"""The benchmark of `cubesat_apds_tpu_torch`, the PyTorch and CUDA port,
on NVIDIA H100 cards: a frame stream through
`pipelines.stream.StreamingLocalizer.run`, driven from files named in
the repository's `BENCHMARK.json` (see README.md in this folder)."""
