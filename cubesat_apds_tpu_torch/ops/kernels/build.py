"""Build and load the package's CUDA kernels.

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` call, all started
together, and one more call links them into a shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds). The library lands in ``build/kernels/`` at the repository
root, named by a hash of the sources and flags: the first call after a
source change rebuilds, later calls and processes reuse it. Nothing is
built at import time.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name → argtypes. Every entry returns cudaError_t as int.
_SIGNATURES = {
    # L, g, out, batch, H, W, tile_h, tile_w, cluster, threads, cells per
    # thread, half_taus (host), n_steps, smem_bytes, stream
    "apds_fed_cycle": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I,
                       _I, _P),
    # cluster, threads, cells per thread, smem_bytes, info (int32 [3], host)
    "apds_fed_cycle_info": (_I, _I, _I, _I, _P),
    # stack, level_hw, lvl, iy, ix, out, K, S, L, Hmax, Wmax, stream
    "apds_sample_patches": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # q_words, db_words, vpop, partial, d0, d1, i0, Q, M, n_split, chunk,
    # stream
    "apds_knn2_hamming": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # info (int32 [8], host)
    "apds_knn2_info": (_P,),
}


@dataclasses.dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_log: str   # nvcc's output (ptxas register/smem report), "" if reused


_LOADED: KernelLibrary | None = None


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME, $CUDA_PATH or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of cubesat_apds_tpu_torch build "
        "at first use; put the CUDA toolkit's bin/ on PATH or set CUDA_HOME")


def _sources():
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libapds_kernels_{h.hexdigest()[:16]}.so"


def _nvcc_all(cmds) -> str:
    """Run the nvcc commands `cmds` all at once; their joined output, or
    raise with the first failure's command and output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


def _build(so: Path) -> str:
    """One nvcc per source, all started together, then one link into `so`;
    returns nvcc's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    srcs = _sources()
    objs = [BUILD_DIR / f"{so.stem}.{os.getpid()}.{s.stem}.o" for s in srcs]
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        log = _nvcc_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                         for s, o in zip(srcs, objs)])
        log += _nvcc_all([[nvcc, *LINK_FLAGS, "-o", str(tmp),
                           *(str(o) for o in objs)]])
        os.replace(tmp, so)     # atomic: a concurrent build never sees half a file
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return log


def load_kernels() -> KernelLibrary:
    """Build (if needed) and load the kernel library; cached per process."""
    global _LOADED
    if _LOADED is not None:
        return _LOADED
    so = library_path()
    log = ""
    if not so.is_file():
        log = _build(so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    _LOADED = KernelLibrary(lib=lib, path=so, build_log=log)
    return _LOADED


def check_launch(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error (launch refused,
    bad argument, or a fault from earlier work on the stream)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def stream_of(t) -> int:
    """The raw handle of the current stream on `t`'s device (the cheap
    query: no Stream object is made)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())


def on_device(dev):
    """A context that makes `dev` the current CUDA device around a launch;
    a no-op, and a cheap one, when it already is."""
    import torch

    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def ptr(t) -> int:
    return t.data_ptr()
