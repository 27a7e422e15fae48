"""Feature stores: the npz `FeatureStore` and the mmap `BinaryFeatureStore`
(copies of the JAX package's, on the same on-disk formats), and
`open_store`, which opens either by its manifest."""

from __future__ import annotations

import json
import os


def open_store(path: str):
    """Open the store at `path` with the backend its manifest names:
    binary manifests carry "segments" (v2) or a flat row count "n" (v1),
    npz FeatureStore manifests neither. Raises FileNotFoundError where
    there is no manifest."""
    manifest_path = os.path.join(path, "manifest.json")
    if not os.path.exists(manifest_path):
        raise FileNotFoundError(f"no feature store at {path!r} (missing "
                                "manifest.json)")
    with open(manifest_path) as f:
        manifest = json.load(f)
    if "segments" in manifest or "n" in manifest:
        from cubesat_apds_tpu_torch.store.binary_store import (
            BinaryFeatureStore)

        return BinaryFeatureStore(path)
    from cubesat_apds_tpu_torch.store.feature_store import FeatureStore

    return FeatureStore.load(path)
