"""Model pool: keyed parameter snapshots with directory persistence.

Port of lifelike_tpu.learning.registry.ModelPool (the host-side stand-in
for the reference's model_pool service). A snapshot is a Flax-layout tree
of numpy arrays (`{"params": {...}}`), and a file is a pickle of
`{"model": tree, "meta": {...}}` — the same format as the JAX package's
pool, so a file written by either package is read by the other
(models.params.flax_tree gives a port net's tree).

The league, PFSP and the training checkpoints are not ported yet.
"""
import os
import pickle
import time
from typing import Any, Dict, List, Optional

import numpy as np


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


class ModelPool:
    """Keyed parameter store with optional directory persistence."""

    def __init__(self, root: Optional[str] = None):
        self._models: Dict[str, Any] = {}
        self._meta: Dict[str, dict] = {}
        self.root = root
        if root:
            os.makedirs(root, exist_ok=True)

    def push(self, key: str, params, meta: Optional[dict] = None, persist=False):
        self._models[key] = _to_numpy(params)
        self._meta[key] = dict(meta or {}, updated_at=time.time())
        if persist and self.root:
            self.save(key)

    def pull(self, key: str):
        if key not in self._models and self.root:
            self.load(key)
        return self._models[key]

    def keys(self) -> List[str]:
        return list(self._models.keys())

    def save(self, key: str):
        assert self.root, "ModelPool has no persistence root"
        with open(os.path.join(self.root, f"{key}.model"), "wb") as f:
            pickle.dump({"model": self._models[key], "meta": self._meta[key]}, f)

    def load(self, key: str):
        with open(os.path.join(self.root, f"{key}.model"), "rb") as f:
            blob = pickle.load(f)
        self._models[key] = blob["model"]
        self._meta[key] = blob.get("meta", {})
        return self._models[key]

    def load_file(self, key: str, path: str):
        """Seed a model from an explicit file (stage hand-off, reference
        --init_model_paths example_sepmc_train.sh:141)."""
        with open(path, "rb") as f:
            blob = pickle.load(f)
        self._models[key] = blob["model"] if isinstance(blob, dict) else blob
        self._meta[key] = blob.get("meta", {}) if isinstance(blob, dict) else {}
        return self._models[key]
