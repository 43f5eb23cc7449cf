"""Model checkpoint save/restore for the learned-feature model.

A checkpoint is one `.npz` file holding every leaf of the parameter tree
under its tree path ("params/ConvBlock_0/Conv_0/kernel"), so it needs
nothing beyond numpy to read and is independent of the device it was
saved from. Checkpoint/resume at the model level complements the
stage-artifact cache (pipeline/cache.py) — SURVEY §5 checkpoint row.
"""

from __future__ import annotations

import os
from typing import Any

import jax
import numpy as np


def _with_suffix(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_params(path: str, params: Any) -> None:
    """Write `params` (a nested dict of arrays) to `path` (.npz)."""
    path = os.path.abspath(_with_suffix(path))
    flat = {}
    for keys, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        flat["/".join(str(k.key) for k in keys)] = np.asarray(leaf)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **flat)


def load_params(path: str, like: Any | None = None) -> Any:
    """Read a checkpoint as a nested dict of jax arrays. With `like`, the
    tree must have exactly `like`'s paths, shapes and dtypes."""
    with np.load(_with_suffix(path)) as z:
        flat = {k: z[k] for k in z.files}
    tree: dict = {}
    for key, arr in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jax.numpy.asarray(arr)
    if like is not None:
        want = {
            "/".join(str(k.key) for k in keys): (tuple(v.shape), np.dtype(v.dtype))
            for keys, v in jax.tree_util.tree_flatten_with_path(like)[0]
        }
        got = {k: (tuple(v.shape), v.dtype) for k, v in flat.items()}
        if want != got:
            bad = sorted(k for k in set(want) | set(got) if want.get(k) != got.get(k))
            raise ValueError(f"checkpoint {path} does not match the model at {bad[:5]}")
    return tree
