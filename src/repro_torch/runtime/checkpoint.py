"""Checkpoints with atomic writes (port of ``repro/runtime/checkpoint.py``).

Layout, the reference's:  <dir>/step_<N>/arrays.npz  +  <dir>/step_<N>/manifest.json
                          <dir>/LATEST  (pointer file, replaced atomically)

Arrays are stored whole, keyed by their path in the tree (dict keys and
tuple indices joined by ``/``, as the reference's ``_flatten`` makes
them), so a checkpoint written by either package restores in the other.
A step is written to a temporary directory and renamed into place, and
``LATEST`` is replaced by a rename: a preemption mid-write never corrupts
it.  The data stream needs nothing but the step (``data/pipeline``).

Trees are dicts, tuples and lists of tensors (or numpy arrays); ``None``
is an empty subtree, as in JAX.  ``restore(shardings=)`` places each leaf
on its ``NamedSharding``'s device (the mesh folded onto one device); the
on-disk layout does not depend on it.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device


def _walk(tree: Any, path: tuple = ()):
    """(path, leaf) pairs of a tree of dicts, tuples and lists; ``None``
    holds no leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {_key(path): _numpy(leaf) for path, leaf in _walk(tree)}


def save(ckpt_dir: str, step: int, tree: Any, *, extra: dict | None = None,
         keep_last: int = 3) -> str:
    """Write ``tree`` as step ``step`` of ``ckpt_dir`` and point LATEST at
    it; keeps the newest ``keep_last`` steps.  Returns the step's
    directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(tree)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {"step": step, "keys": sorted(flat),
                    "extra": extra or {},
                    "shapes": {k: list(v.shape) for k, v in flat.items()},
                    "dtypes": {k: str(v.dtype) for k, v in flat.items()}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    ptr_tmp = os.path.join(ckpt_dir, ".LATEST_tmp")
    with open(ptr_tmp, "w") as f:
        f.write(f"step_{step:08d}")
    os.replace(ptr_tmp, os.path.join(ckpt_dir, "LATEST"))
    _gc(ckpt_dir, keep_last)
    return final


def _gc(ckpt_dir: str, keep_last: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[1])


def _rebuild(tree: Any, leaves, path: tuple = ()):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaves, path + (i,))
                          for i, v in enumerate(tree))
    return leaves(path, tree)


def restore(ckpt_dir: str, tree_like: Any, *, step: int | None = None,
            shardings: Any = None,
            device: str | torch.device = "cuda") -> tuple[Any, int, dict]:
    """Restore into the structure of ``tree_like`` (leaves: anything with a
    ``shape``, e.g. tensors on the ``meta`` device) -> (tree of tensors
    with the stored dtypes, step, the manifest's ``extra``).  Each leaf
    lies on its sharding's device where ``shardings`` (a tree of
    ``NamedSharding`` of ``tree_like``'s structure) is given, else on
    ``device``.  Raises where a stored shape differs from the leaf's."""
    if shardings is not None:
        placement = {path: sh.device for path, sh in _walk(shardings)}
    else:
        device = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as data:
        def leaf(path, like):
            key = _key(path)
            arr = data[key]
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"{key}: stored {arr.shape}, expected "
                                 f"{tuple(like.shape)}")
            return torch.from_numpy(arr).to(
                placement[path] if shardings is not None else device)
        out = _rebuild(tree_like, leaf)
    return out, step, manifest["extra"]
