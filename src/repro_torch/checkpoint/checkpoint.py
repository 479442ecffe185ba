"""Fault-tolerant checkpointing: atomic commit, async writes, auto-resume
(src/repro/checkpoint/checkpoint.py), in the reference's on-disk format.

Layout (one directory per step)::

    ckpt_dir/
      step_000000120/
        arrays.0.npz        # flattened tree leaves, one file per process
        treedef.json        # leaf names, step, dtypes
        COMMITTED           # sentinel written LAST -> atomic commit

A checkpoint is valid iff COMMITTED exists; partially-written directories
(host died mid-save) are ignored by :func:`latest_step` and garbage-collected
by :func:`cleanup`. The async writer runs in a daemon thread so the train
loop never blocks on disk; ``wait()`` joins before the next save or exit.

Leaf names are the ones ``jax.tree_util.tree_flatten_with_path`` gives the
same tree (``.params/['embed']/['embedding']``, ``.opt/.step``): a named
tuple's field is ``.name``, a dict key ``['key']`` (keys sorted), a list
or tuple entry ``[i]``. bf16 leaves are stored as their uint16 bits (npz
has no bf16), so a checkpoint either package writes restores in the
other.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

COMMITTED = "COMMITTED"


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:09d}")


def _children(tree) -> Optional[List[Tuple[str, Any]]]:
    """``(name, child)`` pairs of a node in flattening order, or None for a
    leaf."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(tree)]
    return None


def _flatten_with_names(tree) -> Tuple[list, list]:
    names, leaves = [], []

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            names.append("/".join(path))
            leaves.append(node)
            return
        for name, child in kids:
            walk(child, path + (name,))

    walk(tree, ())
    return names, leaves


def _unflatten(like, leaves):
    """``leaves`` (in flattening order) in the structure of ``like``."""
    it = iter(leaves)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        vals = [build(c) for _, c in kids]
        if hasattr(node, "_fields"):
            return type(node)(*vals)
        return type(node)(vals)

    return build(like)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(the array npz stores, its dtype's name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        x = t.numpy()
    else:
        x = np.asarray(leaf)
    return x, str(x.dtype)


def save(ckpt_dir: str, step: int, tree: Any, *, process: int = 0) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    d = _step_dir(ckpt_dir, step)
    os.makedirs(d, exist_ok=True)
    names, leaves = _flatten_with_names(tree)
    arrays = {}
    dtypes = {}
    for name, leaf in zip(names, leaves):
        arrays[name], dtypes[name] = _to_numpy(leaf)
    np.savez(os.path.join(d, f"arrays.{process}.npz"), **arrays)
    treedef = {"names": names, "step": step, "dtypes": dtypes}
    with open(os.path.join(d, "treedef.json"), "w") as f:
        json.dump(treedef, f)
    # commit LAST — readers only trust committed checkpoints
    with open(os.path.join(d, COMMITTED), "w") as f:
        f.write("ok")
    return d


def restore(ckpt_dir: str, step: int, like: Any, *, process: int = 0) -> Any:
    """Restore into the structure, dtypes and devices of ``like`` (a tree
    of tensors)."""
    d = _step_dir(ckpt_dir, step)
    if not os.path.exists(os.path.join(d, COMMITTED)):
        raise FileNotFoundError(f"checkpoint at step {step} not committed: {d}")
    with open(os.path.join(d, "treedef.json")) as f:
        meta = json.load(f)
    saved_dtypes = meta.get("dtypes", {})
    names, leaves = _flatten_with_names(like)
    out = []
    with np.load(os.path.join(d, f"arrays.{process}.npz")) as data:
        for name, leaf in zip(names, leaves):
            arr = data[name]
            if saved_dtypes.get(name) == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            out.append(t.to(device=leaf.device, dtype=leaf.dtype))
    return _unflatten(like, out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, name, COMMITTED)):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def cleanup(ckpt_dir: str, keep: int = 3) -> None:
    """Drop uncommitted wreckage and all but the newest ``keep`` checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return
    committed, junk = [], []
    for name in sorted(os.listdir(ckpt_dir)):
        if not name.startswith("step_"):
            continue
        path = os.path.join(ckpt_dir, name)
        (committed if os.path.exists(os.path.join(path, COMMITTED)) else junk
         ).append(path)
    for path in junk + committed[:-keep if keep else None]:
        shutil.rmtree(path, ignore_errors=True)


class AsyncCheckpointer:
    """Non-blocking saver: snapshot to host memory synchronously, write to
    disk in a daemon thread. One in-flight save at a time (back-pressure).
    A failed write raises from the next ``wait()``."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.saved_steps: list = []

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        # copies made NOW (on the CPU a tensor's numpy view would alias it)
        # so the in-place optimizer step cannot change what is written
        _, leaves = _flatten_with_names(tree)
        host = [l.detach().to("cpu", copy=True)
                if isinstance(l, torch.Tensor) else np.array(l, copy=True)
                for l in leaves]
        snapshot = _unflatten(tree, host)

        def work():
            try:
                save(self.ckpt_dir, step, snapshot)
                cleanup(self.ckpt_dir, self.keep)
                self.saved_steps.append(step)
            except Exception as e:          # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
