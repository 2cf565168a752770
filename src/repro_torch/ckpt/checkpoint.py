"""Checkpointing: atomic, async, resumable; the reference's on-disk format.

Port of ``repro/ckpt/checkpoint.py`` without ``jax``.

Layout:  <dir>/step_<N>/
            manifest.json        — step, leaf paths/shapes/dtypes, meta
            <leaf-path>.npy      — one array per leaf

* the tree flattening gives the leaf keys and order
  ``jax.tree_util.tree_flatten_with_path`` gives for the trees that get
  saved (nested dicts by sorted key, a ``NamedTuple``'s fields as
  ``.<name>`` in field order, other lists and tuples by index, ``None`` as
  no leaf), so a directory written by either package restores in the
  other with the same keys: a ``TrainState`` as ``.params/embed``,
  ``.opt/.step``, ``.opt/.m/layers/attn/wq``;
* leaves are torch tensors or numpy arrays (or scalars); ``save`` copies a
  tensor to the host on the caller's thread.  bf16 leaves are refused
  (``.npy`` has no bf16); a training state has none, its params and
  moments being fp32;
* atomicity: written to ``step_<N>.tmp`` then renamed — a crash leaves
  either the old or the new checkpoint, never a torn one;
* async: ``save_async`` snapshots to host memory on the caller's thread,
  then writes on a background thread;
* retention: ``keep`` most-recent checkpoints;
* resume: ``latest_step`` + ``restore``.  In place of the reference's
  ``shardings=``, ``restore`` takes a ``device=``: with one it returns
  tensors on that device, without one numpy arrays.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["Checkpointer"]


def _walk(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in ``jax.tree_util`` order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _walk(tree[key], path + (str(key),))
    elif _is_namedtuple(tree):
        for name, sub in zip(tree._fields, tree):
            yield from _walk(sub, path + (f".{name}",))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _walk(sub, path + (str(i),))
    else:
        yield path, tree


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _flatten(tree) -> List[Tuple[str, Any]]:
    return [("/".join(path), leaf) for path, leaf in _walk(tree)]


def _unflatten(tree, leaves: Iterator[Any]):
    """``tree``'s structure with its leaves replaced, in flattening order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: _unflatten(tree[key], leaves) for key in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(sub, leaves) for sub in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(sub, leaves) for sub in tree)
    return next(leaves)


def _to_host(key: str, leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(f"leaf {key!r} is bfloat16, which .npy cannot hold; "
                            "cast it (a training state's fp32 masters need no cast)")
        return leaf.detach().to("cpu", copy=True).numpy()
    arr = np.asarray(leaf)
    if str(arr.dtype) == "bfloat16":
        raise TypeError(f"leaf {key!r} is bfloat16, which .npy cannot hold")
    return arr


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = True,
             meta: Optional[Dict[str, Any]] = None):
        """``meta`` is a small JSON-serialisable dict stored in the manifest
        alongside the leaves — e.g. a live-corpus generation counter, so a
        restored serving engine knows which corpus version the snapshot
        captured (:meth:`read_meta`)."""
        host = [(k, _to_host(k, v)) for k, v in _flatten(tree)]
        if blocking:
            self._write(step, host, meta)
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host, meta))
            self._thread.start()

    def save_async(self, step: int, tree: Any,
                   meta: Optional[Dict[str, Any]] = None):
        self.save(step, tree, blocking=False, meta=meta)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host, meta: Optional[Dict[str, Any]] = None):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest: Dict[str, Any] = {"step": step, "leaves": {},
                                    "meta": meta or {}}
        for key, arr in host:
            fn = key.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"][key] = {
                "file": fn,
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # ------------------------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, d, "manifest.json")):
                    out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def read_meta(self, step: int) -> Dict[str, Any]:
        """Manifest ``meta`` dict for one step (``{}`` for checkpoints
        written without one)."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            return json.load(f).get("meta", {})

    def latest_meta(self) -> Dict[str, Any]:
        """``read_meta`` of the most recent checkpoint (``{}`` when the
        directory holds none) — how a fleet restores its manifest without
        tracking step numbers."""
        s = self.latest_step()
        return self.read_meta(s) if s is not None else {}

    def restore(self, step: int, target_tree: Any, device=None) -> Any:
        """Restore into the structure of ``target_tree``: numpy arrays, or
        with ``device`` tensors on that device."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        keys = [k for k, _ in _flatten(target_tree)]
        missing = [k for k in keys if k not in manifest["leaves"]]
        if missing:
            raise ValueError(f"checkpoint missing leaves: {missing[:5]}")
        leaves = []
        for k in keys:
            a = np.load(os.path.join(d, manifest["leaves"][k]["file"]))
            leaves.append(a if device is None else torch.as_tensor(a, device=device))
        return _unflatten(target_tree, iter(leaves))
