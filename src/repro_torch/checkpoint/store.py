"""Checkpointing: npz of every leaf + JSON manifest, async writes, atomic
renames.

Port of `repro/checkpoint/store.py`, on the same on-disk format, so a
checkpoint written by one package restores in the other:

  <dir>/step_<k>/manifest.json + arrays.npz  (tmp dir + rename = atomic)

A tree is nested dicts, lists, tuples and named tuples of tensors, numpy
arrays or Python scalars; each leaf is stored under its path, the keys
(dicts, in sorted order), indices (lists, tuples) and field names (named
tuples) joined with `_SEP`, as the reference joins its pytree paths.
Restore loads the arrays host-side and places them on the requested
device (the reference's `shardings` argument becomes `device`).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from repro_torch.core import mutable as mut
from repro_torch.core.grid import resolve_device
from repro_torch.utils.tree import leaves_with_path, unflatten

_SEP = "/"


def _key(path: tuple) -> str:
    return _SEP.join(str(p) for p in path)


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {_key(p): _to_numpy(leaf) for p, leaf in leaves_with_path(tree)}


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Future | None = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------- save ----

    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        """Snapshot to host memory NOW; write in the background (async)."""
        flat = _flatten(tree)  # the device-to-host copy happens here, synchronously

        def write():
            tmp = os.path.join(self.dir, f".tmp_step_{step}")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            manifest = {
                "step": step,
                "keys": sorted(flat),
                "shapes": {k: list(v.shape) for k, v in flat.items()},
                "dtypes": {k: str(v.dtype) for k, v in flat.items()},
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        with self._lock:
            if self._pending is not None:
                self._pending.result()  # one in flight at a time
            self._pending = self._pool.submit(write)
            if blocking:
                self._pending.result()

    def wait(self):
        with self._lock:
            if self._pending is not None:
                self._pending.result()
                self._pending = None

    def _gc(self):
        steps = sorted(self.list_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # ---------------------------------------------------------- restore ----

    def list_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore_arrays(self, step: int) -> dict[str, np.ndarray]:
        """Raw {key: array} contents of a step — no structure donor needed.

        This is the restore path for states whose SHAPES are not known up
        front (e.g. a mutable grid index whose slack layout grew since the
        code was written): the caller reconstructs the object from names."""
        path = os.path.join(self.dir, f"step_{step}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            return {k: z[k] for k in z.files}

    def save_mutable_index(self, step: int, state: mut.MutableIndex,
                           blocking: bool = False) -> None:
        """Persist a `core.mutable.MutableIndex` (slack layout, spill log,
        pyramid, tiles — everything needed to keep mutating after restart)."""
        self.save(step, mut.state_to_tree(state), blocking=blocking)

    def restore_mutable_index(self, step: int, device=None) -> mut.MutableIndex:
        """Inverse of `save_mutable_index` — shape-free (see restore_arrays);
        on `device` (None = the card)."""
        return mut.state_from_tree(self.restore_arrays(step), device=device)

    def restore(self, step: int, like: Any, device=None) -> Any:
        """Rebuild the tree of `like` (structure donor: tensors, arrays or
        anything with a `.shape`, e.g. tensors on the meta device) as
        tensors on `device` (None = the card), in the dtypes saved."""
        dev = resolve_device(device)
        flat = self.restore_arrays(step)
        leaves = []
        for p, leaf in leaves_with_path(like):
            key = _key(p)
            arr = flat[key]
            expect = tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)
            if tuple(arr.shape) != expect:
                raise ValueError(f"checkpoint shape mismatch at {key}: {arr.shape} vs {expect}")
            leaves.append(torch.from_numpy(np.array(arr)).to(dev))
        return unflatten(like, iter(leaves))
