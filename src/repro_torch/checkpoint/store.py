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
device (the reference's `shardings` argument becomes `device`), or, with
`placements` (a tree of `parallel.sharding.NamedSharding`), reads leaf by
leaf and keeps each rank's shards as DTensors: the elastic restore of a
checkpoint written from any mesh (or one device, or the reference) onto
another mesh.  Saving a tree of DTensors gathers each leaf and rank 0
writes it, in the same format, so a checkpoint written on a mesh restores
anywhere.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import struct
import threading
import zipfile
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import mutable as mut
from repro_torch.core.grid import resolve_device
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.axes import is_distributed
from repro_torch.utils.tree import leaves, leaves_with_path, unflatten

_SEP = "/"


def _key(path: tuple) -> str:
    return _SEP.join(str(p) for p in path)


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return sh.gather(leaf.detach()).cpu().numpy()
    return np.asarray(leaf)


def stored_array(path: str, key: str) -> np.ndarray:
    """Leaf `key` of an .npz, read-only: mapped from the file where the
    member is stored uncompressed (as `np.savez` writes it), so that a
    slice reads only its own pages; else loaded whole."""
    with zipfile.ZipFile(path) as zf:
        info = zf.getinfo(key + ".npy")
    if info.compress_type != zipfile.ZIP_STORED:
        with np.load(path) as z:
            return z[key]
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        name_len, extra_len = struct.unpack("<HH", f.read(30)[26:30])
        f.seek(info.header_offset + 30 + name_len + extra_len)   # the member's .npy bytes
        version = np.lib.format.read_magic(f)
        read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                       else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read_header(f)
        if math.prod(shape) <= 1:             # a scalar or an empty leaf: read as it is
            return np.fromfile(f, dtype, count=math.prod(shape)).reshape(shape)
        offset = f.tell()
    return np.memmap(path, dtype=dtype, mode="r", offset=offset, shape=shape,
                     order="F" if fortran else "C")


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
        """Snapshot to host memory NOW; write in the background (async).
        A tree holding DTensors is saved by every rank of their mesh
        together, and blocking (every rank returns once the step is on
        disk): each leaf in turn is gathered, rank 0 writes it to the file
        at once and the other ranks drop it, so no rank holds more than
        one whole leaf on the host."""
        if any(is_distributed(leaf) for leaf in leaves(tree)):
            self.wait()
            items = ((_key(p), sh.gather(leaf.detach()) if isinstance(leaf, torch.Tensor)
                      else leaf) for p, leaf in leaves_with_path(tree))
            if dist.get_rank() == 0:
                self._write(step, ((k, _to_numpy(v)) for k, v in items))
            else:
                for _ in items:          # each gather is a collective of every rank
                    pass
            dist.barrier()
            return
        flat = _flatten(tree)  # the device-to-host copy happens here, synchronously
        with self._lock:
            if self._pending is not None:
                self._pending.result()  # one in flight at a time
            self._pending = self._pool.submit(self._write, step, flat.items())
            if blocking:
                self._pending.result()

    def _write(self, step: int, items) -> None:
        """(key, array) pairs to step `step`'s directory, each written as it
        comes (`np.savez`'s format: .npy members of an uncompressed zip)."""
        tmp = os.path.join(self.dir, f".tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        shapes, dtypes = {}, {}
        with zipfile.ZipFile(os.path.join(tmp, "arrays.npz"), "w", zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for key, arr in items:
                with zf.open(key + ".npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, np.asanyarray(arr), allow_pickle=False)
                shapes[key], dtypes[key] = list(arr.shape), str(arr.dtype)
        manifest = {"step": step, "keys": sorted(shapes), "shapes": shapes, "dtypes": dtypes}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

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

    def restore(self, step: int, like: Any, device=None, placements: Any = None) -> Any:
        """Rebuild the tree of `like` (structure donor: tensors, arrays or
        anything with a `.shape`, e.g. tensors on the meta device) as
        tensors on `device` (None = the card), in the dtypes saved.

        `placements`, a tree with `like`'s structure of
        `sharding.NamedSharding` leaves, restores onto a mesh: the leaves
        are read one at a time and each rank reads and keeps only its
        shards (`stored_array`), as DTensors on the mesh's device (the
        reference's restore with `shardings`); a () leaf (a counter) is a
        plain tensor on every rank."""
        path = self.arrays_path(step)
        shardings = [None] * len(leaves(like)) if placements is None else leaves(placements)
        out = []
        for (p, leaf), where in zip(leaves_with_path(like), shardings):
            key = _key(p)
            arr = stored_array(path, key)
            expect = tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)
            if tuple(arr.shape) != expect:
                raise ValueError(f"checkpoint shape mismatch at {key}: {arr.shape} vs {expect}")
            if where is None:
                out.append(torch.from_numpy(np.array(arr)).to(resolve_device(device)))
                continue
            part = np.array(sh.local_part(arr, where.mesh, where.spec) if arr.ndim else arr)
            t = torch.from_numpy(part).to(where.mesh.device)
            out.append(t if arr.ndim == 0 else sh.from_shard(t, where.mesh, where.spec, arr.shape))
        return unflatten(like, iter(out))

    def arrays_path(self, step: int) -> str:
        """The .npz holding step `step`'s leaves."""
        return os.path.join(self.dir, f"step_{step}", "arrays.npz")

