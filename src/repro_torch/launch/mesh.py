"""Device meshes over `torch.distributed` ranks (functions, not constants:
importing this module touches no process group).

Port of `repro/launch/mesh.py`.  One rank per device; the world size is the
mesh's size.  A `Mesh` holds the reference mesh's `shape` (axis name ->
size) and `axis_names`, which is all the sharding rules read, and the
`DeviceMesh` the DTensors and collectives run on.

Single pod:  (16, 16)    axes ('data', 'model')   = 256 chips
Multi pod:   (2, 16, 16) axes ('pod', 'data', 'model') = 512 chips

'pod' composes with 'data' for batch sharding (pure DP across pods).

The caller starts the process group and picks its backend: `nccl` with one
rank per card, `gloo` on the CPU or for several ranks sharing one card
(NCCL refuses two ranks on one device).  The device defaults to the card.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.core.grid import resolve_device


class Mesh:
    """A named mesh of ranks: `shape` (axis -> size, in order),
    `axis_names`, and the `device_mesh` over which the tensors live."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.mesh.shape))

    @property
    def device_type(self) -> str:
        return self.device_mesh.device_type

    @property
    def device(self) -> torch.device:
        """The device this rank's tensors live on."""
        if self.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.device_type)

    def group(self, axis: str):
        """The process group of this rank's line along `axis`."""
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis: str) -> int:
        """This rank's index along `axis`."""
        return self.device_mesh.get_local_rank(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.device_type})"


_SYNC_INSTALLED = []


def _reduce_op(name: str):
    return {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
            "product": dist.ReduceOp.PRODUCT}[name.lower()]


def _use_sync_collectives() -> None:
    """Route DTensor's functional collectives on CUDA tensors through the
    synchronous c10d calls.  With gloo and CUDA tensors (several ranks
    sharing one card) the functional ops' `wait_tensor` crashed the
    process on the card's installation, while the c10d calls themselves
    work; each op here runs its c10d call to the end, so the wait is a
    no-op.  Installed once per process, by `make_mesh`, for a gloo mesh on
    the card."""
    if _SYNC_INSTALLED:
        return
    from torch.distributed.distributed_c10d import _resolve_process_group

    def group_of(name):
        return _resolve_process_group(name)

    def all_gather(inp, group_size, group_name):
        out = inp.new_empty((inp.shape[0] * group_size, *inp.shape[1:]))
        dist.all_gather_into_tensor(out, inp.contiguous(), group=group_of(group_name))
        return out

    def all_reduce_(inp, reduce_op, group_name):
        group = group_of(group_name)
        if reduce_op.lower() == "avg":
            dist.all_reduce(inp, dist.ReduceOp.SUM, group=group)
            return inp.div_(dist.get_world_size(group))
        dist.all_reduce(inp, _reduce_op(reduce_op), group=group)
        return inp

    def all_reduce(inp, reduce_op, group_name):
        return all_reduce_(inp.clone(memory_format=torch.contiguous_format), reduce_op, group_name)

    def reduce_scatter(inp, reduce_op, group_size, group_name):
        group = group_of(group_name)
        out = inp.new_empty((inp.shape[0] // group_size, *inp.shape[1:]))
        avg = reduce_op.lower() == "avg"
        dist.reduce_scatter_tensor(out, inp.contiguous(),
                                   dist.ReduceOp.SUM if avg else _reduce_op(reduce_op),
                                   group=group)
        return out.div_(group_size) if avg else out

    def all_to_all(inp, output_split_sizes, input_split_sizes, group_name):
        group = group_of(group_name)
        n = dist.get_world_size(group)
        outs = list(output_split_sizes) or [inp.shape[0] // n] * n
        out = inp.new_empty((sum(outs), *inp.shape[1:]))
        dist.all_to_all_single(out, inp.contiguous(), outs, list(input_split_sizes) or None,
                               group=group)
        return out

    def broadcast(inp, src, group_name):
        out = inp.clone(memory_format=torch.contiguous_format)
        dist.broadcast(out, src, group=group_of(group_name))
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    for name, fn in (("all_gather_into_tensor", all_gather), ("all_reduce", all_reduce),
                     ("all_reduce_", all_reduce_), ("reduce_scatter_tensor", reduce_scatter),
                     ("all_to_all_single", all_to_all), ("broadcast", broadcast),
                     ("wait_tensor", lambda t: t)):
        lib.impl(name, fn, "CUDA")
    _SYNC_INSTALLED.append(lib)     # the registrations live as long as the library


def make_mesh(shape: dict, device=None) -> Mesh:
    """A mesh of `shape` (axis name -> size) over every rank of the
    started process group, on `device`'s type (None = the card).  Raises
    when the world size is not the mesh's size."""
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape.values())
    if not dist.is_initialized():
        raise RuntimeError(f"need {n} devices for mesh {tuple(shape.values())}: start a "
                           "process group first (torchrun, or init_process_group)")
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(f"need {n} devices for mesh {tuple(shape.values())}, "
                           f"have {world} ranks")
    dev = resolve_device(device)
    if dev.type == "cuda" and dist.get_backend() == "gloo":
        _use_sync_collectives()
    return Mesh(init_device_mesh(dev.type, tuple(shape.values()),
                                 mesh_dim_names=tuple(shape)))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    shape = {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}
    return make_mesh(shape, device)


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A (data, model) mesh over the ranks (tests / smoke runs)."""
    return make_mesh({"data": data, "model": model}, device)


def mesh_chips(mesh) -> int:
    return int(math.prod(mesh.shape.values()))
