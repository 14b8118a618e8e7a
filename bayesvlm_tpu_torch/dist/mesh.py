"""The port's device mesh and its row sharding, counterpart of
`bayesvlm_tpu.dist.mesh`.

JAX has two levels: a mesh over a process's local chips (`shard_map`)
and processes joined by `jax.distributed`. In the torch idiom the unit
is one process per card, so the port's mesh is a 1-D
`torch.distributed.device_mesh.DeviceMesh` named ("data",) over the
ranks of the launch, one device a rank; tensor parallelism lays the
ranks out in 2-D, ("data", "model") (`make_mesh(axis_names, shape)`,
dist/tp.py).

A sharded function takes the same full inputs on every rank. It computes
its rank's contiguous block of rows, padded to a multiple of the world
size as JAX's `_pad_rows` / `pad_to_multiple` do (`local_rows`), then
`all_reduce`s or `all_gather`s (`all_reduce_sum`, `all_gather_rows`), so
that every rank holds the replicated result: what JAX's `out_specs=P()`
gives.

`resolve_auto_mesh("auto")` gives that world mesh when a process group
of more than one rank is initialised, and None otherwise. It is the
counterpart of JAX's "local devices" on a multi-chip host and is sound
for the same reason: the inputs and seeds are identical on every rank,
so every rank's copy of a replicated result is the same.

Collectives run on the CPU under gloo and on the rank's card under NCCL
(`_comm_device`); a tensor on the other kind of device is staged there
and back, so gloo also serves ranks whose tensors are on a card.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

AXIS = "data"


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def _group_ready() -> bool:
    return dist.is_available() and dist.is_initialized()


def make_mesh(axis_names: Sequence[str] = (AXIS,),
              shape: Optional[Sequence[int]] = None):
    """A mesh over every rank of the initialised process group, ranks laid
    out row-major in `shape` (default: every rank on the first axis), of
    device type "cuda" under NCCL and "cpu" under gloo: JAX's
    `make_mesh(devices, axis_names, shape)` with one device a rank. The
    default is the 1-D ("data",) mesh (JAX's `make_mesh()` /
    `default_mesh()`); ("data", "model") with a shape gives the 2-D mesh
    of tensor parallelism (dist/tp.py), whose axes are its sub-meshes
    (`mesh["model"]`)."""
    if not _group_ready():
        raise ValueError("a mesh needs an initialised process group: call "
                         "dist.init.initialize_distributed first")
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    axis_names = tuple(axis_names)
    if shape is None:
        shape = [world] + [1] * (len(axis_names) - 1)
    shape = [int(n) for n in shape]
    if len(shape) != len(axis_names) or math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} over axes {axis_names} does not "
                         f"hold the {world} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=axis_names)


def resolve_auto_mesh(mesh):
    """The selection entry points' "auto": the world mesh when a process
    group of more than one rank is initialised, else None (one device).
    None disables sharding; an explicit mesh is passed through."""
    if isinstance(mesh, str) and mesh == "auto":
        if _group_ready() and dist.get_world_size() > 1:
            return make_mesh()
        return None
    return mesh


def mesh_size(mesh) -> int:
    return 1 if mesh is None else int(mesh.size())


def check_mesh(mesh) -> None:
    """A mesh of more than one rank comes from an initialised group."""
    if mesh_size(mesh) > 1 and not _group_ready():
        raise ValueError(f"a mesh of {mesh_size(mesh)} ranks needs an initialised "
                         f"process group (dist.init.initialize_distributed)")


def row_block(n: int, mesh) -> Tuple[int, int]:
    """(first row, rows) of this rank's block of n rows padded to a
    multiple of the mesh's size."""
    width = pad_to_multiple(n, mesh_size(mesh)) // mesh_size(mesh)
    rank = 0 if mesh is None else int(mesh.get_local_rank())
    return rank * width, width


def local_rows(x: torch.Tensor, mesh, fill: Union[float, str] = 1.0):
    """(this rank's block of x's rows [width, ...], its validity mask
    [width] fp32): x padded to a multiple of the mesh's size with rows of
    `fill` (a value, or "edge": the last real row repeated), then cut into
    contiguous blocks in rank order."""
    n = x.shape[0]
    lo, width = row_block(n, mesh)
    part = x[lo:min(lo + width, n)]
    pad = width - part.shape[0]
    if pad:
        if fill == "edge":
            rows = x[-1:].expand((pad,) + tuple(x.shape[1:]))
        else:
            rows = torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                              device=x.device)
        part = torch.cat([part, rows])
    mask = (torch.arange(lo, lo + width, device=x.device) < n).to(torch.float32)
    return part, mask


def _comm_device(group=None) -> torch.device:
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of every rank's t, on t's device (a mesh of one rank runs
    the collective too; no mesh returns t)."""
    if mesh is None:
        return t
    check_mesh(mesh)
    group = mesh.get_group()
    buf = t.detach().to(_comm_device(group)).contiguous()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.device)


def all_gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's t (of one shape) concatenated along rows in rank
    order, on t's device (no mesh returns t)."""
    if mesh is None:
        return t
    check_mesh(mesh)
    group = mesh.get_group()
    buf = t.detach().to(_comm_device(group)).contiguous()
    out = [torch.empty_like(buf) for _ in range(mesh_size(mesh))]
    dist.all_gather(out, buf, group=group)
    return torch.cat(out).to(t.device)
