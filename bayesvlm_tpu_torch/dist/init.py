"""Multi-process initialisation and the host-array exchanges, counterpart
of `bayesvlm_tpu.dist.init`.

One entry point scales the same scripts from one card to one process per
card:

    from bayesvlm_tpu_torch.dist.init import initialize_distributed
    ctx = initialize_distributed()         # no-op for one process
    mesh = ctx.mesh                        # every rank on 'data'
    dm.shard_for_host(ctx.host_id, ctx.num_hosts)   # webdataset tar split

A launch names its coordinator and its ranks as the JAX package's does:
`COORDINATOR_ADDRESS` (host:port; `JAX_COORDINATOR_ADDRESS` is read
too), `NUM_PROCESSES` and `PROCESS_ID`, or the same as arguments; one
process per card. The process group meets at `tcp://COORDINATOR_ADDRESS`
over NCCL when the device is a card and over gloo on the CPU (or the
caller's `backend`). Rank r works on `cuda:{r % torch.cuda.device_count()}`.
A second call, or a call in a process whose group the caller initialised
itself, is a no-op that describes the group, as JAX's
`is_initialized()` guard makes it.

`allreduce_factors` and `allgather_rows` work on host arrays, as JAX's
do; a tensor given to `allgather_rows` comes back as a tensor on its
device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from bayesvlm_tpu_torch.dist.mesh import _comm_device, make_mesh


@dataclasses.dataclass
class DistContext:
    """JAX's DistContext with one device a rank: its `local_mesh` (this
    rank's devices) is always None and its `num_devices` is `num_hosts`,
    so neither is kept."""

    mesh: Any            # the world mesh (every rank), None for one process
    host_id: int
    num_hosts: int       # the ranks, one card each
    device: torch.device  # this rank's device

    @property
    def is_primary(self) -> bool:
        return self.host_id == 0


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _rank_device(device: Union[str, torch.device], rank: int) -> torch.device:
    """Rank r's card is cuda:{r % device_count()}; a device with an index,
    or the CPU, is taken as given. Nothing falls back to the CPU."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"rank {rank} finds no CUDA device; pass device='cpu' "
                           f"to run the ranks on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
) -> DistContext:
    """Join the launch that the arguments or the environment name, once;
    always returns a DistContext (mesh None and one host for a single
    process). Raises ValueError for a launch named in part: an address
    without NUM_PROCESSES or PROCESS_ID, or NUM_PROCESSES > 1 without an
    address."""
    addr = (coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
            or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if num_processes is None and os.environ.get("NUM_PROCESSES"):
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and os.environ.get("PROCESS_ID"):
        process_id = int(os.environ["PROCESS_ID"])
    if not (dist.is_available() and dist.is_initialized()):
        if addr:
            if num_processes is None or process_id is None:
                raise ValueError(f"COORDINATOR_ADDRESS={addr} names a launch, but "
                                 f"NUM_PROCESSES and PROCESS_ID are not both set")
            rank_device = _rank_device(device, process_id)
            if rank_device.type == "cuda":
                torch.cuda.set_device(rank_device)
            if backend is None:
                backend = "nccl" if rank_device.type == "cuda" else "gloo"
            dist.init_process_group(backend, init_method=f"tcp://{addr}",
                                    world_size=num_processes, rank=process_id)
        elif (num_processes or 1) > 1:
            raise ValueError(f"NUM_PROCESSES={num_processes} names a launch, but no "
                             f"COORDINATOR_ADDRESS is set")
    if _world() == 1 and not (dist.is_available() and dist.is_initialized()):
        return DistContext(mesh=None, host_id=0, num_hosts=1,
                           device=torch.device(device))
    rank = dist.get_rank()
    rank_device = _rank_device(device, rank)
    if rank_device.type == "cuda":
        torch.cuda.set_device(rank_device)
    return DistContext(mesh=make_mesh(), host_id=rank, num_hosts=_world(),
                       device=rank_device)


def _process_allgather(arrays):
    """Each rank's arrays (one shape across ranks) stacked along a new
    first axis in rank order, as host arrays."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a)).to(_comm_device())
        parts = [torch.empty_like(t) for _ in range(_world())]
        dist.all_gather(parts, t)
        out.append(torch.stack(parts).cpu().numpy())
    return tuple(out)


def allreduce_factors(A, B, n_local: float, num_hosts: Optional[int] = None,
                      _allgather=None):
    """Per-host K-FAC factors into the global convention: kfac_ggn returns
    each host's sums divided by sqrt(n_local); the global factors are
    sum_h sums_h / sqrt(sum_h n_h) (ref:hessian_estimation.py:106-109 at
    the global pair count). A no-op on one host (A and B returned as
    given); else host float32 arrays. `_allgather` (a tuple of arrays ->
    the tuple of rank-stacked arrays) is injectable for tests."""
    if num_hosts is None:
        num_hosts = _world()
    if num_hosts <= 1:
        return A, B
    if _allgather is None:
        _allgather = _process_allgather
    to_host = lambda F: (F.detach().cpu().numpy() if isinstance(F, torch.Tensor)
                         else np.asarray(F))
    root = np.sqrt(np.float64(n_local)).astype(np.float32)
    stacked = _allgather((to_host(A) * root, to_host(B) * root,
                          np.asarray(root**2, np.float32)))
    A_all, B_all, n_all = (np.asarray(x) for x in stacked)
    n_global = float(n_all.sum())
    return ((A_all.sum(0) / np.sqrt(n_global)).astype(np.float32),
            (B_all.sum(0) / np.sqrt(n_global)).astype(np.float32))


def allgather_rows(x, num_hosts: Optional[int] = None, return_counts: bool = False):
    """Every host's row block in rank order, for uneven counts too (each
    padded to the largest count for the gather and cut back after it).
    Used by the global-class-batch Stage-1 mode and the multi-process
    feature gathers. `return_counts` also returns the hosts' row counts
    (rank order). x is a host array or a tensor; the result is of its
    kind (a tensor on x's device)."""
    if num_hosts is None:
        num_hosts = _world()
    is_tensor = isinstance(x, torch.Tensor)
    t = x if is_tensor else torch.from_numpy(np.ascontiguousarray(x))
    if num_hosts <= 1:
        counts = np.asarray([t.shape[0]])
        out = x if is_tensor else np.asarray(x)
        return (out, counts) if return_counts else out
    comm = _comm_device()
    n = torch.tensor([t.shape[0]], dtype=torch.int64, device=comm)
    all_n = [torch.empty_like(n) for _ in range(num_hosts)]
    dist.all_gather(all_n, n)
    counts = np.asarray([int(c.item()) for c in all_n])
    m = int(counts.max())
    buf = torch.zeros((m,) + tuple(t.shape[1:]), dtype=t.dtype, device=comm)
    buf[:t.shape[0]] = t.detach().to(comm)
    parts = [torch.empty_like(buf) for _ in range(num_hosts)]
    dist.all_gather(parts, buf)
    out = torch.cat([p[:int(c)] for p, c in zip(parts, counts)])
    out = out.to(t.device) if is_tensor else out.cpu().numpy()
    return (out, counts) if return_counts else out
