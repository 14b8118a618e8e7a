"""The serving mesh: the local devices of one process, one replica of the
image tower on each, the counterpart of the JAX package's serving mesh
(`bayesvlm_tpu/dist/mesh.py:42-58`, `resolve_auto_mesh` over
`jax.local_devices()`, and `bayesvlm_tpu/pipeline.py:130-153`).

JAX places one set of parameters replicated over a 1-D ("data",) mesh of
the process's chips and lets GSPMD split the batch. In torch the same
layout is a list of devices, each holding its own copy of what the
serving forward reads (`pipeline.ProbabilisticVLM` keeps those copies and
splits the batch into contiguous row blocks, one a device). It is not
`torch.distributed`'s `DeviceMesh` (`dist/mesh.py`), which spans the
ranks of a launch: a serving mesh lives inside one process.

A device may repeat (`["cuda:0", "cuda:0"]`: two replicas on one card),
which runs the sharded program on one card, as a test does on the CPU
with `["cpu", "cpu"]`.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

AXIS = "data"


def _device(d) -> torch.device:
    """A device with its index: "cuda" is the current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class ServingMesh:
    """Devices of one process in row order: replica i serves the i-th
    contiguous block of every batch. `shape` and `axis_names` read as a
    JAX mesh's do: {"data": n} and ("data",)."""

    axis_names = (AXIS,)

    def __init__(self, devices: Sequence[Union[str, torch.device]]):
        devices = tuple(_device(d) for d in devices)
        if not devices:
            raise ValueError("a serving mesh needs at least one device")
        if len({d.type for d in devices}) > 1:
            raise ValueError(f"a serving mesh's devices are of one type, got {devices}")
        self.devices = devices

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {AXIS: self.size}

    def __repr__(self) -> str:
        return f"ServingMesh({[str(d) for d in self.devices]})"


def resolve_serving_mesh(mesh, device) -> Union[ServingMesh, None]:
    """`mesh` of `from_pretrained` / `from_serving_cache` on the VLM's
    `device`: "auto" takes every visible card when there is more than one
    (`device` first, then the others in index order) and is None on one
    card or on the CPU; None turns the mesh off; a ServingMesh or a
    sequence of devices forces it on, and must start at `device`."""
    device = _device(device)
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f"mesh must be 'auto', None or a sequence of devices, "
                             f"not {mesh!r}")
        if device.type != "cuda" or torch.cuda.device_count() < 2:
            return None
        others = [torch.device("cuda", i) for i in range(torch.cuda.device_count())
                  if i != device.index]
        return ServingMesh([device, *others])
    if mesh is None:
        return None
    mesh = mesh if isinstance(mesh, ServingMesh) else ServingMesh(mesh)
    if mesh.devices[0] != device:
        raise ValueError(f"the serving mesh's first device {mesh.devices[0]} must be "
                         f"the VLM's device {device}")
    return mesh
