"""Device mesh of the distributed layer (counterpart of
``nsparse_tpu/parallel/mesh.py``).

The JAX layer is single-controller: one process drives a
``jax.sharding.Mesh`` through ``shard_map``.  The port keeps that model
without the SPMD program: a :class:`Mesh` is an ordered tuple of
``torch.device`` s, one per shard, and every function of the layer runs
shard ``d``'s work on ``mesh.devices[d]`` from one process.  Launches are
asynchronous, so the shards of a mesh of several cards overlap without
threads; collectives become copies between the shards' devices (a device
copy on one card, a peer copy across cards).

The counterpart of JAX's virtual mesh (``--xla_force_host_platform_
device_count``) is an explicit ``device``: ``make_mesh(4,
device="cuda:0")`` puts four shards on one card, ``make_mesh(8,
device="cpu")`` eight on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Shard ``d`` lives on ``devices[d]`` (row-major over ``shape``)."""

    devices: Tuple[torch.device, ...]
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(
    n_devices: Optional[int] = None,
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("x",),
    device=None,
) -> Mesh:
    """A mesh of ``n_devices`` shards (default: ``prod(shape)``, else every
    visible CUDA card).  Without ``device`` each shard takes a card of its
    own, and asking for more than exist raises ValueError; with
    ``device`` every shard lives on that one device (a virtual mesh)."""
    if device is None:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        if n_devices is None:
            n_devices = math.prod(shape) if shape else max(len(devs), 1)
        if n_devices > len(devs):
            raise ValueError(f"need {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    else:
        if n_devices is None:
            n_devices = math.prod(shape) if shape else 1
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            # the index tensors report, so shards compare equal to them
            dev = torch.device("cuda", torch.cuda.current_device()
                               if torch.cuda.is_available() else 0)
        devs = [dev] * n_devices
    if shape is None:
        shape = (n_devices,)
    if math.prod(shape) != n_devices:
        raise ValueError(f"mesh shape {shape} holds {math.prod(shape)} "
                         f"devices, not {n_devices}")
    return Mesh(devices=tuple(devs), shape=tuple(shape),
                axis_names=tuple(axis_names[: len(shape)]))


def check_mesh(mesh: Mesh, n_shards: int, axis: str) -> None:
    """The layer's one layout: shard ``d`` on ``mesh.devices[d]``."""
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} is not one of {mesh.axis_names}")
    if mesh.size != n_shards:
        raise ValueError(f"{n_shards} shards on a mesh of {mesh.size} "
                         "devices")


def replicas(x, mesh: Mesh) -> list:
    """``x`` (a tensor or anything with ``.to``) on every shard's device,
    copied once per distinct device (no copy where it already lives)."""
    by_dev = {}
    for dev in mesh.devices:
        if dev not in by_dev:
            by_dev[dev] = x.to(dev)
    return [by_dev[dev] for dev in mesh.devices]
