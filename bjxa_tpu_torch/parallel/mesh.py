"""Device-mesh helpers: a grid of ``torch.device`` that one process drives.

Port of :mod:`bjxa_tpu.parallel.mesh`.  Axis conventions:

* ``dp`` — data parallel over independent files (each file carries its own
  decoder state, so no communication at all; the analog of the
  reference's decoder-per-file model, ``bjxa.3.rst.in:119-120``).
* ``sp`` — sequence parallel over the block range of one stream; shards
  exchange the 2-scalars-per-channel predictor state.

JAX drives a mesh from one controller per process, and so does the port:
a :class:`Mesh` names the devices, the functions of
:mod:`bjxa_tpu_torch.parallel.sharded` put each shard's tensors on its own
device and launch its work there, and shards meet through ``Tensor.to``
(a peer copy between two cards).  Processes meet only at the file-list
level (:mod:`bjxa_tpu_torch.parallel.distributed`).

A device may stand in a mesh more than once (``[torch.device("cpu")] * 8``,
or ``[cuda:0] * 4`` on a one-card host): torch has no virtual devices, so a
repeated device is the port's counterpart of JAX's
``--xla_force_host_platform_device_count``.  Its shards then run one after
another on that device, with the same results.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A named grid of devices.

    ``devices`` is an object array of :class:`torch.device`, one axis per
    name in ``axis_names``; ``shape`` maps each axis name to its size, and
    ``devices.flat`` walks the devices in row-major order, as on a JAX
    mesh.
    """

    devices: np.ndarray
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of {self.devices.ndim} axes named"
                             f" {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis`` in order, the other axes at index 0
        (the first replica where a split leaves them unsharded)."""
        k = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[k] = slice(None)
        return list(self.devices[tuple(index)])


def local_devices() -> list[torch.device]:
    """Every CUDA device of this process, ``cuda:0`` first."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    devices=None, dp: int | None = None, sp: int = 1, axis_names=("dp", "sp")
) -> Mesh:
    """Build a ``(dp, sp)`` mesh over the given devices, or over every
    local CUDA device.

    ``devices`` may repeat a device.  Without it there must be a card:
    the mesh never moves to the CPU on its own (pass
    ``[torch.device("cpu")] * n`` for that).
    """
    if devices is None:
        devices = local_devices()
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device; pass devices=")
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if dp is None:
        dp = n // sp
    if dp * sp != n or n == 0:
        raise ValueError(f"mesh {dp}x{sp} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(dp, sp), tuple(axis_names))


@dataclasses.dataclass(frozen=True)
class DpSharding:
    """The split of a tensor's leading axis into equal contiguous parts,
    part ``i`` on ``devices[i]``; the other axes whole on every part."""

    devices: tuple[torch.device, ...]
    ndim: int

    def shard(self, array) -> list[torch.Tensor]:
        """Split ``array`` (numpy or a tensor) and copy each part to its
        device without blocking.  The leading axis must divide evenly."""
        t = torch.as_tensor(array)
        n = len(self.devices)
        if t.dim() != self.ndim or t.shape[0] % n:
            raise ValueError(f"dp_sharding: shape {tuple(t.shape)} over"
                             f" {n} devices, ndim {self.ndim}")
        return [part.contiguous().to(dev, non_blocking=True)
                for part, dev in zip(t.chunk(n), self.devices)]


def dp_sharding(mesh: Mesh, ndim: int, axis: str = "dp") -> DpSharding:
    """Shard the leading (file) axis over ``axis``, replicate the rest."""
    return DpSharding(tuple(mesh.axis_devices(axis)), ndim)
