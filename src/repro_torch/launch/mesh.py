"""The device mesh as data: axis names and sizes, no devices.

The counterpart of ``repro.launch.mesh``. The reference lowers every
(arch x shape) cell on a production mesh of 256 devices (single pod) or
512 (two pods) in one process; the port's dry run (`dryrun`) needs only
the mesh's axes and sizes to place each tensor, so a `Mesh` here is that
and nothing more (no ``torch.distributed``, no devices).

Mesh shapes:
* single-pod:  (data=16, model=16)            — 256 devices
* multi-pod:   (pod=2, data=16, model=16)     — 512 devices, 2 pods
The ``pod`` axis carries only data parallelism; ``data`` is FSDP within a
pod; ``model`` is tensor/expert parallelism.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Mesh:
    """Axis name -> size, in ``axis_names`` order."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """The number of devices."""
        return math.prod(self.sizes)

    @property
    def name(self) -> str:
        """``16x16``, ``2x16x16``, ``1x1``."""
        return "x".join(map(str, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_debug_mesh(devices: int = 1) -> Mesh:
    """A (1, n) mesh: one device by default, as the port runs on one
    card."""
    return Mesh(("data", "model"), (1, devices))


def data_axes(mesh) -> tuple[str, ...]:
    """Axes that carry the batch dimension (pod included if present)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axis_size(mesh) -> int:
    return mesh.shape["model"]
