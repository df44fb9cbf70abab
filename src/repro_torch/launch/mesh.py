"""Production meshes (port of ``repro.launch.mesh``), as device-free
descriptions: a :class:`MeshShape` has the axis names and sizes the
planner, ``launch/specs.py`` and the dry-run read, and touches no device
or process group. The one H100 is the 1 x 1 host mesh."""
from __future__ import annotations

import math


class MeshShape:
    """A mesh by its shape alone: ``shape`` maps each axis name to its
    size, in order."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"MeshShape({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape({"pod": 2, "data": 16, "model": 16})
    return MeshShape({"data": 16, "model": 16})


def make_host_mesh() -> MeshShape:
    """The one-device mesh (1 x 1, the production axis names): one H100."""
    return MeshShape({"data": 1, "model": 1})
