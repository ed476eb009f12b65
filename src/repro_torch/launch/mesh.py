"""Production meshes, as descriptions.

Single pod: 256 chips as (data=16, model=16).  Multi-pod: 2 pods = 512
chips as (pod=2, data=16, model=16); the "pod" axis carries only
data-parallel gradient all-reduces (the slow inter-pod hops), while
"model" stays inside a pod.

The JAX package builds these as ``jax.make_mesh`` over forced host
devices for its dry-run.  The port's mesh is a ``torch.distributed``
``DeviceMesh``, one process a rank: a 256-rank mesh needs 256 processes.
So :func:`production_mesh` returns a :class:`MeshShape` -- axis names
and sizes, no devices -- which is all the sharding plan reads
(``launch.shardings.build_rules`` reads ``.shape`` and ``.axis_names``;
``models.moe``'s dispatch groups ``.mesh_dim_names`` and ``.size``, as
of a ``DeviceMesh``, when the dry run makes it the active mesh).
:func:`card_mesh` is a world of one card, the launch tools' third mesh.
:func:`describe` gives the same view of a real ``DeviceMesh``.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["MeshShape", "card_mesh", "describe", "mesh_chips",
           "production_mesh"]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's named axes and their sizes, without devices."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def mesh_dim_names(self) -> tuple[str, ...]:
        return self.axis_names

    def size(self, dim: int | None = None) -> int:
        """Devices of the mesh, or of axis ``dim`` (``DeviceMesh.size``)."""
        if dim is None:
            return math.prod(self.axis_sizes)
        return self.axis_sizes[dim]


def production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def card_mesh() -> MeshShape:
    """One card: every axis of the single-pod mesh at size 1."""
    return MeshShape(("data", "model"), (1, 1))


def describe(mesh) -> MeshShape:
    """A :class:`MeshShape` of ``mesh``: a MeshShape as it is, or a
    ``DeviceMesh`` by its dimension names and sizes."""
    if isinstance(mesh, MeshShape):
        return mesh
    return MeshShape(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


def mesh_chips(mesh) -> int:
    """Devices of ``mesh`` (a MeshShape or a ``DeviceMesh``)."""
    return describe(mesh).size()
