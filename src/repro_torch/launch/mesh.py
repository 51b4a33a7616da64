"""Production meshes and sharding resolution: the resolution half of the
reference's ``launch/mesh.py``.

``make_production_mesh`` returns a ``Mesh`` *record* -- axis names and sizes,
no devices -- single pod = (16, 16) ("data", "model") = 256 chips;
multi-pod = (2, 16, 16) ("pod", "data", "model") = 512 chips; and
``make_card_mesh`` the one-card (1, 1) ("data", "model") mesh the port runs on
today.

``shard_tree`` resolves the models' *logical* specs ("fsdp"/"tp" tuples, see
``models/layers.py``) against actual shapes into resolved specs -- per
dimension None or the mesh axis (or tuple of axes) it is split over --
replicating any dimension whose size does not divide the mesh axis (small
archs on big meshes, B=1 long-context decode, odd vocabs), as the reference
does.  ``shard_shape`` and ``per_device_bytes`` give what one device holds,
as the reference's ``NamedSharding.shard_shape`` does.

Deliberately left out: placing tensors on devices (the reference's
``NamedSharding`` and ``jax.make_mesh``), which waits for the port's mesh
(ROADMAP §1 item 3); and ``TPU_PERF_FLAGS``, XLA flags with no counterpart
in an eager PyTorch program.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

Spec = tuple    # a resolved spec: per dimension None | axis name | tuple of axis names


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes, with jax's ``Mesh.shape`` and ``.axis_names``."""
    name: str
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh("multipod_2x16x16", ("pod", "data", "model"), (2, 16, 16))
    return Mesh("pod_16x16", ("data", "model"), (16, 16))


def make_card_mesh() -> Mesh:
    """The one-card mesh: every axis of size 1, so nothing is split."""
    return Mesh("card_1x1", ("data", "model"), (1, 1))


def mesh_axes(mesh) -> tuple[tuple[str, ...], str]:
    """-> (fsdp axis names, tp axis name)."""
    names = mesh.axis_names
    fsdp = tuple(n for n in names if n != "model")
    return fsdp, "model"


def _axis_size(mesh, names) -> int:
    if isinstance(names, str):
        names = (names,)
    return int(math.prod(mesh.shape[n] for n in names))


def resolve_entry(entry, dim: int, mesh, fsdp, tp):
    """Logical spec entry -> mesh axis (or None), honoring divisibility."""
    if entry is None:
        return None
    if entry == "fsdp" or (isinstance(entry, tuple) and entry[0] == "fsdp"):
        name = fsdp if len(fsdp) > 1 else fsdp[0]
        return name if dim % _axis_size(mesh, fsdp) == 0 else None
    if entry == "tp" or (isinstance(entry, tuple) and entry[0] == "tp"):
        return tp if dim % _axis_size(mesh, tp) == 0 else None
    raise ValueError(f"bad logical spec entry {entry!r}")


def _shape(leaf) -> tuple[int, ...]:
    """A leaf's shape: a tensor's, or () for a Python scalar (the port's
    ``len`` of a cache, a host int)."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


def shard_tree(shapes, logical_specs, mesh) -> Any:
    """Resolve a logical-spec tree against a tree of tensors (meta or not)
    -> the same tree of resolved specs.

    Handles ("stacked", subtree) / ("stacked2", subtree) markers by left-padding the
    spec with None dims.
    """
    fsdp, tp = mesh_axes(mesh)

    def walk(shape_t, spec_t, lead):
        if (isinstance(spec_t, tuple) and len(spec_t) == 2
                and spec_t[0] in ("stacked", "stacked2")
                and isinstance(spec_t[1], dict)):
            return walk(shape_t, spec_t[1], lead + (1 if spec_t[0] == "stacked" else 2))
        if isinstance(spec_t, dict):
            return {k: walk(shape_t[k], spec_t[k], lead) for k in spec_t}
        shp = _shape(shape_t)
        if spec_t is None:
            return (None,) * len(shp)
        entries = tuple(spec_t)
        if len(entries) + lead != len(shp):
            raise ValueError(f"spec {spec_t} (+{lead} stacked) does not fit shape {shp}")
        return (None,) * lead + tuple(resolve_entry(e, d, mesh, fsdp, tp)
                                      for e, d in zip(entries, shp[lead:]))

    return walk(shapes, logical_specs, 0)


def shard_shape(shape, spec: Spec, mesh) -> tuple[int, ...]:
    """The per-device shape of a ``shape`` split by resolved ``spec``."""
    out = []
    for d, axes in zip(shape, spec):
        n = 1 if axes is None else _axis_size(mesh, axes)
        if d % n:
            raise ValueError(f"dimension {d} does not split over {axes} ({n})")
        out.append(d // n)
    return tuple(out)


def leaves(tree, specs):
    """(leaf, resolved spec) pairs of a tree and its ``shard_tree``."""
    if isinstance(specs, dict):
        for k in specs:
            yield from leaves(tree[k], specs[k])
    else:
        yield tree, specs


def per_device_bytes(tree, specs, mesh) -> int:
    """Bytes one device holds of ``tree`` (tensors, meta or not) under its
    resolved ``specs``; a Python scalar leaf is a host value, 0 bytes."""
    total = 0
    for leaf, spec in leaves(tree, specs):
        if isinstance(leaf, torch.Tensor):
            total += math.prod(shard_shape(leaf.shape, spec, mesh)) * leaf.element_size()
    return total
