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

Placement, the counterpart of the reference's ``jax.make_mesh`` and
``NamedSharding``: ``device_mesh`` builds a
``torch.distributed.device_mesh.DeviceMesh`` of a record's names and sizes
over the current process group; ``placements`` turns a resolved spec into
DTensor placements (``Shard(d)`` on each mesh axis a dimension splits over,
``Replicate()`` on the others; a dimension split over two axes, as ``fsdp``
on the multipod mesh, takes ``Shard(d)`` on both); ``place`` swaps each
parameter of a family's module for a DTensor so placed, and ``replicated``
gives a replicated tensor's placements.  A placed parameter's local shape
is ``shard_shape`` of its resolved spec, so ``per_device_bytes`` counts what
each device holds.  The group may be real (NCCL on the cards, gloo on the
CPU) or fake (``fake_group``: a group of 256 or 512 members in one process,
over which ``meta`` tensors are placed for the dry run).

Deliberately left out: ``TPU_PERF_FLAGS``, XLA flags with no counterpart in
an eager PyTorch program.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Sequence

import torch
from torch import nn

# a resolved spec -> the DTensor placements on a DeviceMesh, one per dimension
from repro_torch.models.sharding_ctx import placements_of as placements

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


# ------------------------------------------------------------------ placement

def device_mesh(mesh: Mesh, device_type: str = "cuda", ranks: Sequence[int] | None = None):
    """A ``DeviceMesh`` with ``mesh``'s axis names and sizes over the current
    process group: the group's ranks ``ranks`` (default ``0 .. size-1``)
    laid out row-major.  Every rank of the group calls it, as
    ``new_group`` wants; raises when no group exists or it has too few
    ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError(f"placing on the {mesh.name} mesh needs a process group; "
                           "none is initialized")
    ranks = list(range(mesh.size)) if ranks is None else [int(r) for r in ranks]
    if len(ranks) != mesh.size:
        raise ValueError(f"{len(ranks)} ranks for the {mesh.size} devices of {mesh.name}")
    world = dist.get_world_size()
    if max(ranks) >= world:
        raise RuntimeError(f"the {mesh.name} mesh needs rank {max(ranks)} and the process "
                           f"group has {world} ranks")
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(mesh.sizes),
                      mesh_dim_names=mesh.axis_names)


def replicated(dmesh) -> tuple:
    """The placements of a tensor every device holds whole."""
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * dmesh.ndim


def record_of(dmesh, name: str = "placed") -> Mesh:
    """The ``Mesh`` record of a ``DeviceMesh`` (its names and sizes)."""
    return Mesh(name, tuple(dmesh.mesh_dim_names),
                tuple(dmesh.size(i) for i in range(dmesh.ndim)))


def _distribute(t: torch.Tensor, dmesh, spec: Spec):
    from torch.distributed.tensor import distribute_tensor
    # every rank holds the same full tensor (one seed, or one checkpoint), so
    # each keeps its own slice: no rank's data is sent to another
    return distribute_tensor(t, dmesh, placements(spec, dmesh), src_data_rank=None)


def place(module: nn.Module, logical_specs, dmesh) -> nn.Module:
    """Swap each parameter of a family's module for a DTensor on ``dmesh``,
    placed by its leaf's logical spec (``Model.param_specs``) resolved on the
    mesh as ``shard_tree`` resolves it; in place, returns ``module``.  A
    stacked leaf's spec loses its leading stack dimensions
    (``weights.layout``): each layer's parameter takes the rest."""
    from repro_torch.models.weights import layout, meta_tree

    mesh = record_of(dmesh)
    specs = shard_tree(meta_tree(module), logical_specs, mesh)
    owner = {id(p): (m, n) for m in module.modules() for n, p in m._parameters.items()
             if p is not None}
    for path, (stack, params) in layout(module).items():
        spec = specs
        for d in path.split("/"):
            spec = spec[d]
        if any(a is not None for a in spec[:len(stack)]):
            raise ValueError(f"{path}: a stacked dimension is split ({spec})")
        local = spec[len(stack):]
        for p in params:
            m, n = owner[id(p)]
            m._parameters[n] = nn.Parameter(_distribute(p.detach(), dmesh, local),
                                            requires_grad=p.requires_grad)
    return module


def place_tree(tree, logical_specs, dmesh):
    """A tree of tensors (a batch, a state) -> the same tree of DTensors,
    each placed by its logical spec resolved on ``dmesh``; a Python scalar
    leaf stays as it is."""
    specs = shard_tree(tree, logical_specs, record_of(dmesh))

    def walk(t, s):
        if isinstance(s, dict):
            return {k: walk(t[k], s[k]) for k in s}
        return _distribute(t, dmesh, s) if isinstance(t, torch.Tensor) else t

    return walk(tree, specs)


@contextlib.contextmanager
def fake_group(world_size: int, rank: int = 0):
    """A fake process group of ``world_size`` members in this process (every
    collective a no-op that returns at once), for counting one device's
    program on a production mesh; destroyed on exit, so that no later code
    in the process sees a default group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group already exists; a fake one would replace it")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
