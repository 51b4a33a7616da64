"""Activation-sharding context: the reference's ``models/sharding_ctx.py``.

The models call ``shard(x, *logical_entries)`` at the places where the
reference pins an interior activation's sharding; it resolves against a
process-global mesh context that the launcher or the dry run sets (process-global: the
backward runs on autograd's own threads on the card).  Without a
context, or on a plain tensor, it is the identity, so model code stays
mesh-agnostic and an unplaced step runs exactly the ops it ran before.

The context holds a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions (``launch/mesh.py device_mesh``).  On a ``DTensor`` under a
context, ``shard`` is ``x.redistribute(mesh, placements)``: ``Shard(d)`` on
every mesh dimension a tensor dimension resolves to, ``Replicate()`` on the
others -- the DTensor form of the reference's ``with_sharding_constraint``
with a ``NamedSharding``.  A dimension that splits over several mesh axes
takes ``Shard(d)`` on each, in the mesh's order.

Logical entries per dim: None | "fsdp" | "tp" | "dp_max" (divisibility-checked
against the actual dim, replicating when it does not divide -- e.g. 15 heads
on a 16-way TP axis), as the reference's.
"""
from __future__ import annotations

import contextlib
import math
import types

import torch

# process-global, not thread-local: on the card autograd runs the backward
# (and a remat policy's recompute of the forward) on its own device threads
_STATE = types.SimpleNamespace(mesh=None, fsdp=None, tp="model")


def set_mesh_context(mesh, fsdp: tuple[str, ...] | None = None, tp: str = "model") -> None:
    if mesh is not None and fsdp is None:
        fsdp = tuple(n for n in mesh.mesh_dim_names if n != tp)
    _STATE.mesh = mesh
    _STATE.fsdp = fsdp
    _STATE.tp = tp


def get_mesh():
    return _STATE.mesh


@contextlib.contextmanager
def mesh_context(mesh, fsdp=None, tp="model"):
    """``set_mesh_context`` for the block; with a mesh, the plain tensors the
    model makes (rotation tables, masks, constants) meet DTensors as
    replicated ones (``implicit_replication``), as XLA treats an unsharded
    constant."""
    prev = (_STATE.mesh, _STATE.fsdp, _STATE.tp)
    set_mesh_context(mesh, fsdp, tp)
    try:
        if mesh is None:
            yield
        else:
            from torch.distributed.tensor.experimental import implicit_replication
            with implicit_replication():
                yield
    finally:
        set_mesh_context(*prev)


def axis_size(mesh, names) -> int:
    """The product of the sizes of the named mesh dimensions (1 for a name
    the mesh lacks, as the reference's ``mesh.shape.get``)."""
    if isinstance(names, str):
        names = (names,)
    dims = mesh.mesh_dim_names
    return math.prod(mesh.size(dims.index(n)) if n in dims else 1 for n in names)


def placements_of(resolved, mesh) -> tuple:
    """A resolved spec (per tensor dim None | axis | tuple of axes) -> DTensor
    placements on ``mesh``, one per mesh dimension."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * mesh.ndim
    dims = mesh.mesh_dim_names
    for d, axes in enumerate(resolved):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [dims.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} split dim {d} out of the mesh's order {dims}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {dims[i]} splits two dims of one tensor")
            out[i] = Shard(d)
    return tuple(out)


def resolve(shape, entries) -> tuple:
    """Logical entries -> a resolved spec under the active context."""
    mesh, fsdp, tp = _STATE.mesh, _STATE.fsdp, _STATE.tp
    fsdp_name = fsdp if len(fsdp) > 1 else fsdp[0]
    if len(entries) != len(shape):
        raise ValueError(f"{len(entries)} entries for a shape of {tuple(shape)}")
    resolved = []
    for e, d in zip(entries, shape):
        if e is None:
            resolved.append(None)
        elif e == "fsdp":
            resolved.append(fsdp_name if d % axis_size(mesh, fsdp) == 0 else None)
        elif e == "tp":
            resolved.append(tp if d % axis_size(mesh, tp) == 0 else None)
        elif e == "dp_max":
            alln = tuple(fsdp) + (tp,)
            if d % axis_size(mesh, alln) == 0:
                resolved.append(alln)
            elif d % axis_size(mesh, fsdp) == 0:
                resolved.append(fsdp_name)
            else:
                resolved.append(None)
        else:
            raise ValueError(e)
    return tuple(resolved)


def shard(x: torch.Tensor, *entries) -> torch.Tensor:
    """Constrain an activation's sharding; the identity when no mesh context
    is active or ``x`` is a plain tensor.

    Entries: None | "fsdp" | "tp" | "dp_max".  "dp_max" spreads the dim over the
    LARGEST divisible combination of data axes -- (fsdp..., tp) if it divides, else
    fsdp, else replicate."""
    mesh = _STATE.mesh
    if mesh is None:
        return x
    resolved = resolve(x.shape, entries)
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    placements = placements_of(resolved, mesh)
    if tuple(x.placements) != placements:
        x = x.redistribute(mesh, placements)
    if x.requires_grad and torch.is_grad_enabled():
        x = _PinGrad.apply(x, mesh, placements)
    return x


class _PinGrad(torch.autograd.Function):
    """The identity whose backward puts the gradient in the forward's
    placements: a constraint holds for the gradient as XLA's does.  Without
    it DTensor carries a gradient's partial sums (a product's over TP)
    into the next product, which it then runs with the weight whole."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.placements:
            grad = grad.redistribute(ctx.mesh, ctx.placements)
        return grad, None, None


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def tp_splits(dim: int) -> bool:
    """Does a "tp" entry split this dim into more than one part under the
    active context?"""
    mesh = _STATE.mesh
    if mesh is None:
        return False
    n = axis_size(mesh, _STATE.tp)
    return n > 1 and dim % n == 0


def tp_divides(dim: int) -> bool:
    """Would a "tp" entry actually shard this dim under the active context?"""
    mesh = _STATE.mesh
    if mesh is None:
        return True
    return dim % axis_size(mesh, _STATE.tp) == 0
