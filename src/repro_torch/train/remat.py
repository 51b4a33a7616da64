"""Activation-checkpoint policies, the reference's ``train/remat.py``, mapped
onto ``torch.utils.checkpoint``.

A policy is what ``checkpoint(..., context_fn=)`` takes, and the models run
each layer under it (``models.layers.remat``), as the reference runs its scan
body under ``jax.checkpoint(policy=)``:
  * "full": save nothing; the backward recomputes the whole layer;
  * "dots": save the outputs of the matrix products (``mm``, ``addmm``,
    ``bmm``, ``baddbmm``) and recompute the rest -- JAX's ``dots_saveable``;
  * "dots_no_batch": save only the products without a batch dimension
    (``mm``, ``addmm``) -- ``dots_with_no_batch_dims_saveable``;
  * "none", or None: no checkpoint; everything is saved.
A policy changes what is kept for the backward, never a number.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, create_selective_checkpoint_contexts,
                                    noop_context_fn)

_aten = torch.ops.aten
_DOTS = (_aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default)
_DOTS_NO_BATCH = (_aten.mm.default, _aten.addmm.default)


def _saving(ops):
    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy)


POLICIES = {
    "full": noop_context_fn,
    "dots": _saving(_DOTS),
    "dots_no_batch": _saving(_DOTS_NO_BATCH),
}


def get_policy(name: str | None):
    """The policy of ``name`` (None for "none" and None: no checkpoint)."""
    if name is None or name == "none":
        return None
    if name not in POLICIES:
        raise KeyError(f"unknown remat policy {name!r}; known: none, {', '.join(POLICIES)}")
    return POLICIES[name]
