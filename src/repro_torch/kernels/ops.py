"""Dispatch from pattern stages to the kernels or their plain versions.

``run_stage`` is the per-stage executor of ``repro_torch.core.compiler``:

  * backend ``"kernel"`` -- Fully-Parallel, Group-Parallel and Non-Parallel
    stages go to the CUDA kernels (whose wrappers take the plain version only
    for CPU tensors), each at ``geoms["fp" | "gp" | "np"]`` when a ``geoms``
    mapping gives one, else at its native geometry;
  * backend ``"torch"``  -- the plain PyTorch versions on any device.

An ``Aux`` stays a whole-array torch op on both backends; the Fully-Parallel
producers fusion rule 5 folded into it run first, through the same dispatch, so
on the kernel backend they are kernel launches too.  A fused query's ``Reduce``
goes to the query kernel (``query_reduce``) or its plain version.

``run_stage_batched`` runs one stage for K columns of one structure: a
Fully-Parallel, Group-Parallel or Non-Parallel stage as one launch of the
kernel's batched entry (its plain version on the torch backend), an Aux's
producers the same way and its torch op once per member.
"""
from __future__ import annotations

import torch

from repro_torch.core.geometry import Geometry
from repro_torch.core.patterns import (Aux, FullyParallel, GroupParallel,
                                       NonParallel, Reduce, Stage)
from repro_torch.kernels import ref
from repro_torch.kernels.fully_parallel import fully_parallel, fully_parallel_batched, into
from repro_torch.kernels.group_parallel import group_parallel, group_parallel_batched
from repro_torch.kernels.non_parallel import non_parallel, non_parallel_batched
from repro_torch.kernels.query_reduce import query_reduce

BACKENDS = ("kernel", "torch")
PATTERNS = ((FullyParallel, "fp"), (GroupParallel, "gp"), (NonParallel, "np"))


def stage_geom(stage: Stage, geoms: dict[str, Geometry] | None) -> Geometry | None:
    """The geometry ``geoms`` gives the stage's pattern (None: the native one)."""
    if not geoms:
        return None
    return next((geoms.get(p) for kind, p in PATTERNS if isinstance(stage, kind)), None)


def run_stage(stage: Stage, env: dict[str, torch.Tensor], backend: str, *,
              out: torch.Tensor | None = None, geoms: dict[str, Geometry] | None = None,
              **span) -> torch.Tensor:
    """One stage on ``backend``.  A chunk or a span passes its entry in
    ``span`` -- ``n`` (Fully-Parallel); ``out_start``, ``g_start``, ``n_valid``
    and ``g_size`` (Group-Parallel); ``n_chunks`` and ``n`` (Non-Parallel);
    ``n``, ``out_start`` and ``accumulate`` (Reduce) -- with its slices in
    ``env``, and ``out``, its range of the column's output (a Reduce's
    accumulator), which both backends write in place.  ``geoms`` maps
    ``"fp"``, ``"gp"`` and ``"np"`` to the kernels' launch geometries."""
    geom = stage_geom(stage, geoms)
    if isinstance(stage, FullyParallel):
        if backend == "kernel":
            return fully_parallel(stage, env, geom, out=out, **span)
        return into(out, ref.fully_parallel_torch(stage, env, **span), stage.name)
    if isinstance(stage, GroupParallel):
        if backend == "kernel":
            return group_parallel(stage, env, geom, out=out, **span)
        span.pop("g_size", None)
        return into(out, ref.group_parallel_torch(stage, env, **span), stage.name)
    if isinstance(stage, NonParallel):
        if backend == "kernel":
            return non_parallel(stage, env, geom, out=out, **span)
        return into(out, ref.non_parallel_torch(stage, env, **span), stage.name)
    if isinstance(stage, Reduce):
        if backend == "kernel":
            return query_reduce(stage, env, out=out, **span)
        res = ref.query_reduce_torch(stage, env, span.get("n"), span.get("out_start", 0))
        if out is None:
            return res
        return out.add_(res) if span.get("accumulate") else into(out, res, stage.name)
    if isinstance(stage, Aux):
        if span or out is not None:
            raise ValueError(f"{stage.name}: an Aux stage runs whole, never per chunk")
        local = dict(env) if stage.producers else env
        for prod in stage.producers:
            local[prod.out] = run_stage(prod, local, backend, geoms=geoms)
        res = stage.fn(*[local[a] for a in stage.args])
        out_dt = ref.torch_dtype(stage.out_dtype)
        return res if res.dtype == out_dt else res.to(out_dt)
    raise TypeError(f"unknown stage type {type(stage)}")


_BATCHED = ((FullyParallel, fully_parallel_batched, ref.fully_parallel_batched_torch),
            (GroupParallel, group_parallel_batched, ref.group_parallel_batched_torch),
            (NonParallel, non_parallel_batched, ref.non_parallel_batched_torch))


def run_stage_batched(stage: Stage, envs: list[dict[str, torch.Tensor]], backend: str,
                      *, outs: list[torch.Tensor | None] | None = None,
                      geoms: dict[str, Geometry] | None = None) -> list[torch.Tensor]:
    """One stage, whole, for each member's operands in ``envs`` (columns of one
    structure) on ``backend``; ``outs[k]``, when given, is member k's output,
    written in place.  One launch serves the members, so they share the
    pattern's geometry from ``geoms``."""
    outs = [None] * len(envs) if outs is None else list(outs)
    for kind, kernel, plain in _BATCHED:
        if isinstance(stage, kind):
            if backend == "kernel":
                return kernel(stage, envs, stage_geom(stage, geoms), outs=outs)
            return [into(o, r, stage.name) for o, r in zip(outs, plain(stage, envs))]
    if isinstance(stage, Aux):
        locals_ = [dict(env) for env in envs] if stage.producers else envs
        for prod in stage.producers:
            for loc, res in zip(locals_, run_stage_batched(prod, locals_, backend,
                                                           geoms=geoms)):
                loc[prod.out] = res
        out_dt = ref.torch_dtype(stage.out_dtype)
        results = []
        for loc, o in zip(locals_, outs):
            res = stage.fn(*[loc[a] for a in stage.args])
            res = res if res.dtype == out_dt else res.to(out_dt)
            results.append(res if o is None else into(o, res, stage.name))
        return results
    raise TypeError(f"unknown stage type {type(stage)}")
