"""Dispatch from pattern stages to the kernels or their plain versions.

``run_stage`` is the per-stage executor of ``repro_torch.core.compiler``:

  * backend ``"kernel"`` -- Fully-Parallel, Group-Parallel and Non-Parallel
    stages go to the CUDA kernels at their native geometry (whose wrappers take
    the plain version only for CPU tensors);
  * backend ``"torch"``  -- the plain PyTorch versions on any device.

An ``Aux`` stays a whole-array torch op on both backends; the Fully-Parallel
producers fusion rule 5 folded into it run first, through the same dispatch, so
on the kernel backend they are kernel launches too.
"""
from __future__ import annotations

import torch

from repro_torch.core.patterns import (Aux, FullyParallel, GroupParallel,
                                       NonParallel, Stage)
from repro_torch.kernels import ref
from repro_torch.kernels.fully_parallel import fully_parallel, into
from repro_torch.kernels.group_parallel import group_parallel
from repro_torch.kernels.non_parallel import non_parallel

BACKENDS = ("kernel", "torch")


def run_stage(stage: Stage, env: dict[str, torch.Tensor], backend: str, *,
              out: torch.Tensor | None = None, **span) -> torch.Tensor:
    """One stage on ``backend``.  A chunk or a span passes its entry in
    ``span`` -- ``n`` (Fully-Parallel); ``out_start``, ``g_start``, ``n_valid``
    and ``g_size`` (Group-Parallel); ``n_chunks`` and ``n`` (Non-Parallel) --
    with its slices in ``env``, and ``out``, its range of the column's output,
    which both backends write in place."""
    if isinstance(stage, FullyParallel):
        if backend == "kernel":
            return fully_parallel(stage, env, out=out, **span)
        return into(out, ref.fully_parallel_torch(stage, env, **span), stage.name)
    if isinstance(stage, GroupParallel):
        if backend == "kernel":
            return group_parallel(stage, env, out=out, **span)
        span.pop("g_size", None)
        return into(out, ref.group_parallel_torch(stage, env, **span), stage.name)
    if isinstance(stage, NonParallel):
        if backend == "kernel":
            return non_parallel(stage, env, out=out, **span)
        return into(out, ref.non_parallel_torch(stage, env, **span), stage.name)
    if isinstance(stage, Aux):
        if span or out is not None:
            raise ValueError(f"{stage.name}: an Aux stage runs whole, never per chunk")
        local = dict(env) if stage.producers else env
        for prod in stage.producers:
            local[prod.out] = run_stage(prod, local, backend)
        res = stage.fn(*[local[a] for a in stage.args])
        out_dt = ref.torch_dtype(stage.out_dtype)
        return res if res.dtype == out_dt else res.to(out_dt)
    raise TypeError(f"unknown stage type {type(stage)}")
