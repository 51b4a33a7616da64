"""Kernel 2: Group-Parallel balanced 1->N expansion (paper §4, Fig. 10).

Replaces the Pallas TPU kernel ``src/repro/kernels/group_parallel.py:51
group_parallel_call``.  Each block produces ``L`` sub-tiles of ``S*C``
consecutive outputs.  One warp searches the presum for the group of the block's
first output; each sub-tile then stages, from the previous sub-tile's last
group on, the presum entries its outputs need in shared memory, and evaluates
the stage's value chains once per group there (an absorbed bit-unpack
included; for StringDict the word's offset).  Each thread owns ``C``
consecutive outputs: one search in the window, a walk across group boundaries,
the map (RLE identity, DeltaStride affine or the StringDict byte gather) and
the tail, and a 16-byte store (``native_config("gp")`` gives every thread 16
bytes of output).  Counts of at least 1 bound a window to ``S*C + 1`` groups;
a wider one (zero counts) is walked in global memory by the same kernel.  The
CUDA source is ``csrc/group_parallel.cu`` (built for ``sm_90a``); what bounds
it on the card is noted there.  The plain version is
``repro_torch.kernels.ref.group_parallel_torch``.
"""
from __future__ import annotations

import torch

from repro_torch.core.geometry import Geometry, native_config
from repro_torch.core.patterns import AFFINE, IDENTITY, STRGATHER, GroupParallel
from repro_torch.kernels import cuda, ref
from repro_torch.kernels.fully_parallel import finish, into, kernel_out, stage_device

KERNEL = cuda.KernelLib("group_parallel", "zf_group_parallel", cuda.ZfGpArgs)
_MAP_CODES = {IDENTITY: 0, AFFINE: 1, STRGATHER: 2}


def group_parallel(stage: GroupParallel, env: dict[str, torch.Tensor],
                   geom: Geometry | None = None, *, out: torch.Tensor | None = None,
                   out_start: int = 0, g_start: int = 0, n_valid: int | None = None,
                   g_size: int | None = None) -> torch.Tensor:
    """Expand ``stage`` over tensors in ``env``: the CUDA kernel on a CUDA
    device, the plain version on the CPU.  On CUDA it launches or raises.

    A span passes the global index ``out_start`` of its first output, its
    ``n_valid`` outputs, its groups ``[g_start, g_start + g_size)``, its slices
    of the value leaves in ``env`` (the presum stays whole) and ``out``, its
    range of the column's output, which is written in place."""
    n = stage.n_out if n_valid is None else int(n_valid)
    device = stage_device((stage.presum,) + stage.value_inputs + stage.extra_inputs,
                          env)
    if device.type == "cpu":
        return into(out, ref.group_parallel_torch(stage, env, out_start, g_start, n),
                    stage.name)
    if device.type != "cuda":
        raise ValueError(f"no Group-Parallel kernel for device {device}")
    presum = env[stage.presum]
    if presum.dtype != torch.int32 or not presum.is_contiguous() \
            or presum.numel() != stage.n_groups + 1:
        raise ValueError(f"{stage.name}: presum must be contiguous int32 of "
                         f"n_groups + 1 = {stage.n_groups + 1} entries")
    if out_start < 0 or out_start + n > stage.n_out or not 0 <= g_start < stage.n_groups:
        raise ValueError(f"{stage.name}: span of {n} outputs from {out_start} (group "
                         f"{g_start}) outside {stage.n_out} outputs, "
                         f"{stage.n_groups} groups")
    out_dt = ref.torch_dtype(stage.out_dtype)
    dst = kernel_out(out, n, ref.gp_dtype(stage, env), out_dt, False, device, stage.name)
    geom = geom or native_config("gp", out_width=cuda.out_width(dst))
    if geom.S < 32:
        raise ValueError(f"{stage.name}: kernel 2 needs blocks of at least one warp, "
                         f"not {geom}")
    if n:
        # the value leaves hold the groups from g_start on
        extent = stage.n_groups - g_start if g_size is None else int(g_size)
        values = (cuda.ZfChain * 2)(*[cuda.pack_chain(c, env, device, extent)
                                      for c in stage.values])
        extras = [cuda.pack_buffer(env[k], f"{stage.name} input {k!r}", device)
                  for k in stage.extra_inputs] if stage.map_kind == STRGATHER else []
        extras += [cuda.ZfOp()] * (2 - len(extras))
        args = cuda.ZfGpArgs(
            presum=presum.data_ptr(), n_groups=stage.n_groups, values=values,
            tail=cuda.pack_chain(stage.tail, env, device),
            chars=extras[0], offs=extras[1], map_kind=_MAP_CODES[stage.map_kind],
            out_width=cuda.out_width(dst), out=dst.data_ptr(), n=n, L=geom.L, C=geom.C,
            out_start=out_start, g_start=g_start)
        KERNEL.launch(args, geom.S, device)
    return finish(out, dst, lambda t: t if t.dtype == out_dt else t.to(out_dt))


def tile_windows(presum: torch.Tensor, n_out: int, tile: int) -> torch.Tensor:
    """Groups that each run of ``tile`` outputs touches, ``g_hi - g_lo + 1``.
    For ``tile = S*C`` the kernel stages these and, after a block's first
    sub-tile, the previous sub-tile's last group; its buffer holds ``tile + 1``
    groups, the most that counts of at least 1 need, and a wider window
    (a count above ``tile``) takes its global-memory path."""
    presum = presum.to(torch.int64)
    first = torch.arange(0, n_out, tile, dtype=torch.int64, device=presum.device)
    last = torch.clamp(first + tile, max=n_out) - 1
    n_groups = presum.numel() - 1

    def group(i):
        return (torch.searchsorted(presum, i, right=True) - 1).clamp(0, n_groups - 1)

    return group(last) - group(first) + 1
