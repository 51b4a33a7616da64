"""Kernel 2: Group-Parallel balanced 1->N expansion (paper §4, Fig. 10).

Replaces the Pallas TPU kernel ``src/repro/kernels/group_parallel.py:51
group_parallel_call``.  Every thread produces whole output elements: it finds its
group by binary search over the presum, evaluates the stage's value chains at the
group (an absorbed bit-unpack included), applies the map (RLE identity,
DeltaStride affine or the StringDict byte gather) and the tail, and stores the
element in its own width (StringDict writes bytes).  The CUDA source is ``csrc/group_parallel.cu``
(built for ``sm_90a``); what bounds it on the card is noted there.  The plain
version is ``repro_torch.kernels.ref.group_parallel_torch``.
"""
from __future__ import annotations

import torch

from repro_torch.core.geometry import Geometry, native_config
from repro_torch.core.patterns import AFFINE, IDENTITY, STRGATHER, GroupParallel
from repro_torch.kernels import cuda, ref
from repro_torch.kernels.fully_parallel import stage_device

KERNEL = cuda.KernelLib("group_parallel", "zf_group_parallel", cuda.ZfGpArgs)
_MAP_CODES = {IDENTITY: 0, AFFINE: 1, STRGATHER: 2}


def group_parallel(stage: GroupParallel, env: dict[str, torch.Tensor],
                   geom: Geometry | None = None) -> torch.Tensor:
    """Expand ``stage`` over tensors in ``env``: the CUDA kernel on a CUDA
    device, the plain version on the CPU.  On CUDA it launches or raises."""
    device = stage_device((stage.presum,) + stage.value_inputs + stage.extra_inputs,
                          env)
    if device.type == "cpu":
        return ref.group_parallel_torch(stage, env)
    if device.type != "cuda":
        raise ValueError(f"no Group-Parallel kernel for device {device}")
    geom = geom or native_config("gp")
    presum = env[stage.presum]
    if presum.dtype != torch.int32 or not presum.is_contiguous() \
            or presum.numel() != stage.n_groups + 1:
        raise ValueError(f"{stage.name}: presum must be contiguous int32 of "
                         f"n_groups + 1 = {stage.n_groups + 1} entries")
    out = torch.empty(stage.n_out, dtype=ref.gp_dtype(stage, env), device=device)
    if stage.n_out:
        values = (cuda.ZfChain * 2)(*[cuda.pack_chain(c, env, device, stage.n_groups)
                                      for c in stage.values])
        extras = [cuda.pack_buffer(env[k], f"{stage.name} input {k!r}", device)
                  for k in stage.extra_inputs] if stage.map_kind == STRGATHER else []
        extras += [cuda.ZfOp()] * (2 - len(extras))
        args = cuda.ZfGpArgs(
            presum=presum.data_ptr(), n_groups=stage.n_groups, values=values,
            tail=cuda.pack_chain(stage.tail, env, device),
            chars=extras[0], offs=extras[1], map_kind=_MAP_CODES[stage.map_kind],
            out_width=cuda.out_width(out),
            out=out.data_ptr(), n=stage.n_out, L=geom.L, C=geom.C)
        KERNEL.launch(args, geom.S, device)
    out_dt = ref.torch_dtype(stage.out_dtype)
    return out if out.dtype == out_dt else out.to(out_dt)
