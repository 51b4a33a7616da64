"""Kernel 1: Fully-Parallel decode of a fused op chain (paper §4, Fig. 9).

Replaces the Pallas TPU kernel ``src/repro/kernels/fully_parallel.py:35
fully_parallel_call``.  One launch evaluates a stage's whole op chain (e.g.
``UNPACK -> GATHER`` for dictionary|bitpack) per element in registers, so a fused
chain reads its packed words once and writes the output once.  A block stages
the bit-packed words of its tile in shared memory, and each thread writes its
16 bytes of outputs in one store (``native_config("fp", out_width=...)``).
The CUDA source is ``csrc/fully_parallel.cu`` (built for ``sm_90a``); what
bounds it on the card and how it is laid out is noted there.  The plain version
is ``repro_torch.kernels.ref.fully_parallel_torch``.
"""
from __future__ import annotations

import torch

from repro_torch.core.geometry import Geometry, native_config
from repro_torch.core.patterns import FullyParallel
from repro_torch.kernels import cuda, ref

KERNEL = cuda.KernelLib("fully_parallel", "zf_fully_parallel", cuda.ZfFpArgs)
MAX_STAGE_BYTES = 96 * 1024   # ZF_FP_MAX_SMEM in csrc/fully_parallel.cu


def stage_words(geom: Geometry) -> int:
    """Words of the shared buffer a block stages its bit-packed words in: a
    tile of ``L*S*C`` outputs at up to 32 bits starts at most 3 words after a
    16-byte boundary and reads one word past its last element's first, so
    ``tile + 4`` words, in whole 16-byte vectors, hold it at every bit width.
    Capped at ``MAX_STAGE_BYTES``; a wider window takes the kernel's
    per-element path."""
    return min((geom.tile + 4 + 3) // 4 * 4, MAX_STAGE_BYTES // 4)


def stage_device(names, env: dict[str, torch.Tensor]) -> torch.device:
    """The one device every named input lies on."""
    devices = {env[n].device for n in names}
    if len(devices) != 1:
        raise ValueError(f"stage inputs span devices {sorted(map(str, devices))}")
    return devices.pop()


def fully_parallel(stage: FullyParallel, env: dict[str, torch.Tensor],
                   geom: Geometry | None = None) -> torch.Tensor:
    """Decode ``stage`` over tensors in ``env``: the CUDA kernel on a CUDA
    device, the plain version on the CPU.  On CUDA it launches or raises."""
    device = stage_device(stage.inputs, env)
    if device.type == "cpu":
        return ref.fully_parallel_torch(stage, env)
    if device.type != "cuda":
        raise ValueError(f"no Fully-Parallel kernel for device {device}")
    out = torch.empty(stage.n_out, dtype=ref.chain_dtype(stage.chain, env),
                      device=device)
    geom = geom or native_config("fp", out_width=cuda.out_width(out))
    if stage.n_out:
        args = cuda.ZfFpArgs(chain=cuda.pack_chain(stage.chain, env, device,
                                                   stage.n_out),
                             out=out.data_ptr(), n=stage.n_out, L=geom.L, C=geom.C,
                             out_width=cuda.out_width(out),
                             stage_words=stage_words(geom))
        KERNEL.launch(args, geom.S, device)
    return ref.to_out(out, stage.chain, stage.out_dtype)
