"""Kernel 3: Non-Parallel interleaved rANS decode (paper §4, Fig. 11).

Replaces the Pallas TPU kernel ``src/repro/kernels/non_parallel.py:29
non_parallel_call``.  One thread decodes one chunk: ``chunk_size`` dependent
steps on a 32-bit state.  Each block packs the three alphabet tables into one
32-bit entry per slot in shared memory (``decode_table`` gives the layout), so a
step is one shared load and a multiply-add; each lane keeps its next 16 stream
words requested through a ring in shared memory (``cp.async``), so no global
load sits on the chain from state to state; and a lane stores 16 bytes of
symbols at a time after sending each through the stage's ``tail`` (fusion
rule 4).  What bounds it is the chain: ``chunk_size`` steps of a shared load and
a few integer operations.  The CUDA source is ``csrc/non_parallel.cu`` (built
for ``sm_90a``); the plain version is ``repro_torch.kernels.ref.non_parallel_torch``.
"""
from __future__ import annotations

import torch

from repro_torch.core.geometry import Geometry, native_config
from repro_torch.core.patterns import NonParallel
from repro_torch.kernels import cuda, ref
from repro_torch.kernels.fully_parallel import finish, into, kernel_out, stage_device

KERNEL = cuda.KernelLib("non_parallel", "zf_non_parallel", cuda.ZfNpArgs)


def non_parallel(stage: NonParallel, env: dict[str, torch.Tensor],
                 geom: Geometry | None = None, *, n_chunks: int | None = None,
                 n: int | None = None, out: torch.Tensor | None = None) -> torch.Tensor:
    """Decode ``stage`` over tensors in ``env``: the CUDA kernel on a CUDA
    device, the plain version on the CPU.  On CUDA it launches or raises.

    A span of chunks ``[g0, g0 + n_chunks)`` passes its stripe
    ``streams[:row_cap, g0:g0 + n_chunks]`` (its own row count is the kernel's
    ``max_words``) and ``states[g0:g0 + n_chunks]`` in ``env``, its ``n`` valid
    symbols (fewer than ``n_chunks * chunk_size`` only at the end of the
    stream) and ``out``, its range of the output, which is written in place."""
    n_chunks = stage.n_chunks if n_chunks is None else int(n_chunks)
    n = stage.n_out if n is None else int(n)
    names = (stage.streams, stage.states, stage.sym_tab, stage.freq_tab, stage.cum_tab)
    device = stage_device(names, env)
    if device.type == "cpu":
        return into(out, ref.non_parallel_torch(stage, env, n_chunks, n), stage.name)
    if device.type != "cuda":
        raise ValueError(f"no Non-Parallel kernel for device {device}")
    geom = geom or native_config("np")
    streams, states, sym, freq, cum = (env[k] for k in names)
    if streams.dim() != 2 or streams.shape[1] != n_chunks \
            or states.numel() != n_chunks:
        raise ValueError(f"{stage.name}: streams {tuple(streams.shape)} and states "
                         f"{tuple(states.shape)} do not hold {n_chunks} chunks")
    if sym.numel() != 1 << ref.ANS_SCALE_BITS or freq.numel() != 256 \
            or cum.numel() != 256:
        raise ValueError(f"{stage.name}: the tables must hold 4096, 256 and 256 entries")
    if n > n_chunks * stage.chunk_size:
        raise ValueError(f"{stage.name}: {n_chunks} chunks of "
                         f"{stage.chunk_size} cannot hold {n} symbols")
    out_dt = ref.torch_dtype(stage.out_dtype)
    dst = kernel_out(out, n, ref.np_dtype(stage, env), out_dt, False, device, stage.name)
    if n:
        what = f"{stage.name} input"
        args = cuda.ZfNpArgs(
            streams=cuda.operand(streams, what, device, (torch.uint16,)),
            states=cuda.operand(states, what, device, (torch.int32, torch.uint32)),
            sym=cuda.operand(sym, what, device, (torch.uint8,)),
            freq=cuda.operand(freq, what, device, (torch.uint16,)),
            cum=cuda.operand(cum, what, device, (torch.uint16,)),
            max_words=streams.shape[0], n_chunks=n_chunks, n=n,
            tail=cuda.pack_chain(stage.tail, env, device), out=dst.data_ptr(),
            chunk_size=stage.chunk_size, out_width=cuda.out_width(dst),
            L=geom.L, C=geom.C)
        KERNEL.launch(args, geom.S, device)
    return finish(out, dst, lambda t: t if t.dtype == out_dt else t.to(out_dt))


def decode_table(sym: torch.Tensor, freq: torch.Tensor,
                 cum: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """The kernel's packed decode table, one 32-bit entry per slot (as int64):
    ``sym | (freq[sym] - 1) << 8 | (slot - cum[sym]) << 20``, and whether the
    tables fit that layout (``freq`` in 1..4096 and ``slot - cum`` in 0..4095, as
    every encoder table does).  A block whose tables do not fit decodes with
    the three tables instead, so the output is the same either way."""
    s = sym.to(torch.int64)
    slot = torch.arange(s.numel(), dtype=torch.int64, device=s.device)
    f1 = freq.to(torch.int64)[s] - 1
    bias = slot - cum.to(torch.int64)[s]
    fits = bool(((f1 >= 0) & (f1 < 4096) & (bias >= 0) & (bias < 4096)).all())
    return s | (f1 & 0xFFF) << 8 | (bias & 0xFFF) << 20, fits
