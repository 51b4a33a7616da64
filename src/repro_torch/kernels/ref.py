"""Plain PyTorch versions of the two kernels: whole-array interpreters of op chains.

``fully_parallel_torch`` and ``group_parallel_torch`` compute exactly what the CUDA
kernels compute (``fully_parallel.cu`` / ``group_parallel.cu``), with torch ops
over every element at once.  The CPU backend and the tests use them, and the card
compares each kernel with them; nothing on the card's main path calls them.

torch has no ``>>``, ``<<``, ``-`` or ``<`` for ``uint32`` on the CPU, so 32-bit
words are widened to int64 and masked with ``0xFFFFFFFF``; int32 results wrap mod
2^32 exactly like the reference's int32 arithmetic (``wrap_i32``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.patterns import (AFFINE, GATHER, I2F_DIV, IDENTITY, LOAD,
                                       UNPACK, UNZIGZAG, Chain, FullyParallel,
                                       GroupParallel, Op)

MASK32 = 0xFFFFFFFF

_TORCH_DTYPES = {
    np.dtype(np.int32): torch.int32, np.dtype(np.float32): torch.float32,
    np.dtype(np.int64): torch.int64, np.dtype(np.float64): torch.float64,
    np.dtype(np.uint8): torch.uint8, np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16, np.dtype(np.uint32): torch.uint32,
    np.dtype(np.bool_): torch.bool,
}


def torch_dtype(dt) -> torch.dtype:
    return _TORCH_DTYPES[np.dtype(dt)]


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits (two's complement wrap)."""
    return (((x + 2**31) & MASK32) - 2**31).to(torch.int32)


def u32(x: torch.Tensor) -> torch.Tensor:
    """The 32 bits of an int32 (or uint32) tensor as non-negative int64."""
    return x.to(torch.int64) & MASK32


def _unpack(op: Op, idx: torch.Tensor, env: dict[str, torch.Tensor]) -> torch.Tensor:
    packed, bw_op, base_op = (env[b] for b in op.bufs)
    words = u32(packed)
    bw = bw_op[0].to(torch.int64)
    base = base_op[0].to(torch.int64)
    last = words.numel() - 1
    # 64-bit bit position, split like the reference: w = (i>>5)*bw + ((i&31)*bw)>>5
    frac = (idx & 31) * bw
    w = ((idx >> 5) * bw + (frac >> 5)).clamp(max=last)
    off = frac & 31
    lo = words[w] >> off
    hi = torch.where(off == 0, torch.zeros_like(lo),
                     (words[(w + 1).clamp(max=last)] << (32 - off)) & MASK32)
    mask = torch.where(bw >= 32, torch.full_like(bw, MASK32), (1 << (bw & 31)) - 1)
    return wrap_i32(((lo | hi) & mask) + base)


def _source(op: Op, idx: torch.Tensor, env: dict[str, torch.Tensor]) -> torch.Tensor:
    if op.kind == UNPACK:
        return _unpack(op, idx, env)
    if op.kind == LOAD:
        return env[op.bufs[0]][idx]
    raise ValueError(f"{op} is not a source op")


def _transform(op: Op, v: torch.Tensor, env: dict[str, torch.Tensor]) -> torch.Tensor:
    if op.kind == GATHER:
        table = env[op.bufs[0]]
        j = v.to(torch.int64)
        # jnp indexing: negative indices wrap once, then clamp into range
        j = torch.where(j < 0, j + table.numel(), j).clamp(0, table.numel() - 1)
        return table[j]
    if op.kind == I2F_DIV:
        # int32 -> float32 (round to nearest even), then an IEEE float32 divide
        return v.to(torch.float32) / env[op.bufs[0]][0].to(torch.float32)
    if op.kind == UNZIGZAG:
        z = u32(v)
        return wrap_i32((z >> 1) ^ (-(z & 1) & MASK32))
    raise ValueError(f"{op} is not a transform op")


def apply_ops(ops: Chain, v: torch.Tensor, env: dict[str, torch.Tensor]) -> torch.Tensor:
    for op in ops:
        v = _transform(op, v, env)
    return v


def eval_chain(chain: Chain, idx: torch.Tensor,
               env: dict[str, torch.Tensor]) -> torch.Tensor:
    """A chain's value at every index in ``idx`` (int64)."""
    return apply_ops(chain[1:], _source(chain[0], idx, env), env)


def chain_dtype(chain: Chain, env: dict[str, torch.Tensor],
                start: torch.dtype | None = None) -> torch.dtype:
    """The dtype a chain produces (``start``: the value entering a tail)."""
    dt = start
    for op in chain:
        if op.kind in (UNPACK, UNZIGZAG):
            dt = torch.int32
        elif op.kind in (LOAD, GATHER):
            dt = env[op.bufs[0]].dtype
        elif op.kind == I2F_DIV:
            dt = torch.float32
    return dt


def gp_dtype(stage: GroupParallel, env: dict[str, torch.Tensor]) -> torch.dtype:
    mapped = (chain_dtype(stage.values[0], env) if stage.map_kind == IDENTITY
              else torch.int32)
    return chain_dtype(stage.tail, env, start=mapped)


def fully_parallel_torch(stage: FullyParallel,
                         env: dict[str, torch.Tensor]) -> torch.Tensor:
    """out[i] = chain(i) for every i < n_out."""
    device = env[stage.inputs[0]].device
    idx = torch.arange(stage.n_out, dtype=torch.int64, device=device)
    return eval_chain(stage.chain, idx, env).to(torch_dtype(stage.out_dtype))


def group_parallel_torch(stage: GroupParallel,
                         env: dict[str, torch.Tensor]) -> torch.Tensor:
    """out[i] = tail(map(values at g, pos)), g the group owning i."""
    presum = env[stage.presum].to(torch.int64)
    out_dt = torch_dtype(stage.out_dtype)
    if stage.n_out == 0:
        return torch.empty(0, dtype=out_dt, device=presum.device)
    i = torch.arange(stage.n_out, dtype=torch.int64, device=presum.device)
    g = (torch.searchsorted(presum, i, right=True) - 1).clamp(0, stage.n_groups - 1)
    pos = i - presum[g]
    vals = [eval_chain(c, g, env) for c in stage.values]
    if stage.map_kind == AFFINE:
        start = vals[0].to(torch.int32).to(torch.int64)
        stride = vals[1].to(torch.int32).to(torch.int64)
        v = wrap_i32(start + stride * pos)
    else:
        v = vals[0]
    return apply_ops(stage.tail, v, env).to(out_dt)
