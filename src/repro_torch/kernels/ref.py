"""Plain PyTorch versions of the three kernels: whole-array interpreters of op chains.

``fully_parallel_torch``, ``group_parallel_torch`` and ``non_parallel_torch``
compute exactly what the CUDA kernels compute (``fully_parallel.cu``,
``group_parallel.cu``, ``non_parallel.cu``), with torch ops over every element
(or, for rANS, every chunk) at once.  The CPU backend and the tests use them, and the card
compares each kernel with them; nothing on the card's main path calls them.

torch has no ``>>``, ``<<``, ``-`` or ``<`` for ``uint32`` on the CPU, so 32-bit
words are widened to int64 and masked with ``0xFFFFFFFF``; int32 results wrap mod
2^32 exactly like the reference's int32 arithmetic (``wrap_i32``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.patterns import (AFFINE, BYTES, GATHER, I2F_DIV, IDENTITY,
                                       LOAD, MASK, RANGE, ROW, SPAN, STRGATHER, TEST,
                                       UNPACK, UNPACK_RAW, UNZIGZAG, WEIGHT, Chain,
                                       FullyParallel, GroupParallel, NonParallel, Op,
                                       Reduce)

MASK32 = 0xFFFFFFFF
# rANS constants (algos/ans.py): renorm bound, probability scale
ANS_L = 1 << 16
ANS_SCALE_BITS = 12

_TORCH_DTYPES = {
    np.dtype(np.int32): torch.int32, np.dtype(np.float32): torch.float32,
    np.dtype(np.int64): torch.int64, np.dtype(np.float64): torch.float64,
    np.dtype(np.uint8): torch.uint8, np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16, np.dtype(np.uint16): torch.uint16,
    np.dtype(np.uint32): torch.uint32, np.dtype(np.bool_): torch.bool,
}


# torch indexes no uint16 or uint32 tensor on CUDA: index a signed view of the bits
_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32}


def take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[idx]`` for every element type the kernels read."""
    signed = _SIGNED_VIEW.get(t.dtype)
    return t[idx] if signed is None else t.view(signed)[idx].view(t.dtype)


def torch_dtype(dt) -> torch.dtype:
    return _TORCH_DTYPES[np.dtype(dt)]


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits (two's complement wrap)."""
    return (((x + 2**31) & MASK32) - 2**31).to(torch.int32)


def u32(x: torch.Tensor) -> torch.Tensor:
    """The 32 bits of an int32 (or uint32) tensor as non-negative int64."""
    return x.to(torch.int64) & MASK32


def _field(op: Op, idx: torch.Tensor, env: dict[str, torch.Tensor]) -> torch.Tensor:
    """The bit-packed field of each element (int64, non-negative), before the
    base is added."""
    packed, bw_op = env[op.bufs[0]], env[op.bufs[1]]
    words = u32(packed)
    bw = bw_op[0].to(torch.int64)
    last = words.numel() - 1
    # 64-bit bit position, split like the reference: w = (i>>5)*bw + ((i&31)*bw)>>5
    frac = (idx & 31) * bw
    w = ((idx >> 5) * bw + (frac >> 5)).clamp(max=last)
    off = frac & 31
    lo = words[w] >> off
    hi = torch.where(off == 0, torch.zeros_like(lo),
                     (words[(w + 1).clamp(max=last)] << (32 - off)) & MASK32)
    mask = torch.where(bw >= 32, torch.full_like(bw, MASK32), (1 << (bw & 31)) - 1)
    return (lo | hi) & mask


def _unpack(op: Op, idx: torch.Tensor, env: dict[str, torch.Tensor]) -> torch.Tensor:
    return wrap_i32(_field(op, idx, env) + env[op.bufs[2]][0].to(torch.int64))


def _bytes(op: Op, idx: torch.Tensor, env: dict[str, torch.Tensor]) -> torch.Tensor:
    """Little-endian word of bytes buf[i*itemsize + k]; bytes past the fourth
    would shift out of 32 bits (the reference's uint32 shifts give 0)."""
    b = env[op.bufs[0]]
    v = torch.zeros_like(idx)
    for k in range(min(op.imm, 4)):
        v |= b[idx * op.imm + k].to(torch.int64) << (8 * k)
    return wrap_i32(v)


def _source(op: Op, idx: torch.Tensor, env: dict[str, torch.Tensor]) -> torch.Tensor:
    if op.kind == UNPACK:
        return _unpack(op, idx, env)
    if op.kind == LOAD:
        return take(env[op.bufs[0]], idx)
    if op.kind == BYTES:
        return _bytes(op, idx, env)
    if op.kind == UNPACK_RAW:
        return _field(op, idx, env)
    raise ValueError(f"{op} is not a source op")


def jnp_index(j: torch.Tensor, n: int) -> torch.Tensor:
    """jnp indexing of int64 ``j`` into n entries: wrap a negative once, clamp."""
    return torch.where(j < 0, j + n, j).clamp(0, n - 1)


def _transform(op: Op, v: torch.Tensor, env: dict[str, torch.Tensor]) -> torch.Tensor:
    if op.kind == GATHER:
        table = env[op.bufs[0]]
        return take(table, jnp_index(v.to(torch.int64), table.numel()))
    if op.kind == SPAN:
        offs = env[op.bufs[0]]
        j = v.to(torch.int32).to(torch.int64)   # the index is int32; j + 1 wraps
        hi = take(offs, jnp_index(wrap_i32(j + 1).to(torch.int64), offs.numel()))
        lo = take(offs, jnp_index(j, offs.numel()))
        return wrap_i32(hi.to(torch.int64) - lo.to(torch.int64))
    if op.kind == I2F_DIV:
        # int32 -> float32 (round to nearest even), then an IEEE float32 divide
        return v.to(torch.float32) / env[op.bufs[0]][0].to(torch.float32)
    if op.kind == UNZIGZAG:
        z = u32(v)
        return wrap_i32((z >> 1) ^ (-(z & 1) & MASK32))
    if op.kind == RANGE:
        # the field against the rebased bounds, in 64 bits (compare_stage)
        x = v.to(torch.int64)
        base = env[op.bufs[0]][0].to(torch.int64)
        lo, hi = op.arg
        sel = torch.ones_like(x, dtype=torch.bool)
        if lo is not None:
            sel &= x >= lo - base
        if hi is not None:
            sel &= x < hi - base
        return sel
    raise ValueError(f"{op} is not a transform op")


def apply_ops(ops: Chain, v: torch.Tensor, env: dict[str, torch.Tensor]) -> torch.Tensor:
    for op in ops:
        v = _transform(op, v, env)
    return v


def eval_chain(chain: Chain, idx: torch.Tensor,
               env: dict[str, torch.Tensor]) -> torch.Tensor:
    """A chain's value at every index in ``idx`` (int64).  A ``TEST`` takes
    the value so far as its dtype and gives the AND of its predicates."""
    v = _source(chain[0], idx, env)
    for k, op in enumerate(chain[1:], 1):
        if op.kind == TEST:
            preds, dtype = op.arg
            x = to_out(v, chain[:k], dtype)
            v = preds[0].mask(x)
            for p in preds[1:]:
                v = v & p.mask(x)
        else:
            v = _transform(op, v, env)
    return v


def chain_dtype(chain: Chain, env: dict[str, torch.Tensor],
                start: torch.dtype | None = None) -> torch.dtype:
    """The dtype a chain produces (``start``: the value entering a tail)."""
    dt = start
    for op in chain:
        if op.kind in (UNPACK, UNZIGZAG, BYTES, SPAN):
            dt = torch.int32
        elif op.kind in (LOAD, GATHER):
            dt = env[op.bufs[0]].dtype
        elif op.kind == I2F_DIV:
            dt = torch.float32
        elif op.kind == UNPACK_RAW:
            dt = torch.int64
        elif op.kind in (RANGE, TEST):
            dt = torch.bool
    return dt


def gp_dtype(stage: GroupParallel, env: dict[str, torch.Tensor]) -> torch.dtype:
    if stage.map_kind == IDENTITY:
        mapped = chain_dtype(stage.values[0], env)
    elif stage.map_kind == STRGATHER:
        mapped = env[stage.extra_inputs[0]].dtype
    else:
        mapped = torch.int32
    return chain_dtype(stage.tail, env, start=mapped)


def np_dtype(stage: NonParallel, env: dict[str, torch.Tensor]) -> torch.dtype:
    return chain_dtype(stage.tail, env, start=torch.uint8)


def to_out(v: torch.Tensor, chain: Chain, out_dtype) -> torch.Tensor:
    """A chain's values as the stage's output dtype.  A ``BYTES`` word holds the
    output element's bits, so a 4-byte output is a bitcast (float32 included);
    everything else converts by value."""
    dt = torch_dtype(out_dtype)
    if v.dtype == dt:
        return v
    if chain and chain[0].kind == BYTES and dt.itemsize == 4:
        return v.view(dt)
    return v.to(dt)


def fully_parallel_torch(stage: FullyParallel, env: dict[str, torch.Tensor],
                         n: int | None = None) -> torch.Tensor:
    """out[i] = chain(i) for every i < n (default ``n_out``).  A chunk passes
    its own slices of the tiled leaves and its length: its boundaries are
    multiples of the tiles' alignment, so local index i reads what the whole
    column's index ``out_start + i`` reads."""
    device = env[stage.inputs[0]].device
    idx = torch.arange(stage.n_out if n is None else n, dtype=torch.int64,
                       device=device)
    return to_out(eval_chain(stage.chain, idx, env), stage.chain, stage.out_dtype)


def group_parallel_torch(stage: GroupParallel, env: dict[str, torch.Tensor],
                         out_start: int = 0, g_start: int = 0,
                         n_valid: int | None = None) -> torch.Tensor:
    """out[i] = tail(map(values at g, pos)), g the group owning i, for the
    ``n_valid`` outputs from ``out_start`` (default: the whole column).  A span
    searches the whole presum at global output indices and evaluates the value
    chains at ``g - g_start`` over its own slices of the value leaves."""
    presum = env[stage.presum].to(torch.int64)
    out_dt = torch_dtype(stage.out_dtype)
    n = stage.n_out if n_valid is None else n_valid
    if n == 0:
        return torch.empty(0, dtype=out_dt, device=presum.device)
    i = out_start + torch.arange(n, dtype=torch.int64, device=presum.device)
    g = (torch.searchsorted(presum, i, right=True) - 1).clamp(0, stage.n_groups - 1)
    pos = i - presum[g]
    vals = [eval_chain(c, g - g_start, env) for c in stage.values]
    if stage.map_kind == AFFINE:
        start = vals[0].to(torch.int32).to(torch.int64)
        stride = vals[1].to(torch.int32).to(torch.int64)
        v = wrap_i32(start + stride * pos)
    elif stage.map_kind == STRGATHER:
        chars, offs = (env[k] for k in stage.extra_inputs)
        j = jnp_index(vals[0].to(torch.int32).to(torch.int64), offs.numel())
        v = take(chars, jnp_index(take(offs, j).to(torch.int64) + pos, chars.numel()))
    else:
        v = vals[0]
    return apply_ops(stage.tail, v, env).to(out_dt)


def non_parallel_torch(stage: NonParallel, env: dict[str, torch.Tensor],
                       n_chunks: int | None = None,
                       n: int | None = None) -> torch.Tensor:
    """Lockstep rANS decode (``algos/ans.py decode_chunks_np``): a loop over the
    ``chunk_size`` serial steps, each vectorised across the chunks; uint32
    arithmetic in int64 masked to 32 bits.  Returns the first ``n`` (default
    ``n_out``) symbols through the tail.  A span passes its stripe
    ``streams[:row_cap, g0:g1]``, ``states[g0:g1]``, ``n_chunks = g1 - g0`` and
    its valid symbol count."""
    streams = env[stage.streams].to(torch.int64)
    x = u32(env[stage.states])
    sym = env[stage.sym_tab].to(torch.int64)
    freq = env[stage.freq_tab].to(torch.int64)
    cum = env[stage.cum_tab].to(torch.int64)
    n_chunks = stage.n_chunks if n_chunks is None else n_chunks
    cs = stage.chunk_size
    lanes = torch.arange(n_chunks, device=x.device)
    cur = torch.zeros(n_chunks, dtype=torch.int64, device=x.device)
    cap = streams.shape[0] - 1
    out = torch.empty((n_chunks, cs), dtype=torch.uint8, device=x.device)
    for t in range(cs):
        slot = x & ((1 << ANS_SCALE_BITS) - 1)
        s = sym[slot]
        out[:, t] = s.to(torch.uint8)
        x = (freq[s] * (x >> ANS_SCALE_BITS) + slot - cum[s]) & MASK32
        need = x < ANS_L
        w = streams[cur.clamp(0, cap), lanes]
        x = torch.where(need, ((x << 16) | w) & MASK32, x)
        cur += need
    flat = out.reshape(-1)[: stage.n_out if n is None else n]
    return apply_ops(stage.tail, flat, env).to(torch_dtype(stage.out_dtype))


# ------------------------------------------------------------ batched versions
# The plain versions of the kernels' batched entries: K members of one
# structure (same stage, each with its own operands), one result per member.

def fully_parallel_batched_torch(stage: FullyParallel,
                                 envs: list[dict[str, torch.Tensor]]) -> list[torch.Tensor]:
    return [fully_parallel_torch(stage, env) for env in envs]


def group_parallel_batched_torch(stage: GroupParallel,
                                 envs: list[dict[str, torch.Tensor]]) -> list[torch.Tensor]:
    return [group_parallel_torch(stage, env) for env in envs]


def non_parallel_batched_torch(stage: NonParallel,
                               envs: list[dict[str, torch.Tensor]]) -> list[torch.Tensor]:
    return [non_parallel_torch(stage, env) for env in envs]


# ------------------------------------------------------------ fused queries

def reduce_values(stage: Reduce, env: dict[str, torch.Tensor], n: int,
                  out_start: int = 0):
    """The items' values per column, their weights ``w`` (float32) and the
    lane values (float32, not yet weighted), for the ``n`` items from
    ``out_start``: tiled roles read their slices at local indices, ``row``
    roles the resident column at global ones."""
    device = env[stage.inputs[0]].device
    idx = torch.arange(n, dtype=torch.int64, device=device)
    vals: dict[str, torch.Tensor] = {}
    mask = weight = None
    for role in stage.roles:
        v = eval_chain(role.chain, idx + out_start if role.kind == ROW else idx, env)
        v = to_out(v, role.chain, role.dtype)
        if role.kind == MASK:
            mask = v if mask is None else mask & v
        elif role.kind == WEIGHT:
            weight = v.to(torch.float32)
        else:
            vals[role.col] = v
    for p in stage.preds:
        m = p.mask(vals[p.col])
        mask = m if mask is None else mask & m
    w = (torch.ones(n, dtype=torch.float32, device=device) if mask is None
         else mask.to(torch.float32))
    if weight is not None:
        w = w * weight
    lanes = [torch.as_tensor(e.eval(vals), device=device).to(torch.float32)
             .expand(n) for e in stage.lanes]
    return vals, w, lanes


def query_reduce_torch(stage: Reduce, env: dict[str, torch.Tensor],
                       n: int | None = None, out_start: int = 0) -> torch.Tensor:
    """The partial aggregate of items ``[out_start, out_start + n)`` (default
    all ``n_in``): per lane the sum of ``lane * w``, the last lane ``w``, per
    segment of the key when there is one (keys outside ``[0, n_segments)``
    drop their row, as ``jax.ops.segment_sum`` does), lane-major.  Each
    segment is one ``torch.sum`` (a tree) over the rows of that key, so the
    order of the sums is fixed."""
    n = stage.n_in if n is None else int(n)
    vals, w, lanes = reduce_values(stage, env, n, out_start)
    stacked = torch.stack([lane * w for lane in lanes] + [w])       # (L, n)
    if stage.key is None:
        return stacked.sum(dim=1)
    key = torch.as_tensor(stage.key.eval(vals), device=w.device).to(torch.int32).expand(n)
    zero = torch.zeros((), dtype=torch.float32, device=w.device)
    segs = [torch.where(key == s, stacked, zero).sum(dim=1) for s in range(stage.n_segments)]
    return torch.stack(segs, dim=1).reshape(-1)
