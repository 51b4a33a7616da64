"""Delta encoding (paper §2.1, Fully-Parallel family + cumsum auxiliary).

Encode: d[i] = arr[i] - arr[i-1] (d[0] = 0, base = arr[0]); deltas are zigzag-mapped to
non-negative ints so a child bit-packing plan applies (the Parquet-style
delta|bit-packing nesting).  Decode: ``UNZIGZAG`` (F.P.) -> prefix sum + base (Aux),
wrapping mod 2^32 like the reference's int32 arithmetic.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.algos.bitpack import out_dtype
from repro_torch.core.patterns import Aux, BufSpec, FullyParallel, load, unzigzag
from repro_torch.core.registry import register
from repro_torch.kernels.ref import wrap_i32

_MASK32 = np.int64(0xFFFFFFFF)


def zigzag32_np(d: np.ndarray) -> np.ndarray:
    """32-bit zigzag of *wrapped* int32 deltas -> values in [0, 2^32).

    Deltas of int32 data can span 33 bits; working mod 2^32 keeps every delta a
    32-bit word and the mod-2^32 prefix sum still reconstructs exactly."""
    d32 = (d.astype(np.int64) & _MASK32).astype(np.uint32).astype(np.int32) \
        .astype(np.int64)
    return ((d32 << 1) ^ (d32 >> 63)) & _MASK32


def unzigzag32_np(z: np.ndarray) -> np.ndarray:
    z = z.astype(np.uint64)
    return ((z >> np.uint64(1)) ^ (np.uint64(0) - (z & np.uint64(1)))) \
        .astype(np.uint32).astype(np.int64)


def prefix(d: torch.Tensor, base_op: torch.Tensor) -> torch.Tensor:
    """int32 prefix sum plus base, wrapping mod 2^32 (int64 inside, then wrapped)."""
    return wrap_i32(torch.cumsum(d.to(torch.int64), 0) + base_op[0].to(torch.int64))


class DeltaCodec:
    name = "delta"
    pattern = "fp"
    # the start value is data-dependent but shape-free: a runtime operand
    lifted_meta = {"base": np.int32}

    def encode(self, arr: np.ndarray, **_: Any) -> tuple[dict[str, np.ndarray], dict]:
        flat = np.asarray(arr).reshape(-1).astype(np.int64)
        base = int(flat[0]) if flat.size else 0
        d = np.diff(flat, prepend=flat[:1] if flat.size else np.zeros(1, np.int64))
        return {"deltas": zigzag32_np(d)}, {"base": base}

    def decode_np(self, bufs: dict[str, np.ndarray], meta: dict, n: int,
                  dtype: Any) -> np.ndarray:
        d = unzigzag32_np(np.asarray(bufs["deltas"]))
        vals = (np.cumsum(d) + meta["base"]) & _MASK32
        return vals.astype(np.uint32).astype(np.int32).astype(dtype)

    def stages(self, enc, buf_names: dict[str, str], out_name: str,
               meta_names: dict[str, str] | None = None) -> list:
        deltas, base = buf_names["deltas"], meta_names["base"]
        mid = f"{out_name}.unzig"
        return [
            FullyParallel(chain=(load(deltas), unzigzag()), inputs=(deltas,),
                          specs=(BufSpec("tile"),), out=mid, n_out=enc.n,
                          out_dtype=np.int32, elementwise=True, name="unzigzag"),
            Aux(fn=prefix, inputs=(mid, base), out=out_name, n_out=enc.n,
                out_dtype=out_dtype(enc), name="delta-cumsum"),
        ]


register(DeltaCodec())
