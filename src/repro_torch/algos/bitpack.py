"""Bit-packing + Frame-of-Reference (paper §2.1, Fully-Parallel family).

Encode: subtract the column minimum (FOR), pack each value into ``bit_width`` bits,
little-endian within a stream of uint32 words.  ``bit_width`` <= 32.

Decode (Fully-Parallel, the ``UNPACK`` op): out[i] spans at most two words:
    bitpos = i*bw;  w = bitpos >> 5;  off = bitpos & 31
    v = (word[w] >> off | word[w+1] << (32-off)) & mask;  out = v + base
``UNPACK`` is a source op evaluable at any index, so fusion can absorb it into
Group-Parallel value chains -- the paper's Fig. 7(c).
"""
from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.core.patterns import BufSpec, FullyParallel, in_range, unpack, unpack_raw
from repro_torch.core.registry import register


def required_bits(span: int) -> int:
    return max(1, int(span).bit_length()) if span > 0 else 0


def pack_np(values: np.ndarray, bit_width: int) -> np.ndarray:
    """Pack non-negative ints < 2^bit_width into uint32 words (+1 guard word)."""
    n = values.size
    v = values.astype(np.uint64)
    n_words = (n * bit_width + 31) // 32 + 1  # +1 guard for the cross-word read
    packed = np.zeros(n_words, dtype=np.uint64)
    bitpos = np.arange(n, dtype=np.uint64) * np.uint64(bit_width)
    w = (bitpos >> np.uint64(5)).astype(np.int64)
    off = bitpos & np.uint64(31)
    np.bitwise_or.at(packed, w, (v << off) & np.uint64(0xFFFFFFFF))
    np.bitwise_or.at(packed, w + 1, v >> (np.uint64(32) - off))
    return packed.astype(np.uint32)


def unpack_np(packed: np.ndarray, n: int, bit_width: int) -> np.ndarray:
    p = packed.astype(np.uint64)
    bitpos = np.arange(n, dtype=np.uint64) * np.uint64(bit_width)
    w = (bitpos >> np.uint64(5)).astype(np.int64)
    off = bitpos & np.uint64(31)
    both = p[w] | (p[w + 1] << np.uint64(32))
    mask = np.uint64((1 << bit_width) - 1)
    return ((both >> off) & mask).astype(np.int64)


def out_dtype(enc) -> np.dtype:
    """Decoded dtype of an integer codec: the column's own up to 4 bytes, else
    int32 (the reference runs with 64-bit types off)."""
    dt = np.dtype(enc.dtype)
    return dt if dt.itemsize <= 4 else np.dtype(np.int32)


class BitpackCodec:
    name = "bitpack"
    pattern = "fp"
    # bit_width/base are data-dependent scalars: lifted to runtime operands so every
    # same-shaped column shares one compiled program regardless of value range
    lifted_meta = {"bit_width": np.int32, "base": np.int32}

    def encode(self, arr: np.ndarray, bit_width: int | None = None,
               **_: Any) -> tuple[dict[str, np.ndarray], dict]:
        flat = np.asarray(arr).reshape(-1)
        if np.issubdtype(flat.dtype, np.floating):
            raise TypeError("bitpack expects integers (use float2int first)")
        base = int(flat.min()) if flat.size else 0
        shifted = (flat.astype(np.int64) - base)
        bw = bit_width if bit_width is not None else required_bits(int(shifted.max())
                                                                   if flat.size else 0)
        bw = max(1, min(32, bw))
        if shifted.size and int(shifted.max()) >= (1 << bw):
            raise ValueError(f"bit_width {bw} too small for span {int(shifted.max())}")
        return ({"packed": pack_np(shifted, bw)},
                {"bit_width": bw, "base": base})

    def decode_np(self, bufs: dict[str, np.ndarray], meta: dict, n: int,
                  dtype: Any) -> np.ndarray:
        vals = unpack_np(bufs["packed"], n, meta["bit_width"]) + meta["base"]
        return vals.astype(dtype)

    def stages(self, enc, buf_names: dict[str, str], out_name: str,
               meta_names: dict[str, str] | None = None) -> list:
        packed, bw, base = buf_names["packed"], meta_names["bit_width"], meta_names["base"]
        return [FullyParallel(
            chain=(unpack(packed, bw, base),),
            inputs=(packed, bw, base),
            specs=(BufSpec("tile", den=32, num_op=bw), BufSpec("full"), BufSpec("full")),
            out=out_name, n_out=enc.n, out_dtype=out_dtype(enc),
            elementwise=False, name="bitpack")]


def compare_stage(enc, packed_name: str, bw_name: str, base_name: str,
                  out_name: str, lo: int | None, hi: int | None) -> FullyParallel:
    """Compressed-domain range predicate: ``lo <= value < hi`` evaluated on the
    packed field (``UNPACK_RAW -> RANGE``): the unpacked field ``v`` is compared
    in 64 bits against the rebased bounds ``lo - base`` / ``hi - base``, so the
    decoded ``v + base`` (an int32 that can wrap) is never formed.  ``None``
    bounds are open.  The bounds are part of the op (the query's identity,
    which the fused graph's signature digests); ``base`` stays a lifted
    operand, so blobs sharing the structure share the program."""
    return FullyParallel(
        chain=(unpack_raw(packed_name, bw_name), in_range(base_name, lo, hi)),
        inputs=(packed_name, bw_name, base_name),
        specs=(BufSpec("tile", den=32, num_op=bw_name),
               BufSpec("full"), BufSpec("full")),
        out=out_name, n_out=enc.n, out_dtype=np.bool_,
        elementwise=False, name=f"bitpack-cmp[{lo},{hi})")


register(BitpackCodec())
