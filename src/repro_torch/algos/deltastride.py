"""DeltaStride (paper §5.3: an RLE variant for monotone sequences; Group-Parallel).

Encode: maximal runs of constant stride -> (start, stride, count) triples.  A sorted
primary-key column becomes a handful of triples.  Decode: out[i] = start[g] +
stride[g] * pos, a Group-Parallel expansion with the ``AFFINE`` map (int32, wrapping).
"""
from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.algos.bitpack import out_dtype
from repro_torch.algos.rle import presum
from repro_torch.core.patterns import AFFINE, Aux, BufSpec, GroupParallel, load
from repro_torch.core.registry import register


def deltastride_encode_np(flat: np.ndarray):
    """Greedy maximal constant-stride runs, vectorized.

    Let d = diff(flat) and rb = [0, c_1, ..., c_k, len(d)] the boundaries of maximal
    equal-value runs of d.  The first diff-run claims elements [0, rb[1]]; every later
    diff-run [rb[k], rb[k+1]) claims elements [rb[k]+1, rb[k+1]] (its boundary element
    already belongs to the previous run).  Counts therefore telescope to n exactly.
    """
    n = flat.size
    flat64 = flat.astype(np.int64)
    if n == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    if n == 1:
        return flat64[:1], np.zeros(1, np.int64), np.ones(1, np.int64)
    d = np.diff(flat64)
    change = np.flatnonzero(np.diff(d) != 0) + 1
    rb = np.concatenate([[0], change, [d.size]])  # diff-run boundaries, len k+2
    k = rb.size - 1                               # number of diff-runs
    counts = np.empty(k, np.int64)
    counts[0] = rb[1] + 1
    counts[1:] = np.diff(rb)[1:]
    first_elem = np.empty(k, np.int64)
    first_elem[0] = 0
    first_elem[1:] = rb[1:-1] + 1
    starts = flat64[first_elem]
    strides = d[rb[:-1]]
    return starts, strides, counts


class DeltaStrideCodec:
    name = "deltastride"
    pattern = "gp"
    # per-group output offsets, host planning data (see RleCodec.host_meta)
    host_meta = ("group_presum",)

    def encode(self, arr: np.ndarray, **_: Any) -> tuple[dict[str, np.ndarray], dict]:
        flat = np.asarray(arr).reshape(-1)
        starts, strides, counts = deltastride_encode_np(flat)
        group_presum = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return ({"starts": starts.astype(np.int32),
                 "strides": strides.astype(np.int32),
                 "counts": counts.astype(np.int32)},
                {"n_groups": int(counts.size), "group_presum": group_presum})

    def decode_np(self, bufs: dict[str, np.ndarray], meta: dict, n: int,
                  dtype: Any) -> np.ndarray:
        starts = np.asarray(bufs["starts"]).astype(np.int64)
        strides = np.asarray(bufs["strides"]).astype(np.int64)
        counts = np.asarray(bufs["counts"]).astype(np.int64)
        g = np.repeat(np.arange(counts.size), counts)
        group_presum = np.concatenate([[0], np.cumsum(counts)])
        pos = np.arange(g.size) - group_presum[g]
        return (starts[g] + strides[g] * pos)[:n].astype(dtype)

    def stages(self, enc, buf_names: dict[str, str], out_name: str,
               meta_names: dict[str, str] | None = None) -> list:
        presum_name = f"{out_name}.presum"
        n_groups = int(enc.meta["n_groups"])
        starts, strides = buf_names["starts"], buf_names["strides"]
        return [
            Aux(fn=presum, inputs=(buf_names["counts"],), out=presum_name,
                n_out=n_groups + 1, out_dtype=np.int32, name="ds-presum"),
            GroupParallel(
                presum=presum_name, value_inputs=(starts, strides),
                value_specs=(BufSpec("tile"), BufSpec("tile")),
                values=((load(starts),), (load(strides),)), map_kind=AFFINE,
                out=out_name, n_out=enc.n, out_dtype=out_dtype(enc),
                n_groups=n_groups, host_group_presum=enc.meta.get("group_presum"),
                name="deltastride-expand", identity_values=False),
        ]


register(DeltaStrideCodec())
