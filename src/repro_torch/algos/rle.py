"""Run-Length Encoding (paper §2.1/§3.1, the Group-Parallel exemplar).

Encode: maximal runs -> (values, counts).  Decode: presum = exclusive prefix sum of
counts (the one-time data scan, an Aux), then the balanced Group-Parallel expansion
replicates values[g] across out[presum[g] : presum[g+1]] (identity map).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.algos.bitpack import out_dtype
from repro_torch.core.patterns import IDENTITY, Aux, BufSpec, GroupParallel, load
from repro_torch.core.registry import register
from repro_torch.kernels.ref import wrap_i32


def rle_encode_np(flat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    if flat.size == 0:
        return flat[:0], np.zeros(0, np.int64)
    change = np.flatnonzero(np.diff(flat) != 0) + 1
    starts = np.concatenate([[0], change])
    counts = np.diff(np.concatenate([starts, [flat.size]]))
    return flat[starts], counts.astype(np.int64)


def presum(counts: torch.Tensor) -> torch.Tensor:
    """[0, c0, c0+c1, ...] in int32, wrapping mod 2^32 like the reference."""
    c = torch.cumsum(counts.to(torch.int32).to(torch.int64), 0)
    zero = torch.zeros(1, dtype=torch.int32, device=counts.device)
    return torch.cat([zero, wrap_i32(c)])


class RleCodec:
    name = "rle"
    pattern = "gp"
    # host-side planning metadata: per-group output offsets.  Identified by
    # dtype/shape only, never by value (see ir._meta_tokens)
    host_meta = ("group_presum",)

    def encode(self, arr: np.ndarray, **_: Any) -> tuple[dict[str, np.ndarray], dict]:
        flat = np.asarray(arr).reshape(-1)
        values, counts = rle_encode_np(flat)
        group_presum = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return ({"values": values, "counts": counts.astype(np.int32)},
                {"n_groups": int(values.size), "group_presum": group_presum})

    def decode_np(self, bufs: dict[str, np.ndarray], meta: dict, n: int,
                  dtype: Any) -> np.ndarray:
        return np.repeat(np.asarray(bufs["values"]),
                         np.asarray(bufs["counts"]).astype(np.int64))[:n].astype(dtype)

    def stages(self, enc, buf_names: dict[str, str], out_name: str,
               meta_names: dict[str, str] | None = None) -> list:
        presum_name = f"{out_name}.presum"
        n_groups = int(enc.meta["n_groups"])
        values = buf_names["values"]
        return [
            Aux(fn=presum, inputs=(buf_names["counts"],), out=presum_name,
                n_out=n_groups + 1, out_dtype=np.int32, name="rle-presum"),
            GroupParallel(
                presum=presum_name, value_inputs=(values,),
                value_specs=(BufSpec("tile"),), values=((load(values),),),
                map_kind=IDENTITY, out=out_name, n_out=enc.n,
                out_dtype=out_dtype(enc), n_groups=n_groups,
                host_group_presum=enc.meta.get("group_presum"), name="rle-expand"),
        ]


def run_reduce_graph(enc, pred, projs, digest: str, prefix: str = "root"):
    """Per-run fused aggregation for an RLE column (never per row).

    A predicate over an RLE column is constant within a run, so a predicated
    sum collapses to run-length-weighted arithmetic over the run axis:

        partial[l] = sum_g counts_g * pred(values_g) * proj_l(values_g)

    The runs' values/counts children decode at run granularity (``n_groups``
    elements) and feed a terminal ``Reduce`` with ``n_in = n_groups`` -- the
    expansion to ``enc.n`` rows never happens, and chunked execution streams
    spans of runs.  ``pred`` (a ``query.Pred``, or None) and the projections
    (``query`` expressions) read the run values as column ``prefix``; the
    counts are the Reduce's weight role.  Returns a fused, Reduce-terminated
    ``DecodeGraph`` whose last lane is the run-length-weighted selected-row
    count.  ``digest`` distinguishes queries on structurally identical blobs
    (the reference takes closures; its graph, signature and lanes are the
    same)."""
    import dataclasses

    from repro_torch.core import fusion, ir as ir_mod, plan as plan_mod
    from repro_torch.core.compiler import device_layout
    from repro_torch.core.patterns import VALUE, WEIGHT, Reduce, Role

    n_groups = int(enc.meta["n_groups"])
    stages: list = []
    names: dict[str, str] = {}
    dtypes: dict[str, np.dtype] = {}
    for slot in ("values", "counts"):
        if slot in enc.children:
            out = f"{prefix}/{slot}.runs"
            child = plan_mod.lower(enc.children[slot], prefix=f"{prefix}/{slot}",
                                   out_name=out)
            stages += child
            names[slot], dtypes[slot] = out, child[-1].out_dtype
        elif slot in enc.buffers:
            names[slot] = f"{prefix}.{slot}"
            dtypes[slot] = device_layout(enc.buffers[slot][:0]).dtype
        else:
            raise ValueError(f"rle blob has no {slot!r} child or buffer")
    # children lowered on their own Encoded have n == n_groups, so every stage
    # works the run axis; guard against anything expanding to the row axis
    for st in stages:
        if enc.n != n_groups and getattr(st, "n_out", 0) == enc.n:
            raise ValueError(f"per-run path leaked a per-row stage: {st.name}")
    red = Reduce(
        roles=(Role(VALUE, prefix, (load(names["values"]),), dtypes["values"]),
               Role(WEIGHT, f"{prefix}.counts", (load(names["counts"]),),
                    dtypes["counts"])),
        inputs=(names["values"], names["counts"]),
        specs=(BufSpec("tile"), BufSpec("tile")), lanes=tuple(projs),
        preds=() if pred is None else (pred,), n_in=n_groups, out=f"{prefix}.agg",
        n_out=len(projs) + 1, name="rle-run-reduce")
    graph = ir_mod.graph_from_encoded(enc, stages + [red])
    graph = dataclasses.replace(graph, signature=f"{graph.signature}+runq:{digest}")
    return fusion.fuse_graph(graph)


register(RleCodec())
