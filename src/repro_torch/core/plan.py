"""Nesting Layer (paper §3.2): compression-plan trees and compressed blobs.

A ``Plan`` is a tree: a codec plus child plans attached to named output buffers of that
codec's encoder (paper Table 2, e.g. ``RLE[DeltaStride[...], Bit-packing]``).  Encoding
recursively compresses the designated buffers; the remaining *leaf* buffers are what
actually moves host->device.  Decoding lowers the tree post-order into a stage list
(``repro_torch.core.patterns``) which the fusion pass then optimizes.

The blob format is the reference package's, field for field, so one blob feeds
both packages (``encoded_from_reference``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core import registry
from repro_torch.core.patterns import Stage


@dataclasses.dataclass
class Plan:
    codec: str
    params: dict[str, Any] = dataclasses.field(default_factory=dict)
    children: dict[str, "Plan"] = dataclasses.field(default_factory=dict)

    def describe(self) -> str:
        """Human-readable nesting string in the paper's Table-2 notation."""
        base = self.codec
        if not self.children:
            return base
        inner = ", ".join(f"{k}={v.describe()}" for k, v in self.children.items())
        return f"{base}[{inner}]"


def make_plan(codec: str, /, **children: "Plan | None") -> Plan:
    """Convenience constructor: ``make_plan('rle', counts=make_plan('bitpack'))``."""
    kids = {k: v for k, v in children.items() if v is not None}
    return Plan(codec, children=kids)


@dataclasses.dataclass
class Encoded:
    """A compressed blob: leaf buffers (transferred) + static metadata + children."""

    codec: str
    meta: dict[str, Any]
    buffers: dict[str, np.ndarray]
    children: dict[str, "Encoded"]
    n: int
    dtype: Any

    @property
    def compressed_nbytes(self) -> int:
        total = sum(int(b.nbytes) for b in self.buffers.values())
        return total + sum(c.compressed_nbytes for c in self.children.values())

    @property
    def plain_nbytes(self) -> int:
        return int(self.n) * int(np.dtype(self.dtype).itemsize)

    @property
    def ratio(self) -> float:
        """Compression ratio = plain / compressed (larger is better)."""
        c = self.compressed_nbytes
        return float("inf") if c == 0 else self.plain_nbytes / c


def encode(p: Plan, arr: np.ndarray) -> Encoded:
    codec = registry.get(p.codec)
    bufs, meta = codec.encode(np.asarray(arr), **p.params)
    children = {}
    for slot, sub in p.children.items():
        if slot not in bufs:
            raise KeyError(f"{p.codec} has no buffer slot '{slot}' "
                           f"(has {sorted(bufs)})")
        children[slot] = encode(sub, bufs.pop(slot))
    return Encoded(codec=p.codec, meta=meta, buffers=bufs, children=children,
                   n=int(arr.size), dtype=arr.dtype)


def encoded_from_reference(enc: Any) -> Encoded:
    """The port's ``Encoded`` for a blob made by the reference package.

    Duck-typed over ``.codec/.meta/.buffers/.children/.n/.dtype`` with numpy
    arrays, so this module never imports the reference."""
    return Encoded(
        codec=str(enc.codec), meta=dict(enc.meta),
        buffers={k: np.asarray(v) for k, v in enc.buffers.items()},
        children={k: encoded_from_reference(c) for k, c in enc.children.items()},
        n=int(enc.n), dtype=np.dtype(enc.dtype))


def decode_np(enc: Encoded) -> np.ndarray:
    """Pure-numpy recursive oracle (independent of the torch and CUDA paths)."""
    codec = registry.get(enc.codec)
    bufs = dict(enc.buffers)
    for slot, child in enc.children.items():
        bufs[slot] = decode_np(child)
    return codec.decode_np(bufs, enc.meta, enc.n, enc.dtype)


def flat_buffers(enc: Encoded, prefix: str = "root") -> dict[str, np.ndarray]:
    """Leaf buffers under hierarchical names -- the arrays that move host->device."""
    out = {f"{prefix}.{k}": v for k, v in enc.buffers.items()}
    for slot, child in enc.children.items():
        out.update(flat_buffers(child, f"{prefix}/{slot}"))
    return out


def _meta_operand_names(codec, prefix: str) -> dict[str, str]:
    # "@" keeps operand names disjoint from buffer names (buffers never contain it)
    return {k: f"{prefix}.@{k}" for k in getattr(codec, "lifted_meta", {})}


def meta_operands(enc: Encoded, prefix: str = "root") -> dict[str, np.ndarray]:
    """Lifted meta values as (1,)-shaped arrays under their operand names.

    Integer values route through int64 so out-of-range bases wrap mod 2^32."""
    codec = registry.get(enc.codec)
    out: dict[str, np.ndarray] = {}
    for key, dt in getattr(codec, "lifted_meta", {}).items():
        v = enc.meta[key]
        if np.issubdtype(np.dtype(dt), np.integer):
            out[f"{prefix}.@{key}"] = np.asarray([v], np.int64).astype(dt)
        else:
            out[f"{prefix}.@{key}"] = np.asarray([v], dt)
    for slot, child in enc.children.items():
        out.update(meta_operands(child, f"{prefix}/{slot}"))
    return out


def host_operands(enc: Encoded) -> dict[str, np.ndarray]:
    """Everything a compiled Program consumes: leaf buffers + lifted meta operands."""
    return {**flat_buffers(enc), **meta_operands(enc)}


def lower(enc: Encoded, prefix: str = "root", out_name: str | None = None) -> list[Stage]:
    """Lower a compressed blob to a stage list (children first, post-order)."""
    codec = registry.get(enc.codec)
    stages: list[Stage] = []
    buf_names: dict[str, str] = {k: f"{prefix}.{k}" for k in enc.buffers}
    for slot, child in enc.children.items():
        child_out = f"{prefix}/{slot}.decoded"
        stages.extend(lower(child, f"{prefix}/{slot}", out_name=child_out))
        buf_names[slot] = child_out
    out = out_name or f"{prefix}.decoded"
    stages.extend(codec.stages(enc, buf_names, out,
                               meta_names=_meta_operand_names(codec, prefix)))
    return stages


def lower_graph(enc: Encoded):
    """Lower a compressed blob to a DecodeGraph: the stage list plus buffer defs and
    the structural signature the ProgramCache keys on (repro_torch.core.ir)."""
    from repro_torch.core import ir

    return ir.graph_from_encoded(enc, lower(enc))
