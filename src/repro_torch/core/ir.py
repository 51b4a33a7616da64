"""Decode-graph IR: the program representation between Plan and executor.

``plan.lower_graph`` produces a ``DecodeGraph`` from a compressed blob and
``fusion.fuse_graph`` rewrites it; the compiler consumes graphs.  A graph carries
the stage list plus:

  * **buffer defs** -- name/shape/dtype of every leaf buffer that moves host->device;
  * **meta specs** -- the *lifted* data-dependent metadata (bitpack ``bit_width``/
    ``base``, delta ``base``) that enters the program as runtime operands,
    identified by name/dtype/shape only;
  * **output spec** -- final buffer name, length, dtype;
  * **structural signature** -- a digest of the codec tree, structural metadata,
    leaf shapes/dtypes and lifted-operand specs.  Equal signatures lower to
    interchangeable programs, so one compiled program serves all such blobs.  The
    digest is byte-identical to the reference package's for the same blob.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Iterator, TYPE_CHECKING

import numpy as np

from repro_torch.core import registry
from repro_torch.core.patterns import Stage

if TYPE_CHECKING:  # avoid a hard import cycle with repro_torch.core.plan
    from repro_torch.core.plan import Encoded


@dataclasses.dataclass(frozen=True)
class BufferDef:
    """One leaf buffer of a compressed blob (what actually transfers)."""

    name: str                 # hierarchical name, e.g. "root/index.packed"
    shape: tuple[int, ...]
    dtype: str                # numpy dtype string


@dataclasses.dataclass(frozen=True)
class MetaSpec:
    """One lifted meta operand: program identity is (name, shape, dtype) -- never
    the value.  The value rides along at call time as a tiny device buffer."""

    name: str                 # hierarchical operand name, e.g. "root.@bit_width"
    shape: tuple[int, ...]
    dtype: str


@dataclasses.dataclass
class DecodeGraph:
    """A lowered (possibly fused) decode program: stages over named buffers."""

    stages: list[Stage]
    buffers: tuple[BufferDef, ...]   # leaf inputs, in lowering order
    out: str                         # final output buffer name
    n_out: int
    out_dtype: str
    signature: str                   # structural digest (see module docstring)
    meta_specs: tuple[MetaSpec, ...] = ()   # lifted runtime operands
    nesting: str = ""                # human-readable codec nesting, e.g. "rle[bp]"
    fused: bool = False


# ------------------------------------------------------------------- signature

def _meta_tokens(meta: dict[str, Any], lifted: dict[str, Any],
                 host: tuple[str, ...] = ()) -> Iterator[str]:
    for k in sorted(meta):
        if k in lifted:
            # a runtime operand: dtype/shape are identity, the value is not
            yield f"{k}~operand:{np.dtype(lifted[k]).str}:(1,)"
            continue
        if k in host:
            # host planning meta (per-group offsets): dtype/shape only
            v = np.asarray(meta[k])
            yield f"{k}~host:{v.dtype.str}:{tuple(v.shape)}"
            continue
        v = meta[k]
        if isinstance(v, np.ndarray):
            digest = hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest()[:12]
            yield f"{k}=nd{v.shape}{v.dtype}:{digest}"
        elif isinstance(v, (bool, int, float, str, np.integer, np.floating)):
            yield f"{k}={v!r}"
        elif isinstance(v, (tuple, list)):
            yield f"{k}={type(v).__name__}{tuple(v)!r}"
        else:
            # unknown meta types cannot be content-hashed; refusing beats a silent
            # signature collision that would share a program with wrong constants
            raise TypeError(
                f"cannot signature meta value {k!r} of type {type(v).__name__}; "
                "use scalars, strings, tuples/lists, or ndarrays")


def _encoded_tokens(enc: "Encoded") -> Iterator[str]:
    yield f"codec={enc.codec};n={enc.n};dtype={np.dtype(enc.dtype).str}"
    codec = registry.get(enc.codec)
    lifted = getattr(codec, "lifted_meta", {})
    host = tuple(getattr(codec, "host_meta", ()))
    yield from _meta_tokens(enc.meta, lifted, host)
    for name in sorted(enc.buffers):
        b = enc.buffers[name]
        yield f"buf:{name}:{tuple(b.shape)}:{np.dtype(b.dtype).str}"
    for slot in sorted(enc.children):
        yield f"child:{slot}("
        yield from _encoded_tokens(enc.children[slot])
        yield ")"


def structural_signature(enc: "Encoded") -> str:
    """Digest of codec tree + structural metadata + leaf shapes/dtypes + lifted
    operand specs (equal signatures <=> interchangeable programs)."""
    h = hashlib.sha1()
    for tok in _encoded_tokens(enc):
        h.update(tok.encode())
        h.update(b"\x00")
    return h.hexdigest()


def describe_encoded(enc: "Encoded") -> str:
    """Nesting string in the paper's Table-2 notation, from the blob side."""
    if not enc.children:
        return enc.codec
    inner = ", ".join(f"{k}={describe_encoded(v)}" for k, v in enc.children.items())
    return f"{enc.codec}[{inner}]"


def graph_from_encoded(enc: "Encoded", stages: list[Stage]) -> DecodeGraph:
    """Assemble a DecodeGraph around an already-lowered stage list."""
    from repro_torch.core import plan as plan_mod

    flat = plan_mod.flat_buffers(enc)
    buffers = tuple(BufferDef(name=k, shape=tuple(v.shape),
                              dtype=np.dtype(v.dtype).str)
                    for k, v in flat.items())
    ops = plan_mod.meta_operands(enc)
    meta_specs = tuple(MetaSpec(name=k, shape=tuple(v.shape),
                                dtype=np.dtype(v.dtype).str)
                       for k, v in ops.items())
    final = stages[-1]
    return DecodeGraph(
        stages=list(stages), buffers=buffers, out=final.out,
        n_out=int(final.n_out), out_dtype=np.dtype(final.out_dtype).str,
        signature=structural_signature(enc), meta_specs=meta_specs,
        nesting=describe_encoded(enc))
