"""The ZipFlow parallel patterns (paper §3.1) as a small stage IR over op chains.

A decompression *plan* lowers to a list of stages over named buffers:

  * ``FullyParallel`` -- out[i] = chain(i), no cross-element dependency.
  * ``GroupParallel`` -- variable-sized groups expand 1->N; out[i] is produced from
    the group g owning position i and the within-group offset pos = i - presum[g].
  * ``NonParallel``   -- chunked serial decode (interleaved rANS): chunk c is a
    serial chain of ``chunk_size`` steps, chunks are independent (§4, Fig. 11).
  * ``Aux``           -- whole-array auxiliary ops (prefix sums, exception scatter),
    the paper's "PyTorch out-of-the-box operations" escape hatch (§3.2, Fig. 7).

The reference package expresses per-element work as opaque jnp closures that
Pallas inlines into its kernels.  A CUDA kernel cannot run a Python closure, so
here each stage carries a **declarative op chain** instead: a short tuple of
typed ``Op``s over named buffers, for example ``UNPACK(bw, base) -> GATHER(dict)``.
The plain PyTorch versions (``repro_torch.kernels.ref``) interpret a chain with
whole-array torch ops, and the CUDA kernels interpret the same chain per element
in registers -- one definition, two backends.  Fusion concatenates or moves
chains where the reference composes closures.

Op semantics (each op maps a 32-bit register value; the first op is a *source*
that reads at the element index):

  UNPACK(packed, bw_op, base_op)  bit-unpack element i of a FOR-bitpacked uint32
                                  stream (``algos/bitpack.py``), result int32
  LOAD(buf)                       buf[i]
  BYTES(buf, itemsize)            bytes buf[i*itemsize + k], k < min(itemsize, 4),
                                  little-endian in one 32-bit word: the bits of
                                  the output element (rANS byte-reassemble)
  GATHER(table)                   table[v]                       (dictionary)
  SPAN(offs)                      offs[v+1] - offs[v]            (stringdict)
  I2F_DIV(scale)                  float32(v) / scale[0]          (float2int)
  UNZIGZAG                        (v >> 1) ^ -(v & 1) on uint32  (delta)

Buffers may hold 8-, 16- or 32-bit elements; an op reads an element at its own
width (sign-extending signed ones), so uint8 and uint16 leaves reach the device
as they are.  Table lookups index like jnp: a negative index wraps once, then
the index is clamped into range.

Data-dependent scalar metadata (bitpack ``bit_width``/``base``, delta ``base``)
arrives as (1,)-shaped operand buffers listed among a stage's inputs with
``BufSpec("full")``, so one program serves every blob sharing the structure.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np


# --- chunkability levels (what output boundaries a stage can be split at) ---
CHUNK_ELEMENT = "element"
CHUNK_GROUP = "group"
CHUNK_NONE = "none"


@dataclasses.dataclass(frozen=True)
class BufSpec:
    """How an input buffer is tiled relative to the output tile.

    kind="tile": output range [o0, o1) reads input range [o0*num//den, o1*num//den);
    bitpack uses den=32 on uint32 words.  kind="full": whole buffer (small
    metadata: dictionaries, scalars).  ``num_op`` names a runtime meta operand
    that supplies ``num`` (bitpack's ``bit_width``).
    """

    kind: str = "tile"  # "tile" | "full"
    num: int = 1
    den: int = 1
    pad: int = 0
    num_op: str = ""


# ------------------------------------------------------------------------- ops
UNPACK = "unpack"
LOAD = "load"
BYTES = "bytes"
GATHER = "gather"
SPAN = "span"
I2F_DIV = "i2f_div"
UNZIGZAG = "unzigzag"
SOURCE_OPS = (UNPACK, LOAD, BYTES)
OP_KINDS = (UNPACK, LOAD, BYTES, GATHER, SPAN, I2F_DIV, UNZIGZAG)


@dataclasses.dataclass(frozen=True)
class Op:
    """One step of an op chain: ``kind``, the buffer names it reads and, for
    ``BYTES``, an immediate (the item size)."""

    kind: str
    bufs: tuple[str, ...] = ()
    imm: int = 0

    def __post_init__(self):
        if self.kind not in OP_KINDS:
            raise ValueError(f"unknown op kind {self.kind!r}")

    def __str__(self) -> str:
        args = list(self.bufs) + ([str(self.imm)] if self.kind == BYTES else [])
        return f"{self.kind.upper()}({', '.join(args)})"


def unpack(packed: str, bw_op: str, base_op: str) -> Op:
    return Op(UNPACK, (packed, bw_op, base_op))


def load(buf: str) -> Op:
    return Op(LOAD, (buf,))


def load_bytes(buf: str, itemsize: int) -> Op:
    return Op(BYTES, (buf,), imm=int(itemsize))


def gather(table: str) -> Op:
    return Op(GATHER, (table,))


def span(offs: str) -> Op:
    return Op(SPAN, (offs,))


def i2f_div(scale: str) -> Op:
    return Op(I2F_DIV, (scale,))


def unzigzag() -> Op:
    return Op(UNZIGZAG)


Chain = tuple[Op, ...]


def check_chain(chain: Chain, source: bool = True) -> Chain:
    """A chain is one source op (read at the index) followed by transforms; a
    GP tail is transforms only (``source=False``)."""
    chain = tuple(chain)
    heads = chain[:1] if source else ()
    if source and (not chain or chain[0].kind not in SOURCE_OPS):
        raise ValueError(f"chain must start with a source op: {chain}")
    for op in chain[len(heads):]:
        if op.kind in SOURCE_OPS:
            raise ValueError(f"source op {op} inside a chain: {chain}")
    return chain


# ---------------------------------------------------------------------- stages
class Stage:
    out: str
    n_out: int
    out_dtype: np.dtype
    chunkability = CHUNK_NONE   # overridden per pattern (not a dataclass field)


@dataclasses.dataclass
class FullyParallel(Stage):
    """out[i] = chain evaluated at i;   inputs[k] tiled per specs[k]."""

    chain: Chain
    inputs: tuple[str, ...]
    specs: tuple[BufSpec, ...]
    out: str = "out"
    n_out: int = 0
    out_dtype: Any = np.dtype(np.int32)
    elementwise: bool = True   # True iff the chain reads inputs[0] only at i
    name: str = "fp"
    chunkability = CHUNK_ELEMENT

    def __post_init__(self):
        self.chain = check_chain(self.chain)
        self.out_dtype = np.dtype(self.out_dtype)


IDENTITY = "identity"    # out = value (RLE)
AFFINE = "affine"        # out = start + stride * pos, values = (start, stride)
STRGATHER = "strgather"  # out = chars[offs[value] + pos] (StringDict)
MAP_KINDS = (IDENTITY, AFFINE, STRGATHER)


@dataclasses.dataclass
class GroupParallel(Stage):
    """Balanced 1->N expansion (paper §4 'Scheduling Group-Parallel for Load
    Balance').

    out[i]:  g   = searchsorted(presum, i, side='right') - 1
             pos = i - presum[g]
             v_k = values[k] evaluated at g
             out[i] = tail(map(v, pos))

    ``presum`` is the inclusive prefix sum of group counts with a leading 0
    (length n_groups+1).  Each entry of ``values`` is an op chain evaluated at
    the group index; absorbing a preceding Fully-Parallel producer (fusion rule
    2) replaces a ``LOAD`` chain with the producer's chain -- the paper's Fig.
    7(c) fusion of bit-packing into the RLE kernel.  ``tail`` holds elementwise
    ops absorbed from a consumer (fusion rule 3).  The ``STRGATHER`` map
    (StringDict) reads the word bytes and offsets named by ``extra_inputs``.
    """

    presum: str
    value_inputs: tuple[str, ...]
    value_specs: tuple[BufSpec, ...]
    values: tuple[Chain, ...]
    map_kind: str = IDENTITY
    tail: Chain = ()
    out: str = "out"
    n_out: int = 0
    out_dtype: Any = np.dtype(np.int32)
    n_groups: int = 0
    extra_inputs: tuple[str, ...] = ()
    name: str = "gp"
    # per-group output offsets computed by the encoder on the host (planning
    # data only; identified by dtype/shape in the signature, never transferred)
    host_group_presum: Any = None
    # True while ``values`` is a single plain LOAD (fusion rule 2 may absorb)
    identity_values: bool = True
    chunkability = CHUNK_GROUP

    def __post_init__(self):
        self.values = tuple(check_chain(c) for c in self.values)
        self.tail = check_chain(self.tail, source=False)
        self.out_dtype = np.dtype(self.out_dtype)
        if self.map_kind not in MAP_KINDS:
            raise ValueError(f"unknown map kind {self.map_kind!r}")
        if len(self.values) != (2 if self.map_kind == AFFINE else 1):
            raise ValueError(f"{self.map_kind} map takes "
                             f"{2 if self.map_kind == AFFINE else 1} value chains")
        if self.map_kind == STRGATHER and len(self.extra_inputs) != 2:
            raise ValueError("the strgather map takes extra_inputs (chars, offsets)")


@dataclasses.dataclass
class NonParallel(Stage):
    """Chunked serial decode, one chunk per thread in lockstep (paper §4 'towards
    SIMT'), specialised to interleaved rANS (``algos/ans.py``).

    Buffers: ``streams`` (max_words, n_chunks) uint16 words, chunk-transposed so
    word t of every chunk is one row; ``states`` (n_chunks,) uint32 initial
    decoder states (staged as int32 bits); ``sym_tab`` (4096,) uint8,
    ``freq_tab``/``cum_tab`` (256,) uint16.  Chunk c decodes the symbols
    out[c*chunk_size : (c+1)*chunk_size] (the last chunk is cut at ``n_out``), and
    each symbol goes through ``tail``: the elementwise ops of a consumer absorbed
    by fusion rule 4 (the reference's ``out_map``).
    """

    streams: str
    states: str
    sym_tab: str
    freq_tab: str
    cum_tab: str
    chunk_size: int
    n_chunks: int
    tail: Chain = ()
    out: str = "out"
    n_out: int = 0
    out_dtype: Any = np.dtype(np.uint8)
    name: str = "np"
    # actual (pre-padding) word count per chunk, host planning data emitted by
    # the encoder; identified by dtype/shape only, never transferred
    host_group_words: Any = None
    # serial within a chunk, but chunks are independent: splits where whole
    # chunks (= groups) do
    chunkability = CHUNK_GROUP

    def __post_init__(self):
        self.tail = check_chain(self.tail, source=False)
        self.out_dtype = np.dtype(self.out_dtype)


@dataclasses.dataclass
class Aux(Stage):
    """Whole-array auxiliary torch op (prefix sum, scatter-patch).  Fusion barrier.

    ``fn(*[env[a] for a in args])`` computes the output.  Fusion rule 5 folds a
    Fully-Parallel producer of ``args[0]`` into the Aux: the producer is kept as
    a stage in ``producers`` (run in order, each materializing its output into
    a local env before ``fn``), so a kernel backend still runs it as a kernel.
    ``inputs`` lists what the Aux reads from the outer env, as in the reference.
    """

    fn: Callable[..., Any]
    inputs: tuple[str, ...]
    out: str = "out"
    n_out: int = 0
    out_dtype: Any = np.dtype(np.int32)
    name: str = "aux"
    args: tuple[str, ...] = ()
    producers: tuple[FullyParallel, ...] = ()
    chunkability = CHUNK_NONE

    def __post_init__(self):
        self.out_dtype = np.dtype(self.out_dtype)
        if not self.args:
            self.args = tuple(self.inputs)


# --------------------------------------------------------------------- helpers
def compose_fp(first: FullyParallel, second: FullyParallel) -> FullyParallel:
    """Fuse two Fully-Parallel stages: second(first(x)).  The second stage must
    be elementwise in its primary input, i.e. its chain starts ``LOAD(first.out)``,
    so the composed chain is ``first.chain`` followed by the rest of ``second``'s."""
    if not second.elementwise or second.chain[0] != load(first.out):
        raise ValueError(f"cannot compose {first.name} into {second.name}")
    return FullyParallel(
        chain=first.chain + second.chain[1:],
        inputs=first.inputs + second.inputs[1:],
        specs=first.specs + second.specs[1:],
        out=second.out, n_out=second.n_out, out_dtype=second.out_dtype,
        elementwise=first.elementwise,
        name=f"{first.name}+{second.name}")


def stage_inputs(st: Stage) -> tuple[str, ...]:
    """Every env name a stage reads."""
    if isinstance(st, GroupParallel):
        return (st.presum,) + st.value_inputs + st.extra_inputs
    if isinstance(st, NonParallel):
        return (st.streams, st.states, st.sym_tab, st.freq_tab, st.cum_tab)
    return tuple(getattr(st, "inputs", ()))
