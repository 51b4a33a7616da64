"""Kernel 4's generator: one straight-line CUDA kernel per fused query program.

The reference compiles every query: ``compile_query_chunk_graph`` wraps the
fused decode and ``Reduce`` in ``jax.jit`` (``src/repro/core/compiler.py:204``),
so XLA emits straight-line code with the query's constants folded in.  The
port's counterpart: ``generate`` turns the register program that
``kernels/query_reduce.py`` builds from a ``Reduce`` (``_Program``: roles,
predicates, instructions, lanes, key, segments) into one CUDA source, and
``digest`` names it.  The source holds only what differs per query -- a
``ZfQgProgram`` with its sizes, its per-thread scalars (``init``: bit widths,
bases, ``RANGE`` bounds and ``I2F_DIV`` divisors, read once) and a per-row
function -- and the library's entry; ``csrc/query_gen.cuh`` holds the tile
loop, the loads, the accumulators and the sums, and fixes the block, the rows
a thread takes and how the words are read.

Every value of a row is a named local, one per role and one per instruction,
so no register file exists that could be indexed at run time.  Op kinds,
element codes, types, casts, predicate modes and constants are compile-time
facts: float constants are literals of their bits (``__uint_as_float(0x...u)``,
the word ``_word`` gives), integer arithmetic wraps as ``zf_q_wrap`` does,
``%`` is floor modulo, and every float operation is an ``_rn`` intrinsic, so
nvcc cannot contract a multiply and an add into an FMA and each row keeps the
bits of ``ref.query_reduce_torch``.

Pure Python: the source and its digest come out the same on any machine; only
the build (``query_reduce.build_programs``) needs ``nvcc``.
"""
from __future__ import annotations

import hashlib

from repro_torch.core.patterns import (BYTES, GATHER, I2F_DIV, LOAD, RANGE, SPAN, UNPACK,
                                       UNPACK_RAW, UNZIGZAG)
from repro_torch.kernels import cuda

HEADERS = ("query_gen.cuh", "zf_chain.cuh")
F32 = 0                                   # the type code of float32 (query_reduce._TYPES)
ROLE_KINDS = {0: "value", 1: "mask", 2: "weight"}
# an int32 value as an integer of type code t, extended back to 32 bits
WRAPS = {4: "{}",
         1: "static_cast<int32_t>(static_cast<uint8_t>({}))",
         -1: "static_cast<int32_t>(static_cast<int8_t>({}))",
         2: "static_cast<int32_t>(static_cast<uint16_t>({}))",
         -2: "static_cast<int32_t>(static_cast<int16_t>({}))"}
CMPS = {0: "<", 1: "<=", 2: ">=", 3: ">"}
PRED_MODES = {0: "int", 1: "float", 2: "int as float"}
FLOAT_OPS = {2: "__fadd_rn({}, {})", 3: "__fsub_rn({}, {})", 4: "__fmul_rn({}, {})",
             5: "zf_qg_fmod({}, {})"}
INT_OPS = {2: "+", 3: "-", 4: "*"}        # 5 (%) is zf_qg_imod
INSTR_OPS = (0, 1, 2, 3, 4, 5)           # const, cast, +, -, *, % (query_reduce._INSTR)
_header_text: dict[str, bytes] = {}


def _hex(word: int) -> str:
    return f"0x{word & 0xFFFFFFFF:08x}u"


def wrap(expr: str, t: int) -> str:
    return WRAPS[_int_type(t)].format(expr)


def _int_type(t: int) -> int:
    if t not in WRAPS:
        raise ValueError(f"no integer type of code {t}")
    return t


def cast_word(expr: str, src: int, to: int) -> str:
    """A register word of type ``src`` as a word of type ``to`` (torch's .to():
    ints wrap, int -> float rounds to nearest, float -> int truncates)."""
    if src == to:
        return expr
    if to == F32:
        _int_type(src)
        return f"__float_as_uint(__int2float_rn(static_cast<int32_t>({expr})))"
    if src == F32:
        return f"static_cast<uint32_t>({wrap(f'__float2int_rz(__uint_as_float({expr}))', to)})"
    _int_type(src)
    return f"static_cast<uint32_t>({wrap(f'static_cast<int32_t>({expr})', to)})"


def cast_value(expr: str, src: int, to: int) -> str:
    """A typed local of type ``src`` (float, or an int32-extended integer) as ``to``."""
    if src == to:
        return expr
    if to == F32:
        _int_type(src)
        return f"__int2float_rn({expr})"
    if src == F32:
        return wrap(f"__float2int_rz({expr})", to)
    _int_type(src)
    return wrap(expr, to)


def binary(op: int, t: int, a: str, b: str) -> str:
    if t == F32:
        if op not in FLOAT_OPS:
            raise ValueError(f"no float instruction {op}")
        return FLOAT_OPS[op].format(a, b)
    if op == 5:
        return wrap(f"zf_qg_imod({a}, {b})", t)
    if op not in INT_OPS:
        raise ValueError(f"no integer instruction {op}")
    return wrap(f"static_cast<int32_t>(static_cast<uint32_t>({a}) {INT_OPS[op]} "
                f"static_cast<uint32_t>({b}))", t)


def predicate(cmp: int, mode: int, reg: str, value: int) -> str:
    if cmp not in CMPS or mode not in PRED_MODES:
        raise ValueError(f"no predicate of compare {cmp} and mode {mode}")
    if mode == 0:
        return f"static_cast<int64_t>({reg}) {CMPS[cmp]} INT64_C({int(value)})"
    x = reg if mode == 1 else f"__int2float_rn({reg})"
    return f"{x} {CMPS[cmp]} __uint_as_float({_hex(value)})"


def slots(prog) -> list[tuple[int, int, int, str]]:
    """The launch struct's buffer slots: (role, op, buffer index, buffer name) in
    role, op and buffer order."""
    out = [(k, o, bi, b) for k, (chain, *_rest) in enumerate(prog.roles)
           for o, op in enumerate(chain) for bi, b in enumerate(op.bufs)]
    if len(out) > cuda.QG_MAX_BUFS:
        raise ValueError(f"{len(out)} buffers exceed the generated kernel's {cuda.QG_MAX_BUFS}")
    return out


class _Writer:
    """The generated program of one ``_Program``."""

    def __init__(self, prog):
        self.prog = prog
        # (role, op, buffer index) -> slot
        self.slot = {key[:3]: s for s, key in enumerate(slots(prog))}
        self.fields: dict[int, int] = {}    # role -> field (a tiled bit-packed source)
        self.field_calls: list[tuple[str, int]] = []   # (buffer, field) in field order
        self.scalars: list[str] = []        # member declarations
        self.init: list[str] = []
        self.body: list[str] = []

    def buf(self, k: int, o: int, b: int = 0) -> str:
        return f"a.bufs[{self.slot[k, o, b]}]"

    def elem(self, k: int, o: int) -> int:
        return self.prog.elems[self.prog.roles[k][0][o].bufs[0]]

    # ----------------------------------------------------------- one role's chain
    def source(self, k: int, op, row: bool) -> str:
        idx = "g" if row else "i"
        if op.kind in (UNPACK, UNPACK_RAW) and not row:
            f = self.fields[k] = len(self.fields)
            self.field_calls.append((self.buf(k, 0), f))
            self.init.append(f"zf_qg_field(f.f{f}, {self.buf(k, 0)}, {self.buf(k, 0, 1)});")
            word = f"zf_qg_raw<kFast>({self.buf(k, 0)}, f.f{f}, j, i)"
            if op.kind == UNPACK_RAW:
                return word
            self.scalar(f"uint32_t base{k}", f"static_cast<uint32_t>(zf_qg_scalar_i32("
                                             f"{self.buf(k, 0, 2)}))")
            return f"{word} + s.base{k}"
        if op.kind in (UNPACK, UNPACK_RAW):        # a resident column at the global row
            self.scalar(f"int32_t bw{k}", f"zf_qg_scalar_i32({self.buf(k, 0, 1)})")
            base = "0u"
            if op.kind == UNPACK:
                self.scalar(f"uint32_t base{k}", f"static_cast<uint32_t>(zf_qg_scalar_i32("
                                                 f"{self.buf(k, 0, 2)}))")
                base = f"s.base{k}"
            p = self.buf(k, 0)
            return (f"zf_unpack_at(static_cast<const uint32_t*>({p}.p), {p}.n - 1, s.bw{k}, "
                    f"{base}, {idx})")
        if op.kind == LOAD:
            return f"zf_read({self.buf(k, 0)}.p, {self.elem(k, 0)}, {idx})"
        if op.kind == BYTES:
            return f"zf_qg_bytes<{int(op.imm)}>({self.buf(k, 0)}.p, {idx})"
        raise ValueError(f"{op}: the generated query kernel has no source op {op.kind!r}")

    def transform(self, k: int, o: int, op, v: str) -> str:
        if op.kind == GATHER:
            p = self.buf(k, o)
            return (f"zf_read({p}.p, {self.elem(k, o)}, "
                    f"zf_jnp_index(static_cast<int32_t>({v}), {p}.n))")
        if op.kind == SPAN:
            p, e = self.buf(k, o), self.elem(k, o)
            return (f"zf_read({p}.p, {e}, zf_jnp_index(static_cast<int32_t>({v} + 1u), {p}.n)) - "
                    f"zf_read({p}.p, {e}, zf_jnp_index(static_cast<int32_t>({v}), {p}.n))")
        if op.kind == I2F_DIV:
            self.scalar(f"float div{k}_{o}", f"zf_qg_scalar_f32({self.buf(k, o)})")
            return (f"__float_as_uint(__fdiv_rn(__int2float_rn(static_cast<int32_t>({v})), "
                    f"s.div{k}_{o}))")
        if op.kind == UNZIGZAG:
            return f"({v} >> 1) ^ (0u - ({v} & 1u))"
        if op.kind == RANGE:
            # the field against the rebased bounds, in 64 bits, so no int32
            # v + base can wrap (algos/bitpack.py compare_stage)
            lo, hi = op.arg
            base = f"static_cast<int64_t>(zf_qg_scalar_i32({self.buf(k, o)}))"
            tests = []
            if lo is not None:
                self.scalar(f"int64_t lo{k}_{o}", f"INT64_C({int(lo)}) - {base}")
                tests.append(f"static_cast<int64_t>({v}) >= s.lo{k}_{o}")
            if hi is not None:
                self.scalar(f"int64_t hi{k}_{o}", f"INT64_C({int(hi)}) - {base}")
                tests.append(f"static_cast<int64_t>({v}) < s.hi{k}_{o}")
            return f"({' && '.join(tests)}) ? 1u : 0u" if tests else "1u"
        raise ValueError(f"{op}: the generated query kernel has no transform op {op.kind!r}")

    def scalar(self, decl: str, value: str) -> None:
        self.scalars.append(f"{decl};")
        self.init.append(f"s.{decl.split()[-1]} = {value};")

    # ------------------------------------------------------------- the program
    def role(self, k: int) -> tuple[str, str]:
        """Emit role k; returns its kind's name and its word's local."""
        chain, kind, row, src, to = self.prog.roles[k]
        if kind not in ROLE_KINDS:
            raise ValueError(f"no role kind {kind}")
        self.body.append(f"  // role {k}: {ROLE_KINDS[kind]}{' (row)' if row else ''}, "
                         + " -> ".join(op.kind for op in chain))
        v = f"v{k}_0"
        self.body.append(f"  const uint32_t {v} = {self.source(k, chain[0], row)};")
        for o, op in enumerate(chain[1:], 1):
            nxt = f"v{k}_{o}"
            self.body.append(f"  const uint32_t {nxt} = {self.transform(k, o, op, v)};")
            v = nxt
        w = f"w{k}"
        self.body.append(f"  const uint32_t {w} = {cast_word(v, src, to)};")
        if kind == 1:
            self.body.append(f"  const bool m{k} = {w} != 0u;")
        elif kind == 2:
            self.body.append(f"  const float wt{k} = __uint_as_float({cast_word(w, to, F32)});")
        elif to == F32:
            self.body.append(f"  const float r{k} = __uint_as_float({w});")
        else:
            self.body.append(f"  const int32_t r{k} = static_cast<int32_t>({w});")
        return ROLE_KINDS[kind]

    def instr(self, ins) -> None:
        op, t, dst, a, b, src, imm = ins
        if op not in INSTR_OPS:
            raise ValueError(f"no instruction {op}")
        ctype = "float" if t == F32 else "int32_t"
        if op == 0:
            expr = (f"__uint_as_float({_hex(imm)})" if t == F32
                    else wrap(f"static_cast<int32_t>({_hex(imm)})", t))
        elif op == 1:
            expr = cast_value(f"r{a}", src, t)
        else:
            expr = binary(op, t, f"r{a}", f"r{b}")
        self.body.append(f"  const {ctype} r{dst} = {expr};")

    def write(self) -> str:
        p = self.prog
        kinds = [self.role(k) for k in range(len(p.roles))]
        conds = [f"m{k}" for k, kind in enumerate(kinds) if kind == "mask"]
        for n, (reg, cmp, mode, value) in enumerate(p.preds):
            self.body.append(f"  const bool p{n} = {predicate(cmp, mode, f'r{reg}', value)};")
            conds.append(f"p{n}")
        for ins in p.instrs:
            self.instr(ins)
        self.body.append(f"  float w = {' && '.join(conds) if conds else 'true'} ? 1.f : 0.f;")
        weights = [f"wt{k}" for k, kind in enumerate(kinds) if kind == "weight"]
        if weights:
            wt = weights[0]
            for x in weights[1:]:
                wt = f"__fmul_rn({wt}, {x})"
            self.body.append(f"  w = __fmul_rn(w, {wt});")
        if p.key >= 0:
            self.body.append(f"  const int32_t seg = r{p.key};")
            self.body.append("  if (seg < 0 || seg >= kSegments) return;   "
                             "// segment_sum drops the row")
        else:
            self.body.append("  const int32_t seg = 0;")
        lanes = [f"r{reg}" for reg in p.lanes]
        self.body.append(f"  acc.add({', '.join(['seg', 'w'] + lanes)});")
        lines = [
            "// Generated by src/repro_torch/kernels/query_codegen.py from one fused query's",
            "// program (kernels/query_reduce.py _Program); the kernel around it is",
            "// csrc/query_gen.cuh.",
            f"// roles {len(p.roles)}, predicates {len(p.preds)}, instructions "
            f"{len(p.instrs)}, lanes {len(p.lanes)}, segments {p.n_segments}",
            '#include "query_gen.cuh"',
            "",
            "struct ZfQgProgram {",
            f"  static constexpr int kFields = {len(self.fields)};",
            f"  static constexpr int kLanes = {len(lanes)};",
            f"  static constexpr int kSegments = {p.n_segments};",
            "",
            "  struct Fields {   // the tiled bit-packed sources",
            *(f"    ZfQgField f{n};" for n in range(len(self.fields))),
            "  };",
            "",
            "  struct Scalars {   // read once per thread",
            *(f"    {d}" for d in self.scalars),
            *([] if self.scalars else ["    int32_t unused;"]),
            "  };",
            "",
            "  static __device__ __forceinline__ void init(const ZfQgArgs& a, Fields& f, "
            "Scalars& s) {",
            *(f"    {x}" for x in self.init),
            "  }",
            "",
            "  // Whether every field takes the 32-bit path (launch-uniform).",
            "  static __device__ __forceinline__ bool fast(const Fields& f) {",
            f"    return {' && '.join(f'f.f{n}.fast' for n in range(len(self.fields))) or 'true'};",
            "  }",
            "",
            "  // Point each field at the tile of rows from t0.",
            "  static __device__ __forceinline__ void at(const ZfQgArgs& a, Fields& f, "
            "int64_t t0) {",
            *(f"    zf_qg_at({b}, f.f{n}, t0);" for b, n in self.field_calls),
            "  }",
            "",
            "  // Row i of the launch (j of its tile; global row g = out_start + i).",
            "  template <bool kFast, class Acc>",
            "  static __device__ __forceinline__ void row(const ZfQgArgs& a, const Fields& f,",
            "                                             const Scalars& s, uint32_t j, "
            "int64_t i, Acc& acc) {",
            *(["    const int64_t g = a.out_start + i;"] if any(r[2] for r in p.roles) else []),
            *(f"  {x}" for x in self.body),
            "  }",
            "};",
            "",
            "ZF_QG_ENTRY(ZfQgProgram)",
            ""]
        return "\n".join(lines)


def generate(prog) -> str:
    """The CUDA source of ``prog``'s kernel."""
    return _Writer(prog).write()


def digest(source: str) -> str:
    """The build's name: the generated source, the headers' text and the nvcc
    flags -- no pointer, length or chunk size, so one build serves every
    launch of a query."""
    h = hashlib.sha1(source.encode())
    for name in HEADERS:
        if name not in _header_text:
            _header_text[name] = (cuda.CSRC / name).read_bytes()
        h.update(name.encode())
        h.update(_header_text[name])
    h.update(" ".join(cuda.NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def ops_per_row(prog) -> tuple[int, int]:
    """(integer, float) operations a row needs by the query's definition, the
    operations bound's numerator: per bit-packed source a shift and a mask
    (and the base's add), per GATHER/SPAN index one (two), per I2F_DIV a
    conversion and a divide, per ``RANGE`` bound and predicate a compare, per
    instruction one, per lane a multiply by the weight and an add, and the
    count's add; integer compares and casts count as integer, float ones as
    float."""
    n_int = n_float = 0
    for chain, kind, row, src, to in prog.roles:
        for op in chain:
            if op.kind in (UNPACK, UNPACK_RAW):
                n_int += 3 if op.kind == UNPACK else 2
            elif op.kind in (GATHER, SPAN):
                n_int += 1 if op.kind == GATHER else 2
            elif op.kind == I2F_DIV:
                n_float += 2
            elif op.kind == UNZIGZAG:
                n_int += 3
            elif op.kind == RANGE:
                n_int += sum(x is not None for x in op.arg)
        if kind == 2:
            n_float += 1
    for reg, cmp, mode, value in prog.preds:
        if mode == 0:
            n_int += 1
        else:
            n_float += 1
    for op, t, dst, a, b, src, imm in prog.instrs:
        if op == 0:
            continue
        if t == F32:
            n_float += 1
        else:
            n_int += 1
    n_float += 2 * len(prog.lanes) + 1
    return n_int, n_float
