"""Kernel 4's generator (``kernels/query_codegen.py``) on the CPU: no ``nvcc`` needed.

The generated CUDA source of TPC-H Q1 and Q6 (SF 0.002, seed 0), the four
expression-semantics queries and the RLE/compare-mask queries of the card tests
(``tests/test_torch_cuda.py``):

  * the digest: the same program gives the same text and digest; a changed
    predicate constant changes it; a changed chunk size or pointer does not;
  * no register file: every register of ``_Program`` is one named local, no
    array is indexed at run time, and the source holds as many roles,
    predicates and instructions as the program;
  * constants: every literal is the word ``_word`` gives;
  * coverage: every op kind, role kind, cast type pair, instruction and
    predicate mode the program can emit has an emitter, and an unknown one
    raises;
  * the per-launch struct: buffer pointers in role order, the launch's own
    fields, the counter at the scratch's end;
  * no fallback: a failed ``nvcc`` raises and builds and launches nothing;
  * the types a lowered query's launches see are the ones ``lower_query``
    builds its kernel for.
"""
import re
import struct

import numpy as np
import pytest
import torch

from repro_torch.algos.bitpack import pack_np
from repro_torch.core.compiler import device_layout
from repro_torch.core.patterns import (BufSpec, Reduce, Role, gather, i2f_div, in_range,
                                       load, load_bytes, span, unpack, unpack_raw, unzigzag)
from repro_torch.core.plan import encode, host_operands
from repro_torch.core.query import Bin, Col, Const, Pred, lower_query
from repro_torch.data.columns import TABLE2_PLANS
from repro_torch.data.loader import ColumnPipeline
from repro_torch.data.queries import Q1_PLAN, Q6_PLAN
from repro_torch.data.tpch import QUERY_COLUMNS, generate
from repro_torch.kernels import cuda, query_codegen as G, ref
from repro_torch.kernels import query_reduce as QR
from test_torch_cuda import SEMANTICS, _rle_case, _semantics_query

PLANS = ["q1", "q6", *SEMANTICS, "rle-runs", "wide-range"]


def _host_env(operands: dict, resident: dict | None = None) -> dict:
    env = {k: torch.from_numpy(device_layout(v)) for k, v in operands.items()}
    env.update(resident or {})
    return env


@pytest.fixture(scope="module")
def cols():
    return generate(0.002, seed=0)


def _stage(name: str, cols: dict):
    """(Reduce, CPU inputs) of one of ``PLANS``."""
    if name in ("q1", "q6"):
        q = int(name[1])
        encs = {c: encode(TABLE2_PLANS[c], cols[c]) for c in QUERY_COLUMNS[q]}
        fq = lower_query({1: Q1_PLAN, 6: Q6_PLAN}[q], encs)
        return fq.graph.stages[-1], _host_env(fq.operands, {
            fq.resident_input(c): torch.from_numpy(cols[c]) for c in fq.resident})
    if name in SEMANTICS:
        fq = _semantics_query(name)
        return fq.graph.stages[-1], _host_env(fq.operands)
    g, enc, fq, _ = _rle_case()
    if name == "rle-runs":
        return g.stages[0], _host_env(host_operands(enc))
    return fq.graph.stages[-1], _host_env(fq.operands)


@pytest.fixture(scope="module")
def programs(cols):
    out = {}
    for name in PLANS:
        red, env = _stage(name, cols)
        out[name] = (red, env, QR.program(red, env))
    return out


def _defined(src: str) -> dict[str, str]:
    """Each local of the row function and the line that defines it."""
    return {m.group(2): m.group(0) for m in re.finditer(
        r"const (float|int32_t|uint32_t|bool) (\w+) = [^;]*;", src)}


@pytest.mark.parametrize("name", PLANS)
def test_same_program_same_text_and_digest(name, programs, cols):
    red, env, prog = programs[name]
    again = QR._Program(red, env)
    assert again is not prog and again.source == prog.source
    assert G.digest(again.source) == G.digest(prog.source)
    red2, env2 = _stage(name, cols)                  # lowered once more
    assert QR.program(red2, env2).source == prog.source


@pytest.mark.parametrize("name", PLANS)
def test_digest_ignores_pointers_lengths_and_chunks(name, programs):
    """Other buffers (other pointers), fewer rows and the launch's own fields
    reach the kernel through the per-launch struct only."""
    red, env, prog = programs[name]
    moved = {k: v.clone() for k, v in env.items()}
    assert QR._Program(red, moved).source == prog.source
    out = torch.zeros(red.n_out, dtype=torch.float32)
    a, _ = QR._generated_args(prog, env, torch.device("cpu"), 7, 0, out, False)
    b, _ = QR._generated_args(prog, moved, torch.device("cpu"), 5, 2, out, True)
    assert [x.p for x in a.bufs] != [x.p for x in b.bufs]
    assert QR.library(prog.source).digest == G.digest(prog.source)


def test_a_changed_predicate_constant_changes_the_digest():
    base = _semantics_query("promote-drop")
    other = lower_query(
        SEMANTICS["promote-drop"].__class__(
            "promote", predicates=(Pred("A", "<", 80.25), Pred("X", ">=", -20)),
            aggregates=SEMANTICS["promote-drop"].aggregates,
            group_key=SEMANTICS["promote-drop"].group_key, n_segments=16),
        {c: _encs_of(base)[c] for c in ("A", "X")})
    progs = [QR._Program(fq.graph.stages[-1], _host_env(fq.operands)) for fq in (base, other)]
    assert len({G.digest(p.source) for p in progs}) == 2
    assert "0x42a10000u" in progs[0].source and "0x42a08000u" in progs[1].source


def _encs_of(fq):
    """The semantics columns' blobs again (the same encoders, the same data)."""
    from test_torch_cuda import semantics_columns
    from repro_torch.core.plan import Plan, make_plan

    data = semantics_columns()
    plans = {k: make_plan("bitpack") for k in "AFS"}
    plans["X"] = Plan("float2int", children={"ints": make_plan("bitpack")})
    return {c: encode(plans[c], data[c]) for c in data}


@pytest.mark.parametrize("name", PLANS)
def test_every_register_is_one_named_local(name, programs):
    red, env, prog = programs[name]
    src = prog.source
    body = src[src.index("void row("):]
    defined = _defined(body)
    kinds = [r[1] for r in prog.roles]
    want = {f"r{k}" for k, kind in enumerate(kinds) if kind == 0}
    want |= {f"r{ins[2]}" for ins in prog.instrs}
    assert want <= set(defined)
    assert {f"m{k}" for k, kind in enumerate(kinds) if kind == 1} <= set(defined)
    assert {f"wt{k}" for k, kind in enumerate(kinds) if kind == 2} <= set(defined)
    for local in want:                                # defined once
        assert len(re.findall(rf"const \w+ {local} =", body)) == 1
    # no array indexed at run time: every subscript is a literal
    assert not re.search(r"\w\[(?!\d+\])", body)
    assert "ZfQArgs" not in src and "r[" not in src
    # as many roles, predicates and instructions as the program
    assert len(re.findall(r"^    // role \d+:", body, re.M)) == len(prog.roles)
    assert len(re.findall(r"const bool p\d+ =", body)) == len(prog.preds)
    regs = [int(m) for m in re.findall(r"const (?:float|int32_t) r(\d+) =", body)]
    assert sum(r >= len(prog.roles) for r in regs) == len(prog.instrs)
    assert f"kSegments = {red.n_segments};" in src and f"kLanes = {len(red.lanes)};" in src


@pytest.mark.parametrize("name", PLANS)
def test_constants_are_the_words_of_the_program(name, programs):
    red, env, prog = programs[name]
    defined = _defined(prog.source)
    for op, t, dst, a, b, src, imm in prog.instrs:
        if op != 0:
            continue
        (word,) = re.findall(r"0x([0-9a-f]{8})u", defined[f"r{dst}"])
        assert int(word, 16) == imm
        dt = {0: torch.float32, 4: torch.int32, 1: torch.uint8, -1: torch.int8,
              2: torch.uint16, -2: torch.int16}[t]
        value = (struct.unpack("<f", struct.pack("<I", imm))[0] if t == 0
                 else int(np.array(imm, np.uint32).astype(np.int64)))
        assert QR._word(value, dt) == imm
    for n, (reg, cmp, mode, value) in enumerate(prog.preds):
        line = defined[f"p{n}"]
        if mode == 0:
            assert f"INT64_C({value})" in line
        else:
            assert f"__uint_as_float(0x{value:08x}u)" in line


def test_q6_constants_are_the_query_bounds(programs):
    """Q6's ``0.05 <= discount <= 0.07`` compares as float32 words, the range
    masks' bounds are int64 literals rebased once per thread."""
    _, _, prog = programs["q6"]
    src = prog.source
    for v in (0.05, 0.07):
        assert f"0x{QR._word(v, torch.float32):08x}u" in src
    for k, (chain, *_r) in enumerate(prog.roles):
        for o, op in enumerate(chain):
            if op.kind == "range":
                lo, hi = op.arg
                for name_, x in (("lo", lo), ("hi", hi)):
                    if x is not None:
                        assert f"s.{name_}{k}_{o} = INT64_C({x}) - " in src


def test_float_arithmetic_is_intrinsics_only(programs):
    """No ``*`` or ``+`` between floats that nvcc could contract into an FMA:
    every float operation of a row is an ``_rn`` intrinsic."""
    for name, (red, env, prog) in programs.items():
        body = prog.source[prog.source.index("void row("):]
        floats = set(re.findall(r"const float (\w+) =", body)) | {"w"}
        for line in body.splitlines():
            for f in floats:
                assert not re.search(rf"\b{f}\s*[-+*/]\s*\w|\w\s*[-+*/]\s*{f}\b",
                                     line.replace("->", "")), (name, line)


def _synthetic(tmp_dtypes=False):
    """A Reduce whose roles reach every op kind the Q1/Q6 programs do not:
    BYTES, GATHER (uint16 table), SPAN (int32 offsets), UNZIGZAG, a weight
    role, a row role read through UNPACK, and a mask role."""
    rng = np.random.default_rng(5)
    n = 300
    words = pack_np(rng.integers(0, 50, n).astype(np.int64), 6)
    env = {"b": torch.from_numpy(rng.integers(0, 256, 3 * n).astype(np.uint8)),
           "idx": torch.from_numpy(rng.integers(0, 40, n).astype(np.int32)),
           "tab": torch.from_numpy(rng.integers(0, 60000, 40).astype(np.uint16)),
           "offs": torch.from_numpy(np.cumsum(rng.integers(0, 9, 41)).astype(np.int32)),
           "zz": torch.from_numpy(rng.integers(0, 1000, n).astype(np.int32)),
           "wt": torch.from_numpy(rng.integers(1, 5, n).astype(np.int16)),
           "p": torch.from_numpy(words.view(np.int32)),
           "bw": torch.tensor([6], dtype=torch.int32),
           "base": torch.tensor([-7], dtype=torch.int32),
           "sc": torch.tensor([4.0], dtype=torch.float32)}
    roles = (Role("value", "B", (load_bytes("b", 3),), np.int32),
             Role("value", "G", (load("idx"), gather("tab")), np.uint16),
             Role("value", "S", (load("idx"), span("offs")), np.int32),
             Role("value", "Z", (load("zz"), unzigzag()), np.int32),
             Role("weight", "W", (load("wt"),), np.int16),
             Role("row", "R", (unpack("p", "bw", "base"), i2f_div("sc")), np.float32),
             Role("mask", "M", (unpack_raw("p", "bw"), in_range("base", -3, 30)), np.bool_))
    inputs = ("b", "idx", "tab", "offs", "zz", "wt", "p", "bw", "base", "sc")
    lanes = (Bin("-", Col("B"), Col("G", "int32")), Bin("*", Col("S"), Col("Z")),
             Bin("%", Col("R"), Const(2.5)))
    red = Reduce(roles=roles, inputs=inputs, specs=tuple(BufSpec() for _ in inputs),
                 lanes=lanes, key=Bin("%", Col("Z"), Const(3)), n_segments=3,
                 preds=(Pred("S", "<", 20),), n_in=n, n_out=(len(lanes) + 1) * 3,
                 name="synthetic")
    return red, env


def test_every_op_and_role_kind_has_an_emitter():
    red, env = _synthetic()
    prog = QR.program(red, env)
    src = prog.source
    for text in ("zf_qg_bytes<3>(", "zf_read(a.bufs[2].p, 2, zf_jnp_index(",
                 "zf_read(a.bufs[4].p, 4, zf_jnp_index(static_cast<int32_t>(v2_0 + 1u)",
                 "(v3_0 >> 1) ^ (0u - (v3_0 & 1u))", "const float wt4 =",
                 "zf_unpack_at(static_cast<const uint32_t*>(a.bufs[7].p), a.bufs[7].n - 1, "
                 "s.bw5, s.base5, g)", "__fdiv_rn(", "const bool m6 =", "zf_qg_raw<kFast>(a.bufs[11], f.f0, j, i)",
                 "zf_qg_fmod(", "zf_qg_imod(", "w = __fmul_rn(w, wt4);"):
        assert text in src, text
    assert "kFields = 1;" in src              # only the mask's unpack is tiled
    # the plain version runs the same program (the kernel's twin on the CPU)
    assert ref.query_reduce_torch(red, env).shape == (red.n_out,)


def test_every_cast_instruction_and_predicate_has_an_emitter():
    types = (0, 4, 1, -1, 2, -2)
    for a in types:
        for b in types:
            assert G.cast_value("x", a, b) == ("x" if a == b else G.cast_value("x", a, b))
            assert G.cast_word("x", a, b)
        for op in (2, 3, 4, 5):
            assert G.binary(op, a, "x", "y")
    for cmp in G.CMPS:
        for mode in G.PRED_MODES:
            assert G.predicate(cmp, mode, "x", 5)
    for bad in (lambda: G.cast_value("x", 8, 0), lambda: G.cast_word("x", 0, 3),
                lambda: G.binary(6, 0, "x", "y"), lambda: G.binary(1, 4, "x", "y"),
                lambda: G.predicate(4, 0, "x", 1), lambda: G.predicate(0, 3, "x", 1)):
        with pytest.raises(ValueError):
            bad()


def test_an_unknown_op_role_or_instruction_raises(programs):
    import copy

    _, _, prog = programs["q6"]

    class Bogus:
        kind, bufs = "bogus", ()

    for patch in (lambda p: p.roles.__setitem__(0, ((Bogus(),),) + p.roles[0][1:]),
                  lambda p: p.roles.__setitem__(1, (p.roles[1][0][:1] + (Bogus(),),)
                                                + p.roles[1][1:]),
                  lambda p: p.roles.__setitem__(0, p.roles[0][:1] + (7,) + p.roles[0][2:]),
                  lambda p: p.instrs.__setitem__(0, (9,) + p.instrs[0][1:])):
        bad = copy.copy(prog)
        bad.roles, bad.instrs = list(prog.roles), list(prog.instrs)
        patch(bad)
        with pytest.raises(ValueError):
            G.generate(bad)


def test_block_and_rows_are_the_headers():
    """The block and the rows a thread takes are the header's constants, the
    ones the wrapper sizes its grid by; the generated text sets neither."""
    header = (cuda.CSRC / "query_gen.cuh").read_text()
    macros = dict(re.findall(r"^#define (ZF_QG_\w+) (\d+)", header, re.M))
    assert int(macros["ZF_QG_THREADS"]) == QR.THREADS
    assert int(macros["ZF_QG_ROWS"]) == QR.ROWS_PER_THREAD
    assert int(macros["ZF_QG_MAX_BUFS"]) == cuda.QG_MAX_BUFS
    assert int(macros["ZF_QG_MAX_SMEM"]) == QR.MAX_SMEM
    assert int(macros["ZF_QG_REG_ACCS"]) == QR.REG_ACCS
    red, env = _synthetic()
    src = G.generate(QR._Program(red, env))
    assert not re.search(r"kRows|kThreads|kStaged|ZF_QG_ROWS|ZF_QG_THREADS", src)


def test_ops_per_row_counts_the_query():
    """Q6: four bit-packed fields (two with a base), three range bounds, two
    divides, two float compares, one multiply, the lane and the count."""
    cols = generate(0.002, seed=0)
    red, env = _stage("q6", cols)
    n_int, n_float = G.ops_per_row(QR.program(red, env))
    assert (n_int, n_float) == (3 + 3 + 2 + 2 + 3, 2 * 2 + 2 + 1 + 2 + 1)


@pytest.mark.parametrize("name", ["q1", "rle-runs"])
def test_per_launch_struct_packs_pointers_in_role_order(name, programs):
    red, env, prog = programs[name]
    out = torch.zeros(red.n_out, dtype=torch.float32)
    n, start = min(1000, red.n_in), 0 if name == "rle-runs" else 64
    args, scratch = QR._generated_args(prog, env, torch.device("cpu"), n, start, out, True)
    names = [b for chain, *_r in prog.roles for op in chain for b in op.bufs]
    assert [s[0] for s in prog.slots] == names
    assert [(args.bufs[s].p, args.bufs[s].n) for s in range(len(names))] == \
        [(env[b].data_ptr(), env[b].numel()) for b in names]
    assert all(args.bufs[s].p is None and args.bufs[s].n == 0
               for s in range(len(names), cuda.QG_MAX_BUFS))
    grid = QR.n_blocks(n)
    n_acc = (len(red.lanes) + 1) * red.n_segments
    assert (args.n, args.out_start, args.accumulate, args.n_blocks) == (n, start, 1, grid)
    assert args.out == out.data_ptr() and args.partials == scratch.data_ptr()
    assert args.counter == scratch.data_ptr() + 4 * grid * n_acc
    assert scratch.numel() == grid * n_acc + 1
    assert grid == min(-(-n // (QR.THREADS * QR.ROWS_PER_THREAD)), QR.MAX_BLOCKS)
    assert QR.n_blocks(10**9, max_blocks=7) == 7 and QR.n_blocks(1) == 1


def test_per_launch_struct_refuses_what_the_kernel_cannot_read(programs):
    red, env, prog = programs["q1"]
    out = torch.zeros(red.n_out, dtype=torch.float32)
    cpu = torch.device("cpu")
    resident = next(k for k in env if k.endswith(".resident"))
    short = dict(env, **{resident: env[resident][:10]})
    with pytest.raises(ValueError, match="reads"):
        QR._generated_args(prog, short, cpu, 100, 0, out, False)
    strided = dict(env, **{resident: env[resident].repeat(2)[::2]})
    with pytest.raises(ValueError, match="contiguous"):
        QR._generated_args(prog, strided, cpu, 100, 0, out, False)


def test_a_failed_build_raises_and_falls_back_to_nothing(tmp_path, monkeypatch, programs):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))

    def no_nvcc():
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")

    monkeypatch.setattr(cuda, "_nvcc", no_nvcc)
    red, env, _ = programs["q6"]
    prog = QR._Program(red, env)
    before = QR.KERNEL.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        QR.build_programs([prog])
    assert prog.build_s is None and not prog.lib.loaded
    assert not prog.lib.path().exists()
    with pytest.raises(RuntimeError, match="nvcc"):
        prog.kernel(torch.device("cpu"))
    assert QR.KERNEL.launches == before
    # on the CPU the wrapper takes the plain version and builds nothing
    assert torch.equal(QR.query_reduce(red, env), ref.query_reduce_torch(red, env))
    assert QR.KERNEL.launches == before


@pytest.mark.parametrize("q", [1, 6])
def test_lower_query_builds_for_the_types_its_launches_see(q, cols, monkeypatch):
    """``query_types`` (what ``lower_query`` builds the kernel for on a card)
    equals the types of every buffer the query's launches pass, whole and
    chunked, through ``ColumnPipeline.run_query`` on the CPU."""
    names = QUERY_COLUMNS[q]
    seen = []
    plain = ref.query_reduce_torch

    def spy(stage, env, *a, **kw):
        seen.append({b: env[b].dtype for b in stage.inputs})
        return plain(stage, env, *a, **kw)

    monkeypatch.setattr(ref, "query_reduce_torch", spy)
    for cb in (None, 4096):
        pipe = ColumnPipeline({c: TABLE2_PLANS[c] for c in names}, device="cpu",
                              chunk_bytes=cb)
        pipe.compress({c: cols[c] for c in names})
        qp = {1: Q1_PLAN, 6: Q6_PLAN}[q]
        fq, _ = pipe.lower_query(qp)
        seen.clear()
        pipe.run_query(qp)
        assert seen and all(s == pipe.executor.query_types(fq) for s in seen)


@pytest.mark.parametrize("q", [1, 6])
def test_run_query_prepares_the_kernel_before_its_first_launch(q, cols, monkeypatch):
    """``run_query`` on a query lowered by ``core.query.lower_query`` (not
    through ``ColumnPipeline.lower_query``) prepares its kernel before any
    launch, so no compile falls inside its timed run; a second run prepares
    again (a memo hit on a card) before its launches."""
    from repro_torch.core.executor import StreamingExecutor

    names = QUERY_COLUMNS[q]
    qp = {1: Q1_PLAN, 6: Q6_PLAN}[q]
    pipe = ColumnPipeline({c: TABLE2_PLANS[c] for c in names}, device="cpu")
    pipe.compress({c: cols[c] for c in names})
    encs = {c: pipe._encoded[c] for c in qp.columns()}
    fq = lower_query(qp, encs)
    ex = pipe.executor
    events = []
    prepare, plain = StreamingExecutor.prepare_query, ref.query_reduce_torch

    def spy_prepare(self, fq_):
        events.append(("prepare", fq_.graph.stages[-1]))
        return prepare(self, fq_)

    def spy_launch(stage, env, *a, **kw):
        events.append(("launch", stage))
        return plain(stage, env, *a, **kw)

    monkeypatch.setattr(StreamingExecutor, "prepare_query", spy_prepare)
    monkeypatch.setattr(ref, "query_reduce_torch", spy_launch)
    red = fq.graph.stages[-1]
    for _ in range(2):
        events.clear()
        ex.run_query(fq, encs)
        kinds = [k for k, _ in events]
        assert kinds[0] == "prepare" and kinds.count("prepare") == 1 and "launch" in kinds
        assert all(stage is red for _, stage in events)
    # on the CPU preparing builds nothing
    assert not ex._prepared and "_kernel_programs" not in red.__dict__


@pytest.mark.parametrize("name,place", [("lanes17", "registers"), ("lanes7_seg32", "shared"),
                                        ("lanes1_seg256", "global")])
def test_accumulator_columns_in_global_memory_get_their_scratch(name, place, cols):
    """Where a program keeps its accumulators follows the header's layout
    (registers up to 32 with one segment, shared memory while a block's
    columns and warp sums fit ``MAX_SMEM``, global memory past it); only the
    global place gets a column per thread after the partials and the counter,
    for every block of the grid."""
    from repro_torch.data.queries import WIDE_PLANS

    qp = WIDE_PLANS[name]
    encs = {c: encode(TABLE2_PLANS[c], cols[c]) for c in qp.columns()}
    fq = lower_query(qp, encs)
    red = fq.graph.stages[-1]
    prog = QR.program(red, _host_env(fq.operands, {}))
    assert prog.acc_place == place
    n_acc = prog.n_acc
    shared = 4 * n_acc * (QR.THREADS + QR.THREADS // 32)
    assert (shared > QR.MAX_SMEM) == (place == "global")
    out = torch.zeros(red.n_out, dtype=torch.float32)
    n = red.n_in
    args, scratch = QR._generated_args(prog, _host_env(fq.operands, {}), torch.device("cpu"),
                                       n, 0, out, False, max_blocks=132)
    grid = QR.n_blocks(n, 132)
    cols_n = grid * n_acc * QR.THREADS if place == "global" else 0
    assert scratch.numel() == grid * n_acc + 1 + cols_n
    assert args.counter == scratch.data_ptr() + 4 * grid * n_acc
    if place == "global":
        assert args.cols == scratch.data_ptr() + 4 * (grid * n_acc + 1)
    else:
        assert args.cols is None
