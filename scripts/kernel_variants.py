#!/usr/bin/env python3
"""Where kernels 1-4 spend their time: variants timed on one card.

    python3 scripts/kernel_variants.py [--scale S] [--out FILE.json]
                                       [--baseline CSRC_DIR]
                                       [--kernels decode,query]

Builds, from ``src/repro_torch/kernels/csrc``, the three kernels as committed
and variants with one part taken out or forced, and times each on SF-``S``
main-path stages that run them:

  kernel 1  on L_PARTKEY ``bitpack``, L_SHIPDATE ``bitpack+dict-lookup``,
            L_EXTENDEDPRICE ``bitpack+f2i-scale`` and O_COMMENT ``word-lengths``
            and ``byte-reassemble``: ``committed`` at L = 1, 2, 4 and 8;
            ``staging`` (a block's packed words staged, no outputs; for LOAD
            and BYTES sources, which stage nothing, the bare launch);
            ``global`` (the per-element global-memory path forced: no staging,
            no 16-byte loads); ``no-divide`` (I2F_DIV multiplies by its scale
            instead of dividing); ``rolled`` (a chain's transforms applied
            value by value in a rolled loop, not op by op over 4 values)
  kernel 3  on L_RETURNFLAG and O_COMMENT ``ans-decode``: ``committed``;
            ``no-stores`` (symbols folded, not stored); ``bare-chain`` (no
            stores, no stream-word ring: the table lookup and state update
            alone); the committed kernel at 32 and 64 threads
  kernel 2  on O_COMMENT ``stringdict-expand``, L_ORDERKEY
            ``deltastride-expand`` and ``rle-expand``: ``committed`` at L = 1,
            2, 4 and 8 sub-tiles per block; ``search`` (the block's group search
            only); ``search+stage`` (and the window staged, no outputs)
  kernel 4  on TPC-H Q6 and Q1, one launch over every row (the resident
            L_RETURNFLAG of Q1 taken from its source column): ``committed`` (the query's
            generated kernel, R = 4 rows a thread, each row's two words of a
            bit-packed field loaded through L1); ``decode-only`` (every role and mask
            evaluated, the count kept, no lane accumulated); ``no-divide``
            (I2F_DIV multiplies by its scale); ``R=1``, ``R=2`` and ``R=8``
            rows a thread.  Variants are text substitutions of the generated
            source (R: of ``csrc/query_gen.cuh``, inlined into it), each its
            own build; the committed kernel's SASS (``cuobjdump``) is
            summarised by opcode.  Also the host
            time of one wrapper call, and every variant's time by
            ``torch.profiler`` in one session.

With ``--baseline CSRC_DIR`` (the ``csrc`` directory of another tree, e.g. the
parent commit unpacked beside this one) that tree's three kernels are built as
variant ``baseline`` and run at this tree's native geometry beside the
committed ones on every stage above, and every kernel-1 launch of all 24
columns' main path is timed for ``committed`` and ``baseline`` by CUDA events
and by ``torch.profiler``.  An older kernel whose argument struct is a prefix
of today's (fields are only ever appended) loads as it is: kernel 2's span
fields ``out_start`` and ``g_start`` are zero on a whole column.

The committed kernels (and the baseline) must equal the plain versions
bitwise (kernel 4 and its variants that compute the query: the count lane
bitwise, the float lanes within 1e-5); the other variants compute something
else and are only timed.  ``--kernels`` picks the decode kernels 1-3
(``decode``), kernel 4 (``query``) or both (the default).  Times: CUDA
events, L2 flushed, median of 10, the runs interleaved (each variant once in
order, then in reverse).  Needs one NVIDIA GPU and nvcc; imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

FP_STAGED = "      staged = 4 * nvec <= a.stage_words;\n"
FP_OUTPUTS = "    for (int l = 0; l < a.L; ++l) {\n"     # both sources' output loops
FP_WIDE = "    const bool wide = E == W &&"
FP_OP_MAJOR = "  if (fast && (K <= 4 || ch.n_ops == 1)) {\n"
FP_SOURCE_ONLY = "  if (fast && ch.n_ops == 1) {\n"
FP_TRANSFORMS_K = "    if constexpr (K <= 4) zf_transforms_k(ch, 1, v, scale_of);\n"
FP_DIVIDE = "      return __float_as_uint(__fdiv_rn(x, scale()));\n"
FP_MULTIPLY = "      return __float_as_uint(x * scale());\n"
GP_NP_COLS = ("L_RETURNFLAG", "O_COMMENT", "L_ORDERKEY")
FP_STAGES = {("L_PARTKEY", "bitpack"), ("L_SHIPDATE", "bitpack+dict-lookup"),
             ("L_EXTENDEDPRICE", "bitpack+f2i-scale"), ("O_COMMENT", "word-lengths"),
             ("O_COMMENT", "byte-reassemble")}

NP_REFILL = """    words.request(refill);                  // word cur + LOOKAHEAD - 1
    zf_cp_wait<ZF_NP_LOOKAHEAD - 1>();
    next = words.get(cur);
"""
NP_STORE = "  zf_store_packed<W, !kTail>(static_cast<typename ZfOut<W>::T*>(a.out) + first, steps, step);\n"
NP_FOLD = ("  uint32_t fold = 0;\n  for (int32_t t = 0; t < steps; ++t) fold ^= step();\n"
           "  if (fold == 0x12345678u) static_cast<uint8_t*>(a.out)[first] = 1;\n")
GP_SEARCHED = "  int64_t gb = win;\n"
GP_EMIT = "    const int64_t t0 = o0 + threadIdx.x * a.C;\n"
GP_NO_EMIT = GP_EMIT + "    if (hi > lo) {\n      gb = g_hi;\n      __syncthreads();\n      continue;\n    }\n"
VARIANTS = {
    "fully_parallel": {"staging": [(FP_OUTPUTS, "    if (a.n > 0) return;\n" + FP_OUTPUTS)],
                       "global": [(FP_STAGED, "      staged = false;\n"),
                                  (FP_WIDE, "    const bool wide = false && E == W &&")],
                       "no-divide": [("zf_chain.cuh", FP_DIVIDE, FP_MULTIPLY)],
                       "rolled": [(FP_OP_MAJOR, FP_SOURCE_ONLY), (FP_TRANSFORMS_K, "")]},
    "non_parallel": {"no-stores": [(NP_STORE, NP_FOLD)],
                     "bare-chain": [(NP_STORE, NP_FOLD), (NP_REFILL, "")]},
    "group_parallel": {"search": [(GP_SEARCHED, GP_SEARCHED + "  if (gb >= 0) return;\n")],
                       "search+stage": [(GP_EMIT, GP_NO_EMIT)]},
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--baseline", type=Path, default=None,
                    help="csrc directory whose kernels are timed as 'baseline'")
    ap.add_argument("--kernels", default="decode,query",
                    help="decode (kernels 1-3), query (kernel 4), or both")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    which = set(args.kernels.split(","))
    rows = query_variants(args.scale) if "query" in which else []
    if "decode" in which:
        rows += decode_variants(args)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"device": smi, "rows": rows}, indent=1))
    return 0


# kernel 4: text substitutions of the generated source
QUERY_VARIANTS = ("committed", "decode-only", "no-divide", "R=1", "R=2", "R=8")
QUERY_EXACT = ("committed", "R=1", "R=2", "R=8")   # the variants that compute the query
QUERY_RTOL = 1e-5


def _sub(src: str, old: str, new: str, what: str) -> str:
    if old not in src:
        raise RuntimeError(f"{what}: the source no longer holds {old!r}")
    return src.replace(old, new)


def query_variant(src: str, v: str) -> str:
    """Variant ``v`` of a generated kernel's source."""

    from repro_torch.kernels import cuda

    if v == "committed":
        return src
    if v == "no-divide":
        return _sub(src, "__fdiv_rn(", "__fmul_rn(", v)
    if v == "decode-only":
        # no lane: every role's word folded into one test the compiler cannot
        # drop, so each role is still evaluated, and the count kept
        words = re.findall(r"const uint32_t (w\d+) = ", src)
        add = re.search(r"  acc\.add\(seg, w(?:, r\d+)*\);", src).group(0)
        src = re.sub(r"kLanes = \d+;", "kLanes = 0;", src)
        return _sub(src, add, f"  if (({' ^ '.join(words)}) == 0x9e3779b9u) w = __fadd_rn(w, 1.f);"
                    "\n    acc.add(seg, w);", v)
    rows = int(v.removeprefix("R="))
    header = (cuda.CSRC / "query_gen.cuh").read_text()
    header = _sub(header, "#pragma once\n", "", v)
    header = _sub(header, "#define ZF_QG_ROWS 4 ", f"#define ZF_QG_ROWS {rows} ", v)
    return _sub(src, '#include "query_gen.cuh"', header, v)


def sass_summary(so: Path) -> str:
    """Instructions of a library's kernels in SASS (``cuobjdump``), in all and
    the most frequent opcodes: what a row costs, read without a profiler."""
    import collections
    import shutil

    from repro_torch.kernels import cuda

    tool = Path(cuda._nvcc()).with_name("cuobjdump")
    if not tool.is_file():
        tool = Path(shutil.which("cuobjdump") or "")
    if not tool.is_file():
        return "cuobjdump not found"
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True,
                          timeout=120).stdout
    ops = collections.Counter(m.split(".")[0] for m in re.findall(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", sass))
    return f"{sum(ops.values())} instructions; " + " ".join(
        f"{k} {v}" for k, v in ops.most_common(16))


def query_variants(scale: float) -> list[dict]:
    """Kernel 4's variants on Q6 and Q1 (see the module docstring)."""
    import time

    from chip_smoke import Timer, profiled_ms
    from repro_torch.core.compiler import device_layout
    from repro_torch.core.query import lower_query
    from repro_torch.data.columns import TABLE2_PLANS
    from repro_torch.data.queries import Q1_PLAN, Q6_PLAN
    from repro_torch.data.tpch import QUERY_COLUMNS, generate
    from repro_torch.core.plan import encode
    from repro_torch.kernels import cuda, query_codegen, ref
    from repro_torch.kernels import query_reduce as qr

    dev = torch.device("cuda", torch.cuda.current_device())
    names = sorted(set(QUERY_COLUMNS[1]) | set(QUERY_COLUMNS[6]))
    data = generate(scale, seed=0)
    encs = {c: encode(TABLE2_PLANS[c], data[c]) for c in names}
    cases = []
    for q, qp in ((6, Q6_PLAN), (1, Q1_PLAN)):
        fq = lower_query(qp, {c: encs[c] for c in QUERY_COLUMNS[q]})
        red = fq.graph.stages[-1]
        env = {k: torch.from_numpy(device_layout(v)).to(dev) for k, v in fq.operands.items()}
        for c in fq.resident:
            env[fq.resident_input(c)] = torch.from_numpy(data[c]).to(dev)
        prog = qr.program(red, {k: v.cpu() for k, v in env.items()})   # nothing built yet
        libs = {}
        for v in QUERY_VARIANTS:
            libs[v] = qr.library(query_variant(prog.source, v))
        if libs["committed"].source != prog.source:
            raise RuntimeError("the committed variant is not the program's kernel")
        cases.append((q, fq, red, env, prog, libs))
    t0 = time.perf_counter()
    cuda.build([lib for *_, libs in cases for lib in libs.values()])
    print(f"kernel 4 builds: {time.perf_counter() - t0:.1f} s for "
          f"{sum(len(c[-1]) for c in cases)} generated kernels")
    timer = Timer()
    rows, profiled = [], []
    for q, fq, red, env, prog, libs in cases:
        plain = ref.query_reduce_torch(red, env)
        S = fq.n_segments

        def call(v, env=env, prog=prog, libs=libs):
            out = torch.empty(red.n_out, dtype=torch.float32, device=dev)
            libs[v].load(dev)
            args, scratch = qr._generated_args(prog, env, dev, red.n_in, 0, out, False,
                                               libs[v].max_blocks[dev.index])
            libs[v].launch(args, qr.THREADS, dev)
            return out

        order = list(QUERY_VARIANTS)
        for v in order:
            got = call(v)
            if v in QUERY_EXACT and not torch.equal(got[-S:], plain[-S:]):
                raise AssertionError(f"q{q} {v}: count lane {got[-S:].tolist()} != plain "
                                     f"{plain[-S:].tolist()}")
            if v in QUERY_EXACT and not torch.allclose(got, plain, rtol=QUERY_RTOL, atol=0):
                raise AssertionError(f"q{q} {v}: {got.tolist()} vs plain {plain.tolist()}")
        times = {}
        for v in order + order[::-1]:
            times.setdefault(v, []).append(timer.ms(lambda: call(v)))
        ts = []
        for _ in range(50):
            t0 = time.perf_counter()
            qr.query_reduce(red, env)
            ts.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        host = {"host_ms committed": float(np.median(ts))}
        n_int, n_float = query_codegen.ops_per_row(prog)
        for v, lib in libs.items():
            regs = re.findall(r"Used (\d+) registers", lib.path().with_suffix(".log").read_text())
            print(f"q{q} {v}: {regs} registers, grid {lib.max_blocks[dev.index]} blocks")
        print(f"q{q} committed sass: {sass_summary(libs['committed'].path())}")
        rows.append({"kernel": "query_reduce", "query": f"q{q}", "n": red.n_in,
                     "int_ops_per_row": n_int, "float_ops_per_row": n_float,
                     **{v: float(np.median(ts)) for v, ts in times.items()}, **host})
        for v in order:
            profiled.append((rows[-1], v, lambda v=v, call=call: call(v)))
    for (row, v, _), t_ms in zip(profiled, profiled_ms([(fn, "zf_qg_kernel")
                                                        for _, v, fn in profiled],
                                                       timer.flush)):
        row[f"profiler {v}"] = t_ms
    for row in rows:
        print(json.dumps(row))
    return rows


def decode_variants(args) -> list[dict]:
    """Kernels 1-3's variants (see the module docstring)."""
    from chip_smoke import Timer, profiled_ms
    from repro_torch.core.compiler import device_buffers
    from repro_torch.core.geometry import Geometry
    from repro_torch.core.patterns import Aux, FullyParallel, GroupParallel, NonParallel
    from repro_torch.data.columns import TABLE2_PLANS
    from repro_torch.data.loader import ColumnPipeline
    from repro_torch.data.tpch import generate
    from repro_torch.kernels import cuda, ref
    from repro_torch.kernels import (fully_parallel as fpm, group_parallel as gpm,
                                     non_parallel as npm)
    from repro_torch.kernels.ops import run_stage

    work = cuda.build_root() / "variants"
    sources = {}   # (kernel, variant) -> source file
    for kname, edits in VARIANTS.items():
        sources[kname, "committed"] = cuda.CSRC / f"{kname}.cu"
        for vname, subs in edits.items():
            texts = {f: (cuda.CSRC / f).read_text() for f in (f"{kname}.cu", "zf_chain.cuh")}
            for sub in subs:   # (old, new) in the kernel's source, or (file, old, new)
                f, old, new = sub if len(sub) == 3 else (f"{kname}.cu", *sub)
                if old not in texts[f]:
                    raise RuntimeError(f"{kname} {vname}: {f} no longer holds "
                                       f"{old.strip()!r}; update the variant")
                texts[f] = texts[f].replace(old, new)
            d = work / vname
            d.mkdir(parents=True, exist_ok=True)
            for f, text in texts.items():
                (d / f).write_text(text)
            sources[kname, vname] = d / f"{kname}.cu"
    if args.baseline is not None:
        for kname in VARIANTS:
            sources[kname, "baseline"] = args.baseline / f"{kname}.cu"
    procs = {}
    for (kname, vname), src in sources.items():
        so = work / f"lib{kname}-{vname}.so"
        procs[kname, vname] = (so, subprocess.Popen(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", str(src.parent), "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (kname, vname), (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc {kname} {vname}:\n{log}")
        base = {"non_parallel": npm.KERNEL, "group_parallel": gpm.KERNEL,
                "fully_parallel": fpm.KERNEL}[kname]
        # a baseline may read a prefix of today's arguments (fields added since)
        size = ctypes.CDLL(str(so)).zf_args_size()
        if size > ctypes.sizeof(base.args_type):
            raise RuntimeError(f"{kname} {vname}: its arguments outgrow today's")
        lib = cuda.KernelLib(base.name, base.entry,
                             base.args_type if size == ctypes.sizeof(base.args_type)
                             else ctypes.c_char * size)
        lib.path = lambda so=so: so
        lib.load()
        libs[kname, vname] = lib

    timer = Timer()
    ms = timer.ms
    fp_all = args.baseline is not None      # every kernel-1 launch of the main path
    cols = tuple(TABLE2_PLANS) if fp_all else GP_NP_COLS + tuple(
        sorted({c for c, _ in FP_STAGES} - set(GP_NP_COLS)))
    data = generate(args.scale, seed=0)
    pipe = ColumnPipeline({k: TABLE2_PLANS[k] for k in cols}, device="cuda")
    pipe.compress({k: data[k] for k in cols})
    rows = []
    profiled = []   # (row, variant, library, fn) of kernel 1, profiled at once

    def time_stage(col, st, env):
        if isinstance(st, FullyParallel):
            kname, mod, fn, pfn = ("fully_parallel", fpm, fpm.fully_parallel,
                                   ref.fully_parallel_torch)
        elif isinstance(st, NonParallel):
            kname, mod, fn, pfn = ("non_parallel", npm, npm.non_parallel,
                                   ref.non_parallel_torch)
        else:
            kname, mod, fn, pfn = ("group_parallel", gpm, gpm.group_parallel,
                                   ref.group_parallel_torch)
        plain = pfn(st, env)
        named = kname != "fully_parallel" or (col, st.name) in FP_STAGES
        runs = [(v, None) for (k, v) in libs if k == kname and v != "baseline"] \
            if named else [("committed", None)]
        if kname == "non_parallel":
            runs += [("committed", Geometry(1, s, 1)) for s in (32, 64)]
        elif named:
            c = 16 // plain.element_size()
            runs += [("committed", Geometry(L, 256, c)) for L in (1, 2, 4, 8)]
        if (kname, "baseline") in libs:
            runs.append(("baseline", None))
        times = {}
        for vname, geom in runs + runs[::-1]:
            mod.KERNEL = libs[kname, vname]
            key = vname if geom is None else f"{vname} {geom}"
            if vname in ("committed", "baseline"):
                got = fn(st, env, geom)
                if not torch.equal(got.view(torch.uint8), plain.view(torch.uint8)):
                    raise AssertionError(f"{col}:{st.name} {key} differs from the plain "
                                         f"version")
            times.setdefault(key, []).append(ms(lambda: fn(st, env, geom)))
        rows.append({"kernel": kname, "column": col, "stage": st.name, "n": st.n_out,
                     **{k: float(np.median(v)) for k, v in times.items()}})
        if kname == "fully_parallel":
            for vname, geom in runs:
                if vname in ("committed", "baseline") and geom is None:
                    profiled.append((rows[-1], vname, libs[kname, vname],
                                     lambda geom=geom: fn(st, env, geom)))
        mod.KERNEL = libs[kname, "committed"]
        print(json.dumps(rows[-1]))

    for col in cols:
        env = device_buffers(pipe.encoded(col))
        for st in pipe.executor.graph(col).stages:
            fps = st.producers if isinstance(st, Aux) else (st,)
            local = dict(env)
            for sub in fps:
                if isinstance(sub, FullyParallel) and (fp_all or (col, sub.name) in FP_STAGES):
                    time_stage(col, sub, local)
                elif isinstance(sub, (GroupParallel, NonParallel)) and col in GP_NP_COLS:
                    time_stage(col, sub, local)
                if isinstance(st, Aux):
                    local[sub.out] = run_stage(sub, local, "torch")
            env[st.out] = run_stage(st, env, "torch")
    # one profiler session for every kernel-1 launch timed above, each through
    # its own library (a wrapper reads the module's KERNEL at call time)
    def through(lib, fn):
        def call():
            fpm.KERNEL = lib
            fn()
        return call

    for (row, vname, _, _), t_ms in zip(profiled, profiled_ms(
            [(through(lib, fn), "zf_fully_parallel") for _, _, lib, fn in profiled],
            timer.flush)):
        row[f"profiler {vname}"] = t_ms
    fpm.KERNEL = libs["fully_parallel", "committed"]
    mine = [r for r in rows if r["kernel"] == "fully_parallel"]
    for key in ("committed", "baseline"):
        if fp_all:
            print(f"fully_parallel {key}: {len(mine)} launches, events_ms "
                  f"{sum(r[key] for r in mine):.4f} profiler_ms "
                  f"{sum(r['profiler ' + key] for r in mine):.4f}")
    for kname in ("group_parallel", "non_parallel"):
        theirs = [r for r in rows if r["kernel"] == kname and "baseline" in r]
        if theirs:
            print(f"{kname}: {len(theirs)} launches, events_ms committed "
                  f"{sum(r['committed'] for r in theirs):.4f} baseline "
                  f"{sum(r['baseline'] for r in theirs):.4f}")
    return rows


if __name__ == "__main__":
    sys.exit(main())
