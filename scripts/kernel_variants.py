#!/usr/bin/env python3
"""Where kernels 2 and 3 spend their time: variants timed on one card.

    python3 scripts/kernel_variants.py [--scale S] [--out FILE.json]

Builds, from ``src/repro_torch/kernels/csrc``, the Group-Parallel and
Non-Parallel kernels as committed and variants with one part taken out, and
times each on the SF-``S`` main-path stages that run them (L_RETURNFLAG and
O_COMMENT ``ans-decode``, O_COMMENT ``stringdict-expand``, L_ORDERKEY
``deltastride-expand`` and ``rle-expand``):

  kernel 3  ``committed``; ``no-stores`` (symbols folded, not stored);
            ``bare-chain`` (no stores, no stream-word ring: the table lookup
            and state update alone); the committed kernel at 32 and 64 threads
  kernel 2  ``committed`` at L = 1, 2, 4 and 8 sub-tiles per block;
            ``search`` (the block's group search only); ``search+stage`` (and
            the window staged, no outputs)

The committed kernels must equal the plain versions bitwise; the variants
compute something else and are only timed.  Times: CUDA events, L2 flushed,
median of 10, the runs interleaved (each variant once in order, then in
reverse).  Needs one NVIDIA GPU and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

NP_REFILL = """    words.request(refill);                  // word cur + LOOKAHEAD - 1
    zf_cp_wait<ZF_NP_LOOKAHEAD - 1>();
    next = words.get(cur);
"""
NP_STORE = "  zf_store_packed<W, !kTail>(static_cast<typename ZfOut<W>::T*>(a.out) + first, steps, step);\n"
NP_FOLD = ("  uint32_t fold = 0;\n  for (int32_t t = 0; t < steps; ++t) fold ^= step();\n"
           "  if (fold == 0x12345678u) static_cast<uint8_t*>(a.out)[first] = 1;\n")
GP_SEARCHED = "  int64_t gb = win;\n"
GP_EMIT = "    const int64_t i0 = o0 + threadIdx.x * a.C;\n"
GP_NO_EMIT = GP_EMIT + "    if (i0 >= 0) {\n      gb = g_hi;\n      __syncthreads();\n      continue;\n    }\n"
VARIANTS = {
    "non_parallel": {"no-stores": [(NP_STORE, NP_FOLD)],
                     "bare-chain": [(NP_STORE, NP_FOLD), (NP_REFILL, "")]},
    "group_parallel": {"search": [(GP_SEARCHED, GP_SEARCHED + "  if (gb >= 0) return;\n")],
                       "search+stage": [(GP_EMIT, GP_NO_EMIT)]},
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.compiler import device_buffers
    from repro_torch.core.geometry import Geometry
    from repro_torch.core.patterns import GroupParallel, NonParallel
    from repro_torch.data.columns import TABLE2_PLANS
    from repro_torch.data.loader import ColumnPipeline
    from repro_torch.data.tpch import generate
    from repro_torch.kernels import cuda, ref
    from repro_torch.kernels import group_parallel as gpm, non_parallel as npm
    from repro_torch.kernels.ops import run_stage

    work = cuda.build_root() / "variants"
    sources = {}   # (kernel, variant) -> source file
    for kname, edits in VARIANTS.items():
        sources[kname, "committed"] = cuda.CSRC / f"{kname}.cu"
        for vname, subs in edits.items():
            text = (cuda.CSRC / f"{kname}.cu").read_text()
            for old, new in subs:
                if old not in text:
                    raise RuntimeError(f"{kname} {vname}: the source no longer holds "
                                       f"{old.strip()!r}; update the variant")
                text = text.replace(old, new)
            d = work / vname
            d.mkdir(parents=True, exist_ok=True)
            (d / f"{kname}.cu").write_text(text)
            (d / "zf_chain.cuh").write_text((cuda.CSRC / "zf_chain.cuh").read_text())
            sources[kname, vname] = d / f"{kname}.cu"
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
        base = {"non_parallel": npm.KERNEL, "group_parallel": gpm.KERNEL}[kname]
        lib = cuda.KernelLib(base.name, base.entry, base.args_type)
        lib.path = lambda so=so: so
        lib.load()
        libs[kname, vname] = lib

    flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")

    def ms(fn, reps=10):
        fn()
        ts = []
        for _ in range(reps):
            flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return float(np.median(ts))

    cols = ("L_RETURNFLAG", "O_COMMENT", "L_ORDERKEY")
    data = generate(args.scale, seed=0)
    pipe = ColumnPipeline({k: TABLE2_PLANS[k] for k in cols}, device="cuda")
    pipe.compress({k: data[k] for k in cols})
    rows = []
    for col in cols:
        env = device_buffers(pipe.encoded(col))
        for st in pipe.executor.graph(col).stages:
            if isinstance(st, (GroupParallel, NonParallel)):
                kname = "non_parallel" if isinstance(st, NonParallel) else "group_parallel"
                mod = npm if kname == "non_parallel" else gpm
                fn = mod.non_parallel if kname == "non_parallel" else mod.group_parallel
                plain = (ref.non_parallel_torch if kname == "non_parallel"
                         else ref.group_parallel_torch)(st, env)
                runs = [(v, None) for (k, v) in libs if k == kname]
                if kname == "non_parallel":
                    runs += [("committed", Geometry(1, s, 1)) for s in (32, 64)]
                else:
                    c = 16 // plain.element_size()
                    runs += [("committed", Geometry(L, 256, c)) for L in (1, 2, 4, 8)]
                times = {}
                for vname, geom in runs + runs[::-1]:
                    mod.KERNEL = libs[kname, vname]
                    if vname == "committed":
                        got = fn(st, env, geom)
                        if not torch.equal(got, plain):
                            raise AssertionError(f"{col}:{st.name} {vname} {geom} differs "
                                                 f"from the plain version")
                    key = vname if geom is None else f"{vname} {geom}"
                    times.setdefault(key, []).append(ms(lambda: fn(st, env, geom)))
                rows.append({"kernel": kname, "column": col, "stage": st.name,
                             "n": st.n_out, **{k: float(np.median(v))
                                               for k, v in times.items()}})
                print(json.dumps(rows[-1]))
            env[st.out] = run_stage(st, env, "torch")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"device": smi, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
