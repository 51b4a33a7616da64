"""Dry run: does an (architecture x input shape) cell fit, and what bounds it --
without a GPU; the reference's ``launch/dryrun.py``.

For every cell and each asked-for mesh, run the step the cell names
(``make_train_step`` with AdamW, ``Model.prefill`` or ``Model.decode_step``)
once on the ``meta`` device -- real shapes and dtypes, nothing allocated,
nothing computed -- under ``roofline.op_cost.analyze``, and record:
  * memory     -- what a device holds: the arguments (weights, optimizer
                  state, serving state, inputs) resolved on the mesh by
                  ``launch/mesh.py``, and the step's own high-water mark of
                  allocated storage (``temp``); ``fits_80g_hbm``;
  * roofline   -- the counted FLOPs and bytes at the H100's datasheet
                  constants (``roofline/analysis.py``), beside
                  ``model_flops``.
The reference lowers and compiles with XLA and reads its memory and cost
analyses; the port has no compiler, so ``lower_s`` is the counted run's
seconds, there is no ``compile_s``, and ``n_ops`` (the aten ops counted)
takes the place of ``hlo_ops``.

Meshes: ``card`` (one H100: every term is the counted one), ``pod`` (16 x 16)
and ``multipod`` (2 x 16 x 16).  On a production mesh the argument bytes are
per device, by ``shard_tree``; the compute, memory and temp terms are the
whole step's counts divided by the chips (``split: "ideal"``: the port has no
SPMD partitioner yet), and the collective term is unknown (``t_collective``
null) until the mesh exists (ROADMAP §1 item 3).  All figures are modeled at
the H100's datasheet constants, not measured.

Usage (runs on the CPU, no GPU needed):
  python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k --mesh both
  python -m repro_torch.launch.dryrun --all --mesh all --out build/dryrun
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch.mesh import (Mesh, make_card_mesh, make_production_mesh,
                                     per_device_bytes, shard_tree)
from repro_torch.models import cell_status, get_model
from repro_torch.models.weights import meta_tree
from repro_torch.roofline import analysis, op_cost
from repro_torch.train import optimizer
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import make_train_step

# per-arch dry-run training knobs (remat policy, microbatch), the reference's
TRAIN_KNOBS: dict[str, dict] = {
    "nemotron-4-15b": {"microbatch": 8, "remat": "full"},
    "dbrx-132b": {"microbatch": 16, "remat": "full"},
    "phi3.5-moe-42b-a6.6b": {"microbatch": 4, "remat": "full"},
    "phi3-mini-3.8b": {"microbatch": 4, "remat": "full"},
    "zamba2-7b": {"microbatch": 4, "remat": "full"},
    "rwkv6-7b": {"microbatch": 4, "remat": "full"},
    "qwen2-vl-2b": {"microbatch": 2, "remat": "full"},
    "seamless-m4t-medium": {"microbatch": 2, "remat": "full"},
    "qwen1.5-0.5b": {"microbatch": 1, "remat": "full"},
    "smollm-360m": {"microbatch": 4, "remat": "full"},
}

MESHES = {"card": make_card_mesh, "pod": make_production_mesh,
          "multipod": lambda: make_production_mesh(multi_pod=True)}
MESH_CHOICES = {"card": ("card",), "pod": ("pod",), "multipod": ("multipod",),
                "both": ("pod", "multipod"), "all": ("card", "pod", "multipod")}
NO_COLLECTIVES = "waits for ROADMAP §1 item 3"
_COUNTS: dict = {}   # the last cell's count and seconds, for its other meshes


def abstract_init(model, train: bool = False):
    """(the family's module on ``meta``, its logical param specs) without
    allocating anything; ``train`` builds the f32 weights training holds."""
    return model.init(device="meta", train=train), model.param_specs()


def _knobs(arch: str, mesh: Mesh, batch: int, knobs: dict | None) -> dict:
    kn = dict(TRAIN_KNOBS.get(arch, {}))
    kn.update(knobs or {})
    # per-microbatch batch must stay divisible by the fsdp axes, or a
    # partitioner replicates the activations
    fsdp_size = math.prod(s for n, s in mesh.shape.items() if n != "model")
    mb = kn.get("microbatch", 1)
    while mb > 1 and (batch // mb) % fsdp_size:
        mb //= 2
    kn["microbatch"] = mb
    return kn


def run_cell(arch: str, shape_name: str, mesh: Mesh | str = "card",
             knobs: dict | None = None) -> dict:
    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    mesh = MESHES[mesh]() if isinstance(mesh, str) else mesh
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh.name}
    status = cell_status(cfg, shape)
    if status != "run":
        rec["status"] = status
        return rec
    t0 = time.time()
    model = get_model(cfg)
    chips = mesh.size
    B, S = shape.global_batch, shape.seq_len
    train = shape.kind == "train"
    module, p_logical = abstract_init(model, train=train)
    in_shapes, in_logical = model.input_specs(shape)
    args = [(meta_tree(module), p_logical)]
    if train:
        kn = _knobs(arch, mesh, B, knobs)
        rec["knobs"] = kn
        step = make_train_step(cfg, AdamWConfig(), remat=kn.get("remat", "full"),
                               microbatch=kn["microbatch"])
        opt = optimizer.init(module)
        f32 = meta_tree(module, torch.float32)
        args += [({"mu": f32, "nu": f32}, {"mu": p_logical, "nu": p_logical}),
                 (in_shapes, in_logical)]
        call = (step, module, opt, in_shapes)
    else:
        state = model.make_state(B, S, device="meta")
        args += [(state, model.state_specs(B))]
        if shape.kind == "prefill":
            args.append((in_shapes, in_logical))
            call = (model.prefill, module, in_shapes, state)
        else:   # one token per sequence at the end of a full context
            state["len"] = S - 1
            args.append((in_shapes["token"], in_logical["token"]))
            call = (model.decode_step, module, in_shapes["token"], state)
    key = (arch, shape_name, tuple(sorted(rec.get("knobs", {}).items())))
    if key not in _COUNTS:     # a step's count is the same on every mesh
        counted = op_cost.analyze(*call)
        _COUNTS.clear()
        _COUNTS[key] = counted, time.time() - t0
    counted, lower_s = _COUNTS[key]
    argument = sum(per_device_bytes(t, shard_tree(t, spec, mesh), mesh) for t, spec in args)
    output = counted["output_bytes"] / chips
    temp = counted["peak_bytes"] / chips
    per_dev = int(argument + temp)
    card = chips == 1
    roof = analysis.Roofline(
        arch=arch, shape=shape_name, mesh=mesh.name, chips=chips,
        hlo_flops_per_chip=counted["flops"] / chips,
        hlo_bytes_per_chip=counted["bytes"] / chips,
        coll_bytes_per_chip=counted["coll_bytes"] if card else None,
        coll_breakdown=counted["collectives"] if card else NO_COLLECTIVES,
        model_flops_total=analysis.model_flops(cfg, shape, shape.kind),
        per_device_bytes=per_dev,
        useful_bytes_per_chip=float(argument + output),
        split="counted" if card else "ideal")
    rec.update(status="ok", split=roof.split, lower_s=round(lower_s, 1),
               memory={"argument": int(argument), "output": int(output),
                       "temp": int(temp), "per_device_live": per_dev,
                       "fits_80g_hbm": bool(per_dev < analysis.HBM_BYTES)},
               roofline=roof.to_dict(),
               n_ops={"n_ops": counted["n_ops"]}, by_op=counted["by_op"])
    if not card:
        rec["collectives"] = NO_COLLECTIVES
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--mesh", choices=sorted(MESH_CHOICES), default="card")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--microbatch", type=int, default=None)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    archs = sorted(ARCHS) if (args.all or args.arch is None) else [args.arch]
    shapes = sorted(SHAPES) if (args.all or args.shape is None) else [args.shape]
    knobs = {}
    if args.remat:
        knobs["remat"] = args.remat
    if args.microbatch:
        knobs["microbatch"] = args.microbatch
    for arch in archs:
        for shape in shapes:
            for mesh_key in MESH_CHOICES[args.mesh]:
                tag = f"{arch}_{shape}_{mesh_key}"
                out_path = os.path.join(args.out, tag + ".json")
                if os.path.exists(out_path):
                    print(f"[dryrun] {tag}: cached")
                    continue
                print(f"[dryrun] {tag}: counting...", flush=True)
                try:
                    rec = run_cell(arch, shape, mesh_key, knobs or None)
                except Exception as e:  # noqa: BLE001 -- record the failure
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_key,
                           "status": f"FAIL: {type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                with open(out_path, "w") as f:
                    json.dump(rec, f, indent=1)
                status = rec.get("status", "?")
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f" bottleneck={r['bottleneck']}"
                             f" mem/dev={rec['memory']['per_device_live'] / 2**30:.2f}G"
                             f" fits_80g={rec['memory']['fits_80g_hbm']}"
                             f" lower={rec['lower_s']}s")
                print(f"[dryrun] {tag}: {status[:100]}{extra}", flush=True)


if __name__ == "__main__":
    main()
