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
and ``multipod`` (2 x 16 x 16).  On a production mesh the cell counts one
device's program (``split: "counted"``): a fake process group of 256 or 512
members opens in this process (``launch/mesh.py fake_group``), the weights,
optimizer state, serving state and inputs are placed on its ``DeviceMesh``
as DTensors by their resolved specs, the step runs under the mesh context
(``models/sharding_ctx.py``), and the counter sees each device's local ops
and the collectives DTensor issues (by kind, ``collectives``; their time
``t_collective`` at NVLink's rate).  The group is destroyed before the cell
returns.  The argument bytes are per device by ``shard_tree``.  All figures
are modeled at the H100's datasheet constants, not measured.

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
from repro_torch.launch.mesh import (Mesh, device_mesh, fake_group, make_card_mesh,
                                     make_production_mesh, per_device_bytes, place,
                                     place_tree, shard_tree)
from repro_torch.models import cell_status, get_model
from repro_torch.models.sharding_ctx import mesh_context
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
    kn = None
    if train:
        kn = _knobs(arch, mesh, B, knobs)
        rec["knobs"] = kn
        f32 = meta_tree(module, torch.float32)
        args += [({"mu": f32, "nu": f32}, {"mu": p_logical, "nu": p_logical}),
                 (in_shapes, in_logical)]
    else:
        args += [(model.make_state(B, S, device="meta"), model.state_specs(B))]
        args.append((in_shapes, in_logical) if shape.kind == "prefill"
                    else (in_shapes["token"], in_logical["token"]))
    argument = sum(per_device_bytes(t, shard_tree(t, spec, mesh), mesh) for t, spec in args)
    if chips == 1:
        counted = op_cost.analyze(*_call(model, shape, module, kn, lambda t, spec: t))
    else:
        counted = count_placed(mesh, model, shape, module, kn)
    lower_s = time.time() - t0
    output = counted["output_bytes"]
    temp = counted["peak_bytes"]
    per_dev = int(argument + temp)
    roof = analysis.Roofline(
        arch=arch, shape=shape_name, mesh=mesh.name, chips=chips,
        hlo_flops_per_chip=counted["flops"],
        hlo_bytes_per_chip=counted["bytes"],
        coll_bytes_per_chip=counted["coll_bytes"],
        coll_breakdown=counted["collectives"],
        model_flops_total=analysis.model_flops(cfg, shape, shape.kind),
        per_device_bytes=per_dev,
        useful_bytes_per_chip=float(argument + output),
        split="counted")
    rec.update(status="ok", split=roof.split, lower_s=round(lower_s, 1),
               memory={"argument": int(argument), "output": int(output),
                       "temp": int(temp), "per_device_live": per_dev,
                       "fits_80g_hbm": bool(per_dev < analysis.HBM_BYTES)},
               roofline=roof.to_dict(),
               n_ops={"n_ops": counted["n_ops"]}, by_op=counted["by_op"])
    if chips > 1:
        rec["collectives"] = counted["collectives"]
    return rec


def _call(model, shape, module, kn: dict | None, put) -> tuple:
    """The cell's step as (fn, module, *arguments) on ``meta``; ``put(tree,
    logical specs)`` puts each argument tree where the step reads it (as it
    is on one card, placed on a production mesh).  The optimizer state is
    made from ``module``'s parameters, placed or not."""
    cfg = model.cfg
    B, S = shape.global_batch, shape.seq_len
    in_shapes, in_logical = model.input_specs(shape)
    if shape.kind == "train":
        step = make_train_step(cfg, AdamWConfig(), remat=kn.get("remat", "full"),
                               microbatch=kn["microbatch"])
        return (step, module, optimizer.init(module), put(in_shapes, in_logical))
    state = model.make_state(B, S, device="meta")
    if shape.kind == "prefill":
        return (model.prefill, module, put(in_shapes, in_logical),
                put(state, model.state_specs(B)))
    state["len"] = S - 1     # one token per sequence at the end of a full context
    return (model.decode_step, module, put(in_shapes["token"], in_logical["token"]),
            put(state, model.state_specs(B)))


def count_placed(mesh: Mesh, model, shape, module, kn: dict | None) -> dict:
    """Count one device's program of the cell's step on ``mesh``: on a fake
    group of ``mesh.size`` members, ``module``'s weights and the step's
    other arguments placed by their logical specs, the step run under the
    mesh context; the group is destroyed before it returns."""
    with fake_group(mesh.size):
        dm = device_mesh(mesh, "cpu")
        place(module, model.param_specs(), dm)
        call = _call(model, shape, module, kn, lambda t, spec: place_tree(t, spec, dm))
        with mesh_context(dm):
            return op_cost.analyze(*call)


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
