"""Training entry point: ``python -m repro_torch.launch.train --arch <id> [--smoke]
[--device cpu] ...``, the reference's ``launch/train.py``.

Wires the stack together: the compressed token loader (bit-packed tokens
cross the link and are unpacked on the device by kernel 1), the train step
(autograd, per-layer remat, AdamW), and the fault-tolerant loop with
compressed checkpoints, resuming from ``--ckpt-dir``'s latest one.  Random
f32 weights from seed 0 (``--arch``'s config or its reduced ``--smoke``
one), computing in the config's dtype.  It runs on the card (``--device
cuda``, the default) unless ``--device cpu`` is given.

``--production-mesh`` trains on the (16, 16) ("data", "model") mesh, one
process per device: the mesh context is set and the parameters are placed
as DTensors by their logical specs (``launch/mesh.py place``).  The process
group comes from the launcher's environment (``torchrun``: ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``); with fewer ranks than the mesh has devices
it stops and names both counts -- it never shrinks the mesh.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import tempfile

import torch

from repro_torch.configs import ARCHS, SMOKES
from repro_torch.data.loader import CompressedTokenLoader
from repro_torch.launch.mesh import device_mesh, make_production_mesh, place
from repro_torch.models import get_model
from repro_torch.models.sharding_ctx import mesh_context
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import optimizer
from repro_torch.train.loop import LoopConfig, run
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import make_train_step

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--production-mesh", action="store_true",
                    help="place on the (16, 16) mesh (one process per device, torchrun)")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to train on the CPU")

    cfg = (SMOKES if args.smoke else ARCHS)[args.arch]
    model = get_model(cfg)
    dm = production_mesh(device) if args.production_mesh else None
    params = model.init(torch.Generator(device).manual_seed(0), device, train=True)
    context = contextlib.nullcontext()
    if dm is not None:
        place(params, model.param_specs(), dm)
        context = mesh_context(dm)
    opt_state = optimizer.init(params)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps)
    step = make_train_step(cfg, opt_cfg, remat=args.remat, microbatch=args.microbatch)
    # the ZipFlow-compressed token pipeline: fixed-width packed transfer, then
    # the unpack on the device as the step's first launch
    loader = CompressedTokenLoader(cfg.vocab, args.batch, args.seq, device=device)
    decode = loader.decode_fn()

    def step_with_decode(p, o, bufs):
        return step(p, o, decode(bufs))

    def batch_fn(i):
        return loader.to_device(loader.encode_host(i))

    loop_cfg = LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every)
    with context:
        params, opt_state, hist = run(loop_cfg, step_with_decode, params, opt_state, batch_fn)
    final = f"final loss {hist[-1]['loss']:.4f}" if hist else "no step left to run"
    print(f"[train] done: {final}; data moved compressed at ratio {loader.ratio:.2f}x; "
          f"checkpoints in {args.ckpt_dir} "
          f"(ratio {ckpt_mod.compression_report(args.ckpt_dir)['ratio']:.3f})")


def production_mesh(device: torch.device):
    """The pod mesh's ``DeviceMesh`` over the launcher's process group (each
    rank on its own card); stops when the group has fewer ranks than the
    mesh has devices."""
    import torch.distributed as dist

    mesh = make_production_mesh()
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world < mesh.size:
        raise SystemExit(f"--production-mesh needs the {mesh.size} devices of {mesh.name}, "
                         f"one process each, and this run has {world}")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return device_mesh(mesh, device.type)


if __name__ == "__main__":
    main()
