"""End-to-end LM training through the compressed data pipeline, on the port.

Trains a reduced qwen1.5-family model for a few hundred steps; tokens move
host->device bit-packed (fixed width) and are unpacked on the device (kernel
1 on the card, its plain version on the CPU) as each step's first launch.
Shows the ZipFlow loader, AdamW, the fault-tolerant loop with compressed
checkpoints, and that the loss falls.  The counterpart of
``examples/train_lm.py``.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] [--device cpu]
(The same entry point trains the full configs: ``python -m repro_torch.launch.train
--arch qwen1.5-0.5b``.)
"""
import argparse
import dataclasses
import tempfile

import torch

from repro_torch.configs import SMOKES
from repro_torch.data.loader import CompressedTokenLoader
from repro_torch.models import get_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer
from repro_torch.train.loop import LoopConfig, run
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import make_train_step

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=200)
ap.add_argument("--batch", type=int, default=8)
ap.add_argument("--seq", type=int, default=128)
ap.add_argument("--d-model", type=int, default=128)
ap.add_argument("--layers", type=int, default=4)
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
device = torch.device(args.device)
if device.type == "cuda" and not torch.cuda.is_available():
    raise SystemExit("no CUDA device is available; pass --device cpu to train on the CPU")

cfg = dataclasses.replace(
    SMOKES["qwen1.5-0.5b"], d_model=args.d_model, n_layers=args.layers,
    n_heads=4, n_kv_heads=4, d_ff=args.d_model * 3, vocab=4096)
model = get_model(cfg)
params = model.init(torch.Generator(device).manual_seed(0), device, train=True)
n = sum(p.numel() for p in params.parameters())
print(f"model: {cfg.name} variant, {n / 1e6:.2f}M params on {device}")

opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
opt_state = optimizer.init(params)
step = make_train_step(cfg, opt_cfg)

loader = CompressedTokenLoader(cfg.vocab, args.batch, args.seq, device=device)
decode = loader.decode_fn()


def step_with_decode(p, o, bufs):
    # ZipFlow integration: the unpack is the first launch of the step
    return step(p, o, decode(bufs))


def batch_fn(i):
    return loader.to_device(loader.encode_host(i))


with tempfile.TemporaryDirectory() as d:
    loop_cfg = LoopConfig(total_steps=args.steps, ckpt_dir=d,
                          ckpt_every=max(args.steps // 4, 10), log_every=20)
    params, opt_state, hist = run(loop_cfg, step_with_decode, params, opt_state, batch_fn)
    print(f"\nloss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} over {len(hist)} steps")
    print(f"tokens moved compressed: ratio {loader.ratio:.2f}x "
          f"({loader.bytes_compressed / 1e6:.1f} MB vs {loader.bytes_plain / 1e6:.1f} MB plain)")
    rep = ckpt.compression_report(d)
    print(f"checkpoint shards: ratio {rep['ratio']:.3f}x")
if not hist[-1]["loss"] < hist[0]["loss"]:
    raise SystemExit("training did not learn")
print("OK")
