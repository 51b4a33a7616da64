"""Batched LM serving through the PyTorch/CUDA port: continuous batching over
two slots, compressed prompts decoded on the card, and compressed KV paging.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py [--arch A] [--device cpu]

The model is the reduced (SMOKE) config of ``--arch`` (qwen1.5-0.5b unless
given; any of the ten: dense, MoE, VLM, RWKV6, Zamba2 or enc-dec) with random
weights from seed 0.
Five requests share two slots; two of them ship their prompts as ZipFlow
blobs (bitpack and rANS), which decode in one planned wave at admission (on
the card: kernels 1 and 3).  Then a cold KV block is paged out in the bitpack
wire format and back in through kernel 1.  On a CUDA device (the default) the
kernels are built first; ``--device cpu`` runs their plain versions.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import SMOKES
from repro_torch.core.plan import encode, make_plan
from repro_torch.models import get_model
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.kvcache import page_in, page_out

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="qwen1.5-0.5b", choices=sorted(SMOKES))
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
device = torch.device(args.device)
if device.type == "cuda" and not torch.cuda.is_available():
    raise SystemExit("no CUDA device is available; pass --device cpu")

cfg = SMOKES[args.arch]
params = get_model(cfg).init(torch.Generator(device).manual_seed(0), device)

# --- continuous batching over 2 slots, 5 requests (two prompts compressed) ---
eng = ServeEngine(cfg, params, batch_slots=2, max_len=128, eos=-1, device=device)
rng = np.random.default_rng(0)
for rid in range(5):
    prompt = rng.integers(0, cfg.vocab, 6).astype(np.int32)
    if rid < 2:
        eng.submit_compressed(rid, encode(make_plan("bitpack" if rid == 0 else "ans"),
                                          prompt), max_new=8)
    else:
        eng.submit(Request(rid, prompt, max_new=8))
done = eng.run_to_completion(max_steps=500)
for rid in sorted(done):
    print(f"request {rid}: generated {done[rid]}")
print(f"prompt programs: {eng.decode_cache_stats}")

# --- ZipFlow KV paging: quantize+bitpack a cold cache block to host ---
block = torch.from_numpy(rng.normal(size=(2, 64, cfg.n_kv_heads, cfg.hd))
                         .astype(np.float32)).to(device)
pb = page_out(block)
restored = page_in(pb, torch.float32, device=device)
err = float(torch.max(torch.abs(restored - block)))
nbytes = block.numel() * block.element_size()
print(f"\nKV paging: {nbytes} B block -> {pb.packed.nbytes} B on the wire "
      f"({nbytes / pb.packed.nbytes:.1f}x), max dequant err {err:.4f}")
