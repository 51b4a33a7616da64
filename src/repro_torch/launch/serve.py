"""Serving entry point: ``python -m repro_torch.launch.serve --arch <id> [--smoke]
[--device cpu]``

The continuous-batching engine over the uniform Model API, the reference's
``launch/serve.py``: random weights from seed 0 (``--arch``'s config, any of
the ten and so of every family, or its reduced ``--smoke`` config),
``--requests`` plain 8-token prompts, greedy decoding of ``--max-new`` tokens
each over ``--slots`` slots.  It runs on the
card (``--device cuda``, the default) unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCHS, SMOKES
from repro_torch.models import get_model
from repro_torch.serve.engine import Request, ServeEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to serve on the CPU")
    cfg = (SMOKES if args.smoke else ARCHS)[args.arch]
    model = get_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0), device)
    eng = ServeEngine(cfg, params, batch_slots=args.slots, max_len=256, eos=-1,
                      device=device)
    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        eng.submit(Request(rid, rng.integers(0, cfg.vocab, 8).astype(np.int32),
                           max_new=args.max_new))
    done = eng.run_to_completion(max_steps=2000)
    for rid in sorted(done):
        print(f"[serve] request {rid}: {len(done[rid])} tokens -> "
              f"{done[rid][:8]}...")


if __name__ == "__main__":
    main()
