"""TPC-H columns through the PyTorch/CUDA port: compress on the host, stream to
the device (whole, or in chunks), decode, and check against the source.

Run:  PYTHONPATH=src python examples/tpch_pipeline_torch.py [--scale 0.01]
          [--chunk-kib N] [--chunk-decode] [--device cpu]

``--chunk-kib 0`` moves each column in one copy; a size moves every leaf in
pieces of that many KiB, and ``--chunk-decode`` decodes each chunk (element
chunk or span of whole groups) in its own launch.  On a CUDA device (the
default) the kernels are built first; ``--device cpu`` runs the plain versions.
"""
import argparse

import numpy as np

from repro_torch.data.columns import TABLE2_PLANS
from repro_torch.data.loader import ColumnPipeline
from repro_torch.data.tpch import generate

ap = argparse.ArgumentParser()
ap.add_argument("--scale", type=float, default=0.01)
ap.add_argument("--chunk-kib", type=int, default=0)
ap.add_argument("--chunk-decode", action="store_true")
ap.add_argument("--device", default=None)
args = ap.parse_args()

cols = {k: v for k, v in generate(args.scale, seed=0).items() if k in TABLE2_PLANS}
pipe = ColumnPipeline(dict(TABLE2_PLANS), device=args.device,
                      chunk_bytes=args.chunk_kib * 1024 or None,
                      chunk_decode=args.chunk_decode)
ratios = pipe.compress(cols)
res = pipe.run()
for name, r in res.items():
    if not np.array_equal(r.array.cpu().numpy().view(np.uint8), cols[name].view(np.uint8)):
        raise SystemExit(f"{name}: decoded column differs from its source")
    print(f"{name:16s} ratio {ratios[name]:7.2f} n_chunks {r.n_chunks:4d} "
          f"decode_launches {r.decode_launches:4d} transfer_ms {r.transfer_s * 1e3:8.3f} "
          f"decode_ms {r.decode_s * 1e3:8.3f}")
print(f"{len(res)} columns equal to their sources; makespan {pipe.makespan_s * 1e3:.3f} ms "
      f"({pipe.device}); decode units {sum(r.decode_launches for r in res.values())}; "
      f"programs {pipe.cache_stats}")
