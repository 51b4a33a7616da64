#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--scale S] [--seed N] [--out FILE.json]

Phases, in order; none catches its own failure, so any error or mismatch exits
non-zero before the final line:

  1. fail unless CUDA is available;
  2. build the three hand-written decode kernels from ``src/repro_torch/kernels/csrc``
     (``nvcc``, ``sm_90a``, one process per source, all at once) and load
     every kernel of them on the card (``preload`` line: the time CUDA's lazy
     module loading would otherwise add to first launches); fail if a build
     takes more registers a thread than ``core/geometry.py`` ``KERNEL_REGS``
     (which bounds the geometry spaces' blocks); then generate
     TPC-H at ``--scale`` (default SF 1) and encode all 24 Table-2 columns
     (set-up);
  3. kernel vs plain PyTorch version on the card, bitwise: every Fully-Parallel,
     Group-Parallel and Non-Parallel stage of the 24 columns' main path (the FP
     producers inside rule-5 Aux stages included) on the same inputs, timed
     beside their plain versions (the plain rANS decode, a Python loop of
     ``chunk_size`` steps, with fewer reps) and, for RLE expansion,
     ``torch.repeat_interleave`` (for byte-reassemble, the bytes viewed as
     32-bit words and cloned); each launch also by ``torch.profiler``, and
     kernel 3 at blocks of 32 and 64 threads; an FP bit-width x length sweep;
     kernel 1 at every bit width 0-32 around its tile, on packed buffers cut
     short (the clamp) at every 16-byte misalignment, at bit widths above 32
     (its per-element path), on uint8 and uint16 gathers, on gathers from a
     large table, from a uint8 table at an odd address and behind another
     transform, on BYTES items of 1-5 bytes, and on LOAD -> SPAN and UNPACK ->
     GATHER -> UNZIGZAG; GP on skewed run lengths, on zero-count groups
     whose window overflows a block's shared buffer, on all counts 1, on one
     run longer than many tiles and on StringDict words longer than a
     thread's 16 bytes; an rANS sweep (chunk sizes 256, 1000 and 4096; uint8,
     int32 and float32 items; a skewed, a one-symbol and a uniform 256-symbol
     alphabet; lengths that are not a multiple of the chunk size; a rule-4
     tail; tables outside the packed layout).  Then the chunk and span entries
     at 1 MiB chunks: one element chunk of each column that splits (kernel 1),
     every span of L_ORDERKEY under the reference's ``rle`` candidate plan and
     of O_ORDERKEY under ``deltastride`` (kernel 2), and L_RETURNFLAG's rANS
     spans (kernel 3; two of them against the plain version, which takes
     about a second a call, all of them through the column's equality with
     its whole decode), each timed beside the whole-column launch; each
     column's checked chunk and each span column's first span also run at a
     geometry off the native table (``OFF_NATIVE``), bitwise to the native
     launch (counted on the ``compare`` line).  Then the
     batched entries, at K = 2, 8 and one above each kernel's per-launch limit
     (the split): kernel 1 on L_DISCOUNT + L_TAX, kernel 2 on two RLE columns
     of one structure whose runs differ, kernel 3 on L_RETURNFLAG and a copy
     with its rANS chunks in another order; each held bitwise against its
     plain batched version and against K single launches, and timed at K = 2
     beside the two single launches;
  4. the FIFO whole-column path as it ran before the planner (``policy="fifo"``,
     ``chunk_bytes=None``, ``batch_columns=False``, passed explicitly, planned
     once outside the timed runs at the fixed window of 2 decode units):
     ``ColumnPipeline(..., device="cuda").run(plan=...)`` once cold and
     ``WARM_RUNS`` times warm, with the launch counts zeroed just before; every
     column must equal its source bitwise.  Then the same blobs through the
     plain backend, and one more warm run of this path and of the 1 MiB
     chunked path under one ``torch.profiler`` session for the device's busy
     time by kind.  Then the plain-copy yardstick (the plain
     columns copied from pinned memory on the executor's copy stream), and the
     chunked paths: ``ColumnPipeline(..., chunk_bytes=1 << 20,
     chunk_decode=True)`` and the same at 4 MiB (FIFO, no batching, planned
     once at window 2, as for the whole path), each cold and ``WARM_RUNS`` times warm with the counts zeroed just before,
     every column equal to its source; and the same for the two kernel-2 span
     columns;
  5. the planner's paths: ``ColumnPipeline(plans, device="cuda")`` under the
     reference's defaults (chunk-johnson, 1 MiB transfer chunks, batching),
     then ``policy="adaptive", chunk_bytes="auto", chunk_decode=True`` planned
     from the seeded chip model and again after those runs calibrated the
     cost model; each plan run cold and ``WARM_RUNS`` times warm with the
     counts zeroed just before, every column equal to its source; at SF 1 and
     seed 0 the reference-default plan must batch L_DISCOUNT + L_TAX, with one
     batched kernel-1 launch a run and no other batched launch.  ``planner``
     lines give the modeled and measured makespans, the baselines, the
     decisions by mode, decode units and launches per run, the batched groups
     and their batched-entry launches, and the calibrated
     ``launch_overhead_s`` beside the host time per added decode unit;
  6. dispatch and serving.  The inline issuer against the dispatch engine's
     transfer thread (``executor.run(plan=..., async_dispatch=False|True)``)
     on FIFO whole, FIFO chunked 1 MiB with per-chunk decode and the
     reference's defaults, the two modes interleaved, cold + ``WARM_RUNS``
     warm each, every column of every run bitwise equal to its source
     (``dispatch`` lines: makespan by events, host time of ``run``, effective
     plain GB/s, the plain copy of phase 4).  Then the serving mixes of the
     reference's ``benchmarks/fig20_serving.py`` through
     ``ColumnPipeline(..., chunk_bytes="auto", chunk_decode=True,
     policy="adaptive").serve_planner(...)``, each request shipping its own
     shallow copies of the SF-1 blobs: the closed mix (Q1, Q6 and Q13's
     columns, twice, at once) in a cold and a warm shared wave and through the
     naive server (``fifo-per-query``, ``max_wave=1``); the open loop (three
     arrival batches of two, each drained); the same through the drain loop
     (``start``/``submit``/``wait``/``stop``); the SLO mix (a bulk Q1 and three
     point ``O_ORDERKEY`` requests); and a deterministic preemption (the three
     points submitted at the bulk wave's first preempt call must cut in:
     ``preempted == 3``).  Every column of every request is checked bitwise,
     and a request's error or a wait that times out fails the script
     (``serve`` lines: requests, waves, wall, makespan by events over the
     waves, p50/p99 latency, modeled shared and naive makespans, decode units,
     ``cross_batched_saved``, the largest batch per kernel, registration host
     ms per wave and its parts summed over the waves, ``preempted``, the
     chosen candidates), with the counts zeroed just before each mix; the
     warm shared wave must launch every decode kernel, and no drain or
     transfer thread may outlive ``stop()``;
  7. the decode-fused queries (kernel 4, generated per query by
     ``kernels/query_codegen.py`` around ``csrc/query_gen.cuh``): TPC-H Q1
     and Q6 lowered onto their columns (``ColumnPipeline.lower_query``, which
     generates, builds and loads each query's kernel; ``build_s`` per query),
     each run through ``run_query`` whole (one chunk, ``executor.run_query(...,
     chunk_bytes=None)``), chunked at 1 MiB (``ColumnPipeline(chunk_bytes=1 <<
     20)``) and in the loader's searched configuration
     (``ColumnPipeline(chunk_bytes=None)``), each cold + ``WARM_RUNS`` warm,
     with the counts zeroed just before the query runs and read just after
     (Q1 also runs kernel 3 for its resident L_RETURNFLAG): every kernel-4
     launch of those runs is a generated kernel's.  The count lane
     must equal a numpy count over the source columns exactly, and the result
     the materialize-then-query torch engine on the card (the port's ``run`` of
     the query's columns, then ``data/queries.py``) within ``rtol`` 1e-4, the
     reference example's tolerance (the sums are taken in another order).
     Then every kernel-4 launch of those runs is repeated on the same chunk
     against its plain version: the count lane bitwise, the float lanes within
     1e-5 relative (each row's values are the same bits; only the order of the
     sums differs).  ``query`` lines give the fused makespan by CUDA events and
     the host time, ``materialize_ms``, the kernel's whole-launch time, its
     plain version's, the bytes bound (``fusion.hbm_traffic_bytes`` at the HBM
     rate), the operations bound (``query_codegen.ops_per_row`` times the
     rows at 33.5 T operations/s, INT32 and FP32 alike: the kernel emits no
     FMA) and ``bound_ms``, the larger,
     chunks, launches and selectivity.  Then the ad-hoc queries wider than
     Q1 (``data/queries.py`` ``WIDE_PLANS``: 17 lanes, 4 lanes x 16 segments,
     7 x 32 and 1 x 256 -- 256 and 512 accumulators, more than a block's
     threads, the last kept in global memory) and a column-free aggregate
     (``CONST_LANE_PLAN``, 2.5 x the count), their kernels built in one round,
     each through ``lower_query``/``run_query`` with the counts zeroed just
     before: counts against numpy exactly, results against the
     materialize-then-query engine (``plan_engine``) within rtol 1e-4, every
     kernel-4 launch against its plain version (``query wide`` lines);
  8. geometry: for each of kernels 1-3, its largest main-path stage (the
     ``kernels`` line's ``at``) over its whole <L,S,C> space
     (``core/geometry.py``): ``autotune.brute_force`` and ``pruned_search``,
     each geometry measured once (CUDA events, L2 flushed, median of 10) after
     its output is held bitwise against the plain version; the native
     table's and the baseline's geometry beside them, and the Spearman rank
     correlation of ``analytic_cost_ns`` with the measured times
     (``geometry`` lines; each geometry's time in ``--out``);
  9. baseline: ``compile_decoder(enc, backend="baseline")`` (unfused, every
     stage at ``BASELINE_GEOMS``) for all 24 columns, bitwise against the
     fused program and the source, timed whole beside the fused decode, with
     the launches of one decode of each (``baseline`` lines);
 10. report: per-column lines, a totals line, the ``{"kernels": [...]}`` line
     (kernel 4's object beside the three decode kernels', each of those with
     its ``geometry`` object, the launches of phase 11's engine run and
     prompt wave and ``lm_family_launches``, phase 12's per family, and
     ``lm_train_launches``, phase 13's training run, and phase 16's
     ``mesh_run_launches_per_run``, ``mesh_shard_span_launches_per_run`` and
     ``mesh_mid_column_span_launches_per_run``, the last two counted), the
     card's name and power limit from ``nvidia-smi``, and last ``{"ok":
     true, "device": {...}}``;
 11. lm serve (runs after phase 9, so that phase 10 reports it): the
     language-model serving path at the full width of qwen1.5-0.5b (24
     layers, d_model 1024, 16 heads of 64, QKV bias, d_ff 2816, vocab
     151936), random weights drawn in f32 on the card from ``--seed`` by the
     port's own init.  Parity: one decode step after a 16-token prefill, f32
     on the card with TF32 off, against the same weights in f32 on the CPU,
     within ``rtol`` 1e-3 and ``atol`` 1e-3 of the largest |logit| (the CPU
     copy is freed after); the bf16 cast's distance from f32 (the step's max
     abs difference, top-1 agreement over a 17-token forward and the step) is
     printed, not gated.  The engine run: ``ServeEngine(batch_slots=2,
     max_len=256, eos=-1)`` in bf16 serves three bitpack prompts of 16, 16
     and 24 tokens and one rANS prompt of 40 (``submit_compressed``: one
     planner wave on kernels 1 and 3) and one plain 8-token ``submit``, 16
     tokens each, with the counts zeroed just before and read just after:
     every decoded prompt must equal its source, every request emit 16
     tokens without error, the prompt cache read 3 programs and 1 hit, every
     logit be finite, and kernels 1 and 3 have launched.  KV paging: a (2,
     256, 16, 64) bf16 block through ``page_out`` and ``page_in`` (kernel 1),
     bitwise against the plain ``page_in``.  ``lm`` lines: the parity and
     bf16 numbers; prefill ms per prompt token, the median decode-step ms
     (CUDA events) and host ms per step, the weights' bytes bound of a step,
     generated tokens/s; the prompt wave's ``register_s``, ``makespan_s``
     and launches per kernel; the top-level aten ops of a decode step (a
     CPU-only ``torch.profiler`` session over 5 steps: count, the commonest,
     their host ms under the profiler); the wire bytes against the bf16 bytes and
     ``page_in`` (and the unpack alone) on kernel 1 against its plain
     version;
 12. lm families (after phase 11): for each of phi3.5-moe-42b-a6.6b (MoE,
     d_model 4096, 16 experts top-2, d_ff 6400; 8 of its 32 layers, as the
     whole model's ~84 GB in bf16 does not fit the card), qwen2-vl-2b
     (M-RoPE), rwkv6-7b, zamba2-7b (81 Mamba2 layers and a shared attention
     block every 6) and seamless-m4t-medium (12 + 12 layers), each at its
     published width and otherwise whole (``LM_FAMILIES``), random weights
     drawn on the card from ``--seed`` by the port's init.  Parity: one decode
     step after a 16-token prefill (qwen2-vl's after a 16-row patch prefix
     with 3-D positions whose h/w streams differ from t; seamless's through
     ``Model.prefill`` with 64 random frames), f32 on the card with TF32 off
     against the same weights on the CPU within ``LM_TOL``, at a cut depth
     (2 layers; 7 for zamba2, one super-block and a tail layer; 2 + 2 for
     seamless).  The engine run: ``ServeEngine(batch_slots=2, max_len=256,
     eos=-1)`` in bf16 serves a bitpack prompt of 16 tokens and an rANS
     prompt of 24 (``submit_compressed``, one planner wave) and a plain
     8-token prompt, 8 tokens each, with the counts zeroed just before and
     read just after: every decoded prompt equal to its source, every request
     8 tokens without error, every logit finite, kernels 1 and 3 launched.
     One ``lm family`` line each: layers run of the config's and parameters,
     ``init_s``, the parity error against the largest |logit|, the median
     decode-step ms (events) and host ms a step, the weights bound of a step
     (the bytes of the weights it reads at the HBM rate; of an MoE layer's
     experts, those this run's router picked, a mean a layer), prefill ms a
     prompt token, tokens/s and the launches per kernel; then the phase's
     seconds.  Each family's models are freed before the next is drawn.
 13. lm train (after phase 12): the training path.  qwen1.5-0.5b at full
     width, f32 master weights drawn on the card from ``--seed`` by
     ``init(train=True)``, bf16 compute, remat "dots", AdamW at the
     reference's defaults (``weight_decay`` 0.1, ``total_steps`` 8), batch 4
     x 256.  One fixed batch through ``CompressedTokenLoader``: packed at 18
     bits on the host, unpacked on kernel 1, bitwise against the plain
     version and the host's tokens.  The main path: 8 steps, each starting
     with the unpack, with the counts zeroed just before and read just
     after (kernel 1 once a step); the loss must fall and stay finite.
     ``lm train`` lines: the losses; the step by events (median of steps
     2-8) and its host issue time, tokens/s, peak memory, the FLOP bound (6
     x the matrix weights x tokens plus causal attention, at 989 TFLOP/s)
     and the bytes bound (weights read, gradients written, AdamW's reads and
     writes, in f32, at the HBM rate); the loader's packed against int32
     bytes and the unpack on kernel 1 against the plain version; the step
     under remat none/"full"/"dots"; microbatch 2 against 1 in f32 (TF32
     off) on the same weights: the loss within 1e-5, every gradient within
     1e-3 of its parameter's largest, and one step at ``microbatch=2``; the
     embedding's checkpoint encoding and decoding on the host (ms per MB).
     f32 parity at 2 layers (TF32 off), AdamW at lr 3e-3 with 2 warm-up
     steps so the weights move: every remat policy's gradients on the card
     within 1e-4 of none's (bitwise printed); every gradient on the card
     within 1e-3 of its parameter's largest on the CPU (the f32 and f64
     grad norms printed); two AdamW updates on each side from the same
     gradients (the CPU's, of two batches), each parameter within 1e-3 of
     its largest change; then two train steps on each side, losses and
     grad norms within 1e-4 relative, the parameters' difference within
     1e-2 of their change (L2 over all).
     Each other family (``LM_FAMILIES``' parity cuts, f32): one train step
     on the card, loss and grad norm finite, the loss within 1e-4 of the
     CPU's.  At the SMOKE size on the card: ``save`` then ``restore`` bit
     for bit (ratio, seconds, ms per MB), a ``loop.run`` failing at step 5
     and resumed equal bit for bit to an uninterrupted one (under
     ``torch.use_deterministic_algorithms``), and ``python3 -m
     repro_torch.launch.train --smoke --steps 4`` run to its end; then the
     phase's seconds.
 14. lm roofline (after phase 13): qwen1.5-0.5b at full width, random
     weights from ``--seed``: phase 11's decode step (2 slots, ``max_len``
     256, bf16, the cache 128 rows full), a prefill of 2 x 256, and phase
     13's train step (batch 4 x 256, remat "dots", AdamW, f32 master
     weights).  Each is counted by ``roofline.op_cost.analyze`` on the card
     and the same call on ``meta``: the run fails unless the FLOPs and bytes
     are equal (the dry run predicts the card's work).  Each is timed warm by
     CUDA events (median of 5); one ``lm roofline`` line each: ``model_flops``,
     the counted FLOPs and bytes, the events time, ``mfu`` (model FLOPs over
     the time at 989 TFLOP/s), ``hbm_share`` (counted bytes over the time at
     3.35 TB/s), the roofline's step time and bottleneck, and the meta
     count's ``peak_bytes`` against the step's ``max_memory_allocated``
     rise.  Then ``launch.dryrun.run_cell`` on meta for ``ROOF_CELLS``
     (qwen1.5-0.5b train_4k on the card, decode_32k on the card and the
     16 x 16 pod, phi3.5-moe decode_32k on the card; the pod cell counted
     per device on a fake group that the cell opens and destroys), a
     ``dryrun`` line each; then the phase's seconds.  qwen's train_4k pod
     cell moved to phase 15 (d);
 15. mesh (after phase 14): (a) ``ColumnPipeline(mesh=N).mesh_plan()`` over
     the 24 columns' blobs with phase 4's calibrated cost model at N = 1, 2
     and 4, and N = 4 with ``placement="sharded"`` on a topology whose fabric
     is priced at NVLink's rate over the host link's (``mesh plan`` lines:
     modeled makespan, baselines, sharded columns, D2D legs, planning host
     ms; modeled, not measured); each makespan at or below its round-robin
     and single-device baselines; N = 1 equal to ``plan_execution``'s plan
     simulated at its own staging window, and at or above its unbounded
     makespan (the two differ when no window up to 8 is stall-free).
     (b) qwen1.5-0.5b's f32 training weights at full width placed as
     DTensors on a 1 x 1 ("data", "model") ``DeviceMesh`` over an NCCL group
     of one, under the mesh context: ``MESH_STEPS`` train steps (phase 13's
     batch, sequence and remat) against the same steps unplaced, the losses
     and every parameter bitwise equal (``mesh placed`` line: both steps'
     ms by events and host ms).  (c) ``make_dp_compressed_step`` over a
     ("pod",) mesh of ``DP_RANKS`` processes on ``cuda:0`` (NCCL refuses two
     ranks on one card: a gloo group, which takes CUDA tensors) at full
     width, global batch 4 x 256, ``MESH_STEPS`` steps, each step's tokens
     unpacked on kernel 1 by ``CompressedTokenLoader``: the ranks'
     parameters bitwise equal after every step, the synced gradients and
     each member's new error buffer bitwise the plain int8 sum's (rank 0
     takes rank 1's pre-sync gradients and errors), the loss finite
     (``mesh dp`` lines: step ms, sync ms, an f32 all-reduce of the same
     gradients, which through gloo's host memory say nothing of NVLink;
     R6: ``wire_bytes(compressed=True)`` beside the sync's all-reduce wire
     bytes that ``op_cost`` counts).  (d) ``MESH_CELL`` (qwen1.5-0.5b
     train_4k on the pod) through ``python -m repro_torch.launch.dryrun`` in
     a child process (a process has one default group): one device's
     counted FLOPs and bytes, collectives by kind, ``t_collective`` and
     ``per_device_live`` beside the ideal split of phase 14's card cell,
     its FLOPs exactly the card cell's / 256 (``mesh dryrun`` line; modeled
     from counts on meta).  Then the phase's seconds.
 16. mesh run (after phase 15): the mesh's executor,
     ``ColumnPipeline.run_sharded`` over phase 4's blobs of the 24 columns
     and phase 4's kernel-2 span columns (``SPAN_PLANS``), with phase 15's
     calibrated cost model; every logical device id maps onto the one card
     (``devices[id % len(devices)]``), each leg on a copy stream and a
     compute stream of its own.  The reference output of every gate is the
     pipeline's single-device ``run()``, held bitwise to the source.  (a)
     ``mesh_plan(2)``, ``mesh_plan(4)`` and the three group-span columns
     (L_RETURNFLAG's rANS, kernel 3; the span columns, kernel 2) alone at
     N = 4 with ``shard_threshold_bytes=0``, every one sharded (the 26
     columns' plans keep them whole at SF 1), each ``MESH_RUN_REPS`` times
     sequentially and concurrently, interleaved, the counts zeroed just
     before each run: every column bitwise, every logical device with items
     at one or more decode units in ``device_launches`` and at least its
     shards' spans, every sharded column on more than one id, the launches
     of kernels 2 and 3 by shard spans (counted as they happen: a shard
     unit's span program calls, their difference of the kernel counters)
     equal to those the shard schedules call for, in all and from
     ``g_start > 0``, and in the forced case kernels 2 and 3 launched on
     spans that start inside a column (``mesh run`` lines: makespan by events from the first leg's
     start to the last leg's end, host ms of ``run_sharded``, the modeled
     makespan, decode units by logical device, kernel launches and shard
     span launches by kernel, logical and physical device counts).  (b) the
     group-span columns under ``placement="sharded"`` on the reference's
     skewed-link fabric (link 0 six times slower, ``MESH_D2D_SCALE``), both
     modes: bitwise, the executed D2D legs the plan's, each shard on its
     placed device id, the fabric EWMA moved (``mesh run d2d`` lines: each
     leg's bytes and copy ms by events, the fitted ``d2d_scale``; copies
     within the card's memory, not NVLink).  (c) phase 6's closed mix through
     phase 6's serving pipeline with ``serve_planner("shared", mesh=2)``, a
     cold and a warm wave: every column bitwise, every wave ``mesh:`` on ids
     (0, 1), no request error (``mesh serve`` lines beside phase 6's warm
     non-mesh wave).  (d) ``launch.elastic.replan_suffix`` of (a)'s N = 4
     plan after logical device 0 is lost with its whole columns done: the
     survivors decode the rest bitwise (``mesh run suffix`` line).  Then the
     phase's seconds.

It imports nothing of JAX or of the reference package ``repro``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
KERNELS = {
    "fully_parallel": ("src/repro_torch/kernels/csrc/fully_parallel.cu",
                       "src/repro/kernels/fully_parallel.py:35"),
    "group_parallel": ("src/repro_torch/kernels/csrc/group_parallel.cu",
                       "src/repro/kernels/group_parallel.py:51"),
    "non_parallel": ("src/repro_torch/kernels/csrc/non_parallel.cu",
                     "src/repro/kernels/non_parallel.py:29"),
}
# kernel 4 replaces no TPU kernel: the reference's Reduce runs under XLA jit;
# it is generated per query (kernels/query_codegen.py) around this header
QUERY_KERNEL = ("query_reduce", "src/repro_torch/kernels/csrc/query_gen.cuh",
                "src/repro/core/compiler.py:204 (XLA, no pallas_call)")
QUERY_RTOL = 1e-4          # fused vs materialize-then-query: sums in another order
QUERY_KERNEL_RTOL = 1e-5   # kernel vs plain: the same row values, another sum order
FP_BWS = (1, 3, 7, 8, 13, 17, 25, 31, 32)
FP_NS = (1, 127, 4097, 1 << 20, 1_000_003)
NP_CHUNKS = (256, 1000, 4096)     # 1000: chunks that are not a multiple of 16
NP_KINDS = ("uint8", "int32", "float32", "skewed", "one-symbol", "uniform256")
NP_BLOCKS = (32, 64)              # kernel 3's block sizes timed on the main path
NP_NS = (1, 3 * 4096, 1_000_003)
WARM_RUNS = 5
# operations bound of the rANS decode: integer operations per symbol (mask,
# shift, multiply, add, subtract, compare, renorm shift/or, three table reads,
# the store) over the H100 SXM's peak INT32 rate outside the tensor cores
# (33.5 TOP/s, Hopper architecture white paper)
NP_OPS_PER_SYMBOL = 12
INT32_OPS_PER_S = 33.5e12
# float operations outside the tensor cores: 67 TFLOP/s counts an FMA as two;
# kernel 4 emits no FMA, so each add, multiply, compare or divide (one
# operation by the query's definition) issues at the instruction rate
FP32_OPS_PER_S = 33.5e12
CHUNK_SIZES = (1 << 20, 4 << 20)  # chunk_bytes of the chunked paths
# kernel 2's span columns: the reference's candidate plans of the key columns
# (no Table-2 column reaches a Group-Parallel span at SF 1)
SPAN_PLANS = {"L_ORDERKEY": "rle", "O_ORDERKEY": "deltastride"}
# decode units per run the reference's ``StreamingExecutor.chunk_schedule``
# gives the 24 Table-2 columns at SF 1, seed 0
REF_UNITS_SF1 = {1 << 20: 109, 4 << 20: 41}
NP_PLAIN_SPANS = 2                # rANS spans held against the plain version
# the FIFO whole-column configuration the phases before the planner's run in
FIFO_WHOLE = {"policy": "fifo", "chunk_bytes": None, "batch_columns": False}
# one geometry per pattern off the native table, for the chunk and span entries
OFF_NATIVE = {"fully_parallel": (2, 512, 2), "group_parallel": (8, 32, 16),
              "non_parallel": (2, 128, 2)}
PATTERN = {"fully_parallel": "fp", "group_parallel": "gp", "non_parallel": "np"}
# the wide ad-hoc queries' group keys (column, segments), for the numpy count
WIDE_KEYS = {"lanes17": None, "lanes4_seg16": ("L_SUPPKEY", 16),
             "lanes7_seg32": ("L_PARTKEY", 32), "lanes1_seg256": ("L_PARTKEY", 256),
             "const_lane": None}
# LM serving phase (11): qwen1.5-0.5b at full width through the port's engine
LM_ARCH = "qwen1.5-0.5b"
LM_SLOTS, LM_MAX_LEN, LM_MAX_NEW = 2, 256, 16
# (rid, codec, prompt tokens) of the compressed prompts; rid 4 is a plain submit
LM_PROMPTS = ((0, "bitpack", 16), (1, "bitpack", 16), (2, "bitpack", 24), (3, "ans", 40))
LM_PLAIN = 8
LM_PREFILL = 16              # the parity check's prompt, then one decode step
LM_TOL = 1e-3                # f32 card vs CPU: rtol, and atol as a share of max |logit|
LM_PAGE_SHAPE = (2, 256, 16, 64)
LM_PROFILED_STEPS = 5        # decode steps under the host-ops profiler session
# LM families phase (12): each family at its published width; the config
# changes of the serving run (a depth cut where one card's memory forces it)
# and of the f32 parity check (a depth cut that keeps the CPU copy small)
LM_FAMILIES = {
    "phi3.5-moe-42b-a6.6b": ({"n_layers": 8}, {"n_layers": 2}),   # 84 GB whole in bf16
    "qwen2-vl-2b": ({}, {"n_layers": 2}),
    "rwkv6-7b": ({}, {"n_layers": 2}),
    "zamba2-7b": ({}, {"n_layers": 7}),          # one super-block of 6 and a tail layer
    "seamless-m4t-medium": ({}, {"n_layers": 4, "enc_layers": 2, "dec_layers": 2}),
}
FAMILY_PROMPTS = ((0, "bitpack", 16), (1, "ans", 24))   # rid 2 is a plain submit
FAMILY_PLAIN, FAMILY_MAX_NEW = 8, 8
FAMILY_PATCHES, FAMILY_FRAMES = 16, 64   # qwen2-vl's patch prefix, seamless's source frames
# LM training phase (13): qwen1.5-0.5b at full width through the port's train
# step, its tokens unpacked on kernel 1 (launch/train.py's batch, sequence and
# AdamW defaults)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_REMAT = 4, 256, 8, "dots"
TRAIN_TOL = 1e-4             # f32 card vs CPU: loss and grad norm, relative
TRAIN_GRAD_TOL = 1e-3        # f32 gradients (card vs CPU; microbatch 2 vs 1), of each
#                              parameter's largest |gradient| (the CPU tests' GRAD_TOL)
TRAIN_ADAM_TOL = 1e-3        # AdamW on the card vs the CPU from the same gradients, of each
#                              parameter's largest change (a lost update is 1, a lost decay
#                              0.4, b2 0.999 for 0.95 5e-3 to 7e-3)
TRAIN_STEP_TOL = 1e-2        # two train steps, card vs CPU: |params' difference| over
#                              |params' change| (L2, all parameters; an update lost is 1)
TRAIN_MB_TOL = 1e-5          # microbatch 2 vs 1 loss, f32 on the card, relative
TRAIN_PARITY = (2, 64)       # layers and sequence (batch LM_SLOTS) of the f32 parity check
TRAIN_PARITY_STEPS = 2
TRAIN_PARITY_OPT = {"lr": 3e-3, "warmup_steps": 2, "total_steps": 50}   # weights move ~lr
TRAIN_REMATS = (None, "full", "dots")
TRAIN_REMAT_STEPS = 3        # steps timed under each remat policy (the first is warm-up)
TRAIN_LOOP = (6, 4, 5)       # SMOKE loop: steps, ckpt_every, fail_at_step
# LM roofline phase (14): qwen1.5-0.5b's decode step (phase 11's engine: 2
# slots, max_len 256, bf16), a prefill of 2 x 256 and phase 13's train step,
# each counted on the card and on meta; then dry-run cells on meta
ROOF_DECODE_LEN = 128        # cache rows filled before the timed decode step
ROOF_REPS = 5                # warm steps timed (median)
ROOF_CELLS = (("qwen1.5-0.5b", "train_4k", "card"), ("qwen1.5-0.5b", "decode_32k", "card"),
              ("qwen1.5-0.5b", "decode_32k", "pod"),
              ("phi3.5-moe-42b-a6.6b", "decode_32k", "card"))
# mesh phase (15): decode plans over N links from phase 4's calibrated cost
# model; the placed train step and the compressed data-parallel step at
# qwen1.5-0.5b's full width (phase 13's batch, sequence and remat); one
# per-device dry-run cell in a child process (phase 14's qwen train_4k pod
# cell, counted there)
MESH_PLAN_N = (1, 2, 4)
MESH_FABRIC_GBPS = 450.0     # NVLink 4, each direction (H100 SXM5 datasheet)
MESH_STEPS = 3
DP_RANKS = 2                 # two processes on the one card, a gloo group
MESH_CELL = ("qwen1.5-0.5b", "train_4k", "pod")
MESH_REL = 1e-9              # N = 1 against plan_execution: the same simulation
# mesh run phase (16): run_sharded of phase 15's plans and phase 4's blobs
MESH_RUN_REPS = 3            # runs of each plan in each mode (the first cold)
MESH_SKEW = (6.0, 1.0, 1.0, 1.0)   # the reference's skewed-link fabric case
MESH_D2D_SCALE = 0.05        # (tests/test_mesh_decode.py): link 0 6x slow, a cheap fabric


def bits(t: torch.Tensor) -> torch.Tensor:
    """4-byte values as int32 bits (torch compares few uint32 ops)."""
    return t.view(torch.int32) if t.dtype in (torch.float32, torch.uint32) else t


def same(k: torch.Tensor, p: torch.Tensor, what: str) -> float:
    """Bitwise equality of kernel and plain outputs; returns the max abs error (0)."""
    if k.dtype != p.dtype or k.shape != p.shape:
        raise AssertionError(f"{what}: kernel gives {k.dtype}{tuple(k.shape)}, "
                             f"plain {p.dtype}{tuple(p.shape)}")
    if not torch.equal(bits(k), bits(p)):
        err = (k.double() - p.double()).abs().max().item()
        raise AssertionError(f"{what}: kernel differs from plain, max abs err {err}")
    return 0.0


class Timer:
    """Median device time of a call, CUDA events, L2 flushed before each rep.

    The flush (zeroing 1 GiB, ~0.4 ms of device time) also keeps the device
    busy while the host prepares the launch, so the events time the device's
    work, not the host's argument packing."""

    def __init__(self, reps: int = 10):
        self.reps = reps
        self.flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")

    def ms(self, fn, reps: int | None = None) -> float:
        fn()
        ts = []
        for _ in range(reps or self.reps):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return float(np.median(ts))


def stage_bytes(names, env, out: torch.Tensor) -> int:
    """Bytes a stage must move: each input read once, the output written once."""
    return (sum(env[k].numel() * env[k].element_size() for k in set(names))
            + out.numel() * out.element_size())


def ans_input(kind: str, n: int, rng) -> np.ndarray:
    """One input of the rANS sweep."""
    if kind == "skewed":
        return np.where(rng.random(n) < 0.995, 78, rng.integers(0, 256, n)) \
            .astype(np.uint8)
    if kind == "one-symbol":
        return np.full(n, 82, np.uint8)
    if kind == "float32":
        return rng.normal(0, 1e3, n).astype(np.float32)
    if kind == "int32":
        return rng.integers(-2**31, 2**31, n).astype(np.int32)
    if kind == "uniform256":                # renormalises about every 2 steps
        return rng.integers(0, 256, n).astype(np.uint8)
    return rng.integers(0, 5, n).astype(np.uint8)


def long_words(n_words: int, rng) -> np.ndarray:
    """Text whose words (17-64 letters) are longer than a thread's 16 bytes."""
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    lens = rng.integers(17, 65, n_words)
    text = rng.choice(letters, int(lens.sum()) + n_words)
    text[np.cumsum(lens + 1) - 1] = ord(" ")
    return text.astype(np.uint8)


def mib(chunk_bytes: int) -> str:
    """A chunk size as a label: 1MiB, 4MiB, 64KiB."""
    return f"{chunk_bytes >> 20}MiB" if chunk_bytes >= 1 << 20 else f"{chunk_bytes >> 10}KiB"


def unit_env(enc, sched, k: int, whole_env: dict, device="cuda") -> dict:
    """What chunk k of ``sched`` reads, on the card: the whole buffers and its
    own slices of the sliced leaves (row-capped stripes included)."""
    from repro_torch.core.compiler import device_layout
    from repro_torch.core.plan import host_operands

    ops = host_operands(enc)
    env = {n: (torch.from_numpy(device_layout(sched.host_push[n])).to(device)
               if n in sched.host_push else whole_env[n]) for n in sched.whole}
    for leaf in sched.slices:
        env[leaf] = torch.from_numpy(device_layout(
            sched.piece(np.asarray(ops[leaf]), leaf, k))).to(device)
    return env


def profiled_ms(calls, flush: torch.Tensor, reps: int = 5) -> list[float]:
    """Median device time of each ``(fn, kernel)`` of ``calls`` over ``reps``
    calls of fn, as ``torch.profiler`` reads it (no launch latency, unlike CUDA
    events).  All of them run under one profiler session (a process's later
    sessions can miss the card's events), and a kernel's launches are matched
    to the calls in launch order, so each fn must launch its kernel once."""
    for fn, _ in calls:
        fn()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for fn, _ in calls:
            for _ in range(reps):
                flush.zero_()
                fn()
        torch.cuda.synchronize()
    gpu = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    seen = {k: [e.time_range.elapsed_us() / 1e3
                for e in sorted((e for e in gpu if k in e.name),
                                key=lambda e: e.time_range.start)]
            for k in {k for _, k in calls}}
    out = []
    for fn, k in calls:
        ts, seen[k] = seen[k][:reps], seen[k][reps:]
        if len(ts) != reps:
            raise AssertionError(f"profiler missed launches of {k}")
        out.append(float(np.median(ts)))
    if any(seen.values()):
        raise AssertionError("profiler saw more launches than were made")
    return out


def query_truth(q: int, cols: dict) -> np.ndarray:
    """The count lane from the source columns, in numpy: Q6's selected rows,
    Q1's selected rows per group key."""
    if q == 6:
        d = cols["L_DISCOUNT"]
        m = ((cols["L_SHIPDATE"] >= 8766) & (cols["L_SHIPDATE"] < 9131)
             & (d >= np.float32(0.05)) & (d <= np.float32(0.07)) & (cols["L_QUANTITY"] < 24))
        return np.array([m.sum()], np.float64)
    sel = cols["L_SHIPDATE"] <= 10000
    key = np.mod(cols["L_RETURNFLAG"].astype(np.int64) - 65, 4) * 2 + cols["L_LINESTATUS"]
    return np.bincount(key[sel], minlength=8)[:8].astype(np.float64)


def run_queries(args, cols: dict, encoded: dict, timer, hbm: float, libs) -> dict:
    """Phase 7: TPC-H Q1 and Q6 decode-fused on the card (see the module
    docstring); returns the ``query`` records and kernel 4's ``kernels`` object."""
    from repro_torch.core.fusion import hbm_traffic_bytes
    from repro_torch.data.columns import TABLE2_PLANS
    from repro_torch.data.loader import ColumnPipeline
    from repro_torch.data.queries import Q1_PLAN, Q6_PLAN, q1_engine, q6_engine
    from repro_torch.data.tpch import QUERY_COLUMNS
    from repro_torch.kernels import query_codegen, ref
    from repro_torch.kernels.query_reduce import KERNEL as QR, program, query_reduce

    plans = {1: Q1_PLAN, 6: Q6_PLAN}
    engines = {1: q1_engine, 6: q6_engine}
    runs, checks, per_query, lowered = [], [], {}, {}
    err = 0.0

    def drive(q, label, call):
        """Cold + WARM_RUNS warm runs of one configuration; each result checked."""
        spans, hosts, out = [], [], None
        for _ in ("cold",) + ("warm",) * WARM_RUNS:
            t0 = time.perf_counter()
            out = call()
            hosts.append((time.perf_counter() - t0) * 1e3)
            spans.append(out.makespan_s * 1e3)
            counts = np.asarray(out.acc.cpu())[-out.acc.numel() // (len(plans[q].aggregates) + 1):]
            truth = query_truth(q, cols)
            if not np.array_equal(counts.astype(np.float64), truth):
                raise AssertionError(f"q{q} {label}: count lane {counts.tolist()} "
                                     f"!= numpy {truth.tolist()}")
            checks.append((q, label, out))
        return {"query": f"q{q}", "config": label, "fused_ms": float(np.median(spans[1:])),
                "fused_ms_cold": spans[0], "fused_ms_warm_min": min(spans[1:]),
                "fused_ms_warm_max": max(spans[1:]), "host_ms": float(np.median(hosts[1:])),
                "chunks": out.n_chunks, "launches": out.decode_launches,
                "selectivity": out.selectivity, "transfer_ms": out.transfer_s * 1e3,
                "decode_ms": out.decode_s * 1e3, "traffic_bytes": out.traffic_bytes,
                "prefuse_traffic_bytes": out.prefuse_traffic_bytes,
                "compressed_bytes": out.compressed_bytes, "plain_bytes": out.plain_bytes}

    pipes = {}
    for q, qp in plans.items():
        names = QUERY_COLUMNS[q]
        chunked = ColumnPipeline({c: TABLE2_PLANS[c] for c in names}, device="cuda",
                                 chunk_bytes=1 << 20)
        searched = ColumnPipeline({c: TABLE2_PLANS[c] for c in names}, device="cuda",
                                  chunk_bytes=None)
        for p_ in (chunked, searched):
            p_.load({c: encoded[c] for c in names})
        t0 = time.perf_counter()
        fq, encs = chunked.lower_query(qp)        # generates, builds and loads its kernel
        lowered[q] = (time.perf_counter() - t0) * 1e3
        searched.lower_query(qp)
        pipes[q] = (chunked, searched, fq, encs)
    for lib in libs + (QR,):
        lib.launches = 0
    for q, (chunked, searched, fq, encs) in pipes.items():
        qp = plans[q]
        runs.append(drive(q, "whole", lambda: chunked.executor.run_query(fq, encs,
                                                                          chunk_bytes=None)))
        runs.append(drive(q, "chunked 1MiB", lambda: chunked.run_query(qp)))
        runs.append(drive(q, "searched", lambda: searched.run_query(qp)))
    launches = {lib.name: lib.launches for lib in libs + (QR,)}
    if QR.launches <= 0 or launches["non_parallel"] <= 0:
        raise AssertionError(f"the query path did not run kernels 3 and 4: {launches}")
    want = sum(r["launches"] for r in runs) * (WARM_RUNS + 1)
    if QR.launches != want:
        raise AssertionError(f"the generated kernels made {QR.launches} launches, the "
                             f"runs {want}")

    # every kernel-4 launch of those runs, repeated on its chunk against the plain version
    compared, rel = 0, 0.0
    for q, (chunked, searched, fq, encs) in pipes.items():
        red = fq.graph.stages[-1]
        res = {}
        for c in fq.resident:
            res[fq.resident_input(c)] = torch.from_numpy(cols[c]).cuda()
        for label, p_, cb in (("whole", chunked, None), ("chunked 1MiB", chunked, 1 << 20),
                              ("searched", searched, searched._query_cfg[plans[q].digest()][1])):
            sched, staged = p_.executor._query_staging(fq, cb)
            flat = staged.host.cuda()
            for k in range(sched.n_chunks):
                env = {**staged.views(flat, k), **res}
                kw = dict(n=sched.out_sizes[k], out_start=sched.out_starts[k])
                got = query_reduce(red, env, **kw)
                plain = ref.query_reduce_torch(red, env, **kw)
                S = fq.n_segments
                if not torch.equal(got[-S:], plain[-S:]):
                    raise AssertionError(f"q{q} {label} chunk {k}: count lane "
                                         f"{got[-S:].tolist()} != plain {plain[-S:].tolist()}")
                if not torch.allclose(got, plain, rtol=QUERY_KERNEL_RTOL, atol=0):
                    raise AssertionError(f"q{q} {label} chunk {k}: kernel {got.tolist()} "
                                         f"vs plain {plain.tolist()}")
                diff = (got.double() - plain.double()).abs()
                err = max(err, diff.max().item())
                rel = max(rel, (diff / plain.double().abs().clamp(min=1e-30)).max().item())
                compared += 1

    # materialize-then-query: the port's run of the query's columns, then the engine
    for q, qp in plans.items():
        chunked, searched, fq, encs = pipes[q]
        names = QUERY_COLUMNS[q]
        mat = ColumnPipeline({c: TABLE2_PLANS[c] for c in names}, device="cuda",
                             chunk_bytes=None)
        mat.load({c: encoded[c] for c in names})
        host_ms, dev_ms, result = [], [], None
        for _ in ("cold",) + ("warm",) * WARM_RUNS:
            t0 = time.perf_counter()
            out = mat.run()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            result = engines[q]({c: out[c].array for c in names})
            b.record()
            b.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            dev_ms.append(mat.makespan_s * 1e3 + a.elapsed_time(b))
        result = result.cpu().numpy()
        for r in runs:
            if r["query"] != f"q{q}":
                continue
            last = next(o for qq, lbl, o in reversed(checks) if qq == q and lbl == r["config"])
            got = np.asarray(last.result)
            if not np.allclose(got, result, rtol=QUERY_RTOL, atol=0):
                raise AssertionError(f"q{q} {r['config']}: fused {got.tolist()} vs "
                                     f"materialize-then-query {result.tolist()}")
            r["materialize_ms"] = float(np.median(host_ms[1:]))
            r["materialize_device_ms"] = float(np.median(dev_ms[1:]))
        # kernel 4's whole launch beside its plain version and its bound
        red = fq.graph.stages[-1]
        sched, staged = chunked.executor._query_staging(fq, None)
        env = {**staged.views(staged.host.cuda(), 0)}
        for c in fq.resident:
            env[fq.resident_input(c)] = torch.from_numpy(cols[c]).cuda()
        nbytes = hbm_traffic_bytes(fq.graph.stages, {**fq.operands, **{
            k: v for k, v in env.items() if k.endswith(".resident")}})
        prog = program(red, env)
        n_int, n_float = query_codegen.ops_per_row(prog)
        bytes_ms = nbytes / (hbm * 1e9) * 1e3
        ops_ms = max(n_int * red.n_in / INT32_OPS_PER_S, n_float * red.n_in / FP32_OPS_PER_S) * 1e3
        per_query[f"q{q}"] = {
            "ms": timer.ms(lambda: query_reduce(red, env)),
            "plain_ms": timer.ms(lambda: ref.query_reduce_torch(red, env), 3),
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms
            else "operations", "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
            "bytes": nbytes, "rows": red.n_in, "int_ops_per_row": n_int,
            "float_ops_per_row": n_float, "build_s": prog.build_s,
            "lower_query_ms": lowered[q], "digest": prog.lib.digest,
            "launches_per_query": {r["config"]: r["launches"] for r in runs
                                   if r["query"] == f"q{q}"}}
        for line in prog.lib.path().with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas query_gen q{q}: {line.strip()}")
    for r in runs:
        k = per_query[r["query"]]
        r.update(kernel_ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"])
        print(f"query {r['query']} {r['config']} " + " ".join(
            f"{key} {v:.4f}" if isinstance(v, float) else f"{key} {v}"
            for key, v in r.items() if key not in ("query", "config")))
    print(f"query compare: {compared} kernel-4 launches held against the plain version, "
          f"count lanes bitwise, float lanes max abs err {err:.6g}, max rel err {rel:.6g}; "
          f"main-path launches {launches}")
    big = per_query["q1"]
    kernel = {"name": QUERY_KERNEL[0], "route": "cuda", "source": QUERY_KERNEL[1],
              "replaces": QUERY_KERNEL[2], "launches": launches[QR.name],
              "max_abs_err": err, "max_rel_err": rel,
              "ms": big["ms"], "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
              "bound_by": big["bound_by"], "library_ms": None, "matches_plain": True,
              "design": "generated per query", "generator": "src/repro_torch/kernels/"
              "query_codegen.py", "ops_bound_ms": big["ops_bound_ms"], "bytes_bound_ms": big["bytes_bound_ms"],
              "build_s": {k: v["build_s"] for k, v in per_query.items()},
              "at": "q1 whole (one launch over every row)", "compared": compared,
              "per_query": per_query,
              "materialize_ms": {r["query"]: r["materialize_ms"] for r in runs
                                 if r["config"] == "whole"}}
    return {"runs": runs, "kernel": kernel}


def run_wide_queries(cols: dict, encoded: dict, timer, libs) -> list:
    """Phase 7, part 2: the ad-hoc queries wider than Q1 (``data/queries.py``
    ``WIDE_PLANS``: 17 lanes; 4 lanes x 16 segments; 7 x 32 and 1 x 256, more
    accumulators than a block has threads, the last in global memory) and a
    column-free aggregate (``CONST_LANE_PLAN``), each through
    ``ColumnPipeline.lower_query``/``run_query`` on kernel 4, with the counts
    zeroed just before the runs and read just after.  Their kernels build in
    one round first.  The count lane must equal numpy's exactly, the result
    the materialize-then-query engine (``plan_engine`` over the port's ``run``
    of the columns) within rtol 1e-4, and every kernel-4 launch of the runs
    its plain version (count bitwise, floats within 1e-5 relative); the
    column-free lane must be 2.5 x the count."""
    from repro_torch.core.query import lower_query
    from repro_torch.data.columns import TABLE2_PLANS
    from repro_torch.data.loader import ColumnPipeline
    from repro_torch.data.queries import CONST_LANE_PLAN, WIDE_PLANS, plan_engine
    from repro_torch.kernels import cuda, ref
    from repro_torch.kernels.query_reduce import KERNEL as QR, library, program, query_reduce

    plans = {**WIDE_PLANS, "const_lane": CONST_LANE_PLAN}
    pipes, progs = {}, []
    for name, qp in plans.items():
        names = qp.columns()
        p_ = ColumnPipeline({c: TABLE2_PLANS[c] for c in names}, device="cuda",
                            chunk_bytes=None)
        p_.load({c: encoded[c] for c in names})
        # the program on host-typed inputs (nothing built), to build all at once
        fq = lower_query(qp, {c: encoded[c] for c in names})
        progs.append(program(fq.graph.stages[-1], {
            b: torch.empty(0, dtype=dt) for b, dt in p_.executor.query_types(fq).items()}))
        pipes[name] = p_
    t0 = time.perf_counter()
    cuda.build([library(pr.source) for pr in progs])
    build_s = time.perf_counter() - t0
    lowered = {name: pipes[name].lower_query(qp) for name, qp in plans.items()}
    for lib in libs + (QR,):
        lib.launches = 0
    outs = {name: pipes[name].run_query(qp) for name, qp in plans.items()}
    launches = {lib.name: lib.launches for lib in libs + (QR,)}
    if QR.launches != sum(o.n_chunks for o in outs.values()):
        raise AssertionError(f"wide queries: {QR.launches} kernel-4 launches for "
                             f"{sum(o.n_chunks for o in outs.values())} chunks")
    sel = cols["L_QUANTITY"] < 24
    recs = []
    for (name, qp), pr in zip(plans.items(), progs):
        out, (fq, encs) = outs[name], lowered[name]
        S = qp.n_segments
        key = WIDE_KEYS[name]
        truth = (np.array([sel.sum()]) if key is None else
                 np.bincount(np.mod(cols[key[0]].astype(np.int64), key[1])[sel], minlength=S))
        counts = np.asarray(out.acc.cpu())[-S:]
        if not np.array_equal(counts.astype(np.int64), truth.astype(np.int64)):
            raise AssertionError(f"{name}: count lane {counts.tolist()} != numpy")
        mat = ColumnPipeline({c: TABLE2_PLANS[c] for c in qp.columns()}, device="cuda",
                             chunk_bytes=None)
        mat.load({c: encoded[c] for c in qp.columns()})
        res = mat.run()
        want = plan_engine(qp, {c: res[c].array for c in qp.columns()}).cpu().numpy()
        got = np.asarray(out.result)
        if not np.allclose(got, want, rtol=QUERY_RTOL, atol=0):
            raise AssertionError(f"{name}: fused {got.tolist()} vs materialize-then-query "
                                 f"{want.tolist()}")
        if name == "const_lane" and float(out.acc[0]) != 2.5 * float(out.acc[-1]):
            raise AssertionError(f"const_lane: {float(out.acc[0])} != 2.5 x "
                                 f"{float(out.acc[-1])}")
        p_ = pipes[name]
        red = fq.graph.stages[-1]
        sched, staged = p_.executor._query_staging(fq, p_._query_cfg[qp.digest()][1])
        flat = staged.host.cuda()
        res = {fq.resident_input(c): torch.from_numpy(cols[c]).cuda() for c in fq.resident}
        rel = 0.0
        for k in range(sched.n_chunks):
            env = {**staged.views(flat, k), **res}
            kw = dict(n=sched.out_sizes[k], out_start=sched.out_starts[k])
            k_out, plain = query_reduce(red, env, **kw), ref.query_reduce_torch(red, env, **kw)
            if not torch.equal(k_out[-S:], plain[-S:]) or \
                    not torch.allclose(k_out, plain, rtol=QUERY_KERNEL_RTOL, atol=0):
                raise AssertionError(f"{name} chunk {k}: kernel {k_out.tolist()} vs plain "
                                     f"{plain.tolist()}")
            d = (k_out.double() - plain.double()).abs()
            rel = max(rel, (d / plain.double().abs().clamp(min=1e-30)).max().item())
        env = {**staged.views(flat, 0), **res}
        n = sched.out_sizes[0]
        rec = {"query": name, "lanes": len(qp.aggregates), "segments": S,
               "accumulators": pr.n_acc, "acc_place": pr.acc_place,
               "chunks": out.n_chunks, "selected": int(sel.sum()),
               "fused_ms": out.makespan_s * 1e3, "max_rel_err": rel,
               "kernel_ms": timer.ms(lambda: query_reduce(red, env, n=n)),
               "plain_ms": timer.ms(lambda: ref.query_reduce_torch(red, env, n=n), 3)}
        recs.append(rec)
        print(f"query wide {name:14s} " + " ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in rec.items() if k != "query"))
    print(f"query wide: kernels built in {build_s:.2f} s; main-path launches {launches}")
    return recs


def spearman(a, b) -> float:
    """Spearman's rank correlation of two sequences (ties ranked in order)."""
    ra = np.argsort(np.argsort(np.asarray(a, dtype=np.float64)))
    rb = np.argsort(np.argsort(np.asarray(b, dtype=np.float64)))
    return float(np.corrcoef(ra, rb)[0, 1])


def run_geometry(big: dict, timer, spec) -> dict:
    """Phase 8: the launch-geometry spaces of kernels 1-3 on the card.  For
    each kernel's largest stage of the SF-1 run (the ``kernels`` line's
    ``at``), ``autotune.brute_force`` and ``autotune.pruned_search`` over its
    pattern's space (``core/geometry.py``), measuring each geometry once (CUDA
    events, L2 flushed, median of 10 launches; the pruned search reads the
    same measurements) after holding its output bitwise against the plain
    version; plus the native table's and the baseline's geometry, and the
    rank correlation of ``analytic_cost_ns`` with the measured times."""
    from repro_torch.core.autotune import brute_force, pruned_search
    from repro_torch.core.compiler import BASELINE_GEOMS
    from repro_torch.core.geometry import SPACES, analytic_cost_ns, native_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.fully_parallel import fully_parallel
    from repro_torch.kernels.group_parallel import group_parallel
    from repro_torch.kernels.non_parallel import non_parallel

    fns = {"fully_parallel": (fully_parallel, ref.fully_parallel_torch),
           "group_parallel": (group_parallel, ref.group_parallel_torch),
           "non_parallel": (non_parallel, ref.non_parallel_torch)}
    out = {}
    for kname, (rec, st, env) in big.items():
        pattern = PATTERN[kname]
        kfn, pfn = fns[kname]
        plain = pfn(st, env)
        width = plain.element_size()
        measured: dict = {}

        def measure(g):
            if g not in measured:
                same(kfn(st, env, g), plain, f"{kname} {rec['column']}:{st.name} at {g}")
                measured[g] = timer.ms(lambda: kfn(st, env, g))
            return measured[g]

        t0 = time.perf_counter()
        brute = brute_force(pattern, spec, measure, width)
        pruned = pruned_search(pattern, spec, measure, width)
        native = native_config(pattern, out_width=width)
        base = BASELINE_GEOMS[pattern]
        native_ms, base_ms = measure(native), measure(base)
        space = list(SPACES[pattern](spec, width))
        if len(brute.history) != len(space):
            raise AssertionError(f"{kname}: brute force probed {len(brute.history)} of "
                                 f"{len(space)}")
        model_kw = dict(bytes_in=rec["bytes"] - rec["out_bytes"], bytes_out=rec["out_bytes"])
        if pattern == "np":
            model_kw["chunk_size"] = st.chunk_size
        model = [analytic_cost_ns(pattern, g, st.n_out, width, spec, **model_kw)
                 for g in space]
        geo = {"stage": f"{rec['column']}:{st.name}", "n": st.n_out, "out_width": width,
               "space": len(space), "bitwise": len(measured),
               "brute_best": str(brute.best), "brute_ms": brute.cost,
               "pruned_best": str(pruned.best), "pruned_probes": pruned.probes,
               "pruned_ms": pruned.cost, "native": str(native), "native_ms": native_ms,
               "baseline": str(base), "baseline_ms": base_ms,
               "spearman_model": spearman(model, [measured[g] for g in space]),
               "model_best": str(space[int(np.argmin(model))]),
               "model_best_ms": measured[space[int(np.argmin(model))]],
               "worst": str(max(measured, key=measured.get)),
               "worst_ms": max(measured.values()), "seconds": time.perf_counter() - t0,
               "by_geometry": {str(g): v for g, v in sorted(measured.items(),
                                                            key=lambda kv: kv[1])}}
        out[kname] = geo
        print(f"geometry {kname:14s} {geo['stage']:28s} " + " ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in geo.items() if k not in ("stage", "by_geometry")))
    return out


def run_baseline(columns, cols: dict, encoded: dict, timer, libs) -> dict:
    """Phase 9: the unfused ``baseline`` backend (every stage a launch at
    ``BASELINE_GEOMS``) for each column on the card, bitwise against the fused
    program's decode and the source, each timed whole beside the fused one
    (CUDA events, L2 flushed, median of 10), with the kernel launches of one
    decode of each."""
    from repro_torch.core.compiler import compile_decoder, device_buffers

    recs = {}
    for col in columns:
        enc = encoded[col]
        bufs = device_buffers(enc)
        base, fused = compile_decoder(enc, backend="baseline"), compile_decoder(enc)
        counts = []
        for dec in (base, fused):
            before = [lib.launches for lib in libs]
            dec(bufs)
            counts.append(sum(lib.launches - b for lib, b in zip(libs, before)))
        got = base(bufs)
        same(got, fused(bufs), f"baseline {col} vs fused")
        same(got.cpu(), torch.from_numpy(cols[col]), f"baseline {col} vs source")
        recs[col] = {"stages": base.n_kernels, "fused_stages": fused.n_kernels,
                     "launches": counts[0], "fused_launches": counts[1],
                     "ms": timer.ms(lambda: base(bufs)),
                     "fused_ms": timer.ms(lambda: fused(bufs))}
        print(f"baseline {col:16s} " + " ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in recs[col].items()))
    tot = {k: sum(r[k] for r in recs.values()) for k in ("ms", "fused_ms", "launches",
                                                           "fused_launches")}
    print("baseline totals " + " ".join(f"{k} {v:.4f}" if isinstance(v, float)
                                        else f"{k} {v}" for k, v in tot.items()))
    return {"columns": recs, "totals": tot}


def run_serving(cols: dict, encoded: dict, libs, plain_copy_ms: float) -> dict:
    """Phase 6: the dispatch engine and the serving planner on the card (see
    the module docstring); returns the ``dispatch`` and ``serve`` records and
    per kernel the launches of one warm shared wave of the closed mix."""
    import copy

    from repro_torch.core.serve_planner import BULK, POINT
    from repro_torch.data.columns import TABLE2_PLANS
    from repro_torch.data.loader import ColumnPipeline
    from repro_torch.data.tpch import QUERY_COLUMNS

    columns = tuple(TABLE2_PLANS)
    plain_b = sum(cols[c].nbytes for c in columns)
    truth = {c: bits(torch.from_numpy(cols[c]).cuda()) for c in columns}

    def check(c: str, arr: torch.Tensor, what: str) -> None:
        if not torch.equal(bits(arr), truth[c]):
            raise AssertionError(f"{what} {c}: differs from its source")

    # inline against async dispatch, interleaved, on three paths
    paths = {"fifo whole": dict(FIFO_WHOLE),
             "fifo chunked 1MiB": {"policy": "fifo", "chunk_bytes": 1 << 20,
                                   "chunk_decode": True, "batch_columns": False},
             "reference-default": {}}
    dispatch = []
    for label, kw in paths.items():
        p_ = ColumnPipeline(dict(TABLE2_PLANS), device="cuda", **kw)
        p_.load(encoded)
        plan = p_.plan() if label == "reference-default" else p_.plan(window=2)
        for lib in libs:
            lib.launches = 0
        spans, hosts, issue, wait = ({False: [], True: []} for _ in range(4))
        for rep in range(WARM_RUNS + 1):             # the first pair is cold
            for mode in ((False, True) if rep % 2 == 0 else (True, False)):
                res = None
                t0 = time.perf_counter()
                res = p_.executor.run(plan=plan, async_dispatch=mode)
                hosts[mode].append((time.perf_counter() - t0) * 1e3)
                spans[mode].append(p_.makespan_s * 1e3)
                issue[mode].append(p_.executor.last_issue_s * 1e3)
                wait[mode].append(p_.executor.last_wait_s * 1e3)
                for c in columns:
                    check(c, res[c].array, f"dispatch {label} async={int(mode)}")
        counts = {k: lib.launches for k, lib in zip(KERNELS, libs)}
        if min(counts.values()) <= 0:
            raise AssertionError(f"dispatch {label}: a kernel did not run: {counts}")
        for mode in (False, True):
            ms = float(np.median(spans[mode][1:]))
            rec = {"path": label, "mode": "async" if mode else "inline",
                   "makespan_ms": ms, "makespan_ms_cold": spans[mode][0],
                   "makespan_ms_warm_min": min(spans[mode][1:]),
                   "makespan_ms_warm_max": max(spans[mode][1:]),
                   "host_run_ms": float(np.median(hosts[mode][1:])),
                   # host time of the copies' issue, and the dispatcher's waits
                   # for the transfer thread
                   "issue_ms": float(np.median(issue[mode][1:])),
                   "wait_ms": float(np.median(wait[mode][1:])),
                   "effective_plain_gbps": plain_b / ms / 1e6, "plain_copy_ms": plain_copy_ms,
                   "decode_units": sum(r.decode_launches for r in res.values())
                   - sum(len(g) - 1 for g in {tuple(sorted((c,) + r.batched_with))
                                              for c, r in res.items() if r.batched_with}),
                   "launches_per_run": {k: v // (2 * (WARM_RUNS + 1))
                                        for k, v in counts.items()}}
            dispatch.append(rec)
            print(f"dispatch {label} {rec['mode']} " + " ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in rec.items() if k not in ("path", "mode")))
        p_ = res = None

    # the serving mixes of the reference's benchmarks/fig20_serving.py
    pipe = ColumnPipeline(dict(TABLE2_PLANS), device="cuda", chunk_bytes="auto",
                          chunk_decode=True, policy="adaptive")
    mix = [QUERY_COLUMNS[1], QUERY_COLUMNS[6], QUERY_COLUMNS[13]] * 2
    serve = []

    def request(names) -> dict:
        """A client's own blobs: a shallow copy of each SF-1 blob (the bytes
        a fresh encode gives; distinct objects, as distinct clients ship)."""
        return {c: copy.copy(encoded[c]) for c in names}

    def finish(label: str, planner, reqs: list, wall_s: float) -> dict:
        for req in reqs:
            if not req.done or req.error is not None:
                raise AssertionError(f"serve {label} {req.rid}: done {req.done}, "
                                     f"error {req.error!r}")
            if set(req.results) != set(req.encs):
                raise AssertionError(f"serve {label} {req.rid}: columns missing")
            for c, r in req.results.items():
                check(c, r.array, f"serve {label} {req.rid}")
        reports = planner.reports
        lat = [r.latency_s * 1e3 for r in reqs]
        rec = {"mix": label, "requests": len(reqs), "waves": len(reports),
               "wall_ms": wall_s * 1e3,
               "makespan_ms": sum(r.makespan_s for r in reports) * 1e3,
               "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
               "shared_mk_ms": sum(r.shared_makespan_s for r in reports) * 1e3,
               "naive_mk_ms": sum(r.naive_makespan_s for r in reports) * 1e3,
               "decode_launches": sum(r.decode_launches for r in reports),
               "cross_batched_saved": sum(r.cross_batched_saved for r in reports),
               "largest_batch": {k: lib.largest_batch for k, lib in zip(KERNELS, libs)},
               "register_ms_per_wave": [round(r.register_s * 1e3, 4) for r in reports],
               # its parts summed over the waves: program, profile, schedule,
               # staging layout, pinned allocation, packing
               "register_split_ms": {k: round(sum(r.register_split_s.get(k, 0.0)
                                                  for r in reports) * 1e3, 4)
                                     for k in reports[0].register_split_s},
               "preempted": sum(r.preempted for r in reports),
               "chosen": [r.chosen for r in reports],
               "columns": sum(len(r.order) for r in reports),
               "kernel_launches": {k: lib.launches for k, lib in zip(KERNELS, libs)}}
        serve.append(rec)
        print(f"serve {label} " + " ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in rec.items() if k != "mix"))
        return rec

    def zero():
        for lib in libs:
            lib.launches = lib.batched_launches = lib.largest_batch = 0

    def drain_mix(label, planner, batches, klass=BULK):
        zero()
        reqs = []
        t0 = time.perf_counter()
        for b, batch in enumerate(batches):
            for i, names in enumerate(batch):
                reqs.append(planner.submit(f"b{b}x{i}", request(names), klass=klass))
            planner.drain()
        return finish(label, planner, reqs, time.perf_counter() - t0)

    drain_mix("closed_mix shared cold", pipe.serve_planner("shared"), [mix])
    warm = drain_mix("closed_mix shared warm", pipe.serve_planner("shared"), [mix])
    if min(warm["kernel_launches"].values()) <= 0:
        raise AssertionError(f"the closed mix's warm wave did not run every kernel: {warm}")
    drain_mix("closed_mix naive", pipe.serve_planner("fifo-per-query", max_wave=1), [mix])
    batches = [mix[:2], mix[2:4], mix[4:]]
    drain_mix("open_loop", pipe.serve_planner("shared"), batches)
    planner = pipe.serve_planner("shared").start()
    drain_thread = planner._drain_thread
    zero()
    reqs = []
    try:
        t0 = time.perf_counter()
        for b, batch in enumerate(batches):
            for i, names in enumerate(batch):
                reqs.append(planner.submit(f"d{b}x{i}", request(names)))
        for req in reqs:
            if not req.wait(timeout=300.0):
                raise AssertionError(f"serve open_loop_drain {req.rid}: no completion "
                                     "within 300 s")
        wall = time.perf_counter() - t0
    finally:
        planner.stop()
    left = [t.name for t in threading.enumerate()
            if t.name.startswith(("zipflow-serve-drain", "zipflow-xfer"))]
    if drain_thread is None or drain_thread.is_alive() or left:
        raise AssertionError(f"threads outlived stop(): {left}")
    finish("open_loop_drain", planner, reqs, wall)
    # one bulk scan and three point requests at once under the SLO policy
    planner = pipe.serve_planner("slo")
    zero()
    t0 = time.perf_counter()
    reqs = [planner.submit("bulk0", request(QUERY_COLUMNS[1]), klass=BULK)]
    reqs += [planner.submit(f"pt{i}", request(["O_ORDERKEY"]), klass=POINT) for i in range(3)]
    planner.drain()
    finish("slo_mix", planner, reqs, time.perf_counter() - t0)
    # deterministic preemption: the points arrive at the bulk wave's first
    # preempt call and cut in there, as a nested wave
    planner = pipe.serve_planner("slo")
    zero()
    preempt = planner._preempt
    points = []

    def arrive():
        if not points:
            points.extend(planner.submit(f"late{i}", request(["O_ORDERKEY"]), klass=POINT)
                          for i in range(3))
        preempt()

    planner._preempt = arrive
    t0 = time.perf_counter()
    reqs = [planner.submit("bulk", request(QUERY_COLUMNS[1]), klass=BULK)]
    planner.drain()
    finish("slo_preempt", planner, reqs + points, time.perf_counter() - t0)
    bulk = next(r for r in planner.reports if r.rids == ("bulk",))
    if bulk.preempted != 3 or not all(p.preempted_in for p in points):
        raise AssertionError(f"serve slo_preempt: preempted {bulk.preempted}, points "
                             f"{[p.preempted_in for p in points]}")
    return {"dispatch": dispatch, "serve": serve, "pipe": pipe,
            "warm_wave_launches": warm["kernel_launches"],
            "largest_batch": {k: max(r["largest_batch"][k] for r in serve) for k in KERNELS}}


def drive_engine(eng, libs, submit, src: dict, max_new: int, what: str) -> dict:
    """Serve the requests ``submit()`` queues on ``eng`` to completion, with
    every kernel's launch count zeroed just before and read just after: each
    decode step timed by CUDA events and on the host, each prefill (a loop of
    decode steps) by events, the launches of each prompt wave counted.  Fails
    unless every compressed prompt decodes to ``src``, every request emits
    ``max_new`` tokens without error, every logit is finite and kernels 1 and
    3 have launched.  Returns the served tokens, wall seconds, launches and
    the timings."""
    timing = {"prefill": [], "decode_ms": [], "host_ms": [], "in_prefill": False}
    wave = dict.fromkeys((lib.name for lib in libs), 0)
    finite = []
    decode, prefill, drain = eng._decode, eng._prefill, eng._drain_prompts

    def timed_decode(t):
        if timing["in_prefill"]:
            out = decode(t)
        else:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            h0 = time.perf_counter()
            out = decode(t)
            timing["host_ms"].append((time.perf_counter() - h0) * 1e3)
            b.record()
            b.synchronize()
            timing["decode_ms"].append(a.elapsed_time(b))
        finite.append(torch.isfinite(out).all())
        return out

    def timed_prefill(t):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        timing["in_prefill"] = True
        a.record()
        try:
            out = prefill(t)
        finally:
            timing["in_prefill"] = False
        b.record()
        b.synchronize()
        timing["prefill"].append((t.shape[0], a.elapsed_time(b)))
        return out

    def counted_drain():
        before = {lib.name: lib.launches for lib in libs}
        drain()
        for lib in libs:
            wave[lib.name] += lib.launches - before[lib.name]

    eng._decode, eng._prefill, eng._drain_prompts = timed_decode, timed_prefill, counted_drain
    for lib in libs:
        lib.launches = 0
    t0 = time.perf_counter()
    submit()
    done = eng.run_to_completion(max_steps=1000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {lib.name: lib.launches for lib in libs}
    for name in (libs[0].name, libs[2].name):
        if launches[name] == 0:
            raise AssertionError(f"{what}: the engine run launched no {name} kernel")
    for req in eng._requests:
        if req.error is not None:
            raise AssertionError(f"{what}: request {req.rid} failed: {req.error!r}")
        if req.rid in src and not np.array_equal(req.prompt, src[req.rid]):
            raise AssertionError(f"{what}: request {req.rid}'s decoded prompt differs")
    lens = {rid: len(out) for rid, out in done.items()}
    if lens != dict.fromkeys(range(len(eng._requests)), max_new):
        raise AssertionError(f"{what}: tokens per request {lens}")
    if not all(bool(f) for f in finite) or not all(
            bool(torch.isfinite(r._last_logits).all()) for r in eng._requests):
        raise AssertionError(f"{what}: non-finite logits")
    return {"done": done, "wall": wall, "launches": launches, "wave": wave, "timing": timing}


def run_lm_serving(cfg, seed: int, timer, libs, hbm_gbps: float,
                   device: str = "cuda") -> dict:
    """Phase 11: the language-model serving path (see the module docstring);
    returns its record, with per kernel the launches of the engine run."""
    import copy

    from repro_torch.core.compiler import compile_blob, device_buffers
    from repro_torch.core.plan import encode, make_plan
    from repro_torch.models import get_model
    from repro_torch.models.transformer import init_cache
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.kvcache import page_in, page_out

    fp = libs[0]
    dev = torch.device(device)
    t_phase = time.perf_counter()
    rec: dict = {"arch": cfg.name, "slots": LM_SLOTS, "max_len": LM_MAX_LEN,
                 "max_new": LM_MAX_NEW}

    # weights: f32 draws on the card from the seed; the serving copy is their
    # bf16 cast (what the reference computes from f32 weights in a bf16 config)
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    m32 = get_model(cfg32).init(torch.Generator(dev).manual_seed(seed), dev)
    torch.cuda.synchronize()
    rec["init_s"] = time.perf_counter() - t0
    rec["params"] = sum(p.numel() for p in m32.parameters())
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (LM_SLOTS, LM_PREFILL + 1))).to(dev)

    def prefill_then_step(m, t):
        with torch.inference_mode():
            cache = init_cache(m.cfg, LM_SLOTS, 2 * LM_PREFILL, device=t.device)
            _, cache = m.prefill(t[:, :LM_PREFILL], cache)
            return m.decode_step(t[:, LM_PREFILL:], cache)[0].float().cpu()

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card32 = prefill_then_step(m32, toks)
        t0 = time.perf_counter()
        host = copy.deepcopy(m32).cpu()
        host32 = prefill_then_step(host, toks.cpu())
        rec["cpu_parity_s"] = time.perf_counter() - t0
        del host
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    big = float(host32.abs().max())
    rec["parity_max_abs_err"] = float((card32 - host32).abs().max())
    rec["parity_max_abs_logit"] = big
    print(f"lm parity f32 card_vs_cpu prefill {LM_PREFILL} + 1 step: max_abs_err "
          f"{rec['parity_max_abs_err']:.6g} max_abs_logit {big:.6g} (rtol {LM_TOL}, atol "
          f"{LM_TOL} x max_abs_logit) top1_equal "
          f"{bool((card32.argmax(-1) == host32.argmax(-1)).all())}")
    if not torch.allclose(card32, host32, rtol=LM_TOL, atol=LM_TOL * big):
        raise AssertionError("lm: float32 logits on the card differ from the CPU's")

    m16 = m32.with_dtype(torch.bfloat16)
    card16 = prefill_then_step(m16, toks)
    with torch.inference_mode():
        top32 = torch.cat([m32.logits(m32(toks)).argmax(-1).cpu(), card32.argmax(-1)], 1)
        top16 = torch.cat([m16.logits(m16(toks)).argmax(-1).cpu(), card16.argmax(-1)], 1)
    del m32
    torch.cuda.empty_cache()
    rec["bf16_max_abs_diff"] = float((card16 - card32).abs().max())
    rec["bf16_top1_agree"] = int((top16 == top32).sum())
    rec["bf16_top1_of"] = top16.numel()
    rec["weights_bytes"] = sum(p.numel() * p.element_size() for p in m16.parameters())
    print(f"lm bf16_vs_f32 decode-step max_abs_diff {rec['bf16_max_abs_diff']:.6g} "
          f"top1_agree {rec['bf16_top1_agree']}/{rec['bf16_top1_of']} (forward over "
          f"{LM_PREFILL + 1} tokens + the step; recorded, not gated)")

    # the engine run: bf16, compressed prompts through the planner's wave
    eng = ServeEngine(cfg, m16, batch_slots=LM_SLOTS, max_len=LM_MAX_LEN, eos=-1,
                      device=dev)
    src = {rid: rng.integers(0, cfg.vocab, n).astype(np.int32) for rid, _, n in LM_PROMPTS}
    plain = rng.integers(0, cfg.vocab, LM_PLAIN).astype(np.int32)
    encs = {rid: encode(make_plan(codec), src[rid]) for rid, codec, _ in LM_PROMPTS}

    def submit():
        for rid, _, _ in LM_PROMPTS:
            eng.submit_compressed(rid, encs[rid], max_new=LM_MAX_NEW)
        eng.submit(Request(len(LM_PROMPTS), plain, max_new=LM_MAX_NEW))

    run = drive_engine(eng, libs, submit, src, LM_MAX_NEW, "lm")
    done, wall, launches, wave, timing = (run[k] for k in ("done", "wall", "launches", "wave",
                                                           "timing"))
    lens = {rid: len(out) for rid, out in done.items()}
    stats = eng.decode_cache_stats
    if (stats["programs"], stats["hits"]) != (3, 1):
        raise AssertionError(f"lm: prompt cache {stats}, expected 3 programs and 1 hit")
    report = eng.planner.reports[-1]
    tokens = sum(lens.values())
    n_pre = sum(n for n, _ in timing["prefill"])
    rec.update({
        "requests": len(done), "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
        "prompt_cache": stats, "waves": len(eng.planner.reports),
        "prefill_tokens": n_pre,
        "prefill_ms_per_token": sum(ms for _, ms in timing["prefill"]) / n_pre,
        "decode_steps": len(timing["decode_ms"]),
        "decode_step_ms": float(np.median(timing["decode_ms"])),
        "decode_step_ms_min": min(timing["decode_ms"]),
        "decode_host_ms": float(np.median(timing["host_ms"])),
        "decode_bound_ms": rec["weights_bytes"] / (hbm_gbps * 1e9) * 1e3,
        "wave_register_s": report.register_s, "wave_makespan_s": report.makespan_s,
        "wave_launches": wave, "launches": launches, "cache_len": eng.state["len"]})
    print(f"lm engine {cfg.name} bf16 slots {LM_SLOTS} max_len {LM_MAX_LEN} requests "
          f"{len(done)} tokens {tokens} wall_s {wall:.4f} tokens_per_s "
          f"{rec['tokens_per_s']:.2f} prompt_cache {stats} waves {rec['waves']} "
          f"cache_len {rec['cache_len']} launches {launches}")
    print(f"lm prefill tokens {n_pre} ms_per_prompt_token {rec['prefill_ms_per_token']:.4f}")
    print(f"lm decode steps {rec['decode_steps']} median_ms {rec['decode_step_ms']:.4f} "
          f"min_ms {rec['decode_step_ms_min']:.4f} host_ms_per_step "
          f"{rec['decode_host_ms']:.4f} weights_bound_ms {rec['decode_bound_ms']:.4f} "
          f"({rec['weights_bytes'] / 1e9:.3f} GB of weights at {hbm_gbps} GB/s)")
    print(f"lm prompt_wave register_s {report.register_s:.6f} makespan_s "
          f"{report.makespan_s:.6f} decode_launches {report.decode_launches} "
          f"launches {wave}")

    # the host's work in a decode step: its top-level aten ops (each a dispatch,
    # most a launch) under a CPU-only profiler session
    from collections import Counter
    from torch.profiler import ProfilerActivity, profile

    cache = init_cache(cfg, LM_SLOTS, LM_MAX_LEN, device=dev)
    tok = torch.zeros((LM_SLOTS, 1), dtype=torch.int64, device=dev)
    with torch.inference_mode():
        for _ in range(2):
            _, cache = m16.decode_step(tok, cache)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(LM_PROFILED_STEPS):
                _, cache = m16.decode_step(tok, cache)
            torch.cuda.synchronize()
    top = [e for e in prof.events() if e.name.startswith("aten::") and
           (e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::"))]
    rec["host_ops_per_step"] = len(top) / LM_PROFILED_STEPS
    rec["host_ops_ms_per_step"] = sum(e.cpu_time_total for e in top) / 1e3 / LM_PROFILED_STEPS
    rec["host_ops_top"] = {k: v / LM_PROFILED_STEPS
                           for k, v in Counter(e.name for e in top).most_common(8)}
    print(f"lm host_ops per_step {rec['host_ops_per_step']:.1f} per_layer "
          f"{rec['host_ops_per_step'] / cfg.n_layers:.2f} ms_per_step (profiled) "
          f"{rec['host_ops_ms_per_step']:.4f} top {rec['host_ops_top']}")
    del cache

    # KV paging: a (2, 256, 16, 64) bf16 block out in the bitpack wire format
    # and back in through kernel 1, bitwise against the plain page_in
    block = torch.randn(LM_PAGE_SHAPE, generator=torch.Generator(dev).manual_seed(seed),
                        device=dev).to(torch.bfloat16)
    pb = page_out(block)
    n0 = fp.launches
    got = page_in(pb, device=dev)
    rec["page_in_launches"] = fp.launches - n0
    ref_in = page_in(pb, device=dev, backend="torch")
    same(got.view(torch.int16), ref_in.view(torch.int16), "lm page_in")
    if rec["page_in_launches"] < 1:
        raise AssertionError("lm: page_in launched no kernel-1 kernel")
    enc = pb.encoded()
    bufs = device_buffers(enc, dev)
    kprog, pprog = compile_blob(enc, backend="kernel"), compile_blob(enc, backend="torch")
    unpack_bytes = pb.packed.nbytes + block.numel()
    rec.update({
        "page_wire_bytes": pb.packed.nbytes, "page_bf16_bytes": block.numel() * 2,
        "page_in_ms": timer.ms(lambda: page_in(pb, device=dev)),
        "page_in_plain_ms": timer.ms(lambda: page_in(pb, device=dev, backend="torch")),
        "unpack_ms": timer.ms(lambda: kprog(bufs)),
        "unpack_plain_ms": timer.ms(lambda: pprog(bufs)),
        "unpack_bound_ms": unpack_bytes / (hbm_gbps * 1e9) * 1e3,
        "page_max_abs_err": float((got.float() - block.float()).abs().max())})
    print(f"lm kvpage shape {LM_PAGE_SHAPE} wire_bytes {rec['page_wire_bytes']} bf16_bytes "
          f"{rec['page_bf16_bytes']} page_in_ms {rec['page_in_ms']:.4f} plain_ms "
          f"{rec['page_in_plain_ms']:.4f} unpack_ms {rec['unpack_ms']:.4f} unpack_plain_ms "
          f"{rec['unpack_plain_ms']:.4f} unpack_bound_ms {rec['unpack_bound_ms']:.4f} "
          f"launches {rec['page_in_launches']} bitwise True max_abs_err "
          f"{rec['page_max_abs_err']:.4g}")
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"lm phase_s {rec['phase_s']:.2f} init_s {rec['init_s']:.2f} cpu_parity_s "
          f"{rec['cpu_parity_s']:.2f}")
    return rec


def family_batch(cfg, rng, n: int) -> dict:
    """A prefill batch of ``n`` tokens for ``cfg``'s family, as the reference's
    ``prefill`` takes it: for qwen2-vl a prefix of ``FAMILY_PATCHES`` random
    patch embeddings in a square grid at t = 0 (h and w its rows and
    columns) before the text, at the grid's side and on; for seamless
    ``FAMILY_FRAMES`` random source frames."""
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (LM_SLOTS, n)))}
    if cfg.family == "vlm":
        side = int(FAMILY_PATCHES ** 0.5)
        grid = np.stack([np.zeros(FAMILY_PATCHES), np.arange(FAMILY_PATCHES) // side,
                         np.arange(FAMILY_PATCHES) % side])
        text = np.broadcast_to(np.arange(side, side + n), (3, n))
        batch["pos3"] = torch.from_numpy(np.broadcast_to(
            np.concatenate([grid, text], 1), (LM_SLOTS, 3, FAMILY_PATCHES + n)).astype(np.int32))
        batch["patch_embeds"] = torch.from_numpy(rng.normal(
            size=(LM_SLOTS, FAMILY_PATCHES, cfg.d_model)).astype(np.float32))
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(LM_SLOTS, FAMILY_FRAMES, cfg.d_model)).astype(np.float32))
    return batch


def decode_weights_bytes(model, cfg, experts_touched: float | None) -> int:
    """The bytes of the weights a decode step reads: all of them but the
    encoder's (enc-dec) and an unused Zamba2 tail layer; of an MoE layer's
    experts only ``experts_touched`` (this run's mean of distinct experts a
    layer's router picked in a step)."""
    total = 0
    for name, p in model.named_parameters():
        if name.startswith(("enc.", "enc_final.")):
            continue
        if (name.startswith("mamba_tail.") and cfg.family == "hybrid"
                and cfg.n_layers % cfg.attn_every == 0):
            continue
        if ".experts_" in name:
            total += p.numel() // cfg.n_experts * p.element_size() * experts_touched
            continue
        total += p.numel() * p.element_size()
    return int(total)


def run_lm_families(families: dict, seed: int, libs, hbm_gbps: float,
                    device: str = "cuda") -> dict:
    """Phase 12: the other LM families (see the module docstring), each
    family's models freed before the next is drawn; returns per family its
    record, with per kernel the launches of its engine run."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.plan import encode, make_plan
    from repro_torch.models import get_model
    from repro_torch.models import layers as L
    from repro_torch.serve.engine import Request, ServeEngine

    dev = torch.device(device)
    t_phase = time.perf_counter()
    out = {}
    for arch, (cfg, cut32) in families.items():
        t_family = time.perf_counter()
        rec: dict = {"arch": arch, "layers": cfg.n_layers}
        rng = np.random.default_rng(seed)

        # parity: one decode step after a 16-token prefill, f32 on the card
        # (TF32 off) against the same weights on the CPU, at a cut depth
        api = get_model(cut32)
        m32 = api.init(torch.Generator(dev).manual_seed(seed), dev)
        batch = family_batch(cut32, rng, LM_PREFILL)
        step = torch.from_numpy(rng.integers(0, cut32.vocab, (LM_SLOTS, 1)))

        def prefill_then_step(m, d):
            with torch.inference_mode():
                st = api.make_state(LM_SLOTS, 4 * LM_PREFILL, device=d)
                _, st = api.prefill(m, {k: v.to(d) for k, v in batch.items()}, st)
                logits = api.decode_step(m, step.to(d), st)[0]
                return logits[..., :cut32.vocab].float().cpu()   # not the masked padding

        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            card32 = prefill_then_step(m32, dev)
            t0 = time.perf_counter()
            host32 = prefill_then_step(m32.cpu(), torch.device("cpu"))
            rec["cpu_parity_s"] = time.perf_counter() - t0
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        del m32
        big = float(host32.abs().max())
        rec.update({"parity_layers": cut32.n_layers, "parity_max_abs_err":
                    float((card32 - host32).abs().max()), "parity_max_abs_logit": big})
        if not torch.allclose(card32, host32, rtol=LM_TOL, atol=LM_TOL * big):
            raise AssertionError(f"lm family {arch}: float32 logits on the card differ from "
                                 f"the CPU's by {rec['parity_max_abs_err']:.6g}")

        # the serving run: bf16 at the published width
        t0 = time.perf_counter()
        model = get_model(cfg).init(torch.Generator(dev).manual_seed(seed), dev)
        torch.cuda.synchronize()
        rec["init_s"] = time.perf_counter() - t0
        rec["params"] = sum(p.numel() for p in model.parameters())
        eng = ServeEngine(cfg, model, batch_slots=LM_SLOTS, max_len=LM_MAX_LEN, eos=-1,
                          device=dev)
        src = {rid: rng.integers(0, cfg.vocab, n).astype(np.int32)
               for rid, _, n in FAMILY_PROMPTS}
        plain = rng.integers(0, cfg.vocab, FAMILY_PLAIN).astype(np.int32)

        def submit():
            for rid, codec, _ in FAMILY_PROMPTS:
                eng.submit_compressed(rid, encode(make_plan(codec), src[rid]),
                                      max_new=FAMILY_MAX_NEW)
            eng.submit(Request(len(FAMILY_PROMPTS), plain, max_new=FAMILY_MAX_NEW))

        routed = []                      # each MoE router call's expert ids
        route = L.moe_route

        def recorded(p, xg, c):
            probs, gate_v, gate_i = route(p, xg, c)
            routed.append(gate_i)
            return probs, gate_v, gate_i

        L.moe_route = recorded
        try:
            run = drive_engine(eng, libs, submit, src, FAMILY_MAX_NEW, f"lm family {arch}")
        finally:
            L.moe_route = route
        timing = run["timing"]
        touched = (float(np.mean([len(torch.unique(g)) for g in routed]))
                   if cfg.family == "moe" else None)
        weights = decode_weights_bytes(model, cfg, touched)
        tokens = sum(len(v) for v in run["done"].values())
        n_pre = sum(n for n, _ in timing["prefill"])
        rec.update({
            "tokens": tokens, "wall_s": run["wall"], "tokens_per_s": tokens / run["wall"],
            "prefill_tokens": n_pre,
            "prefill_ms_per_token": sum(ms for _, ms in timing["prefill"]) / n_pre,
            "decode_steps": len(timing["decode_ms"]),
            "decode_step_ms": float(np.median(timing["decode_ms"])),
            "decode_host_ms": float(np.median(timing["host_ms"])),
            "experts_touched": touched, "step_weights_bytes": weights,
            "decode_bound_ms": weights / (hbm_gbps * 1e9) * 1e3,
            "launches": run["launches"], "wave_launches": run["wave"]})
        del eng, model
        torch.cuda.empty_cache()
        rec["family_s"] = time.perf_counter() - t_family
        full = ARCHS[arch].n_layers
        print(f"lm family {arch} layers {cfg.n_layers}/{full} params {rec['params']} init_s "
              f"{rec['init_s']:.2f} parity_f32 layers {cut32.n_layers} max_abs_err "
              f"{rec['parity_max_abs_err']:.6g} max_abs_logit {big:.6g} cpu_parity_s "
              f"{rec['cpu_parity_s']:.2f} decode_step_ms {rec['decode_step_ms']:.4f} "
              f"host_ms_per_step {rec['decode_host_ms']:.4f} weights_bound_ms "
              f"{rec['decode_bound_ms']:.4f} ({weights / 1e9:.3f} GB"
              + (f", {touched:.2f} of {cfg.n_experts} experts a layer" if touched else "")
              + f") prefill_ms_per_prompt_token {rec['prefill_ms_per_token']:.4f} "
              f"tokens_per_s {rec['tokens_per_s']:.2f} tokens {tokens} launches "
              f"{run['launches']} wave_launches {run['wave']} family_s {rec['family_s']:.2f}")
        out[arch] = rec
    phase_s = time.perf_counter() - t_phase
    print(f"lm families phase_s {phase_s:.2f}")
    return out


def train_batch(cfg, rng, n: int) -> dict:
    """``family_batch`` of ``n`` tokens with their labels (random next tokens)."""
    batch = family_batch(cfg, rng, n)
    batch["labels"] = torch.from_numpy(rng.integers(0, cfg.vocab, (LM_SLOTS, n)))
    return batch


def _grads(api, model, batch, policy) -> list:
    loss = api.train_loss(model, batch, policy)
    plist = list(model.parameters())
    grads = torch.autograd.grad(loss, plist, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(plist, grads)]


def _leaf_errs(names, got, want, base=None) -> dict:
    """Per parameter: max |got - want| over the largest |want - base| (over
    the largest |want| without ``base``); on the CPU."""
    out = {}
    for n, a, w, b in zip(names, got, want, base or [None] * len(names)):
        a, w = a.detach().cpu().float(), w.detach().cpu().float()
        ref = w if b is None else w - b
        out[n] = float((a - w).abs().max()) / max(float(ref.abs().max()), 1e-30)
    return out


def _worst(errs: dict) -> tuple:
    name = max(errs, key=errs.get)
    return name, errs[name]


def run_lm_train(cfg, smoke, families: dict, seed: int, timer, libs, hbm_gbps: float,
                 device: str = "cuda") -> dict:
    """Phase 13: the LM training path (see the module docstring): ``cfg`` at
    full width, ``families`` (f32, cut in depth) one step each, the
    checkpoint and loop at ``smoke``'s size; returns its record, with per
    kernel the launches of the full-width training run."""
    import copy
    import os
    import tempfile
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.loader import CompressedTokenLoader
    from repro_torch.models import get_model
    from repro_torch.roofline.analysis import PEAK_FLOPS as BF16_FLOPS
    from repro_torch.train import checkpoint as ck
    from repro_torch.train import optimizer
    from repro_torch.train.loop import (LoopConfig, SimulatedFailure, load_state, run,
                                        state_like, state_tree)
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.remat import get_policy
    from repro_torch.train.train_step import make_train_step, make_value_and_grad

    fp = libs[0]
    dev = torch.device(device)
    t_phase = time.perf_counter()
    B, S = TRAIN_BATCH, TRAIN_SEQ
    rec: dict = {"arch": cfg.name, "batch": B, "seq": S, "steps": TRAIN_STEPS,
                 "remat": TRAIN_REMAT}

    # full width: f32 master weights drawn on the card, bf16 compute
    base = torch.cuda.memory_allocated(dev)       # what earlier phases still hold
    t0 = time.perf_counter()
    api = get_model(cfg)
    model = api.init(torch.Generator(dev).manual_seed(seed), dev, train=True)
    torch.cuda.synchronize()
    rec["init_s"] = time.perf_counter() - t0
    plist = list(model.parameters())
    n_params = sum(p.numel() for p in plist)
    n_matmul = sum(p.numel() for n, p in model.named_parameters()
                   if p.ndim >= 2 and n != "embed.embedding")
    rec.update({"params": n_params, "matmul_params": n_matmul})

    # the tokens: one fixed batch, packed on the host, unpacked on kernel 1
    src = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S + 1), dtype=np.int32)
    loader = CompressedTokenLoader(cfg.vocab, B, S, source=lambda step: src, device=dev)
    bufs = loader.to_device(loader.encode_host(0))
    decode, decode_plain = loader.decode_fn("kernel"), loader.decode_fn("torch")
    got, plain = decode(bufs), decode_plain(bufs)
    for k in ("tokens", "labels"):
        same(got[k], plain[k], f"lm train loader {k}")
    want = torch.from_numpy(src).to(dev)
    if not (torch.equal(got["tokens"], want[:, :-1]) and torch.equal(got["labels"], want[:, 1:])):
        raise AssertionError("lm train: the unpacked tokens differ from the host's")
    packed = bufs["root.packed"].numel() * 4
    rec.update({
        "bits": loader.bits, "packed_bytes": packed, "int32_bytes": src.nbytes,
        "unpack_ms": timer.ms(lambda: decode(bufs)),
        "unpack_plain_ms": timer.ms(lambda: decode_plain(bufs)),
        "unpack_bound_ms": (packed + src.nbytes) / (hbm_gbps * 1e9) * 1e3})

    # the main path: TRAIN_STEPS steps on the fixed batch, the unpack each
    # step's first launch, with every kernel's count zeroed just before
    step = make_train_step(cfg, AdamWConfig(total_steps=TRAIN_STEPS), remat=TRAIN_REMAT)
    opt = optimizer.init(model)
    losses, gnorms, step_ms, host_ms = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for lib in libs:
        lib.launches = 0
    t_run = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        h0 = time.perf_counter()
        model, opt, m = step(model, opt, decode(bufs))
        host_ms.append((time.perf_counter() - h0) * 1e3)
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
        losses.append(m["loss"].item())
        gnorms.append(m["grad_norm"].item())
    wall = time.perf_counter() - t_run
    launches = {lib.name: lib.launches for lib in libs}
    rec["peak_gb"] = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    if launches[fp.name] != TRAIN_STEPS:
        raise AssertionError(f"lm train: {launches[fp.name]} kernel-1 launches in "
                             f"{TRAIN_STEPS} steps")
    if not all(np.isfinite(losses + gnorms)):
        raise AssertionError(f"lm train: non-finite loss or grad norm {losses} {gnorms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"lm train: the loss did not fall: {losses}")
    tokens = B * S
    warm = step_ms[1:]
    flops = 6 * n_matmul * tokens + 3 * 2 * B * S * S * cfg.d_model * cfg.n_layers
    # bytes: the forward reads each f32 weight once, the backward writes each
    # gradient once, AdamW reads weights, gradients, mu, nu and writes weights,
    # mu, nu (f32 each)
    step_bytes = 4 * n_params * (1 + 1 + 4 + 3)
    rec.update({
        "losses": losses, "grad_norms": gnorms, "launches": launches, "wall_s": wall,
        "step_ms": float(np.median(warm)), "step_ms_min": min(warm), "step_ms_first": step_ms[0],
        "host_ms": float(np.median(host_ms[1:])), "tokens_per_s": tokens / np.median(warm) * 1e3,
        "flops": flops, "flop_bound_ms": flops / BF16_FLOPS * 1e3,
        "step_bytes": step_bytes, "bytes_bound_ms": step_bytes / (hbm_gbps * 1e9) * 1e3})
    rec["bound_ms"] = max(rec["flop_bound_ms"], rec["bytes_bound_ms"])
    print(f"lm train {cfg.name} params {n_params} (matmul {n_matmul}) bf16 compute f32 master "
          f"batch {B} seq {S} remat {TRAIN_REMAT} steps {TRAIN_STEPS} init_s "
          f"{rec['init_s']:.2f} losses {[round(x, 4) for x in losses]}")
    print(f"lm train step_ms {rec['step_ms']:.4f} (median of steps 2-{TRAIN_STEPS}; min "
          f"{rec['step_ms_min']:.4f} first {rec['step_ms_first']:.4f}) host_ms_per_step "
          f"{rec['host_ms']:.4f} tokens_per_s {rec['tokens_per_s']:.1f} peak_gb "
          f"{rec['peak_gb']:.3f} flop_bound_ms {rec['flop_bound_ms']:.4f} ({flops / 1e12:.3f} "
          f"TFLOP at {BF16_FLOPS / 1e12:.0f} TFLOP/s) bytes_bound_ms "
          f"{rec['bytes_bound_ms']:.4f} ({step_bytes / 1e9:.2f} GB at {hbm_gbps} GB/s) "
          f"launches {launches}")
    print(f"lm train loader bits {loader.bits} packed_bytes {packed} int32_bytes {src.nbytes} "
          f"ratio {src.nbytes / packed:.3f} unpack_ms {rec['unpack_ms']:.4f} unpack_plain_ms "
          f"{rec['unpack_plain_ms']:.4f} unpack_bound_ms {rec['unpack_bound_ms']:.5f} "
          f"launches_per_step {launches[fp.name] / TRAIN_STEPS:g} bitwise True")

    # the step under each remat policy (a few warm steps each, same batch)
    rec["remat_step_ms"], rec["remat_host_ms"] = {}, {}
    for r in TRAIN_REMATS:
        st = make_train_step(cfg, AdamWConfig(total_steps=TRAIN_STEPS), remat=r)
        ev, hs = [], []
        for _ in range(TRAIN_REMAT_STEPS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            h0 = time.perf_counter()
            model, opt, _ = st(model, opt, decode(bufs))
            hs.append((time.perf_counter() - h0) * 1e3)
            b.record()
            b.synchronize()
            ev.append(a.elapsed_time(b))
        rec["remat_step_ms"][str(r)] = float(np.median(ev[1:]))
        rec["remat_host_ms"][str(r)] = float(np.median(hs[1:]))
    # the host's work in a step: its top-level aten ops under a CPU-only
    # profiler session (the remat policy's recompute included)
    st = make_train_step(cfg, AdamWConfig(total_steps=TRAIN_STEPS), remat=TRAIN_REMAT)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model, opt, _ = st(model, opt, decode(bufs))
        torch.cuda.synchronize()
    top = [e for e in prof.events() if e.name.startswith("aten::") and
           (e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::"))]
    rec["host_ops_per_step"] = len(top)
    rec["host_ops_top"] = dict(Counter(e.name for e in top).most_common(6))
    print("lm train remat step_ms " + " ".join(
        f"{r} {rec['remat_step_ms'][r]:.4f} (host {rec['remat_host_ms'][r]:.4f})"
        for r in rec["remat_step_ms"]) + f" (median of steps 2-{TRAIN_REMAT_STEPS} each); "
        f"host_ops_per_step ({TRAIN_REMAT}) {len(top)} top {rec['host_ops_top']}")

    # microbatch 2 against 1 in f32 (TF32 off) on the same weights (an
    # f32-compute view of the master weights): the loss and every gradient
    # of the port's accumulation, then one step through microbatch 2
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        view32 = type(model).trainable(cfg32, model.tree())
        names = [n for n, _ in view32.named_parameters()]
        batch = decode(bufs)
        whole, g1 = make_value_and_grad(cfg32, TRAIN_REMAT)(view32, batch)
        halves, g2 = make_value_and_grad(cfg32, TRAIN_REMAT, 2)(view32, batch)
        mb_errs = _leaf_errs(names, g2, g1)
        del g1, g2
        mb = make_train_step(cfg32, AdamWConfig(total_steps=TRAIN_STEPS), remat=TRAIN_REMAT,
                             microbatch=2)(view32, optimizer.init(view32), batch)[2]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    whole, halves = whole.item(), halves.item()
    worst, mb_grad = _worst(mb_errs)
    rec.update({"microbatch2_loss": mb["loss"].item(), "microbatch1_loss": whole,
                "microbatch2_grad_err": mb_grad})
    print(f"lm train microbatch 2 loss {halves:.8f} (its step {rec['microbatch2_loss']:.8f}) "
          f"microbatch 1 loss {whole:.8f} rel_diff {abs(halves - whole) / abs(whole):.3g} "
          f"(f32, rtol {TRAIN_MB_TOL}); gradients of {len(names)} parameters: worst "
          f"{mb_grad:.3g} of the largest |gradient| ({worst}; tol {TRAIN_GRAD_TOL})")
    if not (abs(halves - whole) <= TRAIN_MB_TOL * abs(whole)
            and abs(rec["microbatch2_loss"] - whole) <= TRAIN_MB_TOL * abs(whole)):
        raise AssertionError("lm train: the microbatch-2 loss differs from the whole batch's")
    if not mb_grad <= TRAIN_GRAD_TOL:
        raise AssertionError(f"lm train: the microbatch-2 gradient of {worst} differs from "
                             f"the whole batch's by {mb_grad:.3g} of its largest")
    # the checkpoint's host encode and decode at full width: the embedding
    # (the largest leaf), as a save and a restore would treat it
    from repro_torch.train.checkpoint import _decode_leaf, _encode_leaf
    emb = model.embed["embedding"].detach()
    t0 = time.perf_counter()
    arr = emb.cpu().numpy()
    d2h_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    enc = _encode_leaf(arr)
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = _decode_leaf(enc, arr.shape, str(arr.dtype))
    decode_s = time.perf_counter() - t0
    if not np.array_equal(back.numpy().view(np.uint32), arr.view(np.uint32)):
        raise AssertionError("lm train: the embedding's checkpoint encoding does not round-trip")
    stored = sum(np.asarray(v).nbytes for v in enc.values() if not isinstance(v, str))
    mb = arr.nbytes / 1e6
    rec.update({"leaf_mb": mb, "leaf_d2h_s": d2h_s, "leaf_encode_s": encode_s,
                "leaf_decode_s": decode_s, "leaf_ratio": arr.nbytes / stored,
                "leaf_encode_ms_per_mb": encode_s * 1e3 / mb,
                "leaf_decode_ms_per_mb": decode_s * 1e3 / mb})
    full_mb = 3 * 4 * n_params / 1e6
    print(f"lm train ckpt_leaf embed.embedding {arr.shape} {mb:.1f} MB d2h_s {d2h_s:.3f} "
          f"encode_s {encode_s:.3f} ({rec['leaf_encode_ms_per_mb']:.1f} ms/MB) decode_s "
          f"{decode_s:.3f} ({rec['leaf_decode_ms_per_mb']:.1f} ms/MB) ratio "
          f"{rec['leaf_ratio']:.4f} round-trip bitwise; a full-width save of params, mu, nu "
          f"({full_mb:.0f} MB) at this rate ~{rec['leaf_encode_ms_per_mb'] * full_mb / 1e3:.0f} s "
          f"of encoding")
    del model, opt, view32, batch, step, emb, arr, enc, back
    torch.cuda.empty_cache()

    # f32 parity, card against CPU, at a cut depth (TF32 off): every remat
    # policy's gradients on the card; every gradient against the CPU's from
    # the same weights; AdamW alone on both sides from the same gradients
    # (the CPU's, of two batches); then two train steps on each side
    layers, ps = TRAIN_PARITY
    cut = dataclasses.replace(cfg, n_layers=layers, dtype=torch.float32)
    capi = get_model(cut)
    card = capi.init(torch.Generator(dev).manual_seed(seed), dev, train=True)
    host = copy.deepcopy(card).cpu()
    names = [n for n, _ in card.named_parameters()]
    before = [p.detach().cpu().clone() for p in host.parameters()]
    pbatch, pbatch2 = (train_batch(cut, np.random.default_rng(seed + i), ps) for i in (0, 1))
    opt_cfg = AdamWConfig(**TRAIN_PARITY_OPT)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        cb = {k: v.to(dev) for k, v in pbatch.items()}
        g0 = _grads(capi, card, cb, None)
        remat_err = {}
        for r in TRAIN_REMATS[1:]:
            g = _grads(capi, card, cb, get_policy(r))
            remat_err[r] = max(float((a - w).abs().max()) for a, w in zip(g, g0))
            bitwise = all(torch.equal(a, w) for a, w in zip(g, g0))
            print(f"lm train remat {r} vs none: max_abs_grad_diff {remat_err[r]:.6g} bitwise "
                  f"{bitwise}")
            if not all(torch.allclose(a, w, rtol=0, atol=TRAIN_TOL * float(w.abs().max()))
                       for a, w in zip(g, g0)):
                raise AssertionError(f"lm train: remat {r} changes the gradients")
        del g
        hg = _grads(capi, host, pbatch, None)
        grad_errs = _leaf_errs(names, g0, hg)
        gnorm = {"card": float(optimizer.global_norm(g0)), "cpu": float(optimizer.global_norm(hg))}
        gnorm64 = {side: math.sqrt(sum(float(torch.sum(t.detach().double() ** 2)) for t in gs))
                   for side, gs in (("card", g0), ("cpu", hg))}
        del g0
        hg2 = _grads(capi, host, pbatch2, None)
        adam = {}
        for side, m in (("card", copy.deepcopy(card)), ("cpu", copy.deepcopy(host))):
            d = next(m.parameters()).device
            o = optimizer.init(m)
            for gs in (hg, hg2)[:TRAIN_PARITY_STEPS]:
                m, o, _ = optimizer.update(opt_cfg, m, o, [t.to(d) for t in gs])
            adam[side] = [p.detach().cpu() for p in m.parameters()]
            del m, o
        adam_errs = _leaf_errs(names, adam["card"], adam["cpu"], before)
        del hg, hg2, adam
        sides = {}
        for name, m, d in (("card", card, dev), ("cpu", host, torch.device("cpu"))):
            st = make_train_step(cut, opt_cfg, remat=None)
            o = optimizer.init(m)
            hist = []
            for _ in range(TRAIN_PARITY_STEPS):
                m, o, met = st(m, o, {k: v.to(d) for k, v in pbatch.items()})
                hist.append((met["loss"].item(), met["grad_norm"].item()))
            sides[name] = (hist, [p.detach().cpu() for p in m.parameters()])
        rec["parity_s"] = time.perf_counter() - t0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (ch, cp), (hh, hp) = sides["card"], sides["cpu"]
    lerr = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(ch, hh))
    gerr = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(ch, hh))
    l2 = lambda ts: math.sqrt(sum(float(torch.sum(t.double() ** 2)) for t in ts))
    step_rel = l2(a - b for a, b in zip(cp, hp)) / l2(b - p for b, p in zip(hp, before))
    step_leaf = {n: float(torch.linalg.vector_norm(a - b)) /
                 max(float(torch.linalg.vector_norm(b - p)), 1e-30)
                 for n, a, b, p in zip(names, cp, hp, before)}
    perr = max(float((a - b).abs().max()) for a, b in zip(cp, hp))
    moved = max(float((b - p).abs().max()) for b, p in zip(hp, before))
    (gworst, grad_err), (aworst, adam_err) = _worst(grad_errs), _worst(adam_errs)
    sworst, sleaf = _worst(step_leaf)
    rec.update({"parity_layers": layers, "parity_loss_rel": lerr, "parity_gnorm_rel": gerr,
                "parity_grad_err": grad_err, "parity_gnorm": gnorm, "parity_gnorm_f64": gnorm64,
                "parity_adam_err": adam_err, "parity_step_rel": step_rel,
                "parity_step_leaf_worst": sleaf, "parity_param_err": perr,
                "parity_param_moved": moved, "remat_grad_err": remat_err})
    print(f"lm train parity f32 card_vs_cpu layers {layers} batch {LM_SLOTS} seq {ps}: "
          f"gradients of {len(names)} parameters: worst {grad_err:.3g} of the largest "
          f"|gradient| ({gworst}; tol {TRAIN_GRAD_TOL}); grad_norm f32 card {gnorm['card']:.9g} "
          f"cpu {gnorm['cpu']:.9g}, f64 card {gnorm64['card']:.9g} cpu {gnorm64['cpu']:.9g}")
    print(f"lm train parity adamw lr {opt_cfg.lr} warmup {opt_cfg.warmup_steps} weight_decay "
          f"{opt_cfg.weight_decay}, {TRAIN_PARITY_STEPS} updates from the CPU's gradients: "
          f"worst {adam_err:.3g} of the parameter's largest change ({aworst}; tol "
          f"{TRAIN_ADAM_TOL})")
    print(f"lm train parity {TRAIN_PARITY_STEPS} train steps: loss_rel {lerr:.3g} "
          f"grad_norm_rel {gerr:.3g} (tol {TRAIN_TOL}) params: |difference| / |change| "
          f"{step_rel:.3g} (tol {TRAIN_STEP_TOL}; worst parameter {sleaf:.3g}, {sworst}) "
          f"max_abs_err {perr:.3g} against a largest change of {moved:.3g} losses card "
          f"{[round(h[0], 6) for h in ch]} cpu {[round(h[0], 6) for h in hh]} parity_s "
          f"{rec['parity_s']:.2f}")
    if grad_err > TRAIN_GRAD_TOL:
        raise AssertionError(f"lm train: the card's gradient of {gworst} differs from the "
                             f"CPU's by {grad_err:.3g} of its largest")
    if adam_err > TRAIN_ADAM_TOL:
        raise AssertionError(f"lm train: AdamW on the card moves {aworst} otherwise than on "
                             f"the CPU ({adam_err:.3g} of its change)")
    if lerr > TRAIN_TOL or gerr > TRAIN_TOL or step_rel > TRAIN_STEP_TOL:
        raise AssertionError("lm train: f32 training on the card differs from the CPU's")
    del card, host, sides, cp, hp, before
    torch.cuda.empty_cache()

    # every other family: one train step at its published width, cut in
    # depth as phase 12's parity check
    rec["families"] = {}
    for arch, cut32 in families.items():
        t0 = time.perf_counter()
        fapi = get_model(cut32)
        m = fapi.init(torch.Generator(dev).manual_seed(seed), dev, train=True)
        host = copy.deepcopy(m).cpu()
        fb = train_batch(cut32, np.random.default_rng(seed), LM_PREFILL)
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with torch.no_grad():
                want = fapi.train_loss(host, fb).item()
            del host
            _, _, met = make_train_step(cut32, AdamWConfig(), remat=TRAIN_REMAT)(
                m, optimizer.init(m), {k: v.to(dev) for k, v in fb.items()})
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        loss, gn = met["loss"].item(), met["grad_norm"].item()
        err = abs(loss - want) / abs(want)
        fr = {"layers": cut32.n_layers, "loss": loss, "cpu_loss": want, "loss_rel": err,
              "grad_norm": gn, "s": time.perf_counter() - t0,
              "params": sum(p.numel() for p in m.parameters())}
        rec["families"][arch] = fr
        print(f"lm train family {arch} layers {cut32.n_layers} params {fr['params']} f32 loss "
              f"{loss:.6f} cpu_loss {want:.6f} rel {err:.3g} grad_norm {gn:.6g} finite "
              f"{bool(np.isfinite([loss, gn]).all())} family_s {fr['s']:.2f}")
        if not (np.isfinite([loss, gn]).all() and err <= TRAIN_TOL):
            raise AssertionError(f"lm train family {arch}: loss {loss} (cpu {want}), grad norm "
                                 f"{gn}")
        del m, met
        torch.cuda.empty_cache()

    # the checkpoint, the loop and a restart at the SMOKE size, on the card
    sl = CompressedTokenLoader(smoke.vocab, 2, 32, device=dev)
    sdecode = sl.decode_fn()

    def setup():
        m = get_model(smoke).init(torch.Generator(dev).manual_seed(seed), dev, train=True)
        return m, optimizer.init(m), make_train_step(
            smoke, AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=50), remat=TRAIN_REMAT)

    def batch_fn(i):
        return sdecode(sl.to_device(sl.encode_host(i)))

    def bitwise(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(a, b))

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            m, o, st = setup()
            m, o, _ = st(m, o, batch_fn(0))
            t0 = time.perf_counter()
            ck.save(os.path.join(tmp, "one"), 1, state_tree(m, o))
            save_s = time.perf_counter() - t0
            m2, o2, _ = setup()
            t0 = time.perf_counter()
            tree, _, _ = ck.restore(os.path.join(tmp, "one"), state_like(m2))
            restore_s = time.perf_counter() - t0
            o2 = load_state(m2, tree)
            if not (bitwise(m.parameters(), m2.parameters()) and bitwise(o["mu"], o2["mu"])
                    and bitwise(o["nu"], o2["nu"]) and o["step"] == o2["step"]):
                raise AssertionError("lm train: a restored checkpoint differs from the state")
            report = ck.compression_report(os.path.join(tmp, "one"))
            steps, every, fail = TRAIN_LOOP
            quiet = lambda s: None
            m, o, st = setup()
            p_ref, o_ref, _ = run(LoopConfig(steps, os.path.join(tmp, "a"), every), st, m, o,
                                  batch_fn, log=quiet)
            m, o, st = setup()
            try:
                run(LoopConfig(steps, os.path.join(tmp, "b"), every, fail_at_step=fail), st, m,
                    o, batch_fn, log=quiet)
                raise AssertionError("lm train: the loop did not fail at its step")
            except SimulatedFailure:
                pass
            m, o, st = setup()
            p_fin, o_fin, hist = run(LoopConfig(steps, os.path.join(tmp, "b"), every), st, m, o,
                                     batch_fn, log=quiet)
            resumed = hist[0]["step"]
            if resumed != every or not (bitwise(p_ref.parameters(), p_fin.parameters())
                                        and bitwise(o_ref["mu"], o_fin["mu"])
                                        and bitwise(o_ref["nu"], o_fin["nu"])):
                raise AssertionError("lm train: the resumed loop differs from the "
                                     "uninterrupted one")
            env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
            t0 = time.perf_counter()
            cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--smoke",
                                  "--steps", "4", "--ckpt-dir", os.path.join(tmp, "cli")],
                                 cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
            cli_s = time.perf_counter() - t0
            if cli.returncode != 0 or "[train] done" not in cli.stdout:
                raise AssertionError(f"lm train: launch.train failed ({cli.returncode}): "
                                     f"{cli.stdout[-2000:]} {cli.stderr[-2000:]}")
    finally:
        torch.use_deterministic_algorithms(False)
    raw_mb = report["raw_bytes"] / 1e6
    rec.update({"ckpt_ratio": report["ratio"], "ckpt_raw_bytes": report["raw_bytes"],
                "ckpt_stored_bytes": report["stored_bytes"], "ckpt_save_s": save_s,
                "ckpt_restore_s": restore_s, "ckpt_save_ms_per_mb": save_s * 1e3 / raw_mb,
                "ckpt_restore_ms_per_mb": restore_s * 1e3 / raw_mb, "cli_s": cli_s})
    print(f"lm train ckpt {smoke.name} raw_bytes {report['raw_bytes']} stored_bytes "
          f"{report['stored_bytes']} ratio {report['ratio']:.4f} save_s {save_s:.3f} "
          f"restore_s {restore_s:.3f} save_ms_per_mb {rec['ckpt_save_ms_per_mb']:.1f} "
          f"restore_ms_per_mb {rec['ckpt_restore_ms_per_mb']:.1f} (45 small leaves: a fixed "
          f"cost a leaf) restore bitwise True")
    print(f"lm train loop {smoke.name} steps {steps} ckpt_every {every} fail_at {fail} "
          f"resumed_at {resumed} bitwise True; launch.train --smoke --steps 4 rc 0 cli_s "
          f"{cli_s:.2f} ({cli.stdout.strip().splitlines()[-1]})")
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"lm train phase_s {rec['phase_s']:.2f}")
    return rec


def _count_diff(a: dict, b: dict) -> dict:
    """The ops whose count, FLOPs or bytes differ between two ``by_op``."""
    return {k: (a.get(k), b.get(k)) for k in sorted(set(a) | set(b)) if a.get(k) != b.get(k)}


def run_lm_roofline(cfg, seed: int, device: str = "cuda") -> dict:
    """Phase 14: the roofline of three full-width steps of ``cfg`` (see the
    module docstring), each counted by ``op_cost.analyze`` on the card and on
    ``meta`` (equal FLOPs and bytes or the run fails), timed by CUDA events
    and put beside ``model_flops`` and the H100's datasheet rates; then
    ``launch.dryrun.run_cell`` on meta for ``ROOF_CELLS``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models import get_model
    from repro_torch.roofline import analysis, op_cost
    from repro_torch.train import optimizer
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_step

    t_phase = time.perf_counter()
    dev = torch.device(device)
    api = get_model(cfg)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(dev).manual_seed(seed)
    B, S = TRAIN_BATCH, TRAIN_SEQ
    shapes = {"decode": ShapeConfig("decode", LM_MAX_LEN, LM_SLOTS, "decode"),
              "prefill": ShapeConfig("prefill", LM_MAX_LEN, LM_SLOTS, "prefill"),
              "train": ShapeConfig("train", S, B, "train")}

    def tokens(shape, d):
        if d.type == "meta":
            return torch.zeros(shape, dtype=torch.int32, device=d)
        return torch.from_numpy(rng.integers(0, cfg.vocab, shape, dtype=np.int32)).to(d)

    def steps(d) -> dict:
        """name -> a call of that step on device ``d``, its state made once."""
        g = gen if d.type != "meta" else None
        serve, train = api.init(g, d), api.init(g, d, train=True)
        cache = api.make_state(LM_SLOTS, LM_MAX_LEN, device=d)
        cache["len"] = ROOF_DECODE_LEN
        tok = tokens((LM_SLOTS, 1), d)
        pcache = api.make_state(LM_SLOTS, LM_MAX_LEN, device=d)
        prompt = {"tokens": tokens((LM_SLOTS, LM_MAX_LEN), d)}
        step = make_train_step(cfg, AdamWConfig(total_steps=TRAIN_STEPS), remat=TRAIN_REMAT)
        opt = optimizer.init(train)
        seq = tokens((B, S + 1), d)
        batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
        return {"decode": lambda: api.decode_step(serve, tok, cache),
                "prefill": lambda: api.prefill(serve, prompt, pcache),
                "train": lambda: step(train, opt, batch)[2]}

    rec: dict = {"arch": cfg.name, "steps": {}, "dryrun": []}
    card, meta = steps(dev), steps(torch.device("meta"))
    for name, fn in card.items():
        got = op_cost.analyze(fn)
        want = op_cost.analyze(meta[name])
        if (got["flops"], got["bytes"]) != (want["flops"], want["bytes"]):
            raise AssertionError(f"lm roofline {name}: card counts {got['flops']} FLOPs "
                                 f"{got['bytes']} bytes, meta {want['flops']} FLOPs "
                                 f"{want['bytes']} bytes; ops that differ "
                                 f"{_count_diff(got['by_op'], want['by_op'])}")
        fn()
        torch.cuda.synchronize()
        ms = []
        for _ in range(ROOF_REPS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = fn()
        torch.cuda.synchronize()
        rise = torch.cuda.max_memory_allocated(dev) - base
        del out
        t = float(np.median(ms)) / 1e3
        mflops = analysis.model_flops(cfg, shapes[name], shapes[name].kind)
        roof = analysis.Roofline(
            arch=cfg.name, shape=name, mesh="card_1x1", chips=1,
            hlo_flops_per_chip=got["flops"], hlo_bytes_per_chip=got["bytes"],
            coll_bytes_per_chip=got["coll_bytes"], coll_breakdown=got["collectives"],
            model_flops_total=mflops, per_device_bytes=0)
        r = {"model_flops": mflops, "counted_flops": got["flops"],
             "counted_bytes": got["bytes"], "n_ops": got["n_ops"], "meta_equal": True,
             "ms": t * 1e3, "ms_all": ms, "mfu": mflops / (t * analysis.PEAK_FLOPS),
             "hbm_share": got["bytes"] / (t * analysis.HBM_BW),
             "roofline_step_ms": roof.step_time * 1e3, "bottleneck": roof.bottleneck,
             "t_compute_ms": roof.t_compute * 1e3, "t_memory_ms": roof.t_memory * 1e3,
             "peak_bytes_meta": want["peak_bytes"], "peak_bytes_card": got["peak_bytes"],
             "max_memory_rise": rise, "count_s_card": got["seconds"],
             "count_s_meta": want["seconds"]}
        rec["steps"][name] = r
        print(f"lm roofline {cfg.name} {name} model_flops {mflops:.6e} counted_flops "
              f"{got['flops']:.6e} counted_bytes {got['bytes']:.6e} n_ops {got['n_ops']} "
              f"meta_equal True ms {r['ms']:.4f} mfu {r['mfu']:.5f} hbm_share "
              f"{r['hbm_share']:.5f} roofline_step_ms {r['roofline_step_ms']:.4f} "
              f"bottleneck {roof.bottleneck} (t_compute_ms {r['t_compute_ms']:.4f} "
              f"t_memory_ms {r['t_memory_ms']:.4f}) peak_bytes_meta {want['peak_bytes']} "
              f"max_memory_rise {rise} count_s card {got['seconds']:.2f} meta "
              f"{want['seconds']:.2f}")
    card = meta = None
    torch.cuda.empty_cache()
    for arch, shape, mesh in ROOF_CELLS:
        c = run_cell(arch, shape, mesh)
        c.pop("by_op", None)
        if c["status"] != "ok":
            raise AssertionError(f"lm roofline dryrun {arch} {shape} {mesh}: {c['status']}")
        rec["dryrun"].append(c)
        ro, mem = c["roofline"], c["memory"]
        print(f"dryrun {arch} {shape} {c['mesh']} split {c['split']} bottleneck "
              f"{ro['bottleneck']} t_compute_ms {ro['t_compute'] * 1e3:.4f} t_memory_ms "
              f"{ro['t_memory'] * 1e3:.4f} t_collective {ro['t_collective']} "
              f"roofline_frac {ro['roofline_frac']:.5f} per_device_gb "
              f"{mem['per_device_live'] / 1e9:.3f} argument_gb {mem['argument'] / 1e9:.3f} "
              f"fits_80g_hbm {mem['fits_80g_hbm']} n_ops {c['n_ops']['n_ops']} lower_s "
              f"{c['lower_s']}")
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"lm roofline phase_s {rec['phase_s']:.2f}")
    return rec


def run_mesh_plans(plans: dict, encoded: dict, cost_model) -> dict:
    """Phase 15 (a): ``ColumnPipeline(mesh=N).mesh_plan()`` over the columns'
    blobs with ``cost_model`` (phase 4's, calibrated) at ``MESH_PLAN_N``, and
    N = 4 with ``placement="sharded"`` on a topology with a fabric priced at
    NVLink's rate over the host link's; each modeled makespan <= its
    round-robin and single-device baselines, N = 1 equal to
    ``plan_execution``'s plan simulated at its window (and >= its unbounded
    makespan).  Modeled, not measured."""
    from repro_torch.core import scheduler
    from repro_torch.core.costmodel import LinkTopology
    from repro_torch.core.planner import _chunk_info, plan_execution
    from repro_torch.data.loader import ColumnPipeline

    pipe = ColumnPipeline(plans, device="cuda", cost_model=cost_model, mesh=max(MESH_PLAN_N))
    pipe.load(encoded)
    profiles = {c: pipe.executor.column_profile(c) for c in encoded}
    d2d = cost_model.spec.host_link_gbps / MESH_FABRIC_GBPS
    cases = [(f"n{n}", {"n_devices": n}) for n in MESH_PLAN_N]
    cases.append(("n4_sharded_fabric", {
        "n_devices": 4, "placement": "sharded", "shard_threshold_bytes": 0,
        "topology": LinkTopology(n_links=4, d2d_scale=d2d)}))
    rec = {}
    for label, kw in cases:
        t0 = time.perf_counter()
        mp = pipe.mesh_plan(**kw)
        host_ms = (time.perf_counter() - t0) * 1e3
        mk, base = mp.modeled_makespan_s, mp.baselines
        for ref_ in ("round-robin", "single-device"):
            if mk > base[ref_] + 1e-15:
                raise AssertionError(f"mesh plan {label}: makespan {mk} above {ref_} "
                                     f"{base[ref_]}")
        r = {"n_devices": mp.n_devices, "policy": mp.policy, "modeled_makespan_ms": mk * 1e3,
             "baselines_ms": {k: v * 1e3 for k, v in sorted(base.items())},
             "sharded_columns": sorted(mp.shards), "n_shards": sum(map(len, mp.shards.values())),
             "redistribution": [list(x) for x in mp.redistribution],
             "items": len(mp.items), "planning_host_ms": host_ms}
        if mp.n_devices == 1:
            # the single-device plan the mesh planner starts from (its
            # chunk_decode default is True, plan_execution's False).  Its
            # modeled makespan is the UNBOUNDED pipeline's; its window is
            # picked after, and is 8 when no window up to 8 is stall-free.
            # The mesh plan simulates at that window, so it equals the plan
            # simulated at its own window, and is >= the unbounded makespan.
            one = plan_execution(profiles, cost_model, policy=pipe.executor.policy,
                                 chunk_bytes=pipe.executor.chunk_bytes, chunk_decode=True,
                                 batch_columns=False)
            names = list(one.order)
            at_window = scheduler.simulate_stream(
                [scheduler.Job(n, one.decisions[n].est_transfer_s,
                               one.decisions[n].est_decode_s) for n in names],
                [_chunk_info(one.decisions[n], cost_model.launch_overhead_s(n))
                 for n in names], window=one.window)
            if (abs(at_window - mk) > MESH_REL * mk
                    or one.modeled_makespan_s > mk * (1 + MESH_REL)):
                raise AssertionError(f"mesh plan n1: {mk} against plan_execution's "
                                     f"{at_window} at its window {one.window} (unbounded "
                                     f"{one.modeled_makespan_s})")
            r["plan_execution_ms"] = at_window * 1e3
            r["plan_execution_unbounded_ms"] = one.modeled_makespan_s * 1e3
            r["plan_execution_window"] = one.window
        rec[label] = r
        print(f"mesh plan {label} (modeled, not measured) devices {mp.n_devices} policy "
              f"{mp.policy} makespan_ms {mk * 1e3:.4f} round_robin_ms "
              f"{base['round-robin'] * 1e3:.4f} single_device_ms "
              f"{base['single-device'] * 1e3:.4f} serial_issue_ms "
              f"{base['serial-issue'] * 1e3:.4f} items {len(mp.items)} sharded "
              f"{r['sharded_columns']} shards {r['n_shards']} redistribution "
              f"{len(mp.redistribution)} legs {r['redistribution']} planning_host_ms "
              f"{host_ms:.2f}" + (f" plan_execution_ms {r['plan_execution_ms']:.4f} "
                                  f"(window {r['plan_execution_window']}; unbounded "
                                  f"{r['plan_execution_unbounded_ms']:.4f})"
                                  if "plan_execution_ms" in r else ""))
    return rec


@contextlib.contextmanager
def _group_store(tag: str):
    """A fresh rendezvous file for a process group (no network needed), in
    a directory that lives as long as the ``with`` block (the group's
    lifetime) and is removed after it."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{tag}_") as d:
        yield os.path.join(d, "store")


def run_placed_train(cfg, seed: int, device: str = "cuda") -> dict:
    """Phase 15 (b): ``cfg``'s f32 training weights placed as DTensors on a
    1 x 1 ("data", "model") ``DeviceMesh`` over an NCCL group of one, under
    the mesh context; ``MESH_STEPS`` train steps (phase 13's batch, sequence
    and remat) against the same steps unplaced: the losses and every
    parameter bitwise equal (a 1 x 1 mesh splits nothing)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import device_mesh, make_card_mesh, place
    from repro_torch.models import get_model
    from repro_torch.models.sharding_ctx import mesh_context
    from repro_torch.train import optimizer
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_step

    dev = torch.device(device)
    with _group_store("nccl") as store:
        dist.init_process_group("nccl", init_method="file://" + store, rank=0, world_size=1)
        try:
            dm = device_mesh(make_card_mesh(), device)
            api = get_model(cfg)
            plain = api.init(torch.Generator(dev).manual_seed(seed), dev, train=True)
            placed = place(api.init(torch.Generator(dev).manual_seed(seed), dev, train=True),
                           api.param_specs(), dm)
            if not all(isinstance(p, DTensor) for p in placed.parameters()):
                raise AssertionError("mesh placed: a parameter is not a DTensor")
            step = make_train_step(cfg, AdamWConfig(total_steps=TRAIN_STEPS), remat=TRAIN_REMAT)
            o1, o2 = optimizer.init(plain), optimizer.init(placed)
            rng = np.random.default_rng(seed)
            rec: dict = {"plain_ms": [], "placed_ms": [], "plain_host_ms": [],
                         "placed_host_ms": [], "losses": []}
            for i in range(MESH_STEPS):
                seq = torch.from_numpy(rng.integers(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1),
                                                    dtype=np.int32)).to(dev)
                batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
                out = {}
                for label, model, opt, ctx in (("plain", plain, o1, None),
                                               ("placed", placed, o2, dm)):
                    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    torch.cuda.synchronize()
                    a.record()
                    h0 = time.perf_counter()
                    if ctx is None:
                        m = step(model, opt, batch)[2]
                    else:
                        with mesh_context(ctx):
                            m = step(model, opt, batch)[2]
                    rec[f"{label}_host_ms"].append((time.perf_counter() - h0) * 1e3)
                    b.record()
                    b.synchronize()
                    rec[f"{label}_ms"].append(a.elapsed_time(b))
                    loss = m["loss"]
                    out[label] = (loss.full_tensor() if isinstance(loss, DTensor) else loss).item()
                if out["plain"] != out["placed"]:
                    raise AssertionError(f"mesh placed step {i}: loss {out['placed']} against "
                                         f"{out['plain']} unplaced")
                rec["losses"].append(out["plain"])
            for (n, a), b in zip(placed.named_parameters(), plain.parameters()):
                if not torch.equal(a.to_local(), b):
                    raise AssertionError(f"mesh placed: {n} differs from the unplaced step's")
            rec["bitwise"] = True
            print(f"mesh placed {cfg.name} 1x1 nccl steps {MESH_STEPS} bitwise True losses "
                  f"{' '.join(f'{x:.6f}' for x in rec['losses'])} step_ms placed "
                  f"{' '.join(f'{x:.2f}' for x in rec['placed_ms'])} plain "
                  f"{' '.join(f'{x:.2f}' for x in rec['plain_ms'])} host_ms placed "
                  f"{' '.join(f'{x:.2f}' for x in rec['placed_host_ms'])} plain "
                  f"{' '.join(f'{x:.2f}' for x in rec['plain_host_ms'])}")
            return rec
        finally:
            dist.destroy_process_group()


def _dp_rank(rank: int, store: str, out_dir: str, arch: str, seed: int, smoke: bool) -> None:
    """One member of phase 15 (c): ``make_dp_compressed_step`` over a ("pod",)
    mesh of ``DP_RANKS`` processes on ``cuda:0`` in a gloo group; writes its
    record to ``out_dir``.  Rank 0 also holds the synced gradients and each
    member's new error buffer against the int8 sum in plain torch."""
    import traceback

    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    try:
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
        dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                                world_size=DP_RANKS)
        _dp_member(rank, dev, out_dir, arch, seed, smoke, DeviceMesh, dist)
    except BaseException:
        with open(os.path.join(out_dir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _dp_member(rank, dev, out_dir, arch, seed, smoke, DeviceMesh, dist) -> None:

    from repro_torch.configs import ARCHS, SMOKES
    from repro_torch.data.loader import CompressedTokenLoader
    from repro_torch.kernels import cuda
    from repro_torch.kernels.fully_parallel import KERNEL as FP
    from repro_torch.models import get_model
    from repro_torch.roofline import op_cost
    from repro_torch.train import grad_compress as GC
    from repro_torch.train import make_dp_compressed_step, optimizer, train_step
    from repro_torch.train.optimizer import AdamWConfig

    cuda.build([FP])               # the parent built it: this loads the library
    FP.load(dev)
    cfg = (SMOKES if smoke else ARCHS)[arch]
    api = get_model(cfg)
    model = api.init(torch.Generator(dev).manual_seed(seed), dev, train=True)
    dm = DeviceMesh("cuda", torch.arange(DP_RANKS), mesh_dim_names=("pod",))
    group = dm.get_group("pod")
    step = make_dp_compressed_step(cfg, AdamWConfig(total_steps=TRAIN_STEPS), dm)
    opt, err = optimizer.init(model), GC.init_error_feedback(model)
    B, S = TRAIN_BATCH, (32 if smoke else TRAIN_SEQ)
    loader = CompressedTokenLoader(cfg.vocab, B, S, device=dev)
    decode = loader.decode_fn("kernel")
    seen: dict = {}
    compress, update = GC.compress_tree, optimizer.update

    def compress_spy(grads, errs, group_, leaves):
        seen["pre"] = ([g.detach().clone() for g in grads], [e.clone() for e in errs])
        seen["leaves"] = leaves
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = compress(grads, errs, group_, leaves)
        b.record()
        b.synchronize()
        seen["sync_ms"] = a.elapsed_time(b)
        seen["new_err"] = out[1]
        return out

    def update_spy(cfg_, params, opt_state, grads):
        seen["synced"] = [g.clone() for g in grads]
        return update(cfg_, params, opt_state, grads)

    train_step.grad_compress.compress_tree = compress_spy
    train_step.optimizer.update = update_spy
    rec = {"rank": rank, "step_ms": [], "sync_ms": [], "f32_allreduce_ms": [], "losses": [],
           "params_equal": [], "synced_equal": [], "err_equal": [], "launches": 0}
    try:
        FP.launches = 0
        for i in range(MESH_STEPS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            dist.barrier(group)
            a.record()
            batch = decode(loader.to_device(loader.encode_host(i)))   # kernel 1
            model, opt, err, m = step(model, opt, err, batch)
            b.record()
            b.synchronize()
            rec["step_ms"].append(a.elapsed_time(b))
            rec["sync_ms"].append(seen["sync_ms"])
            rec["losses"].append(float(m["loss"]))
            # the ranks' parameters, bitwise (rank 1's sent to rank 0)
            mine = torch.cat([p.detach().reshape(-1) for p in model.parameters()]).cpu()
            other = mine.clone()
            dist.broadcast(other, src=1, group=group)
            rec["params_equal"].append(bool(torch.equal(mine, other)))
            # the plain int8 sum from both members' pre-sync gradients and errors
            syn_ok, err_ok = _plain_int8_check(seen, rank, dist, group)
            rec["synced_equal"].append(syn_ok)
            rec["err_equal"].append(err_ok)
            # an f32 all-reduce of the same gradients over the same group
            pre = [g.clone() for g in seen["pre"][0]]
            a2, b2 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            dist.barrier(group)
            a2.record()
            for g in pre:
                dist.all_reduce(g, group=group)
            b2.record()
            b2.synchronize()
            rec["f32_allreduce_ms"].append(a2.elapsed_time(b2))
            del pre
        rec["launches"] = FP.launches
        grads, errs = seen["pre"]
        counted = op_cost.analyze(compress, grads, errs, group, seen["leaves"])
        rec["sync_allreduce_wire_bytes"] = counted["collectives"].get("all-reduce", 0.0)
        rec["wire_bytes_int8"] = GC.wire_bytes(grads, compressed=True)
        rec["wire_bytes_f32"] = GC.wire_bytes(grads, compressed=False)
        rec["params"] = sum(p.numel() for p in model.parameters())
        rec["max_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    finally:
        train_step.grad_compress.compress_tree = compress
        train_step.optimizer.update = update
    with open(os.path.join(out_dir, f"dp_{rank}.json"), "w") as f:
        json.dump(rec, f)


def _plain_int8_check(seen: dict, rank: int, dist, group) -> tuple[bool, bool]:
    """The step's synced gradients (what AdamW got) and each member's new
    error buffer against the int8 sum in plain torch, leaf by leaf: rank 1
    sends its pre-sync gradients + errors and its new errors to rank 0."""
    grads, errs = seen["pre"]
    syn_ok = err_ok = True
    for idx in seen["leaves"]:
        g = torch.stack([grads[i] for i in idx]).float() + torch.stack([errs[i] for i in idx])
        e_new = torch.stack([seen["new_err"][i] for i in idx])
        # rank 1's through host memory (the gloo group), the arithmetic on the
        # card, as the step's own
        g1, e1 = g.cpu(), e_new.cpu()
        dist.broadcast(g1, src=1, group=group)
        dist.broadcast(e1, src=1, group=group)
        if rank != 0:
            continue
        g1, e1 = g1.to(g.device), e1.to(g.device)
        scale = torch.maximum(g.abs().amax(), g1.abs().amax()) / 127.0 + 1e-12
        q0 = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        q1 = torch.clamp(torch.round(g1 / scale), -127, 127).to(torch.int8)
        want = (q0.to(torch.int32) + q1.to(torch.int32)).float() * scale / DP_RANKS
        got = torch.stack([seen["synced"][i] for i in idx])
        syn_ok &= bool(torch.equal(got, want))
        for gg, q, e in ((g, q0, e_new), (g1, q1, e1)):
            err_ok &= bool(torch.equal(e, (gg.double() - q.double() * scale.double()).float()))
    return syn_ok, err_ok


def run_dp_compressed(arch: str, seed: int, smoke: bool = False) -> dict:
    """Phase 15 (c): ``DP_RANKS`` processes on the one card (NCCL refuses two
    ranks on one GPU, so a gloo group, which takes CUDA tensors) run
    ``MESH_STEPS`` compressed data-parallel steps; gates: the ranks'
    parameters bitwise equal after every step, the synced gradients and
    every member's new error buffer bitwise the plain int8 sum's, the loss
    finite."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as out_dir:
        store = os.path.join(out_dir, "store")      # removed with the directory
        ctx = mp.start_processes(_dp_rank, args=(store, out_dir, arch, seed, smoke),
                                 nprocs=DP_RANKS, start_method="spawn", join=False)
        try:
            while not ctx.join(timeout=600):
                pass
        except Exception:
            errors = "".join(Path(out_dir, f).read_text() for f in sorted(os.listdir(out_dir))
                             if f.startswith("error_"))
            raise AssertionError(f"mesh dp: a rank failed\n{errors}") from None
        recs = [json.loads(Path(out_dir, f"dp_{r}.json").read_text()) for r in range(DP_RANKS)]
    r0 = recs[0]
    for i in range(MESH_STEPS):
        if not all(r["params_equal"][i] for r in recs):
            raise AssertionError(f"mesh dp step {i}: the ranks' parameters differ")
        if not (r0["synced_equal"][i] and r0["err_equal"][i]):
            raise AssertionError(f"mesh dp step {i}: synced gradients {r0['synced_equal'][i]}"
                                 f", error buffers {r0['err_equal'][i]} against the plain sum")
        if not all(math.isfinite(r["losses"][i]) for r in recs):
            raise AssertionError(f"mesh dp step {i}: a loss is not finite")
    rec = {"ranks": recs, "launches_per_rank": [r["launches"] for r in recs]}
    print(f"mesh dp {arch} ranks {DP_RANKS} gloo cuda:0 steps {MESH_STEPS} params_bitwise "
          f"True synced_bitwise True err_bitwise True losses "
          f"{' '.join(f'{x:.6f}' for x in r0['losses'])} step_ms "
          f"{' '.join(f'{x:.1f}' for x in r0['step_ms'])} sync_ms "
          f"{' '.join(f'{x:.1f}' for x in r0['sync_ms'])} f32_allreduce_ms "
          f"{' '.join(f'{x:.1f}' for x in r0['f32_allreduce_ms'])} (gloo through host "
          f"memory: says nothing of NVLink) kernel1_launches_per_rank "
          f"{rec['launches_per_rank']} max_memory_gb "
          f"{' '.join(f'{r['max_memory_gb']:.2f}' for r in recs)}")
    print(f"mesh dp R6 wire_bytes_int8 {r0['wire_bytes_int8']} wire_bytes_f32 "
          f"{r0['wire_bytes_f32']} counted_sync_allreduce_wire_bytes "
          f"{r0['sync_allreduce_wire_bytes']:.0f} (int32 payload: "
          f"{r0['sync_allreduce_wire_bytes'] / max(r0['wire_bytes_int8'], 1):.3f} x the "
          f"int8 figure)")
    return rec


def run_mesh_cell(card: dict) -> dict:
    """Phase 15 (d): ``MESH_CELL`` through ``python -m repro_torch.launch.dryrun``
    in a child process (a process has one default group; the cell opens a
    fake one of 256), its per-device counts beside the ideal split of
    phase 14's card cell ``card`` (the whole step's temp / 256 plus the
    pod's argument bytes).  Gate: every dimension of qwen1.5-0.5b's train
    step splits 16 x 16, so one device counts exactly 1/256 of the card's
    FLOPs (a product left split over the wrong axis, or run on partial
    sums, shows as a multiple of that).  Modeled from counts on meta."""
    import tempfile

    arch, shape, mesh = MESH_CELL
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dry_") as out:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                              "--shape", shape, "--mesh", mesh, "--out", out], cwd=ROOT,
                             env=env, capture_output=True, text=True, timeout=900)
        if run.returncode != 0:
            raise AssertionError(f"mesh dryrun: exit {run.returncode}\n{run.stderr[-3000:]}")
        rec = json.loads(Path(out, f"{arch}_{shape}_{mesh}.json").read_text())
    child_s = time.perf_counter() - t0
    if rec.get("status") != "ok" or rec.get("split") != "counted":
        raise AssertionError(f"mesh dryrun: {rec.get('status')} split {rec.get('split')}")
    ro, mem = rec["roofline"], rec["memory"]
    if ro["t_collective"] is None or not rec.get("collectives"):
        raise AssertionError("mesh dryrun: no collective term")
    card_flops = card["roofline"]["hlo_flops_per_chip"]
    if ro["hlo_flops_per_chip"] * 256 != card_flops:
        raise AssertionError(f"mesh dryrun: {ro['hlo_flops_per_chip']:.6e} FLOPs a device, "
                             f"not the card's {card_flops:.6e} / 256")
    ideal_live = mem["argument"] + card["memory"]["temp"] / 256
    print(f"mesh dryrun {arch} {shape} {rec['mesh']} split counted (modeled from counts on "
          f"meta) flops_per_device {ro['hlo_flops_per_chip']:.6e} bytes_per_device "
          f"{ro['hlo_bytes_per_chip']:.6e} collectives "
          + " ".join(f"{k} {v:.6e}" for k, v in sorted(rec["collectives"].items()))
          + f" t_collective_ms {ro['t_collective'] * 1e3:.4f} t_compute_ms "
          f"{ro['t_compute'] * 1e3:.4f} t_memory_ms {ro['t_memory'] * 1e3:.4f} bottleneck "
          f"{ro['bottleneck']} per_device_live_gb {mem['per_device_live'] / 1e9:.3f} "
          + f"ideal_split_gb {ideal_live / 1e9:.3f} card_flops_over_256 True "
          f"fits_80g_hbm {mem['fits_80g_hbm']} count_s {rec['lower_s']} child_s "
          f"{child_s:.1f}")
    rec.pop("by_op", None)
    rec["ideal_per_device_live"] = ideal_live
    rec["child_s"] = child_s
    return rec


def _column_bits(arr) -> torch.Tensor:
    """A run's column as bits on the card (a ``ShardedColumn`` joined)."""
    return bits(arr if isinstance(arr, torch.Tensor) else arr.full())


SPAN_KERNELS = {"gp": "group_parallel", "np": "non_parallel"}


def _span_counts(ex, mp) -> dict:
    """The span launches ``mp``'s shard schedules call for, by kernel
    (kernel 2 for a Group-Parallel span, kernel 3 for a Non-Parallel one):
    all of them (``spans``), those that start inside the column
    (``g_start > 0``, ``mid``), and the spans by logical device
    (``by_device``)."""
    from repro_torch.core.ir import group_chunk_layout

    want = {"spans": dict.fromkeys(SPAN_KERNELS.values(), 0),
            "mid": dict.fromkeys(SPAN_KERNELS.values(), 0), "by_device": {}}
    for col, specs in mp.shards.items():
        k = SPAN_KERNELS[group_chunk_layout(ex.graph(col)).kind]
        for s in specs:
            li = next(i for i, p in enumerate(mp.plans) if s.name in p.decisions)
            sched = ex.shard_schedule(col, mp.plans[li].decisions[s.name].chunk_bytes,
                                      s.g_lo, s.g_hi)
            want["spans"][k] += sched.n_chunks
            want["mid"][k] += sum(g > 0 for g in sched.g_starts)
            dev = int(mp.device_ids[li])
            want["by_device"][dev] = want["by_device"].get(dev, 0) + sched.n_chunks
    return want


@contextlib.contextmanager
def _shard_span_tally(ex, libs):
    """Count, as they happen, the launches of kernels 2 and 3 made by the
    span programs of group-span shards: ``ex._decode`` marks a unit whose
    item is a shard, and each span program call inside it adds its
    difference of the kernel libraries' counters to ``spans`` (and to
    ``mid`` when its ``g_start > 0``).  Yields the tally; the caller zeroes
    it (``.clear()``) before each run."""
    from repro_torch.core.compiler import GroupChunkProgram

    kernels = dict(zip(KERNELS, libs))
    tally = {"spans": dict.fromkeys(SPAN_KERNELS.values(), 0),
             "mid": dict.fromkeys(SPAN_KERNELS.values(), 0)}
    in_shard = [False]
    decode, call = ex._decode, GroupChunkProgram.__call__

    def counted_decode(unit, flats, cols):
        in_shard[0] = "column" in cols[unit.members[0]]
        try:
            return decode(unit, flats, cols)
        finally:
            in_shard[0] = False

    def counted_call(prog, bufs, out_start, g_start, n_valid, out, base=0):
        if not in_shard[0]:
            return call(prog, bufs, out_start, g_start, n_valid, out, base)
        before = {k: kernels[k].launches for k in SPAN_KERNELS.values()}
        res = call(prog, bufs, out_start, g_start, n_valid, out, base)
        for k in SPAN_KERNELS.values():
            n = kernels[k].launches - before[k]
            tally["spans"][k] += n
            if g_start > 0:
                tally["mid"][k] += n
        return res

    def clear():
        for part in tally.values():
            for k in part:
                part[k] = 0

    ex._decode = counted_decode
    GroupChunkProgram.__call__ = counted_call
    try:
        yield tally, clear
    finally:
        GroupChunkProgram.__call__ = call
        del ex._decode


def run_mesh_runs(cols: dict, encoded: dict, span_encoded: dict, cost_model, libs) -> dict:
    """Phase 16 (a), (b) and (d): ``ColumnPipeline.run_sharded`` on the card
    (see the module docstring).  Every run is held bitwise to the pipeline's
    single-device ``run()``, itself held to the source, so the sequential and
    concurrent runs of a plan equal each other bitwise."""
    from repro_torch.core import planner as planner_mod
    from repro_torch.core.costmodel import LinkTopology
    from repro_torch.core.ir import group_chunk_layout
    from repro_torch.core.plan import make_plan
    from repro_torch.data.columns import TABLE2_PLANS
    from repro_torch.data.loader import ColumnPipeline
    from repro_torch.launch.elastic import replan_suffix

    spans_of = {f"{c}.{p}": c for c, p in SPAN_PLANS.items()}
    plans = dict(TABLE2_PLANS) | {n: make_plan(SPAN_PLANS[c]) for n, c in spans_of.items()}
    blobs = dict(encoded) | {n: span_encoded[c] for n, c in spans_of.items()}
    pipe = ColumnPipeline(plans, device="cuda", cost_model=cost_model, mesh=max(MESH_PLAN_N))
    pipe.load(blobs)
    ex = pipe.executor
    single = pipe.run()
    ref = {}
    for n in blobs:
        ref[n] = _column_bits(single[n].array)
        if not torch.equal(ref[n], bits(torch.from_numpy(cols[spans_of.get(n, n)]).cuda())):
            raise AssertionError(f"mesh run: the single-device run of {n} differs from "
                                 "its source")
    single = None
    with _shard_span_tally(ex, libs) as (tally, clear_tally):
        physical = len(ex.physical_devices())
        group_cols = [n for n in blobs if group_chunk_layout(ex.graph(n)) is not None]
        profiles = {n: ex.column_profile(n) for n in group_cols}

        def forced(**kw):
            """The group-span columns alone at N = 4 with ``shard_threshold_bytes=0``
            (the mesh planner's defaults otherwise, as ``mesh_plan``'s)."""
            return planner_mod.plan_mesh_execution(
                profiles, cost_model, n_devices=4, shard_threshold_bytes=0,
                chunk_bytes=ex.chunk_bytes, policy=ex.policy, **kw)

        def drive(label, mp, mode):
            """One ``run_sharded`` with the counts and the shard-span tally
            zeroed just before; its columns held to the single-device run, its
            counted shard spans to those its schedules call for."""
            want = _span_counts(ex, mp)
            for lib in libs:
                lib.launches = 0
            clear_tally()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = pipe.run_sharded(plan=mp, concurrent=mode)
            host_ms = (time.perf_counter() - t0) * 1e3
            counts = {k: lib.launches for k, lib in zip(KERNELS, libs)}
            counts["shard_spans"] = dict(tally["spans"])
            counts["mid_column_spans"] = dict(tally["mid"])
            for c in mp.columns():
                if not torch.equal(_column_bits(res[c].array), ref[c]):
                    raise AssertionError(f"mesh run {label} concurrent={mode}: {c} differs from "
                                         "the single-device run")
            busy = {d for d, items in res.per_device.items() if items}
            if not all(res.device_launches[d] > 0 for d in busy) or any(
                    res.device_launches[d] < n for d, n in want["by_device"].items()):
                raise AssertionError(f"mesh run {label}: device_launches {res.device_launches}, "
                                     f"devices with items {busy}, shard spans by device "
                                     f"{want['by_device']}")
            if (tally["spans"], tally["mid"]) != (want["spans"], want["mid"]):
                raise AssertionError(f"mesh run {label} concurrent={mode}: counted shard span "
                                     f"launches {tally}, the schedules call for {want}")
            for c in mp.shards:
                if len(set(res[c].shard_devices)) < 2:
                    raise AssertionError(f"mesh run {label}: {c} sharded on "
                                         f"{res[c].shard_devices}")
            return res, host_ms, counts

        # (a) N = 2 and 4 over the 26 columns, and every group-span column sharded
        cases = {"n2": pipe.mesh_plan(2), "n4": pipe.mesh_plan(4), "n4_forced_spans": forced()}
        if set(cases["n4_forced_spans"].shards) != set(group_cols):
            raise AssertionError(f"mesh run: the forced plan shards "
                                 f"{sorted(cases['n4_forced_spans'].shards)} of {group_cols}")
        runs, per_device_n4 = {}, None
        for label, mp in cases.items():
            got = {False: [], True: []}
            for rep in range(MESH_RUN_REPS):              # the first pair is cold
                for mode in ((False, True) if rep % 2 == 0 else (True, False)):
                    res, host_ms, counts = drive(label, mp, mode)
                    got[mode].append((res.makespan_s * 1e3, host_ms, counts,
                                      dict(res.device_launches)))
                    if label == "n4":
                        per_device_n4 = res.per_device
                    res = None
            if label == "n4_forced_spans" and min(
                    g[2]["mid_column_spans"][k] for m in got for g in got[m]
                    for k in SPAN_KERNELS.values()) <= 0:
                raise AssertionError(f"mesh run {label}: kernels 2 and 3 ran no mid-column "
                                     f"span: {got}")
            for mode in (False, True):
                warm = got[mode][1:]
                rec = {"logical": mp.n_devices, "physical": physical,
                       "makespan_ms": float(np.median([g[0] for g in warm])),
                       "makespan_ms_cold": got[mode][0][0],
                       "host_ms": float(np.median([g[1] for g in warm])),
                       "host_ms_cold": got[mode][0][1],
                       "modeled_makespan_ms": mp.modeled_makespan_s * 1e3, "policy": mp.policy,
                       "items": len(mp.items), "sharded": sorted(mp.shards),
                       "device_launches": warm[-1][3],
                       "kernel_launches": {k: v for k, v in warm[-1][2].items()
                                           if k in KERNELS},
                       "shard_spans": warm[-1][2]["shard_spans"],
                       "mid_column_spans": warm[-1][2]["mid_column_spans"]}
                key = f"{label} {'concurrent' if mode else 'sequential'}"
                runs[key] = rec
                print(f"mesh run {key} " + " ".join(
                    f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in rec.items())
                    + f" (every logical device shares one card and its one host link; the model"
                    f" assumes {mp.n_devices} links)")

        # (b) D2D legs: the reference's skewed-link fabric plan, shards placed
        d2d = {}
        topo = LinkTopology(n_links=4, link_scale=MESH_SKEW, d2d_scale=MESH_D2D_SCALE)
        mp = forced(topology=topo, placement="sharded")
        legs = {it: (mp.device_ids[s], mp.device_ids[d]) for it, s, d in mp.redistribution}
        if not legs:
            raise AssertionError("mesh run d2d: the skewed-link fabric plan has no D2D leg")
        spec_of = {s.name: s for ss in mp.shards.values() for s in ss}
        for mode in (False, True):
            before = cost_model.topology.d2d_scale
            res, host_ms, counts = drive("d2d", mp, mode)
            after = cost_model.topology.d2d_scale
            got = {it: (s, d) for it, (s, d, _) in res.d2d_copies.items()}
            if got != legs or any(s == d for s, d in got.values()):
                raise AssertionError(f"mesh run d2d: executed legs {got}, the plan's {legs}")
            for col, specs in mp.shards.items():
                want = tuple(int(mp.device_ids[mp.final_device(s.name)]) for s in specs)
                if res[col].shard_devices != want:
                    raise AssertionError(f"mesh run d2d: {col} on {res[col].shard_devices}, "
                                         f"placed on {want}")
            if after is None or after == before:
                raise AssertionError(f"mesh run d2d: the fabric EWMA {before} -> {after}")
            per_leg = {it: {"src": s, "dst": d,
                            "bytes": spec_of[it].n_out
                            * ref[planner_mod.shard_column_of(it)].element_size(),
                            "copy_ms": secs * 1e3}
                       for it, (s, d, secs) in res.d2d_copies.items()}
            key = "concurrent" if mode else "sequential"
            d2d[key] = {"makespan_ms": res.makespan_s * 1e3, "host_ms": host_ms,
                        "legs": per_leg, "d2d_scale": after, "kernel_launches": counts}
            res = None
            d2d[key]["transfer_scale"] = cost_model.transfer_scale
            print(f"mesh run d2d {key} logical 4 physical {physical} legs {len(per_leg)} "
                  f"makespan_ms {d2d[key]['makespan_ms']:.4f} host_ms {host_ms:.2f} "
                  f"fitted_d2d_scale {after:.6g} over the calibrated host link "
                  f"(transfer_scale {cost_model.transfer_scale:.6g}; copies within one card's "
                  f"memory, not NVLink) "
                  + " ".join(f"{it} {v['src']}->{v['dst']} bytes {v['bytes']} copy_ms "
                             f"{v['copy_ms']:.4f}" for it, v in per_leg.items()))

        # (d) the elastic suffix: logical device 0 lost after its whole columns
        done = [it for it in per_device_n4[0] if planner_mod.SHARD_SEP not in it]
        mp2 = replan_suffix(cases["n4"], done, (1, 2, 3), cost_model,
                            {n: ex.column_profile(n) for n in blobs}, shard_threshold_bytes=0)
        res, host_ms, counts = drive("suffix", mp2, None)
        if not set(res.per_device) <= {1, 2, 3} or set(mp2.columns()) & set(done):
            raise AssertionError(f"mesh run suffix: per_device {sorted(res.per_device)}, "
                                 f"re-ran {set(mp2.columns()) & set(done)}")
        suffix = {"done": len(done), "columns": len(mp2.columns()),
                  "per_device": {d: len(v) for d, v in res.per_device.items()},
                  "makespan_ms": res.makespan_s * 1e3, "host_ms": host_ms,
                  "modeled_makespan_ms": mp2.modeled_makespan_s * 1e3,
                  "device_launches": dict(res.device_launches), "kernel_launches": counts}
        print("mesh run suffix " + " ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in suffix.items())
            + f" logical 3 physical {physical}")
        return {"runs": runs, "d2d": d2d, "suffix": suffix}


def run_mesh_serving(cols: dict, encoded: dict, pipe, non_mesh: dict, libs) -> dict:
    """Phase 16 (c): phase 6's closed mix through ``pipe`` (phase 6's serving
    pipeline) with ``serve_planner("shared", mesh=2)``, a cold and a warm
    wave, each request shipping its own shallow copies of the SF-1 blobs;
    beside ``non_mesh``, phase 6's warm non-mesh wave of the same mix."""
    import copy

    from repro_torch.data.tpch import QUERY_COLUMNS

    mix = [QUERY_COLUMNS[1], QUERY_COLUMNS[6], QUERY_COLUMNS[13]] * 2
    truth = {c: bits(torch.from_numpy(cols[c]).cuda()) for names in mix for c in names}
    out = {}
    for label in ("cold", "warm"):
        planner = pipe.serve_planner("shared", mesh=2)
        for lib in libs:
            lib.launches = 0
        t0 = time.perf_counter()
        reqs = [planner.submit(f"m{i}", {c: copy.copy(encoded[c]) for c in names})
                for i, names in enumerate(mix)]
        planner.drain()
        wall = time.perf_counter() - t0
        for req in reqs:
            if not req.done or req.error is not None or set(req.results) != set(req.encs):
                raise AssertionError(f"mesh serve {label} {req.rid}: done {req.done}, "
                                     f"error {req.error!r}")
            for c, r in req.results.items():
                if not torch.equal(_column_bits(r.array), truth[c]):
                    raise AssertionError(f"mesh serve {label} {req.rid}: {c} differs from "
                                         "its source")
        for rep in planner.reports:
            if not rep.chosen.startswith("mesh:") or rep.devices != (0, 1):
                raise AssertionError(f"mesh serve {label}: chose {rep.chosen} on "
                                     f"{rep.devices}")
        lat = [r.latency_s * 1e3 for r in reqs]
        launches: dict = {}
        for rep in planner.reports:
            for d, n in rep.device_launches.items():
                launches[d] = launches.get(d, 0) + n
        rec = {"waves": len(planner.reports), "wall_ms": wall * 1e3,
               "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
               "register_ms": sum(r.register_s for r in planner.reports) * 1e3,
               "makespan_ms": sum(r.makespan_s for r in planner.reports) * 1e3,
               "modeled_ms": sum(r.shared_makespan_s for r in planner.reports) * 1e3,
               "device_launches": launches,
               "kernel_launches": {k: lib.launches for k, lib in zip(KERNELS, libs)},
               "chosen": [r.chosen for r in planner.reports]}
        out[label] = rec
        print(f"mesh serve closed_mix {label} mesh 2 " + " ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in rec.items())
            + f" | non-mesh warm wall_ms {non_mesh['wall_ms']:.4f} p50_ms "
            f"{non_mesh['p50_ms']:.4f} p99_ms {non_mesh['p99_ms']:.4f} register_ms "
            f"{sum(non_mesh['register_ms_per_wave']):.4f} makespan_ms "
            f"{non_mesh['makespan_ms']:.4f}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0, help="TPC-H scale factor")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the per-stage and per-column records here")
    args = ap.parse_args()

    # ---------------------------------------------------------------- phase 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.compiler import build_graph, device_buffers, span_stage
    from repro_torch.core.executor import StreamingExecutor
    from repro_torch.core.geometry import (KERNEL_REGS, Geometry, chip_from_device,
                                           native_config)
    from repro_torch.core.ir import group_chunk_layout
    from repro_torch.core.fusion import fuse
    from repro_torch.algos.bitpack import pack_np
    from repro_torch.core.patterns import (AFFINE, BYTES, IDENTITY, LOAD, STRGATHER,
                                           Aux, BufSpec, FullyParallel, GroupParallel,
                                           NonParallel, gather, load, load_bytes, span,
                                           stage_inputs, unpack, unzigzag)
    from repro_torch.core.plan import Encoded, Plan, encode, make_plan
    from repro_torch.data.columns import TABLE2_PLANS
    from repro_torch.data.loader import ColumnPipeline
    from repro_torch.data.tpch import generate
    from repro_torch.kernels import cuda, ref
    from repro_torch.kernels.fully_parallel import (KERNEL as FP, fully_parallel,
                                                    fully_parallel_batched)
    from repro_torch.kernels.group_parallel import (KERNEL as GP, group_parallel,
                                                    group_parallel_batched, tile_windows)
    from repro_torch.kernels.non_parallel import (KERNEL as NP, decode_table, non_parallel,
                                                  non_parallel_batched)
    from repro_torch.kernels.ops import run_stage

    columns = tuple(TABLE2_PLANS)
    libs = (FP, GP, NP)         # the decode kernels; kernel 4 is built per query in phase 7

    name = torch.cuda.get_device_name(0)
    spec = chip_from_device(0)
    hbm = spec.hbm_gbps
    print(f"device: {name}  torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"sms {spec.sms}  l2_mb {spec.l2_bytes / 2**20:.0f}  hbm_bound_gbps {hbm} "
          f"({spec.source})")

    # ---------------------------------------------------------------- phase 2
    t0 = time.perf_counter()
    cuda.build(libs)
    for lib in libs:
        lib.load(torch.device("cuda", 0))    # every kernel loaded on the card now
    built = " ".join(f"{lib.name} {lib.build_s:.1f} s" for lib in libs
                     if lib.build_s is not None)
    print(f"build: {time.perf_counter() - t0:.2f} s ({built or 'cached'}) -> "
          f"{FP.path().parent}")
    print("preload: " + " ".join(f"{lib.name}_ms {lib.preload_s[0] * 1e3:.4f}"
                                 for lib in libs))
    for lib in libs:
        regs = 0
        for line in lib.path().with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {lib.name}: {line.strip()}")
            m = re.search(r"Used (\d+) registers", line)
            regs = max(regs, int(m.group(1))) if m else regs
        # the geometry spaces bound S by these (core/geometry.py KERNEL_REGS)
        if not 0 < regs <= KERNEL_REGS[PATTERN[lib.name]]:
            raise AssertionError(f"{lib.name} takes {regs} registers a thread, the "
                                 f"geometry spaces assume at most "
                                 f"{KERNEL_REGS[PATTERN[lib.name]]}")

    t0 = time.perf_counter()
    cols = generate(args.scale, seed=args.seed)
    cols = {k: cols[k] for k in columns}
    t_gen = time.perf_counter() - t0
    pipe = ColumnPipeline(dict(TABLE2_PLANS), device="cuda", **FIFO_WHOLE)
    t0 = time.perf_counter()
    ratios = pipe.compress(cols)
    print(f"setup: generate(scale={args.scale}) {t_gen:.1f} s, encode "
          f"{time.perf_counter() - t0:.1f} s, programs {pipe.cache_stats}")

    # ---------------------------------------------------------------- phase 3
    timer = Timer()
    err = {k: 0.0 for k in KERNELS}
    compared = {k: 0 for k in KERNELS}
    stages = []
    profiled = []   # (record, fn, kernel) of each timed stage, profiled at once
    stage_args = {}  # id(record) -> (stage, inputs) of each timed stage

    def check(st, env, col, timed):
        """Kernel vs plain on one FP/GP/NP stage; env holds plain-version inputs."""
        plain_reps = None
        if isinstance(st, FullyParallel):
            kname, kfn, pfn = "fully_parallel", fully_parallel, ref.fully_parallel_torch
        elif isinstance(st, GroupParallel):
            kname, kfn, pfn = "group_parallel", group_parallel, ref.group_parallel_torch
        else:
            kname, kfn, pfn = "non_parallel", non_parallel, ref.non_parallel_torch
            # the plain rANS decode is chunk_size steps of a dozen torch
            # launches each (about a second at 4096): 3 reps, not 10
            plain_reps = 3
            if timed and not decode_table(env[st.sym_tab], env[st.freq_tab],
                                          env[st.cum_tab])[1]:
                raise AssertionError(f"{col}:{st.name}: tables miss the packed layout")
        plain = pfn(st, env)
        err[kname] = max(err[kname], same(kfn(st, env), plain, f"{col}:{st.name}"))
        compared[kname] += 1
        if timed:
            rec = {"kernel": kname, "column": col, "stage": st.name, "n": st.n_out,
                   "out_bytes": plain.numel() * plain.element_size(),
                   "bytes": stage_bytes(stage_inputs(st), env, plain),
                   "ms": timer.ms(lambda: kfn(st, env)),
                   "plain_ms": timer.ms(lambda: pfn(st, env), plain_reps),
                   "library_ms": None}
            profiled.append((rec, lambda: kfn(st, env), f"zf_{kname}"))
            stage_args[id(rec)] = (st, env)
            if kname == "non_parallel":
                for s_ in NP_BLOCKS:
                    rec[f"ms_s{s_}"] = timer.ms(lambda: kfn(st, env, Geometry(1, s_, 1)))
            rec["bound_ms"] = rec["bytes"] / (hbm * 1e9) * 1e3
            rec["bound_by"] = "bytes"
            if kname == "non_parallel":
                ops_ms = st.n_out * NP_OPS_PER_SYMBOL / INT32_OPS_PER_S * 1e3
                if ops_ms > rec["bound_ms"]:
                    rec["bound_ms"], rec["bound_by"] = ops_ms, "operations"
            if (isinstance(st, GroupParallel) and st.map_kind == IDENTITY
                    and not st.tail and st.values[0][0].kind == LOAD):
                vals = env[st.values[0][0].bufs[0]]
                counts = torch.diff(env[st.presum]).long()
                rec["library_ms"] = timer.ms(
                    lambda: torch.repeat_interleave(vals, counts,
                                                    output_size=st.n_out))
                same(torch.repeat_interleave(vals, counts, output_size=st.n_out)
                     .to(plain.dtype), plain, f"{col}:{st.name} repeat_interleave")
            if (isinstance(st, FullyParallel) and len(st.chain) == 1
                    and st.chain[0].kind == BYTES and st.chain[0].imm == 4
                    and plain.element_size() == 4):
                raw = env[st.chain[0].bufs[0]][:4 * st.n_out]
                rec["library_ms"] = timer.ms(lambda: raw.view(torch.int32).clone())
                same(raw.view(torch.int32).clone().view(plain.dtype), plain,
                     f"{col}:{st.name} view-and-clone")
            stages.append(rec)
        return plain

    def walk(graph, env, col, timed=True):
        for st in graph.stages:
            if isinstance(st, Aux):
                local = dict(env)
                for prod in st.producers:
                    local[prod.out] = check(prod, local, col, timed)
                env[st.out] = run_stage(st, env, "torch")
            else:
                env[st.out] = check(st, env, col, timed)
        return env[graph.out]

    t0 = time.perf_counter()
    for col in columns:
        walk(pipe.executor.graph(col), device_buffers(pipe.encoded(col)), col)
    for (rec, _, _), ms in zip(profiled, profiled_ms([c[1:] for c in profiled],
                                                      timer.flush)):
        rec["profiler_ms"] = ms
    profiled = None
    # each kernel's largest main-path stage (the kernels line's), kept with its
    # inputs for phase 8's geometry sweep
    bigs = {}
    for k in KERNELS:
        r = max((r for r in stages if r["kernel"] == k),
                key=lambda r: (r["library_ms"] is not None, r["bytes"]))
        bigs[k] = (r, *stage_args[id(r)])
    stage_args = None
    rng = np.random.default_rng(args.seed)
    for bw in FP_BWS:
        for n in FP_NS:
            lo, hi = (-2**31, 2**31) if bw == 32 else (0, 1 << bw)
            arr = rng.integers(lo, hi, n).astype(np.int32)
            enc = encode(Plan("bitpack", params={"bit_width": bw}), arr)
            out = walk(build_graph(enc), device_buffers(enc), f"sweep bw={bw} n={n}",
                       timed=False)
            same(out.cpu(), torch.from_numpy(arr), f"sweep bw={bw} n={n} vs source")
    # kernel 1's paths, each case counted on the compare line
    fp_tile = native_config("fp").tile
    fp_cases: dict[str, int] = {}

    def fp_case(label, chain, inputs, env, n, out_dtype=np.int32):
        st = FullyParallel(chain=chain, inputs=inputs,
                           specs=tuple(BufSpec("full") for _ in inputs), out="o",
                           n_out=n, out_dtype=out_dtype, elementwise=False, name=label)
        fp_cases[label] = fp_cases.get(label, 0) + 1
        return check(st, env, f"fp {label}", False)

    def packed(bw, n, cut=0, offset=0):
        """Bit-packed values of bw bits, ``cut`` words dropped from the end, the
        buffer ``offset`` words into its allocation; the env and the values."""
        vals = rng.integers(0, 1 << bw, n, dtype=np.int64) if bw else np.zeros(n, np.int64)
        words = (pack_np(vals, bw) if bw else np.zeros(2, np.uint32))
        words = words[:max(1, words.size - cut)].view(np.int32)
        buf = torch.from_numpy(np.concatenate([np.zeros(offset, np.int32), words])).cuda()
        base = int(rng.integers(-2**31, 2**31))
        env = {"p": buf[offset:], "bw": torch.tensor([bw], dtype=torch.int32).cuda(),
               "base": torch.tensor([base], dtype=torch.int32).cuda()}
        return env, (vals + base + 2**31) % 2**32 - 2**31

    unp, unp_in = (unpack("p", "bw", "base"),), ("p", "bw", "base")
    for bw in range(33):
        for n in (1, 31, 32, 127, 128, fp_tile - 1, fp_tile, fp_tile + 1, 1_000_003):
            env, want = packed(bw, n)
            got = fp_case("bw 0-32", unp, unp_in, env, n)
            if not np.array_equal(got.cpu().numpy().astype(np.int64), want):
                raise AssertionError(f"fp bw={bw} n={n}: plain differs from the source")
    for bw in (1, 7, 13, 31, 32):
        for n in (127, fp_tile + 1, 2 * fp_tile + 5):
            for cut in (1, 2, 9, 10**9):          # the guard word, then more
                for offset in range(4):           # every 16-byte misalignment
                    fp_case("short buffer", unp, unp_in, packed(bw, n, cut, offset)[0], n)
    for bw in (33, 40, 64, 100):
        env = packed(31, 300_001)[0]
        env["bw"] = torch.tensor([bw], dtype=torch.int32).cuda()
        fp_case("bw > 32", unp, unp_in, env, 300_001)
    n = 1_000_003
    env = packed(9, n)[0]
    env["x"] = torch.from_numpy(rng.integers(-5, 600, n).astype(np.int16)).cuda()
    for dt in (np.uint8, np.uint16):
        env["t"] = torch.from_numpy(rng.integers(0, np.iinfo(dt).max + 1, 513)
                                    .astype(dt)).cuda()
        fp_case(f"{np.dtype(dt).name} gather", unp + (gather("t"),), unp_in + ("t",),
                env, n, dt)
        fp_case(f"{np.dtype(dt).name} gather", (load("x"), gather("t")), ("x", "t"),
                env, n, dt)
    raw = torch.from_numpy(rng.integers(0, 256, 5 * 300_007 + 8).astype(np.uint8)).cuda()
    for itemsize in range(1, 6):
        for offset in range(4):
            for m in (1, 31, 300_007):
                for dt in ((np.int32, np.uint32, np.float32) if itemsize == 4
                           else (np.int32,)):
                    fp_case("bytes 1-5", (load_bytes("b", itemsize),), ("b",),
                            {"b": raw[offset:offset + m * itemsize]}, m, dt)
    env["t"] = torch.from_numpy(rng.integers(-2**31, 2**31, 2048).astype(np.int32)).cuda()
    env["offs"] = torch.from_numpy(np.sort(rng.integers(0, 10**7, 5000))
                                   .astype(np.int32)).cuda()
    fp_case("unpack-gather-unzigzag", unp + (gather("t"), unzigzag()), unp_in + ("t",),
            env, n)
    raw8 = torch.from_numpy(rng.integers(0, 256, 4000).astype(np.uint8)).cuda()
    env["big"] = torch.from_numpy(rng.integers(-2**31, 2**31, 5000).astype(np.int32)).cuda()
    env["u8"] = raw8[3:3 + 1001]              # odd address, not whole words
    for chain in ((gather("big"),), (gather("u8"),), (unzigzag(), gather("t")),
                  (gather("big"), unzigzag(), gather("t"))):
        ins = tuple(dict.fromkeys(b for op in chain for b in op.bufs))
        fp_case("tables", unp + chain, unp_in + ins, env, n,
                np.uint8 if chain[-1].bufs == ("u8",) else np.int32)
    for dt in (np.int32, np.int16, np.int8, np.uint8):
        info = np.iinfo(dt)
        env["x"] = torch.from_numpy(rng.integers(max(info.min, -50), min(info.max, 6000),
                                                 n).astype(dt)).cuda()
        fp_case("load-span", (load("x"), span("offs")), ("x", "offs"), env, n)
    counts = np.where(rng.random(200_000) < 0.01, rng.integers(2, 300, 200_000), 1)
    counts[1234] = 3_000_000                      # one run far longer than a tile
    vals = rng.integers(-2**31, 2**31 - 1, counts.size).astype(np.int32)
    skew = np.repeat(vals, counts).astype(np.int32)
    for plan in (Plan("rle", children={"counts": make_plan("bitpack"),
                                       "values": make_plan("bitpack")}),
                 Plan("rle", children={"counts": make_plan("bitpack")})):
        enc = encode(plan, skew)
        out = walk(build_graph(enc), device_buffers(enc), f"skew {plan.describe()}",
                   timed=False)
        same(out.cpu(), torch.from_numpy(skew), f"skew {plan.describe()} vs source")
    # DeltaStride whose affine map wraps past 2^31 inside a long group
    ds = Encoded("deltastride",
                 {"n_groups": 3, "group_presum": np.array([0, 1, 400_001, 400_003])},
                 {"starts": np.array([5, 2**31 - 1000, -7], np.int32),
                  "strides": np.array([0, 7, -2**31], np.int32),
                  "counts": np.array([1, 400_000, 2], np.int32)}, {}, 400_003,
                 np.dtype(np.int32))
    out = walk(build_graph(ds), device_buffers(ds), "deltastride wrap", timed=False)
    want = np.concatenate([[5], (np.int64(2**31 - 1000) + 7 * np.arange(400_000)),
                           [-7, -7 - 2**31]]).astype(np.int64)
    same(out.cpu(), torch.from_numpy(((want + 2**31) % 2**32 - 2**31).astype(np.int32)),
         "deltastride wrap vs source")
    # kernel 2's windows: zero-count groups whose window overflows a tile's
    # shared buffer (the kernel's global-memory path), all counts 1 (a window
    # of exactly T groups), one run longer than many tiles; each through the
    # IDENTITY, AFFINE and STRGATHER maps
    gp_geom = native_config("gp")
    tile = gp_geom.S * gp_geom.C            # outputs of one sub-tile's window
    zero = rng.integers(1, 4, 400_000)
    zero[rng.random(zero.size) < 0.3] = 0
    zero[100_000:200_000] = 0
    gp_cases = {"zero-counts": (zero, lambda m: int(m.max()) > tile),
                "all-ones": (np.ones(1_000_003, np.int64), lambda m: int(m.max()) == tile),
                "long-run": (np.concatenate([rng.integers(1, 5, 3000), [50 * tile],
                                             rng.integers(1, 5, 3000)]),
                             lambda m: int((m == 1).sum()) >= 48)}
    for label, (cnt, shows) in gp_cases.items():
        presum = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int32)
        env = {"presum": torch.from_numpy(presum).cuda()}
        for k in ("vals", "strides"):
            env[k] = torch.from_numpy(rng.integers(-2**31, 2**31, cnt.size)
                                      .astype(np.int32)).cuda()
        windows = tile_windows(env["presum"], int(presum[-1]), tile)
        if not shows(windows):
            raise AssertionError(f"gp {label}: windows {windows.min()}..{windows.max()} "
                                 f"do not show the case (tile {tile})")
        env["words"] = torch.from_numpy(rng.integers(0, 1000, cnt.size)
                                        .astype(np.int32)).cuda()
        env["chars"] = torch.from_numpy(rng.integers(0, 256, 50_000)
                                        .astype(np.uint8)).cuda()
        env["offs"] = torch.from_numpy(np.sort(rng.integers(0, 49_000, 1001))
                                       .astype(np.int32)).cuda()
        for map_kind, names in ((IDENTITY, ("vals",)), (AFFINE, ("vals", "strides")),
                                (STRGATHER, ("words",))):
            extra = ("chars", "offs") if map_kind == STRGATHER else ()
            st = GroupParallel(presum="presum", value_inputs=names,
                               value_specs=(BufSpec("tile"),) * len(names),
                               values=tuple((load(k),) for k in names),
                               map_kind=map_kind, extra_inputs=extra, out="out",
                               n_out=int(presum[-1]), n_groups=cnt.size,
                               out_dtype=np.uint8 if extra else np.int32,
                               name=f"{label} {map_kind}")
            got = check(st, env, f"gp {label}", False)
            if map_kind == IDENTITY:
                same(got.cpu(), torch.from_numpy(np.repeat(env["vals"].cpu().numpy(), cnt)),
                     f"gp {label} vs numpy.repeat")
    text = long_words(200_000, rng)
    enc = encode(make_plan("stringdict"), text)
    out = walk(build_graph(enc), device_buffers(enc), "stringdict long words", timed=False)
    same(out.cpu(), torch.from_numpy(text), "stringdict long words vs source")
    for chunk in NP_CHUNKS:
        for kind in NP_KINDS:
            for n in NP_NS:
                arr = ans_input(kind, n, rng)
                enc = encode(Plan("ans", params={"chunk_size": chunk}), arr)
                what = f"ans sweep {kind} chunk={chunk} n={n}"
                out = walk(build_graph(enc), device_buffers(enc), what, timed=False)
                same(bits(out.cpu()), bits(torch.from_numpy(arr)), f"{what} vs source")
    # fusion rule 4 (no Table-2 plan fires it): a GATHER tail inside kernel 3
    syms = rng.integers(0, 40, 1_000_003).astype(np.uint8)
    enc = encode(Plan("ans", params={"chunk_size": 4096}), syms)
    env = device_buffers(enc)
    table = rng.integers(-2**31, 2**31, 40).astype(np.int32)
    env["table"] = torch.from_numpy(table).cuda()
    (dec,) = build_graph(enc).stages
    dec.out = "syms"
    (fused,) = fuse([dec, FullyParallel(
        chain=(load("syms"), gather("table")), inputs=("syms",),
        specs=(BufSpec("tile"),), out="out", n_out=syms.size, name="lookup")])
    if not isinstance(fused, NonParallel) or not fused.tail:
        raise AssertionError(f"rule 4 did not fuse: {fused}")
    same(check(fused, env, "rule-4 tail", False).cpu(), torch.from_numpy(table[syms]),
         "rule-4 tail vs source")
    # tables outside the packed layout (no encoder makes them) take kernel 3's
    # three-table path; the output is garbage, the same in both versions
    enc = encode(Plan("ans", params={"chunk_size": 1000}), ans_input("uint8", 100_003, rng))
    env = device_buffers(enc)
    (dec,) = build_graph(enc).stages
    cum = env[dec.cum_tab].to(torch.int32).cpu().numpy()
    cum[int(np.argmax(env[dec.freq_tab].to(torch.int32).cpu().numpy() > 3))] += 3
    env[dec.cum_tab] = torch.from_numpy(cum.astype(np.uint16)).cuda()
    if decode_table(env[dec.sym_tab], env[dec.freq_tab], env[dec.cum_tab])[1]:
        raise AssertionError("the altered tables still fit the packed layout")
    check(dec, env, "ans three-table path", False)

    # the chunk and span entries, at the shapes the chunked path gives them
    fifo = {"policy": "fifo", "batch_columns": False}
    chunk_pipes = {cb: ColumnPipeline(dict(TABLE2_PLANS), device="cuda", chunk_bytes=cb,
                                      chunk_decode=True, **fifo) for cb in CHUNK_SIZES}
    span_pipes = {cb: ColumnPipeline({c: make_plan(p) for c, p in SPAN_PLANS.items()},
                                     device="cuda", chunk_bytes=cb, chunk_decode=True,
                                     **fifo)
                  for cb in CHUNK_SIZES}
    for cb in CHUNK_SIZES:
        chunk_pipes[cb].load({c: pipe.encoded(c) for c in columns})
        if cb == CHUNK_SIZES[0]:
            span_pipes[cb].compress({c: cols[c] for c in SPAN_PLANS})
        else:
            span_pipes[cb].load({c: span_pipes[CHUNK_SIZES[0]].encoded(c)
                                 for c in SPAN_PLANS})
    span_encoded = {c: span_pipes[CHUNK_SIZES[0]].encoded(c) for c in SPAN_PLANS}
    entries = []          # one record per timed chunk or span entry
    off_entries = []      # chunk and span entries held at a geometry off the native table

    def off_native(kname, col, what, native_out, call):
        """A chunk or span entry again at OFF_NATIVE[kname], into a buffer of
        its own: bitwise to the native launch's range (itself held above)."""
        geom = Geometry(*OFF_NATIVE[kname])
        alt = torch.empty_like(native_out)
        before = libs[list(KERNELS).index(kname)].launches
        call(geom, alt)
        if libs[list(KERNELS).index(kname)].launches != before + 1:
            raise AssertionError(f"{col} {what} at {geom}: no launch of {kname}")
        same(alt, native_out, f"{col} {what} at {geom}")
        off_entries.append(f"{kname} {col} {what} at {geom}")

    def entry(kname, col, what, n, call, whole_call, whole_n, plain_call=None,
              plain_reps=None):
        rec = {"kernel": kname, "column": col, "entry": what, "n": n,
               "ms": timer.ms(call), "whole_n": whole_n, "whole_ms": timer.ms(whole_call),
               "plain_ms": None if plain_call is None else timer.ms(plain_call, plain_reps)}
        entries.append(rec)

    def check_entries(p_, col):
        sched = p_.executor.chunk_schedule(col)
        if sched is None:
            return
        enc, graph = p_.encoded(col), p_.executor.graph(col)
        whole_env = device_buffers(enc)
        want = torch.from_numpy(cols[col])
        out = torch.empty(graph.n_out, dtype=ref.torch_dtype(graph.out_dtype), device="cuda")
        K = sched.n_chunks
        if sched.kind == "element":
            (st,) = graph.stages           # one fused chain on every Table-2 column
            k = K // 2
            env = unit_env(enc, sched, k, whole_env)
            s, n = sched.out_starts[k], sched.out_sizes[k]
            fully_parallel(st, env, n=n, out=out[s:s + n])
            err["fully_parallel"] = max(err["fully_parallel"], same(
                out[s:s + n], ref.fully_parallel_torch(st, env, n), f"{col} chunk {k}"))
            compared["fully_parallel"] += 1
            same(out[s:s + n].cpu(), want[s:s + n], f"{col} chunk {k} vs source")
            off_native("fully_parallel", col, f"chunk {k}", out[s:s + n],
                       lambda g, o: fully_parallel(st, env, g, n=n, out=o))
            entry("fully_parallel", col, f"chunk {k}/{K}", n,
                  lambda: fully_parallel(st, env, n=n, out=out[s:s + n]),
                  lambda: fully_parallel(st, whole_env), st.n_out,
                  lambda: ref.fully_parallel_torch(st, env, n))
            return
        layout = group_chunk_layout(graph)
        if graph.stages[layout.stage_index + 1:]:
            raise AssertionError(f"{col}: a stage after the group stage")
        pro = p_.executor.cache.get_group_prologue(graph, "kernel")
        resident = pro(unit_env(enc, sched, 0, whole_env)) if pro is not None else {}
        st, gst = span_stage(graph), graph.stages[layout.stage_index]
        envs = [{**unit_env(enc, sched, k, whole_env), **resident} for k in range(K)]
        whole = {**whole_env, **resident}
        for k, env in enumerate(envs):
            s, n, g0, gz = (sched.out_starts[k], sched.out_sizes[k], sched.g_starts[k],
                            sched.g_sizes[k])
            if layout.kind == "gp":
                group_parallel(st, env, out=out[s:s + n], out_start=s, g_start=g0,
                               n_valid=n, g_size=gz)
                err["group_parallel"] = max(err["group_parallel"], same(
                    out[s:s + n], ref.group_parallel_torch(st, env, s, g0, n),
                    f"{col} span {k}"))
                compared["group_parallel"] += 1
            else:
                non_parallel(st, env, n_chunks=gz, n=n, out=out[s:s + n])
                if k in (0, K - 1)[:NP_PLAIN_SPANS]:
                    err["non_parallel"] = max(err["non_parallel"], same(
                        out[s:s + n], ref.non_parallel_torch(st, env, gz, n),
                        f"{col} span {k}"))
                    compared["non_parallel"] += 1
        kname = "group_parallel" if layout.kind == "gp" else "non_parallel"
        same(out, run_stage(gst, whole, "kernel"), f"{col}: {K} spans vs whole decode")
        same(out.cpu(), want, f"{col}: {K} spans vs source")
        s, n, g0, gz = (sched.out_starts[0], sched.out_sizes[0], sched.g_starts[0],
                        sched.g_sizes[0])
        if layout.kind == "gp":
            off_native(kname, col, "span 0", out[s:s + n],
                       lambda g, o: group_parallel(st, envs[0], g, out=o, out_start=s,
                                                   g_start=g0, n_valid=n, g_size=gz))
        else:
            off_native(kname, col, "span 0", out[s:s + n],
                       lambda g, o: non_parallel(st, envs[0], g, n_chunks=gz, n=n, out=o))
        if layout.kind == "gp":
            entry(kname, col, f"span 0/{K}", n,
                  lambda: group_parallel(st, envs[0], out=out[s:s + n], out_start=s,
                                         g_start=g0, n_valid=n, g_size=gz),
                  lambda: group_parallel(gst, whole), gst.n_out,
                  lambda: ref.group_parallel_torch(st, envs[0], s, g0, n))
        else:
            entry(kname, col, f"span 0/{K}", n,
                  lambda: non_parallel(st, envs[0], n_chunks=gz, n=n, out=out[s:s + n]),
                  lambda: non_parallel(gst, whole), gst.n_out,
                  lambda: ref.non_parallel_torch(st, envs[0], gz, n), 1)

    for col in columns:
        check_entries(chunk_pipes[CHUNK_SIZES[0]], col)
    for col in SPAN_PLANS:
        check_entries(span_pipes[CHUNK_SIZES[0]], col)
    for kname in KERNELS:
        if not any(r["kernel"] == kname for r in entries):
            raise AssertionError(f"no chunk or span entry of {kname} was checked")
        if not any(e.startswith(kname) for e in off_entries):
            raise AssertionError(f"no entry of {kname} was held off its native geometry")

    # the batched entries: K members of one structure, one launch per the
    # kernel's limit of members, against the plain batched version and K
    # single launches
    batched = []          # one record per kernel and K
    batch_kinds = {"fully_parallel": (FP, fully_parallel, fully_parallel_batched,
                                      ref.fully_parallel_batched_torch),
                   "group_parallel": (GP, group_parallel, group_parallel_batched,
                                      ref.group_parallel_batched_torch),
                   "non_parallel": (NP, non_parallel, non_parallel_batched,
                                    ref.non_parallel_batched_torch)}

    def member_env(enc, upto):
        """The card's operands of a blob and the results of its stages before
        stage ``upto`` (plain versions), what that stage reads."""
        graph = build_graph(enc)
        env = device_buffers(enc)
        for st in graph.stages[:upto]:
            env[st.out] = run_stage(st, env, "torch")
        return graph.stages[upto], env

    def check_batched(kname, encs, what):
        lib, single, kbatch, pbatch = batch_kinds[kname]
        sigs = {build_graph(e).signature for e in encs}
        if len(sigs) != 1:
            raise AssertionError(f"batched {kname}: {what} are not one structure")
        graph = build_graph(encs[0])
        upto = next(i for i, st in enumerate(graph.stages)
                    if type(st).__name__ == {"fully_parallel": "FullyParallel",
                                             "group_parallel": "GroupParallel",
                                             "non_parallel": "NonParallel"}[kname])
        pairs = [member_env(e, upto) for e in encs]
        st = pairs[0][0]
        for k in sorted({2, 8, lib.batch_max + 1}):
            envs = [pairs[i % len(pairs)][1] for i in range(k)]
            before = lib.batched_launches
            got = kbatch(st, envs)
            torch.cuda.synchronize()
            split = lib.batched_launches - before
            if split != -(-k // lib.batch_max):
                raise AssertionError(f"batched {kname} K={k}: {split} launches, the "
                                     f"limit is {lib.batch_max} members")
            plains = pbatch(st, envs)
            for i, (g, env) in enumerate(zip(got, envs)):
                err[kname] = max(err[kname], same(g, plains[i], f"batched {kname} K={k} #{i}"))
                same(g, single(st, env), f"batched {kname} K={k} #{i} vs a single launch")
            compared[kname] += k
            rec = {"kernel": kname, "what": what, "stage": st.name, "k": k,
                   "launches": split, "n": st.n_out}
            if k == 2:
                outs = [torch.empty_like(g) for g in got]
                rec["ms"] = timer.ms(lambda: kbatch(st, envs, outs=outs))
                rec["singles_ms"] = timer.ms(lambda: [single(st, e, out=o)
                                                      for e, o in zip(envs, outs)])
                rec["plain_ms"] = timer.ms(lambda: pbatch(st, envs),
                                           3 if kname == "non_parallel" else None)
                rec["bytes"] = sum(stage_bytes(stage_inputs(st), e, g)
                                   for e, g in zip(envs, got))
                rec["bound_ms"] = rec["bytes"] / (hbm * 1e9) * 1e3
            batched.append(rec)

    check_batched("fully_parallel", [pipe.encoded(c) for c in ("L_DISCOUNT", "L_TAX")],
                  "L_DISCOUNT + L_TAX")
    keys = cols["L_ORDERKEY"]
    cut = np.flatnonzero(np.diff(keys)) + 1
    runs = np.diff(np.concatenate([[0], cut, [keys.size]]))
    vals = keys[np.concatenate([[0], cut])]
    swapped = np.repeat(vals, runs[::-1]).astype(keys.dtype)   # the same runs, reversed
    check_batched("group_parallel", [encode(make_plan("rle"), a) for a in (keys, swapped)],
                  "L_ORDERKEY rle and its runs reversed")
    flags = cols["L_RETURNFLAG"]
    chunk = 4096
    body = flags[:flags.size // chunk * chunk].reshape(-1, chunk)
    shuffled = np.concatenate([body[np.random.default_rng(args.seed).permutation(len(body))]
                               .reshape(-1), flags[body.size:]])
    check_batched("non_parallel", [encode(TABLE2_PLANS["L_RETURNFLAG"], a)
                                   for a in (flags, shuffled)],
                  "L_RETURNFLAG and its rANS chunks reordered")
    print(f"compare: {compared} kernel launches bitwise equal to plain, of them "
          f"kernel-1 cases {fp_cases} ({time.perf_counter() - t0:.1f} s); chunk and span "
          f"entries off the native geometry, bitwise to the native: {len(off_entries)} "
          f"({'; '.join(off_entries[:1] + off_entries[-2:])})")
    for r in entries:
        plain = "" if r["plain_ms"] is None else f" plain_ms {r['plain_ms']:.4f}"
        print(f"entry {r['kernel']:14s} {r['column']:16s} {r['entry']:12s} n {r['n']:9d} "
              f"ms {r['ms']:.4f} whole_n {r['whole_n']:9d} whole_ms {r['whole_ms']:.4f}"
              f"{plain}")
    for r in batched:
        timed = "".join(f" {k} {r[k]:.4f}" for k in ("ms", "singles_ms", "plain_ms", "bound_ms")
                        if k in r)
        print(f"batched {r['kernel']:14s} {r['what']:40s} {r['stage']:20s} K {r['k']:2d} "
              f"launches {r['launches']} n {r['n']:9d}{timed}")
    for r in stages:
        lib = "" if r["library_ms"] is None else f" library_ms {r['library_ms']:.4f}"
        lib += "".join(f" {k} {r[k]:.4f}" for k in ("profiler_ms",) + tuple(
            f"ms_s{s_}" for s_ in NP_BLOCKS) if k in r)
        print(f"stage {r['kernel']:14s} {r['column']:16s} {r['stage']:28s} n {r['n']:9d} "
              f"ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms "
              f"{r['bound_ms']:.4f}{lib}")

    # ---------------------------------------------------------------- phase 4
    for lib in libs:
        lib.launches = 0
    makespans, host_ms = [], []
    whole_plan = pipe.plan(window=2)    # planned once, at the pre-planner window of 2
    for label in ("cold",) + ("warm",) * WARM_RUNS:
        res = None      # drop the last run's columns: a warm run reuses their memory
        t0 = time.perf_counter()
        res = pipe.run(plan=whole_plan)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        for col in columns:
            got = res[col].array.cpu()
            same(got, torch.from_numpy(cols[col]), f"{label} run {col} vs source")
        makespans.append(pipe.makespan_s)
    launches = {k: lib.launches for k, lib in zip(KERNELS, libs)}
    launches_warm = {k: v // (WARM_RUNS + 1) for k, v in launches.items()}
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel did not run on the main path: {launches}")
    plain_exec = StreamingExecutor(backend="torch", device=pipe.device, **FIFO_WHOLE)
    for col in columns:
        plain_exec.compile(col, pipe.encoded(col))
    for _ in range(2):
        pres = plain_exec.run()
    for col in columns:
        same(pres[col].array.cpu(), torch.from_numpy(cols[col]), f"plain run {col}")
    pres = None
    for r in res.values():
        r.array = None  # keep the records, free the columns before the traced run
    # one more warm run under the profiler, and one of the chunked path at
    # 1 MiB (warmed up first), in one session: where the device's time goes
    chunk_trace = chunk_pipes[CHUNK_SIZES[0]]
    chunk_trace.run(window=2)
    marks = {"whole": pipe, f"chunked {mib(CHUNK_SIZES[0])}": chunk_trace}
    traced_ms = {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for label, p_ in marks.items():
            with torch.profiler.record_function(f"run {label}"):
                traced = p_.run(window=2)
            traced_ms[label] = p_.makespan_s * 1e3
            traced = None
    events = prof.events()
    for label in marks:
        (m,) = [e for e in events if e.name == f"run {label}"
                and e.device_type == torch.autograd.DeviceType.CPU]
        device_ms = {"h2d_copy": 0.0, **{k: 0.0 for k in KERNELS}, "torch_ops": 0.0}
        spans = []
        for e in events:
            # the device timeline also carries each record_function range (a
            # user annotation per stream, named like it), which is not work
            if e.device_type != torch.autograd.DeviceType.CUDA or e.name.startswith("run ") \
                    or not m.time_range.start <= e.time_range.start <= m.time_range.end:
                continue
            kind = ("h2d_copy" if "Memcpy" in e.name else
                    "fully_parallel" if "zf_fully_parallel" in e.name else
                    "group_parallel" if "zf_group_parallel" in e.name else
                    "non_parallel" if "zf_non_parallel" in e.name else "torch_ops")
            device_ms[kind] += e.time_range.elapsed_us() / 1e3
            spans.append((e.time_range.start, e.time_range.end))
        busy_us, reach = 0.0, float("-inf")
        for a, b in sorted(spans):          # union of device intervals
            busy_us += max(0.0, b - max(a, reach))
            reach = max(reach, b)
        if sum(device_ms.values()) <= 0:
            raise AssertionError(f"the profiled {label} run shows no device work")
        print(f"device {label} " + " ".join(f"{k}_ms {v:.4f}" for k, v in device_ms.items())
              + f" busy_ms {busy_us / 1e3:.4f} traced_makespan_ms {traced_ms[label]:.4f} "
              f"busy_share {busy_us / 1e3 / traced_ms[label]:.4f}")

    # the plain-copy yardstick: the plain columns from pinned memory to the card
    # on the executor's copy stream, what moving them uncompressed would take
    stream = pipe.executor.copy_stream
    host_plain = [torch.from_numpy(cols[c].reshape(-1).view(np.uint8)).pin_memory()
                  for c in columns]
    dev_plain = [torch.empty_like(h, device="cuda") for h in host_plain]
    copy_ms = []
    for _ in range(WARM_RUNS + 1):       # the first copy warms up
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream):
            a.record(stream)
            for h, d in zip(host_plain, dev_plain):
                d.copy_(h, non_blocking=True)
            b.record(stream)
        b.synchronize()
        copy_ms.append(a.elapsed_time(b))
    for c, d in zip(columns, dev_plain):
        same(d.cpu(), torch.from_numpy(cols[c].reshape(-1).view(np.uint8)), f"plain copy {c}")
    plain_copy_ms = float(np.median(copy_ms[1:]))
    host_plain = dev_plain = None

    # the chunked paths: per-chunk decode at 1 MiB and 4 MiB, and kernel 2's
    # span columns, each driven with the counts zeroed just before
    chunked = {}

    def drive(p_, names, label):
        plan = p_.plan(window=2)        # planned once, at the pre-planner window
        for lib in libs:
            lib.launches = 0
        spans, hosts, out = [], [], None
        for run in ("cold",) + ("warm",) * WARM_RUNS:
            out = None
            t0 = time.perf_counter()
            out = p_.run(plan=plan)
            hosts.append((time.perf_counter() - t0) * 1e3)
            for col in names:
                same(bits(out[col].array.cpu()), bits(torch.from_numpy(cols[col])),
                     f"{label} {run} run {col} vs source")
            spans.append(p_.makespan_s * 1e3)
        counts = {k: lib.launches for k, lib in zip(KERNELS, libs)}
        per_run = {k: v // (WARM_RUNS + 1) for k, v in counts.items()}
        for col in names:
            r = out[col]
            sched = p_.executor.chunk_schedule(col)
            if sched is not None and r.decode_launches < sched.n_chunks:
                raise AssertionError(f"{label} {col}: {r.decode_launches} decode units "
                                     f"for {sched.n_chunks} chunks")
            print(f"chunked {label:22s} {col:16s} n_chunks {r.n_chunks:4d} decode_launches "
                  f"{r.decode_launches:4d} chunk_decoded {int(r.chunk_decoded)} transfer_ms "
                  f"{r.transfer_s * 1e3:.4f} decode_ms {r.decode_s * 1e3:.4f} "
                  f"kernel_launches {r.kernel_launches}")
        units = sum(out[c].decode_launches for c in names)
        rec = {"window": plan.window, "makespan_ms": float(np.median(spans[1:])),
               "makespan_ms_cold": spans[0], "makespan_ms_warm_min": min(spans[1:]),
               "makespan_ms_warm_max": max(spans[1:]),
               "host_run_ms": float(np.median(hosts[1:])), "decode_units_per_run": units,
               "kernel_launches_per_run": sum(per_run.values()),
               "launches": counts, "launches_per_run": per_run}
        print(f"chunked {label} totals " + " ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in rec.items() if k != "launches") + f" launches {counts}")
        return rec

    for cb in CHUNK_SIZES:
        rec = drive(chunk_pipes[cb], columns, f"table2 {mib(cb)}")
        if min(rec["launches"].values()) <= 0:
            raise AssertionError(f"a kernel did not run on the chunked path: {rec}")
        if args.scale == 1.0 and args.seed == 0 \
                and rec["decode_units_per_run"] != REF_UNITS_SF1[cb]:
            raise AssertionError(f"{rec['decode_units_per_run']} decode units at "
                                 f"{mib(cb)}, the reference's schedule gives "
                                 f"{REF_UNITS_SF1[cb]}")
        chunked[f"table2 {mib(cb)}"] = rec
        span = drive(span_pipes[cb], tuple(SPAN_PLANS), f"span columns {mib(cb)}")
        if span["launches"]["group_parallel"] <= 0:
            raise AssertionError(f"kernel 2 did not run on the span path: {span}")
        chunked[f"span columns {mib(cb)}"] = span
        chunk_pipes[cb] = span_pipes[cb] = None

    # ---------------------------------------------------------------- phase 5
    # the planner's paths, each plan driven with the counts zeroed just before
    whole_host = float(np.median(host_ms[1:]))
    one_mib = chunked[f"table2 {mib(CHUNK_SIZES[0])}"]
    host_per_unit_ms = ((one_mib["host_run_ms"] - whole_host)
                        / max(1, one_mib["decode_units_per_run"] - len(columns)))
    planned = {}

    def drive_plan(p_, plan, label, groups_must=None):
        """Cold plus ``WARM_RUNS`` warm runs of ``plan``; ``groups_must`` (the
        batched groups the plan must form, each one batched kernel-1 launch a
        run) is checked when given."""
        for lib in libs:
            lib.launches = lib.batched_launches = 0
        spans, hosts, out = [], [], None
        for run in ("cold",) + ("warm",) * WARM_RUNS:
            out = None
            t0 = time.perf_counter()
            out = p_.run(plan=plan)
            hosts.append((time.perf_counter() - t0) * 1e3)
            for col in columns:
                same(bits(out[col].array.cpu()), bits(torch.from_numpy(cols[col])),
                     f"planner {label} {run} run {col} vs source")
            spans.append(p_.makespan_s * 1e3)
        counts = {k: lib.launches for k, lib in zip(KERNELS, libs)}
        in_batch = {k: lib.batched_launches for k, lib in zip(KERNELS, libs)}
        per_run = {k: v // (WARM_RUNS + 1) for k, v in counts.items()}
        batch_per_run = {k: v // (WARM_RUNS + 1) for k, v in in_batch.items()}
        if min(counts.values()) <= 0:
            raise AssertionError(f"planner {label}: a kernel did not run: {counts}")
        groups = sorted({tuple(sorted((c,) + out[c].batched_with))
                         for c in columns if out[c].batched_with})
        if sum(in_batch.values()) < len(groups) * (WARM_RUNS + 1):
            raise AssertionError(f"planner {label}: batched groups {groups} made "
                                 f"{in_batch} batched launches in {WARM_RUNS + 1} runs")
        if groups_must is not None:
            want = {"fully_parallel": len(groups_must) * (WARM_RUNS + 1),
                    "group_parallel": 0, "non_parallel": 0}
            if [list(g) for g in groups] != groups_must or in_batch != want:
                raise AssertionError(f"planner {label}: batched groups {groups} with "
                                     f"{in_batch} batched launches in {WARM_RUNS + 1} "
                                     f"runs; the plan must form {groups_must}, one "
                                     f"kernel-1 launch each a run: {want}")
        modes = {m: sum(d.decode_mode == m for d in plan.decisions.values())
                 for m in ("whole", "batched", "chunk")}
        overheads = sorted(p_.executor.cost_model.launch_overhead_s(c) * 1e3 for c in columns)
        rec = {"modeled_makespan_ms": plan.modeled_makespan_s * 1e3,
               "makespan_ms": float(np.median(spans[1:])), "makespan_ms_cold": spans[0],
               "makespan_ms_warm_min": min(spans[1:]), "makespan_ms_warm_max": max(spans[1:]),
               "host_run_ms": float(np.median(hosts[1:])),
               "baselines_ms": {k: v * 1e3 for k, v in sorted(plan.baselines.items())},
               "window": plan.window, "modes": modes,
               # a batch is one decode unit, as its columns' records each count it
               "decode_units_per_run": sum(out[c].decode_launches for c in columns)
               - sum(len(g) - 1 for g in groups),
               "kernel_launches_per_run": sum(per_run.values()),
               "launches": counts, "batched_launches": in_batch,
               "launches_per_run": per_run, "batched_launches_per_run": batch_per_run,
               "batched_groups": [list(g) for g in groups],
               "launch_overhead_ms_min": overheads[0],
               "launch_overhead_ms_median": float(np.median(overheads)),
               "launch_overhead_ms_max": overheads[-1],
               "decode_scale": p_.executor.cost_model.decode_scale,
               "transfer_scale": p_.executor.cost_model.transfer_scale,
               "host_ms_per_added_unit": host_per_unit_ms,
               "chunked_columns": sorted(c for c, d in plan.decisions.items()
                                         if d.decode_mode == "chunk")}
        print(f"planner {label} " + " ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in rec.items()))
        for line in plan.explain().splitlines():
            print(f"planner {label} | {line}")
        return rec

    encoded = {c: pipe.encoded(c) for c in columns}
    ref_pipe = ColumnPipeline(dict(TABLE2_PLANS), device="cuda")   # the reference's defaults
    ref_pipe.load(encoded)
    sf1 = args.scale == 1.0 and args.seed == 0     # the one same-program pair of SF 1
    planned["reference-default"] = drive_plan(ref_pipe, ref_pipe.plan(), "reference-default",
                                              [["L_DISCOUNT", "L_TAX"]] if sf1 else None)
    ref_pipe = None
    auto_pipe = ColumnPipeline(dict(TABLE2_PLANS), device="cuda", policy="adaptive",
                               chunk_bytes="auto", chunk_decode=True)
    auto_pipe.load(encoded)
    planned["adaptive-auto seeded"] = drive_plan(auto_pipe, auto_pipe.plan(),
                                                 "adaptive-auto seeded")
    planned["adaptive-auto calibrated"] = drive_plan(auto_pipe, auto_pipe.plan(),
                                                     "adaptive-auto calibrated")
    auto_pipe = None

    # ---------------------------------------------------------------- phase 6
    served = run_serving(cols, encoded, libs, plain_copy_ms)

    # ---------------------------------------------------------------- phase 7
    queries = run_queries(args, cols, encoded, timer, hbm, libs)
    wide = run_wide_queries(cols, encoded, timer, libs)

    # ---------------------------------------------------------------- phase 8
    geometry = run_geometry(bigs, timer, spec)
    bigs = None

    # ---------------------------------------------------------------- phase 9
    baseline = run_baseline(columns, cols, encoded, timer, libs)

    # --------------------------------------------------------------- phase 11
    from repro_torch.configs import ARCHS
    lm = run_lm_serving(ARCHS[LM_ARCH], args.seed, timer, libs, hbm)

    # --------------------------------------------------------------- phase 12
    families = {arch: (dataclasses.replace(ARCHS[arch], **cut),
                       dataclasses.replace(ARCHS[arch], dtype=torch.float32, **cut32))
                for arch, (cut, cut32) in LM_FAMILIES.items()}
    lm_families = run_lm_families(families, args.seed, libs, hbm)

    # --------------------------------------------------------------- phase 13
    from repro_torch.configs import SMOKES
    lm_train = run_lm_train(ARCHS[LM_ARCH], SMOKES[LM_ARCH],
                            {arch: cut32 for arch, (_, cut32) in families.items()},
                            args.seed, timer, libs, hbm)

    # --------------------------------------------------------------- phase 14
    lm_roofline = run_lm_roofline(ARCHS[LM_ARCH], args.seed)

    # --------------------------------------------------------------- phase 15
    t_mesh = time.perf_counter()
    mesh = {"plans": run_mesh_plans(dict(TABLE2_PLANS), {c: pipe.encoded(c) for c in columns},
                                    pipe.executor.cost_model)}
    mesh["placed"] = run_placed_train(ARCHS[LM_ARCH], args.seed)
    torch.cuda.empty_cache()
    mesh["dp"] = run_dp_compressed(LM_ARCH, args.seed)
    card_train = next(c for c in lm_roofline["dryrun"]
                      if (c["arch"], c["shape"], c["mesh"]) == (LM_ARCH, "train_4k", "card_1x1"))
    mesh["dryrun"] = run_mesh_cell(card_train)
    mesh["phase_s"] = time.perf_counter() - t_mesh
    print(f"mesh phase_s {mesh['phase_s']:.2f}")

    # --------------------------------------------------------------- phase 16
    t_mesh = time.perf_counter()
    mesh_run = run_mesh_runs(cols, {c: pipe.encoded(c) for c in columns}, span_encoded,
                             pipe.executor.cost_model, libs)
    mesh_run["serve"] = run_mesh_serving(
        cols, {c: pipe.encoded(c) for c in columns}, served.pop("pipe"),
        next(r for r in served["serve"] if r["mix"] == "closed_mix shared warm"), libs)
    mesh_run["phase_s"] = time.perf_counter() - t_mesh
    print(f"mesh run phase_s {mesh_run['phase_s']:.2f}")

    # --------------------------------------------------------------- phase 10
    makespan = float(np.median(makespans[1:]))
    plain_b = sum(r.plain_bytes for r in res.values())
    comp_b = sum(r.compressed_bytes for r in res.values())
    rows = []
    for col in columns:
        r = res[col]
        rows.append({"column": col, "nesting": pipe.executor.graph(col).nesting,
                     "rows": int(cols[col].size), "compressed_mb": r.compressed_bytes / 1e6,
                     "ratio": ratios[col], "transfer_ms": r.transfer_s * 1e3,
                     "decode_ms": r.decode_s * 1e3, "launches": r.kernel_launches})
        print(f"column {col:16s} {rows[-1]['nesting']:60s} rows {cols[col].size:9d} "
              f"comp_mb {rows[-1]['compressed_mb']:.3f} ratio {ratios[col]:.2f} "
              f"transfer_ms {rows[-1]['transfer_ms']:.4f} decode_ms "
              f"{rows[-1]['decode_ms']:.4f} launches {r.kernel_launches}")
    totals = {"sf": args.scale, "warm_runs": WARM_RUNS, "plain_mb": plain_b / 1e6, "compressed_mb": comp_b / 1e6,
              "makespan_ms_cold": makespans[0] * 1e3, "makespan_ms": makespan * 1e3,
              "makespan_ms_warm_min": min(makespans[1:]) * 1e3,
              "makespan_ms_warm_max": max(makespans[1:]) * 1e3,
              "host_run_ms": float(np.median(host_ms[1:])),
              "plain_backend_makespan_ms": plain_exec.last_makespan_s * 1e3,
              "effective_plain_gbps": plain_b / makespan / 1e9,
              "plain_copy_ms": plain_copy_ms,
              "plain_copy_gbps": plain_b / plain_copy_ms / 1e6,
              "launches_per_run": sum(launches_warm.values())}
    for cb in CHUNK_SIZES:
        rec = chunked[f"table2 {mib(cb)}"]
        totals[f"chunked_{mib(cb)}_makespan_ms"] = rec["makespan_ms"]
        totals[f"chunked_{mib(cb)}_host_run_ms"] = rec["host_run_ms"]
        totals[f"chunked_{mib(cb)}_decode_units"] = rec["decode_units_per_run"]
        totals[f"chunked_{mib(cb)}_launches_per_run"] = rec["kernel_launches_per_run"]
    for label, rec in planned.items():
        key = label.replace(" ", "_").replace("-", "_")
        totals[f"planner_{key}_makespan_ms"] = rec["makespan_ms"]
        totals[f"planner_{key}_modeled_ms"] = rec["modeled_makespan_ms"]
        totals[f"planner_{key}_decode_units"] = rec["decode_units_per_run"]
    totals["host_ms_per_added_unit"] = host_per_unit_ms
    print("totals " + " ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                               for k, v in totals.items()))
    kernels = []
    for kname, (source, replaces) in KERNELS.items():
        mine = [r for r in stages if r["kernel"] == kname]
        big = max(mine, key=lambda r: (r["library_ms"] is not None, r["bytes"]))
        ent = max((r for r in entries if r["kernel"] == kname), key=lambda r: r["n"])
        bat = next(r for r in batched if r["kernel"] == kname and r["k"] == 2)
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": err[kname],
            "ms": big["ms"], "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
            "bound_by": big["bound_by"], "library_ms": big["library_ms"],
            "matches_plain": True, "at": f"{big['column']}:{big['stage']}",
            "n": big["n"], "launches_per_run": launches_warm[kname],
            "main_path_ms": sum(r["ms"] for r in mine),
            "main_path_plain_ms": sum(r["plain_ms"] for r in mine),
            "main_path_bound_ms": sum(r["bound_ms"] for r in mine),
            "main_path_profiler_ms": sum(r["profiler_ms"] for r in mine),
            "chunked_launches_per_run": {k: v["launches_per_run"][kname]
                                         for k, v in chunked.items()},
            "entry": {k: ent[k] for k in ("column", "entry", "n", "ms", "whole_n",
                                          "whole_ms", "plain_ms")},
            "batched_entry": {k: bat[k] for k in ("what", "stage", "k", "launches", "n", "ms",
                                                  "singles_ms", "plain_ms", "bound_ms")},
            "batched_splits": {r["k"]: r["launches"] for r in batched if r["kernel"] == kname},
            "planner_launches_per_run": {k: v["launches_per_run"][kname]
                                         for k, v in planned.items()},
            "planner_batched_launches_per_run": {k: v["batched_launches_per_run"][kname]
                                                 for k, v in planned.items()},
            "serve_launches_per_warm_wave": served["warm_wave_launches"][kname],
            "serve_largest_batch": served["largest_batch"][kname],
            "geometry": {k: v for k, v in geometry[kname].items() if k != "by_geometry"},
            "baseline_launches": sum(
                r["launches"] for r in baseline["columns"].values()),
            "baseline_ms_all_columns": baseline["totals"]["ms"],
            "lm_serve_launches": lm["launches"][kname],
            "lm_prompt_wave_launches": lm["wave_launches"][kname],
            "lm_family_launches": {a: r["launches"][kname] for a, r in lm_families.items()},
            "lm_train_launches": lm_train["launches"][kname],
            "mesh_run_launches_per_run": {k: v["kernel_launches"][kname]
                                          for k, v in mesh_run["runs"].items()},
            "mesh_shard_span_launches_per_run": {
                k: v["shard_spans"].get(kname, 0) for k, v in mesh_run["runs"].items()},
            "mesh_mid_column_span_launches_per_run": {
                k: v["mid_column_spans"].get(kname, 0) for k, v in mesh_run["runs"].items()}})
    kernels.append(queries["kernel"])
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"device": name, "stages": stages,
                                        "columns": rows, "totals": totals,
                                        "entries": entries, "chunked": chunked,
                                        "batched": batched,
                                        "planner": planned, "queries": queries["runs"],
                                        "dispatch": served["dispatch"],
                                        "serve": served["serve"],
                                        "wide_queries": wide, "geometry": geometry,
                                        "baseline": baseline, "lm": lm,
                                        "lm_families": lm_families, "lm_train": lm_train,
                                        "lm_roofline": lm_roofline, "mesh": mesh,
                                        "mesh_run": mesh_run,
                                        "kernels": kernels},
                                       indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
