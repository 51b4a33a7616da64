"""Compressed host->device data pipeline (the paper's end-to-end workflow, Fig. 3).

``CompressedTokenLoader`` feeds LM training: token batches cross the link
bit-packed at ``ceil(log2 vocab)`` bits with a fixed width, so every step's
words have one shape and one decode program, and are unpacked on the device
by the Fully-Parallel kernel (kernel 1).

``ColumnPipeline`` is the user-facing entry point: per-column plans, host encoding
(``compress``), planning (``plan``) and streamed transfer + decompression on the
device (``run``), transfer of one decode unit overlapping the decode of another;
and decode-fused queries over the registered columns (``lower_query``,
``query_plan``, ``run_query``), where only partial aggregates reach the device's
memory; and serving (``serve_planner``): many requests' columns decoded in
shared waves (``core/serve_planner.py``); and mesh plans (``mesh_plan``):
which of N devices each column, or group-span shard of a large column,
streams to and decodes on (``core/planner.py plan_mesh_execution``), run by
``run_sharded``.

It runs on the card unless the caller asks for the CPU: with no ``device`` it
takes ``torch.device("cuda")`` and raises if CUDA is absent.  On a CUDA device
the backend is ``"kernel"`` (the hand-written CUDA kernels, built and loaded on
the device by the executor at construction, before any timed run); the plain
``"torch"`` backend runs on the card only when the caller names it.  On the CPU
the backend is ``"torch"``.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.algos.bitpack import pack_np
from repro_torch.core import plan as plan_mod
from repro_torch.core import scheduler
from repro_torch.core.compiler import compile_blob, device_buffers
from repro_torch.core.executor import (ColumnExec, MeshRunResult, QueryExec,
                                       StreamingExecutor)
from repro_torch.core.plan import Plan
from repro_torch.core.planner import ExecutionPlan, MeshExecutionPlan, plan_mesh_execution
from repro_torch.core.serve_planner import ServePlanner

# the executor's per-column record IS the pipeline's result type
ColumnResult = ColumnExec


def _device(device) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the loader runs on CUDA by default and no CUDA device is "
                           "available; pass device='cpu' to unpack on the host")
    return device


# ------------------------------------------------------------- training loader

class CompressedTokenLoader:
    """A token source moved host->device bit-packed at a fixed width.

    ``source(step)`` gives a (batch, seq_len + 1) int array, deterministic in
    ``step`` (a restarted run sees the same batches); the default draws
    uniform tokens from ``numpy.random.default_rng(step)``, as the
    reference's.  ``encode_host`` packs a step's tokens into the reference's
    words (``pack_np``); ``to_device`` moves them and the blob's meta
    operands to ``device`` (the card unless given); ``decode_fn(backend)``
    returns the device side, unpacking the words with kernel 1 (``"kernel"``;
    its plain version when the words are on the CPU) or with the plain
    version (``"torch"``) into ``tokens``/``labels`` (int32, shifted by one).
    ``bytes_plain``/``bytes_compressed`` count what ``encode_host`` packed."""

    def __init__(self, vocab: int, batch: int, seq_len: int,
                 source: Callable[[int], np.ndarray] | None = None, device=None):
        self.vocab = vocab
        self.batch = batch
        self.seq = seq_len
        self.bits = max(1, math.ceil(math.log2(max(vocab, 2))))
        self.device = _device(device)
        self._source = source or self._synthetic
        self.bytes_plain = 0
        self.bytes_compressed = 0

    def _synthetic(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(step)
        return rng.integers(0, self.vocab, (self.batch, self.seq + 1), dtype=np.int32)

    @property
    def n(self) -> int:
        return self.batch * (self.seq + 1)

    def encode_host(self, step: int) -> dict[str, np.ndarray]:
        """Host side: the step's tokens -> fixed-shape packed words."""
        toks = self._source(step)
        packed = pack_np(toks.reshape(-1).astype(np.int64), self.bits)
        self.bytes_plain += toks.nbytes
        self.bytes_compressed += packed.nbytes
        return {"packed": packed}

    def blob(self, packed: np.ndarray) -> plan_mod.Encoded:
        """The words as a bitpack blob of the batch's int32 tokens."""
        return plan_mod.Encoded(codec="bitpack", meta={"bit_width": self.bits, "base": 0},
                                buffers={"packed": packed}, children={}, n=self.n,
                                dtype=np.dtype(np.int32))

    def to_device(self, host: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        """The transfer: the words and the blob's meta operands on the device."""
        return device_buffers(self.blob(host["packed"]), self.device)

    def decode_fn(self, backend: str = "kernel") -> Callable:
        """The device side: device operands -> {tokens, labels}, one launch
        of the decode program a step (its structure is the same every
        step)."""
        words = (self.n * self.bits + 31) // 32 + 1
        prog = compile_blob(self.blob(np.zeros(words, np.uint32)), backend=backend)
        B, S = self.batch, self.seq

        def decode(bufs: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
            toks = prog(bufs).reshape(B, S + 1)
            return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

        return decode

    def batches(self, start_step: int = 0) -> Iterator[dict[str, torch.Tensor]]:
        step = start_step
        while True:
            yield self.to_device(self.encode_host(step))
            step += 1

    @property
    def ratio(self) -> float:
        return self.bytes_plain / max(self.bytes_compressed, 1)


# ------------------------------------------------------------ analytics pipeline


class ColumnPipeline:
    """Transfer + decompress a set of columns through the streaming executor.

    Columns flow Plan -> DecodeGraph -> ProgramCache -> planner ->
    StreamingExecutor, as in the reference: every scheduling decision (issue
    order, per-column chunk size, decode mode, window) comes from an
    ``ExecutionPlan`` built by ``core/planner.py`` under ``policy`` ("fifo",
    "johnson", "chunk-johnson", or "adaptive", with ``chunk_bytes="auto"`` for
    per-column sizing), and with ``batch_columns`` columns of one structure
    decode in one batched launch per stage.  The defaults are the reference's:
    ``policy="chunk-johnson"``, 1 MiB transfer chunks, whole decode, batching
    on.  ``chunk_bytes=None`` moves each column in one copy; ``chunk_decode=True``
    also decodes each chunk (element chunk or span of whole groups) of a column
    that splits in its own launch while later chunks are in flight;
    ``pipeline=False`` keeps the order of registration.  ``cost_model`` (e.g.
    ``CostModel.load``) seeds planning from an earlier process's calibration;
    each run's measurements feed it.  ``async_dispatch=True`` issues each run's
    copies from a transfer thread (``core.executor.DispatchEngine``).
    ``fuse=False`` decodes the unfused graphs.  ``mesh=N`` sets the device
    count ``mesh_plan`` plans over, and ``placement="sharded"`` pins shard
    ``i`` of every sharded column to its final device ``i``, so that the
    planner may land its bytes elsewhere and move them over a D2D fabric.
    An ``executor`` passed in wins
    over every executor setting here (device, backend, chunking, policy,
    fusion), as in the reference; the pipeline mirrors its configuration."""

    def __init__(self, plans: dict[str, Plan], device: torch.device | str | None = None,
                 backend: str | None = None, chunk_bytes: int | None | str = 1 << 20,
                 chunk_decode: bool = False, policy: str = "chunk-johnson",
                 pipeline: bool = True, batch_columns: bool = True, cost_model=None,
                 async_dispatch: bool = False, fuse: bool = True,
                 executor: StreamingExecutor | None = None, mesh: int | None = None,
                 placement: str | None = None):
        if executor is not None:
            device = executor.device
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ColumnPipeline runs on CUDA by default and no CUDA "
                               "device is available; pass device='cpu' to run the "
                               "plain PyTorch versions on the host")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.plans = plans
        self.device = device
        self.mesh = mesh
        self.placement = placement
        self.executor = executor or StreamingExecutor(
            backend=backend or ("kernel" if device.type == "cuda" else "torch"),
            device=device, chunk_bytes=chunk_bytes, chunk_decode=chunk_decode,
            policy=policy, pipeline=pipeline, batch_columns=batch_columns,
            cost_model=cost_model, async_dispatch=async_dispatch, fuse=fuse)
        # the effective configuration (a passed executor wins)
        self.backend = self.executor.backend
        self.fuse = self.executor.fuse
        self.async_dispatch = self.executor.async_dispatch
        self._encoded: dict[str, plan_mod.Encoded] = {}
        # lowered fused queries and their planned (window, chunk_bytes), keyed
        # by QueryPlan digest (``load`` invalidates: new blobs lower anew)
        self._queries: dict[str, tuple] = {}
        self._query_cfg: dict[str, tuple[int, int | None]] = {}

    def compress(self, columns: dict[str, np.ndarray]) -> dict[str, float]:
        """Encode each column with its plan on the host and stage it for transfer;
        returns the compression ratios."""
        ratios = {}
        for name, arr in columns.items():
            enc = plan_mod.encode(self.plans[name], arr)
            self.load({name: enc})
            ratios[name] = enc.ratio
        return ratios

    def load(self, encoded: dict[str, plan_mod.Encoded]) -> None:
        """Stage blobs encoded earlier (by another pipeline's ``compress``, or
        read back from storage) for transfer, without encoding them again."""
        for name, enc in encoded.items():
            self._encoded[name] = enc
            self.executor.compile(name, enc)
        self._queries.clear()
        self._query_cfg.clear()

    def encoded(self, name: str) -> plan_mod.Encoded:
        return self._encoded[name]

    @property
    def cache_stats(self) -> dict[str, int]:
        """ProgramCache counters: how many distinct programs served the columns."""
        return self.executor.cache.stats

    @property
    def makespan_s(self) -> float | None:
        """Wall time of the last ``run`` on the device (CUDA events on a GPU)."""
        return self.executor.last_makespan_s

    def plan(self, policy: str | None = None, **kw) -> ExecutionPlan:
        """An ``ExecutionPlan`` over the registered columns: from measured
        timings once a ``run`` has fed the cost model, from its calibrated chip
        model before.  Keywords pass through to ``StreamingExecutor.plan``
        (``chunk_bytes="auto"`` sizes each column's chunks)."""
        return self.executor.plan(list(self._encoded), policy=policy, **kw)

    def run(self, order: list[str] | None = None, plan: ExecutionPlan | None = None,
            window: int | None = None) -> dict[str, ColumnResult]:
        """Stream + decode the compressed columns under ``plan`` (built from the
        configured policy unless given); an explicit ``order`` pins the issue
        order, and ``window`` overrides the plan's decode units in flight."""
        return self.executor.run(order=order, plan=plan, window=window)

    def mesh_plan(self, n_devices: int | None = None, **kw) -> MeshExecutionPlan:
        """A ``MeshExecutionPlan`` over the registered columns
        (``planner.plan_mesh_execution``): whole columns, and group-span
        shards of large ones, assigned to ``n_devices`` links so that the
        modeled ``simulate_stream_multi`` makespan is <= round-robin's and
        one device's.  ``n_devices`` defaults to the constructor's ``mesh``,
        else to the CUDA devices visible for a CUDA pipeline and 1 for a CPU
        one.  Keywords pass through to ``plan_mesh_execution``."""
        n = n_devices if n_devices is not None else self.mesh
        if n is None:
            n = torch.cuda.device_count() if self.device.type == "cuda" else 1
        profiles = {name: self.executor.column_profile(name) for name in self._encoded}
        kw.setdefault("chunk_bytes", self.executor.chunk_bytes)
        kw.setdefault("policy", self.executor.policy)
        kw.setdefault("placement", self.placement)
        return plan_mesh_execution(profiles, self.executor.cost_model, n_devices=n, **kw)

    def run_sharded(self, n_devices: int | None = None, plan: MeshExecutionPlan | None = None,
                    concurrent: bool | None = None) -> MeshRunResult:
        """Execute the registered columns over a device mesh: ``plan`` (the
        ``mesh_plan(n_devices)`` by default) through
        ``StreamingExecutor.run_sharded``, each logical device's leg on the
        physical device ``devices[id % len(devices)]``, its legs issued
        together unless ``concurrent=False``.  Returns the
        ``MeshRunResult``."""
        if plan is None:
            plan = self.mesh_plan(n_devices)
        return self.executor.run_sharded(plan, self._encoded, concurrent=concurrent)

    def _measure(self, name: str) -> tuple[float, float]:
        """The column's (transfer_s, decode_s) for scheduling: the executor's
        from its latest run, else measured once here -- one copy of its
        operands to the device and one decode by its program (host clock
        around a synchronized device) -- and fed to the cost model."""
        timings = self.executor.timings
        if name not in timings:
            cuda = self.device.type == "cuda"
            enc = self._encoded[name]
            prog = self.executor.program(name)
            t0 = time.perf_counter()
            bufs = device_buffers(enc, self.device)
            if cuda:
                torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
            prog(bufs)
            if cuda:
                torch.cuda.synchronize(self.device)
            self.executor.cost_model.observe(name, t1 - t0, time.perf_counter() - t1)
        return timings[name]

    def modeled_makespan(self, pipeline: bool = True, johnson: bool = True,
                         chunked: bool = False) -> float:
        """Two-machine flow-shop makespan from the columns' times (chunk-level
        jobs when ``chunked``); measures each column at most once, ever."""
        names = list(self._encoded)
        for n in names:
            self._measure(n)
        return self.executor.modeled_makespan(names=names, pipeline=pipeline,
                                              johnson=johnson, chunked=chunked)

    def serve_planner(self, policy: str = "shared", max_wave: int | None = None,
                      mesh: int | None = None):
        """A multi-query serving planner sharing this pipeline's executor (its
        ProgramCache and calibrated CostModel): concurrent requests' columns
        compose into one shared transfer queue, with cross-request batching and
        SLO-aware issue order (``core/serve_planner.py``); with ``mesh`` (the
        constructor's by default) each wave spans that many devices, under the
        constructor's ``placement``.  Requests submit their own ``Encoded``
        blobs; ``encode_request`` builds them."""
        return ServePlanner(self.executor, policy=policy, max_wave=max_wave,
                            mesh=mesh if mesh is not None else self.mesh,
                            placement=self.placement)

    def encode_request(self, columns: dict[str, np.ndarray]) -> dict[str, plan_mod.Encoded]:
        """A request's columns encoded with this pipeline's plans (the blobs
        ``ServePlanner.submit`` takes)."""
        return {name: plan_mod.encode(self.plans[name], arr) for name, arr in columns.items()}

    def lower_query(self, qplan):
        """Graft a ``core.query.QueryPlan`` onto the registered columns' decode
        graphs: ``(FusedQuery, encs)``, the blobs those ``compress`` built.
        Memoised by query digest (``compress``/``load`` invalidate), so warm
        ``run_query`` calls measure execution, not lowering.  On a card the
        query's kernel is generated, built (``nvcc``, ~3 s the first time a
        program is met; ``build/`` keeps it) and loaded here."""
        key = qplan.digest()
        hit = self._queries.get(key)
        if hit is None:
            from repro_torch.core.query import lower_query

            encs = {c: self._encoded[c] for c in qplan.columns()}
            hit = (lower_query(qplan, encs), encs)
            self.executor.prepare_query(hit[0])
            self._queries[key] = hit
        return hit

    def query_plan(self, qplan, **kw) -> ExecutionPlan:
        """``ExecutionPlan`` for a pending query: per column, fused or
        materialized as the cost model's selectivity-aware fused estimate
        decides (``plan.explain()`` shows ``mode=...+fused sel=...`` rows)."""
        fq, encs = self.lower_query(qplan)
        return self.executor.plan(list(encs), fused_columns={c: None for c in fq.fused_cols},
                                  **kw)

    def run_query(self, qplan, window: int | None = None) -> QueryExec:
        """Decode-fused query execution (late materialization): the fused
        columns stream through per-chunk scan-filter-aggregate launches; only
        partial aggregates reach device memory.  The window and the row-chunk
        count come from the cost model (memoised per query digest): the fused
        columns form one shared-schedule job, and the chunk count is chosen by
        ``simulate_stream`` over 1, 2, 4 and 8 chunks, each extra launch priced
        at the calibrated overhead -- on the CPU, where copies and decode share
        the cores, this is one launch.  A fixed integer ``chunk_bytes``
        overrides the search, as in ``run``."""
        fq, encs = self.lower_query(qplan)
        key = qplan.digest()
        cfg = self._query_cfg.get(key)
        if cfg is None:
            ep = self.query_plan(qplan)     # registers profiles for all columns
            if isinstance(self.executor.chunk_bytes, int):
                cb = self.executor.chunk_bytes       # fixed size: the caller's
            else:
                cm = self.executor.cost_model
                t_tr = d_fused = oh = 0.0
                for c in fq.fused_cols:
                    t_tr += cm.predict(c)[0]
                    d_fused += cm.fused_decode_s(c)
                    oh = max(oh, cm.launch_overhead_s(c))
                # the reference asks JAX whether the host is the device
                # (``serial_host``): one resource, no transfer/decode overlap
                serial = self.executor.device.type == "cpu"
                best_k, best_t = 1, None
                for k in (1, 2, 4, 8):
                    if serial:
                        mk = t_tr + d_fused + (k - 1) * oh
                    else:
                        mk = scheduler.simulate_stream(
                            [scheduler.Job(qplan.name, t_tr, d_fused)],
                            [scheduler.ChunkInfo(n_chunks=k, chunk_decode=k > 1,
                                                 launch_overhead_s=oh)],
                            window=ep.window)
                    if best_t is None or mk < best_t - 1e-12:
                        best_k, best_t = k, mk
                comp = sum(self._encoded[c].compressed_nbytes for c in fq.fused_cols)
                cb = None if best_k == 1 else -(-comp // best_k)
            cfg = (ep.window, cb)
            self._query_cfg[key] = cfg
        win, cb = cfg
        if window is not None:
            win = window
        return self.executor.run_query(fq, encs, chunk_bytes=cb, window=win)
