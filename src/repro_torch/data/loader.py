"""Compressed host->device column pipeline (the paper's end-to-end workflow, Fig. 3).

``ColumnPipeline`` is the user-facing entry point: per-column plans, host encoding
(``compress``), planning (``plan``) and streamed transfer + decompression on the
device (``run``), transfer of one decode unit overlapping the decode of another;
and decode-fused queries over the registered columns (``lower_query``,
``query_plan``, ``run_query``), where only partial aggregates reach the device's
memory.

It runs on the card unless the caller asks for the CPU: with no ``device`` it
takes ``torch.device("cuda")`` and raises if CUDA is absent.  On a CUDA device
the backend is ``"kernel"`` (the hand-written CUDA kernels, built and loaded on
the device by the executor at construction, before any timed run); the plain
``"torch"`` backend runs on the card only when the caller names it.  On the CPU
the backend is ``"torch"``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import plan as plan_mod
from repro_torch.core import scheduler
from repro_torch.core.executor import ColumnExec, QueryExec, StreamingExecutor
from repro_torch.core.plan import Plan
from repro_torch.core.planner import ExecutionPlan

# the executor's per-column record IS the pipeline's result type
ColumnResult = ColumnExec


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
    each run's measurements feed it."""

    def __init__(self, plans: dict[str, Plan], device: torch.device | str | None = None,
                 backend: str | None = None, chunk_bytes: int | None | str = 1 << 20,
                 chunk_decode: bool = False, policy: str = "chunk-johnson",
                 pipeline: bool = True, batch_columns: bool = True, cost_model=None):
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ColumnPipeline runs on CUDA by default and no CUDA "
                               "device is available; pass device='cpu' to run the "
                               "plain PyTorch versions on the host")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.plans = plans
        self.device = device
        self.backend = backend or ("kernel" if device.type == "cuda" else "torch")
        self.executor = StreamingExecutor(
            backend=self.backend, device=device, chunk_bytes=chunk_bytes,
            chunk_decode=chunk_decode, policy=policy, pipeline=pipeline,
            batch_columns=batch_columns, cost_model=cost_model)
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

    def lower_query(self, qplan):
        """Graft a ``core.query.QueryPlan`` onto the registered columns' decode
        graphs: ``(FusedQuery, encs)``, the blobs those ``compress`` built.
        Memoised by query digest (``compress``/``load`` invalidate), so warm
        ``run_query`` calls measure execution, not lowering."""
        key = qplan.digest()
        hit = self._queries.get(key)
        if hit is None:
            from repro_torch.core.query import lower_query

            encs = {c: self._encoded[c] for c in qplan.columns()}
            hit = (lower_query(qplan, encs), encs)
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
