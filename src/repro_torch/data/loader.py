"""Compressed host->device column pipeline (the paper's end-to-end workflow, Fig. 3).

``ColumnPipeline`` is the user-facing entry point: per-column plans, host encoding
(``compress``) and streamed transfer + decompression on the device (``run``),
transfer of column k+1 overlapping the decode of column k.

It runs on the card unless the caller asks for the CPU: with no ``device`` it
takes ``torch.device("cuda")`` and raises if CUDA is absent.  On a CUDA device
the backend is ``"kernel"`` (the hand-written CUDA kernels, built here, before
any timed run); the plain ``"torch"`` backend runs on the card only when the
caller names it.  On the CPU the backend is ``"torch"``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import plan as plan_mod
from repro_torch.core.executor import ColumnExec, StreamingExecutor
from repro_torch.core.plan import Plan

# the executor's per-column record IS the pipeline's result type
ColumnResult = ColumnExec


class ColumnPipeline:
    """Transfer + decompress a set of columns through the streaming executor
    (whole-column FIFO streaming)."""

    def __init__(self, plans: dict[str, Plan], device: torch.device | str | None = None,
                 backend: str | None = None):
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
        if self.backend == "kernel" and device.type == "cuda":
            from repro_torch.kernels import cuda
            from repro_torch.kernels.fully_parallel import KERNEL as FP
            from repro_torch.kernels.group_parallel import KERNEL as GP
            from repro_torch.kernels.non_parallel import KERNEL as NP

            cuda.build([FP, GP, NP])
            for lib in (FP, GP, NP):
                lib.load()
        self.executor = StreamingExecutor(backend=self.backend, device=device)
        self._encoded: dict[str, plan_mod.Encoded] = {}

    def compress(self, columns: dict[str, np.ndarray]) -> dict[str, float]:
        """Encode each column with its plan on the host and stage it for transfer;
        returns the compression ratios."""
        ratios = {}
        for name, arr in columns.items():
            enc = plan_mod.encode(self.plans[name], arr)
            self._encoded[name] = enc
            self.executor.compile(name, enc)
            ratios[name] = enc.ratio
        return ratios

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

    def run(self, order: list[str] | None = None,
            window: int = 2) -> dict[str, ColumnResult]:
        """Stream + decode the compressed columns (all, or ``order``) in order,
        ``window`` columns in flight."""
        return self.executor.run(order=order, window=window)
