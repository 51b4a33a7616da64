"""ZipFlow compiler: DecodeGraph -> executable decode program.

The pipeline is ``plan.lower_graph`` -> ``fusion.fuse_graph`` -> ``compile_graph``;
programs live in a ``ProgramCache`` keyed by the graph's structure-only signature
and the backend, so structurally identical columns share one program even
when their data-dependent meta differs: programs are *called* with an operand dict
(leaf buffers + lifted meta scalars, ``plan.host_operands`` staged on the device),
never specialized on meta values.

Backends:
  * "kernel" -- the hand-written CUDA kernels of ``repro_torch.kernels`` (the
                card's main path), at each pattern's native geometry;
  * "torch"  -- the plain PyTorch versions (the CPU backend, and the comparison
                the card runs against the kernels).
PyTorch runs eagerly, so a program is the fused stage list and its backend; the
one-time cost of a structure is building the CUDA libraries, done once per
process (``repro_torch.kernels.cuda``).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import fusion as fusion_mod
from repro_torch.core import plan as plan_mod
from repro_torch.core.ir import DecodeGraph
from repro_torch.kernels.ops import BACKENDS, run_stage


@dataclasses.dataclass
class Program:
    """One decode program, shared by every blob with the same signature."""

    graph: DecodeGraph
    backend: str
    calls: int = 0

    @property
    def signature(self) -> str:
        return self.graph.signature

    def __call__(self, bufs: dict[str, torch.Tensor]) -> torch.Tensor:
        """Decode one column from its staged operands (no host sync inside)."""
        self.calls += 1
        env = dict(bufs)
        out = None
        for st in self.graph.stages:
            out = run_stage(st, env, self.backend)
            env[st.out] = out
        return out


def compile_graph(graph: DecodeGraph, backend: str = "torch") -> Program:
    """Compile a DecodeGraph to a Program (no caching -- see ProgramCache)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    return Program(graph=graph, backend=backend)


class ProgramCache:
    """Signature-keyed cache of compiled programs: one program per *structure*.

    The key is (graph signature, backend); everything value-dependent is already
    folded into the signature by the IR layer.
    ``max_programs`` bounds the cache LRU-style (None = unbounded).
    """

    def __init__(self, max_programs: int | None = None):
        self._programs: dict[tuple, Any] = {}   # insertion order = LRU order
        self._lock = threading.Lock()
        self._compiling: dict[tuple, threading.Lock] = {}   # per-key compile guard
        self.max_programs = max_programs
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @property
    def stats(self) -> dict[str, int]:
        with self._lock:
            return {"programs": len(self._programs), "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions}

    def _lookup(self, key: tuple):
        """Under self._lock: hit bookkeeping + LRU refresh."""
        prog = self._programs.get(key)
        if prog is not None:
            self.hits += 1
            if self.max_programs is not None:       # refresh LRU position
                self._programs[key] = self._programs.pop(key)
        return prog

    def _get(self, key: tuple, build: Callable[[], Any]):
        # Double-checked: fast-path lookup under self._lock, then a per-key
        # compile lock, then a re-lookup under self._lock before building, so
        # racing threads build each key exactly once.
        with self._lock:
            prog = self._lookup(key)
            if prog is not None:
                return prog
            key_lock = self._compiling.setdefault(key, threading.Lock())
        with key_lock:
            try:
                with self._lock:
                    prog = self._lookup(key)
                    if prog is not None:
                        return prog
                prog = build()
                with self._lock:
                    self._programs[key] = prog
                    self.misses += 1
                    while (self.max_programs is not None
                           and len(self._programs) > self.max_programs):
                        self._programs.pop(next(iter(self._programs)))
                        self.evictions += 1
            finally:
                with self._lock:
                    self._compiling.pop(key, None)
        return prog

    def get(self, graph: DecodeGraph, backend: str = "torch") -> Program:
        key = (graph.signature, backend)
        return self._get(key, lambda: compile_graph(graph, backend=backend))


def build_graph(enc: plan_mod.Encoded) -> DecodeGraph:
    """Lower + fuse: the front half of the compile pipeline."""
    return fusion_mod.fuse_graph(plan_mod.lower_graph(enc))


def compile_blob(enc: plan_mod.Encoded, backend: str = "torch",
                 cache: ProgramCache | None = None) -> Program:
    """Blob -> cached Program.  Without a ``cache`` the program is built fresh."""
    graph = build_graph(enc)
    if cache is None:
        return compile_graph(graph, backend=backend)
    return cache.get(graph, backend=backend)


# ------------------------------------------------------------- device operands

def device_layout(arr: np.ndarray) -> np.ndarray:
    """A host operand in the 32-bit layout the device works in.

    The reference runs JAX with 64-bit types off, so int64 leaves (zigzag deltas,
    float2int ints, their dictionaries) reach its device as int32, wrapped; the
    port does the same here.  uint32 words travel as an int32 view of the same
    bits, since torch has few uint32 operators."""
    a = np.ascontiguousarray(arr)
    if a.dtype == np.uint32:
        return a.view(np.int32)
    if a.dtype in (np.int64, np.uint64):
        return a.astype(np.int32)
    if a.dtype == np.float64:
        return a.astype(np.float32)
    return a


def device_buffers(enc: plan_mod.Encoded,
                   device: torch.device | str = "cuda") -> dict[str, torch.Tensor]:
    """Move a blob's operands host->device: leaf buffers (the compressed transfer
    itself) plus the lifted meta operands the program consumes at call time."""
    return {k: torch.from_numpy(device_layout(v)).to(device)
            for k, v in plan_mod.host_operands(enc).items()}
