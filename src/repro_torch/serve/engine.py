"""Batched serving engine: prefill + decode with continuous-batching slots, the
reference's ``serve/engine.py`` on one device.

Fixed-slot batch, greedy sampling, slot recycling when a sequence emits EOS or
hits its ``max_new``.  The KV cache has one length for every slot, as the
reference's: admitting a request prefills its slot by running ``decode_step``
over all slots, with token 0 in the others, so a request's output depends on
what is served beside it (ROADMAP §3 R3).  The port keeps that, to give the
reference's results.

Prompts may arrive as ZipFlow-compressed blobs (``submit_compressed``): they
enqueue into a shared ``ServePlanner`` transfer queue, and all prompts pending
at the next admission decode as ONE planned wave through the shared
``StreamingExecutor``/``ProgramCache`` (on the card: kernel 1 for bitpack,
kernel 3 for rANS), so same-structure prompts from different requests share a
program and decode in one batched launch.  The decoded prompt comes back to the
host as numpy int32, as the reference's does.

There is no ``jax.jit``: a prefill is a loop of ``decode_step`` over the prompt
(the reference's ``lax.scan``), everything under ``torch.inference_mode()``.
The engine runs on the card unless ``device="cpu"`` is passed.

It serves every family through the uniform model API: ``params`` is the
family's module, the state its cache or recurrent-state dict.  A recurrent
family's prefill advances the other slots' state too (R3), and an enc-dec
model is served against ``make_state``'s cross memory of zeros (ROADMAP §3
R4): both as in the reference.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import plan as plan_mod
from repro_torch.core.compiler import ProgramCache
from repro_torch.core.executor import StreamingExecutor
from repro_torch.core.serve_planner import ServePlanner
from repro_torch.models import get_model


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new: int = 32
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    # decode-wave failure for THIS request's compressed prompt: surfaced to
    # the submitting caller instead of dying in whatever thread drained
    error: BaseException | None = None


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: nn.Module, batch_slots: int = 4,
                 max_len: int = 512, eos: int = 0,
                 decode_policy: str = "johnson",
                 serve_policy: str = "shared",
                 executor: StreamingExecutor | None = None,
                 device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServeEngine runs on CUDA unless device='cpu' is passed, "
                               "and no CUDA device is available")
        if params.device.type != self.device.type:
            raise ValueError(f"the model's weights are on {params.device}, the engine's "
                             f"device is {self.device}")
        self.cfg = cfg
        self.model = get_model(cfg)
        self.params = params
        self.slots: list[Request | None] = [None] * batch_slots
        self.max_len = max_len
        self.eos = eos
        self.state = self.model.make_state(batch_slots, max_len, device=self.device)
        self._queue: deque[Request] = deque()
        self._requests: list[Request] = []       # everything ever submitted
        self._awaiting_prompt: dict[int, Request] = {}
        # prompt decompression: whole-blob transfer (prompts are small) with a
        # bounded private ProgramCache -- every distinct prompt LENGTH is a
        # distinct structural signature, while within a length operand-lifted
        # meta makes all prompts share one program
        self.executor = executor or StreamingExecutor(
            backend="kernel" if self.device.type == "cuda" else "torch",
            device=self.device, chunk_bytes=None, cache=ProgramCache(max_programs=64),
            policy=decode_policy)
        self.planner = ServePlanner(self.executor, policy=serve_policy)

    def _decode(self, toks: torch.Tensor) -> torch.Tensor:
        logits, self.state = self.model.decode_step(self.params, toks, self.state)
        return logits

    def _prefill(self, toks: torch.Tensor) -> torch.Tensor:
        """toks: (S, n_slots, 1) -- step the state through toks[:-1], return the
        last step's logits.  S >= 1 (empty prompts are guarded out)."""
        for t in toks[:-1]:
            self._decode(t)
        return self._decode(toks[-1])

    @property
    def decode_cache_stats(self) -> dict[str, int]:
        """Prompt-decode ProgramCache counters (hits show cross-request reuse)."""
        return self.executor.cache.stats

    def submit(self, req: Request):
        self._queue.append(req)
        self._requests.append(req)

    def submit_compressed(self, rid: int, enc: plan_mod.Encoded,
                          max_new: int = 32, klass: str = "point") -> Request:
        """Admit a request whose prompt arrives as a compressed blob.

        The blob enqueues into the shared serving planner; it decodes at the
        next admission as part of one planned multi-request wave (the
        returned ``Request``'s ``prompt`` is filled then)."""
        req = Request(rid, np.zeros((0,), np.int32), max_new=max_new)
        self.planner.submit(rid, {"prompt": enc}, klass=klass)
        self._awaiting_prompt[rid] = req
        self._requests.append(req)
        return req

    def _drain_prompts(self):
        """Decode all queued compressed prompts as one shared planned wave.
        A failed wave marks each of its requests done-with-error (the per-
        request exception ``ServePlanner`` attaches) rather than raising out
        of the admission path."""
        if not self.planner.pending:
            return
        for rid, sreq in self.planner.drain().items():
            req = self._awaiting_prompt.pop(int(rid), None)
            if req is None:
                continue
            if sreq.error is not None or "prompt" not in sreq.results:
                req.error = sreq.error or RuntimeError(
                    f"request {rid}: prompt decode produced no result")
                req.done = True
                continue
            req.prompt = sreq.results["prompt"].array.cpu().numpy().astype(
                np.int32).reshape(-1)
            self._queue.append(req)

    @torch.inference_mode()
    def _admit(self):
        self._drain_prompts()
        for i, slot in enumerate(self.slots):
            if slot is None and self._queue:
                req = self._queue.popleft()
                self.slots[i] = req
                if len(req.prompt) == 0:
                    # zero-length prompt: nothing to prefill; greedy start
                    # from uniform logits (argmax -> token 0)
                    req._last_logits = torch.zeros((self.cfg.vocab,), device=self.device)
                    continue
                toks = np.zeros((len(req.prompt), len(self.slots), 1), np.int32)
                toks[:, i, 0] = req.prompt
                logits = self._prefill(torch.from_numpy(toks).to(self.device))
                req._last_logits = logits[i, -1]

    @torch.inference_mode()
    def step(self) -> list[tuple[int, int]]:
        """One decode step for all active slots; returns [(rid, token)]."""
        self._admit()
        if not any(self.slots):
            return []
        toks = np.zeros((len(self.slots), 1), np.int32)
        for i, req in enumerate(self.slots):
            if req is not None and req.out:
                toks[i, 0] = req.out[-1]
            elif req is not None:
                toks[i, 0] = int(torch.argmax(req._last_logits))
        logits = self._decode(torch.from_numpy(toks).to(self.device))
        emitted = []
        best = torch.argmax(logits[:, -1], dim=-1).tolist()
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            tok = best[i]
            req.out.append(tok)
            emitted.append((req.rid, tok))
            if tok == self.eos or len(req.out) >= req.max_new:
                req.done = True
                self.slots[i] = None
        return emitted

    def run_to_completion(self, max_steps: int = 1000) -> dict[int, list[int]]:
        done: dict[int, list[int]] = {}
        all_reqs = list(self._requests)
        for _ in range(max_steps):
            self.step()
            for r in all_reqs:
                if r.done and r.rid not in done:
                    done[r.rid] = r.out
            if (not self._queue and not self._awaiting_prompt
                    and not any(self.slots)):
                break
        return done
