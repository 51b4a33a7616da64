"""Uniform model API over all ten configs: the reference's ``models/model.py``.

``get_model(cfg)`` returns a ``Model`` whose members close over the config:
  init(generator=None, device=None, train=False) -> the family's module
      (``Transformer``, ``RWKV``, ``Zamba`` or ``EncDec``); with ``train``
      its weights are f32 parameters that take gradients
  train_loss(params, batch, remat=None)        -- next-token loss (a scalar
      tensor); ``remat`` a policy from ``train.remat.get_policy``
  prefill(params, batch, state) -> (logits, state)
  decode_step(params, token_batch, state) -> (logits, state)
  make_state(batch, max_len, device=None)     -- KV cache or recurrent state

``params`` is the module itself.  ``batch`` is the reference's: ``tokens``
(and ``labels`` for the loss), with ``patch_embeds`` and ``pos3`` for a VLM
(both optional) and ``frames`` for enc-dec.  ``init`` and ``make_state`` put
what they make on the card unless ``device`` says otherwise.  The
reference's ``state_specs``/``input_specs`` (sharding specs and JAX shape
stand-ins) wait for the mesh and the dry run (ROADMAP §1 items 3 and 4).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, rwkv, transformer, zamba
from repro_torch.models.encdec import SRC_RATIO


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    init: Callable              # (generator=None, device=None, train=False) -> module
    train_loss: Callable        # (params, batch, remat=None) -> scalar loss
    prefill: Callable
    decode_step: Callable
    make_state: Callable        # (batch, max_len, device=None) -> cache/recurrent state


def get_model(cfg: ModelConfig) -> Model:
    fam = cfg.family
    step = lambda p, t, st: p.decode_step(t, st)
    loss = lambda p, b, remat=None: p.train_loss(b, remat)
    if fam in transformer.FAMILIES:
        return Model(
            cfg=cfg,
            init=lambda generator=None, device=None, train=False: transformer.init(
                cfg, generator, device, train),
            train_loss=loss,
            prefill=lambda p, b, st: p.prefill(b["tokens"], st, pos3=b.get("pos3"),
                                               prefix_embeds=b.get("patch_embeds")),
            decode_step=step,
            make_state=lambda b, m, device=None: transformer.init_cache(cfg, b, m,
                                                                        device=device))
    if fam == "ssm":
        return Model(
            cfg=cfg,
            init=lambda generator=None, device=None, train=False: rwkv.init(
                cfg, generator, device, train),
            train_loss=loss,
            prefill=lambda p, b, st: p.prefill(b["tokens"], st),
            decode_step=step,
            make_state=lambda b, m, device=None: rwkv.init_state(cfg, b, device=device))
    if fam == "hybrid":
        return Model(
            cfg=cfg,
            init=lambda generator=None, device=None, train=False: zamba.init(
                cfg, generator, device, train),
            train_loss=loss,
            prefill=lambda p, b, st: p.prefill(b["tokens"], st),
            decode_step=step,
            make_state=lambda b, m, device=None: zamba.init_state(cfg, b, m, device=device))
    if fam == "encdec":
        return Model(
            cfg=cfg,
            init=lambda generator=None, device=None, train=False: encdec.init(
                cfg, generator, device, train),
            train_loss=loss,
            prefill=lambda p, b, st: p.prefill(b["frames"], b["tokens"], st),
            decode_step=step,
            make_state=lambda b, m, device=None: encdec.init_cache(
                cfg, b, m, max(m // SRC_RATIO, 128), device=device))
    raise ValueError(f"unknown family {fam}")


# --------------------------------------------------------------- shape skip rules

def cell_status(cfg: ModelConfig, shape: ShapeConfig) -> str:
    """'run' or a recorded skip reason (DESIGN.md shape-applicability)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("skip: pure full-attention arch -- O(S^2) prefill and a >TB KV cache "
                "at 524k tokens are not deployable (DESIGN.md)")
    return "run"
