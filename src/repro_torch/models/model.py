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
  param_specs()                               -- logical specs of the param tree
  state_specs(batch=None)                     -- logical specs of the state
  input_specs(shape) -> (tree of meta tensors, tree of logical specs)

``params`` is the module itself.  ``batch`` is the reference's: ``tokens``
(and ``labels`` for the loss), with ``patch_embeds`` and ``pos3`` for a VLM
(both optional) and ``frames`` for enc-dec.  ``init`` and ``make_state`` put
what they make on the card unless ``device`` says otherwise.

The specs are the reference's, keyed as its trees are (its stacked layers
under ``("stacked", ...)``/``("stacked2", ...)`` markers, so that
``weights.layout`` paths find them); ``launch/mesh.py`` resolves them
against a mesh.  ``input_specs`` gives the reference's
``ShapeDtypeStruct`` stand-ins as tensors on the ``meta`` device (nothing
allocated): tokens for LMs, stub frame embeddings for [audio], stub patch
embeddings + M-RoPE ids for [vlm].
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

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
    param_specs: Callable       # () -> logical specs of the param tree
    state_specs: Callable       # (batch=None) -> logical specs for the state
    input_specs: Callable       # (ShapeConfig) -> (meta tensors, logical specs)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _lm_inputs(cfg: ModelConfig, shape: ShapeConfig):
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"token": _meta((B, 1), torch.int32)}, {"token": ("fsdp", None)}
    shapes = {"tokens": _meta((B, S), torch.int32), "labels": _meta((B, S), torch.int32)}
    specs = {"tokens": ("fsdp", None), "labels": ("fsdp", None)}
    return shapes, specs


def _vlm_inputs(cfg: ModelConfig, shape: ShapeConfig):
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"token": _meta((B, 1), torch.int32)}, {"token": ("fsdp", None)}
    s_img = int(S * cfg.image_frac) // 256 * 256
    s_txt = S - s_img
    shapes = {"tokens": _meta((B, s_txt), torch.int32),
              "labels": _meta((B, s_txt), torch.int32),
              "patch_embeds": _meta((B, s_img, cfg.d_model), cfg.dtype),
              "pos3": _meta((B, 3, S), torch.int32)}
    specs = {"tokens": ("fsdp", None), "labels": ("fsdp", None),
             "patch_embeds": ("fsdp", None, None), "pos3": ("fsdp", None, None)}
    return shapes, specs


def _encdec_inputs(cfg: ModelConfig, shape: ShapeConfig):
    B, S = shape.global_batch, shape.seq_len
    s_tgt = max(S // SRC_RATIO, 128)
    if shape.kind == "decode":
        return {"token": _meta((B, 1), torch.int32)}, {"token": ("fsdp", None)}
    shapes = {"frames": _meta((B, S, cfg.d_model), cfg.dtype),
              "tokens": _meta((B, s_tgt), torch.int32),
              "labels": _meta((B, s_tgt), torch.int32)}
    specs = {"frames": ("fsdp", None, None), "tokens": ("fsdp", None),
             "labels": ("fsdp", None)}
    return shapes, specs


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
                                                                        device=device),
            param_specs=lambda: transformer.param_specs(cfg),
            state_specs=lambda b=None: transformer.cache_specs(cfg),
            input_specs=(lambda s: _vlm_inputs(cfg, s)) if fam == "vlm"
            else (lambda s: _lm_inputs(cfg, s)))
    if fam == "ssm":
        return Model(
            cfg=cfg,
            init=lambda generator=None, device=None, train=False: rwkv.init(
                cfg, generator, device, train),
            train_loss=loss,
            prefill=lambda p, b, st: p.prefill(b["tokens"], st),
            decode_step=step,
            make_state=lambda b, m, device=None: rwkv.init_state(cfg, b, device=device),
            param_specs=lambda: rwkv.param_specs(cfg),
            state_specs=lambda b=None: rwkv.state_specs(cfg),
            input_specs=lambda s: _lm_inputs(cfg, s))
    if fam == "hybrid":
        return Model(
            cfg=cfg,
            init=lambda generator=None, device=None, train=False: zamba.init(
                cfg, generator, device, train),
            train_loss=loss,
            prefill=lambda p, b, st: p.prefill(b["tokens"], st),
            decode_step=step,
            make_state=lambda b, m, device=None: zamba.init_state(cfg, b, m, device=device),
            param_specs=lambda: zamba.param_specs(cfg),
            state_specs=lambda b=None: zamba.state_specs(cfg, batch=b),
            input_specs=lambda s: _lm_inputs(cfg, s))
    if fam == "encdec":
        return Model(
            cfg=cfg,
            init=lambda generator=None, device=None, train=False: encdec.init(
                cfg, generator, device, train),
            train_loss=loss,
            prefill=lambda p, b, st: p.prefill(b["frames"], b["tokens"], st),
            decode_step=step,
            make_state=lambda b, m, device=None: encdec.init_cache(
                cfg, b, m, max(m // SRC_RATIO, 128), device=device),
            param_specs=lambda: encdec.param_specs(cfg),
            state_specs=lambda b=None: encdec.cache_specs(cfg),
            input_specs=lambda s: _encdec_inputs(cfg, s))
    raise ValueError(f"unknown family {fam}")


# --------------------------------------------------------------- shape skip rules

def cell_status(cfg: ModelConfig, shape: ShapeConfig) -> str:
    """'run' or a recorded skip reason (DESIGN.md shape-applicability)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("skip: pure full-attention arch -- O(S^2) prefill and a >TB KV cache "
                "at 524k tokens are not deployable (DESIGN.md)")
    return "run"
