"""Uniform model API: the reference's ``models/model.py``, dense family.

``get_model(cfg)`` returns a ``Model`` whose members close over the config:
  init(generator=None, device=None) -> Transformer
  prefill(params, batch, state) -> (logits, state)
  decode_step(params, token_batch, state) -> (logits, state)
  make_state(batch, max_len, device=None)     -- the KV cache

``params`` is the ``Transformer`` itself.  The reference's ``train_loss``
waits for the training port, and ``state_specs``/``input_specs`` (sharding
specs and JAX shape stand-ins) for the mesh and the dry run (ROADMAP §1 items
3 and 4).  The other families raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer

NOT_PORTED = ("moe", "vlm", "ssm", "hybrid", "encdec")


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    init: Callable
    prefill: Callable
    decode_step: Callable
    make_state: Callable        # (batch, max_len, device=None) -> the KV cache


def get_model(cfg: ModelConfig) -> Model:
    fam = cfg.family
    if fam == "dense":
        return Model(
            cfg=cfg,
            init=lambda generator=None, device=None: transformer.init(cfg, generator, device),
            prefill=lambda p, batch, state: p.prefill(batch["tokens"], state),
            decode_step=lambda p, t, st: p.decode_step(t, st),
            make_state=lambda b, m, device=None: transformer.init_cache(cfg, b, m,
                                                                        device=device),
        )
    if fam in NOT_PORTED:
        raise NotImplementedError(f"the {fam} family is not ported yet: ROADMAP §1 item 4, "
                                  "the other families' serving")
    raise ValueError(f"unknown family {fam}")


# --------------------------------------------------------------- shape skip rules

def cell_status(cfg: ModelConfig, shape: ShapeConfig) -> str:
    """'run' or a recorded skip reason (DESIGN.md shape-applicability)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("skip: pure full-attention arch -- O(S^2) prefill and a >TB KV cache "
                "at 524k tokens are not deployable (DESIGN.md)")
    return "run"
