"""Weights carried across from the reference package.

``params_from_reference`` takes the reference's param tree (numpy arrays, or
anything ``np.asarray`` reads, with the layers stacked on axis 0 as its
``lax.scan`` wants them) and returns the port's ``Transformer`` holding
exactly those values, in ``cfg.dtype`` where the reference casts at use.  It
mirrors ``plan.encoded_from_reference`` and never imports the reference; the
tests use it to feed both packages one set of weights.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import Transformer


def _tensors(tree: Mapping[str, Any]) -> dict:
    return {k: _tensors(v) if isinstance(v, Mapping) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


def params_from_reference(params_np: Mapping[str, Any], cfg: ModelConfig,
                          device: torch.device | str = "cpu") -> Transformer:
    tree = _tensors(params_np)
    stacked = tree["layers"]
    layers = [{k: ({kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict) else v[i])
               for k, v in stacked.items()} for i in range(cfg.n_layers)]
    return Transformer(cfg, {"embed": tree["embed"], "layers": layers,
                             "final_norm": tree["final_norm"]}).to(device)
