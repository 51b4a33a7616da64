"""Weights carried across from the reference package.

``params_from_reference`` takes the reference's param tree (numpy arrays, or
anything ``np.asarray`` reads, with the layers stacked on axis 0 as its
``lax.scan`` wants them -- twice for Zamba's ``mamba_main``) and returns the
family's module (``Transformer``, ``RWKV``, ``Zamba`` or ``EncDec``) holding
exactly those values, in ``cfg.dtype`` where the reference casts at use and
in f32 where it reads f32.  It mirrors ``plan.encoded_from_reference`` and
never imports the reference; the tests use it to feed both packages one set
of weights.  The module lands on the card unless ``device`` says otherwise.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.encdec import EncDec
from repro_torch.models.rwkv import RWKV
from repro_torch.models.transformer import FAMILIES, Transformer
from repro_torch.models.zamba import Zamba, _split


def _tensors(tree: Mapping[str, Any]) -> dict:
    return {k: _tensors(v) if isinstance(v, Mapping) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


def _unstack(tree: Mapping[str, Any], n: int) -> list[dict]:
    """A tree of stacked leaves -> its n slices along axis 0."""
    if any(v.shape[0] != n for v in _leaves(tree)):
        raise ValueError(f"a stacked tree without {n} layers")
    return [_index(tree, i) for i in range(n)]


def _index(tree: Mapping[str, Any], i: int) -> dict:
    return {k: _index(v, i) if isinstance(v, Mapping) else v[i] for k, v in tree.items()}


def _leaves(tree: Mapping[str, Any]):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, Mapping) else (v,)


def params_from_reference(params_np: Mapping[str, Any], cfg: ModelConfig,
                          device: torch.device | str | None = None) -> nn.Module:
    device = L.resolve_device(device)
    tree = _tensors(params_np)
    common = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    fam = cfg.family
    if fam in FAMILIES or fam == "ssm":
        cls = Transformer if fam in FAMILIES else RWKV
        model = cls(cfg, {**common, "layers": _unstack(tree["layers"], cfg.n_layers)})
    elif fam == "hybrid":
        n_super, k, tail = _split(cfg)
        main = _unstack(tree["mamba_main"], n_super)
        model = Zamba(cfg, {**common, "mamba_main": [_unstack(g, k) for g in main],
                            "mamba_tail": _unstack(tree["mamba_tail"], max(tail, 1)),
                            "shared": tree["shared"]})
    elif fam == "encdec":
        model = EncDec(cfg, {**common, "enc": _unstack(tree["enc"], cfg.enc_layers),
                             "dec": _unstack(tree["dec"], cfg.dec_layers),
                             "enc_norm": tree["enc_norm"]})
    else:
        raise ValueError(f"unknown family {fam}")
    return model.to(device)
