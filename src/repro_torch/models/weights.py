"""Weights carried across from and to the reference package's layout.

``params_from_reference`` takes the reference's param tree (numpy arrays, or
anything ``np.asarray`` reads, with the layers stacked on axis 0 as its
``lax.scan`` wants them -- twice for Zamba's ``mamba_main``) and returns the
family's module (``Transformer``, ``RWKV``, ``Zamba`` or ``EncDec``) holding
exactly those values, in ``cfg.dtype`` where the reference casts at use and
in f32 where it reads f32 -- or, with ``train``, every weight in f32 taking
gradients (``LM.trainable``).  It mirrors ``plan.encoded_from_reference`` and
never imports the reference; the tests use it to feed both packages one set
of weights.  The module lands on the card unless ``device`` says otherwise.

``params_to_reference`` is its inverse: the module's weights as the
reference's stacked tree of numpy arrays (f32 where the module holds bf16, a
widening that loses nothing).  ``layout`` says where each of the module's
parameters sits in that tree; with it ``to_reference``/``from_reference``
move any per-parameter tensors (gradients, AdamW's moments) to and from the
reference's leaves, which is how a checkpoint names them and how AdamW finds
a leaf's stacked rank.  ``meta_tree`` gives that tree's shapes alone, as
tensors on the ``meta`` device: what the dry run resolves the logical specs
against.
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
                          device: torch.device | str | None = None,
                          train: bool = False) -> nn.Module:
    device = L.resolve_device(device)
    tree = _tensors(params_np)
    common = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    fam = cfg.family
    build = (lambda cls, p: cls.trainable(cfg, p)) if train else (lambda cls, p: cls(cfg, p))
    if fam in FAMILIES or fam == "ssm":
        cls = Transformer if fam in FAMILIES else RWKV
        model = build(cls, {**common, "layers": _unstack(tree["layers"], cfg.n_layers)})
    elif fam == "hybrid":
        n_super, k, tail = _split(cfg)
        main = _unstack(tree["mamba_main"], n_super)
        model = build(Zamba, {**common, "mamba_main": [_unstack(g, k) for g in main],
                              "mamba_tail": _unstack(tree["mamba_tail"], max(tail, 1)),
                              "shared": tree["shared"]})
    elif fam == "encdec":
        model = build(EncDec, {**common, "enc": _unstack(tree["enc"], cfg.enc_layers),
                               "dec": _unstack(tree["dec"], cfg.dec_layers),
                               "enc_norm": tree["enc_norm"]})
    else:
        raise ValueError(f"unknown family {fam}")
    return model.to(device)


def layout(model: nn.Module) -> dict[str, tuple[tuple[int, ...], list[nn.Parameter]]]:
    """Each leaf of the reference's tree, by its path ("layers/attn/wq") ->
    (its stack's shape, the module's parameters stacked into it in order):
    ``(cfg.n_layers,)`` for a layer's weight, ``(n_super, attn_every)`` for
    Zamba's ``mamba_main``, ``()`` for one that is not stacked."""
    return _layout(model.tree())


def _layout(t) -> dict[str, tuple[tuple[int, ...], list]]:
    if isinstance(t, Mapping):
        return {f"{k}/{p}" if p else k: v for k, sub in t.items()
                for p, v in _layout(sub).items()}
    if not isinstance(t, (list, tuple)):
        return {"": ((), [t])}
    items = [_layout(x) for x in t]
    out = {}
    for path in items[0]:
        stacks = {it[path][0] for it in items}
        if len(stacks) != 1:
            raise ValueError(f"{path}: stacked layers of unequal structure")
        out[path] = ((len(t), *stacks.pop()), [p for it in items for p in it[path][1]])
    return out


def meta_tree(model: nn.Module, dtype: torch.dtype | None = None) -> dict:
    """The reference's nested tree of the module's weights as ``meta``
    tensors (stacked shapes, nothing allocated), each in ``dtype`` or its
    parameter's."""
    tree: dict = {}
    for path, (stack, params) in layout(model).items():
        node = tree
        *dirs, leaf = path.split("/")
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = torch.empty((*stack, *params[0].shape), dtype=dtype or params[0].dtype,
                                 device="meta")
    return tree


def whole(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a plain tensor of its global shape: a DTensor gathered from
    its mesh (a collective: every rank of the mesh calls it), any other
    tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def to_reference(model: nn.Module, tensors) -> dict:
    """Tensors aligned with ``model.parameters()`` (its gradients, AdamW's
    moments, its weights) -> the reference's nested tree of stacked numpy
    arrays; bf16 is widened to f32.  Placed tensors (DTensors) are gathered
    whole, so every rank of their mesh calls it."""
    index = {id(p): i for i, p in enumerate(model.parameters())}
    tensors = list(tensors)
    tree: dict = {}
    for path, (stack, params) in layout(model).items():
        parts = [whole(tensors[index[id(p)]].detach()) for p in params]
        arr = (torch.stack(parts) if stack else parts[0]).to("cpu", copy=True)
        if arr.dtype == torch.bfloat16:
            arr = arr.float()
        node = tree
        *dirs, leaf = path.split("/")
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = arr.numpy().reshape(*stack, *params[0].shape)
    return tree


def from_reference(model: nn.Module, tree: Mapping[str, Any]) -> list[torch.Tensor]:
    """The reference's nested tree (numpy arrays or tensors) -> tensors
    aligned with ``model.parameters()``, each of its parameter's shape, in
    the leaf's dtype (a numpy leaf on the CPU)."""
    by_id = {}
    for path, (stack, params) in layout(model).items():
        node = tree
        for d in path.split("/"):
            node = node[d]
        leaf = node if torch.is_tensor(node) else torch.from_numpy(np.array(node))
        want = (*stack, *params[0].shape)
        if tuple(leaf.shape) != want:
            raise ValueError(f"{path}: shape {tuple(leaf.shape)}, the model's is {want}")
        for p, t in zip(params, leaf.reshape(-1, *params[0].shape)):
            by_id[id(p)] = t
    return [by_id[id(p)] for p in model.parameters()]


def params_to_reference(model: nn.Module) -> dict:
    """The module's weights as the reference's param tree: numpy arrays with
    the layers stacked (the inverse of ``params_from_reference``)."""
    return to_reference(model, model.parameters())
