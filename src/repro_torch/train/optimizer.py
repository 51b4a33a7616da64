"""AdamW over a model's parameters: the reference's ``train/optimizer.py``.

The reference maps its update over the leaves of its param tree; here the
leaves are the module's parameters, updated in place under ``no_grad`` (its
f32 master weights from ``init(train=True)``; a bf16 parameter is updated in
f32 and cast back, as the reference casts back to each leaf's dtype).  The
moments ``mu``/``nu`` are f32 tensors aligned with ``params.parameters()``,
``step`` a Python int; they are updated in place as well, so a step holds
one copy of them.  The arithmetic is the reference's, op for op, in f32:
the global-norm clip, bias corrections, and the decoupled weight decay on
every leaf whose *reference* leaf has two dimensions or more -- the reference
stacks a layer's norm scales and biases to (L, D) for its scan, so those are
decayed, and only the unstacked ones (``final_norm``, ``enc_norm``) are not
(``models.weights.layout`` gives each parameter's stacked rank).  The lists
go through ``torch._foreach_*`` in groups of at most ``GROUP_BYTES`` of f32:
a few launches per group, not per tensor, and f32 temporaries of one group's
size at a time.
"""
from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch
from torch import nn

from repro_torch.models.weights import layout

GROUP_BYTES = 1 << 28
_DECAYED: "weakref.WeakKeyDictionary[nn.Module, list[bool]]" = weakref.WeakKeyDictionary()


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup -> cosine decay, in f32 as the reference computes it."""
    f = np.float32
    s = f(step)
    warm = min(s / f(max(cfg.warmup_steps, 1)), f(1.0))
    t = np.clip((s - f(cfg.warmup_steps)) / f(max(cfg.total_steps - cfg.warmup_steps, 1)),
                f(0.0), f(1.0))
    cos = f(cfg.min_lr_frac) + f(1 - cfg.min_lr_frac) * f(0.5) * (f(1) + np.cos(f(np.pi) * t))
    return float(f(cfg.lr) * warm * cos)


def init(params: nn.Module) -> dict:
    zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params.parameters()]
    return {"mu": zeros, "nu": [torch.zeros_like(z) for z in zeros], "step": 0}


def global_norm(tensors) -> torch.Tensor:
    """The f32 L2 norm over every tensor of the list."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.sqrt(torch.sum(torch.square(torch.stack(norms))))


def decayed(params: nn.Module) -> list[bool]:
    """Per parameter: whether the reference decays its leaf (two or more
    dimensions once stacked); worked out once per module."""
    if params not in _DECAYED:
        ndim = {}
        for stack, ps in layout(params).values():
            for p in ps:
                ndim[id(p)] = len(stack) + p.ndim
        _DECAYED[params] = [ndim[id(p)] >= 2 for p in params.parameters()]
    return _DECAYED[params]


def _groups(tensors: list[torch.Tensor]) -> list[list[int]]:
    """Consecutive indices into ``tensors``, at most ``GROUP_BYTES`` of f32
    a group (a larger tensor alone)."""
    out, size = [[]], 0
    for i, t in enumerate(tensors):
        if out[-1] and size + 4 * t.numel() > GROUP_BYTES:
            out.append([])
            size = 0
        out[-1].append(i)
        size += 4 * t.numel()
    return [g for g in out if g]


def update(cfg: AdamWConfig, params: nn.Module, opt_state: dict, grads):
    """-> (params, opt_state, diagnostics); ``grads`` aligned with
    ``params.parameters()`` (None for a parameter the loss does not reach:
    a zero gradient, as the reference's).  The parameters and the moments
    are updated in place."""
    plist = list(params.parameters())
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(plist, grads)]
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
             if cfg.grad_clip else None)
    lr = schedule(cfg, step)
    f = np.float32
    bc1 = float(f(1) - f(cfg.b1) ** f(step))
    bc2 = float(f(1) - f(cfg.b2) ** f(step))
    decay = decayed(params) if cfg.weight_decay else [False] * len(plist)
    with torch.no_grad():
        for idx in _groups(plist):
            ps = [plist[i] for i in idx]
            mu = [opt_state["mu"][i] for i in idx]
            nu = [opt_state["nu"][i] for i in idx]
            g = [grads[i].float() for i in idx]
            if scale is not None:
                g = torch._foreach_mul(g, scale)
            torch._foreach_mul_(mu, cfg.b1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1 - cfg.b1))
            torch._foreach_mul_(nu, cfg.b2)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - cfg.b2))
            del g
            den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(den, cfg.eps)
            delta = torch._foreach_div(torch._foreach_div(mu, bc1), den)
            del den
            p32 = [p.float() for p in ps]
            dec = [j for j, i in enumerate(idx) if decay[i]]
            if dec:
                torch._foreach_add_([delta[j] for j in dec],
                                    torch._foreach_mul([p32[j] for j in dec], cfg.weight_decay))
            new = torch._foreach_sub(p32, torch._foreach_mul(delta, lr))
            for p, n in zip(ps, new):
                p.copy_(n)
    return params, {**opt_state, "step": step}, {"grad_norm": gnorm, "lr": lr}
