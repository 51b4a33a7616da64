"""Train-step builders: the reference's ``train/train_step.py``.

``make_train_step`` -- loss -> gradients (autograd) -> AdamW, with per-layer
remat and optional microbatch gradient accumulation; ``make_value_and_grad``
is its loss and gradients alone.  With ``microbatch`` > 1
the batch splits on its first axis into that many equal parts, run one after
another; their losses and gradients accumulate in f32 and are divided by
``microbatch`` before the update, as the reference's ``lax.scan`` does.

The reference's ``make_dp_compressed_step`` (data parallelism with the int8
cross-pod gradient sync of ``grad_compress.py``) needs a device mesh and
comes with it (ROADMAP §1 item 3).
"""
from __future__ import annotations

from typing import Callable, Mapping

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import get_model
from repro_torch.train import optimizer
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.remat import get_policy


def _split(batch: Mapping[str, torch.Tensor], k: int) -> list[dict]:
    b = next(iter(batch.values())).shape[0]
    if b % k:
        raise ValueError(f"a batch of {b} does not split into {k} microbatches")
    return [{n: x.reshape(k, b // k, *x.shape[1:])[i] for n, x in batch.items()}
            for i in range(k)]


def make_value_and_grad(cfg: ModelConfig, remat: str | None = "dots",
                        microbatch: int = 1) -> Callable:
    """-> value_and_grad(params, batch) -> (loss, gradients aligned with
    ``params.parameters()``): the train step's loss and gradients, before
    the update; with ``microbatch`` > 1 accumulated in f32 and divided."""
    model = get_model(cfg)
    policy = get_policy(remat)

    def one(params: nn.Module, plist: list, batch) -> tuple:
        loss = model.train_loss(params, batch, policy)
        return loss.detach(), torch.autograd.grad(loss, plist, allow_unused=True)

    def value_and_grad(params: nn.Module, batch: Mapping[str, torch.Tensor]) -> tuple:
        plist = list(params.parameters())
        if not all(p.requires_grad for p in plist):
            raise ValueError("the model's weights take no gradients: build it with "
                             "init(..., train=True) or params_from_reference(..., train=True)")
        if microbatch == 1:
            return one(params, plist, batch)
        loss = torch.zeros((), dtype=torch.float32, device=plist[0].device)
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in plist]
        for mb in _split(batch, microbatch):
            mb_loss, mb_grads = one(params, plist, mb)
            loss = loss + mb_loss
            grads = [acc if g is None else acc + g for acc, g in zip(grads, mb_grads)]
        return loss / microbatch, [g / microbatch for g in grads]

    return value_and_grad


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, remat: str | None = "dots",
                    microbatch: int = 1) -> Callable:
    """-> step(params, opt_state, batch) -> (params, opt_state, metrics);
    ``params`` the family's module with weights that take gradients
    (``init(train=True)``), updated in place."""
    value_and_grad = make_value_and_grad(cfg, remat, microbatch)

    def step(params: nn.Module, opt_state: dict, batch: Mapping[str, torch.Tensor]):
        loss, grads = value_and_grad(params, batch)
        params, opt_state, diag = optimizer.update(opt_cfg, params, opt_state, grads)
        return params, opt_state, {"loss": loss, **diag}

    return step


def make_eval_step(cfg: ModelConfig) -> Callable:
    """-> eval(params, batch) -> the loss, without gradients or remat."""
    model = get_model(cfg)

    def evaluate(params: nn.Module, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        with torch.no_grad():
            return model.train_loss(params, batch, None)

    return evaluate
