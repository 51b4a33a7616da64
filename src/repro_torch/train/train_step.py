"""Train-step builders: the reference's ``train/train_step.py``.

``make_train_step`` -- loss -> gradients (autograd) -> AdamW, with per-layer
remat and optional microbatch gradient accumulation; ``make_value_and_grad``
is its loss and gradients alone.  With ``microbatch`` > 1
the batch splits on its first axis into that many equal parts, run one after
another; their losses and gradients accumulate in f32 and are divided by
``microbatch`` before the update, as the reference's ``lax.scan`` does.

``make_dp_compressed_step`` -- data parallelism over a ``DeviceMesh``, one
process per member: gradients and the loss are averaged over the data axes in
full precision and over the ``pod`` axis with the int8 error-feedback wire
format of ``grad_compress.py`` (the paper's compress-the-slow-link thesis
applied to the link between pods), then AdamW runs on every member alike.
"""
from __future__ import annotations

import math
from typing import Callable, Mapping

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import get_model
from repro_torch.models.weights import layout
from repro_torch.train import grad_compress, optimizer
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.remat import get_policy


def _split(batch: Mapping[str, torch.Tensor], k: int) -> list[dict]:
    b = next(iter(batch.values())).shape[0]
    if b % k:
        raise ValueError(f"a batch of {b} does not split into {k} microbatches")
    # a batch placed on a mesh is gathered whole first (a microbatch spans
    # several devices' rows; the model splits it again at its first pin)
    batch = {n: x.full_tensor() if hasattr(x, "full_tensor") else x for n, x in batch.items()}
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


# ------------------------------------------------------- compressed-DP variant

def _mean(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """The members' mean of ``t``: a SUM all-reduce, then a divide (gloo has
    no AVG), as the reference's ``pmean``."""
    from torch.distributed import _functional_collectives as funcol

    return funcol.wait_tensor(funcol.all_reduce(t, "sum", group)) / n


def make_dp_compressed_step(cfg: ModelConfig, opt_cfg: AdamWConfig, device_mesh,
                            pod_axis: str = "pod") -> Callable:
    """Pure data-parallel train step with the int8 cross-pod gradient sync
    -> step(params, opt_state, err, batch) -> (params, opt_state, err,
    metrics).

    One process per member of ``device_mesh``; the parameters and the
    optimizer state are replicated (every member holds and updates them
    alike), ``err`` is this member's error-feedback buffer
    (``grad_compress.init_error_feedback``).  ``batch`` is the global batch:
    each member takes its rows, the batch split over all the mesh's axes in
    their order (the reference's ``P(mesh.axis_names)``).  Gradients and the
    loss are averaged over the intra-pod axes uncompressed and over
    ``pod_axis`` with ``compress_tree``, divided by the pod count; then
    AdamW, as the reference's ``shard_map`` step."""
    model = get_model(cfg)
    names = tuple(device_mesh.mesh_dim_names)
    data_axes = tuple(n for n in names if n != pod_axis)
    coord = device_mesh.get_coordinate()
    if coord is None:
        raise RuntimeError("this process is not a member of the data-parallel mesh")
    sizes = [device_mesh.size(i) for i in range(device_mesh.ndim)]
    members = math.prod(sizes)
    index = 0
    for c, n in zip(coord, sizes):      # row-major position in the mesh
        index = index * n + c
    groups = {n: device_mesh.get_group(n) for n in names}

    def leaves(params: nn.Module) -> list[list[int]]:
        """The parameters' indices by reference leaf: a stacked leaf's
        layers share one quantization scale, as in the reference's tree."""
        index = {id(p): i for i, p in enumerate(params.parameters())}
        return [[index[id(p)] for p in ps] for _, ps in layout(params).values()]

    def step(params: nn.Module, opt_state: dict, err: list, batch: Mapping[str, torch.Tensor]):
        rows = next(iter(batch.values())).shape[0]
        if rows % members:
            raise ValueError(f"a batch of {rows} does not split over {members} members")
        k = rows // members
        local = {n: x[index * k:(index + 1) * k] for n, x in batch.items()}
        plist = list(params.parameters())
        loss = model.train_loss(params, local, None)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(plist, torch.autograd.grad(loss, plist, allow_unused=True))]
        loss = loss.detach()
        # fast intra-pod reduction, full precision
        for ax in data_axes:
            n = device_mesh.size(names.index(ax))
            grads = [_mean(g, groups[ax], n) for g in grads]
            loss = _mean(loss, groups[ax], n)
        # slow cross-pod reduction, int8 + error feedback
        if pod_axis in names:
            n_pods = device_mesh.size(names.index(pod_axis))
            grads, err = grad_compress.compress_tree(grads, err, groups[pod_axis],
                                                     leaves(params))
            grads = [g / n_pods for g in grads]
            loss = _mean(loss, groups[pod_axis], n_pods)
        params, opt_state, diag = optimizer.update(opt_cfg, params, opt_state, grads)
        return params, opt_state, err, {"loss": loss, **diag}

    return step
