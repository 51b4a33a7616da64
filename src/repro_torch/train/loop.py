"""Fault-tolerant training loop: the reference's ``train/loop.py``.

  * restart-from-latest: the loop resumes from the newest intact checkpoint
    (the atomic LATEST pointer), so any crash and restart converges;
  * periodic and terminal checkpoints with compressed shards
    (``checkpoint.py``), in the reference's layout: the tree
    ``(params, {"mu", "nu", "step"})`` with the layers stacked
    (``state_tree``), so either package restores the other's;
  * straggler detection: a step slower than ``straggler_factor`` x the EMA
    of step times is logged and counted;
  * ``fail_at_step`` injects a failure, to prove restartability.
A step's time ends when its loss is on the host, after a
``torch.cuda.synchronize`` on the card where the reference blocks until
ready.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from repro_torch.models.weights import (from_reference, layout, params_to_reference,
                                       to_reference, whole)
from repro_torch.train import checkpoint as ckpt


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 50
    log_every: int = 10
    straggler_factor: float = 3.0
    fail_at_step: int | None = None  # test hook: simulated crash


class SimulatedFailure(RuntimeError):
    pass


def state_tree(params: nn.Module, opt_state: dict) -> tuple:
    """The training state as the reference's checkpoint tree: numpy arrays
    in its stacked layout, ``step`` an int32 scalar."""
    return (params_to_reference(params),
            {"mu": to_reference(params, opt_state["mu"]),
             "nu": to_reference(params, opt_state["nu"]),
             "step": np.int32(opt_state["step"])})


def state_like(params: nn.Module) -> tuple:
    """``state_tree``'s structure alone, each leaf its path, with no copy of
    a weight: what ``checkpoint.restore`` reads the leaf names from."""
    tree: dict = {}
    for path in layout(params):
        node = tree
        *dirs, leaf = path.split("/")
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = path
    return tree, {"mu": tree, "nu": tree, "step": "step"}


def _placed_like(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t``, whole on every rank, as ``p`` holds it: on its device, and
    split as ``p`` is where ``p`` is a DTensor (each rank keeps its slice)."""
    t = t.to(p.device)
    if not hasattr(p, "device_mesh"):
        return t
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, p.device_mesh, p.placements, src_data_rank=None)


def load_state(params: nn.Module, tree: tuple) -> dict:
    """Copy a checkpoint tree's weights into ``params`` (in place, in each
    parameter's dtype) -> the optimizer state it holds, on their device and
    placed as they are."""
    ptree, otree = tree
    plist = list(params.parameters())
    with torch.no_grad():
        for p, v in zip(plist, from_reference(params, ptree)):
            p.copy_(_placed_like(p, v))
    moments = {k: [_placed_like(p, t.to(torch.float32))
                   for p, t in zip(plist, from_reference(params, otree[k]))]
               for k in ("mu", "nu")}
    return {**moments, "step": int(otree["step"])}


def save_state(ckpt_dir: str, step: int, params: nn.Module, opt_state: dict) -> None:
    """Checkpoint the training state.  Placed on a mesh, every rank gathers
    it whole (``state_tree``) and the mesh's first device alone writes it."""
    tree = state_tree(params, opt_state)
    mesh = getattr(next(params.parameters()), "device_mesh", None)
    if mesh is None or tuple(mesh.get_coordinate() or ()) == (0,) * mesh.ndim:
        ckpt.save(ckpt_dir, step, tree)


def _wait(loss) -> None:
    if torch.is_tensor(loss) and loss.device.type == "cuda":
        torch.cuda.synchronize(loss.device)


def run(loop_cfg: LoopConfig, step_fn: Callable, params: nn.Module, opt_state: dict,
        batch_fn: Callable[[int], Any], log: Callable[[str], None] = print):
    """Run (or resume) training.  ``batch_fn(step)`` must be deterministic in
    step.  Returns (params, opt_state, history)."""
    start_step = 0
    latest = ckpt.latest_step(loop_cfg.ckpt_dir)
    if latest is not None:
        tree, start_step, _ = ckpt.restore(loop_cfg.ckpt_dir, state_like(params))
        opt_state = load_state(params, tree)
        log(f"[loop] resumed from checkpoint step {start_step}")
    history: list[dict] = []
    ema = None
    stragglers = 0
    for step in range(start_step, loop_cfg.total_steps):
        if loop_cfg.fail_at_step is not None and step == loop_cfg.fail_at_step:
            raise SimulatedFailure(f"injected failure at step {step}")
        t0 = time.perf_counter()
        batch = batch_fn(step)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        # placed on a mesh, a metric is a DTensor that may hold partial sums
        metrics = {k: whole(v) if torch.is_tensor(v) else v for k, v in metrics.items()}
        _wait(metrics["loss"])
        dt = time.perf_counter() - t0
        ema = dt if ema is None else 0.9 * ema + 0.1 * dt
        if dt > loop_cfg.straggler_factor * ema and step > start_step + 3:
            stragglers += 1
            log(f"[loop] straggler step {step}: {dt * 1e3:.1f}ms vs EMA "
                f"{ema * 1e3:.1f}ms (count={stragglers})")
        gnorm = metrics.get("grad_norm")
        rec = {"step": step, "loss": float(metrics["loss"]),
               "grad_norm": float("nan") if gnorm is None else float(gnorm), "time_s": dt}
        history.append(rec)
        if step % loop_cfg.log_every == 0:
            log(f"[loop] step {step} loss {rec['loss']:.4f} "
                f"gnorm {rec['grad_norm']:.3f} {dt * 1e3:.0f}ms")
        if (step + 1) % loop_cfg.ckpt_every == 0:
            save_state(loop_cfg.ckpt_dir, step + 1, params, opt_state)
    save_state(loop_cfg.ckpt_dir, loop_cfg.total_steps, params, opt_state)
    return params, opt_state, history
