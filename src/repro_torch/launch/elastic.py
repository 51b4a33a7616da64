"""Elastic scaling: re-mesh and reshard after a node failure, the reference's
``launch/elastic.py``.

On a real cluster the coordinator detects a dead host (heartbeat timeout or
the straggler signal of ``train/loop.py``), evicts its slice, and restarts
the job on the survivors.  The pieces:

  * ``plan_remesh`` -- given the surviving chip count, the largest valid
    (data', model) mesh that keeps the TP axis (model-parallel groups must
    stay whole; only data-parallel replicas are elastic);
  * ``make_mesh_from_plan`` -- a ``DeviceMesh`` ("data", "model") of that
    shape over the surviving ranks of the process group;
  * ``reshard`` -- a family's module placed on the new mesh by its logical
    specs (``launch/mesh.py place``);
  * ``replan_suffix`` -- decode-path elasticity: when a device joins or
    leaves mid-stream, the columns of a ``MeshExecutionPlan`` not yet issued
    re-plan over the surviving links (topology resized), completed work
    untouched;
  * ``ElasticCoordinator.recover`` -- failure -> re-mesh -> restore the latest
    checkpoint (``train/checkpoint.py``) -> reshard, continuing at the
    recorded step with the *same* global batch order.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from repro_torch.launch.mesh import Mesh, device_mesh, place


@dataclasses.dataclass
class RemeshPlan:
    data: int
    model: int
    dropped_chips: int

    @property
    def shape(self) -> tuple[int, int]:
        return (self.data, self.model)


def plan_remesh(surviving_chips: int, model_size: int = 16) -> RemeshPlan:
    """Largest (data', model) grid on the survivors, TP groups intact."""
    if surviving_chips < model_size:
        raise RuntimeError(f"cannot keep {model_size}-way TP with {surviving_chips} chips")
    data = surviving_chips // model_size
    used = data * model_size
    return RemeshPlan(data=data, model=model_size, dropped_chips=surviving_chips - used)


def make_mesh_from_plan(plan: RemeshPlan, ranks: Sequence[int] | None = None,
                        device_type: str = "cuda"):
    """The plan's ("data", "model") ``DeviceMesh`` over the first
    data x model of ``ranks`` (default: the process group's ranks from 0).
    Every rank of the group calls it, survivors or not, as ``new_group``
    wants."""
    n = plan.data * plan.model
    ranks = list(range(n)) if ranks is None else list(ranks)[:n]
    record = Mesh(f"elastic_{plan.data}x{plan.model}", ("data", "model"), plan.shape)
    return device_mesh(record, device_type, ranks)


def reshard(module: nn.Module, logical_specs, new_mesh) -> nn.Module:
    """Place a family's module (its full weights on every rank: a restored
    checkpoint, or the old mesh's gathered) onto the new mesh."""
    return place(module, logical_specs, new_mesh)


def replan_suffix(mesh_plan, done, surviving_device_ids, cost_model, profiles, **plan_kwargs):
    """Re-partition the not-yet-issued suffix of a mesh decode plan after a
    device joins or leaves.

    ``done`` names the columns already decoded (their shards count as done
    when the parent column is done); everything else re-plans from scratch
    over ``surviving_device_ids`` with the plan's topology resized to the new
    link count -- completed work is never moved or repeated.  The original
    plan's placement constraint (and with it any D2D rebalance legs) is
    re-applied to the suffix.  Returns the new ``MeshExecutionPlan`` over the
    remaining columns (None when nothing is left)."""
    from repro_torch.core import planner as planner_mod

    done = set(done)
    remaining = [c for c in mesh_plan.columns() if c not in done]
    if not remaining:
        return None
    ids = tuple(int(x) for x in surviving_device_ids)
    if not ids:
        raise RuntimeError("cannot re-plan decode onto zero devices")
    topo = mesh_plan.topology.resized(len(ids))
    plan_kwargs.setdefault("placement", mesh_plan.placement_policy)
    return planner_mod.plan_mesh_execution(
        {c: profiles[c] for c in remaining}, cost_model, n_devices=len(ids),
        device_ids=ids, topology=topo, window=mesh_plan.window, **plan_kwargs)


class ElasticCoordinator:
    """Failure -> re-mesh -> reshard -> resume, preserving data order."""

    def __init__(self, model_size: int, ckpt_dir: str, device_type: str = "cuda"):
        self.model_size = model_size
        self.ckpt_dir = ckpt_dir
        self.device_type = device_type

    def recover(self, module: nn.Module, logical_specs, surviving_ranks: Sequence[int]):
        """Load the latest checkpoint of ``module``'s weights (saved as the
        reference's tree, ``weights.params_to_reference``) into it and place
        it on the survivors' mesh -> (module, mesh, step)."""
        from repro_torch.models.weights import from_reference
        from repro_torch.train import checkpoint as ckpt
        from repro_torch.train.loop import state_like

        plan = plan_remesh(len(surviving_ranks), self.model_size)
        mesh = make_mesh_from_plan(plan, surviving_ranks, self.device_type)
        tree, step, _extra = ckpt.restore(self.ckpt_dir, state_like(module)[0])
        with torch.no_grad():
            for p, t in zip(module.parameters(), from_reference(module, tree)):
                p.copy_(t.to(p.dtype))
        return reshard(module, logical_specs, mesh), mesh, step
