"""Per-device counting: ``roofline.op_cost`` through DTensor, on the CPU.

  * On a fake (4, 4) group in this process, a product split over both axes
    counts one device's FLOPs, the global count / 16, and the all-gather
    DTensor issues for it; a second call counts the same (DTensor's cached
    shape propagation is not counted either time).
  * A placed FSDP x TP train step of qwen SMOKE on the 16 x 16 pod counts
    all-gather bytes and reduce-scatter or all-reduce bytes.
  * Where every dimension splits 16 x 16 (qwen SMOKE with 16 heads), the
    pod's train step counts exactly the card's FLOPs / 256, product by
    product: a product split over the wrong axis, or run on partial sums,
    would count a multiple of that.  Its decode splits the attention
    exactly 256 ways; DTensor moves the small decode activations rather
    than gather the weights' FSDP axis, so the projections split fewer
    ways (ROADMAP §3).
  * Unplaced, the count is the same with a process group open as without:
    the card's counts do not change.
"""
import dataclasses

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.configs import SHAPES, SMOKES
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as M
from repro_torch.models import get_model
from repro_torch.roofline import op_cost
from repro_torch.train import optimizer
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import make_train_step


def test_a_split_product_counts_one_device_share():
    with M.fake_group(16):
        dm = M.device_mesh(M.Mesh("t", ("data", "model"), (4, 4)), "cpu")
        a = distribute_tensor(torch.empty(64, 1024, device="meta"), dm,
                              (Shard(0), Replicate()), src_data_rank=None)
        b = distribute_tensor(torch.empty(1024, 4096, device="meta"), dm,
                              (Shard(0), Shard(1)), src_data_rank=None)
        first = op_cost.analyze(torch.mm, a, b)
        again = op_cost.analyze(torch.mm, a, b)
    assert first["flops"] == 2 * 64 * 1024 * 4096 / 16
    assert first["by_op"]["aten.mm.default"]["n"] == 1
    # DTensor's plan: a's rows gathered over the data axis (64 x 1024 f32, 3/4
    # of it on the wire), b's split rows contracted into partial sums
    assert first["collectives"] == {"all-gather": 64 * 1024 * 4 * 3 / 4}
    assert (again["flops"], again["bytes"], again["collectives"]) == \
        (first["flops"], first["bytes"], first["collectives"])
    assert not torch.distributed.is_initialized()


def test_placed_train_step_counts_its_collectives(monkeypatch):
    monkeypatch.setattr(dryrun, "ARCHS", SMOKES)
    rec = dryrun.run_cell("qwen1.5-0.5b", "train_4k", "pod")
    assert rec["split"] == "counted"
    coll = rec["collectives"]
    assert coll.get("all-gather", 0) > 0
    assert coll.get("reduce-scatter", 0) + coll.get("all-reduce", 0) > 0
    assert rec["roofline"]["t_collective"] > 0
    assert not torch.distributed.is_initialized()


def _split_cells(monkeypatch, shape: str) -> tuple[dict, dict]:
    """(card, pod) records of qwen SMOKE with 16 heads and KV heads, so that
    the heads split over the pod's 16-way model axis as every other
    dimension does."""
    cfg = dataclasses.replace(SMOKES["qwen1.5-0.5b"], n_heads=16, n_kv_heads=16)
    monkeypatch.setattr(dryrun, "ARCHS", {"qwen1.5-0.5b": cfg})
    return tuple(dryrun.run_cell("qwen1.5-0.5b", shape, m) for m in ("card", "pod"))


PRODUCTS = ("aten.mm.default", "aten.bmm.default")


def test_pod_train_step_counts_the_card_s_flops_over_256(monkeypatch):
    card, pod = _split_cells(monkeypatch, "train_4k")
    assert pod["roofline"]["hlo_flops_per_chip"] * 256 == card["roofline"]["hlo_flops_per_chip"]
    for op in PRODUCTS:
        assert pod["by_op"][op]["n"] == card["by_op"][op]["n"]
        assert pod["by_op"][op]["flops"] * 256 == card["by_op"][op]["flops"]
    assert not torch.distributed.is_initialized()


def test_pod_decode_splits_attention_256_ways(monkeypatch):
    card, pod = _split_cells(monkeypatch, "decode_32k")
    bmm = "aten.bmm.default"
    assert pod["by_op"][bmm]["flops"] * 256 == card["by_op"][bmm]["flops"]
    mm_card, mm_pod = (c["by_op"]["aten.mm.default"]["flops"] for c in (card, pod))
    assert mm_card <= mm_pod * 256 and mm_pod * 16 <= mm_card
    assert not torch.distributed.is_initialized()


def _smoke_step_count() -> dict:
    cfg = SMOKES["qwen1.5-0.5b"]
    api = get_model(cfg)
    module = api.init(device="meta", train=True)
    step = make_train_step(cfg, AdamWConfig(), remat="full")
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=4, seq_len=64)
    inputs, _ = api.input_specs(shape)
    return op_cost.analyze(step, module, optimizer.init(module), inputs)


def test_unplaced_counts_do_not_change_with_a_group_open():
    want = _smoke_step_count()
    with M.fake_group(4):
        got = _smoke_step_count()
    assert (got["flops"], got["bytes"], got["n_ops"], got["collectives"]) == \
        (want["flops"], want["bytes"], want["n_ops"], {})
    assert got["by_op"] == want["by_op"]
