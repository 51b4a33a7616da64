"""Placement on a device mesh, the activation-sharding context and elastic
re-meshing, on the CPU.

  * ``placements``/``place`` follow ``shard_tree``'s resolution, its
    divisibility fallbacks included (``tests/test_elastic.py``'s (6, 8) and
    (5, 7) leaves on a 2 x 4 mesh); every parameter of qwen1.5-0.5b at full
    width, placed on ``meta`` on a fake 16 x 16 group in this process, has
    ``shard_shape`` of its resolved spec as its local shape, and
    ``per_device_bytes`` counts what the placed parameters hold;
  * on a 2 x 2 ``gloo`` mesh (4 processes, ``tests/torch_mesh_ranks.py``)
    qwen SMOKE in f32: the placed ``train_loss`` and its gradients within
    ``GRAD_TOL`` of the unplaced port's, two placed AdamW steps within
    ``LOSS_TOL`` a loss and ``STEP_TOL`` of the parameters' change, and
    ``flash_attention`` on 3 heads over a 2-way TP axis (padded to 4) equal to
    the plain one;
  * ``flash_attention``'s head padding under a context whose TP size does not
    divide the heads equals the unpadded result;
  * elastic: the reference's ``test_elastic.py`` scenario at the port's scale
    -- a (2, 2) mesh, 2 ranks lost, recovery to (1, 2) from a checkpoint: the
    step matches, the loss on the survivors agrees with the full mesh's
    within rtol 1e-3 (the reference's own assertion) and with the
    reference's within ``BF16_TOL``; ``plan_remesh`` equals the reference's
    case for case.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from repro.launch.elastic import plan_remesh as ref_plan_remesh

from repro_torch.configs import ARCHS, SMOKES
from repro_torch.launch import mesh as M
from repro_torch.launch.elastic import plan_remesh
from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.models.sharding_ctx import get_mesh, mesh_context, shard
from repro_torch.models.weights import layout, meta_tree

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_mesh_ranks as R  # noqa: E402
from torch_mesh_ranks import run_case  # noqa: E402

GRAD_TOL = 1e-5      # relative to each leaf's largest |gradient|, f32
LOSS_TOL = 1e-5      # relative, f32
# two AdamW steps at lr 1e-2: the parameters' L2 distance over their L2
# change (``chip_smoke.py``'s ``TRAIN_STEP_TOL``).  Not element by element: a sharded
# sum rounds otherwise, and AdamW's first steps scale each gradient element
# to +-lr, so an element whose gradient is near eps moves by up to lr
STEP_TOL = 1e-2
BF16_TOL = 5e-3      # the reference's bf16 loss against the port's (rtol)


def test_placements_follow_shard_tree_with_fallbacks():
    from torch.distributed.tensor import Replicate, Shard

    record = M.Mesh("t", ("data", "model"), (2, 4))
    tree = {"w": torch.empty(6, 8, device="meta"), "odd": torch.empty(5, 7, device="meta")}
    specs = M.shard_tree(tree, {"w": ("fsdp", "tp"), "odd": ("fsdp", "tp")}, record)
    assert specs == {"w": ("data", "model"), "odd": (None, None)}
    with M.fake_group(8):
        dm = M.device_mesh(record, "cpu")
        assert M.placements(specs["w"], dm) == (Shard(0), Shard(1))
        assert M.placements(specs["odd"], dm) == M.replicated(dm) == (Replicate(), Replicate())
        placed = M.place_tree(tree, {"w": ("fsdp", "tp"), "odd": ("fsdp", "tp")}, dm)
        assert tuple(placed["w"].to_local().shape) == M.shard_shape((6, 8), specs["w"], record)
        assert tuple(placed["odd"].to_local().shape) == (5, 7)
        # a dim split over two axes takes Shard(d) on both, in the mesh's order
        three = M.Mesh("p", ("pod", "data", "model"), (2, 2, 2))
        dm3 = M.device_mesh(three, "cpu")
        assert M.placements((("pod", "data"), "model"), dm3) == (Shard(0), Shard(0), Shard(1))
        with pytest.raises(ValueError, match="order"):
            M.placements((("data", "pod"), None), dm3)
    assert not torch.distributed.is_initialized()      # the fake group is gone


@pytest.mark.parametrize("multi_pod", (False, True), ids=("pod", "multipod"))
def test_place_full_width_on_a_fake_production_mesh(multi_pod):
    cfg = ARCHS["qwen1.5-0.5b"]
    model = get_model(cfg)
    module = model.init(device="meta", train=True)
    record = M.make_production_mesh(multi_pod=multi_pod)
    tree = meta_tree(module)
    specs = M.shard_tree(tree, model.param_specs(), record)
    with M.fake_group(record.size):
        dm = M.device_mesh(record, "cpu")
        M.place(module, model.param_specs(), dm)
        held = 0
        for path, (stack, ps) in layout(module).items():
            spec = specs
            for k in path.split("/"):
                spec = spec[k]
            want = M.shard_shape(ps[0].shape, spec[len(stack):], record)
            for p in ps:
                assert tuple(p.to_local().shape) == want, path
                held += p.to_local().numel() * p.element_size()
        assert held == M.per_device_bytes(tree, specs, record)
        assert sum(p.to_local().numel() for p in module.parameters()) < \
            sum(p.numel() for p in module.parameters()) // 16
    assert not torch.distributed.is_initialized()


def test_device_mesh_refuses_a_missing_or_small_group():
    with pytest.raises(RuntimeError, match="process group"):
        M.device_mesh(M.make_card_mesh(), "cpu")
    with M.fake_group(4):
        with pytest.raises(RuntimeError, match="4 ranks"):
            M.device_mesh(M.make_production_mesh(), "cpu")


@pytest.mark.parametrize("heads,tp", ((4, 3), (3, 2), (15, 16)))
def test_flash_attention_head_padding_equals_unpadded(heads, tp):
    """Plain tensors under a context whose TP size does not divide H: zero
    heads padded in and sliced off, the result bitwise the unpadded one."""
    g = torch.Generator().manual_seed(heads)
    q = torch.randn(2, 16, heads, 8, generator=g)
    k = torch.randn(2, 16, heads, 8, generator=g)
    v = torch.randn(2, 16, heads, 8, generator=g)
    want = L.flash_attention(q, k, v, q_chunk=8, kv_chunk=8)
    with M.fake_group(tp):
        dm = M.device_mesh(M.Mesh("t", ("data", "model"), (1, tp)), "cpu")
        with mesh_context(dm):
            assert get_mesh() is dm
            assert shard(q, "fsdp", None, "tp", None) is q      # plain: the identity
            got = L.flash_attention(q, k, v, q_chunk=8, kv_chunk=8)
        assert get_mesh() is None
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.fixture(scope="module")
def place_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("place"))
    run_case("place", d)
    return d


@pytest.mark.parametrize("rank", range(4))
def test_placed_loss_and_gradients_match_unplaced(rank, place_dir):
    got = R.load(place_dir, f"place_{rank}")
    assert int(got["bad_shapes"]) == 0
    assert int(got["n_sharded"]) > 0
    assert float(got["loss_placed"]) == pytest.approx(float(got["loss"]), rel=LOSS_TOL)
    assert float(got["grad_rel"].max()) <= GRAD_TOL


def test_placed_adamw_steps_match_unplaced(place_dir):
    got = R.load(place_dir, "place_0")
    losses = got["step_losses"]
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=LOSS_TOL)
    assert float(got["change_l2"]) > 0.1                 # the update is visible
    assert float(got["param_l2"]) <= STEP_TOL * float(got["change_l2"])
    assert float(got["param_diff"].max()) <= 2 * 1e-2     # two steps of at most lr each


@pytest.mark.parametrize("rank", range(4))
def test_placed_state_checkpoints_whole_and_resumes_placed(rank, place_dir):
    """Every rank gathers the placed state into the reference's layout, the
    mesh's first device writes it, and a fresh placed module restores it
    bitwise, each parameter and moment on its placements; ``loop.run``
    resumes from it placed and its third step's loss is the unplaced one's."""
    got = R.load(place_dir, f"place_{rank}")
    assert bool(got["ckpt_shapes"])
    assert int(got["ckpt_step"]) == 2
    assert bool(got["ckpt_params_equal"]) and bool(got["ckpt_moments_equal"])
    assert bool(got["ckpt_tree_equal"])
    assert list(got["resumed"]) == [2]
    assert float(got["resumed_loss"]) == pytest.approx(float(got["plain_loss3"]), rel=LOSS_TOL)


def test_production_mesh_checkpoint_is_the_unplaced_layout(place_dir):
    """The checkpoint the placed loop wrote holds whole leaves: the manifest
    of an unplaced SMOKE module's state, leaf for leaf."""
    import json

    from repro_torch.train import optimizer
    from repro_torch.train.loop import state_tree

    cfg = dataclasses.replace(SMOKES[R.ARCH], dtype=torch.float32)
    module = get_model(cfg).init(torch.Generator().manual_seed(0), device="cpu", train=True)
    # the checkpoint names a leaf by its path in the tuple (params, opt_state)
    want = R.flat(dict(zip("01", state_tree(module, optimizer.init(module)))))
    with open(os.path.join(place_dir, "ckpt", "step_00000003", "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    assert {k: tuple(v["shape"]) for k, v in leaves.items()} == \
        {k: v.shape for k, v in want.items()}


@pytest.mark.parametrize("world", [None, "4"])
def test_production_mesh_refuses_a_smaller_group(world, monkeypatch, capsys):
    """``launch.train --production-mesh`` stops before it trains when the
    launcher's group has fewer ranks than the pod has devices, naming both."""
    from repro_torch.launch import train as launch_train

    if world is None:
        monkeypatch.delenv("WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("WORLD_SIZE", world)
    monkeypatch.setattr(sys, "argv", ["train", "--smoke", "--device", "cpu",
                                      "--production-mesh", "--steps", "1"])
    with pytest.raises(SystemExit) as exc:
        launch_train.main()
    msg = str(exc.value)
    assert "256" in msg and msg.endswith(f"has {world or 1}")
    assert not torch.distributed.is_initialized()


def test_placed_flash_attention_pads_heads(place_dir):
    got = R.load(place_dir, "place_0")
    assert tuple(got["pad_shape"]) == (2, 16, 3, 8)
    assert float(got["pad_err"]) <= 1e-6


@pytest.fixture(scope="module")
def elastic_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("elastic"))
    run_case("ref_elastic", d)
    run_case("elastic", d)
    return d


def test_elastic_recovery_matches_the_reference(elastic_dir):
    ref = R.load(elastic_dir, "ref_elastic")
    outs = [R.load(elastic_dir, f"elastic_{r}") for r in range(4)]
    for o in outs:
        assert int(o["step"]) == int(ref["step"]) == 3
        assert tuple(o["shape"]) == tuple(ref["shape"]) == (1, 2)
    survivors = [o for o in outs if bool(o["member"])]
    assert len(survivors) == 2
    for o in survivors:
        np.testing.assert_allclose(float(o["loss_small"]), float(o["loss_full"]), rtol=1e-3)
        np.testing.assert_allclose(float(o["loss_small"]), float(ref["loss_small"]),
                                   rtol=BF16_TOL)
    np.testing.assert_allclose(float(outs[0]["loss_full"]), float(ref["loss_full"]),
                               rtol=BF16_TOL)


@pytest.mark.parametrize("chips,model_size", ((240, 16), (250, 16), (256, 16), (4, 2),
                                              (3, 2), (7, 7), (8, 16)))
def test_plan_remesh_matches_the_reference(chips, model_size):
    try:
        want = ref_plan_remesh(chips, model_size)
    except RuntimeError:
        with pytest.raises(RuntimeError):
            plan_remesh(chips, model_size)
        return
    got = plan_remesh(chips, model_size)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.shape == want.shape


def test_smoke_specs_resolve_on_the_gloo_mesh_shape():
    """The 2 x 2 mesh of the rank tests shards most of qwen SMOKE's leaves."""
    cfg = SMOKES["qwen1.5-0.5b"]
    model = get_model(cfg)
    module = model.init(device="meta", train=True)
    specs = M.shard_tree(meta_tree(module), model.param_specs(),
                         M.Mesh("t", ("data", "model"), (2, 2)))
    split = [s for _, s in M.leaves(meta_tree(module), specs) if any(a for a in s)]
    assert len(split) >= 8
