"""The port's dry run (``launch/dryrun.py``), its mesh resolution
(``launch/mesh.py``) and the models' logical specs, against the reference.

  * ``Model.param_specs``/``state_specs``/``input_specs`` equal the
    reference's spec trees (and input shapes and dtypes) for every SMOKE
    config and shape;
  * the ``meta`` init holds the CPU init's parameter shapes and dtypes;
  * ``shard_tree``/``shard_shape``/``per_device_bytes`` equal the reference's
    ``shard_tree`` on ``AbstractMesh((16, 16))`` and ``((2, 16, 16))`` leaf by
    leaf (``NamedSharding.shard_shape``) for every full-size config's
    parameters (by ``jax.eval_shape``: nothing allocated on either side) and
    its ``decode_32k`` state and inputs;
  * ``run_cell`` at SMOKE size records the reference's keys (renamed where
    the port has no compiler) and its skips; the CLI writes its records.

``repro.launch.dryrun`` is never imported here: it sets XLA_FLAGS to 512
host devices at import.  Its two-line ``abstract_init`` is rebuilt inline.
"""
import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import SMOKES as REF_SMOKES
from repro.launch.mesh import shard_tree as ref_shard_tree
from repro.models import cell_status as ref_cell_status
from repro.models import get_model as ref_get_model
from repro.roofline import analysis as ref_analysis
from repro_torch.configs import ARCHS, SHAPES, SMOKES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (leaves, make_card_mesh, make_production_mesh,
                                     per_device_bytes, shard_shape, shard_tree)
from repro_torch.models import cell_status, get_model
from repro_torch.models.weights import meta_tree

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def _ref_abstract_init(model):
    """The reference dry run's ``abstract_init``: (param shapes, specs)."""
    captured = {}

    def initp(k):
        p, s = model.init(k)
        captured["specs"] = s
        return p

    return jax.eval_shape(initp, jax.random.PRNGKey(0)), captured["specs"]


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) else np.dtype(dt).name


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ------------------------------------------------------------------ specs

@pytest.mark.parametrize("arch", sorted(SMOKES))
def test_param_and_state_specs_equal_reference(arch):
    rm, api = ref_get_model(REF_SMOKES[arch]), get_model(SMOKES[arch])
    _, want = _ref_abstract_init(rm)
    assert api.param_specs() == want
    for shape in SHAPES.values():
        assert api.state_specs(shape.global_batch) == rm.state_specs(shape.global_batch)
    assert api.state_specs() == rm.state_specs()


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(SMOKES))
def test_input_specs_equal_reference(arch, shape):
    want_t, want_s = ref_get_model(REF_SMOKES[arch]).input_specs(REF_SHAPES[shape])
    got_t, got_s = get_model(SMOKES[arch]).input_specs(SHAPES[shape])
    assert got_s == want_s
    assert sorted(got_t) == sorted(want_t)
    for k, t in got_t.items():
        assert t.device.type == "meta"
        assert (tuple(t.shape), _dtype_name(t.dtype)) == (tuple(want_t[k].shape),
                                                         _dtype_name(want_t[k].dtype))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("arch", sorted(SMOKES))
def test_meta_init_matches_cpu_init(arch, train):
    api = get_model(SMOKES[arch])
    meta = api.init(device="meta", train=train)
    cpu = api.init(torch.Generator().manual_seed(0), device="cpu", train=train)
    assert [(n, p.shape, p.dtype, p.requires_grad) for n, p in meta.named_parameters()] == \
        [(n, p.shape, p.dtype, p.requires_grad) for n, p in cpu.named_parameters()]
    assert all(p.device.type == "meta" for p in meta.parameters())


@pytest.mark.parametrize("arch", sorted(SMOKES))
def test_meta_tree_is_the_reference_layout(arch):
    """``weights.meta_tree`` of the port's module: the reference's param tree
    (paths, stacked shapes) without a value."""
    pshape, _ = _ref_abstract_init(ref_get_model(REF_SMOKES[arch]))
    tree = meta_tree(get_model(SMOKES[arch]).init(device="meta"), torch.float32)
    want = {p: tuple(v.shape) for p, v in _paths(pshape)}
    assert {p: tuple(v.shape) for p, v in _paths(tree)} == want


# --------------------------------------------------- resolution at full size

@functools.lru_cache(maxsize=1)
def _full(arch: str):
    """Both sides' parameter, decode_32k state and input trees with their
    logical specs, for the full config: nothing allocated."""
    rm, api = ref_get_model(REF_ARCHS[arch]), get_model(ARCHS[arch])
    shape = SHAPES["decode_32k"]
    B, S = shape.global_batch, shape.seq_len
    r_p, r_ps = _ref_abstract_init(rm)
    r_st = jax.eval_shape(lambda: rm.make_state(B, S))
    r_in, r_is = rm.input_specs(REF_SHAPES["decode_32k"])
    ref = {"params": (r_p, r_ps), "state": (r_st, rm.state_specs(B)), "inputs": (r_in, r_is)}
    p_in, p_is = api.input_specs(shape)
    port = {"params": (meta_tree(api.init(device="meta"), torch.float32), api.param_specs()),
            "state": (api.make_state(B, S, device="meta"), api.state_specs(B)),
            "inputs": (p_in, p_is)}
    return ref, port


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_shard_tree_equals_reference_at_full_size(arch, mesh):
    ref, port = _full(arch)
    sizes, names = MESHES[mesh]
    amesh = AbstractMesh(sizes, names)
    pmesh = make_production_mesh(multi_pod=mesh == "multipod")
    assert pmesh.shape == dict(amesh.shape) and pmesh.axis_names == amesh.axis_names
    for part in ("params", "state", "inputs"):
        (r_tree, r_spec), (p_tree, p_spec) = ref[part], port[part]
        r_sh = ref_shard_tree(r_tree, r_spec, amesh)
        p_sh = shard_tree(p_tree, p_spec, pmesh)
        want_bytes = 0
        for path, r_leaf in _paths(r_tree):
            ns, p_leaf, spec = _at(r_sh, path), _at(p_tree, path), _at(p_sh, path)
            assert isinstance(ns, NamedSharding)
            want_shape = ns.shard_shape(tuple(r_leaf.shape))
            if path == ("len",):          # the port's is a host int: 0 device bytes
                assert spec == () and tuple(ns.spec) == () and not torch.is_tensor(p_leaf)
                continue
            assert tuple(p_leaf.shape) == tuple(r_leaf.shape), (part, path)
            assert spec == tuple(ns.spec) + (None,) * (len(r_leaf.shape) - len(ns.spec))
            assert shard_shape(p_leaf.shape, spec, pmesh) == want_shape, (part, path)
            want_bytes += math.prod(want_shape) * np.dtype(r_leaf.dtype).itemsize
        assert per_device_bytes(p_tree, p_sh, pmesh) == want_bytes, part


def test_card_mesh_splits_nothing():
    mesh = make_card_mesh()
    tree = {"w": torch.empty(6, 10, device="meta"), "len": 0}
    specs = shard_tree(tree, {"w": ("fsdp", ("tp", 10)), "len": ()}, mesh)
    assert specs == {"w": ("data", "model"), "len": ()}
    assert [s for _, s in leaves(tree, specs)] == [("data", "model"), ()]
    assert per_device_bytes(tree, specs, mesh) == 6 * 10 * 4


# ------------------------------------------------------------- run_cell

REC_KEYS = {"arch", "shape", "mesh", "status", "split", "lower_s", "memory", "roofline",
            "n_ops", "by_op"}
MEM_KEYS = {"argument", "output", "temp", "per_device_live", "fits_80g_hbm"}


def _ref_roofline_keys() -> set:
    r = ref_analysis.Roofline(arch="a", shape="s", mesh="m", chips=1, hlo_flops_per_chip=1.0,
                              hlo_bytes_per_chip=1.0, coll_bytes_per_chip=0.0,
                              coll_breakdown={}, model_flops_total=1.0, per_device_bytes=1)
    return set(r.to_dict())


@pytest.mark.parametrize("arch,shape,mesh", [
    ("qwen1.5-0.5b", "train_4k", "card"), ("qwen1.5-0.5b", "prefill_32k", "card"),
    ("qwen1.5-0.5b", "decode_32k", "card"), ("qwen1.5-0.5b", "decode_32k", "pod"),
    ("phi3.5-moe-42b-a6.6b", "decode_32k", "card"), ("rwkv6-7b", "long_500k", "card")])
def test_run_cell_at_smoke_size(arch, shape, mesh, monkeypatch):
    monkeypatch.setattr(dryrun, "ARCHS", SMOKES)
    rec = dryrun.run_cell(arch, shape, mesh)
    want = REC_KEYS | ({"knobs"} if SHAPES[shape].kind == "train" else set()) \
        | ({"collectives"} if mesh != "card" else set())
    assert set(rec) == want
    assert set(rec["memory"]) == MEM_KEYS
    assert _ref_roofline_keys() <= set(rec["roofline"])
    roof = rec["roofline"]
    card = mesh == "card"
    assert rec["split"] == roof["split"] == "counted"   # one device's program
    assert roof["t_collective"] is not None
    assert (roof["t_collective"] > 0) != card and (bool(rec.get("collectives")) != card)
    assert roof["hlo_flops_per_chip"] > 0 and roof["hlo_bytes_per_chip"] > 0
    mem = rec["memory"]
    assert mem["per_device_live"] == int(mem["argument"] + mem["temp"])
    assert rec["n_ops"]["n_ops"] == sum(v["n"] for v in rec["by_op"].values())
    json.dumps(rec)
    if SHAPES[shape].kind == "train":
        assert rec["knobs"] == dryrun.TRAIN_KNOBS[arch]


def test_run_cell_card_and_pod_split_the_same_count(monkeypatch):
    """The pod counts one device's share of the card's step: its FLOPs at
    least the card's / 256 (work a device repeats, where a dimension does
    not split, only adds) and well below the card's, with collectives."""
    monkeypatch.setattr(dryrun, "ARCHS", SMOKES)
    card = dryrun.run_cell("qwen1.5-0.5b", "decode_32k", "card")
    pod = dryrun.run_cell("qwen1.5-0.5b", "decode_32k", "pod")
    rc, rp = card["roofline"], pod["roofline"]
    assert rc["hlo_flops_per_chip"] <= rp["hlo_flops_per_chip"] * 256
    assert rp["hlo_flops_per_chip"] < rc["hlo_flops_per_chip"] / 16
    assert rp["hlo_bytes_per_chip"] < rc["hlo_bytes_per_chip"]
    assert rp["coll_bytes_per_chip"] > 0 == rc["coll_bytes_per_chip"]
    assert pod["memory"]["argument"] < card["memory"]["argument"]
    assert not torch.distributed.is_initialized()     # the fake group is gone


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_skips_equal_cell_status(arch):
    want = ref_cell_status(REF_ARCHS[arch], REF_SHAPES["long_500k"])
    assert cell_status(ARCHS[arch], SHAPES["long_500k"]) == want
    if want != "run":
        assert dryrun.run_cell(arch, "long_500k", "pod") == {
            "arch": arch, "shape": "long_500k", "mesh": "pod_16x16", "status": want}


def test_microbatch_stays_divisible_by_the_fsdp_axes():
    """The reference's loop: halve the microbatch until the per-microbatch
    batch splits over the fsdp axes."""
    B = SHAPES["train_4k"].global_batch
    assert dryrun._knobs("dbrx-132b", make_card_mesh(), B, None)["microbatch"] == 16
    assert dryrun._knobs("dbrx-132b", make_production_mesh(), B, None)["microbatch"] == 16
    assert dryrun._knobs("dbrx-132b", make_production_mesh(multi_pod=True), B,
                         None)["microbatch"] == 8
    assert dryrun._knobs("qwen1.5-0.5b", make_production_mesh(), B,
                         {"remat": "dots"}) == {"microbatch": 1, "remat": "dots"}


def test_cli_writes_both_meshes_and_caches(tmp_path):
    """``--arch qwen1.5-0.5b --shape train_4k --mesh both`` at full width on
    meta: a record with the roofline, ``fits_80g_hbm`` and per-device argument
    bytes for each mesh; a second call skips them as cached."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen1.5-0.5b",
           "--shape", "train_4k", "--mesh", "both", "--out", str(tmp_path)]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    recs = {m: json.loads((tmp_path / f"qwen1.5-0.5b_train_4k_{m}.json").read_text())
            for m in ("pod", "multipod")}
    for m, rec in recs.items():
        assert rec["status"] == "ok", rec["status"]
        assert rec["memory"]["fits_80g_hbm"] in (True, False)
        assert rec["roofline"]["bottleneck"] in ("compute", "memory")
    assert recs["multipod"]["memory"]["argument"] < recs["pod"]["memory"]["argument"]
    again = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
    assert again.stdout.count("cached") == 2
