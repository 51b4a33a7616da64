"""The port's AdamW, train step and gradient compression against the JAX
reference's, on the CPU, f32 on both sides.

AdamW runs three steps from the same params and gradients (numpy seeds) at
``weight_decay=0.1`` with the global-norm clip active: the reference stacks a
layer's norm scales and biases to (L, D), so it decays them, and the port's
1-D per-layer tensors must be decayed as well (only ``final_norm`` is not).
The train step runs three steps on the same batches at ``microbatch`` 1 and
2.  The int8 error-feedback sum is checked on one member, the case the
reference's own test runs on a mesh of one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as REF_SMOKES
from repro.models import get_model as ref_get_model
from repro.train import grad_compress as RGC
from repro.train import optimizer as ROPT
from repro.train.train_step import make_train_step as ref_make_train_step

from repro_torch.configs import SMOKES
from repro_torch.models.weights import from_reference, params_from_reference, to_reference
from repro_torch.train import grad_compress as GC
from repro_torch.train import optimizer as OPT
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import make_eval_step, make_train_step, make_value_and_grad

ARCH = "qwen1.5-0.5b"       # QKV biases and two norms a layer, stacked in the reference
OPT_CFG = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
PARAM_TOL = 1e-6            # AdamW: of the leaf's largest |value|; the same f32 ops
MOMENT_TOL = 1e-5           # mu/nu: relative, f32 (pow and the clip's sqrt in another order)
# the train step, three steps: of the tree's largest |value|.  Not of each
# leaf's: the key bias's gradient vanishes in exact arithmetic (softmax ignores
# a constant added to all of a query's scores), so both packages hold rounding
# noise there, which AdamW normalises to steps of up to +-lr.
STEP_TOL = 1e-5
MB_GRAD_TOL = 1e-5          # microbatch 2 vs 1 gradients, f32, of the leaf's largest |value|
PSUM_TOL = 1e-6             # of the sum's largest |value|: one f32 ulp of the scale
B, S = 4, 16


def flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def ref_params(arch: str = ARCH):
    rcfg = dataclasses.replace(REF_SMOKES[arch], dtype=jnp.float32)
    return rcfg, ref_get_model(rcfg).init(jax.random.PRNGKey(3))[0]


def port_model(params, arch: str = ARCH):
    cfg = dataclasses.replace(SMOKES[arch], dtype=torch.float32)
    return cfg, params_from_reference(jax.tree.map(np.asarray, params), cfg, "cpu", train=True)


def close_trees(got: dict, want: dict, tol: float, what: str, per_leaf: bool = True):
    """Every leaf within ``tol`` of its largest |value| (``per_leaf``) or of
    the tree's."""
    assert set(got) == set(want), what
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        scale = float(np.abs(w).max()) if per_leaf else top
        np.testing.assert_allclose(got[k], w, rtol=0, atol=tol * max(scale, 1e-30),
                                   err_msg=f"{what} {k}")


def test_schedule_matches_the_reference():
    cfg, rcfg = AdamWConfig(**OPT_CFG), ROPT.AdamWConfig(**OPT_CFG)
    for step in range(0, 13):
        np.testing.assert_allclose(OPT.schedule(cfg, step),
                                   float(ROPT.schedule(rcfg, jnp.int32(step))), rtol=1e-6)


def test_decay_follows_the_reference_leaf_rank():
    """A layer's 1-D norm scales and biases are decayed (their reference
    leaves are (L, D)); the final norm is not; every matrix is."""
    _, params = ref_params()
    _, model = port_model(params)
    decayed = dict(zip((n for n, _ in model.named_parameters()), OPT.decayed(model)))
    assert decayed["blocks.0.norms.norm1"] and decayed["blocks.1.attn.bq"]
    assert not decayed["final.final_norm"]
    assert all(d for n, d in decayed.items() if n != "final.final_norm")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_adamw_matches_the_reference_over_three_steps(dtype):
    """The same params and gradients: params, mu, nu, grad norm and lr after
    each of three steps.  In bf16 the params are bf16 on both sides, updated
    in f32 and cast back (within one bf16 ulp: the f32 values before the
    cast agree to ``PARAM_TOL``)."""
    _, params = ref_params()
    _, model = port_model(params)
    if dtype == "bf16":
        params = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
        model = model.to(torch.bfloat16)
    rng = np.random.default_rng(0)
    rcfg, cfg = ROPT.AdamWConfig(**OPT_CFG), AdamWConfig(**OPT_CFG)
    ropt, opt = ROPT.init(params), OPT.init(model)
    for step in range(3):
        grads = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32) * 3.0,
                             params)
        params, ropt, rdiag = ROPT.update(rcfg, params, ropt, grads)
        model, opt, diag = OPT.update(cfg, model, opt, from_reference(model, grads))
        assert opt["step"] == int(ropt["step"]) == step + 1
        assert float(rdiag["grad_norm"]) > cfg.grad_clip          # the clip is active
        np.testing.assert_allclose(float(diag["grad_norm"]), float(rdiag["grad_norm"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(diag["lr"], float(rdiag["lr"]), rtol=1e-6)
        tol = PARAM_TOL if dtype == "f32" else 2.0 ** -8
        close_trees(flat(to_reference(model, model.parameters())), flat(params), tol,
                    f"step {step} params")
        for k in ("mu", "nu"):
            close_trees(flat(to_reference(model, opt[k])), flat(ropt[k]), MOMENT_TOL,
                        f"step {step} {k}")
        assert all(p.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
                   for p in model.parameters())


def batches(cfg, n: int) -> list[dict]:
    out = []
    for i in range(n):
        toks = np.random.default_rng(i).integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_step_matches_the_reference(microbatch):
    """Three steps of ``make_train_step`` (remat "dots" in the port, none in
    the reference: remat changes no number) at ``weight_decay=0.1``: the
    loss of each step and the params and moments after the last."""
    rcfg, params = ref_params()
    cfg, model = port_model(params)
    opt_cfg = dict(OPT_CFG, lr=1e-3)
    rstep = jax.jit(ref_make_train_step(rcfg, ROPT.AdamWConfig(**opt_cfg), remat=None,
                                        microbatch=microbatch))
    step = make_train_step(cfg, AdamWConfig(**opt_cfg), remat="dots", microbatch=microbatch)
    ropt, opt = ROPT.init(params), OPT.init(model)
    for b in batches(cfg, 3):
        params, ropt, rm = rstep(params, ropt, {k: jnp.asarray(v) for k, v in b.items()})
        model, opt, m = step(model, opt, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(m["loss"].item(), float(rm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].item(), float(rm["grad_norm"]), rtol=1e-4)
    close_trees(flat(to_reference(model, model.parameters())), flat(params), STEP_TOL,
                "params", per_leaf=False)
    for k in ("mu", "nu"):
        close_trees(flat(to_reference(model, opt[k])), flat(ropt[k]), STEP_TOL, k,
                    per_leaf=False)


def test_microbatches_give_the_whole_batch_loss_and_eval_step():
    """Two microbatches of equal size: their mean loss is the whole batch's
    (f32), and ``make_eval_step`` gives the loss without a gradient."""
    _, params = ref_params()
    cfg, model = port_model(params)
    b = {k: torch.from_numpy(v) for k, v in batches(cfg, 1)[0].items()}
    want = make_eval_step(cfg)(model, b)
    assert not want.requires_grad
    opt_cfg = AdamWConfig(**OPT_CFG)
    for mb in (1, 2):
        _, m2 = port_model(params)
        loss = make_train_step(cfg, opt_cfg, remat=None, microbatch=mb)(
            m2, OPT.init(m2), b)[2]["loss"]
        np.testing.assert_allclose(loss.item(), want.item(), rtol=1e-6)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(cfg, opt_cfg, microbatch=3)(model, OPT.init(model), b)


def test_microbatch_gradients_are_the_whole_batch_s():
    """``make_value_and_grad`` over two microbatches: every gradient within
    ``MB_GRAD_TOL`` of the leaf's largest |gradient| of the whole batch's
    (f32 sums over the halves, then their mean), the loss within 1e-6."""
    _, params = ref_params()
    cfg, model = port_model(params)
    b = {k: torch.from_numpy(v) for k, v in batches(cfg, 1)[0].items()}
    (l1, g1), (l2, g2) = (make_value_and_grad(cfg, None, mb)(model, b) for mb in (1, 2))
    np.testing.assert_allclose(l2.item(), l1.item(), rtol=1e-6)
    for (name, _), a, w in zip(model.named_parameters(), g2, g1):
        torch.testing.assert_close(a, w, rtol=0, atol=MB_GRAD_TOL * float(w.abs().max()),
                                   msg=name)


def test_train_step_refuses_frozen_weights():
    _, params = ref_params()
    cfg = dataclasses.replace(SMOKES[ARCH], dtype=torch.float32)
    model = params_from_reference(jax.tree.map(np.asarray, params), cfg, "cpu")
    b = {k: torch.from_numpy(v) for k, v in batches(cfg, 1)[0].items()}
    with pytest.raises(ValueError, match="train=True"):
        make_train_step(cfg, AdamWConfig())(model, OPT.init(model), b)


def test_quantize_int8_matches_the_reference():
    x = np.random.default_rng(1).normal(size=(1000,)).astype(np.float32)
    rq, rs = RGC.quantize_int8(jnp.asarray(x))
    q, s = GC.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert s.item() == float(rs)
    np.testing.assert_array_equal(GC.dequantize(q, s).numpy(),
                                  np.asarray(RGC.dequantize(rq, rs)))
    err = np.abs(GC.dequantize(q, s).numpy() - x)
    assert err.max() <= s.item() * 0.5 + 1e-6


def test_error_feedback_sum_on_one_member_matches_the_reference():
    """The reference's convergence case (a quadratic pulled to a target
    through 200 compressed sums) on one member: every step's sum and error
    buffer, from the same inputs, within ``PSUM_TOL`` of the reference's
    ``compressed_psum`` in a ``shard_map`` over a mesh of one (XLA's scale
    can differ from ``max / 127`` by one ulp there), converging to the
    target; the wire format 4x smaller."""
    mesh_kwargs = {}
    if hasattr(jax.sharding, "AxisType"):
        mesh_kwargs["axis_types"] = (jax.sharding.AxisType.Auto,)
    mesh = jax.make_mesh((1,), ("pod",), **mesh_kwargs)
    if hasattr(jax, "shard_map"):
        shard_map, check_kwargs = jax.shard_map, {"check_vma": False}
    else:
        from jax.experimental.shard_map import shard_map
        check_kwargs = {"check_rep": False}
    spec = jax.sharding.PartitionSpec()
    ref_sum = jax.jit(shard_map(lambda g, e: RGC.compressed_psum(g, e, "pod"), mesh=mesh,
                                in_specs=(spec, spec), out_specs=(spec, spec),
                                **check_kwargs))
    target = np.random.default_rng(0).normal(size=(64,)).astype(np.float32)
    w, err = torch.zeros(64), torch.zeros(64)
    for _ in range(200):
        g = 2 * (w - torch.from_numpy(target))
        rs, rerr = ref_sum(jnp.asarray(g.numpy()), jnp.asarray(err.numpy()))
        gsum, err = GC.compressed_psum(g, err)
        scale = float(np.abs(np.asarray(rs)).max())
        np.testing.assert_allclose(gsum.numpy(), np.asarray(rs), rtol=0, atol=PSUM_TOL * scale)
        np.testing.assert_allclose(err.numpy(), np.asarray(rerr), rtol=0,
                                   atol=PSUM_TOL * scale)
        w = w - 0.05 * gsum
    np.testing.assert_allclose(w.numpy(), target, atol=1e-2)
    [gs], [es] = GC.compress_tree([g], [torch.zeros(64)])
    assert gs.shape == es.shape == (64,)
    assert GC.wire_bytes([w], compressed=True) * 4 == GC.wire_bytes([w], compressed=False)
    assert [e.shape for e in GC.init_error_feedback([w, torch.zeros(3, 2)])] == [(64,), (3, 2)]
