"""The port's training loss and gradients against the JAX reference's, on
the CPU.

For every SMOKE config (the MoE aux loss, the VLM's patch prefix with 3-D
positions and the enc-dec frames included) and a Zamba2 variant with a tail
layer: the reference's params from a ``PRNGKey`` carried into the port's
training form (``params_from_reference(..., train=True)``), the same batch
made from a numpy seed, f32 on both sides; ``Model.train_loss`` against
``train_loss`` within ``LOSS_TOL`` relative, and every gradient leaf
(autograd against ``jax.value_and_grad``, the port's per-layer gradients
stacked into the reference's leaves) within ``GRAD_TOL`` of the largest
|gradient| of its leaf.  Every remat policy gives the gradients of none,
bit for bit; ``params_to_reference`` inverts ``params_from_reference``
exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as REF_SMOKES
from repro.models import get_model as ref_get_model

from repro_torch.configs import SMOKES
from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.models.weights import (layout, params_from_reference, params_to_reference,
                                        to_reference)
from repro_torch.train.remat import POLICIES, get_policy

VARIANTS = {"zamba2-7b-tail": ("zamba2-7b", {"n_layers": 5})}
NAMES = list(REF_SMOKES) + list(VARIANTS)
B, S, PATCHES, FRAMES = 2, 32, 4, 32
LOSS_TOL = 1e-5     # relative, f32 sums in another order
GRAD_TOL = 1e-3     # of the leaf's largest |gradient| (f32 sums in another order)


def configs(name: str, jdt=jnp.float32, tdt=torch.float32):
    arch, kw = VARIANTS.get(name, (name, {}))
    return (dataclasses.replace(REF_SMOKES[arch], dtype=jdt, **kw),
            dataclasses.replace(SMOKES[arch], dtype=tdt, **kw))


def train_batch(cfg, seed: int) -> dict:
    """A training batch for ``cfg``'s family as numpy: tokens and labels, a
    VLM's 2x2 patch prefix at t = 0 with its (t, h, w) positions (the text
    after it at 2, 3, ...), an enc-dec's source frames."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(size=(B, PATCHES, cfg.d_model)).astype(np.float32)
        grid = np.array([[0] * PATCHES, [i // 2 for i in range(PATCHES)],
                         [i % 2 for i in range(PATCHES)]])
        text = np.broadcast_to(np.arange(2, 2 + S), (3, S))
        batch["pos3"] = np.broadcast_to(np.concatenate([grid, text], 1),
                                        (B, 3, PATCHES + S)).astype(np.int32)
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(B, FRAMES, cfg.d_model)).astype(np.float32)
    return batch


def torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_grads(model, loss) -> list:
    plist = list(model.parameters())
    grads = torch.autograd.grad(loss, plist, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(plist, grads)]


@pytest.fixture(scope="module", params=NAMES)
def case(request):
    rcfg, cfg = configs(request.param)
    rmodel = ref_get_model(rcfg)
    params, _ = rmodel.init(jax.random.PRNGKey(1))
    batch = train_batch(cfg, 0)
    vg = jax.jit(jax.value_and_grad(lambda p, b: rmodel.train_loss(p, b, None)))
    rloss, rgrads = vg(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(name=request.param, cfg=cfg, params=jax.tree.map(np.asarray, params),
                batch=batch, rloss=float(rloss), rgrads=flat(rgrads))


def test_loss_and_every_gradient_match_the_reference(case):
    cfg = case["cfg"]
    model = params_from_reference(case["params"], cfg, "cpu", train=True)
    loss = get_model(cfg).train_loss(model, torch_batch(case["batch"]))
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(loss.item(), case["rloss"], rtol=LOSS_TOL)
    got = flat(to_reference(model, port_grads(model, loss)))
    assert set(got) == set(case["rgrads"])
    for name, want in case["rgrads"].items():
        big = float(np.abs(want).max())
        np.testing.assert_allclose(got[name], want, rtol=0, atol=GRAD_TOL * max(big, 1e-30),
                                   err_msg=name)


@pytest.mark.parametrize("name", [n for n, c in REF_SMOKES.items() if c.family == "moe"])
def test_moe_aux_loss_is_in_the_loss(name):
    """The loss is the cross-entropy plus 0.01 x the aux loss summed over the
    MoE layers, a term the parity test would see dropped (it moves the loss
    by more than ``LOSS_TOL``)."""
    rcfg, cfg = configs(name)
    params = jax.tree.map(np.asarray, ref_get_model(rcfg).init(jax.random.PRNGKey(1))[0])
    model = params_from_reference(params, cfg, "cpu", train=True)
    batch = torch_batch(train_batch(cfg, 0))
    with torch.no_grad():
        x, (cos, sin) = model._embed(batch["tokens"], None, None, None)
        aux = torch.zeros(())
        for blk in model.blocks:
            x, a = blk.train_fwd(x, cos, sin)
            aux = aux + a
        ce = L.cross_entropy(model.logits(model._finish(x)), batch["labels"])
        loss = model.train_loss(batch)
    assert float(0.01 * aux) > 10 * LOSS_TOL * float(loss)
    assert float(loss) == float(ce + 0.01 * aux)


@pytest.mark.parametrize("policy", ["none", *POLICIES])
def test_every_remat_policy_gives_the_gradients_of_none(case, policy):
    cfg = case["cfg"]
    model = params_from_reference(case["params"], cfg, "cpu", train=True)
    api, batch = get_model(cfg), torch_batch(case["batch"])
    want = port_grads(model, api.train_loss(model, batch))
    loss = api.train_loss(model, batch, get_policy(policy))
    for g, w in zip(port_grads(model, loss), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("form", ["serving f32", "training bf16"])
def test_params_to_reference_inverts_params_from_reference(name, form):
    """Every leaf back exactly, with the reference's names, shapes and dtype
    (f32): the serving form of an f32 config, the training form (f32
    weights) of a bf16 config."""
    rcfg, cfg = (configs(name) if form == "serving f32"
                 else configs(name, jnp.bfloat16, torch.bfloat16))
    params = jax.tree.map(np.asarray, ref_get_model(rcfg).init(jax.random.PRNGKey(2))[0])
    model = params_from_reference(params, cfg, "cpu", train=form != "serving f32")
    want, got = flat(params), flat(params_to_reference(model))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    stacked = {path: stack for path, (stack, _) in layout(model).items()}
    assert {k: v.shape[:len(stacked[k])] for k, v in got.items()} == stacked
