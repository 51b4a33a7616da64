"""The port's MoE, VLM, RWKV6, Zamba2 and enc-dec models against the JAX
reference's, on the CPU.

The reduced (SMOKE) configs of phi3.5-moe and dbrx (MoE), qwen2-vl (M-RoPE,
a patch-embedding prefix), rwkv6 (attention-free), zamba2 (Mamba2 + a shared
attention block; the SMOKE config has no tail layer and an unused
``mamba_tail``, ``zamba2-7b-tail`` has one) and seamless-m4t (enc-dec).  The
reference initialises its params from a ``PRNGKey``; ``params_from_reference``
carries them into the port: every value exactly.  Then ``forward``,
``prefill`` and each ``decode_step`` of both packages take the same inputs,
made from numpy seeds: logits and every state tensor within 1e-4 in f32, and
within the reference's 0.12 in bf16 -- where routing allows: a bf16 MoE
router whose top-k is nearly tied (two experts' logits within ``TIE_GAP``,
not equal) may pick another expert than the reference's, and from there on
that token and those after it may differ by more than bf16 rounding; they
are left out of the comparison.  Zamba2 in
bf16 is held in ``test_torch_lm_families_parts.py``, which with
``test_torch_lm_families_serve.py`` shares the helpers here.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as REF_SMOKES
from repro.models import encdec as RED
from repro.models import get_model as ref_get_model
from repro.models import layers as RL
from repro.models import rwkv as RR
from repro.models import transformer as RT
from repro.models import zamba as RZ

from repro_torch.configs import SMOKES
from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.models.weights import params_from_reference

# name -> (arch, config changes): zamba2 with two super-blocks and a tail layer
VARIANTS = {"zamba2-7b-tail": ("zamba2-7b", {"n_layers": 5})}
NAMES = ["phi3.5-moe-42b-a6.6b", "dbrx-132b", "qwen2-vl-2b", "rwkv6-7b", "zamba2-7b",
         "zamba2-7b-tail", "seamless-m4t-medium"]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4), "bf16": (jnp.bfloat16, torch.bfloat16, 0.12)}
# what the reference reads in f32 whatever the config's dtype
F32_NAMES = {"norm", "norm1", "norm2", "norm3", "final_norm", "enc_norm", "ln_x", "ssm_norm",
             "w0", "u", "A_log", "D_skip", "dt_bias"}
B, PROMPT, STEPS = 2, 8, 4
TIE_GAP = 0.01          # bf16 router: a top-k logit gap below this (not 0) may flip
PATCHES, FRAMES = 4, 32


def configs(name: str, dt: str):
    arch, kw = VARIANTS.get(name, (name, {}))
    jdt, tdt, _ = DTYPES[dt]
    return (dataclasses.replace(REF_SMOKES[arch], dtype=jdt, **kw),
            dataclasses.replace(SMOKES[arch], dtype=tdt, **kw))


@pytest.fixture(scope="module", params=[(n, d) for n in NAMES for d in DTYPES
                                        if not (n.startswith("zamba") and d == "bf16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    """Both packages' models of one config, on the reference's params."""
    return make_pair(*request.param)


def make_pair(name: str, dt: str):
    rcfg, cfg = configs(name, dt)
    rmodel = ref_get_model(rcfg)
    params, _ = rmodel.init(jax.random.PRNGKey(1))
    return types.SimpleNamespace(
        name=name, rcfg=rcfg, cfg=cfg, rmodel=rmodel, params=params, api=get_model(cfg),
        model=params_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu"),
        tol=DTYPES[dt][2], ref_prefill=jax.jit(rmodel.prefill),
        ref_decode=jax.jit(rmodel.decode_step))


def pos3_ids(n_text: int) -> np.ndarray:
    """(B, 3, PATCHES + n_text) Qwen2-VL positions: a 2x2 patch grid at t = 0
    (h, w its row and column), then the text at 2, 3, ... on all three."""
    grid = np.array([[0] * PATCHES, [i // 2 for i in range(PATCHES)],
                     [i % 2 for i in range(PATCHES)]])
    text = np.broadcast_to(np.arange(2, 2 + n_text), (3, n_text))
    return np.broadcast_to(np.concatenate([grid, text], 1), (B, 3, PATCHES + n_text)).astype(
        np.int32)


def inputs(cfg, n: int, seed: int) -> dict:
    """The reference's prefill batch for ``cfg``'s family, as numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, n)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(size=(B, PATCHES, cfg.d_model)).astype(np.float32)
        batch["pos3"] = pos3_ids(n)
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(B, FRAMES, cfg.d_model)).astype(np.float32)
    return batch


class NearTies:
    """Records, while active, the flattened token indices (b * S + s) of each
    port MoE router call whose k-th and (k+1)-th logits are within ``TIE_GAP``
    but not equal: where bf16 may route otherwise than the reference."""

    def __init__(self, monkeypatch):
        self.calls: list[np.ndarray] = []
        route = L.moe_route

        def recorded(p, xg, cfg):
            probs, gate_v, gate_i = route(p, xg, cfg)
            top = torch.sort(probs, dim=-1, descending=True).values.reshape(-1, probs.shape[-1])
            gap = (torch.log(top[:, cfg.top_k - 1]) - torch.log(top[:, cfg.top_k])).numpy()
            self.calls.append(np.flatnonzero((gap > 0) & (gap < TIE_GAP)))
            return probs, gate_v, gate_i

        monkeypatch.setattr(L, "moe_route", recorded)

    def first(self) -> float:
        """The first near-tied token of the calls so far (inf if none)."""
        return min((float(c[0]) for c in self.calls if len(c)), default=np.inf)


def guard(p, monkeypatch):
    """A ``NearTies`` recorder for a bf16 MoE pair, else None."""
    if p.cfg.family == "moe" and p.cfg.dtype == torch.bfloat16:
        return NearTies(monkeypatch)
    return None


def close(ref, got: torch.Tensor, tol: float, what: str = ""):
    r = np.asarray(jnp.asarray(ref, jnp.float32))
    assert r.shape == tuple(got.shape), what
    np.testing.assert_allclose(got.float().numpy(), r, rtol=tol, atol=tol, err_msg=what)


def close_state(rst: dict, pst: dict, tol: float):
    assert set(pst) == set(rst)
    assert pst["len"] == int(rst["len"])
    for k in rst:
        if k != "len":
            assert str(pst[k].dtype) == f"torch.{rst[k].dtype}", k
            close(rst[k], pst[k], tol, k)


def restack(tree):
    """The port's tree (layers as lists) stacked as the reference's, as numpy."""
    if isinstance(tree, dict):
        return {k: restack(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return jax.tree.map(lambda *xs: torch.stack(xs), *[restack(t) for t in tree])
    return tree


def flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def ref_forward(p, batch):
    """The reference's hidden states of the whole sequence."""
    cfg, params = p.rcfg, p.params
    j = {k: jnp.asarray(v) for k, v in batch.items()}
    if cfg.family in ("moe", "vlm"):
        return RT.forward(params, cfg, j["tokens"], pos3=j.get("pos3"),
                          prefix_embeds=j.get("patch_embeds"))[0]
    if cfg.family == "ssm":
        return RR.forward(params, cfg, j["tokens"])[0]
    if cfg.family == "hybrid":
        return RZ._forward(params, cfg, j["tokens"], None, "train")[0]
    return RED.decode_train(params, cfg, j["tokens"], RED.encode(params, cfg, j["frames"]))


def port_forward(p, batch):
    m = p.model
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    if p.cfg.family in ("moe", "vlm"):
        return m(t["tokens"], pos3=t.get("pos3"), prefix_embeds=t.get("patch_embeds"))
    if p.cfg.family == "ssm":
        return m(t["tokens"])[0]
    if p.cfg.family == "hybrid":
        return m(t["tokens"])
    return m(t["tokens"], m.encode(t["frames"]))


# ------------------------------------------------------------------ per family

def test_weights_carry_exactly(pair):
    want = flat(pair.params)
    got = flat(restack(pair.model.tree()))
    assert set(got) == set(want)
    for name, r in want.items():
        dt = torch.float32 if name.split("/")[-1] in F32_NAMES else pair.cfg.dtype
        assert got[name].dtype == dt, name
        np.testing.assert_array_equal(
            got[name].float().numpy(),
            torch.from_numpy(np.array(r)).to(dt).float().numpy(), err_msg=name)


def test_forward(pair, monkeypatch):
    batch = inputs(pair.cfg, 2 * PROMPT, seed=2)
    ties = guard(pair, monkeypatch)
    with torch.inference_mode():
        got = port_forward(pair, batch)
        x = ref_forward(pair, batch)
        outs = [(x, got), (RL.lm_logits(pair.params["embed"], x, pair.rcfg),
                           pair.model.logits(got))]
    keep = got.shape[0] * got.shape[1]
    if ties is not None:                 # the tokens before the first near tie
        keep = int(min(ties.first(), keep))
    for r, g in outs:
        close(np.asarray(r, np.float32).reshape(-1, r.shape[-1])[:keep],
              g.reshape(-1, g.shape[-1])[:keep], pair.tol)


def test_prefill_then_decode_steps_logits_and_state(pair, monkeypatch):
    """Logits of the prefill and of each step, then every state tensor.  A
    bf16 MoE pair compares the calls before its first near tie."""
    batch = inputs(pair.cfg, PROMPT, seed=3)
    steps = np.random.default_rng(4).integers(0, pair.cfg.vocab, (B, STEPS)).astype(np.int32)
    rst, pst = pair.rmodel.make_state(B, 24), pair.api.make_state(B, 24, device="cpu")
    close_state(rst, pst, 0.0)
    ties = guard(pair, monkeypatch)
    tied = lambda: ties is not None and ties.first() < np.inf
    rl, rst = pair.ref_prefill(pair.params, {k: jnp.asarray(v) for k, v in batch.items()},
                               rst)
    with torch.inference_mode():
        pl, pst = pair.api.prefill(pair.model, {k: torch.from_numpy(v)
                                                for k, v in batch.items()}, pst)
        compared = 0
        if not tied():
            close(rl, pl, pair.tol, "prefill")
            close_state(rst, pst, pair.tol)
            compared += 1
        for t in range(STEPS):
            rl, rst = pair.ref_decode(pair.params, jnp.asarray(steps[:, t:t + 1]), rst)
            pl, pst = pair.api.decode_step(pair.model, torch.from_numpy(steps[:, t:t + 1]),
                                           pst)
            if not tied():
                close(rl, pl, pair.tol, f"step {t}")
                compared += 1
    if not tied():
        close_state(rst, pst, pair.tol)
    assert compared == STEPS + 1 or ties is not None
    assert pst["len"] == int(rst["len"])
    if pair.cfg.family == "encdec":      # the cross K/V as long as the memory
        assert pst["ck"].shape[2] == FRAMES
    if pair.cfg.family == "vlm":
        assert pst["len"] == PATCHES + PROMPT + STEPS
