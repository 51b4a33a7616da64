"""Parts of the port's MoE, VLM, RWKV6, Zamba2 and enc-dec models against
the JAX reference's, on the CPU (the whole models are in
``test_torch_lm_families.py``, whose helpers these tests share).

The port's own init and state against the reference's shapes, dtypes and
scales; ``with_dtype``; the model API taking the card unless asked for the
CPU; Zamba2 in bf16, held to the reference's own distance between its bf16
and f32 runs (its Mamba layers turn one-ulp bf16 differences -- sums and
``jax.nn.silu``/``sigmoid`` rounded in another order -- into up to 0.18-0.50
on the SMOKE logits, below the reference's own 0.28-0.59); MoE routing (ties go to the lower
expert, as ``jax.lax.top_k`` orders them; capacity drops; the group shapes
the reference refuses); M-RoPE; the chunked recurrences against their
stepwise selves and the reference's, and the chunk lengths both refuse; the
unused tail layer of a Zamba2 without a tail.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import get_model as ref_get_model
from repro.models import layers as RL
from repro.models import ssm as RS

from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.models import ssm as S_
from repro_torch.models.weights import params_from_reference
from test_torch_lm_families import (B, DTYPES, F32_NAMES, NAMES, PROMPT, close, close_state,
                                    configs, flat, inputs, make_pair, port_forward,
                                    ref_forward, restack)


@pytest.mark.parametrize("name", NAMES)
def test_own_init_has_the_references_shapes_dtypes_and_scales(name):
    rcfg, cfg = configs(name, "bf16")
    ref, _ = ref_get_model(rcfg).init(jax.random.PRNGKey(0))
    model = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    rflat, got = flat(ref), flat(restack(model.tree()))
    assert set(got) == set(rflat)
    for name_, r in rflat.items():
        g, r = got[name_], np.asarray(r)
        assert tuple(g.shape) == r.shape, name_
        leaf = name_.split("/")[-1]
        assert g.dtype == (torch.float32 if leaf in F32_NAMES else cfg.dtype), name_
        g = g.float().numpy()
        if r.std() == 0:                 # ones, zeros, constants
            np.testing.assert_array_equal(g, r, err_msg=name_)
        else:                            # two samples' std: ~1/sqrt(n) apart
            assert abs(g.std() / r.std() - 1) < 4 / np.sqrt(r.size), (name_, g.std(), r.std())


@pytest.mark.parametrize("name", NAMES)
def test_make_state_is_the_references(name):
    rcfg, cfg = configs(name, "bf16")
    rst = ref_get_model(rcfg).make_state(3, 40)
    pst = get_model(cfg).make_state(3, 40, device="cpu")
    close_state(rst, pst, 0.0)


@pytest.mark.parametrize("name", NAMES)
def test_model_api_takes_the_card_unless_asked_for_the_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rcfg, cfg = configs(name, "f32")
    api = get_model(cfg)
    params, _ = ref_get_model(rcfg).init(jax.random.PRNGKey(0))
    for make in (lambda: api.init(), lambda: api.make_state(2, 8),
                 lambda: params_from_reference(jax.tree.map(np.asarray, params), cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert api.init(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("name", ["phi3.5-moe-42b-a6.6b", "rwkv6-7b", "zamba2-7b",
                                  "seamless-m4t-medium"])
def test_with_dtype_is_the_bf16_init_of_the_same_draws(name):
    _, cfg = configs(name, "bf16")
    f32 = get_model(dataclasses.replace(cfg, dtype=torch.float32)).init(
        torch.Generator().manual_seed(5), "cpu")
    bf16 = get_model(cfg).init(torch.Generator().manual_seed(5), "cpu")
    cast = f32.with_dtype(torch.bfloat16)
    assert type(cast) is type(bf16) and cast.cfg == bf16.cfg
    for (n, a), (m, b) in zip(cast.named_parameters(), bf16.named_parameters()):
        assert n == m and a.dtype == b.dtype and torch.equal(a, b), n


@pytest.mark.parametrize("name", ["zamba2-7b", "zamba2-7b-tail"])
def test_zamba_bf16_is_as_close_as_the_references_own_bf16(name):
    """Forward, prefill and decode-step logits in bf16 against the
    reference's bf16, held to the reference's own bf16-to-f32 distance on
    the same inputs (and at least 0.12)."""
    b16, f32 = make_pair(name, "bf16"), make_pair(name, "f32")
    batch = inputs(b16.cfg, 2 * PROMPT, seed=2)
    tol = max(0.12, float(np.abs(np.asarray(ref_forward(b16, batch), np.float32)
                                 - np.asarray(ref_forward(f32, batch))).max()))
    with torch.inference_mode():
        close(ref_forward(b16, batch), port_forward(b16, batch), tol, "forward")
        rst, pst = b16.rmodel.make_state(B, 24), b16.api.make_state(B, 24, device="cpu")
        rst32 = f32.rmodel.make_state(B, 24)
        jb = {"tokens": jnp.asarray(batch["tokens"][:, :PROMPT])}
        rl, rst = b16.ref_prefill(b16.params, jb, rst)
        rl32, rst32 = f32.ref_prefill(f32.params, jb, rst32)
        pl, pst = b16.model.prefill(torch.from_numpy(batch["tokens"][:, :PROMPT]), pst)
        outs = [(rl, rl32, pl)]
        for t in range(PROMPT, 2 * PROMPT):
            tok = batch["tokens"][:, t:t + 1]
            rl, rst = b16.ref_decode(b16.params, jnp.asarray(tok), rst)
            rl32, rst32 = f32.ref_decode(f32.params, jnp.asarray(tok), rst32)
            pl, pst = b16.model.decode_step(torch.from_numpy(tok), pst)
            outs.append((rl, rl32, pl))
    for i, (r, r32, p) in enumerate(outs):
        floor = float(np.abs(np.asarray(r, np.float32) - np.asarray(r32)).max())
        close(r, p, max(0.12, floor), f"call {i}")
    assert pst["len"] == int(rst["len"]) == 2 * PROMPT


# ------------------------------------------------------------------------ MoE

def moe_weights(cfg, seed: int, tie: bool = False):
    rng = np.random.default_rng(seed)
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": rng.normal(size=(D, E)).astype(np.float32) / np.sqrt(D),
         "experts_gate": rng.normal(size=(E, D, Fd)).astype(np.float32) / np.sqrt(D),
         "experts_up": rng.normal(size=(E, D, Fd)).astype(np.float32) / np.sqrt(D),
         "experts_down": rng.normal(size=(E, Fd, D)).astype(np.float32) / np.sqrt(Fd)}
    if tie:                              # experts 1 and 2 share a router column
        p["router"][:, 2] = p["router"][:, 1]
    return p


def moe_both(cfg_kw: dict, dt: str, seed: int, n_tokens=(2, 32), tie=False, zero=False):
    rcfg, cfg = configs("phi3.5-moe-42b-a6.6b", dt)
    rcfg, cfg = (dataclasses.replace(c, **cfg_kw) for c in (rcfg, cfg))
    p = moe_weights(cfg, seed, tie)
    if zero:                             # every router logit equal
        p["router"][:] = 0
    x = np.random.default_rng(seed + 1).normal(size=(*n_tokens, cfg.d_model)).astype(
        np.float32)
    jdt, tdt, tol = DTYPES[dt]
    ry, raux = RL.moe_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x, jdt),
                            rcfg)
    py, paux = L.moe_apply({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x).to(tdt), cfg)
    return (ry, raux), (py, paux), (rcfg, cfg, p, x), tol


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", ["random", "tied", "all-tied", "drops"])
def test_moe_apply_and_aux_equal_the_references(case, dt):
    """y and the aux loss: random routing; two experts tied for every token;
    every logit equal (experts 0 and 1 chosen, in that order, for every
    token, so capacity drops follow the token order); and a capacity small
    enough to drop tokens, which drops the reference's tokens (their rows
    of y are zero in both)."""
    kw = {"capacity_factor": 0.5} if case == "drops" else {}
    (ry, raux), (py, paux), _, tol = moe_both(kw, dt, seed=7, tie=case == "tied",
                                              zero=case == "all-tied")
    close(ry, py, tol)
    close(raux, paux, 1e-5)
    if case in ("drops", "all-tied"):
        dropped = np.all(np.asarray(ry, np.float32) == 0, axis=-1)
        assert dropped.any()
        np.testing.assert_array_equal(np.all(py.float().numpy() == 0, axis=-1), dropped)


@pytest.mark.parametrize("tie", [False, True], ids=["random", "tied"])
def test_moe_top_k_is_jax_top_k(tie):
    """The port's router against the reference's lines (softmax of the f32
    router logits, ``jax.lax.top_k``; ``src/repro/models/layers.py:309-311``):
    equal expert ids, ties (forced equal router columns) lower id first."""
    _, cfg = configs("phi3.5-moe-42b-a6.6b", "f32")
    p = moe_weights(cfg, 9, tie)
    xg = np.random.default_rng(10).normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    probs = jax.nn.softmax((jnp.asarray(xg) @ jnp.asarray(p["router"])).astype(jnp.float32),
                           axis=-1)
    rv, ri = jax.lax.top_k(probs, cfg.top_k)
    pprobs, pv, pi = L.moe_route({"router": torch.from_numpy(p["router"])},
                                 torch.from_numpy(xg), cfg)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    close(rv, pv, 1e-6)
    close(probs, pprobs, 1e-6)
    if tie:                              # both tied experts chosen: 1 before 2
        both = (np.asarray(ri) == 1).any(-1) & (np.asarray(ri) == 2).any(-1)
        assert both.any()
        first = np.asarray(ri)[both]
        assert (np.argmax(first == 1, -1) < np.argmax(first == 2, -1)).all()


def test_moe_refuses_the_group_shapes_the_reference_refuses():
    """B*S above ``moe_group_size`` (512) and no multiple of it: the reference
    asserts, the port raises; a multiple splits into groups in both."""
    with pytest.raises(AssertionError):
        moe_both({"moe_group_size": 512}, "f32", seed=11, n_tokens=(2, 300))
    with pytest.raises(ValueError, match="groups of 512"):
        _, cfg = configs("phi3.5-moe-42b-a6.6b", "f32")
        cfg = dataclasses.replace(cfg, moe_group_size=512)
        L.moe_apply({k: torch.from_numpy(v) for k, v in moe_weights(cfg, 11).items()},
                    torch.zeros((2, 300, cfg.d_model)), cfg)
    (ry, _), (py, _), _, tol = moe_both({"moe_group_size": 512}, "f32", seed=12,
                                        n_tokens=(2, 512))
    close(ry, py, tol)


# ------------------------------------------------------------------------ VLM

@pytest.mark.parametrize("dt", DTYPES)
def test_apply_mrope_equals_the_references(dt):
    rcfg, cfg = configs("qwen2-vl-2b", dt)
    rng = np.random.default_rng(13)
    x = rng.normal(size=(B, 12, cfg.n_heads, cfg.hd)).astype(np.float32)
    pos3 = rng.integers(0, 50, (B, 3, 12)).astype(np.int32)
    jdt, tdt, tol = DTYPES[dt]
    want = RL.apply_mrope(jnp.asarray(x, jdt), jnp.asarray(pos3), cfg.rope_theta,
                          cfg.mrope_sections)
    got = L.apply_mrope(torch.from_numpy(x).to(tdt), torch.from_numpy(pos3), cfg.rope_theta,
                        cfg.mrope_sections)
    assert got.dtype == tdt
    close(want, got, 1e-5 if dt == "f32" else 2e-2)
    # equal streams are plain RoPE
    same = np.broadcast_to(pos3[:, :1], pos3.shape)
    close(L.apply_rope(torch.from_numpy(x), torch.from_numpy(same[:, 0].copy()),
                       cfg.rope_theta),
          L.apply_mrope(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(same)),
                        cfg.rope_theta, cfg.mrope_sections), 0.0)
    with pytest.raises(ValueError, match="sections"):
        L.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), cfg.rope_theta, (4, 2, 1))


# ------------------------------------------------------------ RWKV and Mamba

@pytest.mark.parametrize("name,seq", [("rwkv6-7b", 24), ("zamba2-7b", 16)])
def test_chunked_recurrence_equals_its_stepwise_self(name, seq):
    """The reference's ``test_rwkv_chunked_equals_stepwise`` and
    ``test_mamba_chunked_equals_stepwise`` on the port, in f32: chunks of 8
    against chunks of 1 (the pure recurrence), hidden states and states; and
    chunks of 8 against the reference's."""
    rcfg, cfg = configs(name, "f32")
    rcfg, cfg = (dataclasses.replace(c, ssm_chunk=8) for c in (rcfg, cfg))
    params, _ = ref_get_model(rcfg).init(jax.random.PRNGKey(3))
    model = params_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    step = type(model)(dataclasses.replace(cfg, ssm_chunk=1), model.tree())
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (B, seq)).astype(np.int32)
    api = get_model(cfg)
    with torch.inference_mode():
        xa, sa = model.prefill(torch.from_numpy(toks), api.make_state(B, seq, device="cpu"))
        xb, sb = step.prefill(torch.from_numpy(toks), api.make_state(B, seq, device="cpu"))
    close(xa.numpy(), xb, 1e-4)
    for k in ("wkv", "ssd", "conv"):
        if k in sa:
            close(sa[k].numpy(), sb[k], 1e-4, k)
    rl, rst = jax.jit(ref_get_model(rcfg).prefill)(
        params, {"tokens": jnp.asarray(toks)}, ref_get_model(rcfg).make_state(B, seq))
    close(rl, xa, 1e-4)
    close_state(rst, sa, 1e-4)


@pytest.mark.parametrize("name", ["rwkv6-7b", "zamba2-7b"])
def test_a_length_the_chunk_does_not_divide_is_refused(name):
    rcfg, cfg = configs(name, "f32")
    rcfg, cfg = (dataclasses.replace(c, ssm_chunk=8) for c in (rcfg, cfg))
    params, _ = ref_get_model(rcfg).init(jax.random.PRNGKey(3))
    model = params_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    toks = np.zeros((B, 12), np.int32)
    with pytest.raises(AssertionError):
        ref_get_model(rcfg).prefill(params, {"tokens": jnp.asarray(toks)},
                                    ref_get_model(rcfg).make_state(B, 16))
    with pytest.raises(ValueError, match="chunks of 8"):
        model.prefill(torch.from_numpy(toks), get_model(cfg).make_state(B, 16, device="cpu"))


@pytest.mark.parametrize("fn", ["wkv", "ssd"])
def test_recurrence_kernels_equal_the_references(fn):
    """``_wkv_chunked`` and ``_ssd_chunked`` alone, f32, a carried-in state,
    decays strong enough that the clamp at 60 is reached."""
    rng = np.random.default_rng(14)
    Bn, S, H, hd, N = 2, 16, 3, 8, 5
    if fn == "wkv":
        r, k, v = (rng.normal(size=(Bn, S, H, hd)).astype(np.float32) for _ in range(3))
        logw = -np.exp(rng.normal(size=(Bn, S, H, hd)) * 2 + 1).astype(np.float32)
        u = rng.normal(size=(H, hd)).astype(np.float32)
        s0 = rng.normal(size=(Bn, H, hd, hd)).astype(np.float32)
        args = (r, k, v, logw, u, s0)
        ry, rs = RS._wkv_chunked(*map(jnp.asarray, args), 8)
        py, ps = S_._wkv_chunked(*map(torch.from_numpy, args), 8)
    else:
        x = rng.normal(size=(Bn, S, H, hd)).astype(np.float32)
        Bm, Cm = (rng.normal(size=(Bn, S, N)).astype(np.float32) for _ in range(2))
        la = -np.exp(rng.normal(size=(Bn, S, H)) * 2 + 1).astype(np.float32)
        h0 = rng.normal(size=(Bn, H, hd, N)).astype(np.float32)
        args = (x, Bm, Cm, la, h0)
        ry, rs = RS._ssd_chunked(*map(jnp.asarray, args), 8)
        py, ps = S_._ssd_chunked(*map(torch.from_numpy, args), 8)
    decay = args[3].reshape(Bn, S // 8, 8, -1)
    assert float(-np.cumsum(decay, axis=2).min()) > 60
    close(ry, py, 1e-4)
    close(rs, ps, 1e-4)


# --------------------------------------------------------------------- Zamba

def test_zamba_without_a_tail_carries_an_unused_tail_layer():
    """The SMOKE config (4 layers, a shared block every 2) has no tail: its
    ``mamba_tail`` holds one layer, as the reference's tree does, and that
    layer's weights change nothing."""
    _, cfg = configs("zamba2-7b", "f32")
    model = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    assert len(model.mamba_tail) == 1 and len(model.mamba_main) == 2
    toks = torch.from_numpy(np.random.default_rng(15).integers(0, cfg.vocab, (B, 8)))
    with torch.inference_mode():
        before = model(toks)
        for w in model.mamba_tail[0].parameters():
            w.mul_(3.0)
        assert torch.equal(model(toks), before)
