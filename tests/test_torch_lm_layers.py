"""The port's dense transformer layers against the JAX reference's, on the CPU.

Each function of ``repro_torch.models.layers`` takes the same inputs, made from
a seed with numpy, as its counterpart in ``repro.models.layers``: weights as
f32 dicts (the reference casts them at use, and so does the port), activations
in f32 or bf16.  Tolerances: f32 within ``rtol``/``atol`` 1e-5; bf16 within
2e-2 (torch and XLA round bf16 products and sums in different orders).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as REF_SMOKES
from repro.models import layers as RL

from repro_torch.configs import SMOKES
from repro_torch.models import layers as L

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def cfgs(arch: str, dt: str, **kw):
    jdt, tdt, _ = DTYPES[dt]
    return (dataclasses.replace(REF_SMOKES[arch], dtype=jdt, **kw),
            dataclasses.replace(SMOKES[arch], dtype=tdt, **kw))


def arr(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def both(a: np.ndarray, dt: str):
    """One numpy array as the reference's and the port's activation in ``dt``."""
    jdt, tdt, _ = DTYPES[dt]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def weights(d: dict):
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.from_numpy(v) for k, v in d.items()})


def close(ref, got, dt: str):
    tol = DTYPES[dt][2]
    r = np.asarray(jnp.asarray(ref, jnp.float32))
    g = got.float().numpy()
    assert r.shape == g.shape
    assert got.dtype == DTYPES[dt][1] or dt == "f32"
    np.testing.assert_allclose(g, r, rtol=tol, atol=tol)


@pytest.mark.parametrize("dt", DTYPES)
def test_rms_norm(dt):
    rng = np.random.default_rng(0)
    rx, px = both(arr(rng, (2, 5, 64), 3.0), dt)
    scale = arr(rng, (64,))
    close(RL.rms_norm(rx, jnp.asarray(scale), 1e-5),
          L.rms_norm(px, torch.from_numpy(scale), 1e-5), dt)


@pytest.mark.parametrize("dt", DTYPES)
def test_apply_rope(dt):
    rng = np.random.default_rng(1)
    rx, px = both(arr(rng, (2, 7, 4, 16)), dt)
    pos = rng.integers(0, 300, (2, 7)).astype(np.int32)
    close(RL.apply_rope(rx, jnp.asarray(pos), 10_000.0),
          L.apply_rope(px, torch.from_numpy(pos), 10_000.0), dt)
    np.testing.assert_array_equal(L.rope_freqs(16, 1e4), RL.rope_freqs(16, 1e4))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "smollm-360m"])   # with and without bias
def test_attention_qkv(arch, dt):
    rcfg, cfg = cfgs(arch, dt)
    assert cfg.qkv_bias == (arch == "qwen1.5-0.5b")
    rng = np.random.default_rng(2)
    p = {k: np.asarray(v) for k, v in L.attention_init(torch.Generator().manual_seed(0),
                                                       cfg).items()}
    for b in ("bq", "bk", "bv"):
        if b in p:
            p[b] = arr(rng, p[b].shape)       # nonzero biases, to see them added
    rp, pp = weights(p)
    rx, px = both(arr(rng, (2, 5, cfg.d_model)), dt)
    for r, g in zip(RL.attention_qkv(rp, rx, rcfg), L.attention_qkv(pp, px, cfg)):
        close(r, g, dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("groups", [1, 3])
@pytest.mark.parametrize("per_slot", [False, True])
def test_attention_decode(groups, per_slot, dt):
    rng = np.random.default_rng(3)
    B, S, Hkv, hd = 3, 12, 2, 16
    rq, pq = both(arr(rng, (B, 1, Hkv * groups, hd)), dt)
    rk, pk = both(arr(rng, (B, S, Hkv, hd)), dt)
    rv, pv = both(arr(rng, (B, S, Hkv, hd)), dt)
    if per_slot:
        lens = np.array([1, 7, 12], np.int32)
        rlen, plen = jnp.asarray(lens), torch.from_numpy(lens)
    else:
        rlen, plen = jnp.int32(9), 9
    close(RL.attention_decode(rq, rk, rv, rlen), L.attention_decode(pq, pk, pv, plen), dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("chunks,kv_offset", [((16, 16), 0), ((4, 8), 0), ((8, 4), 5)])
def test_flash_attention(chunks, kv_offset, dt):
    rng = np.random.default_rng(4)
    B, S, H, Hkv, hd = 2, 16, 4, 2, 8
    rq, pq = both(arr(rng, (B, S, H, hd)), dt)
    rk, pk = both(arr(rng, (B, S, Hkv, hd)), dt)
    rv, pv = both(arr(rng, (B, S, Hkv, hd)), dt)
    qc, kc = chunks
    close(RL.flash_attention(rq, rk, rv, causal=True, q_chunk=qc, kv_chunk=kc,
                             kv_offset=kv_offset),
          L.flash_attention(pq, pk, pv, causal=True, q_chunk=qc, kv_chunk=kc,
                            kv_offset=kv_offset), dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("mlp", ["swiglu", "relu2", "gelu"])
def test_mlp_apply(mlp, dt):
    rcfg, cfg = cfgs("qwen1.5-0.5b", dt, mlp=mlp)
    rng = np.random.default_rng(5)
    p = {k: np.asarray(v) for k, v in L.mlp_init(torch.Generator().manual_seed(1),
                                                 cfg).items()}
    assert set(p) == ({"w_gate", "w_up", "w_down"} if mlp == "swiglu" else {"w_up", "w_down"})
    rp, pp = weights(p)
    rx, px = both(arr(rng, (2, 3, cfg.d_model)), dt)
    close(RL.mlp_apply(rp, rx, rcfg), L.mlp_apply(pp, px, cfg), dt)


@pytest.mark.parametrize("dt", DTYPES)
def test_embed_lookup(dt):
    rcfg, cfg = cfgs("qwen1.5-0.5b", dt)
    p = {k: np.asarray(v) for k, v in L.embed_init(torch.Generator().manual_seed(2),
                                                   cfg).items()}
    rp, pp = weights(p)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    got = L.embed_lookup(pp, torch.from_numpy(toks), cfg)
    assert got.dtype == cfg.dtype
    close(RL.embed_lookup(rp, jnp.asarray(toks), rcfg), got, dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("tied", [False, True])
def test_lm_logits_over_a_padded_vocab(tied, dt):
    rcfg, cfg = cfgs("qwen1.5-0.5b", dt, vocab=250, tie_embeddings=tied)
    assert L.padded_vocab(cfg.vocab) == RL.padded_vocab(cfg.vocab) == 256
    p = {k: np.asarray(v) for k, v in L.embed_init(torch.Generator().manual_seed(3),
                                                   cfg).items()}
    assert ("lm_head" in p) == (not tied) and p["embedding"].shape == (256, cfg.d_model)
    rp, pp = weights(p)
    rx, px = both(arr(np.random.default_rng(7), (2, 3, cfg.d_model)), dt)
    ref, got = RL.lm_logits(rp, rx, rcfg), L.lm_logits(pp, px, cfg)
    assert got.shape == (2, 3, 256)
    # the padding is masked with the same value, in the logits' dtype
    np.testing.assert_array_equal(got[..., 250:].float().numpy(),
                                  np.asarray(ref[..., 250:], np.float32))
    close(ref[..., :250], got[..., :250], dt)
