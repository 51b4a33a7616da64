"""The port's dense transformer against the JAX reference's, on the CPU.

The reduced (SMOKE) configs of qwen1.5-0.5b (MHA with QKV bias) and
smollm-360m (GQA, 3 heads over 1).  The reference initialises its params from
a ``PRNGKey``; ``params_from_reference`` carries them into the port.  Then
``forward``, ``prefill``, ``decode_step`` and ``init_cache`` of both packages
take the same tokens: logits and caches within 1e-4 in f32, and within the
reference's own 0.12 in bf16.  Also: the reference's prefill/decode against
forward check (``tests/test_models.py``) repeated on the port, the port's own
init against the reference's shapes, dtypes and scales, and the model API
taking the card unless ``device="cpu"`` is passed.  The other families are
held to the reference in ``test_torch_lm_families.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import SMOKES as REF_SMOKES
from repro.configs import get_config as ref_get_config
from repro.models import cell_status as ref_cell_status
from repro.models import get_model as ref_get_model
from repro.models import layers as RL
from repro.models import transformer as RT

from repro_torch.configs import ARCHS, SMOKES, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.models import cell_status, get_model
from repro_torch.models import transformer as T
from repro_torch.models.weights import params_from_reference

ARCH_NAMES = ["qwen1.5-0.5b", "smollm-360m"]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4), "bf16": (jnp.bfloat16, torch.bfloat16, 0.12)}
B, S = 2, 16


@pytest.fixture(scope="module", params=[(a, d) for a in ARCH_NAMES for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    """(reference cfg, reference params, port cfg, port model) for one config."""
    arch, dt = request.param
    jdt, tdt, tol = DTYPES[dt]
    rcfg = dataclasses.replace(REF_SMOKES[arch], dtype=jdt)
    cfg = dataclasses.replace(SMOKES[arch], dtype=tdt)
    params, _ = ref_get_model(rcfg).init(jax.random.PRNGKey(1))
    model = params_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return rcfg, params, cfg, model, tol


@pytest.fixture(scope="module")
def ref_decode(pair):
    """The reference's ``decode_step`` under ``jax.jit`` (one trace per shape)."""
    rcfg = pair[0]
    return jax.jit(lambda p, t, st: RT.decode_step(p, rcfg, t, st))


def tokens(cfg, n=S, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, n)).astype(np.int32)


def close(ref, got: torch.Tensor, tol: float):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def test_weights_carry_exactly(pair):
    rcfg, params, cfg, model, _ = pair
    np.testing.assert_array_equal(
        model.blocks[1].attn["wq"].float().numpy(),
        np.asarray(jnp.asarray(params["layers"]["attn"]["wq"][1], rcfg.dtype), np.float32))
    assert model.blocks[0].norms["norm1"].dtype == torch.float32
    assert model.embed["embedding"].dtype == cfg.dtype


def test_forward(pair):
    rcfg, params, cfg, model, tol = pair
    toks = tokens(cfg)
    x, _ = RT.forward(params, rcfg, jnp.asarray(toks))
    with torch.inference_mode():
        got = model(torch.from_numpy(toks))
        close(x, got, tol)
        close(RL.lm_logits(params["embed"], x, rcfg), model.logits(got), tol)


def test_prefill_decode_step_and_cache(pair, ref_decode):
    rcfg, params, cfg, model, tol = pair
    toks = tokens(cfg)
    half = S // 2
    rst = RT.init_cache(rcfg, B, 24)
    pst = T.init_cache(cfg, B, 24, device="cpu")
    for k in ("k", "v"):
        assert tuple(pst[k].shape) == rst[k].shape and pst[k].dtype == cfg.dtype
    assert pst["len"] == int(rst["len"]) == 0
    rl, rst = RT.prefill(params, rcfg, jnp.asarray(toks[:, :half]), rst)
    with torch.inference_mode():
        pl, pst = model.prefill(torch.from_numpy(toks[:, :half]), pst)
        close(rl, pl, tol)
        for t in range(half, S):
            rl, rst = ref_decode(params, jnp.asarray(toks[:, t:t + 1]), rst)
            pl, pst = model.decode_step(torch.from_numpy(toks[:, t:t + 1]), pst)
            close(rl, pl, tol)
    assert pst["len"] == int(rst["len"]) == S
    close(rst["k"], pst["k"], tol)
    close(rst["v"], pst["v"], tol)


def test_decode_past_the_cache_writes_its_last_row(pair, ref_decode):
    """``dynamic_update_slice`` clamps its start: a 4-row cache decoded 6 times
    keeps writing row 3, and positions keep counting (both packages)."""
    rcfg, params, cfg, model, tol = pair
    toks = tokens(cfg, n=6, seed=3)
    rst, pst = RT.init_cache(rcfg, B, 4), T.init_cache(cfg, B, 4, device="cpu")
    with torch.inference_mode():
        for t in range(6):
            rl, rst = ref_decode(params, jnp.asarray(toks[:, t:t + 1]), rst)
            pl, pst = model.decode_step(torch.from_numpy(toks[:, t:t + 1]), pst)
            close(rl, pl, tol)
    close(rst["k"], pst["k"], tol)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "smollm-360m"])
def test_prefill_decode_matches_forward(arch):
    """The reference's ``test_prefill_decode_matches_forward`` on the port:
    prefill the first half, decode the rest one token at a time, against the
    full forward's logits, within the reference's 0.12 (bf16 serving)."""
    cfg = SMOKES[arch]
    model = get_model(cfg).init(torch.Generator().manual_seed(1), "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 32)))
    with torch.inference_mode():
        full = model.logits(model(toks))
        half = 16
        logits, state = model.prefill(toks[:, :half], T.init_cache(cfg, 2, 32, device="cpu"))
        outs = [logits]
        for t in range(half, 31):
            logits, state = model.decode_step(toks[:, t:t + 1], state)
            outs.append(logits)
    serve = torch.cat(outs, dim=1).float().numpy()
    np.testing.assert_allclose(serve, full[:, half - 1:31].float().numpy(),
                               rtol=0.12, atol=0.12)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_own_init_has_the_references_shapes_dtypes_and_scales(arch):
    rcfg, cfg = REF_SMOKES[arch], SMOKES[arch]
    ref, _ = ref_get_model(rcfg).init(jax.random.PRNGKey(0))
    model = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    tree = model.tree()
    rflat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(ref)[0]}
    flat = {}
    for k, v in tree["embed"].items():
        flat[f"embed/{k}"] = v
    flat["final_norm"] = tree["final_norm"]
    for part in ("attn", "mlp"):
        for k in tree["layers"][0][part]:
            flat[f"layers/{part}/{k}"] = torch.stack([lp[part][k] for lp in tree["layers"]])
    for k in ("norm1", "norm2"):
        flat[f"layers/{k}"] = torch.stack([lp[k] for lp in tree["layers"]])
    assert set(flat) == set(rflat)
    for name, r in rflat.items():
        got = flat[name]
        assert tuple(got.shape) == r.shape, name
        norm = name.endswith(("norm", "norm1", "norm2"))
        assert got.dtype == (torch.float32 if norm else cfg.dtype), name
        g = got.float().numpy()
        if norm or name.split("/")[-1] in ("bq", "bk", "bv"):
            np.testing.assert_array_equal(g, r, err_msg=name)     # ones and zeros
        else:
            assert abs(g.std() / r.std() - 1) < 0.1, (name, g.std(), r.std())
            assert abs(g.mean()) < 4 * r.std() / np.sqrt(r.size), name


def test_with_dtype_is_the_bf16_init_of_the_same_draws():
    cfg = SMOKES["qwen1.5-0.5b"]
    f32 = get_model(dataclasses.replace(cfg, dtype=torch.float32)).init(
        torch.Generator().manual_seed(5), "cpu")
    bf16 = get_model(cfg).init(torch.Generator().manual_seed(5), "cpu")
    cast = f32.with_dtype(torch.bfloat16)
    assert cast.cfg == bf16.cfg
    for (n, a), (m, b) in zip(cast.named_parameters(), bf16.named_parameters()):
        assert n == m and a.dtype == b.dtype and torch.equal(a, b), n


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_configs_are_the_references(arch, smoke):
    cfg, rcfg = get_config(arch, smoke), ref_get_config(arch, smoke)
    fields = [f.name for f in dataclasses.fields(cfg) if f.name != "dtype"]
    assert fields == [f.name for f in dataclasses.fields(rcfg) if f.name != "dtype"]
    assert all(getattr(cfg, f) == getattr(rcfg, f) for f in fields), arch
    assert cfg.dtype == torch.bfloat16 and rcfg.dtype == jnp.bfloat16
    assert (cfg.hd, cfg.param_count(), cfg.active_param_count()) == \
        (rcfg.hd, rcfg.param_count(), rcfg.active_param_count())
    for shape in SHAPES.values():
        assert cell_status(cfg, shape) == ref_cell_status(rcfg, REF_SHAPES[shape.name])


def test_model_api_takes_the_card_unless_asked_for_the_cpu():
    """``init``, ``make_state`` and ``params_from_reference`` put what they
    make on the card when ``device`` is None: without CUDA they raise, as
    ``ServeEngine`` does, and ``device="cpu"`` is the way to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = SMOKES["qwen1.5-0.5b"]
    model = get_model(cfg)
    params, _ = ref_get_model(REF_SMOKES["qwen1.5-0.5b"]).init(jax.random.PRNGKey(0))
    for make in (lambda: model.init(), lambda: model.make_state(2, 8),
                 lambda: T.init(cfg), lambda: T.init_cache(cfg, 2, 8),
                 lambda: params_from_reference(jax.tree.map(np.asarray, params), cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert model.init(device="cpu").device.type == "cpu"
    assert model.make_state(2, 8, device="cpu")["k"].device.type == "cpu"
