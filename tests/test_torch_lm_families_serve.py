"""The port's ``ServeEngine`` serving the MoE, VLM, RWKV6, Zamba2 and enc-dec
families against the JAX reference's engine, on the CPU, in f32.

The reduced (SMOKE) configs in float32 (greedy tokens are compared only in
float32, as in ``test_torch_lm_serve.py``), the reference's params from
``PRNGKey(0)`` carried into the port by ``params_from_reference``:

  * both packages' engines token for token, one config of each family (and
    dbrx): a bitpack prompt of 16 tokens and an rANS prompt of 24 through
    ``submit_compressed`` (one planner wave), a plain 8-token prompt; every
    prompt decoded as its source, and the final state equal;
  * ROADMAP §3 R3 on rwkv6, pinned: the engine's all-slot prefill also
    advances the other slots' recurrent state, so request 0's tokens alone
    differ from its tokens beside a second request, in both packages, and
    the port equals the reference in both runs;
  * ROADMAP §3 R4, pinned: the engine serves an enc-dec model against
    ``make_state``'s cross memory of zeros (128 rows), in both packages;
  * the ``launch.serve`` CLI on the CPU for every family.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as REF_SMOKES
from repro.core import plan as RP
from repro.models import get_model as ref_get_model
from repro.serve import engine as RE

from repro_torch.configs import SMOKES
from repro_torch.core import plan as P
from repro_torch.launch import serve as launch_serve
from repro_torch.models.weights import params_from_reference
from repro_torch.serve import engine as E
from test_torch_lm_families import close

ARCHS = ["phi3.5-moe-42b-a6.6b", "dbrx-132b", "qwen2-vl-2b", "rwkv6-7b", "zamba2-7b",
         "seamless-m4t-medium"]
# (rid, codec, prompt length) of the compressed prompts; rid 2 is a plain submit
COMPRESSED = [(0, "bitpack", 16), (1, "ans", 24)]
PLAIN = 8


def models_of(arch: str):
    rcfg = dataclasses.replace(REF_SMOKES[arch], dtype=jnp.float32)
    cfg = dataclasses.replace(SMOKES[arch], dtype=torch.float32)
    params, _ = ref_get_model(rcfg).init(jax.random.PRNGKey(0))
    return rcfg, params, cfg, params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                                    device="cpu")


def engines(models, slots=2, max_len=64):
    rcfg, params, cfg, model = models
    return (RE.ServeEngine(rcfg, params, batch_slots=slots, max_len=max_len, eos=-1),
            E.ServeEngine(cfg, model, batch_slots=slots, max_len=max_len, eos=-1,
                          device="cpu"))


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_token_for_token_with_compressed_prompts(arch):
    models = models_of(arch)
    ref, port = engines(models)
    vocab = models[2].vocab
    rng = np.random.default_rng(0)
    src = {rid: rng.integers(0, vocab, n).astype(np.int32) for rid, _, n in COMPRESSED}
    for rid, codec, _ in COMPRESSED:
        ref.submit_compressed(rid, RP.encode(RP.make_plan(codec), src[rid]), max_new=4)
        port.submit_compressed(rid, P.encode(P.make_plan(codec), src[rid]), max_new=4)
    plain = rng.integers(0, vocab, PLAIN).astype(np.int32)
    ref.submit(RE.Request(2, plain, max_new=4))
    port.submit(E.Request(2, plain.copy(), max_new=4))
    want, got = ref.run_to_completion(100), port.run_to_completion(100)
    assert got == want and {k: len(v) for k, v in got.items()} == dict.fromkeys(range(3), 4)
    for req in port._requests:
        assert req.error is None and req.done
        if req.rid in src:
            np.testing.assert_array_equal(req.prompt, src[req.rid])
    assert len(port.planner.reports) == len(ref.planner.reports) == 1
    assert port.state["len"] == int(ref.state["len"])
    for k, v in ref.state.items():
        if k != "len":
            close(v, port.state[k], 1e-4, k)


def test_prefill_advances_the_neighbours_recurrent_state():
    """ROADMAP §3 R3 on a recurrent family, pinned: a prefill steps every
    slot (token 0 in the others), so request 0's tokens change when a second
    request is served beside it -- in the reference, and identically in the
    port."""
    models = models_of("rwkv6-7b")
    rng = np.random.default_rng(3)
    first, second = (rng.integers(0, models[2].vocab, 6).astype(np.int32) for _ in range(2))
    runs = {}
    for label, reqs in (("alone", [first]), ("beside", [first, second])):
        ref, port = engines(models)
        for rid, toks in enumerate(reqs):
            ref.submit(RE.Request(rid, toks, max_new=6))
            port.submit(E.Request(rid, toks.copy(), max_new=6))
        want, got = ref.run_to_completion(100), port.run_to_completion(100)
        assert got == want, label
        runs[label] = got[0]
    assert runs["alone"] != runs["beside"]


def test_encdec_engine_attends_to_a_zero_cross_memory():
    """ROADMAP §3 R4, pinned: the engine never encodes frames, so each decoder
    layer's cross-attention reads ``make_state``'s memory of zeros
    (``max(max_len // 8, 128)`` rows), in both packages."""
    models = models_of("seamless-m4t-medium")
    ref, port = engines(models)
    toks = np.random.default_rng(5).integers(0, models[2].vocab, 6).astype(np.int32)
    ref.submit(RE.Request(0, toks, max_new=3))
    port.submit(E.Request(0, toks.copy(), max_new=3))
    assert port.run_to_completion(50) == ref.run_to_completion(50)
    for k in ("ck", "cv"):
        assert tuple(port.state[k].shape) == ref.state[k].shape
        assert port.state[k].shape[2] == 128
        assert not port.state[k].any() and not np.asarray(ref.state[k]).any()


@pytest.mark.parametrize("arch", ARCHS[1:])
def test_launch_serve_every_family_on_the_cpu(arch, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch, "--smoke", "--device", "cpu",
                                      "--requests", "3", "--max-new", "3"])
    launch_serve.main()
    assert capsys.readouterr().out.count("3 tokens") == 3
