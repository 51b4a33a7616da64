"""The port's LM serving path against the JAX reference's, on the CPU, in f32.

The reduced qwen1.5-0.5b config in float32 (greedy tokens are compared only in
float32: torch and XLA round bf16 in different orders), the reference's params
from ``PRNGKey(0)`` carried into the port by ``params_from_reference``:

  * ``ServeEngine`` of both packages token for token: plain submits, three
    bitpack prompts (16, 16 and 24 tokens) and one rANS prompt (40) through
    ``submit_compressed``, an empty prompt; every prompt decoded as its
    source, equal ``decode_cache_stats``, one planner wave each;
  * ROADMAP §3 R3 pinned: the KV cache's one shared length makes request 0's
    tokens alone differ from its tokens beside a second request, in both
    packages, and the port equals the reference in both runs;
  * KV paging: ``quantize_kv``/``dequantize_kv`` and ``page_out``'s words
    bitwise equal to the reference's, ``page_in`` equal;
  * the ``launch.serve`` CLI on the CPU, and ``ServeEngine()`` refusing to
    leave the card without ``device="cpu"``.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as REF_SMOKES
from repro.core import plan as RP
from repro.models import get_model as ref_get_model
from repro.serve import engine as RE
from repro.serve import kvcache as RK

from repro_torch.configs import SMOKES
from repro_torch.core import plan as P
from repro_torch.serve import engine as E
from repro_torch.serve import kvcache as K
from repro_torch.models.weights import params_from_reference

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen1.5-0.5b"
# (rid, codec, prompt length): the chip smoke's compressed prompts
COMPRESSED = [(0, "bitpack", 16), (1, "bitpack", 16), (2, "bitpack", 24), (3, "ans", 40)]


@pytest.fixture(scope="module")
def models():
    rcfg = dataclasses.replace(REF_SMOKES[ARCH], dtype=jnp.float32)
    cfg = dataclasses.replace(SMOKES[ARCH], dtype=torch.float32)
    params, _ = ref_get_model(rcfg).init(jax.random.PRNGKey(0))
    return rcfg, params, cfg, params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                                    device="cpu")


def engines(models, slots=2, max_len=256):
    rcfg, params, cfg, model = models
    return (RE.ServeEngine(rcfg, params, batch_slots=slots, max_len=max_len, eos=-1),
            E.ServeEngine(cfg, model, batch_slots=slots, max_len=max_len, eos=-1,
                          device="cpu"))


def prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return {rid: rng.integers(0, vocab, n).astype(np.int32) for rid, _, n in COMPRESSED}


def test_plain_submits_token_for_token(models):
    ref, port = engines(models)
    rng = np.random.default_rng(1)
    for rid in range(3):
        toks = rng.integers(0, models[2].vocab, 4 + 2 * rid).astype(np.int32)
        ref.submit(RE.Request(rid, toks, max_new=5))
        port.submit(E.Request(rid, toks.copy(), max_new=5))
    want, got = ref.run_to_completion(100), port.run_to_completion(100)
    assert got == want and set(got) == {0, 1, 2}
    assert all(len(v) == 5 for v in got.values())
    assert port.state["len"] == int(ref.state["len"])


def test_compressed_prompts_and_an_empty_one_token_for_token(models):
    ref, port = engines(models)
    src = prompts(models[2].vocab)
    for rid, codec, _ in COMPRESSED:
        ref.submit_compressed(rid, RP.encode(RP.make_plan(codec), src[rid]), max_new=6)
        port.submit_compressed(rid, P.encode(P.make_plan(codec), src[rid]), max_new=6)
    plain = np.random.default_rng(2).integers(0, models[2].vocab, 8).astype(np.int32)
    for eng, mod in ((ref, RE), (port, E)):
        eng.submit(mod.Request(4, plain.copy(), max_new=6))
        eng.submit(mod.Request(5, np.zeros((0,), np.int32), max_new=3))
    want, got = ref.run_to_completion(200), port.run_to_completion(200)
    assert got == want
    assert {k: len(v) for k, v in got.items()} == {0: 6, 1: 6, 2: 6, 3: 6, 4: 6, 5: 3}
    for req in port._requests:
        assert req.error is None and req.done
        if req.rid in src:
            assert req.prompt.dtype == np.int32
            np.testing.assert_array_equal(req.prompt, src[req.rid])
    # the two 16-token bitpack prompts share one program
    assert port.decode_cache_stats == ref.decode_cache_stats == \
        {"programs": 3, "hits": 1, "misses": 3, "evictions": 0}
    assert len(port.planner.reports) == len(ref.planner.reports) == 1
    assert port.planner.pending == 0 and not port._awaiting_prompt


def test_shared_cache_length_makes_outputs_depend_on_neighbours(models):
    """ROADMAP §3 R3, pinned: one ``len`` for every slot, and a prefill that
    steps every slot, so request 0's tokens change when a second request is
    served beside it -- in the reference, and identically in the port."""
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


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_kv_paging_words_and_values_equal_the_references(dt):
    rng = np.random.default_rng(4)
    block = rng.normal(size=(2, 16, 4, 32)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dt == "f32" else (jnp.bfloat16, torch.bfloat16)
    rb, pb = jnp.asarray(block, jdt), torch.from_numpy(block).to(tdt)
    rq, rs = RK.quantize_kv(rb)
    q, s = K.quantize_kv(pb)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy().view(np.int32), np.asarray(rs).view(np.int32))
    np.testing.assert_array_equal(K.dequantize_kv(q, s, tdt).float().numpy(),
                                  np.asarray(RK.dequantize_kv(rq, rs, jdt), np.float32))
    rpage, page = RK.page_out(rb), K.page_out(pb)
    assert (page.bit_width, page.base, page.shape) == (rpage.bit_width, rpage.base, rpage.shape)
    assert page.packed.dtype == rpage.packed.dtype == np.uint32
    np.testing.assert_array_equal(page.packed, rpage.packed)
    np.testing.assert_array_equal(page.scale.view(np.int32), rpage.scale.view(np.int32))
    back = K.page_in(page, tdt, device="cpu")
    assert back.dtype == tdt and tuple(back.shape) == block.shape
    np.testing.assert_array_equal(back.float().numpy(),
                                  np.asarray(RK.page_in(rpage, jdt), np.float32))
    np.testing.assert_array_equal(back.numpy() if dt == "f32" else back.float().numpy(),
                                  K.page_in(page, tdt, device="cpu", backend="torch")
                                  .float().numpy())


def test_launch_serve_smoke_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
                          "--device", "cpu", "--requests", "3", "--max-new", "4"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("4 tokens") == 3


def test_engine_refuses_to_leave_the_card(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        E.ServeEngine(models[2], models[3])
