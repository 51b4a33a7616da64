"""The port's compressed checkpoints, fault-tolerant loop and compressed
token loader against the JAX reference's, on the CPU (the loop's own tests
are in ``test_torch_train_loop.py``, which shares the helpers here).

Checkpoints: the training state ``(params, {"mu", "nu", "step"})`` in the
reference's layout (layers stacked, leaves named by their paths), written by
either package and restored by the other to the same arrays, bit for bit;
a bf16 leaf as the reference stores it (which the reference itself cannot
read back, ROADMAP §3); the hash check.  The loader: the reference's packed
words, tokens and labels.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as REF_SMOKES
from repro.data.loader import CompressedTokenLoader as RefLoader
from repro.models import get_model as ref_get_model
from repro.train import checkpoint as RCK
from repro.train import optimizer as ROPT

from repro_torch.configs import SMOKES
from repro_torch.data.loader import CompressedTokenLoader
from repro_torch.models import get_model
from repro_torch.train import checkpoint as CK
from repro_torch.train import optimizer as OPT
from repro_torch.train.loop import load_state, state_like, state_tree
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import make_train_step

ARCH = "qwen1.5-0.5b"
OPT_CFG = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=50, weight_decay=0.1)


def flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def batch_fn(i: int) -> dict:
    toks = np.random.default_rng(i).integers(0, SMOKES[ARCH].vocab, (2, 33))
    return {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}


def setup(opt_cfg: AdamWConfig = OPT_CFG):
    """The SMOKE qwen in training form (f32 weights, bf16 compute), AdamW
    state and a step without remat."""
    cfg = SMOKES[ARCH]
    model = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu", train=True)
    return model, OPT.init(model), make_train_step(cfg, opt_cfg, remat=None)


def ref_state():
    """The reference's state tree of the same config: its names and shapes."""
    params, _ = ref_get_model(REF_SMOKES[ARCH]).init(jax.random.PRNGKey(0))
    return params, ROPT.init(params)


def assert_same(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    model, opt, step = setup()
    model, opt, _ = step(model, opt, batch_fn(0))
    d = str(tmp_path / "ck")
    CK.save(d, 7, state_tree(model, opt), extra={"note": "x"})
    (params, ropt), step_no, extra = RCK.restore(d, ref_state())
    assert step_no == 7 and extra["note"] == "x"
    assert_same(flat((params, ropt)), flat(state_tree(model, opt)))
    assert int(ropt["step"]) == 1
    assert CK.compression_report(d)["ratio"] > 1.0       # the exponent plane compresses


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """A reference state after one of its steps, saved by the reference, read
    by the port into its module and moments: the same arrays, and the same
    leaf names, files, shapes and dtypes as the port's own save.  The names
    come from ``state_like``, as the loop's resume takes them."""
    from repro.train.train_step import make_train_step as ref_make_train_step

    params, ropt = ref_state()
    rstep = jax.jit(ref_make_train_step(REF_SMOKES[ARCH], ROPT.AdamWConfig(
        **dataclasses.asdict(OPT_CFG)), remat=None))
    b = batch_fn(0)
    params, ropt, _ = rstep(params, ropt, {k: jnp.asarray(v.numpy(), jnp.int32)
                                           for k, v in b.items()})
    d = str(tmp_path / "ref")
    RCK.save(d, 3, (params, ropt))
    model, opt, _ = setup()
    names = lambda t: [n for n, _ in CK._leaf_paths(t)]
    assert names(state_like(model)) == names(state_tree(model, opt))
    tree, step_no, _ = CK.restore(d, state_like(model))
    opt = load_state(model, tree)
    assert step_no == 3 and opt["step"] == 1
    assert_same(flat(state_tree(model, opt)), flat((params, ropt)))
    mine = str(tmp_path / "port")
    CK.save(mine, 3, state_tree(model, opt))
    ref_man, man = (json.load(open(os.path.join(x, "step_00000003", "manifest.json")))
                    for x in (d, mine))
    strip = lambda m: {k: {f: v[f] for f in ("file", "shape", "dtype", "raw_bytes")}
                       for k, v in m["leaves"].items()}
    assert strip(man) == strip(ref_man)


def test_bf16_leaf_is_stored_as_the_reference_stores_it(tmp_path):
    """A bf16 leaf: two raw bytes an element under dtype "bfloat16", from
    either package; the port reads both back bit for bit; the reference
    cannot read either (its ``astype`` of the raw bytes to bfloat16 raises)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)).to(torch.bfloat16)
    ref_leaf = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    for who, save in (("port", CK.save), ("ref", RCK.save)):
        d = str(tmp_path / who)
        save(d, 1, {"w": x if who == "port" else ref_leaf})
        man = json.load(open(os.path.join(d, "step_00000001", "manifest.json")))
        assert man["leaves"]["w"]["dtype"] == "bfloat16"
        got, _, _ = CK.restore(d, {"w": 0})
        assert got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"].view(torch.int16), x.view(torch.int16))
        with pytest.raises((TypeError, ValueError)):
            RCK.restore(d, {"w": ref_leaf})


def test_checkpoint_corruption_detected(tmp_path):
    model, opt, _ = setup()
    d = str(tmp_path / "ck")
    sdir = CK.save(d, 1, state_tree(model, opt))
    victim = sorted(f for f in os.listdir(sdir) if f.endswith(".npz"))[0]
    with open(os.path.join(sdir, victim), "r+b") as f:
        f.seek(100)
        f.write(b"\xde\xad")
    with pytest.raises(IOError, match="corruption"):
        CK.restore(d, state_tree(model, opt))


@pytest.mark.parametrize("vocab,batch,seq", [(151936, 2, 16), (256, 3, 7), (1, 1, 4)])
def test_loader_words_tokens_and_labels_match_the_reference(vocab, batch, seq):
    """``encode_host`` packs the reference's words at ``ceil(log2 vocab)``
    bits; the plain ``decode_fn`` and kernel 1's wrapper (its plain version
    on CPU tensors) give the reference's tokens and labels."""
    ref, mine = RefLoader(vocab, batch, seq), CompressedTokenLoader(vocab, batch, seq,
                                                                    device="cpu")
    assert mine.bits == ref.bits
    rdecode = ref.decode_fn()
    for step in (0, 5):
        rw, w = ref.encode_host(step), mine.encode_host(step)
        np.testing.assert_array_equal(w["packed"], rw["packed"])
        want = rdecode({"packed": jnp.asarray(rw["packed"])})
        for backend in ("torch", "kernel"):
            got = mine.decode_fn(backend)(mine.to_device(w))
            for k in ("tokens", "labels"):
                assert got[k].dtype == torch.int32
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert (mine.bytes_plain, mine.bytes_compressed) == (ref.bytes_plain, ref.bytes_compressed)
    assert mine.ratio == ref.ratio


def test_loader_takes_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CompressedTokenLoader(256, 2, 8)
    assert next(CompressedTokenLoader(256, 2, 8, device="cpu").batches(3))[
        "root.packed"].device.type == "cpu"
