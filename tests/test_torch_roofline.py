"""The port's op-cost counter and roofline against closed forms and the
reference's HLO walker (``repro.roofline.hlo_cost``), on the CPU.

``op_cost.analyze`` takes its FLOP formulas from ``torch.utils.flop_counter``'s
registry (2 * M * N * K a matrix product); these tests reuse the cases of
``tests/test_hlo_cost.py`` on it (a matmul exact, loops multiplied, flash
attention, a training gradient near 6 N D), then hold its counts of every
SMOKE family's ``prefill``, ``decode_step`` and training gradient against the
reference's ``hlo_cost.analyze`` of the same function at B = 2, S = 64.

Where the counts differ, one side runs a dot the other does not:
  * the training gradient: the reference's ``flash_attention`` wraps its
    kv-block body in ``jax.checkpoint`` ("recompute p-blocks in the
    backward"), so its backward recomputes every block's scores
    ``einsum("bqhd,bkhd->bhqk", q, k)`` -- one dot of 2 * B * H * Sq * Sk * hd
    FLOPs per attention call -- before the four dots of the block's gradient;
    the port's eager ``flash_attention`` lets autograd keep the
    probabilities and runs only the four.  For qwen1.5 and phi3.5-moe at
    SMOKE size that is 2 layers x 2 * 2 * 4 * 64 * 64 * 16 = 2,097,152 = 2^21
    FLOPs; with it added back the counts are equal for every attention-only
    family.  The RWKV6 and Mamba2 chunk scans put their intra-chunk score
    blocks under ``jax.checkpoint`` as well, so rwkv6 and zamba2 count less
    by a share held within ``GRAD_TOL`` (measured 1.0% and 3.1%);
  * seamless's prefill: the reference projects each decoder layer's memory to
    cross K and V twice (once for the cache, once inside ``_cross_attn``)
    and XLA keeps both; the port projects it once and reuses it.
"""
import jax
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import SMOKES as REF_SMOKES
from repro.configs.base import ShapeConfig as RefShape
from repro.models import get_model as ref_get_model
from repro.roofline import analysis as ref_analysis
from repro.roofline import hlo_cost
from repro_torch.configs import ARCHS, SHAPES, SMOKES
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import get_model
from repro_torch.roofline import analysis, op_cost
from repro_torch.roofline.op_cost import analyze

B, S = 2, 64
GRAD_TOL = 0.05   # rwkv6 / zamba2 gradient: counted within 5% below the reference's


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ------------------------------------------------------------- closed forms

def test_matmul_exact():
    got = analyze(lambda a, b: a @ b, torch.zeros(256, 512), torch.zeros(512, 128))
    assert got["flops"] == 2 * 256 * 512 * 128
    assert got["bytes"] == (256 * 512 + 512 * 128 + 256 * 128) * 4
    assert got["n_ops"] == 1 and got["peak_bytes"] == 256 * 128 * 4


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_loop_multiplication(device):
    """The reference's scan of 10 trips: an eager loop runs all 10."""
    def f(x, w):
        for _ in range(10):
            x = torch.tanh(x @ w)
        return x.sum()

    x = torch.zeros(128, 128, device=device)
    assert analyze(f, x, x)["flops"] == 10 * 2 * 128 ** 3


def test_nested_loops():
    def f(x, w):
        for _ in range(5):
            for _ in range(4):
                x = x @ w
        return x.sum()

    x = _meta(64, 64)
    assert analyze(f, x, x)["flops"] == 20 * 2 * 64 ** 3


def test_flash_attention_flops_within_tolerance():
    """Chunked flash attention == 2 * 2 * B*H*Sq*Sk*hd (QK^T + PV): the port
    runs every block, the causally masked ones too."""
    from repro_torch.models.layers import flash_attention

    Bq, Sq, H, hd = 2, 1024, 4, 64
    q = _meta(Bq, Sq, H, hd)
    got = analyze(flash_attention, q, q, q, causal=True, q_chunk=256, kv_chunk=256)["flops"]
    want = 4 * Bq * H * Sq * Sq * hd
    assert abs(got - want) / want < 0.05, (got, want)


def test_training_flops_close_to_analytic():
    """Full smoke-model train grad: counted flops ~ 6-8x N x D (fwd 2, bwd 4)."""
    cfg = SMOKES["qwen1.5-0.5b"]
    api = get_model(cfg)
    model = api.init(device="meta", train=True)
    Bt, St = 4, 128
    batch = {"tokens": _meta(Bt, St, dtype=torch.int32),
             "labels": _meta(Bt, St, dtype=torch.int32)}

    def grad():
        loss = api.train_loss(model, batch)
        return torch.autograd.grad(loss, list(model.parameters()))

    got = analyze(grad)["flops"]
    n = sum(p.numel() for p in model.parameters())
    lo, hi = 5 * n * Bt * St, 11 * n * Bt * St
    assert lo < got < hi, (got, lo, hi)


def test_collective_bytes_zero_without_collectives():
    def f(x, w):
        for _ in range(7):
            x = torch.tanh(x @ w)
        return x.sum()

    x = _meta(64, 64)
    got = analyze(f, x, x)
    assert got["coll_bytes"] == 0.0 and got["collectives"] == {}


def test_collectives_at_the_reference_ring_factors():
    """An all-reduce and an all-gather of the functional collectives over a
    fake process group of 8: 2 * in * 7/8 and out * 7/8 wire bytes."""
    fake_pg = pytest.importorskip("torch.testing._internal.distributed.fake_pg",
                                  reason="torch has no fake process group here")
    import torch.distributed as dist

    n = 8
    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=0, world_size=n)
    try:
        group = dist.group.WORLD.group_name
        x = torch.ones(4, 8)
        c10d = torch.ops._c10d_functional

        def f(x):
            a = c10d.wait_tensor(c10d.all_reduce(x, "sum", group))
            g = c10d.wait_tensor(c10d.all_gather_into_tensor(x, n, group))
            return a, g

        got = analyze(f, x)
    finally:
        dist.destroy_process_group()
    ring = (n - 1) / n
    assert got["collectives"] == {"all-reduce": 2 * 128 * ring, "all-gather": n * 128 * ring}
    assert got["coll_bytes"] == sum(got["collectives"].values())
    for kind, in_b, out_b in (("all-reduce", 5, 5), ("all-gather", 5, 40),
                              ("reduce-scatter", 40, 5), ("all-to-all", 9, 9)):
        want = {"all-reduce": 2 * in_b, "all-gather": out_b}.get(kind, in_b) * ring
        assert op_cost.ring_wire_bytes(kind, in_b, out_b, n) == want


def test_views_count_no_bytes_and_in_place_counts_read_and_write():
    x = torch.zeros(8, 8)
    got = analyze(lambda: x.view(64).add_(1.0))
    assert got["by_op"]["aten.view.default"]["bytes"] == 0
    assert got["by_op"]["aten.add_.Tensor"]["bytes"] == 2 * 64 * 4


# ------------------------------------------------------------- model_flops

def test_model_flops_moe_uses_active_params():
    cfg = ARCHS["dbrx-132b"]
    dense_equiv = 6 * cfg.param_count() * 4096 * 256
    got = analysis.model_flops(cfg, SHAPES["train_4k"], "train")
    assert got < dense_equiv, "MoE must count active params only"
    assert got > 6 * cfg.active_param_count() * 4096 * 256 * 0.9


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_equal_reference(arch, shape):
    sh = SHAPES[shape]
    assert analysis.model_flops(ARCHS[arch], sh, sh.kind) == ref_analysis.model_flops(
        REF_ARCHS[arch], REF_SHAPES[shape], sh.kind)


# ------------------------------------------------------------- Roofline

FIELDS = [
    dict(chips=1, hlo_flops_per_chip=3e12, hlo_bytes_per_chip=2e9, coll_bytes_per_chip=0.0,
         model_flops_total=2.5e12, per_device_bytes=10, useful_bytes_per_chip=1.5e9),
    dict(chips=256, hlo_flops_per_chip=1e10, hlo_bytes_per_chip=4e11,
         coll_bytes_per_chip=3e9, model_flops_total=2e12, per_device_bytes=7,
         useful_bytes_per_chip=5e11),
    dict(chips=512, hlo_flops_per_chip=8e14, hlo_bytes_per_chip=1e9,
         coll_bytes_per_chip=9e12, model_flops_total=3e17, per_device_bytes=3),
]
PROPS = ("t_compute", "t_memory", "t_collective", "bottleneck", "step_time", "bw_frac",
         "useful_flops_frac", "roofline_frac")


@pytest.mark.parametrize("fields", FIELDS)
def test_roofline_properties_equal_reference(fields, monkeypatch):
    """Given the same fields and the same constants, every property and the
    shared ``to_dict`` keys equal the reference's."""
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(analysis, name, getattr(ref_analysis, name))
    common = dict(arch="a", shape="s", mesh="m", coll_breakdown={}, **fields)
    mine, ref = analysis.Roofline(**common), ref_analysis.Roofline(**common)
    for p in PROPS:
        assert getattr(mine, p) == getattr(ref, p), p
    got, want = mine.to_dict(), ref.to_dict()
    assert set(want) <= set(got)
    assert {k: got[k] for k in want} == want


def test_roofline_without_collective_term():
    """On a production mesh the collective term is unknown: the bottleneck
    and step time come from the other two terms."""
    r = analysis.Roofline(arch="a", shape="s", mesh="pod_16x16", chips=256,
                          hlo_flops_per_chip=1e12, hlo_bytes_per_chip=1e9,
                          coll_bytes_per_chip=None, coll_breakdown="waits",
                          model_flops_total=1e14, per_device_bytes=1, split="ideal")
    assert r.t_collective is None
    assert r.bottleneck == "compute" and r.step_time == r.t_compute
    assert "n/a" in analysis.summarize([r.to_dict()])


def test_constants_are_the_h100s():
    assert analysis.PEAK_FLOPS == 989e12
    assert analysis.HBM_BW == 3.35e12
    assert analysis.LINK_BW == 450e9


# ------------------------------------------------- against the reference

def _ref_hlo(arch: str, kind: str) -> str:
    rm = ref_get_model(REF_SMOKES[arch])
    pshape = jax.eval_shape(lambda k: rm.init(k)[0], jax.random.PRNGKey(0))
    ins, _ = rm.input_specs(RefShape(kind, S, B, kind))
    if kind == "train":
        fn = jax.grad(lambda p, b: rm.train_loss(p, b))
        return jax.jit(fn).lower(pshape, ins).compile().as_text()
    st = jax.eval_shape(lambda: rm.make_state(B, _max_len(arch)))
    if kind == "prefill":
        fn = lambda p, b, s: rm.prefill(p, b, s)
        return jax.jit(fn).lower(pshape, ins, st).compile().as_text()
    fn = lambda p, t, s: rm.decode_step(p, t, s)
    return jax.jit(fn).lower(pshape, ins["token"], st).compile().as_text()


def _max_len(arch: str) -> int:
    """The state's rows: enc-dec's prompt is max(S // 8, 128) tokens."""
    return 128 if SMOKES[arch].family == "encdec" else S


def _port_flops(arch: str, kind: str) -> float:
    api = get_model(SMOKES[arch])
    model = api.init(device="meta", train=kind == "train")
    ins = api.input_specs(ShapeConfig(kind, S, B, kind))[0]
    if kind == "train":
        def grad():
            loss = api.train_loss(model, ins)
            return torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)

        return analyze(grad)["flops"]
    state = api.make_state(B, _max_len(arch), device="meta")
    if kind == "prefill":
        return analyze(api.prefill, model, ins, state)["flops"]
    return analyze(api.decode_step, model, ins["token"], state)["flops"]


def _attn_recompute(cfg) -> int:
    """The FLOPs of the score dot the reference's checkpointed flash-attention
    body recomputes in the backward: 2 * B * H * Sq * Sk * hd per call."""
    per = lambda sq, sk: 2 * B * cfg.n_heads * sq * sk * cfg.hd
    if cfg.family == "encdec":
        tgt = max(S // 8, 128)
        return (cfg.enc_layers * per(S, S)
                + cfg.dec_layers * (per(tgt, tgt) + per(tgt, S)))
    if cfg.family == "hybrid":
        return (cfg.n_layers // cfg.attn_every) * per(S, S)
    if cfg.family == "ssm":
        return 0
    return cfg.n_layers * per(S, S)     # a VLM's S counts its patch prefix


def _cross_kv_twice(cfg) -> int:
    """The reference's second projection of the memory to cross K and V in
    its enc-dec prefill: per decoder layer, K and V of B x S frames."""
    return cfg.dec_layers * 2 * 2 * B * S * cfg.d_model * cfg.n_kv_heads * cfg.hd


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", sorted(SMOKES))
def test_counted_flops_equal_reference_hlo(arch, kind):
    want = hlo_cost.analyze(_ref_hlo(arch, kind))["flops"]
    got = _port_flops(arch, kind)
    if SMOKES[arch].family == "encdec" and kind == "prefill":
        want -= _cross_kv_twice(SMOKES[arch])
    assert got == want


@pytest.mark.parametrize("arch", sorted(SMOKES))
def test_gradient_flops_against_reference_hlo(arch):
    cfg = SMOKES[arch]
    want = hlo_cost.analyze(_ref_hlo(arch, "train"))["flops"]
    got = _port_flops(arch, "train")
    if cfg.family in ("ssm", "hybrid"):
        assert want * (1 - GRAD_TOL) <= got + _attn_recompute(cfg) <= want
    else:
        assert got + _attn_recompute(cfg) == want
