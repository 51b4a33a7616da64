"""int32 wrap-around: the port's prefix sums and affine map wrap mod 2^32 exactly
like the reference's int32 arithmetic (torch's cumsum widens to int64, and signed
overflow is undefined in C++, so both are easy to get wrong)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as RP
from repro.core.compiler import compile_decoder, device_buffers as ref_device_buffers

from repro_torch.algos import delta, rle
from repro_torch.core import plan as P
from repro_torch.core.compiler import build_graph, compile_blob, device_buffers
from repro_torch.kernels.ref import wrap_i32


def wrapped(x) -> np.ndarray:
    return ((np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31).astype(np.int32)


def ref_aux(renc, name):
    """The reference's own Aux closure of that name, from its unfused lowering."""
    return next(st for st in RP.lower(renc) if st.name == name)


def test_wrap_i32():
    x = torch.tensor([0, 2**31 - 1, 2**31, 2**32 + 5, -2**31 - 1, -2**40 - 3])
    assert wrap_i32(x).tolist() == wrapped(x.numpy()).tolist()


def test_presum_wraps_like_reference():
    counts = np.array([2**30, 2**30, 2**30, 5, 2**31 - 1], np.int32)
    renc = RP.encode(RP.make_plan("rle"), np.repeat(np.arange(5), 2).astype(np.int32))
    want = np.asarray(ref_aux(renc, "rle-presum").fn(jnp.asarray(counts)))
    got = rle.presum(torch.from_numpy(counts))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, wrapped(np.concatenate([[0], np.cumsum(counts.astype(np.int64))])))


def test_delta_prefix_wraps_like_reference():
    d = np.array([2**31 - 1, 2**31 - 1, 5, -2**31, -2**31, 7], np.int32)
    base = np.array([2**31 - 2], np.int32)
    renc = RP.encode(RP.Plan("delta"), np.arange(6, dtype=np.int32))
    want = np.asarray(ref_aux(renc, "delta-cumsum").fn(jnp.asarray(d), jnp.asarray(base)))
    got = delta.prefix(torch.from_numpy(d), torch.from_numpy(base))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, wrapped(np.cumsum(d.astype(np.int64)) + base[0]))


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_delta_column_wraps_end_to_end(backend):
    rng = np.random.default_rng(7)
    arr = rng.integers(-2**31, 2**31, 5000).astype(np.int32)   # deltas span 33 bits
    plan = RP.Plan("delta", children={"deltas": RP.make_plan("bitpack")})
    renc = RP.encode(plan, arr)
    penc = P.encoded_from_reference(renc)
    got = compile_blob(penc, backend=backend)(device_buffers(penc, "cpu"))
    want = compile_decoder(renc, backend="pallas", interpret=True)(
        ref_device_buffers(renc))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), arr)


def _deltastride_wrap_blob():
    """Three groups; the second's start + stride*pos runs past 2^31 - 1."""
    counts = np.array([1, 4000, 2], np.int32)
    buffers = {"starts": np.array([5, 2**31 - 1000, -7], np.int32),
               "strides": np.array([0, 7, -2**31], np.int32), "counts": counts}
    meta = {"n_groups": 3,
            "group_presum": np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)}
    n = int(counts.sum())
    return (RP.Encoded("deltastride", meta, buffers, {}, n, np.dtype(np.int32)),
            P.Encoded("deltastride", dict(meta), dict(buffers), {}, n,
                      np.dtype(np.int32)))


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_deltastride_affine_map_wraps(backend):
    renc, penc = _deltastride_wrap_blob()
    expect = wrapped(np.concatenate([
        [5], 2**31 - 1000 + 7 * np.arange(4000, dtype=np.int64), [-7, -7 - 2**31]]))
    got = compile_blob(penc, backend=backend)(device_buffers(penc, "cpu"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), expect)
    want = compile_decoder(renc, backend="pallas", interpret=True)(
        ref_device_buffers(renc))
    np.testing.assert_array_equal(np.asarray(want), expect)
    assert [st.name for st in build_graph(penc).stages] == ["ds-presum",
                                                           "deltastride-expand"]
