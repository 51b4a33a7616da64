"""Per-stage parity of the PyTorch port against the JAX reference.

Each blob is made once by the reference encoder and handed to the port through
``encoded_from_reference``.  The reference runs every fused stage through its
Pallas kernels in interpret mode (as ``tests/test_kernels.py`` does); the port runs
the same stages through the plain PyTorch versions of its CUDA kernels, and through
the kernel wrappers, which take the plain version for CPU tensors.  Every stage
output must match bit for bit, and so must every Fully-Parallel producer that
fusion rule 5 folded into an Aux (held against the reference's unfused stage of
the same name).  Inputs are seeded numpy; tolerance is zero everywhere, the
float2int divide included.
"""
import numpy as np
import pytest

from repro.core import plan as RP
from repro.core.compiler import build_graph as ref_build_graph
from repro.core.compiler import device_buffers as ref_device_buffers
from repro.core.geometry import Geometry
from repro.kernels import ops as ref_ops

from repro_torch.core import plan as P
from repro_torch.core.compiler import build_graph, device_buffers
from repro_torch.core.patterns import Aux
from repro_torch.kernels.ops import run_stage

mp = RP.make_plan
GEOMS = {"fp": Geometry(2, 8, 128), "gp": Geometry(2, 8, 128),
         "np": Geometry(1, 8, 128)}


def as_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_bitwise(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(as_bits(got), as_bits(want), err_msg=what)


def ref_outputs(renc, fuse: bool = True) -> dict[str, np.ndarray]:
    """Every stage output of the reference, Pallas kernels in interpret mode."""
    env = ref_device_buffers(renc)
    outs = {}
    for st in ref_build_graph(renc, fuse=fuse).stages:
        env[st.out] = ref_ops.run_stage(st, env, GEOMS, interpret=True)
        outs[st.out] = np.asarray(env[st.out])
    return outs


def port_outputs(penc, backend: str = "torch") -> dict[str, np.ndarray]:
    """Every stage output of the port (and of each Aux's folded producers)."""
    env = device_buffers(penc, "cpu")
    outs = {}
    for st in build_graph(penc).stages:
        if isinstance(st, Aux) and st.producers:
            local = dict(env)
            for prod in st.producers:
                local[prod.out] = run_stage(prod, local, backend)
                outs[prod.out] = local[prod.out].numpy()
        env[st.out] = run_stage(st, env, backend)
        outs[st.out] = env[st.out].numpy()
    return outs


def check_blob(renc, arr=None):
    """Per-stage bitwise parity of one blob; returns the port's final output."""
    penc = P.encoded_from_reference(renc)
    fused, unfused = ref_outputs(renc), None
    for backend in ("torch", "kernel"):
        mine = port_outputs(penc, backend)
        for name, got in mine.items():
            if name in fused:
                assert_bitwise(got, fused[name], f"{backend} stage {name}")
            else:   # a rule-5 producer: the reference's unfused stage
                unfused = unfused or ref_outputs(renc, fuse=False)
                assert_bitwise(got, unfused[name], f"{backend} producer {name}")
    final = mine[build_graph(penc).out]
    if arr is not None:
        assert_bitwise(final, arr, "vs source")
    return final


def encode_ref(plan, arr):
    return RP.encode(plan, arr)


@pytest.mark.parametrize("bw", [1, 3, 7, 8, 13, 17, 25, 31, 32])
def test_bitpack_width_sweep(bw, rng):
    lo, hi = (-2**31, 2**31) if bw == 32 else (0, 2**bw)
    arr = rng.integers(lo, hi, 3001).astype(np.int32)
    check_blob(encode_ref(RP.Plan("bitpack", params={"bit_width": bw}), arr), arr)


@pytest.mark.parametrize("n", [1, 127, 1025, 4097])
def test_bitpack_lengths(n, rng):
    arr = rng.integers(-1000, 1000, n).astype(np.int32)
    check_blob(encode_ref(mp("bitpack"), arr), arr)


def test_dictionary_bitpack(rng):
    arr = rng.choice(np.array([8035, 9001, 10590, -3, 2**31 - 1], np.int32), 4000)
    check_blob(encode_ref(RP.Plan("dictionary", children={"index": mp("bitpack")}),
                          arr), arr)


def test_float2int_bitpack_no_exceptions(rng):
    arr = (rng.integers(90_000, 10_500_000, 4000) / 100.0).astype(np.float32)
    renc = encode_ref(RP.Plan("float2int", children={"ints": mp("bitpack")}), arr)
    assert renc.meta["n_exc"] == 0
    check_blob(renc, arr)


def test_float2int_bitpack_with_exceptions(rng):
    arr = (rng.integers(0, 10**6, 4000) / 100.0).astype(np.float32)
    arr[::97] = rng.random(arr[::97].size).astype(np.float32) * 1e-3 + 0.1234567
    renc = encode_ref(RP.Plan("float2int", children={"ints": mp("bitpack")}), arr)
    assert renc.meta["n_exc"] > 0
    check_blob(renc, arr)
