"""The int8 error-feedback sum and the compressed data-parallel step over a
real process group, against the JAX reference, on the CPU.

Each side runs in a subprocess (``tests/torch_mesh_ranks.py``): the
reference on 4 forced host devices under ``shard_map``, the port as 4
processes in a ``gloo`` group.

  * ``compressed_psum``: the same four members' numpy gradients and error
    buffers give bitwise-equal sums and new error buffers;
  * R6, pinned: the sync's all-reduce is counted by ``roofline.op_cost`` at
    int32 size (4 bytes an element, plus each tensor's f32 scale), while
    ``wire_bytes(compressed=True)`` keeps the reference's 1 byte an element;
  * ``make_dp_compressed_step`` on a ("pod", "data") = (2, 2) mesh, qwen SMOKE
    in f32 with the reference's parameters (``params_from_reference``), a
    global batch of 8 x 32, two steps at lr 1e-2: every step's loss within
    ``LOSS_TOL``, the parameters' L2 distance within ``STEP_TOL`` of their
    change (``chip_smoke.py``'s ``TRAIN_STEP_TOL``), and the four ranks' parameters
    bitwise equal.
"""
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_mesh_ranks as R  # noqa: E402
from torch_mesh_ranks import run_case  # noqa: E402

LOSS_TOL = 1e-4
STEP_TOL = 1e-2


@pytest.fixture(scope="module")
def psum_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("psum"))
    run_case("ref_psum", d)
    run_case("psum", d)
    return d


@pytest.fixture(scope="module")
def dp_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dp"))
    run_case("ref_dp", d)
    run_case("dp", d)
    return d


@pytest.mark.parametrize("rank", range(4))
def test_compressed_psum_is_bitwise_the_reference(rank, psum_dir):
    ref = R.load(psum_dir, "ref_psum")
    got = R.load(psum_dir, f"psum_{rank}")
    for i in range(len(R.PSUM_SHAPES)):
        for what in ("sum", "err"):
            want = ref[f"{what}{i}"][rank]
            assert got[f"{what}{i}"].dtype == np.float32
            np.testing.assert_array_equal(got[f"{what}{i}"].view(np.int32),
                                          want.view(np.int32), err_msg=f"{what}{i}")


def test_r6_payload_counts_int32_and_wire_bytes_keep_one_byte(psum_dir):
    got = R.load(psum_dir, "psum_0")
    n = sum(int(np.prod(s)) for s in R.PSUM_SHAPES)
    ring = 3 / 4                                    # 4 members
    payload = 4 * n + 4 * len(R.PSUM_SHAPES)        # int32 payloads + f32 scales
    assert float(got["allreduce_bytes"]) == pytest.approx(2 * payload * ring, rel=1e-12)
    assert int(got["wire_int8"]) == n               # the reference's 1 byte an element
    assert int(got["wire_f32"]) == 4 * n
    # the int32 payload crosses at the f32 sum's size: R6
    assert float(got["allreduce_bytes"]) > 2 * int(got["wire_f32"]) * ring


def test_dp_step_matches_the_reference(dp_dir):
    ref = R.load(dp_dir, "ref_dp")
    p0 = R.load(dp_dir, "ref_params")
    got = R.load(dp_dir, "dp_0")
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=0, atol=LOSS_TOL)
    keys = [k for k in ref if k.startswith("p/")]
    assert set(keys) == {k for k in got if k.startswith("p/")}
    dist = sum(float(((got[k] - ref[k]) ** 2).sum()) for k in keys) ** 0.5
    change = sum(float(((ref[k] - p0[k[2:]]) ** 2).sum()) for k in keys) ** 0.5
    assert change > 0.1                      # the update is visible
    assert dist <= STEP_TOL * change, (dist, change)


@pytest.mark.parametrize("rank", (1, 2, 3))
def test_dp_ranks_hold_bitwise_equal_parameters(rank, dp_dir):
    a, b = R.load(dp_dir, "dp_0"), R.load(dp_dir, f"dp_{rank}")
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
