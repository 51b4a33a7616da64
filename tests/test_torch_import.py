"""The port stands alone and hides no fallback.

  * ``repro_torch`` and every submodule import with JAX blocked, and import
    nothing of the reference package ``repro`` (in a fresh interpreter);
  * the default entry point runs on CUDA and raises when there is none;
  * a kernel wrapper launches or raises for a non-CPU device, never quietly
    takes the plain version; a missing ``nvcc`` is an error, not a fallback;
  * ``chip_smoke.py`` exits non-zero and prints no result without a GPU, in the
    checkout and alone in an empty directory.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core.patterns import BufSpec, FullyParallel, unpack
from repro_torch.data.columns import TABLE2_PLANS
from repro_torch.data.loader import ColumnPipeline
from repro_torch.kernels import cuda
from repro_torch.kernels.fully_parallel import fully_parallel

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(k for k, v in sys.modules.items()
                if v is not None and k.split(".")[0] in ("repro", "jax", "jaxlib"))
assert not leaked, leaked
for new in ("repro_torch.core.query", "repro_torch.data.queries",
            "repro_torch.kernels.query_reduce", "repro_torch.core.serve_planner",
            "repro_torch.configs", "repro_torch.configs.base",
            "repro_torch.configs.qwen1_5_0_5b", "repro_torch.models",
            "repro_torch.models.layers", "repro_torch.models.transformer",
            "repro_torch.models.model", "repro_torch.models.weights",
            "repro_torch.models.ssm", "repro_torch.models.rwkv", "repro_torch.models.zamba",
            "repro_torch.models.encdec",
            "repro_torch.serve", "repro_torch.serve.kvcache", "repro_torch.serve.engine",
            "repro_torch.launch", "repro_torch.launch.serve", "repro_torch.launch.train",
            "repro_torch.train", "repro_torch.train.optimizer", "repro_torch.train.remat",
            "repro_torch.train.train_step", "repro_torch.train.grad_compress",
            "repro_torch.train.checkpoint", "repro_torch.train.loop",
            "repro_torch.roofline", "repro_torch.roofline.analysis",
            "repro_torch.roofline.op_cost", "repro_torch.launch.mesh",
            "repro_torch.launch.dryrun", "repro_torch.launch.elastic",
            "repro_torch.models.sharding_ctx"):
    assert new in names, new
print(len(names))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_imports_without_jax_or_reference():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20     # every module of the package


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ColumnPipeline({"L_TAX": TABLE2_PLANS["L_TAX"]})


def _bitpack_stage(device: str):
    env = {"p": torch.zeros(3, dtype=torch.int32, device=device),
           "bw": torch.ones(1, dtype=torch.int32, device=device),
           "base": torch.zeros(1, dtype=torch.int32, device=device)}
    st = FullyParallel(chain=(unpack("p", "bw", "base"),), inputs=("p", "bw", "base"),
                       specs=(BufSpec("tile", den=32, num_op="bw"), BufSpec("full"),
                              BufSpec("full")), out="o", n_out=40, elementwise=False,
                       name="bitpack")
    return st, env


def test_wrapper_raises_for_a_device_it_has_no_kernel_for():
    st, env = _bitpack_stage("meta")
    with pytest.raises(ValueError, match="no Fully-Parallel kernel"):
        fully_parallel(st, env)
    st, env = _bitpack_stage("cpu")
    env["bw"] = env["bw"].to("meta")
    with pytest.raises(ValueError, match="span devices"):
        fully_parallel(st, env)
    st, env = _bitpack_stage("cpu")
    assert fully_parallel(st, env).tolist() == [0] * 40


def test_missing_nvcc_is_an_error(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(shutil, "which", lambda *_: None)
    monkeypatch.setattr(cuda.Path, "is_file", lambda self: False)
    lib = cuda.KernelLib("fully_parallel", "zf_fully_parallel", cuda.ZfFpArgs)
    with pytest.raises(RuntimeError, match="nvcc"):
        lib.load()
    assert lib.launches == 0


def test_abi_structs_match_the_cuda_layout():
    """Every ``static_assert(sizeof(T) == N)`` in ``csrc/`` names a struct that
    ``kernels/cuda.py`` mirrors with ``ctypes`` at the same size, so a change of
    the argument structs on one side cannot drift from the other."""
    import ctypes
    import re

    sizes = {}
    for f in sorted(cuda.CSRC.glob("*.cu*")):
        for name, n in re.findall(r"static_assert\(\s*sizeof\((\w+)\)\s*==\s*(\d+)",
                                  f.read_text()):
            sizes[name] = int(n)
    assert set(sizes) == {"ZfOp", "ZfChain", "ZfFpArgs", "ZfGpArgs", "ZfNpArgs",
                          "ZfQgBuf", "ZfQgArgs"}
    assert {k: ctypes.sizeof(getattr(cuda, k)) for k in sizes} == sizes


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_gpu(where, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cwd, env = ROOT, _env()
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
        env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_pack_chain_rejects_what_the_kernels_do_not_take():
    from repro_torch.core.patterns import gather, load

    dev = torch.device("cpu")
    env = {"i": torch.zeros(4, dtype=torch.int64), "t": torch.zeros(2, dtype=torch.int32)}
    with pytest.raises(ValueError, match="32-bit"):
        cuda.pack_chain((load("i"), gather("t")), env, dev)
    env["i"] = torch.zeros(8, dtype=torch.int32)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        cuda.pack_chain((load("i"),), env, dev)
    env["i"] = torch.zeros(4, dtype=torch.int32)
    packed = cuda.pack_chain((load("i"), gather("t")), env, dev)
    assert packed.n_ops == 2 and packed.ops[1].n == 2
    with pytest.raises(ValueError, match="exceeds"):
        cuda.pack_chain((load("i"),) + (gather("t"),) * cuda.MAX_OPS, env, dev)
    with pytest.raises(ValueError, match="reads 5"):
        cuda.pack_chain((load("i"), gather("t")), env, dev, extent=5)


def test_pack_chain_keeps_narrow_operands_narrow():
    """uint8/uint16/int8 buffers go to the kernels at their own width: each op
    carries its buffer's element code (bytes, negative when signed)."""
    from repro_torch.core.patterns import gather, load, load_bytes, span

    dev = torch.device("cpu")
    env = {"b": torch.zeros(12, dtype=torch.uint8), "h": torch.zeros(3, dtype=torch.uint16),
           "s": torch.zeros(3, dtype=torch.int8), "o": torch.zeros(4, dtype=torch.int32)}
    packed = cuda.pack_chain((load_bytes("b", 4), gather("h"), gather("s"), span("o")),
                             env, dev, extent=3)
    assert [(op.elem, op.imm, op.n) for op in packed.ops[:4]] == \
        [(1, 4, 12), (2, 0, 3), (-1, 0, 3), (4, 0, 4)]
    with pytest.raises(ValueError, match="reads 16"):
        cuda.pack_chain((load_bytes("b", 4),), env, dev, extent=4)
    with pytest.raises(ValueError, match="uint8"):
        cuda.pack_chain((load_bytes("o", 4),), env, dev, extent=1)
    assert cuda.out_width(torch.empty(2, dtype=torch.uint8)) == 1
    with pytest.raises(ValueError, match="4-byte"):
        cuda.out_width(torch.empty(2, dtype=torch.int64))
