"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``; pointers come from
``tensor.data_ptr()`` and the stream from ``torch.cuda.current_stream()``.  No
PyTorch headers are compiled, so a build takes seconds.  Libraries land in
``build/repro_torch_ext/<hash>/`` under the checkout (``REPRO_TORCH_BUILD_DIR``
overrides), keyed by a hash of every source and the flags, and are built at
first use, all sources concurrently.  A build or launch failure raises; nothing
falls back to the plain versions.

The op-chain structs below mirror ``csrc/zf_chain.cuh`` byte for byte; every
library reports its argument struct's size, which is checked at load.  Operands
reach the kernels at their own width (8-, 16- or 32-bit elements); each op
carries its buffer's element code, and each launch its output's width.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from repro_torch.core.patterns import (BYTES, GATHER, I2F_DIV, LOAD, SPAN, UNPACK,
                                       UNZIGZAG, Chain)

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")
MAX_OPS = 8
_OP_CODES = {UNPACK: 0, LOAD: 1, GATHER: 2, I2F_DIV: 3, UNZIGZAG: 4, BYTES: 5,
             SPAN: 6}
# element code of a buffer: bytes per element, negative for a signed narrow type
_ELEM_CODES = {torch.int32: 4, torch.uint32: 4, torch.float32: 4,
               torch.uint16: 2, torch.int16: -2, torch.uint8: 1, torch.bool: 1,
               torch.int8: -1}


class ZfOp(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int32), ("elem", ctypes.c_int16),
                ("imm", ctypes.c_int16), ("n", ctypes.c_int64),
                ("a", ctypes.c_void_p), ("b", ctypes.c_void_p),
                ("c", ctypes.c_void_p)]


class ZfChain(ctypes.Structure):
    _fields_ = [("n_ops", ctypes.c_int32), ("pad", ctypes.c_int32),
                ("ops", ZfOp * MAX_OPS)]


class ZfFpArgs(ctypes.Structure):
    _fields_ = [("chain", ZfChain), ("out", ctypes.c_void_p), ("n", ctypes.c_int64),
                ("L", ctypes.c_int32), ("C", ctypes.c_int32),
                ("out_width", ctypes.c_int32), ("stage_words", ctypes.c_int32)]


class ZfGpArgs(ctypes.Structure):
    _fields_ = [("presum", ctypes.c_void_p), ("n_groups", ctypes.c_int64),
                ("values", ZfChain * 2), ("tail", ZfChain),
                ("chars", ZfOp), ("offs", ZfOp),
                ("map_kind", ctypes.c_int32), ("out_width", ctypes.c_int32),
                ("out", ctypes.c_void_p), ("n", ctypes.c_int64),
                ("L", ctypes.c_int32), ("C", ctypes.c_int32),
                # appended, so an older kernel's struct is a prefix of this one
                ("out_start", ctypes.c_int64), ("g_start", ctypes.c_int64)]


class ZfNpArgs(ctypes.Structure):
    _fields_ = [("streams", ctypes.c_void_p), ("states", ctypes.c_void_p),
                ("sym", ctypes.c_void_p), ("freq", ctypes.c_void_p),
                ("cum", ctypes.c_void_p), ("max_words", ctypes.c_int64),
                ("n_chunks", ctypes.c_int64), ("n", ctypes.c_int64),
                ("tail", ZfChain), ("out", ctypes.c_void_p),
                ("chunk_size", ctypes.c_int32), ("out_width", ctypes.c_int32),
                ("L", ctypes.c_int32), ("C", ctypes.c_int32)]


def build_root() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/cuda.py -> checkout root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_ext"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


class KernelLib:
    """One compiled ``csrc/<name>.cu`` plus the launch count of its kernel.

    ``launches`` goes up by one for each kernel launch made through ``launch``
    and nowhere else, so a run can show that its path went through the kernel."""

    def __init__(self, name: str, entry: str, args_type: type):
        self.name = name
        self.entry = entry
        self.args_type = args_type
        self.launches = 0
        self.build_s: float | None = None   # wall time of this process's nvcc
        self._lib: ctypes.CDLL | None = None

    def path(self) -> Path:
        return build_root() / _source_hash() / f"lib{self.name}.so"

    def compile_cmd(self, out: Path) -> list[str]:
        return [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out),
                str(CSRC / f"{self.name}.cu")]

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            build([self])
            lib = ctypes.CDLL(str(self.path()))
            fn = getattr(lib, self.entry)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.zf_error_string.argtypes = [ctypes.c_int]
            lib.zf_error_string.restype = ctypes.c_char_p
            lib.zf_args_size.argtypes = []
            lib.zf_args_size.restype = ctypes.c_int
            size = lib.zf_args_size()
            if size != ctypes.sizeof(self.args_type):
                raise RuntimeError(f"{self.name}: argument struct is {size} bytes in "
                                   f"CUDA, {ctypes.sizeof(self.args_type)} in Python")
            self._lib = lib
        return self._lib

    def launch(self, args: ctypes.Structure, threads: int,
               device: torch.device) -> None:
        lib = self.load()
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, self.entry)(ctypes.addressof(args), int(threads),
                                       int(device.index), stream)
        if err != 0:
            msg = lib.zf_error_string(err).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: {msg} ({err})")
        self.launches += 1


_BUILD_LOCK = threading.Lock()


def build(libs) -> None:
    """Compile every missing library, one ``nvcc`` per source, all at once."""
    with _BUILD_LOCK:
        todo = [lib for lib in libs if not lib.path().is_file()]
        if not todo:
            return
        procs = []
        for lib in todo:
            out = lib.path()
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = lib.compile_cmd(tmp)
            log = open(out.with_suffix(".log"), "w")
            procs.append((lib, tmp, log, time.perf_counter(), subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT)))
        running = list(procs)
        while running:   # each library's own build time, not its place in line
            for lib, _, _, t0, proc in running:
                if proc.poll() is not None:
                    lib.build_s = time.perf_counter() - t0
            running = [p for p in running if p[4].returncode is None]
            time.sleep(0.05)
        failed = []
        for lib, tmp, log, _, proc in procs:
            rc = proc.returncode
            log.close()
            if rc != 0:
                failed.append(f"{lib.name}: nvcc exit {rc}\n"
                              f"{lib.path().with_suffix('.log').read_text()}")
            else:
                os.replace(tmp, lib.path())   # atomic: concurrent builds agree
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


# --------------------------------------------------------------- op-chain ABI

def operand(t: torch.Tensor, what: str, device: torch.device,
            dtypes=tuple(_ELEM_CODES)) -> int:
    """The device pointer of a tensor a kernel reads, after checking it."""
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, the launch on {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{what} has dtype {t.dtype}; the kernels take 8-, 16- and "
                         f"32-bit elements ({', '.join(map(str, dtypes))})")
    if not t.is_contiguous() or t.numel() == 0:
        raise ValueError(f"{what} must be a non-empty contiguous tensor")
    return t.data_ptr()


def pack_buffer(t: torch.Tensor, what: str, device: torch.device) -> ZfOp:
    """A whole buffer as an op's ``a`` operand (pointer, count, element code)."""
    return ZfOp(a=operand(t, what, device), n=t.numel(), elem=_ELEM_CODES[t.dtype])


def out_width(t: torch.Tensor) -> int:
    """Bytes per element of a kernel's output (the kernels store 1, 2 or 4)."""
    if t.element_size() not in (1, 2, 4):
        raise ValueError(f"the kernels write 1-, 2- or 4-byte elements, not {t.dtype}")
    return t.element_size()


def pack_chain(chain: Chain, env: dict[str, torch.Tensor], device: torch.device,
               extent: int = 0) -> ZfChain:
    """The C struct of an op chain, with each op's buffers resolved in ``env``.

    ``extent`` is the number of indices the chain's source is read at (the
    kernel reads a ``LOAD`` buffer unchecked there; the other ops clamp)."""
    if len(chain) > MAX_OPS:
        raise ValueError(f"chain of {len(chain)} ops exceeds the kernels' {MAX_OPS}")
    out = ZfChain(n_ops=len(chain))
    for k, op in enumerate(chain):
        ptrs = [operand(env[b], f"{op} input {b!r}", device) for b in op.bufs]
        reads = extent * (op.imm if op.kind == BYTES else 1)
        if op.kind in (LOAD, BYTES) and env[op.bufs[0]].numel() < reads:
            raise ValueError(f"{op}: buffer holds {env[op.bufs[0]].numel()} "
                             f"elements, the chain reads {reads}")
        if op.kind == UNPACK:
            if _ELEM_CODES[env[op.bufs[0]].dtype] != 4:
                raise ValueError(f"{op}: packed words must be 32-bit")
            bw, base = env[op.bufs[1]], env[op.bufs[2]]
            if bw.dtype != torch.int32 or base.dtype != torch.int32:
                raise ValueError(f"{op}: bit width and base operands must be int32")
        if op.kind == I2F_DIV and env[op.bufs[0]].dtype != torch.float32:
            raise ValueError(f"{op}: the scale must be float32")
        if op.kind == BYTES and (env[op.bufs[0]].dtype != torch.uint8 or op.imm < 1):
            raise ValueError(f"{op}: reads a uint8 buffer, item size >= 1")
        ptrs += [None] * (3 - len(ptrs))
        buf = env[op.bufs[0]] if op.bufs else None
        out.ops[k] = ZfOp(kind=_OP_CODES[op.kind], imm=op.imm,
                          elem=_ELEM_CODES[buf.dtype] if buf is not None else 4,
                          n=buf.numel() if buf is not None else 0,
                          a=ptrs[0], b=ptrs[1], c=ptrs[2])
    return out
