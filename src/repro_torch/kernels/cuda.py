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
library reports its argument struct's size, which is checked at load.  Each
library also has a batched entry (``<entry>_batched``) that decodes up to
``zf_batch_max()`` members' argument structs in one launch (read at load);
``KernelLib.launch_batched`` splits a larger batch into several launches.
``load(device)`` also loads every kernel of the library on that device
(``zf_preload``), so no launch of a timed run waits for CUDA's lazy module
loading.  Operands
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

from repro_torch.core.patterns import (BYTES, GATHER, I2F_DIV, LOAD, QUERY_OPS, RANGE,
                                       SPAN, UNPACK, UNPACK_RAW, UNZIGZAG, Chain)

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")
MAX_OPS = 8
_OP_CODES = {UNPACK: 0, LOAD: 1, GATHER: 2, I2F_DIV: 3, UNZIGZAG: 4, BYTES: 5,
             SPAN: 6, UNPACK_RAW: 7, RANGE: 8}
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


# kernel 4 (csrc/query_reduce.cu): one fused query's roles, predicates and
# expression program, by value in the 4 KB parameter space
QR_MAX_ROLES, QR_MAX_ROLE_OPS, QR_MAX_PREDS = 12, 4, 16
QR_MAX_INSTRS, QR_MAX_REGS, QR_MAX_LANES, QR_MAX_ACC = 48, 32, 16, 64


class ZfQRole(ctypes.Structure):
    _fields_ = [("n_ops", ctypes.c_int32), ("kind", ctypes.c_int8), ("row", ctypes.c_int8),
                ("src", ctypes.c_int8), ("type", ctypes.c_int8),
                ("ops", ZfOp * QR_MAX_ROLE_OPS)]


class ZfQPred(ctypes.Structure):
    _fields_ = [("reg", ctypes.c_int8), ("cmp", ctypes.c_int8), ("mode", ctypes.c_int8),
                ("pad", ctypes.c_int8 * 5), ("value", ctypes.c_int64)]


class ZfQInstr(ctypes.Structure):
    _fields_ = [("op", ctypes.c_int8), ("type", ctypes.c_int8), ("dst", ctypes.c_int8),
                ("a", ctypes.c_int8), ("b", ctypes.c_int8), ("src", ctypes.c_int8),
                ("pad", ctypes.c_int8 * 2), ("imm", ctypes.c_int64)]


class ZfQArgs(ctypes.Structure):
    _fields_ = [("roles", ZfQRole * QR_MAX_ROLES), ("preds", ZfQPred * QR_MAX_PREDS),
                ("prog", ZfQInstr * QR_MAX_INSTRS), ("lane_reg", ctypes.c_int8 * QR_MAX_LANES),
                ("n_roles", ctypes.c_int32), ("n_preds", ctypes.c_int32),
                ("n_instrs", ctypes.c_int32), ("n_lanes", ctypes.c_int32),
                ("n_segments", ctypes.c_int32), ("key_reg", ctypes.c_int32),
                ("accumulate", ctypes.c_int32), ("n_blocks", ctypes.c_int32),
                ("n", ctypes.c_int64), ("out_start", ctypes.c_int64),
                ("out", ctypes.c_void_p), ("partials", ctypes.c_void_p),
                ("counter", ctypes.c_void_p)]


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
    """One compiled ``csrc/<name>.cu`` plus the launch counts of its kernel.

    ``launches`` goes up by one for each kernel launch made through ``launch``
    or ``launch_batched`` and nowhere else, so a run can show that its path
    went through the kernel; ``batched_launches`` counts the batched ones
    among them.  ``batch_max`` is the most members one batched launch takes
    (its structs must fit the 4 KB kernel parameter space), as the library
    reports it at load; a library of an older tree (``scripts/kernel_variants.py
    --baseline``) has neither a batched entry nor ``zf_preload``: it leaves
    ``batch_max`` None and loads its kernels at their first launches.
    ``preload_s`` is the wall time of ``zf_preload`` per device index (the
    query kernel's library has ``zf_preload`` and no batched entry)."""

    def __init__(self, name: str, entry: str, args_type: type):
        self.name = name
        self.entry = entry
        self.args_type = args_type
        self.batch_max: int | None = None
        self.launches = 0
        self.batched_launches = 0
        self.build_s: float | None = None   # wall time of this process's nvcc
        self.preload_s: dict[int, float] = {}
        self._lib: ctypes.CDLL | None = None
        self._preload = False                # the library exports zf_preload
        self._batched = None                 # the batched entry, bound at first use

    def path(self) -> Path:
        return build_root() / _source_hash() / f"lib{self.name}.so"

    def compile_cmd(self, out: Path) -> list[str]:
        return [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out),
                str(CSRC / f"{self.name}.cu")]

    def load(self, device: torch.device | None = None) -> ctypes.CDLL:
        """The built library; with a CUDA ``device``, every kernel of it is
        loaded there too (once per device)."""
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
            if hasattr(lib, "zf_batch_max"):
                lib.zf_batch_max.restype = ctypes.c_int
                self.batch_max = lib.zf_batch_max()
            if hasattr(lib, "zf_preload"):
                lib.zf_preload.argtypes = [ctypes.c_int32]
                lib.zf_preload.restype = ctypes.c_int
                self._preload = True
            self._lib = lib
        if device is not None and device.type == "cuda" \
                and device.index not in self.preload_s and self._preload:
            index = torch.cuda.current_device() if device.index is None else device.index
            t0 = time.perf_counter()
            err = self._lib.zf_preload(index)
            if err != 0:
                msg = self._lib.zf_error_string(err).decode()
                raise RuntimeError(f"{self.name}: loading its kernels failed: {msg} ({err})")
            self.preload_s[device.index] = time.perf_counter() - t0
        return self._lib

    def launch(self, args: ctypes.Structure, threads: int,
               device: torch.device) -> None:
        lib = self.load(device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, self.entry)(ctypes.addressof(args), int(threads),
                                       int(device.index), stream)
        if err != 0:
            msg = lib.zf_error_string(err).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: {msg} ({err})")
        self.launches += 1

    def launch_batched(self, members: list, threads: int, device: torch.device) -> None:
        """The batched kernel over the members' argument structs: one launch per
        ``batch_max`` of them."""
        fn = self._batched
        if fn is None:
            lib = self.load(device)
            if self.batch_max is None:
                raise RuntimeError(f"{self.name}: this library has no batched entry")
            fn = getattr(lib, f"{self.entry}_batched")
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                           ctypes.c_int32, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._batched = fn
        lib = self.load(device)
        stream = torch.cuda.current_stream(device).cuda_stream
        for i in range(0, len(members), self.batch_max):
            part = members[i:i + self.batch_max]
            structs = (self.args_type * len(part))(*part)
            err = fn(ctypes.addressof(structs), len(part), int(threads),
                     int(device.index), stream)
            if err != 0:
                msg = lib.zf_error_string(err).decode()
                raise RuntimeError(f"{self.name} batched launch of {len(part)} failed: "
                                   f"{msg} ({err})")
            self.launches += 1
            self.batched_launches += 1


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
               extent: int = 0, query_ops: bool = False) -> ZfChain:
    """The C struct of an op chain, with each op's buffers resolved in ``env``.

    ``extent`` is the number of indices the chain's source is read at (the
    kernel reads a ``LOAD`` buffer unchecked there; the other ops clamp).
    ``UNPACK_RAW`` and ``RANGE`` reach the query kernel only (``query_ops``);
    ``TEST`` is compiled into its predicates, never packed."""
    if len(chain) > MAX_OPS:
        raise ValueError(f"chain of {len(chain)} ops exceeds the kernels' {MAX_OPS}")
    out = ZfChain(n_ops=len(chain))
    for k, op in enumerate(chain):
        if op.kind in QUERY_OPS and (not query_ops or op.kind not in _OP_CODES):
            raise ValueError(f"{op}: the decode kernels do not take this op")
        ptrs = [operand(env[b], f"{op} input {b!r}", device) for b in op.bufs]
        reads = extent * (op.imm if op.kind == BYTES else 1)
        if op.kind in (LOAD, BYTES) and env[op.bufs[0]].numel() < reads:
            raise ValueError(f"{op}: buffer holds {env[op.bufs[0]].numel()} "
                             f"elements, the chain reads {reads}")
        if op.kind in (UNPACK, UNPACK_RAW):
            if _ELEM_CODES[env[op.bufs[0]].dtype] != 4:
                raise ValueError(f"{op}: packed words must be 32-bit")
            if any(env[b].dtype != torch.int32 for b in op.bufs[1:]):
                raise ValueError(f"{op}: bit width and base operands must be int32")
        if op.kind == RANGE and env[op.bufs[0]].dtype != torch.int32:
            raise ValueError(f"{op}: the base operand must be int32")
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
        if op.kind == RANGE:
            # the bounds: n = lo, b = hi (64-bit integers), imm bits = present
            lo, hi = op.arg
            for x in (lo, hi):
                if x is not None and not -2**62 <= x < 2**62:
                    raise ValueError(f"{op}: bound {x} outside the 64-bit compare")
            out.ops[k].n = 0 if lo is None else lo
            out.ops[k].b = None if hi is None else hi & (2**64 - 1)
            out.ops[k].imm = (lo is not None) | (hi is not None) << 1
    return out
