"""Kernel 4: a fused query's decode, filter and aggregate in one launch.

No TPU kernel corresponds: the reference runs its terminal ``Reduce`` under XLA
jit (``src/repro/core/compiler.py:204 compile_query_chunk_graph``), which fuses
the decode chains into the reduction and emits straight-line code per query.
``query_reduce`` launches the port's counterpart over one chunk of items: a
kernel generated for the query (``kernels/query_codegen.py`` writes it,
``csrc/query_gen.cuh`` holds its loop, loads and sums; what bounds it and
how it is laid out is noted there).  Per item it evaluates every role's op
chain, the masks and predicates, the lanes and the group key, and it sums
per block in a fixed order.  The decoded columns never reach device memory.
Its plain version is ``repro_torch.kernels.ref.query_reduce_torch``.

The expressions (``core/query.py`` trees) become a small register program:
one register per role (the role's value, in its type), then one per
constant, cast and arithmetic node, with common subtrees shared.  Each node's
type is the one torch gives the plain version (the expression evaluated on
empty tensors of the roles' types), so the kernel converts and wraps where
torch does.  The generated kernel has two limits of its own: the launch
struct's buffer slots (``cuda.QG_MAX_BUFS``; a query past them raises) and
shared memory, which holds each thread's column of accumulators when there
are several segments; a query whose columns do not fit keeps them in global
memory (``_Program.acc_place``), so it still runs on the kernel.  ``program`` builds the
program once per stage and buffer types and, when it first meets a CUDA
device, builds its kernel with ``nvcc`` (into ``cuda.build_root()/<digest>/``,
one build per distinct program) and loads it there, so ``lower_query`` on a
card (``ColumnPipeline.lower_query``) compiles before any timed run.
"""
from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from repro_torch.core.patterns import BYTES, LOAD, MASK, ROW, TEST, WEIGHT, Reduce
from repro_torch.core.query import Col
from repro_torch.kernels import cuda, query_codegen, ref
from repro_torch.kernels.fully_parallel import check_out, stage_device

THREADS = 128             # csrc/query_gen.cuh ZF_QG_THREADS
ROWS_PER_THREAD = 4       # consecutive items a thread takes per tile (ZF_QG_ROWS)
MAX_BLOCKS = 132 * 8      # 8 blocks on each of the H100's 132 SMs
MAX_SMEM = 231_424        # dynamic shared memory a block may opt into (ZF_QG_MAX_SMEM)
REG_ACCS = 32             # the most accumulators kept in registers (ZF_QG_REG_ACCS)


class _Launches:
    """The generated kernels' launch count, every query's together: ``query_reduce``
    adds one where it launches one, and nowhere else."""

    name = "query_gen"

    def __init__(self):
        self.launches = 0


KERNEL = _Launches()


class _GeneratedLib(cuda.KernelLib):
    """One generated kernel's library: ``cuda.build_root()/<digest>/`` holds its
    source and its ``.so``."""

    def __init__(self, digest: str, source: str):
        super().__init__("query_gen", "zf_query_gen", cuda.ZfQgArgs)
        self.digest, self.source = digest, source
        self.max_blocks: dict[int, int] = {}   # per device: the blocks that run at once

    def load(self, device: torch.device | None = None):
        lib = super().load(device)
        if device is not None and device.type == "cuda" and device.index not in self.max_blocks:
            lib.zf_max_blocks.argtypes = [ctypes.c_int32]
            lib.zf_max_blocks.restype = ctypes.c_int
            blocks = lib.zf_max_blocks(device.index)
            if blocks < 1:
                raise RuntimeError(f"query_gen {self.digest}: no block fits an SM "
                                   f"({lib.zf_error_string(-blocks).decode()})")
            self.max_blocks[device.index] = blocks
        return lib

    def path(self):
        return cuda.build_root() / self.digest / "libquery_gen.so"

    def compile_cmd(self, out):
        src = self.path().with_name("query_gen.cu")
        tmp = src.with_name(f"query_gen.{os.getpid()}.cu")
        tmp.write_text(self.source)
        os.replace(tmp, src)
        return [cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", str(cuda.CSRC), "-o", str(out), str(src)]


_LIBRARIES: dict[str, _GeneratedLib] = {}


def library(source: str) -> _GeneratedLib:
    """The library of a generated source, one per digest in a process."""
    digest = query_codegen.digest(source)
    if digest not in _LIBRARIES:
        _LIBRARIES[digest] = _GeneratedLib(digest, source)
    return _LIBRARIES[digest]

_TYPES = {torch.float32: 0, torch.int32: 4, torch.uint8: 1, torch.bool: 1,
          torch.int8: -1, torch.uint16: 2, torch.int16: -2}
_ROLE_KINDS = {MASK: 1, WEIGHT: 2}            # value and row roles: 0
_INSTR = {"const": 0, "cast": 1, "+": 2, "-": 3, "*": 4, "%": 5}
_CMP = {"<": 0, "<=": 1, ">=": 2, ">": 3}


def _type(dt: torch.dtype, what: str) -> int:
    if dt not in _TYPES:
        raise ValueError(f"{what}: the query kernel takes float32 and 8/16/32-bit "
                         f"integers, not {dt}")
    return _TYPES[dt]


def _word(value, dt: torch.dtype) -> int:
    """A constant's 32-bit register word in type ``dt`` (as torch converts it)."""
    v = torch.tensor(value).to(dt)
    if dt == torch.float32:
        return int(v.view(torch.int32).item()) & 0xFFFFFFFF
    return int(v.to(torch.int64).item()) & 0xFFFFFFFF


class _Program:
    """A Reduce's kernel-side description that does not change per chunk: per
    role (chain without its ``TEST``, kind, source and target types), the
    predicates, the instructions, the lane and key registers, the segments
    and each buffer's element code; its generated kernel (``source``, ``lib``)
    and the wall time of the ``nvcc`` this program started (``build_s``, None
    when the build existed)."""

    def __init__(self, stage: Reduce, env: dict[str, torch.Tensor]):
        self.roles = []          # (chain, kind code, row?, src type, type)
        self.preds = []          # (reg, cmp, mode, value)
        self.instrs = []         # (op, type, dst, a, b, src, imm)
        self.n_segments = stage.n_segments
        self.lib: _GeneratedLib | None = None
        self.build_s: float | None = None
        regs: dict[str, tuple[int, torch.dtype]] = {}
        for role in stage.roles:
            for op in role.chain:
                cuda.check_op_types(op, env)
        self.elems = {b: cuda._ELEM_CODES[env[b].dtype] for b in stage.inputs}
        for k, role in enumerate(stage.roles):
            chain, kind, dt = role.chain, _ROLE_KINDS.get(role.kind, 0), ref.torch_dtype(role.dtype)
            tests = [op for op in chain if op.kind == TEST]
            if tests:
                if chain[-1].kind != TEST or len(tests) > 1:
                    raise ValueError(f"{stage.name}: a TEST must end the role's chain")
                chain, kind, dt = chain[:-1], 0, ref.torch_dtype(tests[0].arg[1])
            src = ref.chain_dtype(chain, env)
            if chain[0].kind == BYTES and dt.itemsize == 4:
                src = dt                      # a word of the element's bits
            what = f"{stage.name} role {role.col}"
            self.roles.append((chain, kind, role.kind == ROW, _type(src, what),
                               _type(dt, what)))
            if tests:
                for p in tests[0].arg[0]:
                    self._pred(k, dt, p)
            elif role.kind not in (MASK, WEIGHT):
                regs[role.col] = (k, dt)
        self.n_regs = len(stage.roles)
        for p in stage.preds:
            k, dt = regs[p.col]
            self._pred(k, dt, p)
        self._regs, self._memo = regs, {}
        empties = {c: torch.empty(0, dtype=dt) for c, (_, dt) in regs.items()}
        self._empties = empties
        self.lanes = [self._as(self._node(e), torch.float32) for e in stage.lanes]
        self.key = (-1 if stage.key is None
                    else self._as(self._node(stage.key), torch.int32))
        self.n_acc = (len(self.lanes) + 1) * stage.n_segments
        if 4 * self.n_acc * (THREADS // 32) > MAX_SMEM:
            raise ValueError(f"{stage.name}: {self.n_acc} accumulators: a block's warp sums "
                             f"exceed the query kernel's {MAX_SMEM} bytes of shared memory")
        # per buffer slot of the launch struct: its name, and for a LOAD or
        # BYTES source the elements an item reads and whether at the global row
        self.slots = []
        for k, o, _, b in query_codegen.slots(self):
            chain, _, row = self.roles[k][:3]
            op = chain[o]
            per = (op.imm if op.kind == BYTES else 1) if o == 0 and op.kind in (LOAD, BYTES) else 0
            self.slots.append((b, per, row))

    @property
    def acc_place(self) -> str:
        """Where a thread keeps its accumulators (``ZfQgLayout`` in
        ``csrc/query_gen.cuh``): ``"registers"`` (one segment, at most
        ``REG_ACCS``), else a column of ``n_acc`` floats in ``"shared"`` memory,
        or in ``"global"`` memory when a block's columns and warp sums exceed
        ``MAX_SMEM``."""
        if self.n_segments == 1 and self.n_acc <= REG_ACCS:
            return "registers"
        if 4 * self.n_acc * (THREADS + THREADS // 32) > MAX_SMEM:
            return "global"
        return "shared"

    @functools.cached_property
    def source(self) -> str:
        """The CUDA source of this program's kernel."""
        return query_codegen.generate(self)

    def kernel(self, device: torch.device) -> cuda.KernelLib:
        """This program's kernel, built at first use and loaded on ``device``."""
        if self.lib is None or not self.lib.loaded:
            build_programs([self])
        self.lib.load(device)
        return self.lib

    def _pred(self, reg: int, dt: torch.dtype, p) -> None:
        bounds = ([(">=", p.value), ("<=", p.value2)] if p.op == "between"
                  else [(p.op, p.value)])
        for op, value in bounds:
            if op not in _CMP:
                raise ValueError(f"unknown predicate op {p.op!r}")
            if torch.result_type(torch.empty(0, dtype=dt), value).is_floating_point:
                mode = 1 if dt.is_floating_point else 2
                word = int(np.float32(value).view(np.int32)) & 0xFFFFFFFF
                self.preds.append((reg, _CMP[op], mode, word))
            else:
                self.preds.append((reg, _CMP[op], 0, int(value)))

    def _emit(self, op: str, dt: torch.dtype, a: int = 0, b: int = 0, src: int = 0,
              imm: int = 0) -> int:
        key = (op, dt, a, b, src, imm)
        if key not in self._memo:       # common subexpressions share a register
            self.instrs.append((_INSTR[op], _type(dt, "query expression"), self.n_regs,
                                a, b, src, imm))
            self._memo[key] = self.n_regs
            self.n_regs += 1
        return self._memo[key]

    def _as(self, node, dt: torch.dtype) -> int:
        """A node (register and type, or a Python scalar) as a register of ``dt``."""
        if not isinstance(node, tuple):
            return self._emit("const", dt, imm=_word(node, dt))
        reg, have = node
        if have == dt:
            return reg
        return self._emit("cast", dt, a=reg, src=_type(have, "query expression"))

    def _node(self, e):
        """Register and torch dtype of an expression node, or a Python scalar
        for a constant subtree."""
        v = e.eval(self._empties)
        if not isinstance(v, torch.Tensor):
            return v
        if isinstance(e, Col):
            return self._as(self._regs[e.name], v.dtype), v.dtype
        a, b = self._node(e.a), self._node(e.b)
        return self._emit(e.op, v.dtype, self._as(a, v.dtype), self._as(b, v.dtype)), v.dtype


def program(stage: Reduce, env: dict[str, torch.Tensor]) -> _Program:
    """The stage's compiled program, built once per stage and buffer types.  On
    a CUDA device its kernel is built (at its first use anywhere: ``nvcc`` into
    ``cuda.build_root()/<digest>/``) and loaded there too."""
    sig = tuple(env[b].dtype for b in stage.inputs)
    memo = stage.__dict__.setdefault("_kernel_programs", {})
    if sig not in memo:
        memo[sig] = _Program(stage, env)
    prog = memo[sig]
    device = stage_device(stage.inputs, env)
    if device.type == "cuda":
        prog.kernel(device)
    return prog


def build_programs(progs) -> None:
    """Build the kernels of ``progs`` that are not built yet in one ``cuda.build``
    (one ``nvcc`` per source, all at once).  A program whose kernel this call
    built records the build's wall time in ``build_s``; a failed build raises."""
    fresh: dict[str, _Program] = {}
    for p in progs:
        if p.lib is None:
            p.lib = library(p.source)
        if not p.lib.path().is_file():
            fresh.setdefault(p.lib.digest, p)
    cuda.build([p.lib for p in fresh.values()])
    for p in fresh.values():
        p.build_s = p.lib.build_s


def n_blocks(n: int, max_blocks: int = MAX_BLOCKS) -> int:
    """The grid of a launch over n items: a tile of THREADS x ROWS_PER_THREAD
    items a block, at most ``max_blocks`` (a generated kernel's: the blocks its
    SMs hold at once, so no block waits for a second wave)."""
    return max(1, min(-(-n // (THREADS * ROWS_PER_THREAD)), max_blocks))


def _generated_args(prog: _Program, env, device, n: int, out_start: int,
                    out: torch.Tensor, accumulate: bool, max_blocks: int = MAX_BLOCKS):
    """A generated kernel's argument struct and the scratch it points into (block
    partials, the counter, and each thread's accumulator column when they live
    in global memory): each buffer slot's pointer and element count, and the
    launch's own fields.  The program is compiled in, so nothing of it is
    packed here."""
    grid = n_blocks(n, max_blocks)
    n_acc = prog.n_acc
    cols = grid * n_acc * THREADS if prog.acc_place == "global" else 0
    scratch = torch.empty(grid * n_acc + 1 + cols, dtype=torch.float32, device=device)
    args = cuda.ZfQgArgs(n=n, out_start=out_start, accumulate=int(accumulate), n_blocks=grid,
                         out=out.data_ptr(), partials=scratch.data_ptr(),
                         counter=scratch.data_ptr() + 4 * grid * n_acc,
                         cols=scratch.data_ptr() + 4 * (grid * n_acc + 1) if cols else None)
    for s, (name, per, row) in enumerate(prog.slots):
        t = env[name]
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the launch on {device}")
        if not t.is_contiguous() or t.numel() == 0:
            raise ValueError(f"{name} must be a non-empty contiguous tensor")
        if per and t.numel() < per * (out_start + n if row else n):
            raise ValueError(f"{name}: buffer holds {t.numel()} elements, the query reads "
                             f"{per * (out_start + n if row else n)}")
        args.bufs[s].p, args.bufs[s].n = t.data_ptr(), t.numel()
    return args, scratch


def _prepare(stage: Reduce, env, n, out, accumulate):
    """The launch's length, device and output after the wrapper's checks; the
    device is None when the inputs lie on the CPU (the plain version's case)."""
    n = stage.n_in if n is None else int(n)
    if n < 1:
        raise ValueError(f"{stage.name}: a launch covers at least one item, not {n}")
    device = stage_device(stage.inputs, env)
    if out is not None:
        check_out(out, stage.n_out, torch.float32, stage.name)
    elif accumulate:
        raise ValueError(f"{stage.name}: accumulate needs an out")
    if device.type == "cpu":
        return n, None, out
    if device.type != "cuda":
        raise ValueError(f"no query kernel for device {device}")
    if out is None:
        out = torch.empty(stage.n_out, dtype=torch.float32, device=device)
    elif out.device != device:
        raise ValueError(f"{stage.name}: out is on {out.device}, the launch on {device}")
    return n, device, out


def query_reduce(stage: Reduce, env: dict[str, torch.Tensor], *, n: int | None = None,
                 out_start: int = 0, out: torch.Tensor | None = None,
                 accumulate: bool = False) -> torch.Tensor:
    """The partial aggregate of items ``[out_start, out_start + n)`` (default all
    ``n_in``): the query's generated CUDA kernel on a CUDA device, the plain
    version on the CPU.  On CUDA it launches or raises (a failed build or
    launch included); nothing falls back to another kernel or the plain version.

    A chunk passes its slices of the tiled leaves in ``env`` (read at local
    indices; resident "row" columns whole, read at global ones).  ``out``, when
    given, receives the ``n_out`` lanes, or has them added (``accumulate``: the
    executor's running sum over chunks, in chunk order)."""
    n, device, out = _prepare(stage, env, n, out, accumulate)
    if device is None:
        res = ref.query_reduce_torch(stage, env, n, out_start)
        if out is None:
            return res
        return out.add_(res) if accumulate else out.copy_(res)
    prog = program(stage, env)
    # the scratch is freed on return: the caching allocator hands it out again
    # only to work queued after this launch on the same stream
    args, _scratch = _generated_args(prog, env, device, n, out_start, out, accumulate,
                                     max_blocks=prog.lib.max_blocks[device.index])
    prog.lib.launch(args, THREADS, device)
    KERNEL.launches += 1
    return out
