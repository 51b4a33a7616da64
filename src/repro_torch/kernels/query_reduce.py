"""Kernel 4: a fused query's decode, filter and aggregate in one launch.

No TPU kernel corresponds: the reference runs its terminal ``Reduce`` under XLA
jit (``src/repro/core/compiler.py:204 compile_query_chunk_graph``), which fuses
the decode chains into the reduction.  ``query_reduce`` launches the port's
counterpart, ``csrc/query_reduce.cu``, over one chunk of items: every role's
op chain, the masks and predicates, the lanes and the group key per item, and
partial sums per block summed in a fixed order (what bounds it and how it is
laid out is noted there).  The decoded columns never reach device memory.
Its plain version is ``repro_torch.kernels.ref.query_reduce_torch``.

The expressions (``core/query.py`` trees) become a small program the kernel
interprets: one register per role (the role's value, in its type), then one
per constant, cast and arithmetic node, with common subtrees shared.  Each
node's type is the one torch gives the plain version (the expression
evaluated on empty tensors of the roles' types), so the kernel converts and
wraps where torch does.  A query that needs more roles, ops, predicates,
instructions, registers or lanes than the argument struct holds raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.patterns import BYTES, MASK, ROW, TEST, WEIGHT, Reduce
from repro_torch.core.query import Col
from repro_torch.kernels import cuda, ref
from repro_torch.kernels.fully_parallel import check_out, stage_device

KERNEL = cuda.KernelLib("query_reduce", "zf_query_reduce", cuda.ZfQArgs)
THREADS = 128
ROWS_PER_THREAD = 4       # items a thread takes at least, before the grid is capped
MAX_BLOCKS = 132 * 8      # 8 blocks on each of the H100's 132 SMs

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
    predicates, the instructions, the lane and key registers."""

    def __init__(self, stage: Reduce, env: dict[str, torch.Tensor]):
        self.roles = []          # (chain, kind code, row?, src type, type)
        self.preds = []          # (reg, cmp, mode, value)
        self.instrs = []         # (op, type, dst, a, b, src, imm)
        regs: dict[str, tuple[int, torch.dtype]] = {}
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
        if self.n_regs > cuda.QR_MAX_REGS or len(self.instrs) > cuda.QR_MAX_INSTRS \
                or len(self.preds) > cuda.QR_MAX_PREDS or len(self.roles) > cuda.QR_MAX_ROLES \
                or len(self.lanes) > cuda.QR_MAX_LANES \
                or (len(self.lanes) + 1) * stage.n_segments > cuda.QR_MAX_ACC:
            raise ValueError(
                f"{stage.name}: {len(self.roles)} roles, {len(self.preds)} predicates, "
                f"{len(self.instrs)} instructions, {self.n_regs} registers, "
                f"{len(self.lanes)} lanes x {stage.n_segments} segments exceed the query "
                f"kernel's {cuda.QR_MAX_ROLES}, {cuda.QR_MAX_PREDS}, {cuda.QR_MAX_INSTRS}, "
                f"{cuda.QR_MAX_REGS}, {cuda.QR_MAX_LANES} and {cuda.QR_MAX_ACC} accumulators")
        self.template = self._template(stage)

    def _template(self, stage: Reduce) -> cuda.ZfQArgs:
        """The argument struct's fields that every launch of this program shares."""
        args = cuda.ZfQArgs(n_roles=len(self.roles), n_preds=len(self.preds),
                            n_instrs=len(self.instrs), n_lanes=len(self.lanes),
                            n_segments=stage.n_segments, key_reg=self.key)
        for k, (chain, kind, row, src, dt) in enumerate(self.roles):
            if len(chain) > cuda.QR_MAX_ROLE_OPS:
                raise ValueError(f"{stage.name}: a role chain of {len(chain)} ops exceeds "
                                 f"the query kernel's {cuda.QR_MAX_ROLE_OPS}")
            role = args.roles[k]
            role.n_ops, role.kind, role.row, role.src, role.type = len(chain), kind, row, src, dt
        for k, (reg, cmp, mode, value) in enumerate(self.preds):
            args.preds[k] = cuda.ZfQPred(reg=reg, cmp=cmp, mode=mode, value=value)
        for k, (op, dt, dst, a, b, src, imm) in enumerate(self.instrs):
            args.prog[k] = cuda.ZfQInstr(op=op, type=dt, dst=dst, a=a, b=b, src=src, imm=imm)
        for k, reg in enumerate(self.lanes):
            args.lane_reg[k] = reg
        return args

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
    """The stage's compiled program, built once per stage and role types."""
    sig = tuple(ref.chain_dtype(r.chain, env) for r in stage.roles)
    memo = stage.__dict__.setdefault("_kernel_programs", {})
    if sig not in memo:
        memo[sig] = _Program(stage, env)
    return memo[sig]


def n_blocks(n: int) -> int:
    return max(1, min(-(-n // (THREADS * ROWS_PER_THREAD)), MAX_BLOCKS))


def _launch_args(stage: Reduce, env, device, n: int, out_start: int, out: torch.Tensor,
                 accumulate: bool):
    """The argument struct and the scratch (block partials + the counter) it
    points into: the program's template with this launch's pointers, length
    and offsets."""
    prog = program(stage, env)
    grid = n_blocks(n)
    n_acc = (len(prog.lanes) + 1) * stage.n_segments
    scratch = torch.empty(grid * n_acc + 1, dtype=torch.float32, device=device)
    args = cuda.ZfQArgs.from_buffer_copy(prog.template)
    args.accumulate, args.n_blocks, args.n, args.out_start = int(accumulate), grid, n, out_start
    args.out, args.partials = out.data_ptr(), scratch.data_ptr()
    args.counter = scratch.data_ptr() + 4 * grid * n_acc
    for k, (chain, _, row, _, _) in enumerate(prog.roles):
        packed = cuda.pack_chain(chain, env, device, out_start + n if row else n,
                                 query_ops=True)
        ctypes.memmove(ctypes.addressof(args.roles[k].ops), ctypes.addressof(packed.ops),
                       ctypes.sizeof(args.roles[k].ops))
    return args, scratch


def query_reduce(stage: Reduce, env: dict[str, torch.Tensor], *, n: int | None = None,
                 out_start: int = 0, out: torch.Tensor | None = None,
                 accumulate: bool = False) -> torch.Tensor:
    """The partial aggregate of items ``[out_start, out_start + n)`` (default all
    ``n_in``): the CUDA kernel on a CUDA device, the plain version on the CPU.
    On CUDA it launches or raises.

    A chunk passes its slices of the tiled leaves in ``env`` (read at local
    indices; resident "row" columns whole, read at global ones).  ``out``, when
    given, receives the ``n_out`` lanes, or has them added (``accumulate``: the
    executor's running sum over chunks, in chunk order)."""
    n = stage.n_in if n is None else int(n)
    if n < 1:
        raise ValueError(f"{stage.name}: a launch covers at least one item, not {n}")
    device = stage_device(stage.inputs, env)
    if out is not None:
        check_out(out, stage.n_out, torch.float32, stage.name)
    elif accumulate:
        raise ValueError(f"{stage.name}: accumulate needs an out")
    if device.type == "cpu":
        res = ref.query_reduce_torch(stage, env, n, out_start)
        if out is None:
            return res
        return out.add_(res) if accumulate else out.copy_(res)
    if device.type != "cuda":
        raise ValueError(f"no query kernel for device {device}")
    if out is None:
        out = torch.empty(stage.n_out, dtype=torch.float32, device=device)
    elif out.device != device:
        raise ValueError(f"{stage.name}: out is on {out.device}, the launch on {device}")
    # the scratch is freed on return: the caching allocator hands it out again
    # only to work queued after this launch on the same stream
    args, _scratch = _launch_args(stage, env, device, n, out_start, out, accumulate)
    KERNEL.launch(args, THREADS, device)
    return out
