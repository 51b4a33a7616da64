"""Op-cost counter: the port's counterpart of the reference's ``roofline/hlo_cost.py``.

The reference compiles a step with XLA and walks the compiled HLO text,
multiplying each ``while`` body by its trip count.  The port has no compiler
between the model and the card: a step is eager PyTorch, every aten op it
dispatches is a launch (or a view, which moves nothing), so there is no HLO
to walk.  ``analyze(fn, *args, **kwargs)`` runs ``fn`` once under a
``TorchDispatchMode`` and counts each op as it reaches the dispatcher --
below autograd, so the backward's ops and a remat policy's recompute are
counted as they run:

  flops        -- matrix products and convolutions (and the fused attention
                  ops, which the port does not call), by the formulas of
                  ``torch.utils.flop_counter``'s registry (2 * M * N * K for
                  ``mm``, per batch for ``bmm``); elementwise ops count
                  nothing, as the reference counts them;
  bytes        -- the inputs plus outputs of every op that is not a view (a
                  view is an op whose schema marks its result an alias and
                  writes nothing, or whose result shares an input's storage,
                  as ``_unsafe_view`` does): the eager program's HBM traffic,
                  each tensor at its logical size; an in-place op's target
                  counts as read and written;
  collectives  -- wire bytes per kind of the ``_c10d_functional`` all-reduce,
                  all-gather, reduce-scatter and all-to-all, at the
                  reference's ring factors (``ring_wire_bytes``);
  peak_bytes   -- the high-water mark of the storage the ops allocate, each
                  storage counted once from the op that makes it until it is
                  freed (what existed before the call -- weights, optimizer
                  state, inputs -- is not counted): on ``meta`` the step's
                  activation memory;
  n_ops, by_op -- the ops counted, and per op its count, FLOPs and bytes.

There is no trip-count walk: eager code runs every iteration of its Python
loops, so nothing is multiplied.  The count depends only on the ops, their
shapes and dtypes, so it is the same on ``meta`` (nothing allocated, nothing
computed) as on ``cuda``; ``chip_smoke.py`` checks that on the card.
"""
from __future__ import annotations

import time
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

COLLECTIVES = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
               "all_reduce_coalesced": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all"}


def ring_wire_bytes(kind: str, in_bytes: float, out_bytes: float, n: int) -> float:
    """Per-device wire bytes of one collective over a group of ``n`` (the
    reference's ring-cost factors, ``analysis.py``):
    all-gather out * (n-1)/n, reduce-scatter in * (n-1)/n,
    all-reduce 2 * in * (n-1)/n, all-to-all in * (n-1)/n."""
    ring = (max(n, 2) - 1) / max(n, 2)
    if kind == "all-reduce":
        return 2 * in_bytes * ring
    if kind == "all-gather":
        return out_bytes * ring
    return in_bytes * ring


def _dtensor_type():
    """``DTensor``, where ``torch.distributed`` is built in."""
    if not torch.distributed.is_available():
        return None
    from torch.distributed.tensor import DTensor
    return DTensor


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _writes(arg) -> bool:
    return arg.alias_info is not None and arg.alias_info.is_write


def _group_size(func, args) -> int:
    """The process group's size of a ``_c10d_functional`` collective: its
    ``group_size`` argument where it has one, else its group's."""
    names = [a.name for a in func._schema.arguments]
    if "group_size" in names:
        return int(args[names.index("group_size")])
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(args[names.index("group_name")]).size()


class OpCounter(TorchDispatchMode):
    """The counts of every aten op dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.n_ops = 0
        self.coll: dict[str, float] = {}
        self.by_op: dict[str, dict] = defaultdict(lambda: {"n": 0, "flops": 0, "bytes": 0})
        self.owned: dict[int, int] = {}     # storage -> its bytes, while alive
        self.live = 0
        self.peak = 0

    def _free(self, key: int) -> None:
        self.live -= self.owned.pop(key, 0)

    def _own(self, t: torch.Tensor, key: int) -> None:
        st = t.untyped_storage()
        self.owned[key] = st.nbytes()
        self.live += self.owned[key]
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dtensor = _dtensor_type()
        if dtensor is not None and any(isinstance(t, dtensor)
                                       for t in tree_flatten((args, kwargs))[0]):
            # one device's program: the global op is not counted; DTensor's own
            # dispatch (in C++, with this mode still active) runs the local ops
            # and the collectives of its redistributions, which reach this
            # counter as plain-tensor ops
            return NotImplemented
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out      # DTensor's shape propagation on fake tensors: no device op
        schema = func._schema
        ins = _tensors((args, kwargs))
        written = [t for a, v in zip(schema.arguments, args) if _writes(a)
                   for t in _tensors(v)]
        written += [t for a in schema.arguments if _writes(a) and a.name in kwargs
                    for t in _tensors(kwargs[a.name])]
        outs = _tensors(out)
        in_keys = {_storage_key(t) for t in ins}
        fresh = [(t, k) for t in outs for k in (_storage_key(t),) if k not in in_keys]
        # a functional collective's wait and autograd wrapper move nothing
        is_view = (not written and not fresh) or (
            func.namespace == "_c10d_functional"
            and func._overloadpacket.__name__ not in COLLECTIVES)
        for t, k in fresh:
            if k not in self.owned:
                self._own(t, k)
        name = str(func)
        rec = self.by_op[name]
        rec["n"] += 1
        self.n_ops += 1
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None:
            f = int(fn(*args, **kwargs, out_val=out))
            rec["flops"] += f
            self.flops += f
        if not is_view:
            seen = {id(t) for t in outs}
            out_b = sum(_nbytes(t) for t in outs) + sum(
                _nbytes(t) for t in written if id(t) not in seen)
            in_b = sum(_nbytes(t) for t in ins)
            rec["bytes"] += in_b + out_b
            self.bytes += in_b + out_b
            kind = (COLLECTIVES.get(func._overloadpacket.__name__)
                    if func.namespace == "_c10d_functional" else None)
            if kind is not None:
                wire = ring_wire_bytes(kind, in_b, out_b, _group_size(func, args))
                self.coll[kind] = self.coll.get(kind, 0.0) + wire
        return out


def analyze(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once under an ``OpCounter`` -> the
    reference's ``flops``, ``bytes``, ``collectives`` and ``coll_bytes``, plus
    ``peak_bytes``, ``n_ops``, ``by_op``, ``output_bytes`` (the storage of
    ``fn``'s result that the call allocated and still holds) and
    ``seconds`` (the call's wall time)."""
    counter = OpCounter()
    t0 = time.perf_counter()
    with counter:
        result = fn(*args, **kwargs)
    seconds = time.perf_counter() - t0
    keys = {_storage_key(t) for t in _tensors(result)}
    return {"flops": float(counter.flops), "bytes": float(counter.bytes),
            "collectives": dict(counter.coll),
            "coll_bytes": float(sum(counter.coll.values())),
            "peak_bytes": int(counter.peak), "n_ops": counter.n_ops,
            "by_op": {k: dict(v) for k, v in sorted(counter.by_op.items())},
            "output_bytes": int(sum(counter.owned.get(k, 0) for k in keys)),
            "seconds": seconds}
