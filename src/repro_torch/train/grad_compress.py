"""Gradient compression with error feedback: the reference's
``train/grad_compress.py``.

Gradients are int8-quantized per tensor (symmetric max-scale), summed across
the members of a process group in integer space, dequantized, and the
quantization residual is fed back into the next step.  The reference runs
``compressed_psum`` inside a ``shard_map`` over a named axis, with a scalar
``pmax`` to agree on the scale and an int32 ``psum`` of the payload; here the
axis is a ``torch.distributed`` process group, the ``pmax`` a MAX
all-reduce of the scale and the ``psum`` a SUM all-reduce of the int32
payload (functional collectives, so that ``roofline.op_cost`` counts them).
``group=None`` is the sum over this process alone (the case the reference's
test runs on a mesh of one), even when a default group exists: a group is
always named, as the reference always names its axis.

The payload crosses as int32, 4 bytes per element like the f32 sum it
replaces, while ``wire_bytes`` reports 1 (the int8 the format is named for):
the reference does both, and the port keeps both, since its sums equal the
reference's only with an int32 sum (ROADMAP §3, R6).
"""
from __future__ import annotations

import functools

import torch


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.amax(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """A functional all-reduce (``_c10d_functional``, which the op counter
    prices), waited for."""
    from torch.distributed import _functional_collectives as funcol

    return funcol.wait_tensor(funcol.all_reduce(t, op, group))


def compressed_psum(grad: torch.Tensor, err: torch.Tensor, group=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 sum over the members of ``group`` -> (the
    dequantized sum, this member's new error-feedback buffer).

    Two phases: (1) agree on a global scale with a scalar MAX all-reduce,
    (2) integer-sum the quantized payload.  The reconstruction sum(q_i) * s
    is then exact with respect to what was sent, and each member's
    quantization residual goes into its own buffer."""
    [s], [e] = _leaf_psum([grad], [err], group)
    return s, e


def _leaf_psum(grads, errs, group) -> tuple[list, list]:
    """``compressed_psum`` of the tensors that form one reference leaf,
    quantized with the leaf's one scale: the max of the tensors' own
    maxima, which is the stacked leaf's maximum bit for bit, so no tensor
    is copied into a stack."""
    gs = [g.float() + e for g, e in zip(grads, errs)]
    amax = functools.reduce(torch.maximum, [torch.amax(torch.abs(g)) for g in gs])
    if group is not None:
        amax = _all_reduce(amax, "max", group)
    scale = amax / 127.0 + 1e-12
    sums, new_errs = [], []
    for g in gs:
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        # the residual rounded once from the exact g - q * scale, as the
        # reference's fused multiply-add gives it: in f64 the product and the
        # difference are exact
        new_errs.append((g.double() - q.double() * scale.double()).float())
        qsum = q.to(torch.int32)
        if group is not None:
            qsum = _all_reduce(qsum, "sum", group)
        sums.append(qsum.float() * scale)
    return sums, new_errs


def compress_tree(grads, errs, group=None, leaves=None) -> tuple[list, list]:
    """``compressed_psum`` over aligned lists of gradients and buffers.
    ``leaves`` groups them as the reference's tree does: each entry the
    indices of the tensors that form one leaf (a layer weight stacked over
    the layers, ``weights.layout``), quantized with one scale as that leaf
    is; by default every tensor is a leaf of its own."""
    sums, new_errs = [None] * len(grads), [None] * len(grads)
    for idx in leaves if leaves is not None else [[i] for i in range(len(grads))]:
        s, e = _leaf_psum([grads[i] for i in idx], [errs[i] for i in idx], group)
        for i, si, ei in zip(idx, s, e):
            sums[i], new_errs[i] = si, ei
    return sums, new_errs


def init_error_feedback(params) -> list[torch.Tensor]:
    """Zero f32 buffers aligned with ``params`` (tensors, or a module's
    parameters)."""
    tensors = params.parameters() if hasattr(params, "parameters") else params
    return [torch.zeros_like(p, dtype=torch.float32) for p in tensors]


def wire_bytes(tensors, compressed: bool) -> int:
    """Cross-member bytes of one sync of these tensors, as the reference
    reports them: 1 per element compressed (the int32 payload is 4, R6)."""
    n = sum(t.numel() for t in tensors)
    return n * (1 if compressed else 4)
