"""Gradient compression with error feedback: the reference's
``train/grad_compress.py``.

Gradients are int8-quantized per tensor (symmetric max-scale), summed across
the members of a group in integer space, dequantized, and the quantization
residual is fed back into the next step.  The reference runs
``compressed_psum`` inside a ``shard_map`` over a named axis, with a scalar
``pmax`` to agree on the scale and an int32 ``psum`` of the payload.  This is
the sum over this process alone, where ``pmax`` and ``psum`` are the
identity: the case the reference's own test runs on a mesh of one.  The sum
over several members comes with the mesh (ROADMAP §1 item 3).
"""
from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.amax(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(grad: torch.Tensor, err: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 sum over this process -> (the dequantized sum, the
    new error-feedback buffer).  Wire bytes: 1 per element and one scalar,
    against 4 for an f32 sum."""
    g = grad.float() + err
    scale = torch.amax(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    new_err = g - q.float() * scale
    qsum = q.to(torch.int32)
    return qsum.float() * scale, new_err


def compress_tree(grads, errs) -> tuple[list, list]:
    """``compressed_psum`` over aligned lists of gradients and buffers."""
    outs = [compressed_psum(g, e) for g, e in zip(grads, errs)]
    return [o[0] for o in outs], [o[1] for o in outs]


def init_error_feedback(params) -> list[torch.Tensor]:
    """Zero f32 buffers aligned with ``params`` (tensors, or a module's
    parameters)."""
    tensors = params.parameters() if hasattr(params, "parameters") else params
    return [torch.zeros_like(p, dtype=torch.float32) for p in tensors]


def wire_bytes(tensors, compressed: bool) -> int:
    """Cross-member bytes of one sync of these tensors."""
    n = sum(t.numel() for t in tensors)
    return n * (1 if compressed else 4)
