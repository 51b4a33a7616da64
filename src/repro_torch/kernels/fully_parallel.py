"""Kernel 1: Fully-Parallel decode of a fused op chain (paper §4, Fig. 9).

Replaces the Pallas TPU kernel ``src/repro/kernels/fully_parallel.py:35
fully_parallel_call``.  One launch evaluates a stage's whole op chain (e.g.
``UNPACK -> GATHER`` for dictionary|bitpack) per element in registers, so a fused
chain reads its packed words once and writes the output once.  A block stages
the bit-packed words of its tile in shared memory, and each thread writes its
16 bytes of outputs in one store (``native_config("fp", out_width=...)``).
The CUDA source is ``csrc/fully_parallel.cu`` (built for ``sm_90a``); what
bounds it on the card and how it is laid out is noted there.  The plain version
is ``repro_torch.kernels.ref.fully_parallel_torch``.

``fully_parallel_batched`` decodes K columns of one structure in one launch of
the kernel's batched entry (one block row per member, ``blockIdx.y``), each
member with its own operands; a batch larger than ``KERNEL.batch_max`` takes several
launches.  Its plain version is ``ref.fully_parallel_batched_torch``.
"""
from __future__ import annotations

import torch

from repro_torch.core.geometry import Geometry, native_config
from repro_torch.core.patterns import BYTES, FullyParallel
from repro_torch.kernels import cuda, ref

KERNEL = cuda.KernelLib("fully_parallel", "zf_fully_parallel", cuda.ZfFpArgs)
MAX_STAGE_BYTES = 96 * 1024   # ZF_FP_MAX_SMEM in csrc/fully_parallel.cu


def stage_words(geom: Geometry) -> int:
    """Words of the shared buffer a block stages its bit-packed words in: a
    tile of ``L*S*C`` outputs at up to 32 bits starts at most 3 words after a
    16-byte boundary and reads one word past its last element's first, so
    ``tile + 4`` words, in whole 16-byte vectors, hold it at every bit width.
    Capped at ``MAX_STAGE_BYTES``; a wider window takes the kernel's
    per-element path."""
    return min((geom.tile + 4 + 3) // 4 * 4, MAX_STAGE_BYTES // 4)


def stage_device(names, env: dict[str, torch.Tensor]) -> torch.device:
    """The one device every named input lies on."""
    devices = {env[n].device for n in names}
    if len(devices) != 1:
        raise ValueError(f"stage inputs span devices {sorted(map(str, devices))}")
    return devices.pop()


def into(out: torch.Tensor | None, result: torch.Tensor, what: str) -> torch.Tensor:
    """``result``, or ``result`` written into ``out`` (a chunk's or a span's
    range of the column) when one is given; the dtype and length must agree."""
    if out is None:
        return result
    check_out(out, result.numel(), result.dtype, what)
    return out.copy_(result)


def check_out(out: torch.Tensor, n: int, dtype: torch.dtype, what: str) -> None:
    if out.dtype != dtype or out.numel() != n or not out.is_contiguous():
        raise ValueError(f"{what}: out must be a contiguous {dtype} of {n} elements, "
                         f"not {out.dtype}{tuple(out.shape)}")


def kernel_out(out: torch.Tensor | None, n: int, kdt: torch.dtype, final: torch.dtype,
               bitcast: bool, device: torch.device, what: str) -> torch.Tensor:
    """The tensor a kernel writes its ``n`` outputs of type ``kdt`` into: ``out``
    itself (or its bits, for a bitcast) where it holds them, else a new one
    that the caller converts into ``out``."""
    if out is None:
        return torch.empty(n, dtype=kdt, device=device)
    check_out(out, n, final, what)
    if out.device != device:
        raise ValueError(f"{what}: out is on {out.device}, the launch on {device}")
    if out.dtype == kdt:
        return out
    if bitcast and out.element_size() == kdt.itemsize:
        return out.view(kdt)
    return torch.empty(n, dtype=kdt, device=device)


def finish(out: torch.Tensor | None, written: torch.Tensor,
           converted) -> torch.Tensor:
    """The stage's result: ``converted(written)`` when no ``out`` was given,
    else ``out`` (converted into it unless the kernel wrote it in place)."""
    if out is None:
        return converted(written)
    if written.data_ptr() != out.data_ptr() or written.numel() != out.numel():
        out.copy_(converted(written))
    return out


def batch_device(envs, names) -> torch.device:
    """The one device every member's named inputs lie on."""
    devices = {stage_device(names, env) for env in envs}
    if len(devices) != 1:
        raise ValueError(f"batch members span devices {sorted(map(str, devices))}")
    return devices.pop()


def _launch_args(stage: FullyParallel, env, device, geom, n, out):
    """The launch's argument struct (None when there is nothing to decode),
    the tensor it writes, and its geometry."""
    final = ref.torch_dtype(stage.out_dtype)
    dst = kernel_out(out, n, ref.chain_dtype(stage.chain, env), final,
                     stage.chain[0].kind == BYTES, device, stage.name)
    geom = geom or native_config("fp", out_width=cuda.out_width(dst))
    args = None
    if n:
        args = cuda.ZfFpArgs(chain=cuda.pack_chain(stage.chain, env, device, n),
                             out=dst.data_ptr(), n=n, L=geom.L, C=geom.C,
                             out_width=cuda.out_width(dst),
                             stage_words=stage_words(geom))
    return args, dst, geom


def fully_parallel(stage: FullyParallel, env: dict[str, torch.Tensor],
                   geom: Geometry | None = None, *, n: int | None = None,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """Decode ``stage`` over tensors in ``env``: the CUDA kernel on a CUDA
    device, the plain version on the CPU.  On CUDA it launches or raises.

    A chunk passes its length ``n`` and its slices of the tiled leaves in
    ``env``, and ``out``, its range of the column's output, which is written in
    place."""
    n = stage.n_out if n is None else int(n)
    device = stage_device(stage.inputs, env)
    if device.type == "cpu":
        return into(out, ref.fully_parallel_torch(stage, env, n), stage.name)
    if device.type != "cuda":
        raise ValueError(f"no Fully-Parallel kernel for device {device}")
    args, dst, geom = _launch_args(stage, env, device, geom, n, out)
    if args is not None:
        KERNEL.launch(args, geom.S, device)
    return finish(out, dst, lambda t: ref.to_out(t, stage.chain, stage.out_dtype))


def fully_parallel_batched(stage: FullyParallel, envs: list[dict[str, torch.Tensor]],
                           geom: Geometry | None = None, *,
                           outs: list[torch.Tensor | None] | None = None
                           ) -> list[torch.Tensor]:
    """Decode ``stage`` whole for each member's operands in ``envs`` (columns of
    one structure): the kernel's batched entry on a CUDA device, one launch per
    ``KERNEL.batch_max`` members; the plain version for each member on the CPU.  On
    CUDA it launches or raises.  ``outs[k]``, when given, is member k's
    output, written in place."""
    outs = [None] * len(envs) if outs is None else list(outs)
    device = batch_device(envs, stage.inputs)
    if device.type == "cpu":
        return [into(o, r, stage.name)
                for o, r in zip(outs, ref.fully_parallel_batched_torch(stage, envs))]
    if device.type != "cuda":
        raise ValueError(f"no Fully-Parallel kernel for device {device}")
    packs = [_launch_args(stage, env, device, geom, stage.n_out, o)
             for env, o in zip(envs, outs)]
    members = [args for args, _, _ in packs if args is not None]
    if members:
        KERNEL.launch_batched(members, packs[0][2].S, device)
    return [finish(o, dst, lambda t: ref.to_out(t, stage.chain, stage.out_dtype))
            for o, (_, dst, _) in zip(outs, packs)]
