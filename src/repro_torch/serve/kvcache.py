"""KV-cache compression for serving (ZipFlow applied to the serving data path):
the reference's ``serve/kvcache.py``.

Two mechanisms:
  * int8 per-head-scale quantization of K/V blocks (in-HBM footprint, 2x vs bf16);
  * bit-packed host<->device paging of cold cache blocks: the wire format is the
    ZipFlow bitpack codec, so the paging link moves 8 bits a value instead of 16.

``page_out`` quantizes on the block's device and packs on the host with the
reference's ``pack_np``; ``page_in`` moves the words to the device and unpacks
them there through the Fully-Parallel kernel (kernel 1), as a bitpack blob of
the block's words and meta (its plain version when the device is the CPU).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.algos.bitpack import pack_np, required_bits
from repro_torch.core.compiler import compile_blob, device_buffers
from repro_torch.core.plan import Encoded

PAGE_BASE = -127        # frame of reference of the int8 values on the wire


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (..., S, H, hd) -> (int8 values, f32 scales per (..., S, H))."""
    xf = x.float()
    scale = torch.amax(torch.abs(xf), dim=-1) / 127.0 + 1e-9
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


@dataclasses.dataclass
class PagedBlock:
    """A cache block paged out to host in ZipFlow wire format."""
    packed: np.ndarray
    bit_width: int
    base: int
    shape: tuple
    scale: np.ndarray | None = None

    def encoded(self) -> Encoded:
        """The words and meta as a bitpack blob of the block's int8 values."""
        return Encoded(codec="bitpack", meta={"bit_width": self.bit_width, "base": self.base},
                       buffers={"packed": self.packed}, children={},
                       n=int(np.prod(self.shape)), dtype=np.dtype(np.int8))


def page_out(block: torch.Tensor) -> PagedBlock:
    """Quantize + bitpack a KV block for host paging."""
    q, scale = quantize_kv(block)
    host = q.cpu().numpy().astype(np.int64).reshape(-1) - PAGE_BASE   # non-negative
    bw = required_bits(254)
    return PagedBlock(packed=pack_np(host, bw), bit_width=bw, base=PAGE_BASE,
                      shape=tuple(block.shape), scale=scale.cpu().numpy())


def page_in(pb: PagedBlock, dtype: torch.dtype = torch.bfloat16,
            device: torch.device | str = "cuda", backend: str = "kernel") -> torch.Tensor:
    """Move a paged block's words to ``device`` and unpack and dequantize them
    there: on kernel 1 (``backend="kernel"``) or its plain version
    (``"torch"``)."""
    enc = pb.encoded()
    q = compile_blob(enc, backend=backend)(device_buffers(enc, device))
    scale = torch.from_numpy(pb.scale).to(device)
    return dequantize_kv(q.reshape(pb.shape), scale, dtype)
