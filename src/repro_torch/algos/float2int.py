"""Float2Int (paper §2.1, Fully-Parallel family; the ALP/G-ALP idea).

Encode: find the smallest decimal scale 10^d such that round(x * 10^d) reconstructs x
exactly; store the integers (bit-packable child slot) plus a sparse exception list for
values that do not round-trip.  Decode: ``I2F_DIV`` (int -> float32, then a
correctly rounded divide by the scale; F.P.), then scatter-patch exceptions (Aux).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.patterns import Aux, BufSpec, FullyParallel, i2f_div, load
from repro_torch.core.registry import register

_MAX_DECIMALS = 9


def patch(x: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Exceptions overwrite the scaled values (``x.at[idx].set(val)``)."""
    out = x.clone()
    out[idx.long()] = val
    return out


class Float2IntCodec:
    name = "float2int"
    pattern = "fp"

    def encode(self, arr: np.ndarray, decimals: int | None = None,
               **_: Any) -> tuple[dict[str, np.ndarray], dict]:
        flat = np.asarray(arr).reshape(-1).astype(np.float64)
        flat32 = flat.astype(np.float32)

        def attempt(d: int):
            scaled = np.round(flat * 10.0**d)
            ok = np.abs(scaled) < 2**31 - 1
            # exactness is verified with the decoder's arithmetic: a float32
            # division by the exactly-representable 10^d, correctly rounded
            recon = scaled.astype(np.float32) / np.float32(10.0 ** d)
            return scaled, ok & (recon == flat32)

        best_d, best_exc = None, None
        cand = range(_MAX_DECIMALS + 1) if decimals is None else [decimals]
        for d in cand:
            _, exact = attempt(d)
            n_exc = int((~exact).sum())
            if best_exc is None or n_exc < best_exc:
                best_d, best_exc = d, n_exc
            if n_exc == 0:
                break
        d = best_d
        scaled, exact = attempt(d)
        exc_idx = np.flatnonzero(~exact).astype(np.int32)
        ints = np.where(exact, scaled, 0).astype(np.int64)
        # the scale ships as a (1,) runtime buffer so the divide is a real,
        # correctly rounded division on every backend
        return ({"ints": ints,
                 "exc_idx": exc_idx,
                 "exc_val": flat[exc_idx].astype(np.float32),
                 "scale": np.asarray([10.0 ** d], np.float32)},
                {"decimals": int(d), "n_exc": int(exc_idx.size)})

    def decode_np(self, bufs: dict[str, np.ndarray], meta: dict, n: int,
                  dtype: Any) -> np.ndarray:
        out = (np.asarray(bufs["ints"]).astype(np.float32)
               / np.float32(10.0 ** meta["decimals"]))
        out[np.asarray(bufs["exc_idx"]).astype(np.int64)] = np.asarray(bufs["exc_val"])
        return out.astype(dtype)

    def stages(self, enc, buf_names: dict[str, str], out_name: str,
               meta_names: dict[str, str] | None = None) -> list:
        n_exc = int(enc.meta["n_exc"])
        mid = f"{out_name}.scaled" if n_exc else out_name
        ints, scale = buf_names["ints"], buf_names["scale"]
        stages: list = [FullyParallel(
            chain=(load(ints), i2f_div(scale)),
            inputs=(ints, scale),
            specs=(BufSpec("tile"), BufSpec("full")),
            out=mid, n_out=enc.n, out_dtype=np.float32,
            elementwise=True, name="f2i-scale")]
        if n_exc:
            stages.append(Aux(
                fn=patch, inputs=(mid, buf_names["exc_idx"], buf_names["exc_val"]),
                out=out_name, n_out=enc.n, out_dtype=np.float32, name="f2i-patch"))
        return stages


register(Float2IntCodec())
