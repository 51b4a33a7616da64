"""Dictionary encoding (paper §2.1/Fig. 6(a), Fully-Parallel family).

Encode: unique values -> dictionary; data -> indices.  Decode is a parallel table
lookup (``LOAD(index) -> GATHER(dictionary)``).  The index buffer is the natural
child-plan slot (dictionary|bit-packing, paper Table 2's date columns).
"""
from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.algos.bitpack import out_dtype
from repro_torch.core.patterns import BufSpec, FullyParallel, gather, load
from repro_torch.core.registry import register


class DictionaryCodec:
    name = "dictionary"
    pattern = "fp"

    def encode(self, arr: np.ndarray, **_: Any) -> tuple[dict[str, np.ndarray], dict]:
        flat = np.asarray(arr).reshape(-1)
        dictionary, index = np.unique(flat, return_inverse=True)
        return ({"index": index.astype(np.int32), "dictionary": dictionary},
                {"n_dict": int(dictionary.size)})

    def decode_np(self, bufs: dict[str, np.ndarray], meta: dict, n: int,
                  dtype: Any) -> np.ndarray:
        return np.asarray(bufs["dictionary"])[
            np.asarray(bufs["index"]).astype(np.int64)].astype(dtype)

    def stages(self, enc, buf_names: dict[str, str], out_name: str,
               meta_names: dict[str, str] | None = None) -> list:
        index, dictionary = buf_names["index"], buf_names["dictionary"]
        return [FullyParallel(
            chain=(load(index), gather(dictionary)),
            inputs=(index, dictionary),
            specs=(BufSpec("tile"), BufSpec("full")),
            out=out_name, n_out=enc.n, out_dtype=out_dtype(enc),
            elementwise=True, name="dict-lookup")]


def code_bounds(dictionary: np.ndarray, lo, hi) -> tuple[int | None, int | None]:
    """Map a value range ``[lo, hi)`` to a dictionary-code range ``[clo, chi)``.

    ``np.unique`` emits the dictionary sorted, so order-preserving predicates
    translate exactly: ``value >= lo``  <=>  ``code >= searchsorted(d, lo)``
    and ``value < hi``  <=>  ``code < searchsorted(d, hi)`` (both 'left').
    A range predicate on a dictionary column then runs on the (bit-packed)
    codes without the dictionary gather.  ``None`` bounds stay open."""
    d = np.asarray(dictionary)
    clo = None if lo is None else int(np.searchsorted(d, lo, side="left"))
    chi = None if hi is None else int(np.searchsorted(d, hi, side="left"))
    return clo, chi


register(DictionaryCodec())
