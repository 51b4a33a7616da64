"""String dictionary (paper §2.1/§5.3.1, Group-Parallel family).

Tokenize the column's byte stream on spaces and periods (the paper's O_COMMENT
recipe), build a word dictionary, and store one index per token.  Decoding
expands each token to its word's bytes: each token is a group whose count is the
word length, and out[i] = dict_chars[dict_offsets[index[g]] + pos]:

  word-lengths       FP   ``LOAD(index) -> SPAN(dict_offsets)``
  sd-presum          Aux  int32 prefix sum with a leading 0
  stringdict-expand  GP   ``STRGATHER`` map over (dict_chars, dict_offsets)

Exactness: every byte of the input is covered by the token grammar
``[^ .]*[ .] | [^ .]+$``, so decode is byte-identical.
"""
from __future__ import annotations

import re
from typing import Any

import numpy as np

from repro_torch.algos.rle import presum
from repro_torch.core.patterns import (STRGATHER, Aux, BufSpec, FullyParallel,
                                       GroupParallel, load, span)
from repro_torch.core.registry import register

_TOKEN_RE = re.compile(rb"[^ .]*[ .]|[^ .]+$")


class StringDictCodec:
    name = "stringdict"
    pattern = "gp"
    # per-token output byte offsets, host planning data (see RleCodec.host_meta)
    host_meta = ("group_presum",)

    def encode(self, arr: np.ndarray, **_: Any) -> tuple[dict[str, np.ndarray], dict]:
        raw = np.ascontiguousarray(np.asarray(arr)).view(np.uint8).reshape(-1)
        data = raw.tobytes()
        tokens = _TOKEN_RE.findall(data) if data else []
        vocab: dict[bytes, int] = {}
        index = np.empty(len(tokens), dtype=np.int32)
        for t, tok in enumerate(tokens):
            index[t] = vocab.setdefault(tok, len(vocab))
        words = list(vocab.keys())
        dict_chars = np.frombuffer(b"".join(words), dtype=np.uint8).copy()
        lengths = np.fromiter((len(w) for w in words), dtype=np.int32,
                              count=len(words))
        dict_offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
        group_presum = np.concatenate(
            [[0], np.cumsum(lengths[index], dtype=np.int64)]).astype(np.int64)
        return ({"index": index, "dict_chars": dict_chars,
                 "dict_offsets": dict_offsets},
                {"n_tokens": len(tokens), "n_words": len(words),
                 "n_bytes": raw.size, "itemsize": int(np.dtype(arr.dtype).itemsize),
                 "group_presum": group_presum})

    def decode_np(self, bufs: dict[str, np.ndarray], meta: dict, n: int,
                  dtype: Any) -> np.ndarray:
        index = np.asarray(bufs["index"]).astype(np.int64)
        chars = np.asarray(bufs["dict_chars"])
        offs = np.asarray(bufs["dict_offsets"]).astype(np.int64)
        counts = np.diff(offs)[index]
        g = np.repeat(np.arange(index.size), counts)
        starts = np.concatenate([[0], np.cumsum(counts)])
        pos = np.arange(g.size) - starts[g]
        raw = chars[offs[index[g]] + pos].astype(np.uint8)
        return raw[: meta["n_bytes"]].view(np.dtype(dtype))[:n].copy()

    def stages(self, enc, buf_names: dict[str, str], out_name: str,
               meta_names: dict[str, str] | None = None) -> list:
        n_tokens = int(enc.meta["n_tokens"])
        counts_name = f"{out_name}.counts"
        presum_name = f"{out_name}.presum"
        index, chars, offs = (buf_names[k] for k in ("index", "dict_chars",
                                                     "dict_offsets"))
        return [
            FullyParallel(chain=(load(index), span(offs)), inputs=(index, offs),
                          specs=(BufSpec("tile"), BufSpec("full")),
                          out=counts_name, n_out=n_tokens, out_dtype=np.int32,
                          elementwise=True, name="word-lengths"),
            Aux(fn=presum, inputs=(counts_name,), out=presum_name,
                n_out=n_tokens + 1, out_dtype=np.int32, name="sd-presum"),
            GroupParallel(
                presum=presum_name, value_inputs=(index,),
                value_specs=(BufSpec("tile"),), values=((load(index),),),
                map_kind=STRGATHER, out=out_name, n_out=int(enc.meta["n_bytes"]),
                out_dtype=np.uint8, n_groups=n_tokens, extra_inputs=(chars, offs),
                host_group_presum=enc.meta.get("group_presum"),
                name="stringdict-expand"),
        ]


register(StringDictCodec())
