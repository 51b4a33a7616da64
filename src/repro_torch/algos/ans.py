"""rANS entropy coding (paper §2.1/§3.1, the Non-Parallel exemplar).

The stream is cut into chunks of ``chunk_size`` bytes that decode independently;
on the card one thread owns a chunk (paper Fig. 11).  Compressed words are stored
*chunk-transposed* ("striped"): word t of every chunk is one row, so threads that
read their t-th words read neighbouring words.

Construction (rans_word, 32-bit state, 16-bit renorm, 12-bit probability scale):
  L = 2^16, M = 2^12.  Encode (symbols in reverse order so decode is forward):
     if x >= freq[s] << 20: emit low 16 bits, x >>= 16        (at most once)
     x  = (x // freq[s]) << 12 | (x % freq[s]) + cum[s]
  Decode:
     slot = x & 4095; s = sym[slot]
     x = freq[s] * (x >> 12) + slot - cum[s]
     if x < L: x = x << 16 | next_word                          (at most 1 word)

Decode lowers to ``ans-decode`` (Non-Parallel, uint8 symbols) and, for items
wider than a byte, ``byte-reassemble`` (Fully-Parallel over the ``BYTES`` op).
The numpy encoder and oracle are the reference package's, copied.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.algos.bitpack import out_dtype
from repro_torch.core.patterns import BufSpec, FullyParallel, NonParallel, load_bytes
from repro_torch.core.registry import register
from repro_torch.kernels.ref import ANS_L as L, ANS_SCALE_BITS as SCALE_BITS

M = 1 << SCALE_BITS  # probability denominator


def normalize_freqs(counts: np.ndarray) -> np.ndarray:
    """Scale 256-bin counts to sum to M with every present symbol >= 1."""
    counts = counts.astype(np.float64)
    total = counts.sum()
    if total == 0:
        freqs = np.zeros(256, np.int64)
        freqs[0] = M
        return freqs
    freqs = np.floor(counts / total * M).astype(np.int64)
    freqs[(counts > 0) & (freqs == 0)] = 1
    # repair the sum by adjusting the largest bin (always large enough)
    diff = M - freqs.sum()
    freqs[np.argmax(freqs)] += diff
    if freqs.max() <= 0:  # degenerate guard
        freqs[:] = 0
        freqs[np.argmax(counts)] = M
    assert freqs.sum() == M and freqs.min() >= 0
    return freqs


def encode_chunks_np(syms: np.ndarray, freq: np.ndarray, cum: np.ndarray,
                     return_wcount: bool = False):
    """Vectorized (across chunks) rANS encode.

    syms: (n_chunks, chunk_size) uint8.  Returns (streams, states):
    streams (max_words, n_chunks) uint16 in *decoder consumption order*, states
    (n_chunks,) uint32 final encoder states (= decoder initial states).  With
    ``return_wcount`` also returns the actual per-chunk word counts (the stripe
    pads every chunk to the maximum; wcount is the pre-padding truth).
    """
    n_chunks, cs = syms.shape
    x = np.full(n_chunks, L, dtype=np.uint64)
    emitted = np.zeros((cs + 1, n_chunks), dtype=np.uint16)  # emission order
    wcount = np.zeros(n_chunks, dtype=np.int64)
    freq64 = freq.astype(np.uint64)
    cum64 = cum.astype(np.uint64)
    lanes = np.arange(n_chunks)
    for t in range(cs - 1, -1, -1):
        s = syms[:, t]
        f = freq64[s]
        need = x >= (f << np.uint64(20))
        idx = lanes[need]
        emitted[wcount[idx], idx] = (x[idx] & np.uint64(0xFFFF)).astype(np.uint16)
        wcount[idx] += 1
        x[idx] >>= np.uint64(16)
        x = ((x // f) << np.uint64(SCALE_BITS)) | (x % f)
        x += cum64[s]
    max_words = int(wcount.max()) if n_chunks else 0
    max_words = max(max_words, 1)
    # decoder consumes in reverse emission order -> flip each chunk's prefix
    take = wcount[None, :] - 1 - np.arange(max_words)[:, None]
    streams = np.where(take >= 0,
                       emitted[np.clip(take, 0, cs), lanes[None, :]],
                       np.uint16(0)).astype(np.uint16)
    if return_wcount:
        return streams, x.astype(np.uint32), wcount
    return streams, x.astype(np.uint32)


def decode_chunks_np(streams: np.ndarray, states: np.ndarray, sym: np.ndarray,
                     freq: np.ndarray, cum: np.ndarray, cs: int) -> np.ndarray:
    """Numpy oracle mirroring the lockstep decode."""
    n_chunks = states.shape[0]
    x = states.astype(np.uint64)
    cur = np.zeros(n_chunks, dtype=np.int64)
    lanes = np.arange(n_chunks)
    out = np.empty((n_chunks, cs), dtype=np.uint8)
    cap = streams.shape[0] - 1
    for t in range(cs):
        slot = (x & np.uint64(M - 1)).astype(np.int64)
        s = sym[slot]
        out[:, t] = s
        x = freq[s].astype(np.uint64) * (x >> np.uint64(SCALE_BITS)) \
            + slot.astype(np.uint64) - cum[s].astype(np.uint64)
        need = x < L
        w = streams[np.clip(cur, 0, cap), lanes].astype(np.uint64)
        x = np.where(need, (x << np.uint64(16)) | w, x)
        cur += need
    return out


class AnsCodec:
    name = "ans"
    pattern = "np"
    # host-side planning metadata: actual per-chunk compressed word counts.
    # Identified by dtype/shape only, never by value, and never transferred.
    host_meta = ("group_words",)

    def encode(self, arr: np.ndarray, chunk_size: int = 4096,
               **_: Any) -> tuple[dict[str, np.ndarray], dict]:
        raw = np.ascontiguousarray(np.asarray(arr)).view(np.uint8).reshape(-1)
        n_bytes = raw.size
        cs = int(chunk_size)
        n_chunks = max(1, -(-n_bytes // cs))
        padded = np.zeros(n_chunks * cs, dtype=np.uint8)
        padded[:n_bytes] = raw
        counts = np.bincount(padded, minlength=256)
        freq = normalize_freqs(counts)
        cum = np.concatenate([[0], np.cumsum(freq)[:-1]])
        sym_tab = np.repeat(np.arange(256, dtype=np.uint8), freq)
        streams, states, wcount = encode_chunks_np(
            padded.reshape(n_chunks, cs), freq, cum, return_wcount=True)
        return ({"streams": streams, "states": states,
                 "sym_tab": sym_tab.astype(np.uint8),
                 "freq_tab": freq.astype(np.uint16),
                 "cum_tab": cum.astype(np.uint16)},
                {"chunk_size": cs, "n_chunks": n_chunks, "n_bytes": n_bytes,
                 "itemsize": int(np.dtype(arr.dtype).itemsize),
                 "group_words": wcount.astype(np.int64)})

    def decode_np(self, bufs: dict[str, np.ndarray], meta: dict, n: int,
                  dtype: Any) -> np.ndarray:
        syms = decode_chunks_np(
            np.asarray(bufs["streams"]), np.asarray(bufs["states"]),
            np.asarray(bufs["sym_tab"]).astype(np.int64),
            np.asarray(bufs["freq_tab"]).astype(np.int64),
            np.asarray(bufs["cum_tab"]).astype(np.int64), meta["chunk_size"])
        raw = syms.reshape(-1)[: meta["n_bytes"]]
        return raw.view(np.dtype(dtype))[:n].copy()

    def stages(self, enc, buf_names: dict[str, str], out_name: str,
               meta_names: dict[str, str] | None = None) -> list:
        meta = enc.meta
        itemsize = int(meta["itemsize"])
        bytes_name = f"{out_name}.bytes" if itemsize > 1 else out_name
        stages: list = [NonParallel(
            streams=buf_names["streams"], states=buf_names["states"],
            sym_tab=buf_names["sym_tab"], freq_tab=buf_names["freq_tab"],
            cum_tab=buf_names["cum_tab"], chunk_size=int(meta["chunk_size"]),
            n_chunks=int(meta["n_chunks"]), out=bytes_name,
            n_out=int(meta["n_bytes"]), out_dtype=np.uint8,
            host_group_words=meta.get("group_words"), name="ans-decode")]
        if itemsize > 1:
            # the item's bytes, little-endian; float32 is a bitcast, and items
            # wider than 4 bytes keep their low word as int32 (as the reference)
            stages.append(FullyParallel(
                chain=(load_bytes(bytes_name, itemsize),), inputs=(bytes_name,),
                specs=(BufSpec("tile", num=itemsize, den=1),),
                out=out_name, n_out=enc.n, out_dtype=out_dtype(enc),
                elementwise=False, name="byte-reassemble"))
        return stages


register(AnsCodec())
