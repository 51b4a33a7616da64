"""Host-side pieces of kernels 1, 2 and 3, on the CPU.

  * kernel 1's native geometry gives every thread 16 bytes of output in a tile
    of a multiple of 128 outputs at every output width, and its staging buffer
    (``fully_parallel.stage_words``) holds the packed words any tile reads, at
    every bit width 0-32, wherever the tile starts;
  * kernel 3's packed decode table (``non_parallel.decode_table``) unpacks to
    the encoder's ``sym``, ``freq`` and ``cum`` for every alphabet of the
    ``chip_smoke.py`` sweep, the one-symbol ``freq = 4096`` case included, and
    flags tables outside its layout;
  * kernel 2's per-tile windows (``group_parallel.tile_windows``) agree with a
    search per output, and the native geometry gives every thread 16 bytes;
  * the plain Group-Parallel version equals ``numpy.repeat`` on zero-count
    groups (the reference assumes counts >= 1, so this is not held against it).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.compiler import build_graph, device_buffers
from repro_torch.core.geometry import Geometry, native_config
from repro_torch.core.patterns import BufSpec, GroupParallel, load
from repro_torch.core.plan import Plan, encode
from repro_torch.kernels import ref
from repro_torch.kernels.fully_parallel import MAX_STAGE_BYTES, stage_words
from repro_torch.kernels.group_parallel import tile_windows
from repro_torch.kernels.non_parallel import decode_table

FP_GEOMS = (native_config("fp", out_width=1), native_config("fp", out_width=2),
            native_config("fp"), Geometry(3, 96, 5), Geometry(1, 32, 1))
NP_KINDS = ("uint8", "int32", "float32", "skewed", "one-symbol", "uniform256")


def ans_input(kind: str, n: int, rng) -> np.ndarray:
    """The alphabets of ``chip_smoke.py``'s rANS sweep."""
    if kind == "skewed":
        return np.where(rng.random(n) < 0.995, 78, rng.integers(0, 256, n)) \
            .astype(np.uint8)
    if kind == "one-symbol":
        return np.full(n, 82, np.uint8)
    if kind == "float32":
        return rng.normal(0, 1e3, n).astype(np.float32)
    if kind == "int32":
        return rng.integers(-2**31, 2**31, n).astype(np.int32)
    if kind == "uniform256":
        return rng.integers(0, 256, n).astype(np.uint8)
    return rng.integers(0, 5, n).astype(np.uint8)


def ans_tables(arr: np.ndarray):
    enc = encode(Plan("ans", params={"chunk_size": 1000}), arr)
    env = device_buffers(enc, "cpu")
    st = next(s for s in build_graph(enc).stages if hasattr(s, "sym_tab"))
    return env[st.sym_tab], env[st.freq_tab], env[st.cum_tab]


@pytest.mark.parametrize("kind", NP_KINDS)
def test_decode_table_unpacks_to_the_alphabet(kind, rng):
    sym, freq, cum = ans_tables(ans_input(kind, 20_000, rng))
    tab, fits = decode_table(sym, freq, cum)
    assert fits
    assert tab.shape == (4096,) and int(tab.min()) >= 0 and int(tab.max()) < 2**32
    s = tab & 0xFF
    f = ((tab >> 8) & 0xFFF) + 1
    c = torch.arange(4096) - (tab >> 20)
    assert torch.equal(s, sym.to(torch.int64))
    assert torch.equal(f, freq.to(torch.int64)[s])
    assert torch.equal(c, cum.to(torch.int64)[s])
    if kind == "one-symbol":
        assert int(f.min()) == 4096        # 13 bits as freq, 12 as freq - 1


def test_decode_table_flags_tables_outside_the_layout(rng):
    sym, freq, cum = ans_tables(ans_input("uint8", 20_000, rng))
    bad_cum = cum.to(torch.int32)
    bad_cum[int(torch.argmax((freq.to(torch.int32) > 3).to(torch.int32)))] += 3
    assert not decode_table(sym, freq, bad_cum.to(torch.uint16))[1]
    bad_freq = freq.to(torch.int32)
    bad_freq[int(sym[0])] = 0
    assert not decode_table(sym, bad_freq.to(torch.uint16), cum)[1]


@pytest.mark.parametrize("tile", [1, 7, 1024, 4096])
def test_tile_windows_match_a_search_per_output(tile, rng):
    counts = rng.integers(0, 6, 12_000)
    counts[2000:7000] = 0
    counts[:3] = 0
    presum = np.concatenate([[0], np.cumsum(counts)])
    n = int(presum[-1])
    g = np.clip(np.searchsorted(presum, np.arange(n), side="right") - 1, 0, counts.size - 1)
    want = [g[min(o + tile, n) - 1] - g[o] + 1 for o in range(0, n, tile)]
    got = tile_windows(torch.from_numpy(presum.astype(np.int32)), n, tile)
    assert got.tolist() == want
    if tile >= 1024:
        assert max(want) > tile          # the run of zero counts overflows a window


def test_windows_of_counts_of_at_least_one_fit_a_tile(rng):
    counts = rng.integers(1, 4, 20_000)
    presum = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))
    geom = native_config("gp")
    tile = geom.S * geom.C
    assert int(tile_windows(presum, int(presum[-1]), tile).max()) <= tile
    ones = torch.arange(20_001, dtype=torch.int32)
    assert int(tile_windows(ones, 20_000, tile).max()) == tile


@pytest.mark.parametrize("width", [1, 2, 4])
def test_native_gp_geometry_stores_16_bytes_per_thread(width):
    geom = native_config("gp", out_width=width)
    assert geom.C * width == 16 and geom.S % 32 == 0
    assert native_config("gp") == native_config("gp", out_width=4)


@pytest.mark.parametrize("layout", ["scattered", "leading", "trailing", "all-but-one"])
def test_plain_gp_on_zero_counts_equals_numpy_repeat(layout, rng):
    counts = rng.integers(0, 5, 3000)
    if layout == "leading":
        counts[:500] = 0
    elif layout == "trailing":
        counts[-500:] = 0
    elif layout == "all-but-one":
        counts[:] = 0
        counts[1234] = 77
    vals = rng.integers(-2**31, 2**31, counts.size).astype(np.int32)
    presum = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    env = {"presum": torch.from_numpy(presum), "vals": torch.from_numpy(vals)}
    st = GroupParallel(presum="presum", value_inputs=("vals",),
                       value_specs=(BufSpec("tile"),), values=((load("vals"),),),
                       out="out", n_out=int(presum[-1]), n_groups=counts.size,
                       name="zero-counts")
    got = ref.group_parallel_torch(st, env)
    assert torch.equal(got, torch.from_numpy(np.repeat(vals, counts)))


@pytest.mark.parametrize("width", [1, 2, 4])
def test_native_fp_geometry_stores_16_bytes_per_thread(width):
    geom = native_config("fp", out_width=width)
    assert geom.C * width == 16 and geom.S % 32 == 0
    assert geom.tile % 128 == 0
    assert native_config("fp") == native_config("fp", out_width=4) == Geometry(4, 256, 4)
    # the buffer a native block stages at 32 bits: 16 KB and a vector
    assert stage_words(geom) * 4 == 16 * 1024 + 16


@pytest.mark.parametrize("bw", range(33))
def test_stage_words_hold_every_tile_window(bw):
    """Count, with numpy, the words each element's bits touch, from the word of
    the tile's first bit aligned down to 16 bytes (a buffer may start at any
    word, so 0-3 words before it), through the last element's second word;
    in whole 16-byte vectors that is what the kernel stages, and it must fit.
    Tiles start at block boundaries and, as a chunk of a column may, off them."""
    for geom in FP_GEOMS:
        cap = stage_words(geom)
        assert cap % 4 == 0 and 0 < cap * 4 <= MAX_STAGE_BYTES
        for e0 in (0, geom.tile, 777 * geom.tile, 5, 12_345_679):
            i = np.arange(e0, e0 + geom.tile, dtype=np.int64)
            first = (i * bw) >> 5                  # the word holding an element's first bit
            last_bit = i * bw + max(bw, 1) - 1
            assert np.all((last_bit >> 5) <= first + 1)   # its bits lie in two words
            for shift in range(4):
                slots = int((first + 1).max()) - (int(first[0]) - shift) + 1
                assert (slots + 3) // 4 * 4 <= cap, (geom, e0, shift)


def test_stage_words_cap_wide_tiles():
    """A tile whose words at 32 bits exceed the cap stages up to the cap (the
    kernel takes its per-element path for wider windows)."""
    geom = Geometry(32, 256, 4)
    assert stage_words(geom) * 4 == MAX_STAGE_BYTES
    assert geom.tile * 4 > MAX_STAGE_BYTES
