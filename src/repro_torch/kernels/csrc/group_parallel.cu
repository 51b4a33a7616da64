// Kernel 2: Group-Parallel (balanced 1->N) expansion.
//
// Replaces src/repro/kernels/group_parallel.py:51 group_parallel_call (Pallas, TPU).
// Output-centric: every block produces L sub-tiles of S*C consecutive outputs,
// so the work per block is the same whatever the group sizes (the paper's load
// balance, §4).  For output i:
//   g   = upper_bound(presum, i) - 1      (clamped to [0, n_groups))
//   pos = i - presum[g]
//   v   = values[0](g)                    IDENTITY (RLE)
//       | values[0](g) + values[1](g)*pos AFFINE (DeltaStride), mod 2^32
//       | chars[offs[values[0](g)] + pos] STRGATHER (StringDict)
//   out[i] = tail(v), stored in 1, 2 or 4 bytes
// Each value chain may hold an absorbed Fully-Parallel producer (fusion rule 2),
// e.g. bit-packed RLE values decoded right here, never materialized.
//
// A block, as the reference's tiles do (group_parallel.py:73-104), works on a
// window of groups in fast memory instead of the whole presum:
//  1. one warp finds the group of the block's first output, a 32-way search of
//     the presum in global memory (about 5 rounds of one coalesced read for
//     13.5M groups); no pre-pass launch and no host search.  Each later
//     sub-tile starts from the previous one's last group, so one search serves
//     L sub-tiles;
//  2. per sub-tile, the block stages the presum from that group on, a row of
//     S entries at a time, until an entry passes the sub-tile's last output
//     (__syncthreads_count finds its last group), then evaluates the value
//     chains once per group into shared memory (an absorbed bit-unpack, the
//     AFFINE start and stride; for STRGATHER the word's offset
//     offs[values[0](g)]);
//  3. each thread owns C consecutive outputs: one binary search in the window
//     (about 10-12 levels), then a walk forward across group boundaries;
//  4. a thread's outputs leave in one 16-byte store (16, 8 or 4 outputs at 1,
//     2 or 4 bytes), so a warp writes 512 contiguous bytes.  Without a tail the
//     16 outputs are unrolled, so their loads (StringDict's 16 byte loads)
//     are all in flight before the first is packed; a head before a 16-byte
//     boundary, the tail at n and other C are stored element by element.
// Counts of at least 1 (RLE and DeltaStride runs, StringDict tokens) bound a
// sub-tile's window to S*C + 1 groups (S*C + 2 presum entries), the buffer's
// size.  Zero counts (a hand-built stage; the plain version takes them) can
// widen it: such a sub-tile searches for its last group and walks the presum
// range in global memory, evaluating each group's values where it needs them.
// The presum must be non-decreasing (counts >= 0), as searchsorted requires.
//
// Spans (group-boundary streamed decode).  A launch writes the n_valid outputs
// [out_start, out_start + n_valid) of the column, out[0] being output
// out_start.  The presum is the whole column's, searched at global output
// indices, so g and pos are the whole-column values; the value chains read a
// span's own slices of their leaves, so they are evaluated at g - g_start.
// Blocks tile the global index space from the output whose address is 16-byte
// aligned at or before out[0], so every thread's C outputs keep the alignment
// of the whole-column launch; the threads at the span's two ends store only
// their part (zf_store_packed's head and tail).  A whole column is the span
// out_start = g_start = 0, n_valid = n.
//
// Bound on this card: bytes (1-4 bytes written per output; the presum, value
// and, for StringDict, word bytes read), with a few instructions per output.
// What holds it back: the first search (dependent global rounds), the
// per-group value chains (dependent gathers), and for StringDict one byte load
// per output, scattered over the dictionary's words.
//
// Batched entry (zf_group_parallel_batched): K columns of one structure decode
// in one launch; blockIdx.y picks member m[k] of a ZfGpBatch passed by value
// (__grid_constant__), which keeps its own presum, value leaves, group count,
// span offsets and output, and org[k], its first output's 16-byte origin.  The
// members share the map, output width and geometry; the grid is as wide as the
// widest member, whose surplus blocks return at once.  A ZfGpArgs is 1,128 B,
// so the 4 KB kernel parameter space takes ZF_GP_MAX_BATCH = 3 members a
// launch; the wrapper splits a larger batch into several launches.
#include "zf_chain.cuh"

struct ZfGpArgs {
  const int32_t* presum;  // (n_groups + 1,), presum[0] = 0
  int64_t n_groups;
  ZfChain values[2];
  ZfChain tail;
  ZfOp chars;             // STRGATHER: word bytes (a, n, elem; kind unused)
  ZfOp offs;              // STRGATHER: word offsets
  int32_t map_kind;       // ZF_IDENTITY, ZF_AFFINE or ZF_STRGATHER
  int32_t out_width;      // bytes per output element: 1, 2 or 4
  void* out;              // output out_start (a span's first)
  int64_t n;              // n_valid: outputs written
  int32_t L;
  int32_t C;
  int64_t out_start;      // global index of out[0] (appended: older kernels load as a prefix)
  int64_t g_start;        // first group of the value leaves' slices
};

static_assert(sizeof(ZfGpArgs) == 1128, "ZfGpArgs layout is shared with kernels/cuda.py");

#define ZF_GP_MAX_BATCH 3    // members of one batched launch: 3 x 1,128 B of 4 KB

struct ZfGpBatch {
  ZfGpArgs m[ZF_GP_MAX_BATCH];
  int64_t org[ZF_GP_MAX_BATCH];
};

static_assert(sizeof(ZfGpBatch) + sizeof(int64_t) <= 4096,
              "a batch must fit the 4 KB kernel parameter space");

#define ZF_GP_MAX_SMEM (96 * 1024)   // shared bytes a block's window may take

// The group of output q, clamp(upper_bound(presum, q) - 1, 0, n_groups - 1),
// found by one warp: 32 probes per round over the range [lo, hi) that holds
// upper_bound (about 5 rounds for 13.5M groups).  Every lane returns it.
__device__ __forceinline__ int64_t zf_find_group(const int32_t* presum, int64_t n_groups,
                                                 int64_t q) {
  const int lane = threadIdx.x & 31;
  int64_t lo = 0, hi = n_groups + 1;
  while (lo < hi) {   // warp-uniform
    const int64_t len = hi - lo;
    const int64_t p = lo + (static_cast<int64_t>(lane + 1) * len) / 33;
    const int cnt = __popc(__ballot_sync(0xFFFFFFFFu, static_cast<int64_t>(presum[p]) <= q));
    const int64_t lo2 = cnt ? lo + (static_cast<int64_t>(cnt) * len) / 33 + 1 : lo;
    hi = cnt == 32 ? hi : lo + (static_cast<int64_t>(cnt + 1) * len) / 33;
    lo = lo2;
  }
  const int64_t g = lo - 1;
  return g < 0 ? 0 : (g >= n_groups ? n_groups - 1 : g);
}

// values[0] at (global) group g, and for STRGATHER the offset of the word it
// names; the chains' leaves are the span's slices, which start at g_start.
template <int kMap>
__device__ __forceinline__ uint32_t zf_group_value(const ZfGpArgs& a, int64_t g) {
  const uint32_t v = zf_eval(a.values[0], g - a.g_start);
  if (kMap != ZF_STRGATHER) return v;
  return zf_read(a.offs.a, a.offs.elem, zf_jnp_index(static_cast<int32_t>(v), a.offs.n));
}

// A thread's walk over the groups m = g_hi - g_lo + 1 of its block's window:
// ps[k] = presum[g_lo + k] for k <= m, in shared memory (kShared, with the
// per-group values v0/v1 beside it) or in global memory (values evaluated here).
template <int kMap, bool kShared>
struct ZfCursor {
  const ZfGpArgs& a;
  const int32_t* ps;
  const uint32_t* v0;
  const uint32_t* v1;
  int64_t g_lo, m;
  int64_t k = 0, start = 0, next = 0, vk = -1;
  uint32_t val0 = 0, val1 = 0;

  __device__ __forceinline__ void load() {
    start = ps[k];
    next = k + 1 < m ? static_cast<int64_t>(ps[k + 1]) : INT64_MAX;
  }
  // The group of output i: the last k with ps[k] <= i, clamped to [0, m).
  __device__ __forceinline__ void seek(int64_t i) {
    int64_t lo = 0, hi = m + 1;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (static_cast<int64_t>(ps[mid]) <= i) lo = mid + 1;
      else hi = mid;
    }
    k = lo - 1 < 0 ? 0 : (lo - 1 >= m ? m - 1 : lo - 1);
    load();
  }
  // map(values at the group of i, pos); the caller applies the tail.
  __device__ __forceinline__ uint32_t mapped(int64_t i) {
    while (next <= i) {
      ++k;
      load();
    }
    if (vk != k) {
      vk = k;
      if (kShared) {
        val0 = v0[k];
        if (kMap == ZF_AFFINE) val1 = v1[k];
      } else {
        val0 = zf_group_value<kMap>(a, g_lo + k);
        if (kMap == ZF_AFFINE) val1 = zf_eval(a.values[1], g_lo + k - a.g_start);
      }
    }
    const int64_t pos = i - start;
    uint32_t v = val0;
    if (kMap == ZF_AFFINE) {
      v += val1 * static_cast<uint32_t>(pos);  // uint32: wraps
    } else if (kMap == ZF_STRGATHER) {
      const int64_t j = static_cast<int64_t>(static_cast<int32_t>(val0)) + pos;
      v = zf_read(a.chars.a, a.chars.elem, zf_jnp_index(j, a.chars.n));
    }
    return v;
  }
};

// Global outputs [i0, i0 + nc) of one thread.  A full, aligned 16-byte group with no
// tail (every main-path stage) is unrolled: its K values (for STRGATHER, K
// independent byte loads) are all requested before the first is packed.
// Anything else goes through zf_store_packed one output at a time.
template <int W, class Cursor>
__device__ __forceinline__ void zf_emit(const ZfGpArgs& a, Cursor& cur, int64_t i0,
                                        int32_t nc) {
  constexpr int K = 16 / W;
  typename ZfOut<W>::T* o = static_cast<typename ZfOut<W>::T*>(a.out) + (i0 - a.out_start);
  cur.seek(i0);
  if (nc == K && a.tail.n_ops == 0 && (reinterpret_cast<uintptr_t>(o) & 15u) == 0) {
    uint32_t v[K];
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = cur.mapped(i0 + j);
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < K; ++j) zf_pack<W>(w, j, v[j]);
    *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
  int64_t i = i0;
  zf_store_packed<W, false>(o, nc, [&] { return zf_transforms(a.tail, 0, cur.mapped(i++)); });
}

// A block covers L sub-tiles of S*C consecutive outputs, one after the other,
// from `org` (the output at the aligned address at or before out[0]) on.
// `cap`: groups the shared window holds (S*C + 1, or less where that exceeds
// ZF_GP_MAX_SMEM); dynamic shared memory holds ps[cap + 1], v0[cap] (, v1[cap]).
template <int W, int kMap>
__device__ __forceinline__ void zf_gp_block(const ZfGpArgs& a, int64_t cap, int64_t org,
                                            int64_t block) {
  extern __shared__ int32_t smem[];
  __shared__ int64_t win;
  int32_t* ps = smem;
  uint32_t* v0 = reinterpret_cast<uint32_t*>(ps + cap + 1);
  uint32_t* v1 = v0 + cap;
  const int64_t S = blockDim.x;
  const int64_t sub = S * a.C;
  const int64_t lo = a.out_start, hi = a.out_start + a.n;   // the outputs written
  const int64_t o_begin = org + block * a.L * sub;
  if (threadIdx.x < 32) {
    const int64_t g = zf_find_group(a.presum, a.n_groups, o_begin > lo ? o_begin : lo);
    if (threadIdx.x == 0) win = g;
  }
  __syncthreads();
  // gb: a group at or before the group of the sub-tile's first output, with
  // presum[gb] <= that output unless gb == 0: the search's answer for the first
  // sub-tile, the previous sub-tile's last group after it.
  int64_t gb = win;
  for (int l = 0; l < a.L; ++l) {
    const int64_t o0 = o_begin + l * sub;
    if (o0 >= hi) break;
    const int64_t o_last = (o0 + sub < hi ? o0 + sub : hi) - 1;
    // Stage presum[gb ..] a row of S entries at a time until an entry exceeds
    // o_last; cnt counts those that do not, so the group of o_last is
    // gb + cnt - 1 (clamped).  No search.
    int64_t cnt = 0, rows = 0;
    for (bool more = true; more; rows += S) {
      const int64_t k = rows + threadIdx.x;
      int le = 0;
      if (gb + k <= a.n_groups) {
        const int32_t p = a.presum[gb + k];
        if (k <= cap) ps[k] = p;
        le = static_cast<int64_t>(p) <= o_last;
      }
      const int c = __syncthreads_count(le);
      cnt += c;
      more = c == S && gb + rows + S <= a.n_groups && rows + S <= cap;
    }
    int64_t g_hi = gb + cnt - 1;
    g_hi = g_hi < 0 ? 0 : (g_hi >= a.n_groups ? a.n_groups - 1 : g_hi);
    int64_t m = g_hi - gb + 1;
    const bool staged = m <= cap && m < rows;
    if (staged) {
      for (int64_t k = threadIdx.x; k < m; k += S) {
        v0[k] = zf_group_value<kMap>(a, gb + k);
        if (kMap == ZF_AFFINE) v1[k] = zf_eval(a.values[1], gb + k - a.g_start);
      }
    } else {
      // wider than the buffer (zero counts): the rows stopped early, so
      // search for the group of o_last and walk [gb, g_hi] in global memory
      if (threadIdx.x < 32) {
        const int64_t g = zf_find_group(a.presum, a.n_groups, o_last);
        if (threadIdx.x == 0) win = g;
      }
      __syncthreads();
      g_hi = win;
      m = g_hi - gb + 1;
    }
    __syncthreads();
    const int64_t t0 = o0 + threadIdx.x * a.C;
    const int64_t i0 = t0 > lo ? t0 : lo;                    // the span's first thread
    const int64_t i1 = t0 + a.C < hi ? t0 + a.C : hi;
    if (i0 < i1) {
      const int32_t nc = static_cast<int32_t>(i1 - i0);
      if (staged) {
        ZfCursor<kMap, true> cur{a, ps, v0, v1, gb, m};
        zf_emit<W>(a, cur, i0, nc);
      } else {
        ZfCursor<kMap, false> cur{a, a.presum + gb, nullptr, nullptr, gb, m};
        zf_emit<W>(a, cur, i0, nc);
      }
    }
    gb = g_hi;
    __syncthreads();   // the window is rewritten for the next sub-tile
  }
}

template <int W, int kMap>
__global__ void zf_group_parallel_kernel(const ZfGpArgs a, int64_t cap, int64_t org) {
  zf_gp_block<W, kMap>(a, cap, org, blockIdx.x);
}

// Member blockIdx.y of the batch; blocks past its last output return.
template <int W, int kMap>
__global__ void zf_group_parallel_batched_kernel(const __grid_constant__ ZfGpBatch b,
                                                 int64_t cap) {
  const ZfGpArgs& a = b.m[blockIdx.y];
  const int64_t org = b.org[blockIdx.y];
  const int64_t tile = static_cast<int64_t>(a.L) * blockDim.x * a.C;
  if (a.n <= 0 || org + static_cast<int64_t>(blockIdx.x) * tile >= a.out_start + a.n) return;
  zf_gp_block<W, kMap>(a, cap, org, blockIdx.x);
}

// One launch of the single kernel (batch == nullptr; `org` its origin) or of
// the batched one over `k` members; `a` gives the geometry.
template <int W, int kMap>
static cudaError_t zf_gp_launch(const ZfGpArgs& a, const ZfGpBatch* batch, int32_t k,
                                unsigned grid, int32_t threads, int64_t org,
                                cudaStream_t stream) {
  constexpr int64_t per_group = kMap == ZF_AFFINE ? 12 : 8;   // presum, values[0] (, [1])
  const int64_t fit = (ZF_GP_MAX_SMEM - 4) / per_group;
  // a sub-tile of outputs touches at most `sub` groups when counts are >= 1,
  // and its window starts at most one group earlier (the previous sub-tile's last)
  const int64_t sub = static_cast<int64_t>(threads) * a.C;
  const int64_t cap = sub + 1 < fit ? sub + 1 : fit;
  const size_t smem = static_cast<size_t>(4 + cap * per_group);
  if (smem > 48 * 1024 - 64) {
    const cudaError_t err = batch == nullptr
        ? cudaFuncSetAttribute(zf_group_parallel_kernel<W, kMap>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem))
        : cudaFuncSetAttribute(zf_group_parallel_batched_kernel<W, kMap>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (batch == nullptr)
    zf_group_parallel_kernel<W, kMap><<<grid, threads, smem, stream>>>(a, cap, org);
  else
    zf_group_parallel_batched_kernel<W, kMap>
        <<<dim3(grid, static_cast<unsigned>(k)), threads, smem, stream>>>(*batch, cap);
  return cudaGetLastError();
}

template <int W>
static cudaError_t zf_gp_map(const ZfGpArgs& a, const ZfGpBatch* batch, int32_t k,
                             unsigned grid, int32_t threads, int64_t org, cudaStream_t s) {
  switch (a.map_kind) {
    case ZF_IDENTITY: return zf_gp_launch<W, ZF_IDENTITY>(a, batch, k, grid, threads, org, s);
    case ZF_AFFINE: return zf_gp_launch<W, ZF_AFFINE>(a, batch, k, grid, threads, org, s);
    case ZF_STRGATHER: return zf_gp_launch<W, ZF_STRGATHER>(a, batch, k, grid, threads, org, s);
    default: return cudaErrorInvalidValue;
  }
}

// The output at the 16-byte boundary at or before out[0], where blocks start
// tiling, and the blocks that cover the outputs from there.
static int64_t zf_gp_org(const ZfGpArgs& a) {
  const int64_t w = a.out_width;
  return a.out_start - static_cast<int64_t>((reinterpret_cast<uintptr_t>(a.out) & 15u) / w);
}

static int64_t zf_gp_grid(const ZfGpArgs& a, int32_t threads) {
  const int64_t tile = static_cast<int64_t>(a.L) * threads * a.C;
  return a.n > 0 ? (a.out_start + a.n - zf_gp_org(a) + tile - 1) / tile : 0;
}

static bool zf_gp_valid(const ZfGpArgs& a, int32_t threads) {   // warp 0 searches
  return a.n_groups > 0 && threads >= 32 && a.out_start >= 0 && a.L >= 1 && a.C >= 1 &&
         (a.out_width == 1 || a.out_width == 2 || a.out_width == 4);
}

static cudaError_t zf_gp_dispatch(const ZfGpArgs& a, const ZfGpBatch* batch, int32_t k,
                                  int64_t grid, int32_t threads, int64_t org,
                                  int32_t device, void* stream) {
  if (grid > 0x7FFFFFFF) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const unsigned g = static_cast<unsigned>(grid);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.out_width) {
    case 1: return zf_gp_map<1>(a, batch, k, g, threads, org, s);
    case 2: return zf_gp_map<2>(a, batch, k, g, threads, org, s);
    case 4: return zf_gp_map<4>(a, batch, k, g, threads, org, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int zf_group_parallel(const ZfGpArgs* args, int32_t threads, int32_t device,
                                 void* stream) {
  if (args->n <= 0) return 0;
  if (!zf_gp_valid(*args, threads)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(zf_gp_dispatch(*args, nullptr, 1, zf_gp_grid(*args, threads),
                                         threads, zf_gp_org(*args), device, stream));
}

// k members of one structure in one launch (see the batched entry above).
extern "C" int zf_group_parallel_batched(const ZfGpArgs* args, int32_t k, int32_t threads,
                                         int32_t device, void* stream) {
  if (k < 1 || k > ZF_GP_MAX_BATCH) return static_cast<int>(cudaErrorInvalidValue);
  ZfGpBatch batch = {};
  int64_t grid = 0;
  for (int32_t j = 0; j < k; ++j) {
    const ZfGpArgs& a = args[j];
    if (!zf_gp_valid(a, threads) || a.map_kind != args[0].map_kind ||
        a.out_width != args[0].out_width || a.L != args[0].L || a.C != args[0].C)
      return static_cast<int>(cudaErrorInvalidValue);
    const int64_t g = zf_gp_grid(a, threads);
    grid = g > grid ? g : grid;
    batch.m[j] = a;
    batch.org[j] = zf_gp_org(a);
  }
  if (grid == 0) return 0;
  return static_cast<int>(zf_gp_dispatch(args[0], &batch, k, grid, threads, 0, device,
                                         stream));
}

extern "C" int zf_batch_max() { return ZF_GP_MAX_BATCH; }

// Every instance (output width x map, single and batched) on `device`.
extern "C" int zf_preload(int32_t device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
#define ZF_GP_PAIR(W, M) zf_group_parallel_kernel<W, M>, zf_group_parallel_batched_kernel<W, M>
  return static_cast<int>(zf_preload_all(
      ZF_GP_PAIR(1, ZF_IDENTITY), ZF_GP_PAIR(1, ZF_AFFINE), ZF_GP_PAIR(1, ZF_STRGATHER),
      ZF_GP_PAIR(2, ZF_IDENTITY), ZF_GP_PAIR(2, ZF_AFFINE), ZF_GP_PAIR(2, ZF_STRGATHER),
      ZF_GP_PAIR(4, ZF_IDENTITY), ZF_GP_PAIR(4, ZF_AFFINE), ZF_GP_PAIR(4, ZF_STRGATHER)));
#undef ZF_GP_PAIR
}

ZF_EXPORT_HELPERS(ZfGpArgs)
