// Kernel 3: Non-Parallel interleaved rANS decode, one chunk per thread.
//
// Replaces src/repro/kernels/non_parallel.py:29 non_parallel_call (Pallas, TPU).
// The TPU kernel advances a (1, G) register of decoder states in lockstep, one
// chunk per VPU lane.  Here one thread owns one chunk (the paper's §4 / Fig. 11
// mapping) and runs its chunk_size dependent steps:
//   e    = tab[x & 4095]                                   (one shared load)
//   x    = (freq-1 of e + 1) * (x >> 12) + bias of e        (uint32, mod 2^32)
//   if (x < 2^16) x = x << 16 | next                        (at most one word)
//   out[c*chunk_size + t] = tail(sym of e)                  (only below n)
//
// What bounds it.  Its bytes bound is a few microseconds; a chunk's steps are
// serial, so the floor on this card is chunk_size x the latency of one step's
// dependent chain.  The design keeps that chain short:
//  - One packed entry per slot, built by each block in shared memory from the
//    three alphabet tables: sym (bits 0-7) | freq - 1 (bits 8-19) |
//    slot - cum[sym] (bits 20-31); 16 KB.  freq - 1 because a one-symbol
//    alphabet has freq = 4096.  A step is one shared load and an IMAD.  A table
//    that does not fit the layout (freq outside 1..4096 or slot - cum outside
//    0..4095, which no encoder emits) sends its block down the same loop with
//    the three separate lookups, so every table decodes as the plain version.
//  - No global load on the chain.  Each lane keeps its next ZF_NP_LOOKAHEAD
//    stream words requested: a per-lane ring in shared memory, refilled with
//    4-byte cp.async (the aligned pair that holds the word; a 4-byte-aligned
//    read never leaves the page of the word it holds) one word per
//    renormalisation, so a word is requested 15 renormalisations before it is
//    used.  O_COMMENT renormalises every ~2.4 steps and a uniform 256-symbol
//    alphabet every ~2, so the lead is 30+ steps, over 1,000 cycles: more than
//    an HBM miss.  The word the next renormalisation takes is already in a
//    register, and the refill that follows a renormalisation is issued behind
//    the next step's table load.  Reads clamp at max_words - 1 as the plain
//    version does.
//  - Packed stores.  A lane collects 16 bytes of outputs (16, 8 or 4 symbols
//    at 1, 2 or 4 bytes) and writes them with one 16-byte store; an unaligned
//    head (chunk_size need not be a multiple of 16) and the tail (the last
//    chunk stops at n) are written element by element.  The output width and
//    whether a tail chain runs are template parameters, resolved at launch;
//    without a tail the 16 steps of a store are unrolled.
//  - The step has no branch: the renormalisation is a select, and the refill
//    a predicated copy.
// streams[t, c] is chunk-transposed, so lanes whose cur agree read neighbouring
// words.  Geometry: S threads per block, C chunks per thread (one after the
// other), L such rounds; block b covers chunks [b*L*S*C, (b+1)*L*S*C).
//
// Batched entry (zf_non_parallel_batched): K columns of one structure decode in
// one launch; blockIdx.y picks member m[k] of a ZfNpBatch passed by value
// (__grid_constant__), with its own streams, states, tables, lengths and
// output.  The members share the output width, whether a tail runs, and the
// geometry; the grid is as wide as the member with the most chunks, whose
// surplus blocks return at once.  A ZfNpArgs is 416 B, so the 4 KB kernel
// parameter space takes ZF_NP_MAX_BATCH = 9 members a launch; the wrapper
// splits a larger batch into several launches.
#include "zf_chain.cuh"

#define ZF_ANS_M 4096          // probability scale 2^12 (sym table entries)
#define ZF_ANS_SCALE_BITS 12
#define ZF_ANS_L (1u << 16)    // renormalisation bound
#define ZF_NP_LOOKAHEAD 16     // stream words each lane keeps requested (power of 2)

struct ZfNpArgs {
  const uint16_t* streams;   // (max_words, n_chunks), word t of chunk c at t*n_chunks+c
  const uint32_t* states;    // (n_chunks,) initial decoder states
  const uint8_t* sym;        // (4096,)
  const uint16_t* freq;      // (256,)
  const uint16_t* cum;       // (256,)
  int64_t max_words;
  int64_t n_chunks;
  int64_t n;                 // symbols written: out is (n,)
  ZfChain tail;              // fusion rule 4: elementwise ops on each symbol
  void* out;
  int32_t chunk_size;
  int32_t out_width;         // bytes per output element: 1, 2 or 4
  int32_t L;
  int32_t C;
};

static_assert(sizeof(ZfNpArgs) == 416, "ZfNpArgs layout is shared with kernels/cuda.py");

#define ZF_NP_MAX_BATCH 9    // members of one batched launch: 9 x 416 B of 4 KB

struct ZfNpBatch {
  ZfNpArgs m[ZF_NP_MAX_BATCH];
};

static_assert(sizeof(ZfNpBatch) <= 4096, "a batch must fit the 4 KB kernel parameter space");

// Copy 4 bytes global -> shared if `on`, and commit a cp.async group either
// way (an empty group completes at once), so every step commits one group.
__device__ __forceinline__ void zf_cp_async4_commit(void* smem, const void* gmem, bool on) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p cp.async.ca.shared.global [%0], [%1], 4;\n"
      " cp.async.commit_group;\n}\n" ::"r"(s), "l"(gmem), "r"(static_cast<uint32_t>(on))
      : "memory");
}

template <int N>
__device__ __forceinline__ void zf_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The stream words of one chunk, ZF_NP_LOOKAHEAD of them requested ahead.
// Slot k of the lane's ring is ring[k * S], so a warp's slots are neighbouring
// words.  A word is copied as the aligned 4-byte pair that holds it; `half`
// says which half, from the parity of its address (stride odd: alternating).
struct ZfWords {
  uint32_t* ring;
  int32_t S;
  const uint16_t* src;     // the next word to request (stops at max_words - 1)
  const uint16_t* last;    // word max_words - 1 of this chunk
  int64_t stride;          // n_chunks
  uint32_t half0, flip;    // bit 1 of word 0's address; stride & 1
  int32_t cap;             // max_words - 1
  int32_t issued = 0;      // words requested so far

  __device__ __forceinline__ ZfWords(uint32_t* ring_, int32_t S_, const uint16_t* col,
                                     int64_t stride_, int32_t cap_)
      : ring(ring_), S(S_), src(col), last(col + cap_ * stride_), stride(stride_),
        half0(static_cast<uint32_t>(reinterpret_cast<uintptr_t>(col) >> 1) & 1u),
        flip(static_cast<uint32_t>(stride_) & 1u), cap(cap_) {}

  // Request word `issued` if `on`; commit one group either way.
  __device__ __forceinline__ void request(bool on) {
    const uintptr_t g = reinterpret_cast<uintptr_t>(src) & ~uintptr_t(3);
    zf_cp_async4_commit(ring + (issued & (ZF_NP_LOOKAHEAD - 1)) * S,
                        reinterpret_cast<const void*>(g), on);
    if (on) {
      ++issued;
      src = src == last ? src : src + stride;
    }
  }
  // Word w, whose copy has completed.
  __device__ __forceinline__ uint32_t get(int32_t w) const {
    const uint32_t pair = ring[(w & (ZF_NP_LOOKAHEAD - 1)) * S];
    const uint32_t hi = half0 ^ (static_cast<uint32_t>(w < cap ? w : cap) & flip);
    return (pair >> (hi * 16u)) & 0xFFFFu;
  }
};

// Decode chunk c.  kPacked: one lookup in the packed table; else three lookups.
// The step is branch-free: the renormalisation is a select, and the refill
// after one is a predicated copy issued in the next step, behind its table
// load, so it overlaps the load's latency.
template <int W, bool kTail, bool kPacked>
__device__ __forceinline__ void zf_decode_chunk(const ZfNpArgs& a, const uint32_t* tab,
                                                const uint8_t* sym, const uint16_t* freq,
                                                const uint16_t* cum, uint32_t* ring, int64_t c) {
  const int64_t first = c * a.chunk_size;
  const int64_t left = a.n - first;
  const int32_t steps = left < a.chunk_size ? static_cast<int32_t>(left) : a.chunk_size;
  ZfWords words(ring + threadIdx.x, static_cast<int32_t>(blockDim.x), a.streams + c,
                a.n_chunks, static_cast<int32_t>(a.max_words - 1));
#pragma unroll
  for (int k = 0; k < ZF_NP_LOOKAHEAD; ++k) words.request(true);
  zf_cp_wait<ZF_NP_LOOKAHEAD - 1>();
  uint32_t next = words.get(0);   // the word the next renormalisation takes
  int32_t cur = 0;
  bool refill = false;
  uint32_t x = a.states[c];

  auto step = [&]() -> uint32_t {
    const uint32_t slot = x & (ZF_ANS_M - 1);
    const uint32_t e = kPacked ? tab[slot] : sym[slot];
    // One group per step; word cur was requested at least LOOKAHEAD - 1
    // groups ago (one renormalisation per step at most), so it has landed.
    words.request(refill);                  // word cur + LOOKAHEAD - 1
    zf_cp_wait<ZF_NP_LOOKAHEAD - 1>();
    next = words.get(cur);
    uint32_t s;
    if (kPacked) {
      s = e & 0xFFu;
      x = (((e >> 8) & 0xFFFu) + 1u) * (x >> ZF_ANS_SCALE_BITS) + (e >> 20);
    } else {
      s = e;
      x = static_cast<uint32_t>(freq[s]) * (x >> ZF_ANS_SCALE_BITS) + slot - cum[s];
    }
    refill = x < ZF_ANS_L;
    x = refill ? (x << 16) | next : x;
    cur += refill;
    return kTail ? zf_transforms(a.tail, 0, s) : s;
  };

  // without a tail (every main-path stage) each 16-byte group is unrolled
  zf_store_packed<W, !kTail>(static_cast<typename ZfOut<W>::T*>(a.out) + first, steps, step);
  asm volatile("cp.async.wait_all;\n" ::: "memory");   // the ring is reused
}

template <int W, bool kTail>
__device__ __forceinline__ void zf_np_block(const ZfNpArgs& a, int64_t block) {
  __shared__ uint32_t tab[ZF_ANS_M];
  __shared__ uint8_t sym[ZF_ANS_M];
  __shared__ uint16_t freq[256];
  __shared__ uint16_t cum[256];
  extern __shared__ uint32_t ring[];   // ZF_NP_LOOKAHEAD x blockDim.x
  for (int k = threadIdx.x; k < ZF_ANS_M; k += blockDim.x) sym[k] = a.sym[k];
  for (int k = threadIdx.x; k < 256; k += blockDim.x) {
    freq[k] = a.freq[k];
    cum[k] = a.cum[k];
  }
  __syncthreads();
  int bad = 0;
  for (int k = threadIdx.x; k < ZF_ANS_M; k += blockDim.x) {
    const uint32_t s = sym[k];
    const uint32_t f1 = static_cast<uint32_t>(freq[s]) - 1u;
    const uint32_t bias = static_cast<uint32_t>(k) - cum[s];
    bad |= f1 > 4095u || bias > 4095u;
    tab[k] = s | f1 << 8 | bias << 20;
  }
  const bool packed = !__syncthreads_or(bad);

  const int64_t S = blockDim.x;
  const int64_t block0 = block * a.L * S * a.C;
  for (int r = 0; r < a.L * a.C; ++r) {
    const int64_t c = block0 + r * S + threadIdx.x;
    if (c >= a.n_chunks || c * a.chunk_size >= a.n) return;
    if (packed) zf_decode_chunk<W, kTail, true>(a, tab, sym, freq, cum, ring, c);
    else zf_decode_chunk<W, kTail, false>(a, tab, sym, freq, cum, ring, c);
  }
}

template <int W, bool kTail>
__global__ void zf_non_parallel_kernel(const ZfNpArgs a) {
  zf_np_block<W, kTail>(a, blockIdx.x);
}

// Member blockIdx.y of the batch; blocks past its last chunk return.
template <int W, bool kTail>
__global__ void zf_non_parallel_batched_kernel(const __grid_constant__ ZfNpBatch b) {
  const ZfNpArgs& a = b.m[blockIdx.y];
  const int64_t tile = static_cast<int64_t>(a.L) * blockDim.x * a.C;
  if (a.n <= 0 || static_cast<int64_t>(blockIdx.x) * tile >= a.n_chunks) return;
  zf_np_block<W, kTail>(a, blockIdx.x);
}

// One launch of the single kernel (batch == nullptr) or of the batched one
// over `k` members.
template <int W, bool kTail>
static cudaError_t zf_np_launch(const ZfNpArgs& a, const ZfNpBatch* batch, int32_t k,
                                unsigned grid, int32_t threads, cudaStream_t stream) {
  const size_t ring = static_cast<size_t>(ZF_NP_LOOKAHEAD) * 4 * threads;
  if (ring > 48 * 1024 - 21 * 1024) {   // beyond the default 48 KB with the tables
    const cudaError_t err = batch == nullptr
        ? cudaFuncSetAttribute(zf_non_parallel_kernel<W, kTail>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(ring))
        : cudaFuncSetAttribute(zf_non_parallel_batched_kernel<W, kTail>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(ring));
    if (err != cudaSuccess) return err;
  }
  if (batch == nullptr)
    zf_non_parallel_kernel<W, kTail><<<grid, threads, ring, stream>>>(a);
  else
    zf_non_parallel_batched_kernel<W, kTail>
        <<<dim3(grid, static_cast<unsigned>(k)), threads, ring, stream>>>(*batch);
  return cudaGetLastError();
}

static bool zf_np_valid(const ZfNpArgs& a) {
  return a.max_words > 0 && a.max_words <= 0x7FFFFFFF && a.chunk_size > 0 && a.L >= 1 &&
         a.C >= 1;
}

static int64_t zf_np_grid(const ZfNpArgs& a, int32_t threads) {
  const int64_t tile = static_cast<int64_t>(a.L) * threads * a.C;
  return a.n > 0 && a.n_chunks > 0 ? (a.n_chunks + tile - 1) / tile : 0;
}

static cudaError_t zf_np_dispatch(const ZfNpArgs& a, const ZfNpBatch* batch, int32_t k,
                                  int64_t grid, int32_t threads, int32_t device,
                                  void* stream) {
  if (grid > 0x7FFFFFFF) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const unsigned g = static_cast<unsigned>(grid);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tail = a.tail.n_ops > 0;
  switch (a.out_width) {
    case 1: return tail ? zf_np_launch<1, true>(a, batch, k, g, threads, s)
                        : zf_np_launch<1, false>(a, batch, k, g, threads, s);
    case 2: return tail ? zf_np_launch<2, true>(a, batch, k, g, threads, s)
                        : cudaErrorInvalidValue;
    case 4: return tail ? zf_np_launch<4, true>(a, batch, k, g, threads, s)
                        : cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int zf_non_parallel(const ZfNpArgs* args, int32_t threads, int32_t device,
                               void* stream) {
  if (args->n <= 0 || args->n_chunks <= 0) return 0;
  if (!zf_np_valid(*args)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      zf_np_dispatch(*args, nullptr, 1, zf_np_grid(*args, threads), threads, device, stream));
}

// k members of one structure in one launch (see the batched entry above).
extern "C" int zf_non_parallel_batched(const ZfNpArgs* args, int32_t k, int32_t threads,
                                       int32_t device, void* stream) {
  if (k < 1 || k > ZF_NP_MAX_BATCH) return static_cast<int>(cudaErrorInvalidValue);
  ZfNpBatch batch = {};
  int64_t grid = 0;
  for (int32_t j = 0; j < k; ++j) {
    const ZfNpArgs& a = args[j];
    if (!zf_np_valid(a) || a.out_width != args[0].out_width || a.L != args[0].L ||
        a.C != args[0].C || (a.tail.n_ops > 0) != (args[0].tail.n_ops > 0))
      return static_cast<int>(cudaErrorInvalidValue);
    const int64_t g = zf_np_grid(a, threads);
    grid = g > grid ? g : grid;
    batch.m[j] = a;
  }
  if (grid == 0) return 0;
  return static_cast<int>(zf_np_dispatch(args[0], &batch, k, grid, threads, device, stream));
}

extern "C" int zf_batch_max() { return ZF_NP_MAX_BATCH; }

// Every instance (output width x tail chain, single and batched) on `device`.
extern "C" int zf_preload(int32_t device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
#define ZF_NP_PAIR(W, T) zf_non_parallel_kernel<W, T>, zf_non_parallel_batched_kernel<W, T>
  return static_cast<int>(zf_preload_all(
      ZF_NP_PAIR(1, false), ZF_NP_PAIR(1, true), ZF_NP_PAIR(2, false),
      ZF_NP_PAIR(2, true), ZF_NP_PAIR(4, false), ZF_NP_PAIR(4, true)));
#undef ZF_NP_PAIR
}

ZF_EXPORT_HELPERS(ZfNpArgs)
