// Kernel 1: Fully-Parallel decode of one fused op chain.
//
// Replaces src/repro/kernels/fully_parallel.py:35 fully_parallel_call (Pallas, TPU).
// out[i] = chain(i) for i < n.  Launch geometry is the paper's <L,S,C> read the GPU
// way: grid = ceil(n / (L*S*C)) blocks of S threads; thread t of a block produces,
// in each of L main-loop iterations, C contiguous elements.  Threads past n write
// nothing, so the output is exactly (n,) (the TPU's padded tile has no counterpart).
//
// What bounds it on this card: bytes.  A chain does a handful of integer
// operations per element against 1-4 bytes written and up to 4 read, far below
// the H100's operations-per-byte balance point, so the kernel must keep enough
// bytes in flight and spend few instructions per element.  The design:
//  - Scalars once.  The bit width, base and every I2F_DIV scale are read into
//    registers at the start of a thread, so no store forces a reload per
//    element (the compiler cannot prove that the output does not alias them).
//  - 16 bytes out per thread.  The native geometry gives a thread C = 16 /
//    out_width outputs per iteration (<4,256,4> at 4 bytes; geometry.py), and
//    a full, aligned group leaves in one 16-byte store.
//  - UNPACK from shared memory.  Element i starts at bit i*bw of a continuous
//    stream, so a block's tile of outputs reads one contiguous run of words.
//    The block copies that run into shared memory with 16-byte cp.async (all
//    issued before one wait), starting at the word of its first bit aligned
//    down to 16 bytes, so a tile may start at any element; words past the
//    buffer's last are staged as copies of the last, which reproduces the
//    reference's clamp.  Each thread then walks its C values with a funnel
//    shift, one shared load per value.  A bit width outside [0, 32] (no
//    encoder makes one; the plain version takes it) or a window wider than the
//    buffer takes the per-element global-memory path in the same kernel.
//  - LOAD and BYTES as wide loads.  When a thread's C items are its 16 bytes
//    (item size = output width) and aligned, one 16-byte load fetches them
//    (staging them in shared memory as well was slower on word-lengths: the
//    block's wait delays its gathers); otherwise BYTES items come from the
//    aligned 4-byte words that hold them, and byte by byte only at the
//    buffer's ragged edges.
//  - Transforms op by op.  At 4-byte outputs a thread's 4 values go through
//    the shared interpreter together, one op at a time (zf_transforms_k), so
//    their loads (a GATHER's, a SPAN's) are in flight together (the `rolled`
//    variant of scripts/kernel_variants.py applies them value by value).  At
//    1- and 2-byte outputs only a chain that is its source alone unrolls; the
//    rest roll through one call of zf_transforms, so the build stays in
//    seconds.
//  - The kernel is specialised on the source and the output width (9
//    instances).  No launch bounds: with __launch_bounds__(1024) ptxas
//    spilled to stay at 32 registers.
//
// Batched entry (zf_fully_parallel_batched): K columns of one structure (the
// planner's BATCHED decision) decode in one launch.  Member k's argument struct
// is m[k] of a ZfFpBatch passed by value (__grid_constant__, so indexing it by
// blockIdx.y reads the parameter space and copies nothing); blockIdx.y picks the
// member and blockIdx.x its block, so each member keeps its own pointers,
// length, bit width, base and divisors.  The members must share the source kind,
// output width and geometry (one instance serves the launch); the grid is as
// wide as the longest member, whose surplus blocks return at once, and the
// shared buffer as large as the largest member's stage_words.  The kernel
// parameter space is 4 KB, so a launch takes at most ZF_FP_MAX_BATCH = 11
// members (11 x 360 B); the wrapper splits a larger batch into several launches.
#include "zf_chain.cuh"

struct ZfFpArgs {
  ZfChain chain;
  void* out;
  int64_t n;
  int32_t L;
  int32_t C;
  int32_t out_width;    // bytes per output element: 1, 2 or 4
  int32_t stage_words;  // UNPACK: words the shared staging buffer holds (multiple of 4)
};

static_assert(sizeof(ZfFpArgs) == 360, "ZfFpArgs layout is shared with kernels/cuda.py");

#define ZF_FP_MAX_BATCH 11   // members of one batched launch: 11 x 360 B of 4 KB

struct ZfFpBatch {
  ZfFpArgs m[ZF_FP_MAX_BATCH];
};

static_assert(sizeof(ZfFpBatch) <= 4096, "a batch must fit the 4 KB kernel parameter space");

#define ZF_FP_MAX_SMEM (96 * 1024)   // shared bytes a block's staged words may take

// Copy 16 bytes global -> shared without passing through registers.
__device__ __forceinline__ void zf_cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void zf_cp_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Drop the low W bytes of a 16-byte register (the mirror of zf_shift_in).
template <int W>
__device__ __forceinline__ uint4 zf_shift_out(uint4 q) {
  if constexpr (W == 4) {
    return make_uint4(q.y, q.z, q.w, 0u);
  } else {
    constexpr int B = 8 * W;
    return make_uint4(q.x >> B | q.y << (32 - B), q.y >> B | q.z << (32 - B),
                      q.z >> B | q.w << (32 - B), q.w >> B);
  }
}

// The low W bytes of v as a word, extended as element code `elem` says.
template <int W>
__device__ __forceinline__ uint32_t zf_widen(uint32_t v, int32_t elem) {
  if (W == 1) return elem < 0 ? static_cast<uint32_t>(static_cast<int32_t>(static_cast<int8_t>(v)))
                              : v & 0xFFu;
  if (W == 2) return elem < 0 ? static_cast<uint32_t>(static_cast<int32_t>(static_cast<int16_t>(v)))
                              : v & 0xFFFFu;
  return v;
}

// BYTES item i (zf_bytes) from the aligned 4-byte words that hold it; byte by
// byte where such a word would reach outside the buffer.
__device__ __forceinline__ uint32_t zf_bytes_words(const ZfOp& op, int64_t i) {
  const uintptr_t buf = reinterpret_cast<uintptr_t>(op.a);
  const uintptr_t p = buf + static_cast<uintptr_t>(i * op.imm);
  const uint32_t need = op.imm < 4 ? op.imm : 4;
  const uint32_t sh = static_cast<uint32_t>(p & 3u);
  const uintptr_t al = p - sh;
  const bool two = sh + need > 4;
  if (al < buf || al + (two ? 8u : 4u) > buf + static_cast<uintptr_t>(op.n))
    return zf_bytes(op, i);
  const uint32_t w0 = __ldg(reinterpret_cast<const uint32_t*>(al));
  const uint32_t w1 = two ? __ldg(reinterpret_cast<const uint32_t*>(al + 4)) : 0u;
  const uint32_t v = __funnelshift_r(w0, w1, 8 * sh);
  return need == 4 ? v : v & ((1u << (8 * need)) - 1u);
}

// Cursors: each call gives the source value of the next element of a thread;
// fast() does the same where zf_fp_emit's fast path holds.

// UNPACK.  Staged (bw in [0, 32]): element j of the block starts at bit b of
// the staged words s, and the next one in the same word or the next.  Else
// element i from global memory.
struct ZfBits {
  const uint32_t* s;
  uint32_t b, bw, mask, base;
  uint32_t k, lo;   // word of bit b, and its value
  const uint32_t* packed;
  int64_t last, i;
  bool staged;

  __device__ __forceinline__ uint32_t fast() {   // staged holds
    const uint32_t hi = s[k + 1];
    const uint32_t v = __funnelshift_r(lo, hi, b);
    b += bw;
    const uint32_t nk = b >> 5;
    lo = nk == k ? lo : hi;
    k = nk;
    return (v & mask) + base;
  }
  __device__ __forceinline__ uint32_t operator()() {
    if (staged) return fast();
    return zf_unpack_at(packed, last, static_cast<int32_t>(bw), base, i++);
  }
};

// LOAD or BYTES items from item i: out of q (the thread's 16 bytes, fetched in
// one load, items of W bytes) when `pre`, else one by one.
template <int kSrc, int W>
struct ZfItems {
  const ZfOp& op;
  int64_t i;
  uint4 q;
  bool pre;

  __device__ __forceinline__ uint32_t fast() {   // pre holds
    const uint32_t v = zf_widen<W>(q.x, kSrc == ZF_LOAD ? op.elem : 0);
    q = zf_shift_out<W>(q);
    return v;
  }
  __device__ __forceinline__ uint32_t operator()() {
    if (pre) return fast();
    const uint32_t v = kSrc == ZF_LOAD ? zf_read(op.a, op.elem, i) : zf_bytes_words(op, i);
    ++i;
    return v;
  }
};

// A thread's nc outputs at o.  `fast`: nc fills 16 aligned bytes and the
// cursor has its values at hand.  Then the K = 16 / W values are fetched
// unrolled, the transforms run op by op over all of them (at K = 4; at larger
// K only a chain that is its source alone takes this path), and one 16-byte
// store writes them.  Everything else is a rolled loop with one call of the
// shared interpreter (zf_store_packed still stores 16 bytes at a time where
// it can).
template <int W, class Src>
__device__ __forceinline__ void zf_fp_emit(const ZfChain& ch, const float (&scale)[ZF_MAX_OPS],
                                           typename ZfOut<W>::T* __restrict__ o, int32_t nc,
                                           bool fast, Src& src) {
  constexpr int K = 16 / W;
  const auto scale_of = [&](int k) { return scale[k]; };
  if (fast && (K <= 4 || ch.n_ops == 1)) {
    uint32_t v[K];
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = src.fast();
    if constexpr (K <= 4) zf_transforms_k(ch, 1, v, scale_of);
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < K; ++j) zf_pack<W>(w, j, v[j]);
    *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
  zf_store_packed<W, false>(o, nc, [&] { return zf_transforms(ch, 1, src(), scale_of); });
}

// Block `block` of one launch over the arguments `a` (a single launch's, or a
// batched launch's member).
template <int kSrc, int W>
__device__ __forceinline__ void zf_fp_block(const ZfFpArgs& a, int64_t block) {
  extern __shared__ uint4 zf_fp_stage[];   // UNPACK: the block's words
  using T = typename ZfOut<W>::T;
  const ZfChain& ch = a.chain;
  const ZfOp& src = ch.ops[0];
  const int64_t S = blockDim.x;
  const int64_t tile = static_cast<int64_t>(a.L) * S * a.C;
  const int64_t e0 = block * tile;
  const int64_t m = a.n - e0 < tile ? a.n - e0 : tile;   // outputs of this block
  T* __restrict__ out = static_cast<T*>(a.out) + e0;
  float scale[ZF_MAX_OPS];
#pragma unroll
  for (int k = 0; k < ZF_MAX_OPS; ++k)
    scale[k] = k < ch.n_ops && ch.ops[k].kind == ZF_I2F_DIV
                   ? __ldg(static_cast<const float*>(ch.ops[k].a)) : 0.f;

  if constexpr (kSrc == ZF_UNPACK) {
    const uint32_t* __restrict__ packed = static_cast<const uint32_t*>(src.a);
    const int64_t last = src.n - 1;
    const int32_t bw = __ldg(static_cast<const int32_t*>(src.b));
    const uint32_t base = static_cast<uint32_t>(__ldg(static_cast<const int32_t*>(src.c)));
    // The block's window: words [a0, a0 + 4 * nvec), a0 the word of bit e0*bw
    // aligned down to 16 bytes (shift words before it), through the word after
    // the one holding the last element's first bit.
    bool staged = bw >= 0 && bw <= 32;
    int64_t a0 = 0, nvec = 0;
    uint32_t shift = 0, off0 = 0;
    if (staged) {
      const int64_t bit0 = e0 * bw;
      const int64_t w_lo = bit0 >> 5;
      off0 = static_cast<uint32_t>(bit0 & 31);
      shift = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(packed + w_lo) >> 2) & 3u;
      a0 = w_lo - shift;
      nvec = (shift + ((off0 + (m - 1) * bw) >> 5) + 2 + 3) >> 2;
      staged = 4 * nvec <= a.stage_words;
    }
    uint32_t* words = reinterpret_cast<uint32_t*>(zf_fp_stage);
    if (staged) {   // block-uniform
      for (int64_t v = threadIdx.x; v < nvec; v += S) {
        const int64_t w = a0 + 4 * v;
        if (w >= 0 && w + 3 <= last) {
          zf_cp_async16(zf_fp_stage + v, packed + w);
        } else {   // the buffer's edges: clamp each word into [0, last]
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int64_t c = w + q < 0 ? 0 : (w + q > last ? last : w + q);
            words[4 * v + q] = __ldg(packed + c);
          }
        }
      }
      zf_cp_wait_all();
      __syncthreads();
    }
    const uint32_t mask = bw >= 32 ? 0xFFFFFFFFu : ((1u << (bw & 31)) - 1u);
    for (int l = 0; l < a.L; ++l) {
      const int64_t j0 = (static_cast<int64_t>(l) * S + threadIdx.x) * a.C;
      if (j0 >= m) break;
      const int32_t nc = static_cast<int32_t>(m - j0 < a.C ? m - j0 : a.C);
      T* o = out + j0;
      const bool full = nc * W == 16 && (reinterpret_cast<uintptr_t>(o) & 15u) == 0;
      const uint32_t b = off0 + static_cast<uint32_t>(j0) * static_cast<uint32_t>(bw);
      ZfBits cur{words + shift, b, static_cast<uint32_t>(bw), mask, base, b >> 5, 0u,
                 packed, last, e0 + j0, staged};
      if (staged) cur.lo = cur.s[cur.k];
      zf_fp_emit<W>(ch, scale, o, nc, full && staged, cur);
    }
  } else {
    // LOAD or BYTES: item size E bytes, the thread's items contiguous.  Items
    // of the output's width from a 16-byte aligned tile come in one 16-byte
    // load per thread; a thread whose 16 bytes are not whole (the tail at n)
    // and other item sizes read item by item.
    const int32_t E = kSrc == ZF_LOAD ? (src.elem < 0 ? -src.elem : src.elem) : src.imm;
    const uint8_t* in0 = static_cast<const uint8_t*>(src.a) + e0 * E;
    const bool wide = E == W && (reinterpret_cast<uintptr_t>(in0) & 15u) == 0;   // block-uniform
    for (int l = 0; l < a.L; ++l) {
      const int64_t j0 = (static_cast<int64_t>(l) * S + threadIdx.x) * a.C;
      if (j0 >= m) break;
      const int32_t nc = static_cast<int32_t>(m - j0 < a.C ? m - j0 : a.C);
      T* o = out + j0;
      const bool full = nc * W == 16 && (reinterpret_cast<uintptr_t>(o) & 15u) == 0;
      ZfItems<kSrc, W> cur{src, e0 + j0, make_uint4(0u, 0u, 0u, 0u), wide && full};
      if (cur.pre) cur.q = __ldg(reinterpret_cast<const uint4*>(in0 + j0 * E));
      zf_fp_emit<W>(ch, scale, o, nc, cur.pre, cur);
    }
  }
}

template <int kSrc, int W>
__global__ void zf_fully_parallel_kernel(const ZfFpArgs a) {
  zf_fp_block<kSrc, W>(a, blockIdx.x);
}

// Member blockIdx.y of the batch; blocks past its last output return.
template <int kSrc, int W>
__global__ void zf_fully_parallel_batched_kernel(const __grid_constant__ ZfFpBatch b) {
  const ZfFpArgs& a = b.m[blockIdx.y];
  const int64_t tile = static_cast<int64_t>(a.L) * blockDim.x * a.C;
  if (static_cast<int64_t>(blockIdx.x) * tile >= a.n) return;
  zf_fp_block<kSrc, W>(a, blockIdx.x);
}

// One launch of the single kernel (batch == nullptr) or of the batched one
// over `k` members; `a` gives the geometry and the largest stage_words.
template <int kSrc, int W>
static cudaError_t zf_fp_launch(const ZfFpArgs& a, const ZfFpBatch* batch, int32_t k,
                                unsigned grid, int32_t threads, cudaStream_t stream) {
  const size_t smem = kSrc == ZF_UNPACK ? static_cast<size_t>(a.stage_words) * 4 : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = batch == nullptr
        ? cudaFuncSetAttribute(zf_fully_parallel_kernel<kSrc, W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem))
        : cudaFuncSetAttribute(zf_fully_parallel_batched_kernel<kSrc, W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (batch == nullptr)
    zf_fully_parallel_kernel<kSrc, W><<<grid, threads, smem, stream>>>(a);
  else
    zf_fully_parallel_batched_kernel<kSrc, W>
        <<<dim3(grid, static_cast<unsigned>(k)), threads, smem, stream>>>(*batch);
  return cudaGetLastError();
}

template <int kSrc>
static cudaError_t zf_fp_width(const ZfFpArgs& a, const ZfFpBatch* batch, int32_t k,
                               unsigned grid, int32_t threads, cudaStream_t s) {
  switch (a.out_width) {
    case 1: return zf_fp_launch<kSrc, 1>(a, batch, k, grid, threads, s);
    case 2: return zf_fp_launch<kSrc, 2>(a, batch, k, grid, threads, s);
    case 4: return zf_fp_launch<kSrc, 4>(a, batch, k, grid, threads, s);
    default: return cudaErrorInvalidValue;
  }
}

static bool zf_fp_valid(const ZfFpArgs& a) {
  return a.chain.n_ops >= 1 && a.stage_words >= 0 && a.stage_words % 4 == 0 &&
         static_cast<int64_t>(a.stage_words) * 4 <= ZF_FP_MAX_SMEM && a.L >= 1 && a.C >= 1;
}

static cudaError_t zf_fp_dispatch(const ZfFpArgs& a, const ZfFpBatch* batch, int32_t k,
                                  int64_t grid, int32_t threads, int32_t device,
                                  void* stream) {
  if (grid > 0x7FFFFFFF) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const unsigned g = static_cast<unsigned>(grid);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.chain.ops[0].kind) {
    case ZF_UNPACK: return zf_fp_width<ZF_UNPACK>(a, batch, k, g, threads, s);
    case ZF_LOAD: return zf_fp_width<ZF_LOAD>(a, batch, k, g, threads, s);
    case ZF_BYTES: return zf_fp_width<ZF_BYTES>(a, batch, k, g, threads, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int zf_fully_parallel(const ZfFpArgs* args, int32_t threads, int32_t device,
                                 void* stream) {
  if (args->n <= 0) return 0;
  if (!zf_fp_valid(*args)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tile = static_cast<int64_t>(args->L) * threads * args->C;
  return static_cast<int>(
      zf_fp_dispatch(*args, nullptr, 1, (args->n + tile - 1) / tile, threads, device, stream));
}

// k members of one structure in one launch (see the batched entry above).
extern "C" int zf_fully_parallel_batched(const ZfFpArgs* args, int32_t k, int32_t threads,
                                         int32_t device, void* stream) {
  if (k < 1 || k > ZF_FP_MAX_BATCH) return static_cast<int>(cudaErrorInvalidValue);
  ZfFpBatch batch = {};
  ZfFpArgs geom = args[0];
  int64_t grid = 0;
  for (int32_t j = 0; j < k; ++j) {
    const ZfFpArgs& a = args[j];
    if (!zf_fp_valid(a) || a.chain.ops[0].kind != args[0].chain.ops[0].kind ||
        a.out_width != args[0].out_width || a.L != args[0].L || a.C != args[0].C)
      return static_cast<int>(cudaErrorInvalidValue);
    const int64_t tile = static_cast<int64_t>(a.L) * threads * a.C;
    const int64_t g = a.n > 0 ? (a.n + tile - 1) / tile : 0;
    grid = g > grid ? g : grid;
    geom.stage_words = a.stage_words > geom.stage_words ? a.stage_words : geom.stage_words;
    batch.m[j] = a;
  }
  if (grid == 0) return 0;
  return static_cast<int>(zf_fp_dispatch(geom, &batch, k, grid, threads, device, stream));
}

extern "C" int zf_batch_max() { return ZF_FP_MAX_BATCH; }

// Every instance (source x output width, single and batched) on `device`.
extern "C" int zf_preload(int32_t device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
#define ZF_FP_PAIR(S, W) zf_fully_parallel_kernel<S, W>, zf_fully_parallel_batched_kernel<S, W>
  return static_cast<int>(zf_preload_all(
      ZF_FP_PAIR(ZF_UNPACK, 1), ZF_FP_PAIR(ZF_UNPACK, 2), ZF_FP_PAIR(ZF_UNPACK, 4),
      ZF_FP_PAIR(ZF_LOAD, 1), ZF_FP_PAIR(ZF_LOAD, 2), ZF_FP_PAIR(ZF_LOAD, 4),
      ZF_FP_PAIR(ZF_BYTES, 1), ZF_FP_PAIR(ZF_BYTES, 2), ZF_FP_PAIR(ZF_BYTES, 4)));
#undef ZF_FP_PAIR
}

ZF_EXPORT_HELPERS(ZfFpArgs)
