// Kernel 4, generated per query: the hand-written half.
//
// No TPU kernel corresponds: the reference runs its terminal Reduce under XLA
// jit (src/repro/core/compiler.py:204 compile_query_chunk_graph), and XLA emits
// straight-line code per query with the query's constants folded in.  The
// port's counterpart is a kernel generated per query program:
// kernels/query_codegen.py writes, from the register program that
// kernels/query_reduce.py builds (_Program), a per-row function -- one named
// local per role and per instruction; op kinds, element types, casts,
// predicate modes and constants compiled in -- and the extern "C" entry.  This
// header holds the rest: the tile loop, the packed words' loads, the
// accumulators, the block sums and the last block's fixed-order sum.  One
// launch covers the items [out_start, out_start + n) of one chunk; ZfQgArgs
// carries only what changes per launch (the program is compiled in).
//
// Each row's values are those of the plain version (kernels/ref.py
// query_reduce_torch): every float operation of the generated code is an _rn
// intrinsic, so nvcc's default --fmad=true cannot contract a multiply and an
// add into an FMA; only the order of the sums differs.
//
// What bounds it on this card: a row's instructions, not its bytes.  Q6 reads
// ~46 bits a row (0.010 ms at SF 1 at 3.35 TB/s) and runs ~5x that; its
// unpacks, IEEE divides (a quarter of the time: the `no-divide` variant),
// compares and lanes are the work, so the design cuts instructions per row
// (scripts/kernel_variants.py measures each choice):
//  - Straight-line code per query: no loop, switch or register file per row.
//  - Scalars once per thread: bit widths, masks and bases, RANGE bounds
//    rebased, I2F_DIV divisors are read into registers by the generated
//    init(), not per row.
//  - Buffers from the parameter space: a launch's pointers and lengths stay in
//    the __grid_constant__ ZfQgArgs and are read there where needed, so they
//    take no registers across the loop.
//  - R = ZF_QG_ROWS = 4 consecutive rows per thread (1, 2 and 8 were
//    slower), so a warp takes 32*R contiguous rows and reads one contiguous
//    run of each bit-packed field's words.  A row's two words come through
//    L1 (__ldg), its word index and bit offset 32-bit arithmetic from the
//    tile's first bit, computed in 64 bits once a tile.  Staging the tile's
//    words in shared memory with 16-byte cp.async, as kernel 1 does, was no
//    faster on Q6 and slower on Q1.  A bit width outside [0, 32] (no encoder
//    makes one), or a buffer of 2^31 words, takes the 64-bit per-row path of
//    zf_unpack_at; the check is hoisted out of the rows (zf_qg_tiles<kFast>).
//  - Accumulators: with one segment (and at most 32 of them) the lanes and
//    the count stay in registers; with several (Q1: 5 x 8) each thread keeps
//    a column of (lanes + 1) x segments floats in shared memory (thread t's
//    column is bank t mod 32, so no conflicts); registers with each add
//    predicated on the key were slower.  A query whose columns outgrow
//    ZF_QG_MAX_SMEM (more than 438 accumulators) keeps them in global memory
//    instead, one column per thread in the launch's scratch (ZfQgArgs::cols),
//    with one block per SM; slow, but every query the reference runs runs
//    here.  A block sums each accumulator with a shuffle tree per warp, then
//    the warps in order; thread j mod T finishes accumulator j, so a query
//    may have more accumulators than a block has threads.
//  - The grid is the blocks the SMs hold at once (zf_max_blocks, from the
//    kernel's registers and shared memory), so no block waits for a second
//    wave while the others idle.
//  - Across blocks: each block writes its partials to scratch; the last block
//    to finish (an integer atomic counter, zeroed by the entry before the
//    launch) sums them, block b by thread b mod T in block order, then the
//    same block sum, and writes, or adds to, the output.  No float atomics:
//    the same launch gives the same bits every time.
#pragma once

#include "zf_chain.cuh"

#define ZF_QG_MAX_BUFS 72   // buffer slots of the launch struct (kernels/cuda.py QG_MAX_BUFS)
#define ZF_QG_THREADS 128   // a block (kernels/query_reduce.py THREADS)
#define ZF_QG_ROWS 4        // consecutive rows a thread takes per tile
// dynamic shared memory a block may opt into: the H100's 227 KB less 1 KB for
// the kernel's static shared memory (kernels/query_reduce.py MAX_SMEM)
#define ZF_QG_MAX_SMEM 231424
#define ZF_QG_REG_ACCS 32   // the most accumulators kept in registers (one segment)

// One buffer a role's op reads: its device pointer and element count.
struct ZfQgBuf {
  const void* p;
  int64_t n;
};

// What changes per launch; the program itself is compiled in.
struct ZfQgArgs {
  ZfQgBuf bufs[ZF_QG_MAX_BUFS];   // every role op's buffers, in role, op and buffer order
  int64_t n;                       // items of this launch
  int64_t out_start;               // global index of its first item
  float* out;                      // (lanes + 1) x segments, lane-major
  float* partials;                 // n_blocks x accumulators
  uint32_t* counter;               // after the partials
  int32_t accumulate;              // 1: add the totals to out, 0: write them
  int32_t n_blocks;                // the grid
  float* cols;                     // accumulator columns in global memory (n_blocks x
                                   // accumulators x threads) when shared memory cannot
                                   // hold them, else null
};

static_assert(sizeof(ZfQgBuf) == 16, "ZfQgBuf layout is shared with kernels/cuda.py");
static_assert(sizeof(ZfQgArgs) == 1208, "ZfQgArgs layout is shared with kernels/cuda.py");

// Floor modulo (the sign of the divisor), as jnp and torch.remainder give it.
__device__ __forceinline__ int32_t zf_qg_imod(int32_t x, int32_t y) {
  if (y == 0) return x;          // XLA's integer remainder by zero
  if (y == -1) return 0;         // INT_MIN % -1 would overflow
  const int32_t r = x % y;
  return (r != 0 && ((r < 0) != (y < 0))) ? r + y : r;
}

__device__ __forceinline__ float zf_qg_fmod(float x, float y) {
  const float r = fmodf(x, y);
  return (r != 0.f && ((r < 0.f) != (y < 0.f))) ? __fadd_rn(r, y) : r;
}

// Item i of a buffer of little-endian items of `kSize` bytes, as a word: bytes
// past the fourth would shift out of it (the reference's uint32 shifts give 0).
template <int kSize>
__device__ __forceinline__ uint32_t zf_qg_bytes(const void* p, int64_t i) {
  const uint8_t* b = static_cast<const uint8_t*>(p) + i * kSize;
  uint32_t v = 0;
#pragma unroll
  for (int k = 0; k < (kSize < 4 ? kSize : 4); ++k) v |= static_cast<uint32_t>(b[k]) << (8 * k);
  return v;
}

__device__ __forceinline__ int32_t zf_qg_scalar_i32(const ZfQgBuf& b) {
  return __ldg(static_cast<const int32_t*>(b.p));
}

__device__ __forceinline__ float zf_qg_scalar_f32(const ZfQgBuf& b) {
  return __ldg(static_cast<const float*>(b.p));
}

// The kernel's dynamic shared memory: the accumulator columns (several
// segments), then the warp sums.
extern __shared__ float zf_qg_smem[];

// A bit-packed field read at the tile's rows (a role's UNPACK or UNPACK_RAW
// source at chunk-local indices; its words are the launch's buffer, read
// from the parameter space where needed): its scalars, and where this tile's
// words are.
struct ZfQgField {
  int32_t bw;
  uint32_t mask;
  bool fast;           // bw in [0, 32] and fewer than 2^31 words: 32-bit per row
  uint32_t w0;         // the word of the tile's first bit, clamped to the last
  uint32_t off0;       // the tile's first bit within that word
};

__device__ __forceinline__ void zf_qg_field(ZfQgField& f, const ZfQgBuf& packed,
                                            const ZfQgBuf& bw) {
  f.bw = zf_qg_scalar_i32(bw);
  f.mask = f.bw >= 32 ? 0xFFFFFFFFu : ((1u << (f.bw & 31)) - 1u);
  f.fast = f.bw >= 0 && f.bw <= 32 && packed.n - 1 < 0x7FFFFF00;
  f.w0 = f.off0 = 0u;
}

// Point the field at the tile of rows from t0: the word of its first bit,
// clamped to the buffer's last, and the bit within it.
__device__ __forceinline__ void zf_qg_at(const ZfQgBuf& p, ZfQgField& f, int64_t t0) {
  if (!f.fast) return;
  const int64_t w_lo = (t0 * f.bw) >> 5;
  f.off0 = static_cast<uint32_t>((t0 * f.bw) & 31);
  f.w0 = static_cast<uint32_t>(w_lo < p.n - 1 ? w_lo : p.n - 1);
}

// The field of row j of the tile (chunk-local index i) before any base is
// added: bits [b, b + bw) of the tile's words, b = off0 + j * bw.  kFast: the
// launch has checked that every field takes the 32-bit path.
template <bool kFast>
__device__ __forceinline__ uint32_t zf_qg_raw(const ZfQgBuf& p, const ZfQgField& f, uint32_t j,
                                              int64_t i) {
  const uint32_t* packed = static_cast<const uint32_t*>(p.p);
  if (kFast || f.fast) {
    const uint32_t b = f.off0 + j * static_cast<uint32_t>(f.bw);
    const uint32_t last = static_cast<uint32_t>(p.n - 1);
    const uint32_t k = f.w0 + (b >> 5);
    const uint32_t lo = __ldg(packed + (k < last ? k : last));
    const uint32_t hi = __ldg(packed + (k + 1 < last ? k + 1 : last));
    return __funnelshift_r(lo, hi, b) & f.mask;
  }
  return zf_unpack_at(packed, p.n - 1, f.bw, 0u, i);
}

// A thread's accumulators, (L + 1) x S of them, accumulator j = l * S + q for
// lane l (the count last) of segment q: in registers with one segment (at
// most 32 of them), else a column in shared or global memory (the block's
// columns at `cols`), accumulator j at col[j * T].
template <int L, int S, int T>
struct ZfQgAcc {
  static constexpr int kAcc = (L + 1) * S;
  static constexpr bool kRegs = S == 1 && kAcc <= ZF_QG_REG_ACCS;
  float r[kRegs ? kAcc : 1];
  float* col;

  __device__ __forceinline__ explicit ZfQgAcc(float* cols) : col(cols + threadIdx.x) {
    if constexpr (kRegs) {
#pragma unroll
      for (int j = 0; j < kAcc; ++j) r[j] = 0.f;
    } else {
      for (int j = 0; j < kAcc; ++j) col[j * T] = 0.f;
    }
  }

  // w times each lane, and w, into segment seg (the row's key, in [0, S)).
  template <class... F>
  __device__ __forceinline__ void add(int32_t seg, float w, F... lanes) {
    static_assert(sizeof...(F) == L, "one value per lane");
    const float v[L + 1] = {__fmul_rn(lanes, w)..., w};
#pragma unroll
    for (int l = 0; l <= L; ++l) {
      if constexpr (kRegs) {
        r[l] = __fadd_rn(r[l], v[l]);
      } else {
        float* p = col + (l * S + seg) * T;
        *p = __fadd_rn(*p, v[l]);
      }
    }
  }

  __device__ __forceinline__ float get(int j) const {
    if constexpr (kRegs) return r[j];
    else return col[j * T];
  }
};

// The block's sum of value(j) over its threads, for each accumulator j, handed
// to done(j, sum) by thread j mod T: a shuffle tree in each warp, then the
// warps in order (a fixed order, so the same values give the same bits).
// wsum holds kAcc x T / 32 floats.
template <int T, int kAcc, class V, class D>
__device__ __forceinline__ void zf_qg_block_sum(float* wsum, V&& value, D&& done) {
  constexpr int W = T / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const auto warp_sum = [&](int j) {
    float x = value(j);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_down_sync(0xFFFFFFFFu, x, o));
    if (lane == 0) wsum[j * W + warp] = x;
  };
  if constexpr (kAcc <= 64) {   // unrolled: register accumulators stay registers
#pragma unroll
    for (int j = 0; j < kAcc; ++j) warp_sum(j);
  } else {
#pragma unroll 4
    for (int j = 0; j < kAcc; ++j) warp_sum(j);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kAcc; j += T) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) s = __fadd_rn(s, wsum[j * W + w]);
    done(j, s);
  }
}

// Where P's accumulators live and the dynamic shared memory a block takes:
// the columns (unless they are registers, or too large, then global memory),
// then the warp sums.
template <class P>
struct ZfQgLayout {
  static constexpr int T = ZF_QG_THREADS;
  using Acc = ZfQgAcc<P::kLanes, P::kSegments, T>;
  static constexpr int kAcc = Acc::kAcc;
  static constexpr size_t kCols = Acc::kRegs ? 0 : sizeof(float) * kAcc * T;
  static constexpr size_t kWsum = sizeof(float) * kAcc * (T / 32);
  static constexpr bool kGlobal = kCols + kWsum > ZF_QG_MAX_SMEM;
  static constexpr size_t kSmem = (kGlobal ? 0 : kCols) + kWsum;
  static_assert(kWsum <= ZF_QG_MAX_SMEM, "the warp sums must fit shared memory");
};

// The block's tiles of the launch, each row into `acc`; kFast: every field
// takes the 32-bit path (the launch-uniform check hoisted out of the rows).
template <class P, bool kFast, class Acc>
__device__ __forceinline__ void zf_qg_tiles(const ZfQgArgs& a, typename P::Fields& f,
                                            const typename P::Scalars& s, Acc& acc) {
  constexpr int64_t TILE = static_cast<int64_t>(ZF_QG_THREADS) * ZF_QG_ROWS;
  const int64_t step = static_cast<int64_t>(gridDim.x) * TILE;
  for (int64_t t0 = static_cast<int64_t>(blockIdx.x) * TILE; t0 < a.n; t0 += step) {
    const int64_t m = a.n - t0 < TILE ? a.n - t0 : TILE;
    P::at(a, f, t0);
#pragma unroll
    for (int r = 0; r < ZF_QG_ROWS; ++r) {
      const uint32_t j = threadIdx.x * ZF_QG_ROWS + r;
      if (j < m) P::template row<kFast>(a, f, s, j, t0 + j, acc);
    }
  }
}

// P is the generated ZfQgProgram: its sizes (kFields, kLanes, kSegments),
// its Fields and per-thread Scalars with init() and fast(), at() over its
// fields, and row().
template <class P>
__global__ void zf_qg_kernel(const __grid_constant__ ZfQgArgs a) {
  using Lay = ZfQgLayout<P>;
  constexpr int T = Lay::T;
  constexpr int kAcc = Lay::kAcc;
  static_assert(T % 32 == 0, "a block is whole warps");
  float* cols = Lay::kGlobal ? a.cols + static_cast<int64_t>(blockIdx.x) * kAcc * T
                             : zf_qg_smem;
  float* wsum = zf_qg_smem + (Lay::kGlobal ? 0 : Lay::kCols / sizeof(float));
  typename P::Fields f;
  typename P::Scalars s;
  P::init(a, f, s);
  typename Lay::Acc acc(cols);
  if (P::fast(f)) zf_qg_tiles<P, true>(a, f, s, acc);
  else zf_qg_tiles<P, false>(a, f, s, acc);
  zf_qg_block_sum<T, kAcc>(wsum, [&](int j) { return acc.get(j); }, [&](int j, float part) {
    a.partials[static_cast<int64_t>(blockIdx.x) * kAcc + j] = part;
  });
  __threadfence();
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(a.counter, 1u) == static_cast<uint32_t>(gridDim.x) - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: thread t sums blocks t, t + T, ... of each accumulator in
  // order, then the block sum -- the same order whichever block is last
  zf_qg_block_sum<T, kAcc>(wsum, [&](int j) {
    float x = 0.f;
    for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += T)
      x = __fadd_rn(x, __ldcg(&a.partials[static_cast<int64_t>(b) * kAcc + j]));
    return x;
  }, [&](int j, float tot) { a.out[j] = a.accumulate ? __fadd_rn(a.out[j], tot) : tot; });
  if (threadIdx.x == 0) *a.counter = 0u;
}

template <class P>
static cudaError_t zf_qg_launch(const ZfQgArgs& a, int32_t threads, int32_t device,
                                void* stream) {
  if (threads != ZF_QG_THREADS || a.n <= 0 || a.n_blocks < 1 || a.out == nullptr ||
      a.partials == nullptr || a.counter == nullptr || (ZfQgLayout<P>::kGlobal && a.cols == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(a.counter, 0, sizeof(uint32_t), s);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = ZfQgLayout<P>::kSmem;
  if constexpr (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(zf_qg_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  zf_qg_kernel<P><<<static_cast<unsigned>(a.n_blocks), ZF_QG_THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

// The most blocks of P that run at once on the device: its SMs times the
// blocks an SM holds at P's registers and shared memory (the wrapper's grid;
// one block per SM when the columns are in global memory, whose scratch
// grows with the grid), or a negative CUDA error.
template <class P>
static int zf_qg_max_blocks(int32_t device) {
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (ZfQgLayout<P>::kGlobal) return err == cudaSuccess ? sms : -static_cast<int>(err);
  constexpr size_t smem = ZfQgLayout<P>::kSmem;
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(zf_qg_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, zf_qg_kernel<P>,
                                                        ZF_QG_THREADS, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return per_sm * sms;
}

// The library's C interface for the program P: the launch, the grid's size,
// the preload of its kernel, and the helpers every library exports
// (kernels/cuda.py reads them).
#define ZF_QG_ENTRY(P)                                                                   \
  extern "C" int zf_query_gen(const ZfQgArgs* args, int32_t threads, int32_t device,    \
                              void* stream) {                                            \
    return static_cast<int>(zf_qg_launch<P>(*args, threads, device, stream));            \
  }                                                                                      \
  extern "C" int zf_max_blocks(int32_t device) { return zf_qg_max_blocks<P>(device); }   \
  extern "C" int zf_preload(int32_t device) {                                            \
    const cudaError_t err = cudaSetDevice(device);                                       \
    if (err != cudaSuccess) return static_cast<int>(err);                                \
    return static_cast<int>(zf_preload_all(zf_qg_kernel<P>));                            \
  }                                                                                      \
  ZF_EXPORT_HELPERS(ZfQgArgs)
