// Op chains evaluated per element in registers: the device half of the port's
// "one definition, two backends" stage IR (repro_torch/core/patterns.py).  The
// plain PyTorch half is repro_torch/kernels/ref.py; the two must agree bit for bit.
//
// A chain is passed to a kernel by value as a small POD array of ops holding
// device pointers, so one build serves every chain.  Every register value is a
// 32-bit word; each op knows how it reads it (int32, uint32 or float32 bits).
// Buffers hold 8-, 16- or 32-bit elements: an op's ``elem`` gives the width of
// its buffer ``a`` in bytes, negative for a signed narrow type, and a read
// zero- or sign-extends the element to a word.  An output of 1, 2 or 4 bytes
// per element takes the word's low bytes (``zf_write``, or 16 bytes at a time
// through ``zf_store_packed``).
#pragma once

#include <cstdint>
#include <initializer_list>
#include <cuda_runtime.h>

#define ZF_MAX_OPS 8

enum : int32_t {
  ZF_UNPACK = 0, ZF_LOAD = 1, ZF_GATHER = 2, ZF_I2F_DIV = 3, ZF_UNZIGZAG = 4,
  ZF_BYTES = 5, ZF_SPAN = 6
};
enum : int32_t { ZF_IDENTITY = 0, ZF_AFFINE = 1, ZF_STRGATHER = 2 };

struct ZfOp {
  int32_t kind;
  int16_t elem;     // element of buffer a: 1, 2 or 4 bytes; -1, -2 signed
  int16_t imm;      // BYTES: item size
  int64_t n;        // element count of buffer a (packed words, table entries)
  const void* a;    // UNPACK: packed words; LOAD: buffer; GATHER: table; I2F_DIV:
                    // scale; BYTES: bytes; SPAN: offsets
  const void* b;    // UNPACK: bit width operand (int32, (1,))
  const void* c;    // UNPACK: base operand (int32, (1,))
};

struct ZfChain {
  int32_t n_ops;
  int32_t pad;
  ZfOp ops[ZF_MAX_OPS];
};

static_assert(sizeof(ZfOp) == 40, "ZfOp layout is shared with kernels/cuda.py");
static_assert(sizeof(ZfChain) == 328, "ZfChain layout is shared with kernels/cuda.py");

// Element j of a buffer of `elem`-byte elements as a 32-bit word.
__device__ __forceinline__ uint32_t zf_read(const void* p, int32_t elem, int64_t j) {
  switch (elem) {
    case 1: return static_cast<const uint8_t*>(p)[j];
    case -1: return static_cast<uint32_t>(static_cast<int32_t>(static_cast<const int8_t*>(p)[j]));
    case 2: return static_cast<const uint16_t*>(p)[j];
    case -2: return static_cast<uint32_t>(static_cast<int32_t>(static_cast<const int16_t*>(p)[j]));
    default: return static_cast<const uint32_t*>(p)[j];
  }
}

// Store the low `width` bytes of v as element i.
__device__ __forceinline__ void zf_write(void* p, int32_t width, int64_t i, uint32_t v) {
  if (width == 1) static_cast<uint8_t*>(p)[i] = static_cast<uint8_t>(v);
  else if (width == 2) static_cast<uint16_t*>(p)[i] = static_cast<uint16_t>(v);
  else static_cast<uint32_t*>(p)[i] = v;
}

// jnp indexing into n entries: a negative index wraps once, then it is clamped.
__device__ __forceinline__ int64_t zf_jnp_index(int64_t j, int64_t n) {
  j = j < 0 ? j + n : j;
  return j < 0 ? 0 : (j >= n ? n - 1 : j);
}

// Bit-unpack element i (algos/bitpack.py) of `packed` (last + 1 words), its bit
// width and base given.  The bit position is split as (i>>5)*bw + ((i&31)*bw)>>5
// in 64 bits; shifts by 32 are undefined in C++, so off == 0 and bw >= 32 are
// selected explicitly, as the reference does.
__device__ __forceinline__ uint32_t zf_unpack_at(const uint32_t* packed, int64_t last,
                                                 int32_t bw, uint32_t base, int64_t i) {
  const int64_t frac = (i & 31) * static_cast<int64_t>(bw);
  int64_t w = (i >> 5) * static_cast<int64_t>(bw) + (frac >> 5);
  w = w < last ? w : last;
  const uint32_t off = static_cast<uint32_t>(frac & 31);
  const uint32_t lo = packed[w] >> off;
  const uint32_t hi = off == 0 ? 0u : packed[w + 1 < last ? w + 1 : last] << (32u - off);
  const uint32_t mask = bw >= 32 ? 0xFFFFFFFFu : ((1u << (bw & 31)) - 1u);
  return ((lo | hi) & mask) + base;  // int32 add, wrapping
}

// The same with the bit width and base read from the op's device scalars.
__device__ __forceinline__ uint32_t zf_unpack(const ZfOp& op, int64_t i) {
  return zf_unpack_at(static_cast<const uint32_t*>(op.a), op.n - 1,
                      *static_cast<const int32_t*>(op.b),
                      static_cast<uint32_t>(*static_cast<const int32_t*>(op.c)), i);
}

// Item i of a byte buffer, little-endian: bytes past the fourth would shift out
// of the word (the reference's uint32 shifts give 0), so they are not read.
__device__ __forceinline__ uint32_t zf_bytes(const ZfOp& op, int64_t i) {
  const uint8_t* b = static_cast<const uint8_t*>(op.a) + i * op.imm;
  const int k_end = op.imm < 4 ? op.imm : 4;
  uint32_t v = 0;
  for (int k = 0; k < k_end; ++k) v |= static_cast<uint32_t>(b[k]) << (8 * k);
  return v;
}

__device__ __forceinline__ uint32_t zf_source(const ZfOp& op, int64_t i) {
  if (op.kind == ZF_UNPACK) return zf_unpack(op, i);
  if (op.kind == ZF_BYTES) return zf_bytes(op, i);
  return zf_read(op.a, op.elem, i);  // ZF_LOAD
}

// `scale()` gives an I2F_DIV op's divisor: kernels 2 and 3 read it from the
// op's scalar at each use, kernel 1 passes the value it read once.
template <class Scale>
__device__ __forceinline__ uint32_t zf_transform(const ZfOp& op, uint32_t v, Scale&& scale) {
  switch (op.kind) {
    case ZF_GATHER:
      return zf_read(op.a, op.elem, zf_jnp_index(static_cast<int32_t>(v), op.n));
    case ZF_SPAN: {
      // offs[v+1] - offs[v]; the index is int32, so v + 1 wraps as in the reference
      const int64_t hi = zf_jnp_index(static_cast<int32_t>(v + 1u), op.n);
      const int64_t lo = zf_jnp_index(static_cast<int32_t>(v), op.n);
      return zf_read(op.a, op.elem, hi) - zf_read(op.a, op.elem, lo);
    }
    case ZF_I2F_DIV: {
      // correctly rounded int32 -> float32 and float32 divide (no fast math)
      const float x = __int2float_rn(static_cast<int32_t>(v));
      return __float_as_uint(__fdiv_rn(x, scale()));
    }
    case ZF_UNZIGZAG:
      return (v >> 1) ^ (0u - (v & 1u));
    default:
      return v;
  }
}

// Apply ops [first, n_ops) to v; `scale(k)` is op k's I2F_DIV divisor.  The
// loop is unrolled over the fixed bound so the op array is indexed statically
// and stays in the kernel's parameter space.
template <class Scale>
__device__ __forceinline__ uint32_t zf_transforms(const ZfChain& ch, int first, uint32_t v,
                                                  Scale&& scale) {
#pragma unroll
  for (int k = 0; k < ZF_MAX_OPS; ++k) {
    if (k >= first && k < ch.n_ops) v = zf_transform(ch.ops[k], v, [&] { return scale(k); });
  }
  return v;
}

__device__ __forceinline__ uint32_t zf_transforms(const ZfChain& ch, int first, uint32_t v) {
  return zf_transforms(ch, first, v,
                       [&](int k) { return *static_cast<const float*>(ch.ops[k].a); });
}

// zf_transforms over K values at once, op by op, so that the K values' loads
// (a GATHER's, a SPAN's) are in flight together.
template <int K, class Scale>
__device__ __forceinline__ void zf_transforms_k(const ZfChain& ch, int first, uint32_t (&v)[K],
                                                Scale&& scale) {
#pragma unroll
  for (int k = 0; k < ZF_MAX_OPS; ++k) {
    if (k >= first && k < ch.n_ops) {
#pragma unroll
      for (int j = 0; j < K; ++j) v[j] = zf_transform(ch.ops[k], v[j], [&] { return scale(k); });
    }
  }
}

__device__ __forceinline__ uint32_t zf_eval(const ZfChain& ch, int64_t i) {
  return zf_transforms(ch, 1, zf_source(ch.ops[0], i));
}

// Element type of a W-byte output.
template <int W> struct ZfOut;
template <> struct ZfOut<1> { using T = uint8_t; };
template <> struct ZfOut<2> { using T = uint16_t; };
template <> struct ZfOut<4> { using T = uint32_t; };

// Shift the low W bytes of v into the top of a 16-byte accumulator, so that
// after 16 / W shifts acc holds the outputs in address order (no dynamic
// register indexing, so the loop need not be unrolled).
template <int W>
__device__ __forceinline__ void zf_shift_in(uint4& acc, uint32_t v) {
  if (W == 4) {
    acc = make_uint4(acc.y, acc.z, acc.w, v);
  } else {
    constexpr int B = 8 * W;
    const uint32_t top = W == 1 ? v << 24 : v << 16;
    acc = make_uint4(acc.x >> B | acc.y << (32 - B), acc.y >> B | acc.z << (32 - B),
                     acc.z >> B | acc.w << (32 - B), acc.w >> B | top);
  }
}

// Place output j (of 16 / W) of a 16-byte group into its word: static
// indices only, so w stays in registers.
template <int W>
__device__ __forceinline__ void zf_pack(uint32_t (&w)[4], int j, uint32_t v) {
  if (W == 1) w[j >> 2] |= (v & 0xFFu) << (8 * (j & 3));
  else if (W == 2) w[j >> 1] |= (v & 0xFFFFu) << (16 * (j & 1));
  else w[j] = v;
}

// Store n outputs of `next()` at o: element by element up to the first 16-byte
// boundary and after the last one, 16-byte stores between.  kUnroll unrolls
// each 16-byte group (straight-line code the scheduler can overlap); without
// it `next` has one call site, so a large body (a tail chain) is compiled once.
template <int W, bool kUnroll, class Next>
__device__ __forceinline__ void zf_store_packed(typename ZfOut<W>::T* o, int64_t n,
                                                Next&& next) {
  using T = typename ZfOut<W>::T;
  constexpr int K = 16 / W;
  int64_t head = static_cast<int64_t>(((16u - (reinterpret_cast<uintptr_t>(o) & 15u)) & 15u) / W);
  head = head < n ? head : n;
  const int64_t vend = head + (n - head) / K * K;
  if (kUnroll) {
    int64_t c = 0;
    for (; c < head; ++c) o[c] = static_cast<T>(next());
    for (; c < vend; c += K) {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < K; ++j) zf_pack<W>(w, j, next());
      *reinterpret_cast<uint4*>(o + c) = make_uint4(w[0], w[1], w[2], w[3]);
    }
    for (; c < n; ++c) o[c] = static_cast<T>(next());
    return;
  }
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  for (int64_t c = 0; c < n; ++c) {
    const uint32_t v = next();
    if (c < head || c >= vend) {
      o[c] = static_cast<T>(v);
    } else {
      zf_shift_in<W>(acc, v);
      if ((c - head) % K == K - 1) *reinterpret_cast<uint4*>(o + c + 1 - K) = acc;
    }
  }
}

// The error helpers every library exports (kernels/cuda.py reads them).
// Loads kernels' code on the current device now: under CUDA's lazy module
// loading each kernel is otherwise loaded at its first launch, inside a run.
template <class... F>
static cudaError_t zf_preload_all(F*... fns) {
  cudaError_t first = cudaSuccess;
  for (const void* fn : {reinterpret_cast<const void*>(fns)...}) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (first == cudaSuccess) first = err;
  }
  return first;
}

#define ZF_EXPORT_HELPERS(ArgsType)                                             \
  extern "C" int zf_args_size() { return static_cast<int>(sizeof(ArgsType)); } \
  extern "C" const char* zf_error_string(int err) {                            \
    return cudaGetErrorString(static_cast<cudaError_t>(err));                  \
  }
