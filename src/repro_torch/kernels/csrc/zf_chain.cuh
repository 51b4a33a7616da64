// Op chains evaluated per element in registers: the device half of the port's
// "one definition, two backends" stage IR (repro_torch/core/patterns.py).  The
// plain PyTorch half is repro_torch/kernels/ref.py; the two must agree bit for bit.
//
// A chain is passed to a kernel by value as a small POD array of ops holding
// device pointers, so one build serves every chain.  Every register value is a
// 32-bit word; each op knows how it reads it (int32, uint32 or float32 bits).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define ZF_MAX_OPS 8

enum : int32_t { ZF_UNPACK = 0, ZF_LOAD = 1, ZF_GATHER = 2, ZF_I2F_DIV = 3, ZF_UNZIGZAG = 4 };
enum : int32_t { ZF_IDENTITY = 0, ZF_AFFINE = 1 };

struct ZfOp {
  int32_t kind;
  int32_t pad;
  int64_t n;        // element count of buffer a (packed words, table entries)
  const void* a;    // UNPACK: packed words; LOAD: buffer; GATHER: table; I2F_DIV: scale
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

// Bit-unpack element i (algos/bitpack.py).  The bit position is split as
// (i>>5)*bw + ((i&31)*bw)>>5 in 64 bits; shifts by 32 are undefined in C++, so
// off == 0 and bw >= 32 are selected explicitly, as the reference does.
__device__ __forceinline__ uint32_t zf_unpack(const ZfOp& op, int64_t i) {
  const uint32_t* packed = static_cast<const uint32_t*>(op.a);
  const int32_t bw = *static_cast<const int32_t*>(op.b);
  const uint32_t base = static_cast<uint32_t>(*static_cast<const int32_t*>(op.c));
  const int64_t frac = (i & 31) * static_cast<int64_t>(bw);
  const int64_t last = op.n - 1;
  int64_t w = (i >> 5) * static_cast<int64_t>(bw) + (frac >> 5);
  w = w < last ? w : last;
  const uint32_t off = static_cast<uint32_t>(frac & 31);
  const uint32_t lo = packed[w] >> off;
  const uint32_t hi = off == 0 ? 0u : packed[w + 1 < last ? w + 1 : last] << (32u - off);
  const uint32_t mask = bw >= 32 ? 0xFFFFFFFFu : ((1u << (bw & 31)) - 1u);
  return ((lo | hi) & mask) + base;  // int32 add, wrapping
}

__device__ __forceinline__ uint32_t zf_source(const ZfOp& op, int64_t i) {
  if (op.kind == ZF_UNPACK) return zf_unpack(op, i);
  return static_cast<const uint32_t*>(op.a)[i];  // ZF_LOAD
}

__device__ __forceinline__ uint32_t zf_transform(const ZfOp& op, uint32_t v) {
  switch (op.kind) {
    case ZF_GATHER: {
      // jnp indexing: a negative index wraps once, then the index is clamped
      int64_t j = static_cast<int32_t>(v);
      j = j < 0 ? j + op.n : j;
      j = j < 0 ? 0 : (j >= op.n ? op.n - 1 : j);
      return static_cast<const uint32_t*>(op.a)[j];
    }
    case ZF_I2F_DIV: {
      // correctly rounded int32 -> float32 and float32 divide (no fast math)
      const float x = __int2float_rn(static_cast<int32_t>(v));
      return __float_as_uint(__fdiv_rn(x, *static_cast<const float*>(op.a)));
    }
    case ZF_UNZIGZAG:
      return (v >> 1) ^ (0u - (v & 1u));
    default:
      return v;
  }
}

// Apply ops [first, n_ops) to v.  The loop is unrolled over the fixed bound so
// the op array is indexed statically and stays in the kernel's parameter space.
__device__ __forceinline__ uint32_t zf_transforms(const ZfChain& ch, int first, uint32_t v) {
#pragma unroll
  for (int k = 0; k < ZF_MAX_OPS; ++k) {
    if (k >= first && k < ch.n_ops) v = zf_transform(ch.ops[k], v);
  }
  return v;
}

__device__ __forceinline__ uint32_t zf_eval(const ZfChain& ch, int64_t i) {
  return zf_transforms(ch, 1, zf_source(ch.ops[0], i));
}
