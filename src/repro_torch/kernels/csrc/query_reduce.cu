// Kernel 4: a fused query's decode, filter and aggregate in one launch.
//
// No TPU kernel corresponds: the reference runs its terminal Reduce under XLA
// jit (src/repro/core/compiler.py:204 compile_query_chunk_graph), which fuses
// the decode chains into the reduction.  This kernel is the port's counterpart
// of that fusion.  One launch covers the items [out_start, out_start + n) of one
// chunk; per item a thread
//  - evaluates each role's op chain (zf_chain.cuh, plus UNPACK_RAW and RANGE
//    for compressed-domain masks) at the chunk-local index, or a resident
//    column's at the global one, and converts it to the role's type;
//  - ANDs the mask roles and the predicates into the row's selection, as
//    float32 times any weight role (RLE run lengths): the weight w;
//  - runs the expression program (the lanes and the group key, compiled from
//    the query's expression trees by kernels/query_reduce.py) over a small
//    register file, in float32 or 8/16/32-bit integers as the reference's
//    types say;
//  - adds w * lane, and w, into its own column of a shared accumulator of
//    (lanes + 1) x segments floats (a key outside [0, segments) drops the row).
// Then each block sums its threads' accumulators as a tree and writes its
// partials; the last block to finish (an integer atomic counter, zeroed by the
// entry before the launch) sums the blocks' partials in a fixed order and
// writes, or adds to, the output.  No float atomics: the sums' order, and so
// the result, is the same in every run.  Float arithmetic uses the _rn
// intrinsics (no contraction into FMA, no fast math), so each row's values are
// those of the plain version (kernels/ref.py query_reduce_torch); only the
// order of the sums differs.
//
// What bounds it on this card: bytes.  Every item reads its packed fields
// (Q6 at SF 1: ~46 bits a row) and writes nothing; the decoded columns never
// reach device memory.  The query is interpreted (roles, predicates and the
// program are loops over the __grid_constant__ argument struct, read from the
// parameter space), so the kernel spends a few hundred instructions an item
// on interpretation; a simple kernel that is right comes first.
#include "zf_chain.cuh"

#define ZF_QR_MAX_ROLES 12
#define ZF_QR_MAX_ROLE_OPS 4
#define ZF_QR_MAX_PREDS 16
#define ZF_QR_MAX_INSTRS 48
#define ZF_QR_MAX_REGS 32
#define ZF_QR_MAX_LANES 16
#define ZF_QR_MAX_ACC 64          // (lanes + 1) x segments
#define ZF_QR_MAX_THREADS 256

enum : int8_t { ZF_QR_VALUE = 0, ZF_QR_MASK = 1, ZF_QR_WEIGHT = 2 };
// value types: float32, or an integer of 1, 2 or 4 bytes (negative: signed);
// a register holds a float's bits or an integer sign- or zero-extended to 32 bits
enum : int8_t { ZF_QT_F32 = 0 };
enum : int8_t { ZF_QI_CONST = 0, ZF_QI_CAST = 1, ZF_QI_ADD = 2, ZF_QI_SUB = 3,
                ZF_QI_MUL = 4, ZF_QI_MOD = 5 };
enum : int8_t { ZF_QP_LT = 0, ZF_QP_LE = 1, ZF_QP_GE = 2, ZF_QP_GT = 3 };
// predicate modes: integers in 64 bits; floats; an integer register as float32
enum : int8_t { ZF_QM_INT = 0, ZF_QM_FLOAT = 1, ZF_QM_INT_AS_FLOAT = 2 };

struct ZfQRole {
  int32_t n_ops;
  int8_t kind;       // ZF_QR_VALUE, ZF_QR_MASK or ZF_QR_WEIGHT
  int8_t row;        // 1: read at the global index out_start + i (a resident column)
  int8_t from;       // the chain's type
  int8_t type;       // the role's type (the chain's word converted to it)
  ZfOp ops[ZF_QR_MAX_ROLE_OPS];
};

struct ZfQPred {
  int8_t reg;
  int8_t cmp;
  int8_t mode;
  int8_t pad[5];
  int64_t value;     // an integer, or a float32's bits in the low word
};

struct ZfQInstr {
  int8_t op;
  int8_t type;       // the result's type
  int8_t dst;
  int8_t a;
  int8_t b;
  int8_t from;       // CAST: the operand's type
  int8_t pad[2];
  int64_t imm;       // CONST: the value's word in the low 32 bits
};

struct ZfQArgs {
  ZfQRole roles[ZF_QR_MAX_ROLES];
  ZfQPred preds[ZF_QR_MAX_PREDS];
  ZfQInstr prog[ZF_QR_MAX_INSTRS];
  int8_t lane_reg[ZF_QR_MAX_LANES];   // float32 registers of the lanes (not the count)
  int32_t n_roles;
  int32_t n_preds;
  int32_t n_instrs;
  int32_t n_lanes;        // aggregates; the count lane is one more
  int32_t n_segments;
  int32_t key_reg;        // int32 register of the segment key, -1 for none
  int32_t accumulate;     // 1: add the totals to out, 0: write them
  int32_t n_blocks;       // the grid; partials holds n_blocks x accumulators
  int64_t n;              // items of this launch
  int64_t out_start;      // global index of its first item
  float* out;             // (lanes + 1) x segments, lane-major
  float* partials;
  uint32_t* counter;
};

static_assert(sizeof(ZfQRole) == 168, "ZfQRole layout is shared with kernels/cuda.py");
static_assert(sizeof(ZfQPred) == 16, "ZfQPred layout is shared with kernels/cuda.py");
static_assert(sizeof(ZfQInstr) == 16, "ZfQInstr layout is shared with kernels/cuda.py");
static_assert(sizeof(ZfQArgs) == 3128, "ZfQArgs layout is shared with kernels/cuda.py");
static_assert(sizeof(ZfQArgs) <= 4096, "the arguments must fit the 4 KB kernel parameter space");

// An integer's 32-bit register value as an integer of type t.
__device__ __forceinline__ uint32_t zf_q_wrap(uint32_t v, int8_t t) {
  switch (t) {
    case 1: return v & 0xFFu;
    case -1: return static_cast<uint32_t>(static_cast<int32_t>(static_cast<int8_t>(v)));
    case 2: return v & 0xFFFFu;
    case -2: return static_cast<uint32_t>(static_cast<int32_t>(static_cast<int16_t>(v)));
    default: return v;
  }
}

// A register of type `from` converted to type `to` (torch's .to(): ints wrap,
// int -> float rounds to nearest, float -> int truncates).
__device__ __forceinline__ uint32_t zf_q_cast(uint32_t v, int8_t from, int8_t to) {
  if (from == to) return v;
  if (to == ZF_QT_F32) return __float_as_uint(__int2float_rn(static_cast<int32_t>(v)));
  if (from == ZF_QT_F32) return zf_q_wrap(static_cast<uint32_t>(__float2int_rz(__uint_as_float(v))), to);
  return zf_q_wrap(v, to);
}

__device__ __forceinline__ uint32_t zf_q_source(const ZfOp& op, int64_t i) {
  return op.kind == ZF_UNPACK_RAW ? zf_unpack_raw(op, i) : zf_source(op, i);
}

__device__ __forceinline__ uint32_t zf_q_transform(const ZfOp& op, uint32_t v) {
  if (op.kind == ZF_RANGE) return zf_range(op, v);
  return zf_transform(op, v, [&] { return *static_cast<const float*>(op.a); });
}

// Floor modulo (the sign of the divisor), as jnp and torch.remainder give it.
__device__ __forceinline__ int32_t zf_q_imod(int32_t x, int32_t y) {
  if (y == 0) return x;          // XLA's integer remainder by zero
  if (y == -1) return 0;         // INT_MIN % -1 would overflow
  const int32_t r = x % y;
  return (r != 0 && ((r < 0) != (y < 0))) ? r + y : r;
}

__device__ __forceinline__ float zf_q_fmod(float x, float y) {
  const float r = fmodf(x, y);
  return (r != 0.f && ((r < 0.f) != (y < 0.f))) ? r + y : r;
}

__device__ __forceinline__ uint32_t zf_q_binary(int8_t op, int8_t t, uint32_t x, uint32_t y) {
  if (t == ZF_QT_F32) {
    const float a = __uint_as_float(x), b = __uint_as_float(y);
    switch (op) {
      case ZF_QI_ADD: return __float_as_uint(__fadd_rn(a, b));
      case ZF_QI_SUB: return __float_as_uint(__fsub_rn(a, b));
      case ZF_QI_MUL: return __float_as_uint(__fmul_rn(a, b));
      default: return __float_as_uint(zf_q_fmod(a, b));
    }
  }
  switch (op) {   // integers wrap: computed on the 32-bit words, then narrowed
    case ZF_QI_ADD: return zf_q_wrap(x + y, t);
    case ZF_QI_SUB: return zf_q_wrap(x - y, t);
    case ZF_QI_MUL: return zf_q_wrap(x * y, t);
    default:
      return zf_q_wrap(static_cast<uint32_t>(
          zf_q_imod(static_cast<int32_t>(x), static_cast<int32_t>(y))), t);
  }
}

__device__ __forceinline__ bool zf_q_test(const ZfQPred& p, uint32_t v) {
  if (p.mode == ZF_QM_INT) {
    const int64_t x = static_cast<int32_t>(v);
    switch (p.cmp) {
      case ZF_QP_LT: return x < p.value;
      case ZF_QP_LE: return x <= p.value;
      case ZF_QP_GE: return x >= p.value;
      default: return x > p.value;
    }
  }
  const float x = p.mode == ZF_QM_FLOAT ? __uint_as_float(v)
                                        : __int2float_rn(static_cast<int32_t>(v));
  const float c = __uint_as_float(static_cast<uint32_t>(p.value));
  switch (p.cmp) {
    case ZF_QP_LT: return x < c;
    case ZF_QP_LE: return x <= c;
    case ZF_QP_GE: return x >= c;
    default: return x > c;
  }
}

// Tree sum of each accumulator's column of blockDim.x values (a power of two).
__device__ __forceinline__ void zf_q_block_sum(float* acc, int n_acc) {
  const int t = threadIdx.x, T = blockDim.x;
  for (int s = T >> 1; s > 0; s >>= 1) {
    if (t < s)
      for (int j = 0; j < n_acc; ++j) acc[j * T + t] += acc[j * T + t + s];
    __syncthreads();
  }
}

__global__ void zf_query_reduce_kernel(const __grid_constant__ ZfQArgs a) {
  extern __shared__ float acc[];     // accumulator j of thread t at acc[j * T + t]
  const int t = threadIdx.x, T = blockDim.x;
  const int S = a.n_segments;
  const int n_acc = (a.n_lanes + 1) * S;
  for (int j = 0; j < n_acc; ++j) acc[j * T + t] = 0.f;
  const int64_t stride = static_cast<int64_t>(a.n_blocks) * T;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * T + t; i < a.n; i += stride) {
    uint32_t r[ZF_QR_MAX_REGS];
    bool keep = true;
    bool weighted = false;
    float wt = 1.f;
    for (int k = 0; k < a.n_roles; ++k) {
      const ZfQRole& ro = a.roles[k];
      uint32_t v = zf_q_source(ro.ops[0], ro.row ? a.out_start + i : i);
      for (int o = 1; o < ro.n_ops; ++o) v = zf_q_transform(ro.ops[o], v);
      v = zf_q_cast(v, ro.from, ro.type);
      r[k] = v;
      if (ro.kind == ZF_QR_MASK) {
        keep = keep && v != 0u;
      } else if (ro.kind == ZF_QR_WEIGHT) {
        const float f = __uint_as_float(zf_q_cast(v, ro.type, ZF_QT_F32));
        wt = weighted ? __fmul_rn(wt, f) : f;
        weighted = true;
      }
    }
    for (int k = 0; k < a.n_preds; ++k) keep = keep && zf_q_test(a.preds[k], r[a.preds[k].reg]);
    for (int k = 0; k < a.n_instrs; ++k) {
      const ZfQInstr& in = a.prog[k];
      uint32_t v;
      if (in.op == ZF_QI_CONST) v = static_cast<uint32_t>(in.imm);
      else if (in.op == ZF_QI_CAST) v = zf_q_cast(r[in.a], in.from, in.type);
      else v = zf_q_binary(in.op, in.type, r[in.a], r[in.b]);
      r[in.dst] = v;
    }
    float w = keep ? 1.f : 0.f;
    if (weighted) w = __fmul_rn(w, wt);
    int seg = 0;
    if (a.key_reg >= 0) {
      seg = static_cast<int32_t>(r[a.key_reg]);
      if (seg < 0 || seg >= S) continue;     // segment_sum drops the row
    }
    for (int l = 0; l < a.n_lanes; ++l)
      acc[(l * S + seg) * T + t] += __fmul_rn(__uint_as_float(r[a.lane_reg[l]]), w);
    acc[(a.n_lanes * S + seg) * T + t] += w;
  }
  __syncthreads();
  zf_q_block_sum(acc, n_acc);
  for (int j = t; j < n_acc; j += T)
    a.partials[static_cast<int64_t>(blockIdx.x) * n_acc + j] = acc[j * T];
  __threadfence();
  __shared__ bool last;
  __syncthreads();
  if (t == 0) last = atomicAdd(a.counter, 1u) == static_cast<uint32_t>(gridDim.x) - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: thread t sums blocks t, t + T, ... of each accumulator in
  // order, then a tree over the threads -- the same order whichever block is last
  for (int j = 0; j < n_acc; ++j) {
    float s = 0.f;
    for (int b = t; b < a.n_blocks; b += T) s += __ldcg(&a.partials[static_cast<int64_t>(b) * n_acc + j]);
    acc[j * T + t] = s;
  }
  __syncthreads();
  zf_q_block_sum(acc, n_acc);
  for (int j = t; j < n_acc; j += T) a.out[j] = a.accumulate ? a.out[j] + acc[j * T] : acc[j * T];
  if (t == 0) *a.counter = 0u;
}

static bool zf_q_valid(const ZfQArgs& a, int32_t threads) {
  if (threads < 32 || threads > ZF_QR_MAX_THREADS || (threads & (threads - 1)) != 0) return false;
  if (a.n <= 0 || a.n_blocks < 1 || a.n_segments < 1 || a.n_lanes < 0 ||
      a.n_lanes > ZF_QR_MAX_LANES || (a.n_lanes + 1) * a.n_segments > ZF_QR_MAX_ACC)
    return false;
  if (a.n_roles < 1 || a.n_roles > ZF_QR_MAX_ROLES || a.n_preds < 0 ||
      a.n_preds > ZF_QR_MAX_PREDS || a.n_instrs < 0 || a.n_instrs > ZF_QR_MAX_INSTRS ||
      a.key_reg >= ZF_QR_MAX_REGS)
    return false;
  for (int k = 0; k < a.n_roles; ++k)
    if (a.roles[k].n_ops < 1 || a.roles[k].n_ops > ZF_QR_MAX_ROLE_OPS) return false;
  for (int k = 0; k < a.n_preds; ++k)
    if (a.preds[k].reg < 0 || a.preds[k].reg >= a.n_roles) return false;
  for (int k = 0; k < a.n_instrs; ++k) {
    const ZfQInstr& in = a.prog[k];
    if (in.dst < a.n_roles || in.dst >= ZF_QR_MAX_REGS || in.a < 0 || in.a >= ZF_QR_MAX_REGS ||
        in.b < 0 || in.b >= ZF_QR_MAX_REGS)
      return false;
  }
  for (int l = 0; l < a.n_lanes; ++l)
    if (a.lane_reg[l] < 0 || a.lane_reg[l] >= ZF_QR_MAX_REGS) return false;
  return a.out != nullptr && a.partials != nullptr && a.counter != nullptr;
}

extern "C" int zf_query_reduce(const ZfQArgs* args, int32_t threads, int32_t device,
                               void* stream) {
  if (!zf_q_valid(*args, threads)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(args->counter, 0, sizeof(uint32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>((args->n_lanes + 1) * args->n_segments) * threads *
                      sizeof(float);
  zf_query_reduce_kernel<<<static_cast<unsigned>(args->n_blocks), threads, smem, s>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int zf_preload(int32_t device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(zf_preload_all(zf_query_reduce_kernel));
}

ZF_EXPORT_HELPERS(ZfQArgs)
