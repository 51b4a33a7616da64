// Kernel 2: Group-Parallel (balanced 1->N) expansion.
//
// Replaces src/repro/kernels/group_parallel.py:51 group_parallel_call (Pallas, TPU).
// Output-centric: every thread produces whole output elements, so the work per
// block is the same whatever the group sizes (the paper's load balance, §4).
// For output i:
//   g   = upper_bound(presum, i) - 1      binary search over the whole presum
//   pos = i - presum[g]
//   v   = values[0](g)                    IDENTITY (RLE)
//       | values[0](g) + values[1](g)*pos AFFINE (DeltaStride), mod 2^32
//   out[i] = tail(v)
// Each value chain may hold an absorbed Fully-Parallel producer (fusion rule 2),
// e.g. bit-packed RLE values decoded right here, never materialized.
//
// Bound on this card: bytes (4 bytes written per element, the presum and value
// words read).  The search is log2(groups) dependent loads per element, but
// neighbouring threads follow the same path, so those loads hit L1/L2.  The
// reference's per-tile first-group scan and windowed search are a later
// optimization.
#include "zf_chain.cuh"

struct ZfGpArgs {
  const int32_t* presum;  // (n_groups + 1,), presum[0] = 0
  int64_t n_groups;
  ZfChain values[2];
  ZfChain tail;
  int32_t map_kind;       // ZF_IDENTITY (values[0] only) or ZF_AFFINE
  int32_t pad;
  uint32_t* out;
  int64_t n;
  int32_t L;
  int32_t C;
};

static_assert(sizeof(ZfGpArgs) == 1032, "ZfGpArgs layout is shared with kernels/cuda.py");

// First j in [0, len) with presum[j] > q, or len.
__device__ __forceinline__ int64_t zf_upper_bound(const int32_t* presum, int64_t len, int64_t q) {
  int64_t lo = 0, hi = len;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (static_cast<int64_t>(presum[mid]) <= q) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ uint32_t zf_expand(const ZfGpArgs& a, int64_t i) {
  int64_t g = zf_upper_bound(a.presum, a.n_groups + 1, i) - 1;
  g = g < 0 ? 0 : (g >= a.n_groups ? a.n_groups - 1 : g);
  const uint32_t pos = static_cast<uint32_t>(i - static_cast<int64_t>(a.presum[g]));
  uint32_t v = zf_eval(a.values[0], g);
  if (a.map_kind == ZF_AFFINE) v += zf_eval(a.values[1], g) * pos;  // uint32: wraps
  return zf_transforms(a.tail, 0, v);
}

__global__ void zf_group_parallel_kernel(const ZfGpArgs a) {
  const int64_t S = blockDim.x;
  const int64_t block0 = static_cast<int64_t>(blockIdx.x) * a.L * S * a.C;
  for (int l = 0; l < a.L; ++l) {
    const int64_t t0 = block0 + (static_cast<int64_t>(l) * S + threadIdx.x) * a.C;
    for (int c = 0; c < a.C; ++c) {
      const int64_t i = t0 + c;
      if (i < a.n) a.out[i] = zf_expand(a, i);
    }
  }
}

extern "C" int zf_group_parallel(const ZfGpArgs* args, int32_t threads, int32_t device,
                                 void* stream) {
  if (args->n <= 0) return 0;
  if (args->n_groups <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tile = static_cast<int64_t>(args->L) * threads * args->C;
  const int64_t grid = (args->n + tile - 1) / tile;
  if (grid > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidConfiguration);
  zf_group_parallel_kernel<<<static_cast<unsigned>(grid), threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int zf_args_size() { return static_cast<int>(sizeof(ZfGpArgs)); }

extern "C" const char* zf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
