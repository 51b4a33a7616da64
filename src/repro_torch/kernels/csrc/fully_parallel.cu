// Kernel 1: Fully-Parallel decode of one fused op chain.
//
// Replaces src/repro/kernels/fully_parallel.py:35 fully_parallel_call (Pallas, TPU).
// out[i] = chain(i) for i < n.  Launch geometry is the paper's <L,S,C> read the GPU
// way: grid = ceil(n / (L*S*C)) blocks of S threads; thread t of a block produces,
// in each of L main-loop iterations, C contiguous elements.  Threads past n write
// nothing, so the output is exactly (n,) (the TPU's padded tile has no counterpart).
//
// Bound on this card: bytes.  A chain does a handful of integer operations per
// element against 4 bytes written and up to 4 read, far below the H100's
// operations-per-byte balance point.  The design keeps every intermediate of a
// fused chain in registers (one read of the packed words, one write of the
// output), and with C = 1 neighbouring threads touch neighbouring words, so a
// warp's loads and stores coalesce.
#include "zf_chain.cuh"

struct ZfFpArgs {
  ZfChain chain;
  uint32_t* out;
  int64_t n;
  int32_t L;
  int32_t C;
};

static_assert(sizeof(ZfFpArgs) == 352, "ZfFpArgs layout is shared with kernels/cuda.py");

__global__ void zf_fully_parallel_kernel(const ZfFpArgs a) {
  const int64_t S = blockDim.x;
  const int64_t block0 = static_cast<int64_t>(blockIdx.x) * a.L * S * a.C;
  for (int l = 0; l < a.L; ++l) {
    const int64_t t0 = block0 + (static_cast<int64_t>(l) * S + threadIdx.x) * a.C;
    for (int c = 0; c < a.C; ++c) {
      const int64_t i = t0 + c;
      if (i < a.n) a.out[i] = zf_eval(a.chain, i);
    }
  }
}

extern "C" int zf_fully_parallel(const ZfFpArgs* args, int32_t threads, int32_t device,
                                 void* stream) {
  if (args->n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tile = static_cast<int64_t>(args->L) * threads * args->C;
  const int64_t grid = (args->n + tile - 1) / tile;
  if (grid > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidConfiguration);
  zf_fully_parallel_kernel<<<static_cast<unsigned>(grid), threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int zf_args_size() { return static_cast<int>(sizeof(ZfFpArgs)); }

extern "C" const char* zf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
