// Kernel 3: Non-Parallel interleaved rANS decode, one chunk per thread.
//
// Replaces src/repro/kernels/non_parallel.py:29 non_parallel_call (Pallas, TPU).
// The TPU kernel advances a (1, G) register of decoder states in lockstep, one
// chunk per VPU lane.  Here one thread owns one chunk (the paper's §4 / Fig. 11
// mapping) and runs its chunk_size dependent steps:
//   slot = x & 4095;  s = sym[slot]
//   x    = freq[s] * (x >> 12) + slot - cum[s]            (uint32, mod 2^32)
//   if (x < 2^16) x = x << 16 | streams[cur++, c]          (at most one word)
//   out[c*chunk_size + t] = tail(s)                         (only below n)
// streams[t, c] is chunk-transposed, so the threads of a warp that read their
// cur-th words read neighbouring uint16 whenever their cur agree.  Threads past
// n_chunks decode nothing; the last chunk stops at n, which changes no earlier
// symbol.  Geometry: S threads per block, C chunks per thread (one after the
// other), L such rounds; block b covers chunks [b*L*S*C, (b+1)*L*S*C).
//
// Bound on this card: by bytes it is tiny (for L_RETURNFLAG at SF 1 about 1.2 MB
// of stripes and 6 MB of symbols, a few microseconds at HBM rate).  In practice
// it is set by the serial chain of each chunk -- three dependent shared-memory
// lookups, a multiply and, every few symbols, a global load per step -- with
// only n_chunks threads in flight (1,466 for L_RETURNFLAG).  The design keeps
// the 5 KB of tables in shared memory (copied once per block), so the chain's
// lookups never touch L2, spreads the chunks over many small blocks so every
// SM holds some, and reads a stream word only when the state needs one.  Still
// open (ROADMAP): the byte stores of a warp are chunk_size bytes apart, and few
// chunks are in flight.
#include "zf_chain.cuh"

#define ZF_ANS_M 4096          // probability scale 2^12 (sym table entries)
#define ZF_ANS_SCALE_BITS 12
#define ZF_ANS_L (1u << 16)    // renormalisation bound

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

__global__ void zf_non_parallel_kernel(const ZfNpArgs a) {
  __shared__ uint8_t sym[ZF_ANS_M];
  __shared__ uint16_t freq[256];
  __shared__ uint16_t cum[256];
  for (int k = threadIdx.x; k < ZF_ANS_M; k += blockDim.x) sym[k] = a.sym[k];
  for (int k = threadIdx.x; k < 256; k += blockDim.x) {
    freq[k] = a.freq[k];
    cum[k] = a.cum[k];
  }
  __syncthreads();

  const int64_t S = blockDim.x;
  const int64_t block0 = static_cast<int64_t>(blockIdx.x) * a.L * S * a.C;
  const int64_t cap = a.max_words - 1;
  const bool has_tail = a.tail.n_ops > 0;
  for (int r = 0; r < a.L * a.C; ++r) {
    const int64_t c = block0 + r * S + threadIdx.x;
    if (c >= a.n_chunks) return;
    const int64_t first = c * a.chunk_size;
    const int64_t left = a.n - first;
    const int32_t steps = left < a.chunk_size ? static_cast<int32_t>(left) : a.chunk_size;
    const uint16_t* words = a.streams + c;
    uint32_t x = a.states[c];
    int64_t cur = 0;
    for (int32_t t = 0; t < steps; ++t) {
      const uint32_t slot = x & (ZF_ANS_M - 1);
      const uint32_t s = sym[slot];
      x = static_cast<uint32_t>(freq[s]) * (x >> ZF_ANS_SCALE_BITS) + slot - cum[s];
      if (x < ZF_ANS_L) {
        x = (x << 16) | words[(cur < cap ? cur : cap) * a.n_chunks];
        ++cur;
      }
      zf_write(a.out, a.out_width, first + t, has_tail ? zf_transforms(a.tail, 0, s) : s);
    }
  }
}

extern "C" int zf_non_parallel(const ZfNpArgs* args, int32_t threads, int32_t device,
                               void* stream) {
  if (args->n <= 0 || args->n_chunks <= 0) return 0;
  if (args->max_words <= 0 || args->chunk_size <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tile = static_cast<int64_t>(args->L) * threads * args->C;
  const int64_t grid = (args->n_chunks + tile - 1) / tile;
  if (grid > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidConfiguration);
  zf_non_parallel_kernel<<<static_cast<unsigned>(grid), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

ZF_EXPORT_HELPERS(ZfNpArgs)
