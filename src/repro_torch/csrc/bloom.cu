// Blocked Bloom filter kernels for Hopper (sm_90a): hash_words and
// membership.  Plain C entry points, bound with ctypes by
// repro_torch/kernels/bloom_kernel.py; each launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError().
//
// hash_words replaces src/repro/kernels/bloom_kernel.py::hash_words
// (_words_kernel).  Item i's L u32 lanes (row stride ls) give k bit
// positions in one 64-bit block word by double hashing: h1 and h2 are
// the murmur3-finalized Horner mix of the lanes with seeds 1 and 2
// (h2 forced odd), bit i is (h1 + i*h2) mod 64 with the sum wrapping
// at 2**32 first -- the words the filter computes as
// bloom_words_ref(double_hash(lanes, k, 64)).  Native unsigned
// arithmetic wraps as the u32 math of the JAX package does.  One
// thread per item; out is (M, 2) [lo, hi].
// Bound: bytes -- L + 2 words per item against ~100 integer
// operations, far below the card's integer rate per byte.
//
// membership replaces bloom_kernel.py::membership (_member_kernel):
// already_present[i] = all bits of words[i] are set in prior[i], for a
// valid item.  One thread per item over two words and the valid byte.
// Bound: bytes (17 bytes in, 1 out per item).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kC1 = 0x85EBCA6Bu, kC2 = 0xC2B2AE35u, kPhi = 0x9E3779B9u;

__device__ __forceinline__ unsigned fmix32(unsigned h) {
  h ^= h >> 16;
  h *= kC1;
  h ^= h >> 13;
  h *= kC2;
  h ^= h >> 16;
  return h;
}

// repro.core.hashing.hash_lanes of one row of L lanes
__device__ __forceinline__ unsigned hash_lanes(const unsigned* row, int L, unsigned seed) {
  unsigned h = seed * kPhi + (unsigned)L;
  for (int i = 0; i < L; ++i) h = (h ^ fmix32(row[i])) * kC1 + (unsigned)(i + 1);
  return fmix32(h);
}

__global__ void hash_words_kernel(const unsigned* __restrict__ lanes, long long ls,
                                  long long m, int L, int k,
                                  unsigned* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const unsigned* row = lanes + i * ls;
  const unsigned h1 = hash_lanes(row, L, 1u);
  const unsigned h2 = hash_lanes(row, L, 2u) | 1u;
  unsigned lo = 0u, hi = 0u;
  for (int j = 0; j < k; ++j) {
    const unsigned bit = (h1 + (unsigned)j * h2) & 63u;   // % 64 of the wrapped sum
    if (bit < 32u)
      lo |= 1u << bit;
    else
      hi |= 1u << (bit - 32u);
  }
  out[2 * i] = lo;
  out[2 * i + 1] = hi;
}

__global__ void membership_kernel(const unsigned* __restrict__ prior,
                                  const unsigned* __restrict__ words,
                                  const unsigned char* __restrict__ valid, long long m,
                                  unsigned char* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const uint2 p = reinterpret_cast<const uint2*>(prior)[i];
  const uint2 w = reinterpret_cast<const uint2*>(words)[i];
  out[i] = (valid[i] != 0 && (p.x & w.x) == w.x && (p.y & w.y) == w.y) ? 1 : 0;
}

int ctas_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// lanes (m, >= L) u32 rows at stride ls; out (m, 2) u32.
int hash_words_launch(const void* lanes, long long ls, long long m, int L, int k,
                      void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m == 0) return (int)cudaGetLastError();
  hash_words_kernel<<<ctas_for(m), kThreads, 0, s>>>((const unsigned*)lanes, ls, m, L, k,
                                                     (unsigned*)out);
  return (int)cudaGetLastError();
}

// prior, words (m, 2) u32 contiguous (8-byte aligned rows); valid (m,) u8;
// out (m,) u8.
int membership_launch(const void* prior, const void* words, const void* valid,
                      long long m, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m == 0) return (int)cudaGetLastError();
  membership_kernel<<<ctas_for(m), kThreads, 0, s>>>(
      (const unsigned*)prior, (const unsigned*)words, (const unsigned char*)valid, m,
      (unsigned char*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
