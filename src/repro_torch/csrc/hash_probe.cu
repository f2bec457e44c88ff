// Owner-side hash-table probe kernels for Hopper (sm_90a):
// insert_arrivals and find_arrivals.  Plain C entry points, bound with
// ctypes by repro_torch/kernels/hash_probe.py; each launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().
//
// Table layout (blocked open addressing, 32-bit words):
//   tkeys (nb, B, Lk), tvals (nb, B, Lv), status (nb, B); the low two
//   status bits are the bucket state (0 FREE, 2 READY), the rest are
//   read flags that the probe keeps.
// Arrival segment: rows of [local block | Lk key words | Lv value words]
// with row stride segw (a view of the exchange's owner segment).
//
// probe_block: one warp compares a key against the B slots of a block,
// 32 slots per step; __ballot_sync finds the first READY slot whose key
// words all match and the first FREE slot.  Shared by both kernels.
//
// insert_arrivals replaces src/repro/kernels/hash_probe.py::
// insert_arrivals (_insert_arrivals_kernel).  Tables must come out bit
// for bit as if the arrivals were inserted one at a time in arrival
// order (the TPU kernel's fori_loop over each block's queries), so each
// table block is owned by one warp that walks that block's arrivals in
// order: the CSR front end (a stable sort of arrivals by block, done in
// PyTorch as the JAX package does outside its kernel) hands each block
// a [start, end) range.  Blocks are independent, so no atomics.  There
// is no per-block query capacity: the TPU kernel fails arrivals past
// its q_cap, this kernel and the plain version serve them all.
// Bound: bytes -- the probe reads the touched blocks' keys and status
// and writes one slot per success; the out-of-place table copy that
// precedes it (the function returns a new table, as in JAX) moves the
// whole table twice and dominates.
//
// find_arrivals replaces src/repro/kernels/hash_probe.py::find_arrivals
// (_find_arrivals_kernel).  Order-free: one warp per query, no binning,
// so no q_cap and no overflow fallback.  The value is an exact integer
// gather of the first match's words.  Bound: bytes -- one block of keys
// and status per query, one value row per hit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kModeSet = 0, kModeAdd = 1;   // 2 = keep the first writer's value

struct Probe {
  int match;   // first READY slot holding the key, or B
  int free;    // first FREE slot, or B (meaningful only when match == B)
};

// The table pointers are not __restrict__: insert writes the same
// arrays that later probes of the same warp read.
__device__ __forceinline__ Probe probe_block(const int* tk, const int* st,
                                             long long blk, int B, int lk,
                                             const int* key, int lane) {
  Probe p{B, B};
  for (int c = 0; c < B; c += kWarp) {
    const int s = c + lane;
    bool hit = false, is_free = false;
    if (s < B) {
      const unsigned state = (unsigned)st[blk * B + s] & 3u;
      is_free = state == 0u;
      if (state == 2u) {
        const int* k = tk + (blk * B + s) * lk;
        hit = true;
        for (int l = 0; l < lk; ++l) hit = hit && (k[l] == key[l]);
      }
    }
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    const unsigned f = __ballot_sync(0xffffffffu, is_free);
    if (p.free == B && f) p.free = c + __ffs(f) - 1;
    if (m) {
      p.match = c + __ffs(m) - 1;
      break;
    }
  }
  return p;
}

__global__ void insert_arrivals_kernel(int* tk, int* tv, int* st,
                                       const int* __restrict__ seg, long long segw,
                                       const int* __restrict__ order,
                                       const int* __restrict__ start, long long nb,
                                       int B, int lk, int lv, int mode,
                                       unsigned char* __restrict__ ok) {
  const long long blk = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (blk >= nb) return;                    // uniform across the warp
  const int end = start[blk + 1];
  for (int j = start[blk]; j < end; ++j) {
    const long long q = order[j];
    const int* row = seg + q * segw;
    const Probe p = probe_block(tk, st, blk, B, lk, row + 1, lane);
    const bool has_match = p.match < B;
    const bool can = has_match || p.free < B;
    if (can) {
      const long long at = blk * B + (has_match ? p.match : p.free);
      if (lane < lk) tk[at * lk + lane] = row[1 + lane];
      if (lane < lv) {
        int* dst = tv + at * lv + lane;
        const int v = row[1 + lk + lane];
        if (!has_match || mode == kModeSet)
          *dst = v;
        else if (mode == kModeAdd)
          *dst = (int)((unsigned)*dst + (unsigned)v);   // wrapping u32 add
        // keep mode with a match: the first writer's value stays
      }
      if (lane == 0) st[at] = (int)(((unsigned)st[at] & ~3u) | 2u);
    }
    if (lane == 0) ok[q] = can ? 1 : 0;
    __syncwarp();                           // the next probe sees these writes
  }
}

__global__ void find_arrivals_kernel(const int* tk, const int* tv, const int* st,
                                     const int* __restrict__ seg, long long segw,
                                     const unsigned char* __restrict__ valid,
                                     long long m, long long nb, int B, int lk, int lv,
                                     unsigned char* __restrict__ found,
                                     int* __restrict__ vals) {
  const long long q = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (q >= m) return;                       // uniform across the warp
  const int* row = seg + q * segw;
  const long long blk = row[0];
  bool hit = false;
  long long at = 0;
  if (valid[q] && blk >= 0 && blk < nb) {   // uniform: one query per warp
    const Probe p = probe_block(tk, st, blk, B, lk, row + 1, lane);
    hit = p.match < B;
    at = blk * B + p.match;
  }
  if (lane < lv) vals[q * lv + lane] = hit ? tv[at * lv + lane] : 0;
  if (lane == 0) found[q] = hit ? 1 : 0;
}

int ctas_for_warps(long long warps) {
  return (int)((warps * kWarp + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Tables are updated in place (the wrapper passes fresh copies);
// order (m_valid,) i32 arrival rows sorted stably by block; start
// (nb + 1,) i32 CSR offsets into order; ok (m,) u8 zero-filled.
int insert_arrivals_launch(void* tk, void* tv, void* st, const void* seg,
                           long long segw, const void* order, const void* start,
                           long long nb, int B, int lk, int lv, int mode, void* ok,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nb == 0) return (int)cudaGetLastError();
  insert_arrivals_kernel<<<ctas_for_warps(nb), kThreads, 0, s>>>(
      (int*)tk, (int*)tv, (int*)st, (const int*)seg, segw, (const int*)order,
      (const int*)start, nb, B, lk, lv, mode, (unsigned char*)ok);
  return (int)cudaGetLastError();
}

// seg rows (m, >= 1 + lk) with row stride segw; valid (m,) u8;
// out found (m,) u8, vals (m, lv) i32.
int find_arrivals_launch(const void* tk, const void* tv, const void* st,
                         const void* seg, long long segw, const void* valid,
                         long long m, long long nb, int B, int lk, int lv, void* found,
                         void* vals, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m == 0) return (int)cudaGetLastError();
  find_arrivals_kernel<<<ctas_for_warps(m), kThreads, 0, s>>>(
      (const int*)tk, (const int*)tv, (const int*)st, (const int*)seg, segw,
      (const unsigned char*)valid, m, nb, B, lk, lv, (unsigned char*)found,
      (int*)vals);
  return (int)cudaGetLastError();
}

}  // extern "C"
