// Owner-side hash-table probe kernels for Hopper (sm_90a): the arrival
// front ends insert_arrivals / find_arrivals and the column front ends
// insert / find.  Plain C entry points, bound with ctypes by
// repro_torch/kernels/hash_probe.py; each launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError().
//
// Table layout (blocked open addressing, 32-bit words):
//   tkeys (nb, B, Lk), tvals (nb, B, Lv), status (nb, B); the low two
//   status bits are the bucket state (0 FREE, 2 READY), the rest are
//   read flags that the probe keeps.
// Arrival segment: rows of [local block | Lk key words | Lv value words]
// with row stride segw (a view of the exchange's owner segment).
// Columns: qblock (M,), qkeys (M, Lk) and qvals (M, Lv), each at its own
// row stride, qvalid (M,) u8.  Both front ends feed the same warp
// routines with a key (and value) pointer and a row stride, so the
// column kernels read the caller's arrays in place: no segment is
// assembled first.
//
// probe_block: one warp compares a key against the B slots of a block,
// 32 slots per step; __ballot_sync finds the first READY slot whose key
// words all match and the first FREE slot.  Shared by all four kernels.
//
// insert_arrivals replaces src/repro/kernels/hash_probe.py::
// insert_arrivals (_insert_arrivals_kernel), insert replaces
// hash_probe.py::insert (_insert_kernel).  Tables must come out bit for
// bit as if the items were inserted one at a time in batch order (the
// TPU kernels' fori_loop over each block's queries), so each table
// block is owned by one warp that walks that block's items in order:
// the CSR front end (a stable sort of items by block, done in PyTorch
// as the JAX package does outside its kernel) hands each block a
// [start, end) range.  Blocks are independent, so no atomics.  There is
// no per-block query capacity: the TPU kernels fail items past their
// q_cap, these kernels and the plain versions serve them all.
// Bound: bytes -- the probe reads the touched blocks' keys and status
// and writes one slot per success; the out-of-place table copy that
// precedes it (the function returns a new table, as in JAX) moves the
// whole table twice and dominates.
//
// find_arrivals replaces hash_probe.py::find_arrivals
// (_find_arrivals_kernel), find replaces hash_probe.py::find
// (_find_kernel).  Order-free: one warp per query, no binning, so no
// q_cap and no overflow fallback.  The value is an exact integer
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

// Walk table block blk's items in batch order; item q's key words are
// keys[q * ks : + lk], its value words vals[q * vs : + lv].
__device__ __forceinline__ void insert_block(int* tk, int* tv, int* st, long long blk,
                                             const int* __restrict__ keys, long long ks,
                                             const int* __restrict__ vals, long long vs,
                                             const int* __restrict__ order, int begin,
                                             int end, int B, int lk, int lv, int mode,
                                             unsigned char* __restrict__ ok, int lane) {
  for (int j = begin; j < end; ++j) {
    const long long q = order[j];
    const int* key = keys + q * ks;
    const Probe p = probe_block(tk, st, blk, B, lk, key, lane);
    const bool has_match = p.match < B;
    const bool can = has_match || p.free < B;
    if (can) {
      const long long at = blk * B + (has_match ? p.match : p.free);
      if (lane < lk) tk[at * lk + lane] = key[lane];
      if (lane < lv) {
        int* dst = tv + at * lv + lane;
        const int v = vals[q * vs + lane];
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

// One query per warp: found flag and value words of query q in block blk
// (a block outside [0, nb) finds nothing).
__device__ __forceinline__ void find_one(const int* tk, const int* tv, const int* st,
                                         long long q, bool live, long long blk,
                                         const int* key, long long nb, int B, int lk,
                                         int lv, unsigned char* __restrict__ found,
                                         int* __restrict__ vals, int lane) {
  bool hit = false;
  long long at = 0;
  if (live && blk >= 0 && blk < nb) {       // uniform: one query per warp
    const Probe p = probe_block(tk, st, blk, B, lk, key, lane);
    hit = p.match < B;
    at = blk * B + p.match;
  }
  if (lane < lv) vals[q * lv + lane] = hit ? tv[at * lv + lane] : 0;
  if (lane == 0) found[q] = hit ? 1 : 0;
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
  insert_block(tk, tv, st, blk, seg + 1, segw, seg + 1 + lk, segw, order, start[blk],
               start[blk + 1], B, lk, lv, mode, ok, lane);
}

__global__ void insert_kernel(int* tk, int* tv, int* st,
                              const int* __restrict__ qkeys, long long ks,
                              const int* __restrict__ qvals, long long vs,
                              const int* __restrict__ order,
                              const int* __restrict__ start, long long nb, int B,
                              int lk, int lv, int mode, unsigned char* __restrict__ ok) {
  const long long blk = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (blk >= nb) return;                    // uniform across the warp
  insert_block(tk, tv, st, blk, qkeys, ks, qvals, vs, order, start[blk], start[blk + 1],
               B, lk, lv, mode, ok, lane);
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
  find_one(tk, tv, st, q, valid[q] != 0, row[0], row + 1, nb, B, lk, lv, found, vals,
           lane);
}

__global__ void find_kernel(const int* tk, const int* tv, const int* st,
                            const int* __restrict__ qblock,
                            const int* __restrict__ qkeys, long long ks,
                            const unsigned char* __restrict__ qvalid, long long m,
                            long long nb, int B, int lk, int lv,
                            unsigned char* __restrict__ found, int* __restrict__ vals) {
  const long long q = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (q >= m) return;                       // uniform across the warp
  const bool live = qvalid[q] != 0;
  const long long blk = live ? qblock[q] : -1;   // qblock is read only when valid
  find_one(tk, tv, st, q, live, blk, qkeys + q * ks, nb, B, lk, lv, found, vals, lane);
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

// Column insert: qkeys rows at stride ks, qvals rows at stride vs;
// order/start/ok as for insert_arrivals_launch.
int insert_launch(void* tk, void* tv, void* st, const void* qkeys, long long ks,
                  const void* qvals, long long vs, const void* order, const void* start,
                  long long nb, int B, int lk, int lv, int mode, void* ok, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nb == 0) return (int)cudaGetLastError();
  insert_kernel<<<ctas_for_warps(nb), kThreads, 0, s>>>(
      (int*)tk, (int*)tv, (int*)st, (const int*)qkeys, ks, (const int*)qvals, vs,
      (const int*)order, (const int*)start, nb, B, lk, lv, mode, (unsigned char*)ok);
  return (int)cudaGetLastError();
}

// Column find: qblock (m,) i32, qkeys rows at stride ks, qvalid (m,) u8;
// out found (m,) u8, vals (m, lv) i32.
int find_launch(const void* tk, const void* tv, const void* st, const void* qblock,
                const void* qkeys, long long ks, const void* qvalid, long long m,
                long long nb, int B, int lk, int lv, void* found, void* vals,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m == 0) return (int)cudaGetLastError();
  find_kernel<<<ctas_for_warps(m), kThreads, 0, s>>>(
      (const int*)tk, (const int*)tv, (const int*)st, (const int*)qblock,
      (const int*)qkeys, ks, (const unsigned char*)qvalid, m, nb, B, lk, lv,
      (unsigned char*)found, (int*)vals);
  return (int)cudaGetLastError();
}

}  // extern "C"
