// Owner-side hash-table probe kernels for Hopper (sm_90a): the arrival
// front ends insert_arrivals / find_arrivals and the column front ends
// insert / find.  Plain C entry points, bound with ctypes by
// repro_torch/kernels/hash_probe.py; each launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError().
//
// Table layout (blocked open addressing, 32-bit words):
//   tkeys (nb, B, Lk), tvals (nb, B, Lv), status (nb, B); the low two
//   status bits are the bucket state (0 FREE, 1 and 3 neither free nor
//   matchable, 2 READY), the rest are read flags that ride along.
// Items: item q's block at blk[q * bs], its key words at key[q * ks + l],
// its value words at val[q * vs + l] (struct Items).  The arrival
// front ends point all three into the exchange's owner segment (rows of
// [local block | Lk key words | Lv value words] at row stride segw); the
// column front ends at the caller's separate arrays.  Both share every
// device routine below.
//
// insert_arrivals replaces src/repro/kernels/hash_probe.py::
// insert_arrivals (_insert_arrivals_kernel), insert replaces
// hash_probe.py::insert (_insert_kernel).  The tables must come out bit
// for bit as if the items were inserted one at a time in batch order.
// Design (probe_insert_blocks, one warp per table block):
//   * the wrapper's CSR (bin_csr in csrc/binning.cu: the items in stable
//     block order) hands each block its items in batch order;
//   * the warp stages the block's status, keys and values in shared
//     memory once (cp.async), and lists the block's FREE slots and its
//     READY slots (with their keys), each ascending, by ballot prefix
//     counts;
//   * it resolves its items 32 at a time, one per lane, against the
//     staged block: each lane scans the READY list for its key, the first
//     hit being the first READY slot holding it (list_match); lanes with
//     equal keys are grouped by __match_any_sync (64 bits: the first two
//     key words; wider keys are then checked word by word); the lowest
//     lane of a group (its first occurrence) leads it; leaders without a
//     match take the next FREE slots in lane order (a ballot prefix count
//     against the running free list) and join the READY list, or fail,
//     with their group, once the free list runs out; values combine by
//     mode in lane order (SET the group's last value, ADD the u32 sum on
//     top of the stored one, KEEP the stored or the leader's value); the
//     staged block is updated before the next 32.  Distinct keys touch
//     distinct slots, and a key's duplicates within the 32 are one group,
//     so the step equals the one-at-a-time walk;
//   * it writes the block back once.  The output tables are new (the
//     function is out of place, as in JAX): every warp copies its block
//     through, touched or not, so the table is read once and written once
//     and no separate clone runs.
// Bound: bytes -- the table read and written once, plus the items.  What
// keeps it off the bound: the CSR before it (one bin_csr pass per 10
// bits of the block index), the random reads of the items' rows, and
// each warp's chain of dependent loads (start, CSR, item rows) per block.
// No per-block query capacity: the TPU kernels fail items past their
// q_cap, these kernels serve them all.
//
// find_arrivals replaces hash_probe.py::find_arrivals
// (_find_arrivals_kernel), find replaces hash_probe.py::find
// (_find_kernel).  Block-major (probe_find_blocks): the same CSR groups
// the queries by block; one warp per touched block stages its status
// and keys in shared memory once, lists its READY slots, and answers its
// queries 32 at a time, one a lane (list_match); a hit gathers the
// slot's value words exactly from device memory and writes them and the
// found flag to the query's own row (the rows of the others stay zero).
// Untouched blocks are not read.  Bound: bytes -- each touched block's
// keys and status once, the hit rows' values, the queries read and the
// answers written; the queries' key reads and the answers' writes are
// random, one sector each.  A sparse batch (the wrapper's choice: fewer
// queries than two a block) pays more for the CSR and the warp per block
// than sharing a block can save, so it takes probe_find_queries: one
// warp per query reads its block from device memory, no CSR.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerCta = 8;
constexpr int kModeSet = 0, kModeAdd = 1;            // 2 = keep the first writer's value
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxShared = 227 * 1024;            // a CTA's dynamic shared memory

struct Items {
  const int* blk;
  long long bs;
  const int* key;
  long long ks;
  const int* val;
  long long vs;
};

__host__ __device__ __forceinline__ int pad4(long long n) { return (int)((n + 3) & ~3LL); }

// One warp's shared memory, as offsets in ints: the block's status, keys
// and (insert) values; its READY list (key words, slot); the words of 32
// items; (insert) the free list.
struct Offsets {
  int st, key, val, rk, rs, qk, qv, sfree, end;
  __host__ __device__ __forceinline__ Offsets(int B, int lk, int lv, bool insert) {
    const int v = insert ? lv : 0;
    st = 0;
    key = st + pad4(B);
    val = key + pad4((long long)B * lk);
    rk = val + pad4((long long)B * v);
    rs = rk + pad4((long long)B * lk);
    qk = rs + pad4(B);
    qv = qk + pad4(kWarp * lk);
    sfree = qv + pad4(kWarp * v);
    end = sfree + (insert ? pad4(B) : 0);
  }
};

__host__ __device__ __forceinline__ int warp_ints(int B, int lk, int lv, bool insert) {
  return Offsets(B, lk, lv, insert).end;
}

// A warp's block, staged.
struct Staged {
  int *st, *key, *val, *rk, *rs, *qk, *qv, *sfree;
  int nr;                                   // entries of the READY list
  __device__ __forceinline__ Staged(int* base, int B, int lk, int lv, bool insert) : nr(0) {
    const Offsets o(B, lk, lv, insert);
    st = base + o.st;
    key = base + o.key;
    val = base + o.val;
    rk = base + o.rk;
    rs = base + o.rs;
    qk = base + o.qk;
    qv = base + o.qv;
    sfree = base + o.sfree;
  }
};

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(int* dst, const int* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b, int n) {
  return ((((uintptr_t)a) | ((uintptr_t)b)) & 15) == 0 && (n & 3) == 0;
}

// Issue the copy of n contiguous words into shared memory (16 bytes a
// lane where both sides allow it); the caller waits.
__device__ __forceinline__ void stage(int* dst, const int* src, int n, int lane) {
  if (aligned16(dst, src, n)) {
    for (int i = lane * 4; i < n; i += kWarp * 4) cp_async16(dst + i, src + i);
  } else {
    for (int i = lane; i < n; i += kWarp) cp_async4(dst + i, src + i);
  }
}

__device__ __forceinline__ void unstage(int* dst, const int* src, int n, int lane) {
  if (aligned16(dst, src, n)) {
    for (int i = lane * 4; i < n; i += kWarp * 4)
      *reinterpret_cast<int4*>(dst + i) = *reinterpret_cast<const int4*>(src + i);
  } else {
    for (int i = lane; i < n; i += kWarp) dst[i] = src[i];
  }
}

// The staged block's READY slots in ascending order, their key words
// beside them (ballot prefix counts, 32 slots at a time).
__device__ __forceinline__ void list_ready(Staged& b, int B, int lk, int lane) {
  const unsigned lower = (1u << lane) - 1u;
  for (int c = 0; c < B; c += kWarp) {
    const int s = c + lane;
    const bool ready = s < B && ((unsigned)b.st[s] & 3u) == 2u;
    const unsigned bal = __ballot_sync(kFull, ready);
    if (ready) {
      const int at = b.nr + __popc(bal & lower);
      b.rs[at] = s;
      for (int l = 0; l < lk; ++l) b.rk[at * lk + l] = b.key[s * lk + l];
    }
    b.nr += __popc(bal);
  }
  __syncwarp();
}

// The first READY slot holding this lane's key (k0, k1 its first words,
// qk all of them), or B: the first hit of the READY list, which keeps
// READY slots in ascending order (a key the insert adds is new to the
// block, so its place at the end cannot hide an earlier slot).
__device__ __forceinline__ int list_match(const Staged& b, int B, int lk, int k0, int k1,
                                          const int* qk) {
  for (int i = 0; i < b.nr; ++i) {
    const int* kk = b.rk + i * lk;
    if (kk[0] != k0 || (lk > 1 && kk[1] != k1)) continue;
    bool eq = true;
    for (int l = 2; l < lk && eq; ++l) eq = kk[l] == qk[l];
    if (eq) return b.rs[i];
  }
  return B;
}

// Load the items order[j0 + lane] (when below end) into the step
// buffers; returns the lane's item, its first two key words in k0, k1.
__device__ __forceinline__ long long load_items(const Staged& b, const Items& it,
                                                const int* __restrict__ order, int j0, int end,
                                                int lk, int lv, int lane, int* k0, int* k1) {
  *k0 = *k1 = 0;
  if (j0 + lane >= end) return 0;
  const long long q = order[j0 + lane];
  for (int l = 0; l < lk; ++l) {
    const int w = it.key[q * it.ks + l];
    b.qk[lane * lk + l] = w;
    if (l == 0) *k0 = w;
    if (l == 1) *k1 = w;
  }
  for (int l = 0; l < lv; ++l) b.qv[lane * lv + l] = it.val[q * it.vs + l];
  return q;
}

// Resolve one step of up to 32 items against the staged block (see the
// top of the file).  Returns the free slots taken.
__device__ __forceinline__ int insert_step(Staged& b, int nfree, int head, long long q,
                                           bool act, int k0, int k1, int B, int lk, int lv,
                                           int mode, unsigned char* __restrict__ ok,
                                           int lane) {
  const unsigned lower = (1u << lane) - 1u;
  const unsigned amask = __ballot_sync(kFull, act);
  const int match = act ? list_match(b, B, lk, k0, k1, b.qk + lane * lk) : B;
  // the lanes of this step holding the same key, lowest lane first
  const unsigned long long k64 =
      (unsigned long long)(unsigned)k0 | ((unsigned long long)(unsigned)k1 << 32);
  unsigned peers = __match_any_sync(kFull, k64) & amask;
  if (lk > 2 && act) {                      // the match saw two words: check the rest
    unsigned same = 0;
    for (unsigned c = peers; c; c &= c - 1) {
      const int o = __ffs(c) - 1;
      bool eq = true;
      for (int l = 2; l < lk && eq; ++l) eq = b.qk[o * lk + l] == b.qk[lane * lk + l];
      if (eq) same |= 1u << o;
    }
    peers = same;
  }
  const int leader = act ? __ffs(peers) - 1 : lane;
  const bool lead = act && leader == lane;
  const bool fresh = lead && match == B;
  const unsigned fb = __ballot_sync(kFull, fresh);
  const int r = __popc(fb & lower);
  const int slot = match < B ? match : (fresh && head + r < nfree ? b.sfree[head + r] : B);
  const bool lead_ok = lead && slot < B;
  const unsigned okb = __ballot_sync(kFull, lead_ok);
  if (act) ok[q] = (okb >> leader) & 1u;
  const unsigned added = __ballot_sync(kFull, lead_ok && match == B);
  if (lead_ok) {
    b.st[slot] = (int)(((unsigned)b.st[slot] & ~3u) | 2u);
    for (int l = 0; l < lk; ++l) b.key[slot * lk + l] = b.qk[lane * lk + l];
    if (match == B) {                       // a new key: onto the READY list
      const int at = b.nr + __popc(added & lower);
      b.rs[at] = slot;
      for (int l = 0; l < lk; ++l) b.rk[at * lk + l] = b.qk[lane * lk + l];
    }
    int* dst = b.val + (long long)slot * lv;
    if (mode == kModeSet) {
      const int last = 31 - __clz(peers);
      for (int l = 0; l < lv; ++l) dst[l] = b.qv[last * lv + l];
    } else if (mode == kModeAdd) {
      for (int l = 0; l < lv; ++l) {
        unsigned acc = match < B ? (unsigned)dst[l] : 0u;
        for (unsigned c = peers; c; c &= c - 1)
          acc += (unsigned)b.qv[(__ffs(c) - 1) * lv + l];   // wrapping u32 add
        dst[l] = (int)acc;
      }
    } else if (match == B) {                // keep: a new key takes its first writer's value
      for (int l = 0; l < lv; ++l) dst[l] = b.qv[lane * lv + l];
    }
  }
  b.nr += __popc(added);
  __syncwarp();                             // the next 32 see these updates
  return __popc(added);
}

__global__ void probe_insert_blocks(const int* __restrict__ tk, const int* __restrict__ tv,
                                    const int* __restrict__ st, int* __restrict__ otk,
                                    int* __restrict__ otv, int* __restrict__ ost, Items it,
                                    const int* __restrict__ order,
                                    const int* __restrict__ start, long long nb, int B,
                                    int lk, int lv, int mode,
                                    unsigned char* __restrict__ ok) {
  extern __shared__ __align__(16) int smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const long long blk = (long long)blockIdx.x * (blockDim.x / kWarp) + warp;
  if (blk >= nb) return;                    // uniform across the warp
  Staged b(smem + (long long)warp * warp_ints(B, lk, lv, true), B, lk, lv, true);
  const long long row = blk * B;
  stage(b.st, st + row, B, lane);
  stage(b.key, tk + row * lk, B * lk, lane);
  stage(b.val, tv + row * lv, B * lv, lane);
  const int begin = start[blk], end = start[blk + 1];
  cp_async_wait_all();
  __syncwarp();
  if (begin < end) {
    // the block's FREE slots, ascending, and its READY list
    const unsigned lower = (1u << lane) - 1u;
    int nfree = 0;
    for (int c = 0; c < B; c += kWarp) {
      const int s = c + lane;
      const bool f = s < B && ((unsigned)b.st[s] & 3u) == 0u;
      const unsigned bal = __ballot_sync(kFull, f);
      if (f) b.sfree[nfree + __popc(bal & lower)] = s;
      nfree += __popc(bal);
    }
    list_ready(b, B, lk, lane);
    int head = 0;                           // free slots taken so far
    for (int j0 = begin; j0 < end; j0 += kWarp) {
      int k0, k1;
      const long long q = load_items(b, it, order, j0, end, lk, lv, lane, &k0, &k1);
      __syncwarp();
      head += insert_step(b, nfree, head, q, j0 + lane < end, k0, k1, B, lk, lv, mode, ok,
                          lane);
    }
  }
  unstage(ost + row, b.st, B, lane);
  unstage(otk + row * lk, b.key, B * lk, lane);
  unstage(otv + row * lv, b.val, B * lv, lane);
}

__global__ void probe_find_blocks(const int* __restrict__ tk, const int* __restrict__ tv,
                                  const int* __restrict__ st, Items it,
                                  const int* __restrict__ order,
                                  const int* __restrict__ start, long long nb, int B, int lk,
                                  int lv, unsigned char* __restrict__ found,
                                  int* __restrict__ vals) {
  extern __shared__ __align__(16) int smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const long long blk = (long long)blockIdx.x * (blockDim.x / kWarp) + warp;
  if (blk >= nb) return;                    // uniform across the warp
  const int begin = start[blk], end = start[blk + 1];
  if (begin == end) return;                 // untouched: not read
  Staged b(smem + (long long)warp * warp_ints(B, lk, lv, false), B, lk, lv, false);
  const long long row = blk * B;
  stage(b.st, st + row, B, lane);
  stage(b.key, tk + row * lk, B * lk, lane);
  cp_async_wait_all();
  __syncwarp();
  list_ready(b, B, lk, lane);
  for (int j0 = begin; j0 < end; j0 += kWarp) {
    int k0, k1;
    const long long q = load_items(b, it, order, j0, end, lk, 0, lane, &k0, &k1);
    __syncwarp();
    if (j0 + lane < end) {
      const int match = list_match(b, B, lk, k0, k1, b.qk + lane * lk);
      if (match < B) {
        const int* src = tv + (row + match) * lv;
        for (int l = 0; l < lv; ++l) vals[q * lv + l] = src[l];
        found[q] = 1;
      }
    }
    __syncwarp();                           // b.qk is rewritten by the next 32
  }
}

// The first READY slot of block blk holding key, or B: one warp reads
// the block's status and READY keys from device memory, 32 slots at a
// time, and ballots the matches.
__device__ __forceinline__ int first_ready(const int* __restrict__ tk,
                                           const int* __restrict__ st, long long blk, int B,
                                           int lk, const int* key, int lane) {
  for (int c = 0; c < B; c += kWarp) {
    const int s = c + lane;
    bool hit = s < B && ((unsigned)st[blk * B + s] & 3u) == 2u;
    for (int l = 0; l < lk && hit; ++l) hit = tk[(blk * B + s) * lk + l] == key[l];
    const unsigned m = __ballot_sync(kFull, hit);
    if (m) return c + __ffs(m) - 1;
  }
  return B;
}

// The sparse route: one warp per query, no CSR.  A query's block is read
// only when the query is valid.
__global__ void probe_find_queries(const int* __restrict__ tk, const int* __restrict__ tv,
                                   const int* __restrict__ st, Items it,
                                   const unsigned char* __restrict__ valid, long long m,
                                   long long nb, int B, int lk, int lv,
                                   unsigned char* __restrict__ found,
                                   int* __restrict__ vals) {
  const long long q = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (q >= m) return;                       // uniform across the warp
  const long long blk = valid[q] ? (long long)it.blk[q * it.bs] : -1;
  int match = B;
  if (blk >= 0 && blk < nb) match = first_ready(tk, st, blk, B, lk, it.key + q * it.ks, lane);
  if (lane < lv) vals[q * lv + lane] = match < B ? tv[(blk * B + match) * lv + lane] : 0;
  if (lane == 0) found[q] = match < B ? 1 : 0;
}

// Warps of one CTA and its dynamic shared memory for warps needing
// `per_warp` ints each; false when one warp's buffers do not fit.
template <typename K>
bool plan_ctas(K kernel, int per_warp, int* warps, size_t* shmem) {
  const size_t bytes = sizeof(int) * (size_t)per_warp;
  if (bytes > kMaxShared) return false;
  int w = kWarpsPerCta;
  while (w > 1 && w * bytes > kMaxShared) --w;
  *warps = w;
  *shmem = w * bytes;
  if (*shmem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*shmem);
  return true;
}

int insert_blocks(const int* tk, const int* tv, const int* st, int* otk, int* otv, int* ost,
                  Items it, const int* order, const int* start, long long nb, int B, int lk,
                  int lv, int mode, unsigned char* ok, cudaStream_t s) {
  if (nb == 0) return (int)cudaGetLastError();
  int warps;
  size_t shmem;
  if (!plan_ctas(probe_insert_blocks, warp_ints(B, lk, lv, true), &warps, &shmem))
    return (int)cudaErrorInvalidValue;
  probe_insert_blocks<<<(int)((nb + warps - 1) / warps), warps * kWarp, shmem, s>>>(
      tk, tv, st, otk, otv, ost, it, order, start, nb, B, lk, lv, mode, ok);
  return (int)cudaGetLastError();
}

// The block-major walk over the CSR (order, start) when the caller built
// one, else the sparse route.  The walk's found and vals are zeroed
// here; it writes the hits.
int find_blocks(const int* tk, const int* tv, const int* st, Items it,
                const unsigned char* valid, const int* order, const int* start, long long m,
                long long nb, int B, int lk, int lv, unsigned char* found, int* vals,
                cudaStream_t s) {
  if (m == 0) return (int)cudaGetLastError();
  if (order == nullptr) {
    probe_find_queries<<<(int)((m * kWarp + 255) / 256), 256, 0, s>>>(
        tk, tv, st, it, valid, m, nb, B, lk, lv, found, vals);
    return (int)cudaGetLastError();
  }
  int warps;
  size_t shmem;
  if (!plan_ctas(probe_find_blocks, warp_ints(B, lk, lv, false), &warps, &shmem))
    return (int)cudaErrorInvalidValue;
  cudaMemsetAsync(found, 0, (size_t)m, s);
  cudaMemsetAsync(vals, 0, sizeof(int) * (size_t)m * lv, s);
  probe_find_blocks<<<(int)((nb + warps - 1) / warps), warps * kWarp, shmem, s>>>(
      tk, tv, st, it, order, start, nb, B, lk, lv, found, vals);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// In: tables tk/tv/st; out: new tables otk/otv/ost (every block
// written); seg rows (m, >= 1 + lk + lv) at row stride segw; order
// (m,) i32 item rows, block b's valid items in batch order at
// [start[b], start[b + 1]); start (nb + 1,) i32; ok (m,) u8 zero-filled.
int insert_arrivals_launch(const void* tk, const void* tv, const void* st, void* otk,
                           void* otv, void* ost, const void* seg, long long segw,
                           const void* order, const void* start, long long nb, int B, int lk,
                           int lv, int mode, void* ok, void* stream) {
  const int* row = (const int*)seg;
  const Items it{row, segw, row + 1, segw, row + 1 + lk, segw};
  return insert_blocks((const int*)tk, (const int*)tv, (const int*)st, (int*)otk, (int*)otv,
                       (int*)ost, it, (const int*)order, (const int*)start, nb, B, lk, lv,
                       mode, (unsigned char*)ok, (cudaStream_t)stream);
}

// Column insert: qkeys rows at stride ks, qvals rows at stride vs;
// the rest as for insert_arrivals_launch.
int insert_launch(const void* tk, const void* tv, const void* st, void* otk, void* otv,
                  void* ost, const void* qkeys, long long ks, const void* qvals,
                  long long vs, const void* order, const void* start, long long nb, int B,
                  int lk, int lv, int mode, void* ok, void* stream) {
  const Items it{nullptr, 0, (const int*)qkeys, ks, (const int*)qvals, vs};
  return insert_blocks((const int*)tk, (const int*)tv, (const int*)st, (int*)otk, (int*)otv,
                       (int*)ost, it, (const int*)order, (const int*)start, nb, B, lk, lv,
                       mode, (unsigned char*)ok, (cudaStream_t)stream);
}

// seg rows (m, >= 1 + lk) at row stride segw; valid (m,) u8; order/start
// the CSR as for insert_arrivals_launch, or null for the sparse route;
// out found (m,) u8, vals (m, lv) i32.
int find_arrivals_launch(const void* tk, const void* tv, const void* st, const void* seg,
                         long long segw, const void* valid, const void* order,
                         const void* start, long long m, long long nb, int B, int lk, int lv,
                         void* found, void* vals, void* stream) {
  const int* row = (const int*)seg;
  const Items it{row, segw, row + 1, segw, nullptr, 0};
  return find_blocks((const int*)tk, (const int*)tv, (const int*)st, it,
                     (const unsigned char*)valid, (const int*)order, (const int*)start, m, nb,
                     B, lk, lv, (unsigned char*)found, (int*)vals, (cudaStream_t)stream);
}

// Column find: qblock (m,) i32, qkeys rows at stride ks, qvalid (m,) u8;
// the rest as for find_arrivals_launch.
int find_launch(const void* tk, const void* tv, const void* st, const void* qblock,
                const void* qkeys, long long ks, const void* qvalid, const void* order,
                const void* start, long long m, long long nb, int B, int lk, int lv,
                void* found, void* vals, void* stream) {
  const Items it{(const int*)qblock, 1, (const int*)qkeys, ks, nullptr, 0};
  return find_blocks((const int*)tk, (const int*)tv, (const int*)st, it,
                     (const unsigned char*)qvalid, (const int*)order, (const int*)start, m,
                     nb, B, lk, lv, (unsigned char*)found, (int*)vals, (cudaStream_t)stream);
}

}  // extern "C"
