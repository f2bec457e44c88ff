// Exchange wire kernels for Hopper (sm_90a): bin_offsets, bin_csr,
// pack_rows, place_rows, ragged_slots, row_mix, histogram.  Plain C entry
// points, bound with ctypes by repro_torch/kernels/binning.py; every entry
// point launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().
// All u32 words travel as 32-bit ints; only bit patterns matter.
//
// bin_offsets replaces src/repro/kernels/binning.py::bin_offsets
// (_offsets_kernel).  Per item: its stable rank among the valid items
// of its bin; per bin: the valid count.  The TPU kernel carries the
// running per-bin prefix from one grid step to the next, which relies
// on the steps running in order.  GPU blocks run in no order, so the
// prefix crosses tiles by a decoupled look-back (Merrill and Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016):
// one memset of the status words, then one launch of bo_rank_tiles.
//   - each CTA takes a tile of kTileItems items, its index from an
//     atomic counter (so it only ever waits on tiles that have started),
//     and stages the tile's bins and valid bytes in shared memory with
//     16-byte loads;
//   - each warp ranks its kTileItems / 8 items in order, 32 at a time:
//     with one bin and the invalid one, one __ballot_sync per bin,
//     every lane keeping both counts in registers; with more,
//     __match_any_sync groups the lanes of equal bins and the lowest
//     peer advances the warp's count in shared memory (ballots over 2
//     or 3 bins measured no faster); the rank is the popcount of the
//     lower lanes of its bin;
//   - the warps' counts give each warp's base and the tile's per-bin
//     aggregate, which the tile publishes at once (flag A); then, with
//     at most kWindowBins bins, one warp per bin reads 32 preceding
//     tiles' status words at a time, else one lane per bin reads one
//     tile at a time, summing back to the first inclusive prefix (flag
//     P); flag and value share one 64-bit word (release / acquire), and
//     the tile publishes its own inclusive prefix;
//   - each item's offset is written once, coalesced; the last tile's
//     inclusive prefix is the counts.
// So ranks equal stable-argsort ranks exactly.  Invalid items rank in
// an extra last bin, so the offsets agree with the plain version
// (stable argsort with invalid items last) bit for bit.  Bound: bytes
// -- 5 bytes read and 4 written per item, read once; the status words
// are tiles * nb * 8 bytes.  At most kMaxBins bins (including the
// invalid one).
//
// bin_csr serves bin_offsets past kMaxBins bins (the same TPU kernel)
// and builds the hash probes' CSR: the items in stable bin order (each
// bin's valid items in batch order, the items that are not live --
// invalid, or a bin outside [0, nbins) -- last) and where each bin's run
// starts.  A stable counting sort by least-significant digit, one launch
// per digit (the Onesweep design: Adinets and Merrill, "Onesweep: A
// Faster Least Significant Digit Radix Sort for GPUs", 2022): each item
// travels as a 64-bit word bin << 32 | index (a negative word when it is
// not live: the digit past the last), and each pass over a digit of at
// most kDigitBits bits is a stable partition of the previous pass's order.
//   - one memset zeroes the scratch's control words, digit counts and
//     every pass's status words;
//   - csr_count reads the bins (in place, at their row stride) and the
//     valid bytes once and counts every pass's digits in shared memory
//     (count_item, which histogram shares), flushing with global atomics;
//     the last CTA to finish scans each pass's counts into digit starts;
//   - each pass is one launch of csr_pass: a CTA takes a tile (its index
//     from an atomic counter), each warp loads its chunk of words into
//     registers at once (the first pass makes them from the bins on the
//     fly) and ranks them in order, 32 a step, its peers found by one
//     __ballot_sync per bit of the digit (measured faster than
//     __match_any_sync); the tile publishes its per-digit aggregate (flag
//     A; the first tile its inclusive prefix), sorts itself by digit in
//     shared memory, then looks back a thread per digit over the earlier
//     tiles' status words to the nearest inclusive prefix (flag P) and
//     publishes its own; flag and count share one 32-bit word (so a call
//     takes fewer than 2**30 items); it writes the tile out by digit runs,
//     so a run's words land consecutively.  Each word is read once and
//     written once a pass; the last pass writes the index (order) and the
//     bin (sorted bins) instead;
//   - csr_starts finds each bin's start by a binary search of the sorted
//     bins (nbins log n reads, whatever the bins' spread).
// Tiles hold 8192 words (4096 measured slower at 2**24 items, 2048 slower
// there and no faster at 2**19).  Bound: bytes -- the bins and valid
// bytes read, order and start written; the words add 8 bytes written and
// read per item and pass but the last, the status words tiles * 1025 * 4
// bytes a pass.
//
// pack_rows replaces src/repro/kernels/binning.py::pack_rows
// (_pack_rows_kernel): the ragged word slot of each row for retry
// round rnd and the scatter of its first roww[flow] words into the
// flat send buffer, fused.  The TPU kernel keeps the whole buffer in
// one VMEM block; here it lives in device memory: one memset, then
// pack_rows_kernel.  Each CTA loads the per-flow tables into shared
// memory once; each warp takes 32 rows, each lane computes one row's
// slot once (the __device__ ragged_slot that ragged_slots_kernel
// shares), and the warp copies the rows' 32 * wmax contiguous words
// lane by lane: lane l reads and writes words l, l + 32, ... of that
// run, taking its row's slot and width by shuffle (the row and lane
// advance by the constant 32 = a * wmax + b: no division per word, and
// 64-bit arithmetic only for the word address).  Rows of one bin and
// flow with consecutive ranks land at consecutive slots, so there each
// store instruction writes 128 contiguous bytes.  Slots are unique, so
// no atomics; words nobody writes stay 0 (the wire checksum relies on
// fmix32(0) == 0).  Bound: bytes -- rows and metadata read once, buffer
// written once (twice with the memset).
//
// place_rows replaces src/repro/kernels/binning.py::place_rows
// (_place_rows_kernel): a copy of dst with fixed-width rows written at
// explicit word slots; a word at or past the end drops.  A copy kernel
// then one thread per (row, lane) word.  Bound: bytes.
//
// ragged_slots replaces src/repro/kernels/binning.py::ragged_slots
// (_ragged_slots_kernel): the word slot alone, without the scatter.
// pack_rows and ragged_slots call the same __device__ ragged_slot, so
// the two cannot drift apart.  One thread per item; an item that does
// not ship this round gets the sentinel.  Bound: bytes -- 13 bytes read
// and 4 written per item.
//
// row_mix replaces src/repro/kernels/binning.py::row_mix
// (_row_mix_kernel): the wire checksum hash of each row, the lanes
// weighted by 0x9E3779B1 * (2l + 1), summed and finished with fmix32,
// all in native unsigned arithmetic (the u32 wrap comes free).  One
// thread per row; rows come at a row stride, so a strided segment view
// is read in place.  An all-zero row hashes to 0.  Bound: bytes -- the
// rows read once, one word written per row.
//
// histogram replaces src/repro/kernels/binning.py::histogram
// (_hist_kernel): per-bin counts of the valid items.  The TPU kernel
// sums one-hot rows on the MXU in float32; here the counts are exact
// integers.  Each warp loads 512 items a step with 16-byte loads of the
// bins (4-byte loads of the valid bytes beside them); up to kFewBins bins
// it counts by one __ballot_sync per bin and item, every lane keeping the
// warp's counts in registers; above, count_item (shared with bin_csr's
// count pass) adds each item to shared counters by atomicAdd (merging the
// lanes of equal bins by __match_any_sync first measured slower), each
// warp on its own copy of the counters while kMaxSharedBins allows (one
// copy per CTA at most); each CTA flushes once per bin to global memory.
// Bins outside [0, nbins) are not counted.
// Above kMaxSharedBins bins the counts go straight to global atomics.
// Bound: bytes -- 5 bytes read per item.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerCta = 8;
constexpr int kMaxBins = 1024;     // including the invalid bin
constexpr int kThreads = 256;
constexpr int kSMs = 132;
constexpr int kMaxSharedBins = 12288;   // 48 KB of shared counters
constexpr int kFewBins = 4;             // bins up to which histogram counts by ballots
constexpr int kGroup = 16;              // items a histogram lane loads in a step
constexpr int kDigitBits = 10;          // widest digit of one bin_csr pass
constexpr int kDigitStride = (1 << kDigitBits) + 1;   // digit counters a pass (not-live last)
constexpr int kMaxPasses = 4;           // digits of a 31-bit bin
constexpr int kCountItems = 8;          // items a csr_count thread loads before it counts
constexpr int kCountCtas = kSMs * 4;    // csr_count CTAs at most: one flush each
constexpr int kDigitsPerThread = (kDigitStride + kThreads - 1) / kThreads;   // csr_pass
constexpr int kCsrSteps = 32;           // words a csr_pass lane holds: 8192-word tiles
constexpr int kCsrTile = kWarpsPerCta * kWarp * kCsrSteps;
constexpr int kTileItems = 4096;        // items per CTA of bin_offsets' one pass
// bins (the invalid one included) up to which bin_offsets looks back a
// warp per bin, 32 tiles a read (measured faster up to 4, a lane per bin
// one tile a read faster at 8)
constexpr int kWindowBins = 4;
constexpr int kMaxSharedFlows = 2048;   // per-flow tables pack_rows keeps in shared memory
constexpr int kPackBatch = 4;           // words a pack_rows lane loads before it stores
constexpr unsigned kFull = 0xffffffffu;
// look-back status word: flag in the high 32 bits, value in the low 32
// (0: the tile has published nothing yet -- the words are zeroed per call)
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;
// bin_csr's status words: flag in the high 2 bits, a count below 2**30 in
// the low 30 (so a call takes fewer than 2**30 items)
constexpr unsigned kCsrAggregate = 1u << 30;
constexpr unsigned kCsrPrefix = 2u << 30;
constexpr unsigned kCsrCount = (1u << 30) - 1;

__device__ __forceinline__ int bucket_of(int bin, unsigned char valid, int nb) {
  // nb includes the invalid bin (nb - 1)
  return (valid && bin >= 0 && bin < nb - 1) ? bin : nb - 1;
}

__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// A status word whose flag and value travel in one access needs no
// ordering against anything else: relaxed, at the GPU's scope.
__device__ __forceinline__ void store_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned load_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Shared memory of bo_rank_tiles: the staged bins (then each item's bin << 16
// | rank in its warp), the valid bytes, each warp's per-bin counts (then
// bases), and per bin the tile's aggregate and exclusive prefix.
size_t bo_rank_tiles_shmem(int nb) {
  return (size_t)kTileItems * 5 + sizeof(int) * (kWarpsPerCta + 2) * nb;
}

// The exclusive prefix of bin k before tile t: the sum of the preceding
// tiles' aggregates back to the nearest inclusive prefix.  By one warp,
// 32 preceding tiles a read (lane 0 the nearest); a tile that has not
// published yet is read again.
__device__ __forceinline__ int look_back_window(const unsigned long long* status, long long t,
                                                int nb, int k, int lane) {
  int ex = 0;
  for (long long j = t - 1;;) {
    const long long p = j - lane;
    const unsigned long long w = p >= 0 ? load_acquire(status + p * nb + k) : kPrefix;
    const unsigned flag = (unsigned)(w >> 32);
    const unsigned pm = __ballot_sync(kFull, flag == 2);
    const int first = pm ? __ffs(pm) - 1 : kWarp - 1;
    const unsigned upto = (2u << first) - 1u;   // lanes up to the first prefix
    if (__ballot_sync(kFull, flag == 0) & upto) {
      __nanosleep(32);
      continue;
    }
    ex += (int)__reduce_add_sync(kFull, lane <= first ? (unsigned)w : 0u);
    if (pm) return ex;
    j -= kWarp;
  }
}

// The same for 32 bins at once (lane l: bin k0 + l), one preceding tile
// a read, each lane walking back until its bin's inclusive prefix.
__device__ __forceinline__ int look_back_lanes(const unsigned long long* status, long long t,
                                               int nb, int k) {
  int ex = 0;
  bool done = k >= nb;
  for (long long p = t - 1; __any_sync(kFull, !done);) {
    if (done) continue;
    if (p < 0) {
      done = true;
      continue;
    }
    const unsigned long long w = load_acquire(status + p * nb + k);
    const unsigned flag = (unsigned)(w >> 32);
    if (flag == 0) {
      __nanosleep(32);
      continue;
    }
    ex += (int)(unsigned)w;
    done = flag == 2;
    --p;
  }
  return ex;
}

// Rank one warp's chunk of the staged tile in order, 32 items a step:
// each item's bin << 16 | rank among its bin's items in the chunk goes
// back to sbin, the chunk's per-bin counts to run.  kNb > 0: exactly kNb
// bins (nb), one ballot per bin each step and every lane keeping every
// count; kNb == 0: any nb, __match_any_sync groups the lanes of equal
// bins and the lowest peer advances the count in shared memory.
template <int kNb>
__device__ __forceinline__ void rank_chunk(int* sbin, const unsigned char* sval, int beg,
                                           int end, int nb, int* run, int lane) {
  const unsigned lower = (1u << lane) - 1u;
  if constexpr (kNb > 0) {
    int cnt[kNb] = {};
    for (int base = beg; base < end; base += kWarp) {
      const int i = base + lane;
      const bool act = i < end;
      const int b = act ? bucket_of(sbin[i], sval[i], kNb) : -1;
      int r = 0;
#pragma unroll
      for (int k = 0; k < kNb; ++k) {
        const unsigned m = __ballot_sync(kFull, b == k);
        if (b == k) r = cnt[k] + __popc(m & lower);
        cnt[k] += __popc(m);
      }
      if (act) sbin[i] = b << 16 | r;
    }
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < kNb; ++k) run[k] = cnt[k];
  } else {
    for (int base = beg; base < end; base += kWarp) {
      const int i = base + lane;
      const bool act = i < end;
      const int b = act ? bucket_of(sbin[i], sval[i], nb) : nb;   // nb: idle lane
      const unsigned peers = __match_any_sync(kFull, b);
      const int r = __popc(peers & lower);
      const int prior = act ? run[b] : 0;
      __syncwarp();
      if (act && r == 0) run[b] = prior + __popc(peers);
      __syncwarp();
      if (act) sbin[i] = b << 16 | (prior + r);
    }
  }
}

template <int kNb>
__global__ void __launch_bounds__(kThreads) bo_rank_tiles(
    const int* __restrict__ bins, const unsigned char* __restrict__ valid, long long n,
    int nb, bool vec, int* __restrict__ next_tile, unsigned long long* __restrict__ status,
    int* __restrict__ counts, int* __restrict__ offsets) {
  constexpr int kChunk = kTileItems / kWarpsPerCta;   // items per warp, in order
  extern __shared__ __align__(16) int sbin[];
  unsigned char* sval = reinterpret_cast<unsigned char*>(sbin + kTileItems);
  int* wcnt = reinterpret_cast<int*>(sval + kTileItems);   // kWarpsPerCta x nb
  int* agg = wcnt + kWarpsPerCta * nb;
  int* excl = agg + nb;
  __shared__ int s_tile;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  if (threadIdx.x == 0) s_tile = atomicAdd(next_tile, 1);
  for (int i = threadIdx.x; i < kWarpsPerCta * nb; i += kThreads) wcnt[i] = 0;
  __syncthreads();
  const long long t = s_tile;
  const long long beg = t * kTileItems;
  const int items = (int)(n - beg < kTileItems ? n - beg : kTileItems);
  // stage the tile: 16-byte loads when whole and aligned
  if (vec && items == kTileItems) {
    const int4* gb = reinterpret_cast<const int4*>(bins + beg);
    const int4* gv = reinterpret_cast<const int4*>(valid + beg);
    int4* sb4 = reinterpret_cast<int4*>(sbin);
    int4* sv4 = reinterpret_cast<int4*>(sval);
#pragma unroll
    for (int q = threadIdx.x; q < kTileItems / 4; q += kThreads) sb4[q] = __ldcs(gb + q);
#pragma unroll
    for (int q = threadIdx.x; q < kTileItems / 16; q += kThreads) sv4[q] = __ldcs(gv + q);
  } else {
    for (int i = threadIdx.x; i < items; i += kThreads) {
      sbin[i] = bins[beg + i];
      sval[i] = valid[beg + i];
    }
  }
  __syncthreads();
  int* run = wcnt + warp * nb;
  const int cbeg = warp * kChunk, cend = cbeg + kChunk < items ? cbeg + kChunk : items;
  rank_chunk<kNb>(sbin, sval, cbeg, cend, nb, run, lane);
  __syncthreads();
  // each warp's base per bin, the tile's aggregate, published at once
  unsigned long long* mine = status + t * nb;
  for (int k = threadIdx.x; k < nb; k += kThreads) {
    int acc = 0;
    for (int w = 0; w < kWarpsPerCta; ++w) {
      const int c = wcnt[w * nb + k];
      wcnt[w * nb + k] = acc;
      acc += c;
    }
    agg[k] = acc;
    store_release(mine + k, (t == 0 ? kPrefix : kAggregate) | (unsigned)acc);
  }
  __syncthreads();
  // look-back: with few bins a warp per bin over 32 tiles a read, else a
  // lane per bin
  if (nb <= kWindowBins) {
    if (warp < nb) {
      const int ex = t > 0 ? look_back_window(status, t, nb, warp, lane) : 0;
      if (lane == 0) {
        if (t > 0) store_release(mine + warp, kPrefix | (unsigned)(ex + agg[warp]));
        excl[warp] = ex;
      }
    }
  } else {
    for (int k0 = warp * kWarp; k0 < nb; k0 += kThreads) {
      const int k = k0 + lane;
      const int ex = t > 0 ? look_back_lanes(status, t, nb, k) : 0;
      if (k < nb) {
        if (t > 0) store_release(mine + k, kPrefix | (unsigned)(ex + agg[k]));
        excl[k] = ex;
      }
    }
  }
  __syncthreads();
  for (int i = cbeg + lane; i < cend; i += kWarp) {
    const int v = sbin[i], b = v >> 16;
    offsets[beg + i] = excl[b] + run[b] + (v & 0xffff);
  }
  if (beg + kTileItems >= n)               // the last tile: its inclusive prefix
    for (int k = threadIdx.x; k < nb; k += kThreads) counts[k] = excl[k] + agg[k];
}

// Word slot of an item's row in retry round rnd of the ragged wire and
// its width roww[flow], from the item's bin, flow, rank and valid flag
// (loaded by the caller, all at once); false when the item does not ship
// in that round.
__device__ __forceinline__ bool ragged_slot(int bin, int f, int off, bool valid,
                                            const int* __restrict__ woff,
                                            const int* __restrict__ roww,
                                            const int* __restrict__ caps,
                                            const int* __restrict__ rounds, int nflows,
                                            int rnd, long long wtot, long long* slot,
                                            int* width) {
  if (!valid || f < 0 || f >= nflows || rounds[f] <= rnd) return false;
  const long long cap = caps[f];
  const long long off_r = (long long)off - (long long)rnd * cap;
  if (off_r < 0 || off_r >= cap) return false;
  *width = roww[f];
  *slot = (long long)bin * wtot + woff[f] + off_r * *width;
  return true;
}

__global__ void __launch_bounds__(kThreads, 8) pack_rows_kernel(
    const int* __restrict__ rows, int wmax, const int* __restrict__ bins,
    const int* __restrict__ flow, const int* __restrict__ off,
    const unsigned char* __restrict__ valid, long long n, const int* __restrict__ woff,
    const int* __restrict__ roww, const int* __restrict__ caps,
    const int* __restrict__ rounds, int nflows, int rnd, long long wtot, long long total,
    int* __restrict__ out) {
  extern __shared__ int tabs[];            // woff, roww, caps, rounds (few flows)
  const bool shared = nflows <= kMaxSharedFlows;
  if (shared) {
    for (int f = threadIdx.x; f < nflows; f += blockDim.x) {
      tabs[f] = woff[f];
      tabs[nflows + f] = roww[f];
      tabs[2 * nflows + f] = caps[f];
      tabs[3 * nflows + f] = rounds[f];
    }
    __syncthreads();
  }
  const int* tw = shared ? tabs : woff;
  const int* tr = shared ? tabs + nflows : roww;
  const int* tc = shared ? tabs + 2 * nflows : caps;
  const int* tn = shared ? tabs + 3 * nflows : rounds;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  // lane l starts at word l of the warp's run: row l / wmax, lane l % wmax;
  // each step of 32 words advances a rows and b lanes
  const int row0 = lane / wmax, col0 = lane % wmax;
  const int a = kWarp / wmax, b = kWarp % wmax;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long r0 = ((long long)blockIdx.x * kWarpsPerCta + warp) * kWarp; r0 < n;
       r0 += step) {
    // every load of the warp's 32 rows at once: their words, then each
    // lane's row's bin, flow, rank and valid flag
    const int words = (int)((n - r0 < kWarp ? n - r0 : kWarp) * wmax);
    const int* src = rows + r0 * wmax;
    int v[kPackBatch];
#pragma unroll
    for (int u = 0; u < kPackBatch; ++u)
      v[u] = lane + u * kWarp < words ? __ldcs(src + lane + u * kWarp) : 0;
    const long long i = r0 + lane < n ? r0 + lane : n - 1;
    const int bin = __ldcs(bins + i), f = __ldcs(flow + i), o = __ldcs(off + i);
    const bool ok = r0 + lane < n && valid[i];
    long long slot = 0;
    int width = 0;                         // words of this lane's row that ship
    if (ragged_slot(bin, f, o, ok, tw, tr, tc, tn, nflows, rnd, wtot, &slot, &width))
      width = width < wmax ? width : wmax;
    const unsigned slo = (unsigned)slot, shi = (unsigned)(slot >> 32);
    int row = row0, col = col0;
    for (int j0 = 0; j0 < wmax; j0 += kPackBatch) {   // a batch of loads, then its stores
      if (j0 > 0) {
#pragma unroll
        for (int u = 0; u < kPackBatch; ++u) {
          const int q = lane + (j0 + u) * kWarp;
          v[u] = j0 + u < wmax && q < words ? __ldcs(src + q) : 0;
        }
      }
#pragma unroll
      for (int u = 0; u < kPackBatch; ++u) {
        if (j0 + u < wmax) {               // warp-uniform
          const unsigned lo = __shfl_sync(kFull, slo, row & (kWarp - 1));
          const unsigned hi = __shfl_sync(kFull, shi, row & (kWarp - 1));
          const int wd = __shfl_sync(kFull, width, row & (kWarp - 1));
          if (lane + (j0 + u) * kWarp < words && col < wd) {
            const long long w = (long long)((unsigned long long)hi << 32 | lo) + col;
            if (w >= 0 && w < total) out[w] = v[u];
          }
          row += a;
          col += b;
          if (col >= wmax) {
            col -= wmax;
            ++row;
          }
        }
      }
    }
  }
}

__global__ void ragged_slots_kernel(const int* __restrict__ bins,
                                    const int* __restrict__ flow,
                                    const int* __restrict__ off,
                                    const unsigned char* __restrict__ valid, long long n,
                                    const int* __restrict__ woff,
                                    const int* __restrict__ roww,
                                    const int* __restrict__ caps,
                                    const int* __restrict__ rounds, int nflows, int rnd,
                                    long long wtot, long long sentinel,
                                    int* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    long long slot;
    int width;
    const bool ship = ragged_slot(bins[i], flow[i], off[i], valid[i], woff, roww, caps,
                                  rounds, nflows, rnd, wtot, &slot, &width);
    out[i] = (int)(ship ? slot : sentinel);   // low 32 bits, as the plain version
  }
}

__device__ __forceinline__ unsigned fmix32(unsigned h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__global__ void row_mix_kernel(const unsigned* __restrict__ rows, long long m,
                               long long row_stride, int lanes, unsigned* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m; i += stride) {
    const unsigned* r = rows + i * row_stride;
    unsigned h = 0u;
    for (int l = 0; l < lanes; ++l) h += r[l] * (0x9E3779B1u * (2u * (unsigned)l + 1u));
    out[i] = fmix32(h);
  }
}

// Count one item (b < 0: none) in shared counters: histogram's counters
// above kFewBins bins and bin_csr's digit counts.
__device__ __forceinline__ void count_item(int b, int* cnt) {
  if (b >= 0) atomicAdd(cnt + b, 1);
}

// The buckets (-1: not counted) of a lane's 16 items of the warp's 512 at
// i0: item i0 + 4 (32 q + lane) + e is b[4 q + e], so every load of the
// warp is contiguous (16 bytes of bins and 4 valid bytes a lane); a whole
// aligned step by vector loads, else item by item.
__device__ __forceinline__ void load_group(const int* __restrict__ bins,
                                           const unsigned char* __restrict__ valid,
                                           long long n, int nbins, long long i0, bool vec,
                                           int lane, int (&b)[kGroup]) {
  if (vec && i0 + kWarp * kGroup <= n) {
    int4 b4[4];
    unsigned v4[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long i = i0 + 4 * (q * kWarp + lane);
      b4[q] = __ldcs(reinterpret_cast<const int4*>(bins + i));
      v4[q] = __ldcs(reinterpret_cast<const unsigned*>(valid + i));
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int bb[4] = {b4[q].x, b4[q].y, b4[q].z, b4[q].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = (v4[q] >> (8 * e)) & 0xffu;
        b[4 * q + e] = ok && bb[e] >= 0 && bb[e] < nbins ? bb[e] : -1;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const long long i = i0 + 4 * ((j / 4) * kWarp + lane) + j % 4;
      const int v = i < n && valid[i] ? bins[i] : -1;
      b[j] = v >= 0 && v < nbins ? v : -1;
    }
  }
}

// kBallot: at most kFewBins bins, counted by ballots in registers; else by
// count_item into `copies` shared copies of the counters (0: global).
template <bool kBallot>
__global__ void __launch_bounds__(kThreads) histogram_kernel(
    const int* __restrict__ bins, const unsigned char* __restrict__ valid, long long n,
    int nbins, bool vec, int copies, int* __restrict__ counts) {
  extern __shared__ int sh[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nsh = kBallot ? nbins : copies * nbins;
  for (int k = threadIdx.x; k < nsh; k += kThreads) sh[k] = 0;
  __syncthreads();
  int* cnt = copies ? sh + (warp % copies) * nbins : counts;
  int few[kFewBins] = {};                  // the warp's counts (ballots)
  constexpr long long kWarpItems = kWarp * kGroup;
  const long long stride = (long long)gridDim.x * kWarpsPerCta * kWarpItems;
  for (long long i0 = ((long long)blockIdx.x * kWarpsPerCta + warp) * kWarpItems; i0 < n;
       i0 += stride) {
    int b[kGroup];
    load_group(bins, valid, n, nbins, i0, vec, lane, b);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if constexpr (kBallot) {
#pragma unroll
        for (int k = 0; k < kFewBins; ++k)
          if (k < nbins) few[k] += __popc(__ballot_sync(kFull, b[j] == k));
      } else {
        count_item(b[j], cnt);
      }
    }
  }
  if constexpr (kBallot) {
    if (lane == 0)
      for (int k = 0; k < nbins; ++k) atomicAdd(sh + k, few[k]);
  }
  __syncthreads();
  const int ncopies = kBallot ? 1 : copies;
  for (int k = threadIdx.x; ncopies && k < nbins; k += kThreads) {
    int c = 0;
    for (int v = 0; v < ncopies; ++v) c += sh[v * nbins + k];
    if (c) atomicAdd(counts + k, c);
  }
}

__global__ void copy_words(const int* __restrict__ src, long long n,
                           int* __restrict__ dst) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < n; t += stride)
    dst[t] = src[t];
}

__global__ void place_rows_kernel(const int* __restrict__ slots,
                                  const int* __restrict__ rows, long long m, int w,
                                  long long total, int* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < m * w;
       t += stride) {
    const long long i = t / w;
    const long long word = (long long)slots[i] + (t - i * w);
    if (slots[i] >= 0 && word < total) out[word] = rows[t];
  }
}

// The items' words: read from the previous pass, or made from the bins
// (at row stride bstride) in the first; the bin and the valid byte are
// loaded together, whatever the valid byte says.
struct Words {
  const long long* words;
  const int* bins;
  long long bstride;
  const unsigned char* valid;
  long long nbins;
  __device__ __forceinline__ long long operator()(long long i) const {
    if (words) return words[i];
    const long long b = bins[i * bstride];
    return (valid[i] && b >= 0 && b < nbins ? b << 32 : -(1LL << 32)) | i;
  }
};

// The digit of a word, or nd for a word that is not live (the last digit).
__device__ __forceinline__ int digit_of(long long w, int shift, int nd) {
  return w >= 0 ? (int)((w >> (32 + shift)) & (nd - 1)) : nd;
}

// out[b] = the sum of in[0:b], by one warp in chunks of 32.
__device__ __forceinline__ void warp_exclusive_scan(const int* in, int* out, int nb,
                                                    int lane) {
  int carry = 0;
  for (int c = 0; c < nb; c += kWarp) {
    const int v = c + lane < nb ? in[c + lane] : 0;
    int x = v;
    for (int o = 1; o < kWarp; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (c + lane < nb) out[c + lane] = carry + x - v;
    carry += __shfl_sync(kFull, x, kWarp - 1);
  }
}

// The passes of one bin_csr call: each pass's digit shift and digit count.
struct CsrPlan {
  int passes;
  int shift[kMaxPasses];
  int nd[kMaxPasses];
};

// Every pass's digit counts (pass p at counts + p * kDigitStride, its
// not-live digit last), by count_item into shared counters; the last CTA to
// finish turns them into digit starts.
__global__ void __launch_bounds__(kThreads) csr_count(
    const int* __restrict__ bins, long long bstride, const unsigned char* __restrict__ valid,
    long long n, long long nbins, CsrPlan plan, int* __restrict__ counts,
    int* __restrict__ done) {
  __shared__ int tally[kMaxPasses * kDigitStride];
  __shared__ bool last;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int total = plan.passes * kDigitStride;
  for (int k = threadIdx.x; k < total; k += kThreads) tally[k] = 0;
  __syncthreads();
  const long long threads = (long long)gridDim.x * kThreads;
  for (long long i0 = (long long)blockIdx.x * kThreads + threadIdx.x; i0 < n;
       i0 += threads * kCountItems) {
    long long b[kCountItems];
    bool live[kCountItems];
#pragma unroll
    for (int j = 0; j < kCountItems; ++j) {   // every load first
      const long long i = i0 + j * threads;
      b[j] = i < n ? bins[i * bstride] : 0;
      live[j] = i < n && valid[i];
    }
#pragma unroll
    for (int j = 0; j < kCountItems; ++j) {
      if (i0 + j * threads >= n) break;
      const bool in = live[j] && b[j] >= 0 && b[j] < nbins;
      for (int p = 0; p < plan.passes; ++p) {
        const int nd = plan.nd[p];
        count_item(in ? (int)((b[j] >> plan.shift[p]) & (nd - 1)) : nd,
                   tally + p * kDigitStride);
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < total; k += kThreads)
    if (tally[k]) atomicAdd(counts + k, tally[k]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int k = threadIdx.x; k < total; k += kThreads) tally[k] = __ldcg(counts + k);
  __syncthreads();
  if (warp < plan.passes)
    warp_exclusive_scan(tally + warp * kDigitStride, counts + warp * kDigitStride,
                        plan.nd[warp] + 1, lane);
}

// The look-back of csr_pass's tile t > 0, a thread per digit (several
// digits a thread, all at once): each digit's count in the earlier tiles
// from their status words, one tile a read (more tiles a read measured
// slower: the look-back is bound by these reads), back to the nearest
// inclusive prefix; a word not yet published is read again at once (a
// sleep between reads measured slower).  It publishes the tile's inclusive
// prefix and writes the exclusive one to base[k].
__device__ __forceinline__ void look_back_digits(const unsigned* status, long long t, int nb,
                                                 unsigned* mine, const int* agg, int* base) {
  constexpr int kPer = kDigitsPerThread;
  int ex[kPer];
  long long p[kPer];                       // the next earlier tile to read, -1: done
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    ex[j] = 0;
    p[j] = (int)threadIdx.x + j * kThreads < nb ? t - 1 : -1;
  }
  for (bool busy = true; busy;) {
    unsigned w[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      w[j] = p[j] >= 0 ? load_relaxed(status + p[j] * nb + threadIdx.x + j * kThreads) : 0u;
    busy = false;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const unsigned flag = w[j] & ~kCsrCount;
      if (p[j] >= 0 && flag != 0) {
        ex[j] += (int)(w[j] & kCsrCount);
        p[j] = flag == kCsrPrefix ? -1 : p[j] - 1;
      }
      busy |= p[j] >= 0;
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int k = threadIdx.x + j * kThreads;
    if (k < nb) {
      store_relaxed(mine + k, kCsrPrefix | (unsigned)(ex[j] + agg[k]));
      base[k] = ex[j];
    }
  }
}

// The sum of v over the CTA's threads below this one (tmp: kWarpsPerCta ints).
__device__ __forceinline__ int block_exclusive_scan(int v, int* tmp) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  int x = v;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == kWarp - 1) tmp[warp] = x;
  __syncthreads();
  int below = 0;
  for (int u = 0; u < warp; ++u) below += tmp[u];
  __syncthreads();                         // tmp may be reused at once
  return below + x - v;
}

// Shared memory of csr_pass: the tile sorted by digit, each warp's digit
// counts (then bases), and per digit the tile's count, its start in the
// tile and where its first word goes (then less that start).
size_t csr_pass_shmem(int nb) {
  return sizeof(long long) * kCsrTile + sizeof(int) * (kWarpsPerCta + 3) * nb;
}

// One digit pass over tiles of kCsrTile words: the words to out, or (the
// last pass) each word's index to order and its bin to sbin (nbins for a
// word that is not live).  dstart: the digit starts.
__global__ void __launch_bounds__(kThreads, 2) csr_pass(
    Words src, long long n, int shift, int nd, const int* __restrict__ dstart,
    int* __restrict__ next_tile, unsigned* __restrict__ status, long long* __restrict__ out,
    int* __restrict__ order, int* __restrict__ sbin, int nbins) {
  constexpr int kChunk = kWarp * kCsrSteps;   // words per warp, in order
  extern __shared__ __align__(16) long long buf[];
  const int nb = nd + 1;
  int* wcnt = reinterpret_cast<int*>(buf + kCsrTile);   // kWarpsPerCta x nb
  int* agg = wcnt + kWarpsPerCta * nb;
  int* local = agg + nb;
  int* base = local + nb;
  __shared__ int s_tile, scan_tmp[kWarpsPerCta];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  if (threadIdx.x == 0) s_tile = atomicAdd(next_tile, 1);
  for (int k = threadIdx.x; k < kWarpsPerCta * nb; k += kThreads) wcnt[k] = 0;
  __syncthreads();
  const long long t = s_tile;
  const long long beg = t * kCsrTile;
  const int items = (int)(n - beg < kCsrTile ? n - beg : kCsrTile);
  // the warp's chunk: every load at once, then ranked in order 32 a step
  const long long c0 = beg + (long long)warp * kChunk + lane;
  long long w[kCsrSteps];
#pragma unroll
  for (int s = 0; s < kCsrSteps; ++s) w[s] = c0 + s * kWarp < n ? src(c0 + s * kWarp) : 0;
  int* run = wcnt + warp * nb;
  const unsigned lower = (1u << lane) - 1u;
  const int dbits = 32 - __clz(nb);        // bits of a digit, the idle lane's nb included
  unsigned rk[kCsrSteps / 2] = {};         // ranks in the warp's chunk, two 16-bit a word
#pragma unroll
  for (int s = 0; s < kCsrSteps; ++s) {
    const bool act = c0 + s * kWarp < n;
    const int d = act ? digit_of(w[s], shift, nd) : nb;   // nb: idle lane
    // the lanes of equal digit: one ballot per bit (measured faster than
    // __match_any_sync)
    unsigned peers = kFull;
    for (int bit = 0; bit < dbits; ++bit) {
      const unsigned set = __ballot_sync(kFull, (d >> bit) & 1);
      peers &= (d >> bit) & 1 ? set : ~set;
    }
    const int rr = __popc(peers & lower);
    const int prior = act ? run[d] : 0;
    __syncwarp();
    if (act && rr == 0) run[d] = prior + __popc(peers);
    __syncwarp();
    rk[s / 2] |= (unsigned)(prior + rr) << (16 * (s % 2));
  }
  __syncthreads();
  // per digit each warp's base and the tile's aggregate, published at once
  // (the first tile's is its inclusive prefix), then each digit's start in
  // the tile: a thread per kDigitsPerThread consecutive digits
  unsigned* mine = status + t * nb;
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kDigitsPerThread; ++j) {
    const int k = kDigitsPerThread * threadIdx.x + j;
    if (k < nb) {
      int acc = 0;
      for (int v = 0; v < kWarpsPerCta; ++v) {
        const int c = wcnt[v * nb + k];
        wcnt[v * nb + k] = acc;
        acc += c;
      }
      agg[k] = acc;
      sum += acc;
      store_relaxed(mine + k, (t == 0 ? kCsrPrefix : kCsrAggregate) | (unsigned)acc);
    }
  }
  int at = block_exclusive_scan(sum, scan_tmp);
#pragma unroll
  for (int j = 0; j < kDigitsPerThread; ++j) {
    const int k = kDigitsPerThread * threadIdx.x + j;
    if (k < nb) {
      local[k] = at;
      at += agg[k];
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kCsrSteps; ++s)        // the tile sorted by digit
    if (c0 + s * kWarp < n) {
      const int d = digit_of(w[s], shift, nd);
      buf[local[d] + run[d] + ((rk[s / 2] >> (16 * (s % 2))) & 0xffffu)] = w[s];
    }
  __syncthreads();
  // look-back: where the tile's first word of each digit goes
  if (t > 0) {
    look_back_digits(status, t, nb, mine, agg, base);
  } else {
    for (int k = threadIdx.x; k < nb; k += kThreads) base[k] = 0;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nb; k += kThreads) base[k] += dstart[k] - local[k];
  __syncthreads();
  for (int i = threadIdx.x; i < items; i += kThreads) {   // out by digit runs
    const long long v = buf[i];
    const long long p = base[digit_of(v, shift, nd)] + i;
    if (order) {
      order[p] = (int)v;
      sbin[p] = v >= 0 ? (int)(v >> 32) : nbins;
    } else {
      out[p] = v;
    }
  }
}

// start[b], the first place whose sorted bin is b or more: a binary search
// of the sorted bins per bin.  (A fill of each place's run of bins, the
// warp filling a long run, measured faster on the kernel phase's and a
// wave's batches, and about twice as slow summed over the extensions
// path's calls, where a few long runs each fall to one warp.)
__global__ void csr_starts(const int* __restrict__ sbin, long long n, long long nbins,
                           int* __restrict__ start) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x; b <= nbins;
       b += stride) {
    long long lo = 0, hi = n;
    while (lo < hi) {
      const long long mid = (lo + hi) / 2;
      if (sbin[mid] < b) lo = mid + 1; else hi = mid;
    }
    start[b] = (int)lo;
  }
}

// Where one bin_csr call keeps what in its scratch (byte offsets): the
// control words (each pass's tile counter, csr_count's done counter), the
// digit counts and every pass's status words -- all zeroed by one memset
// -- then the words between passes and the sorted bins.
struct CsrLayout {
  CsrPlan plan;
  long long tiles, counts, status[kMaxPasses], zeroed, words[2], sbin, bytes;
};

CsrLayout csr_layout(long long n, long long nbins) {
  CsrLayout L{};
  int bits = 1;
  while ((1LL << bits) < nbins) ++bits;
  const int passes = (bits + kDigitBits - 1) / kDigitBits;
  L.plan.passes = passes;
  for (int p = 0, shift = 0; p < passes; ++p) {
    const int width = bits / passes + (p < bits % passes);
    L.plan.shift[p] = shift;
    L.plan.nd[p] = 1 << width;
    shift += width;
  }
  L.tiles = (n + kCsrTile - 1) / kCsrTile;
  auto up = [](long long b) { return (b + 255) / 256 * 256; };   // 256-byte aligned
  long long off = 256;
  L.counts = off;
  off += up(sizeof(int) * passes * kDigitStride);
  for (int p = 0; p < passes; ++p) {
    L.status[p] = off;
    off += up(sizeof(unsigned) * L.tiles * (L.plan.nd[p] + 1));
  }
  L.zeroed = off;
  for (int q = 0; q < 2; ++q) {            // pass p < last writes words[p % 2]
    L.words[q] = off;
    if (q < passes - 1) off += up(sizeof(long long) * n);
  }
  L.sbin = off;
  L.bytes = off + up(sizeof(int) * n);
  return L;
}

int grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = 132LL * 64;         // enough CTAs to fill 132 SMs
  return (int)(blocks < cap ? blocks : cap);
}

template <int kNb>
cudaError_t bo_rank_tiles_launch(const void* bins, const void* valid, long long n, int nb,
                            void* scratch, void* counts, void* offsets, cudaStream_t s) {
  const long long tiles = (n + kTileItems - 1) / kTileItems;
  cudaMemsetAsync(scratch, 0, sizeof(unsigned long long) * (1 + tiles * nb), s);
  const size_t shmem = bo_rank_tiles_shmem(nb);
  cudaFuncSetAttribute(bo_rank_tiles<kNb>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)shmem);
  const bool vec = ((uintptr_t)bins | (uintptr_t)valid) % 16 == 0;
  unsigned long long* words = (unsigned long long*)scratch;
  bo_rank_tiles<kNb><<<(int)tiles, kThreads, shmem, s>>>(
      (const int*)bins, (const unsigned char*)valid, n, nb, vec, (int*)words, words + 1,
      (int*)counts, (int*)offsets);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int bin_offsets_max_bins() { return kMaxBins; }

// bins (n,) i32, valid (n,) u8, nb = nbins + 1 (invalid bin last);
// scratch (1 + ceil(n / kTileItems) * nb,) u64: the tile counter, then
// the status words (zeroed here).  Out counts (nb,) i32, offsets (n,) i32.
int bin_offsets_launch(const void* bins, const void* valid, long long n, int nb,
                       void* scratch, void* counts, void* offsets, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nb < 1 || nb > kMaxBins) return (int)cudaErrorInvalidValue;
  if (n == 0) {
    cudaMemsetAsync(counts, 0, sizeof(int) * nb, s);
    return (int)cudaGetLastError();
  }
  // by ballots only with one bin (and the invalid one): about 10% faster
  // at 2**23-2**24 items, no faster at 2**19 or with more bins
  if (nb == 2)
    return (int)bo_rank_tiles_launch<2>(bins, valid, n, nb, scratch, counts, offsets, s);
  return (int)bo_rank_tiles_launch<0>(bins, valid, n, nb, scratch, counts, offsets, s);
}

// Bytes of scratch bin_csr_launch takes for n items into nbins bins.
long long bin_csr_scratch_bytes(long long n, long long nbins) {
  return csr_layout(n, nbins).bytes;
}

// bins (n,) i32 at row stride bstride, valid (n,) u8, n < 2**30, 1 <= nbins < 2**31;
// scratch (bin_csr_scratch_bytes,) 8-byte aligned; out order (n,) i32,
// start (nbins + 1,) i32.
int bin_csr_launch(const void* bins, long long bstride, const void* valid, long long n,
                   long long nbins, void* scratch, void* order, void* start, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n >= (1LL << 30) || nbins < 1 || nbins >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const CsrLayout L = csr_layout(n, nbins);
  char* base = (char*)scratch;
  int* sbin = (int*)(base + L.sbin);
  if (n > 0) {
    cudaMemsetAsync(base, 0, L.zeroed, s);
    const long long want = (n + kThreads * kCountItems - 1) / (kThreads * kCountItems);
    csr_count<<<(int)(want < kCountCtas ? want : kCountCtas), kThreads, 0, s>>>(
        (const int*)bins, bstride, (const unsigned char*)valid, n, nbins, L.plan,
        (int*)(base + L.counts), (int*)base + kMaxPasses);
    Words src{nullptr, (const int*)bins, bstride, (const unsigned char*)valid, nbins};
    for (int p = 0; p < L.plan.passes; ++p) {
      const bool last = p == L.plan.passes - 1;
      long long* out = last ? nullptr : (long long*)(base + L.words[p % 2]);
      const int nd = L.plan.nd[p];
      const size_t shmem = csr_pass_shmem(nd + 1);
      cudaFuncSetAttribute(csr_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
      csr_pass<<<(int)L.tiles, kThreads, shmem, s>>>(
          src, n, L.plan.shift[p], nd, (const int*)(base + L.counts) + p * kDigitStride,
          (int*)base + p, (unsigned*)(base + L.status[p]), out, last ? (int*)order : nullptr,
          last ? sbin : nullptr, (int)nbins);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      src = Words{out, nullptr, 0, nullptr, nbins};
    }
  }
  csr_starts<<<grid_for(nbins + 1), kThreads, 0, s>>>(sbin, n, nbins, (int*)start);
  return (int)cudaGetLastError();
}

// rows (n, wmax) i32; bins/flow/off (n,) i32; valid (n,) u8; per-flow
// tables woff/roww/caps/rounds (nflows,) i32; out (total,) i32.
int pack_rows_launch(const void* rows, int wmax, const void* bins, const void* flow,
                     const void* off, const void* valid, long long n,
                     const void* woff, const void* roww, const void* caps,
                     const void* rounds, int nflows, int rnd, long long wtot,
                     long long total, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (total > 0) cudaMemsetAsync(out, 0, sizeof(int) * total, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n * wmax == 0 || total == 0) return (int)err;
  const long long ctas = (n + kThreads - 1) / kThreads;
  const long long cap = 132LL * 128;        // each CTA loads the tables once
  const size_t shmem = nflows <= kMaxSharedFlows ? sizeof(int) * 4 * nflows : 0;
  pack_rows_kernel<<<(int)(ctas < cap ? ctas : cap), kThreads, shmem, s>>>(
      (const int*)rows, wmax, (const int*)bins, (const int*)flow, (const int*)off,
      (const unsigned char*)valid, n, (const int*)woff, (const int*)roww,
      (const int*)caps, (const int*)rounds, nflows, rnd, wtot, total, (int*)out);
  return (int)cudaGetLastError();
}

// dst (total,) i32; slots (m,) i32; rows (m, w) i32; out (total,) i32.
int place_rows_launch(const void* dst, long long total, const void* slots,
                      const void* rows, long long m, int w, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (total == 0) return (int)cudaGetLastError();
  copy_words<<<grid_for(total), kThreads, 0, s>>>((const int*)dst, total, (int*)out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || m * w == 0) return (int)err;
  place_rows_kernel<<<grid_for(m * w), kThreads, 0, s>>>(
      (const int*)slots, (const int*)rows, m, w, total, (int*)out);
  return (int)cudaGetLastError();
}

// bins/flow/off (n,) i32; valid (n,) u8; per-flow tables (nflows,) i32;
// out (n,) i32.
int ragged_slots_launch(const void* bins, const void* flow, const void* off,
                        const void* valid, long long n, const void* woff,
                        const void* roww, const void* caps, const void* rounds,
                        int nflows, int rnd, long long wtot, long long sentinel,
                        void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0) return (int)cudaGetLastError();
  ragged_slots_kernel<<<grid_for(n), kThreads, 0, s>>>(
      (const int*)bins, (const int*)flow, (const int*)off, (const unsigned char*)valid, n,
      (const int*)woff, (const int*)roww, (const int*)caps, (const int*)rounds, nflows,
      rnd, wtot, sentinel, (int*)out);
  return (int)cudaGetLastError();
}

// rows: m rows of `lanes` u32 words, row i at word i * row_stride;
// out (m,) u32.
int row_mix_launch(const void* rows, long long m, long long row_stride, int lanes,
                   void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m == 0) return (int)cudaGetLastError();
  row_mix_kernel<<<grid_for(m), kThreads, 0, s>>>((const unsigned*)rows, m, row_stride,
                                                  lanes, (unsigned*)out);
  return (int)cudaGetLastError();
}

// bins (n,) i32; valid (n,) u8; out counts (nbins,) i32 (zeroed here).
int histogram_launch(const void* bins, const void* valid, long long n, int nbins,
                     void* counts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nbins < 1) return (int)cudaErrorInvalidValue;
  cudaMemsetAsync(counts, 0, sizeof(int) * nbins, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n == 0) return (int)err;
  const long long want = (n + kThreads * kGroup - 1) / (kThreads * kGroup);
  const long long cap = kSMs * 8LL;        // a few CTAs per SM: one flush each
  const int grid = (int)(want < cap ? want : cap);
  const bool vec = ((uintptr_t)bins | (uintptr_t)valid) % 16 == 0;
  if (nbins <= kFewBins) {
    histogram_kernel<true><<<grid, kThreads, sizeof(int) * nbins, s>>>(
        (const int*)bins, (const unsigned char*)valid, n, nbins, vec, 1, (int*)counts);
  } else {
    // a copy of the counters per warp while they fit, else fewer (0: global)
    int copies = nbins <= kMaxSharedBins ? kMaxSharedBins / nbins : 0;
    copies = copies < kWarpsPerCta ? copies : kWarpsPerCta;
    histogram_kernel<false><<<grid, kThreads, sizeof(int) * copies * nbins, s>>>(
        (const int*)bins, (const unsigned char*)valid, n, nbins, vec, copies, (int*)counts);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
