// Exchange wire kernels for Hopper (sm_90a): bin_offsets, pack_rows,
// place_rows, ragged_slots, row_mix, histogram.  Plain C entry points, bound with ctypes by
// repro_torch/kernels/binning.py; every entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().
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
// starts.  A stable counting sort by least-significant digit: each item
// travels as a 64-bit word bin << 32 | index (a negative word when it is
// not live; the first pass reads the bins and makes the words on the
// fly), and each pass over a digit of at most 10 bits is a stable
// partition of the previous pass's order.  A pass is the three steps of
// bin_offsets over CTA segments of kDigitSegItems words: bd_count counts
// each segment's digits, bo_scan gives each segment's base per digit
// and the digit totals, bd_starts scans the totals; bd_place recounts
// its segment per warp, walks each warp's kSegItems words in order, 32
// at a time, ranking equal digits with __match_any_sync,
// sorts the segment by digit in shared memory that way, and writes it
// out, so each digit's run of the segment goes out as consecutive
// words.  csr_finish then takes each place's index and, by binary
// search of the sorted bins, each bin's start.  Bound: bytes -- per
// pass the words read twice and written once, the segment tables
// nseg * (digits + 1) ints.
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
// integers: each block counts in shared memory, the lanes of a warp
// that hold the same bin merged by __match_any_sync into one atomicAdd,
// and flushes once per bin to global memory.  Bins outside [0, nbins)
// are not counted.  Above kMaxSharedBins bins the counts go straight to
// global atomics.  Bound: bytes -- 5 bytes read per item.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kSegItems = 1024;    // words per warp segment (bin_csr)
constexpr int kWarpsPerCta = 8;
constexpr int kMaxBins = 1024;     // including the invalid bin
constexpr int kDigitBits = 10;     // bits of the bin one bin_csr pass sorts by
constexpr int kDigitSegItems = kWarpsPerCta * kSegItems;   // words per bin_csr CTA
constexpr int kThreads = 256;
constexpr int kMaxSharedBins = 12288;   // 48 KB of shared counters
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

__device__ __forceinline__ int bucket_of(int bin, unsigned char valid, int nb) {
  // nb includes the invalid bin (nb - 1)
  return (valid && bin >= 0 && bin < nb - 1) ? bin : nb - 1;
}

__global__ void bo_scan(const int* __restrict__ seg_counts, long long nseg, int nb,
                        int* __restrict__ seg_base, int* __restrict__ counts) {
  __shared__ int part[1024];
  const int b = blockIdx.x, t = threadIdx.x, T = blockDim.x;
  const long long per = (nseg + T - 1) / T;
  const long long beg = per * t;
  const long long end = beg + per < nseg ? beg + per : nseg;
  int s = 0;
  for (long long g = beg; g < end; ++g) s += seg_counts[g * nb + b];
  part[t] = s;
  __syncthreads();
  for (int off = 1; off < T; off <<= 1) {   // Hillis-Steele inclusive scan
    const int v = t >= off ? part[t - off] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  int run = part[t] - s;                    // exclusive prefix of this chunk
  for (long long g = beg; g < end; ++g) {
    const int c = seg_counts[g * nb + b];
    seg_base[g * nb + b] = run;
    run += c;
  }
  if (t == T - 1) counts[b] = part[t];
}

__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
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

template <bool kShared>
__global__ void histogram_kernel(const int* __restrict__ bins,
                                 const unsigned char* __restrict__ valid, long long n,
                                 int nbins, int* __restrict__ counts) {
  extern __shared__ int sh[];
  int* cnt = kShared ? sh : counts;
  if (kShared) {
    for (int b = threadIdx.x; b < nbins; b += blockDim.x) sh[b] = 0;
    __syncthreads();
  }
  const int lane = threadIdx.x % kWarp;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // the loop bound is warp-uniform: every lane of a warp takes part in
  // each __match_any_sync
  for (long long base = (long long)blockIdx.x * blockDim.x + threadIdx.x - lane; base < n;
       base += stride) {
    const long long i = base + lane;
    int b = -1;
    if (i < n && valid[i]) {
      const int v = bins[i];
      if (v >= 0 && v < nbins) b = v;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    if (b >= 0 && lane == __ffs(peers) - 1) atomicAdd(&cnt[b], __popc(peers));
  }
  if (kShared) {
    __syncthreads();
    for (int b = threadIdx.x; b < nbins; b += blockDim.x)
      if (sh[b]) atomicAdd(&counts[b], sh[b]);
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
// (at row stride bstride; read only for a valid item) in the first.
struct Words {
  const long long* words;
  const int* bins;
  long long bstride;
  const unsigned char* valid;
  long long nbins;
  __device__ __forceinline__ long long operator()(long long i) const {
    if (words) return words[i];
    const long long b = valid[i] ? (long long)bins[i * bstride] : -1;
    return (b >= 0 && b < nbins ? b << 32 : -(1LL << 32)) | i;
  }
};

// The digit of a word, or nd for a word that is not live (the last bin).
__device__ __forceinline__ int digit_of(long long w, int shift, int nd) {
  return w >= 0 ? (int)((w >> (32 + shift)) & (nd - 1)) : nd;
}

__global__ void bd_count(Words src, long long n, int shift, int nd,
                         int* __restrict__ seg_counts) {
  extern __shared__ int sh[];
  const int nb = nd + 1;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) sh[b] = 0;
  __syncthreads();
  const long long beg = (long long)blockIdx.x * kDigitSegItems;
  const long long end = beg + kDigitSegItems < n ? beg + kDigitSegItems : n;
  for (long long i = beg + threadIdx.x; i < end; i += blockDim.x)
    atomicAdd(&sh[digit_of(src(i), shift, nd)], 1);
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += blockDim.x)
    seg_counts[(long long)blockIdx.x * nb + b] = sh[b];
}

// out[b] = the sum of in[0:b], by one warp in chunks of 32 (in place
// allowed).
__device__ __forceinline__ void warp_exclusive_scan(const int* in, int* out, int nb,
                                                    int lane) {
  int carry = 0;
  for (int c = 0; c < nb; c += kWarp) {
    const int v = c + lane < nb ? in[c + lane] : 0;
    int x = v;
    for (int o = 1; o < kWarp; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (c + lane < nb) out[c + lane] = carry + x - v;
    carry += __shfl_sync(0xffffffffu, x, kWarp - 1);
  }
}

// start[b] = the words of the digits below b.
__global__ void bd_starts(const int* __restrict__ counts, int nb, int* __restrict__ start) {
  warp_exclusive_scan(counts, start, nb, threadIdx.x);
}

// Shared memory of bd_place: the sorted segment, each warp's digit
// counts (then bases), and per digit the segment's local and global start.
size_t bd_place_shmem(int nb) {
  return sizeof(long long) * kDigitSegItems + sizeof(int) * (kWarpsPerCta + 2) * nb;
}

__global__ void bd_place(Words src, long long n, int shift, int nd,
                         const int* __restrict__ seg_base, const int* __restrict__ start,
                         long long* __restrict__ out) {
  extern __shared__ __align__(16) long long buf[];
  const int nb = nd + 1;
  int* cnt = reinterpret_cast<int*>(buf + kDigitSegItems);   // kWarpsPerCta x nb
  int* local = cnt + kWarpsPerCta * nb;                       // nb
  int* global = local + nb;                                   // nb
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const long long seg0 = (long long)blockIdx.x * kDigitSegItems;
  const long long beg = seg0 + (long long)warp * kSegItems;
  const long long end = beg + kSegItems < n ? beg + kSegItems : n;
  const long long seg_end = seg0 + kDigitSegItems < n ? seg0 + kDigitSegItems : n;
  int* run = cnt + warp * nb;
  for (int b = lane; b < nb; b += kWarp) run[b] = 0;
  __syncwarp();
  for (long long i = beg + lane; i < end; i += kWarp)
    atomicAdd(&run[digit_of(src(i), shift, nd)], 1);
  __syncthreads();
  // per digit: each warp's local base, the digit's local start in the
  // segment and its global start
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    int acc = 0;
    for (int w = 0; w < kWarpsPerCta; ++w) {
      const int c = cnt[w * nb + b];
      cnt[w * nb + b] = acc;
      acc += c;
    }
    local[b] = acc;                         // the digit's count, scanned below
    global[b] = start[b] + seg_base[(long long)blockIdx.x * nb + b];
  }
  __syncthreads();
  if (warp == 0) warp_exclusive_scan(local, local, nb, lane);   // each digit's local start
  __syncthreads();
  const unsigned lower = (1u << lane) - 1u;
  for (long long base = beg; base < end; base += kWarp) {
    const long long i = base + lane;
    const bool act = i < end;
    const long long w = act ? src(i) : 0;
    const int d = act ? digit_of(w, shift, nd) : nb;   // nb: idle lane
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int r = __popc(peers & lower);
    if (act) buf[local[d] + run[d] + r] = w;
    __syncwarp();
    if (act && r == 0) run[d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  for (long long i = threadIdx.x; i < seg_end - seg0; i += blockDim.x) {
    const long long w = buf[i];
    const int d = digit_of(w, shift, nd);
    out[global[d] + (i - local[d])] = w;
  }
}

// Each place's index, and each bin's start: the first place whose bin
// (nbins for a word that is not live) is at least the bin.
__global__ void csr_finish(const long long* __restrict__ words, long long n, long long nbins,
                           int* __restrict__ order, int* __restrict__ start) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) order[t] = (int)(words[t] & 0xffffffffLL);
  if (t <= nbins) {
    long long lo = 0, hi = n;
    while (lo < hi) {
      const long long mid = (lo + hi) / 2;
      const long long w = words[mid];
      if ((w >= 0 ? w >> 32 : nbins) < t) lo = mid + 1; else hi = mid;
    }
    start[t] = (int)lo;
  }
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

// bins (n,) i32 at row stride bstride, valid (n,) u8, nbins >= 1;
// scratch words (2 n,) i64, seg (2 ceil(n / kDigitSegItems) (2**10 + 1),)
// i32, digits (2 (2**10 + 1),) i32; out order (n,) i32, start (nbins + 1,) i32.
int bin_csr_launch(const void* bins, long long bstride, const void* valid, long long n,
                   long long nbins, void* words, void* seg, void* digits, void* order,
                   void* start, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nbins < 1 || nbins >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  int bits = 1;
  while ((1LL << bits) < nbins) ++bits;
  const int passes = (bits + kDigitBits - 1) / kDigitBits;
  const long long nseg = (n + kDigitSegItems - 1) / kDigitSegItems;
  const int maxb = (1 << kDigitBits) + 1;
  long long* wbuf[2] = {(long long*)words, (long long*)words + n};
  int* seg_counts = (int*)seg;
  int* seg_base = seg_counts + nseg * maxb;
  int* counts = (int*)digits;
  int* dstart = counts + maxb;
  const size_t place_shmem = bd_place_shmem(maxb);
  cudaFuncSetAttribute(bd_place, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)place_shmem);
  Words src{nullptr, (const int*)bins, bstride, (const unsigned char*)valid, nbins};
  int shift = 0;
  for (int p = 0; p < passes && n > 0; ++p) {
    const int width = bits / passes + (p < bits % passes);
    const int nd = 1 << width, nb = nd + 1;
    long long* out = wbuf[p % 2];
    bd_count<<<(int)nseg, kWarpsPerCta * kWarp, sizeof(int) * nb, s>>>(src, n, shift, nd,
                                                                        seg_counts);
    bo_scan<<<nb, 1024, 0, s>>>(seg_counts, nseg, nb, seg_base, counts);
    bd_starts<<<1, kWarp, 0, s>>>(counts, nb, dstart);
    bd_place<<<(int)nseg, kWarpsPerCta * kWarp, bd_place_shmem(nb), s>>>(
        src, n, shift, nd, seg_base, dstart, out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = Words{out, nullptr, 0, nullptr, nbins};
    shift += width;
  }
  const long long threads = (n > nbins + 1 ? n : nbins + 1);
  csr_finish<<<(int)((threads + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      n > 0 ? src.words : nullptr, n, nbins, (int*)order, (int*)start);
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
  const long long cap = 132LL * 8;          // a few blocks per SM: one flush each
  long long blocks = (n + kThreads - 1) / kThreads;
  const int grid = (int)(blocks < cap ? blocks : cap);
  if (nbins <= kMaxSharedBins)
    histogram_kernel<true><<<grid, kThreads, sizeof(int) * nbins, s>>>(
        (const int*)bins, (const unsigned char*)valid, n, nbins, (int*)counts);
  else
    histogram_kernel<false><<<grid, kThreads, 0, s>>>(
        (const int*)bins, (const unsigned char*)valid, n, nbins, (int*)counts);
  return (int)cudaGetLastError();
}

}  // extern "C"
