// Exchange wire kernels for Hopper (sm_90a): bin_offsets, pack_rows,
// place_rows.  Plain C entry points, bound with ctypes by
// repro_torch/kernels/binning.py; every entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().
// All u32 words travel as 32-bit ints; only bit patterns matter.
//
// bin_offsets replaces src/repro/kernels/binning.py::bin_offsets
// (_offsets_kernel).  Per item: its stable rank among the valid items
// of its bin; per bin: the valid count.  The TPU kernel carries the
// running per-bin prefix from one grid step to the next, which relies
// on the steps running in order.  GPU blocks run in no order, so this
// is three passes over warp-sized segments of kSegItems items:
//   1. bo_count: per-segment bin counts (shared-memory atomics; order
//      does not matter for a count);
//   2. bo_scan: per bin, an exclusive scan of the segment counts (one
//      CTA per bin) -> each segment's base, plus the bin totals;
//   3. bo_rank: each warp walks its segment 32 items at a time in
//      order; __match_any_sync groups the lanes of equal bins, the rank
//      inside the group is the popcount of lower peer lanes, and the
//      lowest peer advances the segment's running counter.  So ranks
//      equal stable-argsort ranks exactly.
// Invalid items rank in an extra last bin, so the offsets agree with
// the plain version (stable argsort with invalid items last) bit for
// bit.  Bound: bytes -- 9 bytes read and 4 written per item, read
// twice (passes 1 and 3); the scan touches nseg * nbins ints.
// At most kMaxBins bins (including the invalid one): the per-warp
// counters of pass 3 live in shared memory.
//
// pack_rows replaces src/repro/kernels/binning.py::pack_rows
// (_pack_rows_kernel): the ragged word slot of each row for retry
// round rnd and the scatter of its first roww[flow] words into the
// flat send buffer, fused.  The TPU kernel keeps the whole buffer in
// one VMEM block; here it lives in device memory: one memset, then one
// thread per (row, lane) word.  Slots are unique, so no atomics; words
// nobody writes stay 0 (the wire checksum relies on fmix32(0) == 0).
// Bound: bytes -- rows read once, buffer written once (twice with the
// memset).
//
// place_rows replaces src/repro/kernels/binning.py::place_rows
// (_place_rows_kernel): a copy of dst with fixed-width rows written at
// explicit word slots; a word at or past the end drops.  A copy kernel
// then one thread per (row, lane) word.  Bound: bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kSegItems = 1024;    // items per warp segment (bin_offsets)
constexpr int kWarpsPerCta = 8;
constexpr int kMaxBins = 1024;     // including the invalid bin
constexpr int kThreads = 256;

__device__ __forceinline__ int bucket_of(int bin, unsigned char valid, int nb) {
  // nb includes the invalid bin (nb - 1)
  return (valid && bin >= 0 && bin < nb - 1) ? bin : nb - 1;
}

__global__ void bo_count(const int* __restrict__ bins,
                         const unsigned char* __restrict__ valid, long long n,
                         int nb, long long nseg, int* __restrict__ seg_counts) {
  extern __shared__ int sh[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const long long seg = (long long)blockIdx.x * kWarpsPerCta + warp;
  int* cnt = sh + warp * nb;
  for (int b = lane; b < nb; b += kWarp) cnt[b] = 0;
  __syncwarp();
  if (seg < nseg) {
    const long long beg = seg * kSegItems;
    const long long end = beg + kSegItems < n ? beg + kSegItems : n;
    for (long long i = beg + lane; i < end; i += kWarp)
      atomicAdd(&cnt[bucket_of(bins[i], valid[i], nb)], 1);
  }
  __syncwarp();
  if (seg < nseg)
    for (int b = lane; b < nb; b += kWarp) seg_counts[seg * nb + b] = cnt[b];
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

__global__ void bo_rank(const int* __restrict__ bins,
                        const unsigned char* __restrict__ valid, long long n, int nb,
                        long long nseg, const int* __restrict__ seg_base,
                        int* __restrict__ offsets) {
  extern __shared__ int sh[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const long long seg = (long long)blockIdx.x * kWarpsPerCta + warp;
  if (seg >= nseg) return;                  // uniform across the warp
  int* run = sh + warp * nb;
  for (int b = lane; b < nb; b += kWarp) run[b] = seg_base[seg * nb + b];
  __syncwarp();
  const long long beg = seg * kSegItems;
  const long long end = beg + kSegItems < n ? beg + kSegItems : n;
  const unsigned lower = (1u << lane) - 1u;
  for (long long base = beg; base < end; base += kWarp) {
    const long long i = base + lane;
    const bool act = i < end;
    const int b = act ? bucket_of(bins[i], valid[i], nb) : nb;   // nb: idle lane
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    const int r = __popc(peers & lower);
    if (act) offsets[i] = run[b] + r;
    __syncwarp();
    if (act && r == 0) run[b] += __popc(peers);
    __syncwarp();
  }
}

__global__ void pack_rows_kernel(const int* __restrict__ rows, int wmax,
                                 const int* __restrict__ bins,
                                 const int* __restrict__ flow,
                                 const int* __restrict__ off,
                                 const unsigned char* __restrict__ valid, long long n,
                                 const int* __restrict__ woff,
                                 const int* __restrict__ roww,
                                 const int* __restrict__ caps,
                                 const int* __restrict__ rounds, int nflows, int rnd,
                                 long long wtot, long long total, int* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < n * wmax;
       t += stride) {
    const long long i = t / wmax;
    const int lane = (int)(t - i * wmax);
    if (!valid[i]) continue;
    const int f = flow[i];
    if (f < 0 || f >= nflows || rounds[f] <= rnd || lane >= roww[f]) continue;
    const long long cap = caps[f];
    const long long off_r = (long long)off[i] - (long long)rnd * cap;
    if (off_r < 0 || off_r >= cap) continue;
    const long long w = (long long)bins[i] * wtot + woff[f] + off_r * roww[f] + lane;
    if (w >= 0 && w < total) out[w] = rows[t];
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

int grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = 132LL * 64;         // enough CTAs to fill 132 SMs
  return (int)(blocks < cap ? blocks : cap);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int bin_offsets_max_bins() { return kMaxBins; }

// bins (n,) i32, valid (n,) u8, nb = nbins + 1 (invalid bin last);
// scratch seg_counts/seg_base (ceil(n / kSegItems) * nb,) i32;
// out counts (nb,) i32, offsets (n,) i32.
int bin_offsets_launch(const void* bins, const void* valid, long long n, int nb,
                       void* seg_counts, void* seg_base, void* counts, void* offsets,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nb < 1 || nb > kMaxBins) return (int)cudaErrorInvalidValue;
  if (n == 0) {
    cudaMemsetAsync(counts, 0, sizeof(int) * nb, s);
    return (int)cudaGetLastError();
  }
  const long long nseg = (n + kSegItems - 1) / kSegItems;
  const int ctas = (int)((nseg + kWarpsPerCta - 1) / kWarpsPerCta);
  const size_t shmem = sizeof(int) * kWarpsPerCta * nb;
  bo_count<<<ctas, kWarpsPerCta * kWarp, shmem, s>>>(
      (const int*)bins, (const unsigned char*)valid, n, nb, nseg, (int*)seg_counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bo_scan<<<nb, 1024, 0, s>>>((const int*)seg_counts, nseg, nb, (int*)seg_base,
                              (int*)counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bo_rank<<<ctas, kWarpsPerCta * kWarp, shmem, s>>>(
      (const int*)bins, (const unsigned char*)valid, n, nb, nseg,
      (const int*)seg_base, (int*)offsets);
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
  pack_rows_kernel<<<grid_for(n * wmax), kThreads, 0, s>>>(
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

}  // extern "C"
