// Scans of the recurrent mixers for Hopper (sm_90a): mamba_scan and
// rwkv_scan.  Plain C entry points, bound with ctypes by
// repro_torch/kernels/ssm_scan.py; each launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError().
//
// Neither replaces a Pallas kernel: the JAX package runs both recurrences
// as lax.scan bodies (src/repro/models/ssm.py:98-109 and :183-193), which
// XLA compiles into one loop.  Eager PyTorch would run each step as 6-8
// launches (about 1.1 M launches for one 2,048-token prefill wave of
// zamba2-7b's 68 Mamba2 layers); here one launch runs a layer's whole scan,
// at decode (T = 1) too.
//
// mamba_scan (Mamba2's SSD recurrence, ngroups = 1):
//   decay = exp(a[h] dt[t]),  h[s, p] = h[s, p] decay + B[t, s] x[t, p] dt[t],
//   y[t, p] = sum_s C[t, s] h[s, p]
// has two routes, chosen by shape, an entry point each (the wrapper counts
// each one's launches):
//   * chunked (T >= kL): the SSD form on the tensor cores, mamba_ssd_kernel
//     below.  Its products run in 3xTF32, so the final state is no longer
//     rounded as the plain loop rounds it; output and state are held to
//     the plain version at a relative L2 of 1e-5.
//   * sequential (T < kL, decode): mamba_scan_kernel, one CTA per (batch,
//     head), one thread per head column p, the column's d_state values in
//     registers; each update rounded as the plain step rounds it
//     (__fmul_rn, __fadd_rn: no contraction), so the final state equals
//     the plain version's.
// rwkv_scan (RWKV-6's data-dependent decay), one route:
//   kv[k] = key[t, k] val[t, v],  out[t, v] = sum_k r[t, k] (s[k, v] + u[h, k] kv[k]),
//   s[k, v] = w[t, k] s[k, v] + kv[k]
// the exact sequential recurrence, each value column's state spread over
// four threads (rwkv_scan_kernel below); its state updates round as the
// plain step does, so the final state equals the plain version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// --------------------------------------------------------------------------
// shared helpers: cp.async staging and 3xTF32 mma.sync
// --------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 (or 4) bytes from global to shared; src_bytes 0 zero-fills the slot
__device__ __forceinline__ void cp16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// rows [0, rows) of a float slice (row r at src + r * rs, columns [0, cols))
// into dst at a pitch of ld floats, columns [0, width) (width % 4 == 0);
// rows at or past n and columns at or past cols are zero-filled.  vec: in
// 16-byte copies (src 16-byte aligned, rs and cols multiples of 4), else in
// 4-byte copies.  Threads tid, tid + nt, ... take the pieces in turn.
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* src, long long rs,
                                           int rows, int n, int cols, int width, bool vec,
                                           int tid, int nt) {
  if (vec) {
    const int per = width / 4;
    for (int i = tid; i < rows * per; i += nt) {
      const int r = i / per, c = 4 * (i % per);
      const bool in = r < n && c < cols;
      cp16(dst + r * ld + c, in ? src + r * rs + c : src, in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < rows * width; i += nt) {
      const int r = i / width, c = i % width;
      const bool in = r < n && c < cols;
      cp4(dst + r * ld + c, in ? src + r * rs + c : src, in ? 4 : 0);
    }
  }
}

// x = hi + lo, the split of csrc/flash_attention.cu's flash_fwd_tf32: hi is
// x rounded to TF32 (to nearest, ties away from zero, as cvt.rna.tf32.f32
// rounds, here with an add and a mask), lo = x - hi exactly, passed whole:
// the tensor cores read the top 19 bits of a .tf32 operand
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(float x0, float x1, float x2, float x3,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(x0, hi[0], lo[0]);
  split(x1, hi[1], lo[1]);
  split(x2, hi[2], lo[2]);
  split(x3, hi[3], lo[3]);
}

// D (16 x 8, f32) += A (16 x 8, tf32, row) * B (8 x 8, tf32, col).  With g =
// lane / 4, t = lane % 4: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
// t + 4); b0 (t, g), b1 (t + 4, g); d0 (g, 2t), d1 (g, 2t + 1), d2 (g + 8,
// 2t), d3 (g + 8, 2t + 1).  The order of the 8 k-slots is free as long as A
// and B agree.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32 (lo*hi + hi*lo + hi*hi, the small terms first) into accumulators
// d[n0] .. d[n0 + N - 1], one pass over them per term
template <int N, int M>
__device__ __forceinline__ void mma3(float (&d)[M][4], int n0, const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[N][2],
                                     const uint32_t (&bl)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n0 + n], al, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n0 + n], ah, bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n0 + n], ah, bh[n][0], bh[n][1]);
}

// --------------------------------------------------------------------------
// mamba_scan, sequential route (T < kL): one thread a head column
// --------------------------------------------------------------------------
// Bound at decode: bytes (the state read and written).  The operands every
// thread reads (B, C, dt) are staged kChunk steps at a time in shared memory.

constexpr int kChunk = 32;
constexpr int kMaxP = 256;   // head columns a CTA takes (register cap 255 a thread)

template <int S>
__global__ void __launch_bounds__(kMaxP) mamba_scan_kernel(
    const float* __restrict__ x, long long x_sb, long long x_st,
    const float* __restrict__ dt, const float* __restrict__ bm,
    const float* __restrict__ cm, long long bc_sb, long long bc_st,
    const float* __restrict__ a, const float* __restrict__ h0, float* __restrict__ y,
    float* __restrict__ hout, int T, int H, int P) {
  const int bh = blockIdx.x;
  const int b = bh / H, hh = bh % H;
  const int p = threadIdx.x;
  __shared__ float sB[kChunk][S], sC[kChunk][S], sDt[kChunk];

  float h[S];
  const float* h0p = h0 + (long long)bh * S * P + p;
#pragma unroll
  for (int s = 0; s < S; ++s) h[s] = h0p[(long long)s * P];
  const float av = a[hh];
  const float* xrow = x + b * x_sb + (long long)hh * P + p;
  float* yrow = y + ((long long)b * T * H + hh) * P + p;

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int n = min(kChunk, T - t0);
    __syncthreads();   // the previous chunk's readers are done
    for (int i = p; i < n * S; i += P) {
      const int j = i / S, s = i % S;
      const long long off = b * bc_sb + (long long)(t0 + j) * bc_st + s;
      sB[j][s] = bm[off];
      sC[j][s] = cm[off];
    }
    for (int j = p; j < n; j += P) sDt[j] = dt[((long long)b * T + t0 + j) * H + hh];
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float dtv = sDt[j];
      const float decay = expf(__fmul_rn(av, dtv));
      const float xdt = __fmul_rn(xrow[(long long)(t0 + j) * x_st], dtv);
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        h[s] = __fadd_rn(__fmul_rn(h[s], decay), __fmul_rn(sB[j][s], xdt));
        acc = fmaf(sC[j][s], h[s], acc);
      }
      yrow[(long long)(t0 + j) * H * P] = acc;
    }
  }
  float* hop = hout + (long long)bh * S * P + p;
#pragma unroll
  for (int s = 0; s < S; ++s) hop[(long long)s * P] = h[s];
}

// --------------------------------------------------------------------------
// mamba_scan, chunked route: the SSD form on the tensor cores
// --------------------------------------------------------------------------
// T is cut into chunks of kL steps.  With A[t] = a dt[t] and cs the running
// sum of A from the chunk's start (cs[i] = A[0] + ... + A[i], summed in
// order), a chunk with carried state h (S x P) gives
//   Y[i, p]   = exp(cs[i]) (C h)[i, p] + sum_{j <= i} M[i, j] X[j, p],
//               M[i, j] = G[i, j] exp(cs[i] - cs[j]) dt[j],  G = C B^T (L x L)
//   h'[s, p]  = exp(cs[L-1]) h[s, p] + sum_j B[j, s] W[j] X[j, p],
//               W[j] = exp(cs[L-1] - cs[j]) dt[j]
// and the chunks run in order inside the CTA.  The decay exponents are
// differences of the chunk-local running sum (never of one over all of T:
// exp(cs[i] - cs[j]) would lose |cs| 2^-24 of its value), and the mask is
// applied before exp: no exponent above the diagonal is evaluated.
//
// Bound: bytes.  At zamba2-7b's prefill call (8, 2048, 112 heads of 64,
// d_state 64), x and y are 940 MB of the ~985 MB moved (0.29 ms at 3.35
// TB/s); the products are 2 (L/2 + 2 S) P flops a head and step (about 34
// GFLOP at L = 32), 0.21 ms at three TF32 passes at 495 TFLOP/s.  The
// sequential form's 5 flops a state element a step on the CUDA cores (0.56
// ms at 67 TFLOP/s; ~0.9 ms at the rounding it needs) is no bound.  The
// kernel runs at about a quarter of the bytes' bound: mma.sync's TF32 rate
// (three passes) and the phases a chunk runs in lockstep hold it.
//
// Design of mamba_ssd_kernel.  One CTA covers hg heads of one batch row (2,
// or 1 where H is odd or two heads' warps pass kMaxWarps), wp = ceil(P / 16)
// warps a head, each warp owning 16 columns p of its head for the whole
// scan.  At zamba2-7b's widths a CTA is 8 warps and 89 KB, two CTAs an SM
// (2 heads measured faster than 1 and no slower than 4 on an H100):
//   * 3xTF32 mma.sync.m16n8k8 for every product (one TF32 pass would miss
//     the 1e-5 gate; x, B, C are float32 conv outputs, so bf16 is out).
//   * The state lives in registers as the accumulator of h^T (p x s): the
//     update h^T += (W X)^T B accumulates into it, and the same registers
//     are the B fragments of C h (k = s taken in the order 2t, 2t + 1 of
//     each 8), so the state never goes through shared memory.
//   * B and C are shared by all heads (ngroups = 1): G = C B^T, 6 of its
//     8 16 x 8 tiles (those at or below the diagonal), is computed once a
//     chunk by the CTA's warps and kept in shared memory; each head's
//     warps then form M (G times its decays, each element once) there.
//   * X feeds two products: the fragment a lane loads for Y's X (j, p) is
//     the one it scales by W for the state's (W X)^T, so it is read once.
//   * The next chunk's x, B, C and dt are staged by cp.async into the
//     second of two buffers while the current chunk computes: 16-byte
//     copies where every row start is 16-byte aligned (zamba2-7b's x, B
//     and C slices are), 4-byte copies otherwise; rows past T and columns
//     past P zero-filled, so a partial chunk adds nothing to the state.
//   * Row pitches make every fragment load conflict-free: S + 8 floats
//     for B and C (float2 loads of s pairs, scalar loads of j rows), 16 wp
//     + 8 for X, kL + 4 for G and M.
namespace ssd {

constexpr int kL = 32;          // steps a chunk
constexpr int kLdM = kL + 4;    // row pitch of G and M (floats)

struct Params {
  const float *x, *dt, *bm, *cm, *a, *h0;
  float *y, *hout;
  long long x_sb, x_st, bc_sb, bc_st;   // element strides
  int T, H, P, hg, wp, vec_x, vec_bc;
};

constexpr int kMaxWarps = 8;    // warps a CTA: 2 heads of up to 64 columns, or 1 of 128

template <int S>
struct Cfg {
  static constexpr int kLdB = S + 8;   // B and C rows (floats)
  static constexpr int kNS = S / 8;    // 8-column tiles of s
  // CTAs an SM the registers must allow: two at d_state <= 64 (128 registers
  // a thread); one at 128, whose two heads' buffers pass half the shared memory
  static constexpr int kMinBlocks = S >= 128 ? 1 : 2;
};

__host__ __device__ constexpr int head_floats(int wp) {
  return 2 * kL * (16 * wp + 8) + kL * kLdM + 5 * kL;   // X x2, M, dt x2, cs, W, E
}

template <int S>
__host__ __device__ constexpr int smem_floats(int hg, int wp) {
  return 4 * kL * Cfg<S>::kLdB + kL * kLdM + hg * head_floats(wp);
}

template <int S>
__global__ void __launch_bounds__(kMaxWarps * 32, Cfg<S>::kMinBlocks)
    mamba_ssd_kernel(const Params p) {
  constexpr int LB = Cfg<S>::kLdB, NS = Cfg<S>::kNS, CH = NS < 4 ? NS : 4;
  extern __shared__ float4 smem4[];
  float* sB = reinterpret_cast<float*>(smem4);    // [2][kL][LB]
  float* sC = sB + 2 * kL * LB;                   // [2][kL][LB]
  float* sG = sC + 2 * kL * LB;                   // [kL][kLdM]
  const int ldx = 16 * p.wp + 8;

  const int groups = p.H / p.hg;                 // hg divides H
  const int b = blockIdx.x / groups, hfirst = (blockIdx.x % groups) * p.hg;
  const int tid = threadIdx.x, nt = blockDim.x, nwarps = nt >> 5;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int hl = warp / p.wp, nth = 32 * p.wp, th = tid - hl * nth;
  const int p0 = 16 * (warp % p.wp);
  const int hh = hfirst + hl;
  float* sX = sG + kL * kLdM + hl * head_floats(p.wp);   // [2][kL][ldx]
  float* sM = sX + 2 * kL * ldx;                 // [kL][kLdM]
  float* sDt = sM + kL * kLdM;                   // [2][kL]
  float* sCs = sDt + 2 * kL;                     // [kL]
  float* sW = sCs + kL;                          // [kL]
  float* sE = sW + kL;                           // [kL]: exp(cs)

  // chunk c into buffer c & 1: B and C by every thread, x and dt by the head's
  auto stage = [&](int c) {
    const int t0 = c * kL, n = min(kL, p.T - t0), buf = c & 1;
    const long long bc = b * p.bc_sb + t0 * p.bc_st;
    stage_rows(sB + buf * kL * LB, LB, p.bm + bc, p.bc_st, kL, n, S, S, p.vec_bc, tid, nt);
    stage_rows(sC + buf * kL * LB, LB, p.cm + bc, p.bc_st, kL, n, S, S, p.vec_bc, tid, nt);
    stage_rows(sX + buf * kL * ldx, ldx, p.x + b * p.x_sb + t0 * p.x_st + (long long)hh * p.P,
               p.x_st, kL, n, p.P, 16 * p.wp, p.vec_x, th, nth);
    for (int j = th; j < kL; j += nth) {
      const bool in = j < n;
      cp4(sDt + buf * kL + j, in ? p.dt + ((long long)b * p.T + t0 + j) * p.H + hh : p.dt,
          in ? 4 : 0);
    }
  };

  // hT[n]: h^T (p, s) at p = p0 + g (+8 for [2], [3]), s = 8n + 2t (+1 for [1], [3])
  float hT[NS][4];
  const long long hbase = ((long long)b * p.H + hh) * S * p.P;
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int s = 8 * n + 2 * t + (r & 1), col = p0 + g + 8 * (r >> 1);
      hT[n][r] = col < p.P ? p.h0[hbase + (long long)s * p.P + col] : 0.f;
    }

  const int nchunks = (p.T + kL - 1) / kL;
  stage(0);
  cp_commit();
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * kL, n = min(kL, p.T - t0), buf = c & 1;
    cp_wait_all();
    __syncthreads();                           // chunk c landed; chunk c - 1 is done
    if (c + 1 < nchunks) stage(c + 1);
    cp_commit();
    const float* cB = sB + buf * kL * LB;
    const float* cC = sC + buf * kL * LB;
    const float* cX = sX + buf * kL * ldx;
    const float* cDt = sDt + buf * kL;

    // G = C B^T, the tiles at or below the diagonal, a tile a warp: two
    // accumulators (even and odd k steps) halve the chain of dependent mmas
    for (int tile = warp; tile < 6; tile += nwarps) {
      const int m = tile < 2 ? 0 : 1, nj = tile < 2 ? tile : tile - 2;
      float d[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        const float2 c0 = *reinterpret_cast<const float2*>(cC + (16 * m + g) * LB + 8 * kk + 2 * t);
        const float2 c1 =
            *reinterpret_cast<const float2*>(cC + (16 * m + g + 8) * LB + 8 * kk + 2 * t);
        const float2 bb = *reinterpret_cast<const float2*>(cB + (8 * nj + g) * LB + 8 * kk + 2 * t);
        uint32_t ah[4], al[4], bh[1][2], bl[1][2];
        split4(c0.x, c1.x, c0.y, c1.y, ah, al);
        split(bb.x, bh[0][0], bl[0][0]);
        split(bb.y, bh[0][1], bl[0][1]);
        mma3<1>(d, kk & 1, ah, al, bh, bl);
      }
      float* gr = sG + (16 * m + g) * kLdM + 8 * nj + 2 * t;
      gr[0] = d[0][0] + d[1][0];
      gr[1] = d[0][1] + d[1][1];
      gr[8 * kLdM] = d[0][2] + d[1][2];
      gr[8 * kLdM + 1] = d[0][3] + d[1][3];
    }
    // the head's decays, a lane a step: cs in step order, W, exp(cs)
    if (warp % p.wp == 0) {
      const float av = p.a[hh];
      float cs = 0.f;
#pragma unroll
      for (int k = 0; k < kL; ++k) {
        const float ak = __fmul_rn(av, cDt[k]);
        if (k <= lane) cs = __fadd_rn(cs, ak);
      }
      const float last = __shfl_sync(0xffffffffu, cs, kL - 1);
      sCs[lane] = cs;
      sW[lane] = expf(last - cs) * cDt[lane];
      sE[lane] = expf(cs);
    }
    __syncthreads();                           // G and the decays are in

    // M = G o exp(cs[i] - cs[j]) dt[j] on and below the diagonal, 0 above
    for (int e = th; e < kL * kL; e += nth) {
      const int i = e / kL, j = e % kL;
      sM[i * kLdM + j] = j <= i ? sG[i * kLdM + j] * (expf(sCs[i] - sCs[j]) * cDt[j]) : 0.f;
    }
    __syncthreads();                           // M is in

    // Y = exp(cs) o (C h): acc[m][q] rows 16m + g (+8), columns p0 + 8q + 2t (+1);
    // k = s in the order (2t, 2t + 1) of each 8, so hT is the B fragment
    float acc[2][2][4] = {};
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      uint32_t bh[2][2], bl[2][2];
      split(hT[kk][0], bh[0][0], bl[0][0]);
      split(hT[kk][1], bh[0][1], bl[0][1]);
      split(hT[kk][2], bh[1][0], bl[1][0]);
      split(hT[kk][3], bh[1][1], bl[1][1]);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float2 c0 = *reinterpret_cast<const float2*>(cC + (16 * m + g) * LB + 8 * kk + 2 * t);
        const float2 c1 =
            *reinterpret_cast<const float2*>(cC + (16 * m + g + 8) * LB + 8 * kk + 2 * t);
        uint32_t ah[4], al[4];
        split4(c0.x, c1.x, c0.y, c1.y, ah, al);
        mma3<2>(acc[m], 0, ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float e0 = sE[16 * m + g], e1 = sE[16 * m + g + 8];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        acc[m][q][0] *= e0;
        acc[m][q][1] *= e0;
        acc[m][q][2] *= e1;
        acc[m][q][3] *= e1;
      }
    }
    const float decay = sE[kL - 1];
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int r = 0; r < 4; ++r) hT[s][r] *= decay;

    // over 8-step blocks kk of j: Y += M X (blocks at or below the diagonal),
    // h^T += (W X)^T B; k = j in the order (t, t + 4)
#pragma unroll
    for (int kk = 0; kk < kL / 8; ++kk) {
      const float* xr = cX + (8 * kk + t) * ldx + p0 + g;
      const float x00 = xr[0], x10 = xr[8], x01 = xr[4 * ldx], x11 = xr[4 * ldx + 8];
      uint32_t xh[2][2], xl[2][2];
      split(x00, xh[0][0], xl[0][0]);
      split(x01, xh[0][1], xl[0][1]);
      split(x10, xh[1][0], xl[1][0]);
      split(x11, xh[1][1], xl[1][1]);
#pragma unroll
      for (int m = kk / 2; m < 2; ++m) {
        const float* mr = sM + (16 * m + g) * kLdM + 8 * kk + t;
        uint32_t ah[4], al[4];
        split4(mr[0], mr[8 * kLdM], mr[4], mr[8 * kLdM + 4], ah, al);
        mma3<2>(acc[m], 0, ah, al, xh, xl);
      }
      const float w0 = sW[8 * kk + t], w1 = sW[8 * kk + t + 4];
      uint32_t ah[4], al[4];
      split4(w0 * x00, w0 * x10, w1 * x01, w1 * x11, ah, al);
      const float* br = cB + (8 * kk + t) * LB + g;
#pragma unroll
      for (int n0 = 0; n0 < NS; n0 += CH) {
        uint32_t bh[CH][2], bl[CH][2];
#pragma unroll
        for (int n = 0; n < CH; ++n) {
          split(br[8 * (n0 + n)], bh[n][0], bl[n][0]);
          split(br[4 * LB + 8 * (n0 + n)], bh[n][1], bl[n][1]);
        }
        mma3<CH>(hT, n0, ah, al, bh, bl);
      }
    }

    // y rows t0 + i < T, columns < P
    const long long yrs = (long long)p.H * p.P;
    float* yb = p.y + ((long long)b * p.T + t0) * yrs + (long long)hh * p.P;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 16 * m + g + 8 * half, col = p0 + 8 * q + 2 * t;
          if (i >= n) continue;
          float* yp = yb + i * yrs + col;
          const float v0 = acc[m][q][2 * half], v1 = acc[m][q][2 * half + 1];
          if ((p.P & 1) == 0 && col + 1 < p.P) {
            *reinterpret_cast<float2*>(yp) = make_float2(v0, v1);
          } else {
            if (col < p.P) yp[0] = v0;
            if (col + 1 < p.P) yp[1] = v1;
          }
        }
  }
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int s = 8 * n + 2 * t + (r & 1), col = p0 + g + 8 * (r >> 1);
      if (col < p.P) p.hout[hbase + (long long)s * p.P + col] = hT[n][r];
    }
}

template <int S>
int launch(const Params& p, int nb, cudaStream_t stream) {
  if (p.hg < 1 || p.wp < 1 || p.hg * p.wp > kMaxWarps || p.H % p.hg != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = 4 * smem_floats<S>(p.hg, p.wp);
  static int allowed = 0;   // the dynamic shared memory this instance was allowed
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        mamba_ssd_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  mamba_ssd_kernel<S><<<nb * (p.H / p.hg), 32 * p.hg * p.wp, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace ssd

// --------------------------------------------------------------------------
// rwkv_scan: the exact recurrence, each value column over four warps
// --------------------------------------------------------------------------
// Bound: bytes (0.20 ms at rwkv6-1.6b's prefill call, (8, 2048, 32 heads of
// 64)); the operations the function needs, 5 float32 flops a state element
// a step (k v, the FMA r s, w s and its sum) and 5 a step and k for the
// bonus, take 0.16 ms on the CUDA cores.
// A chunked form would divide by running products of w = exp(-exp(.)),
// which leave float32 when w is small, so the scan stays sequential.
//
// Design of rwkv_scan_kernel.  One CTA per (batch, head), kQ K threads:
// thread (q, v) = (tid / K, tid % K) owns rows [q K/4, (q + 1) K/4) of value
// column v, K/4 state values in registers, so the chain of dependent sums
// in a step is K/4 long (in two chains of K/8) and the SM holds 4x the
// warps of one thread a column.
//   * The state updates round as the plain step rounds them (__fmul_rn,
//     __fadd_rn: w s and k v each rounded, then their sum), so the final
//     state is bit-identical to the plain version's.
//   * The bonus u k v is factored out of the sum over k: out[v] = sum_k r
//     s[k, v] + v sum_k r u k, the second sum taken once a step for the
//     CTA (4 instructions a state element remain: k v, the FMA r s, w s,
//     its sum).
//   * A warp's lanes share q, so the r, key and w rows a step reads are
//     warp-uniform float4 broadcasts.  Each thread writes its partial sum
//     of a step to shared memory; after the chunk's steps the CTA combines
//     the four of each (step, column) as (q0 + q1) + (q2 + q3), adds v
//     times the bonus sum, and stores the chunk's outputs row by row.  The
//     output is held at 1e-5 relative L2.
//   * r, key, w and val go through cp.async, kSteps steps at a time, into
//     the second of two buffers while the current chunk's steps run: no
//     global load is left in the step loop.
namespace rwkv {

constexpr int kQ = 4;        // threads a value column, K threads apart
constexpr int kSteps = 32;   // steps a staged chunk

template <int K>
__host__ __device__ constexpr int smem_floats() {
  // r, key, w, val x2; u; the bonus sums; the partial sums
  return 2 * 4 * kSteps * K + K + kSteps + kQ * kSteps * K;
}

template <int K>
__global__ void __launch_bounds__(kQ * K) rwkv_scan_kernel(
    const float* __restrict__ r, const float* __restrict__ key, const float* __restrict__ val,
    const float* __restrict__ w, const float* __restrict__ u, const float* __restrict__ s0,
    float* __restrict__ out, float* __restrict__ sout, int T, int H, int vec) {
  constexpr int NT = kQ * K, NK = K / kQ, PER = K / 8;   // PER: threads a bonus sum
  extern __shared__ float4 smem4[];
  float* sOps = reinterpret_cast<float*>(smem4);   // [2][4][kSteps][K]: r, key, w, val
  float* sU = sOps + 2 * 4 * kSteps * K;           // [K]
  float* sRuk = sU + K;                            // [kSteps]: sum_k r u k
  float* sPart = sRuk + kSteps;                    // [kQ][kSteps][K]: the partial sums
  const int bh = blockIdx.x, b = bh / H, hh = bh % H;
  const int tid = threadIdx.x, q = tid / K, v = tid % K;

  float st[NK];   // st[i] = s[q NK + i, v]
  const float* s0p = s0 + (long long)bh * K * K + v;
#pragma unroll
  for (int i = 0; i < NK; ++i) st[i] = s0p[(long long)(q * NK + i) * K];
  if (tid < K) sU[tid] = u[(long long)hh * K + tid];
  // (b, t, hh, 0) of a contiguous (B, T, H, K) operand
  const long long row0 = ((long long)b * T * H + hh) * K;
  const long long tstride = (long long)H * K;
  const float* const ops[4] = {r, key, w, val};

  auto stage = [&](int c) {
    const int t0 = c * kSteps, n = min(kSteps, T - t0), buf = c & 1;
#pragma unroll
    for (int o = 0; o < 4; ++o)
      stage_rows(sOps + (buf * 4 + o) * kSteps * K, K, ops[o] + row0 + t0 * tstride, tstride,
                 kSteps, n, K, K, vec, tid, NT);
  };

  const int nchunks = (T + kSteps - 1) / kSteps;
  stage(0);
  cp_commit();
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * kSteps, n = min(kSteps, T - t0), buf = c & 1;
    cp_wait_all();
    __syncthreads();                           // chunk c landed; chunk c - 1 is combined
    if (c + 1 < nchunks) stage(c + 1);
    cp_commit();
    const float* cr = sOps + (buf * 4 + 0) * kSteps * K;
    const float* ck = cr + kSteps * K;
    const float* cw = ck + kSteps * K;
    const float* cv = cw + kSteps * K;
    {   // the bonus sums: PER threads a step, 8 rows each, then a shuffle tree
      const int j = tid / PER, part = tid % PER;
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = 8 * part + e;
        acc = fmaf(cr[j * K + k] * sU[k], ck[j * K + k], acc);
      }
#pragma unroll
      for (int off = PER / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (part == 0) sRuk[j] = acc;
    }

#pragma unroll 2
    for (int j = 0; j < n; ++j) {
      const float vv = cv[j * K + v];
      float a[2] = {0.f, 0.f};
#pragma unroll
      for (int m = 0; m < NK / 4; ++m) {
        const int k = q * NK + 4 * m;
        const float4 rr = *reinterpret_cast<const float4*>(cr + j * K + k);
        const float4 kk = *reinterpret_cast<const float4*>(ck + j * K + k);
        const float4 ww = *reinterpret_cast<const float4*>(cw + j * K + k);
        const float rv[4] = {rr.x, rr.y, rr.z, rr.w}, kv4[4] = {kk.x, kk.y, kk.z, kk.w},
                    wv[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& s = st[4 * m + e];
          const float kv = __fmul_rn(kv4[e], vv);
          a[m & 1] = fmaf(rv[e], s, a[m & 1]);
          s = __fadd_rn(__fmul_rn(wv[e], s), kv);
        }
      }
      sPart[(q * kSteps + j) * K + v] = a[0] + a[1];
    }
    __syncthreads();                           // the chunk's partial and bonus sums are in
    for (int i = tid; i < n * K; i += NT) {
      const float* pp = sPart + i;             // (q = 0, step i / K, column i % K)
      const float sum = (pp[0] + pp[kSteps * K]) + (pp[2 * kSteps * K] + pp[3 * kSteps * K]);
      out[row0 + (t0 + i / K) * tstride + i % K] = fmaf(cv[i], sRuk[i / K], sum);
    }
  }
  float* sop = sout + (long long)bh * K * K + v;
#pragma unroll
  for (int i = 0; i < NK; ++i) sop[(long long)(q * NK + i) * K] = st[i];
}

template <int K>
int launch(const float* r, const float* key, const float* val, const float* w, const float* u,
           const float* s0, float* out, float* sout, int nb, int T, int H, int vec,
           cudaStream_t stream) {
  constexpr int smem = 4 * smem_floats<K>();
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        rwkv_scan_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  rwkv_scan_kernel<K><<<nb * H, kQ * K, smem, stream>>>(r, key, val, w, u, s0, out, sout, T, H,
                                                        vec);
  return (int)cudaGetLastError();
}

}  // namespace rwkv

template <int S>
void launch_mamba(const float* x, long long x_sb, long long x_st, const float* dt,
                  const float* bm, const float* cm, long long bc_sb, long long bc_st,
                  const float* a, const float* h0, float* y, float* hout, int nb, int T, int H,
                  int P, cudaStream_t s) {
  mamba_scan_kernel<S><<<nb * H, P, 0, s>>>(x, x_sb, x_st, dt, bm, cm, bc_sb, bc_st, a, h0, y,
                                            hout, T, H, P);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The two routes of mamba_scan, an entry point each (the wrapper counts each
// one's launches).  x (nb, T, H, P) float32 at batch / step strides x_sb,
// x_st (elements), each step's (H, P) contiguous; dt (nb, T, H) contiguous;
// bm, cm (nb, T, S) at strides bc_sb, bc_st, each step's S contiguous; a
// (H,); h0, hout (nb, H, S, P) contiguous; y (nb, T, H, P) contiguous.  S in
// {16, 32, 64, 128}, T >= 1.
//
// The chunked route: heads (1 or 2, dividing H) a CTA, heads x ceil(P / 16)
// <= kMaxWarps; vec_x, vec_bc: x's, B's and C's row starts are all 16-byte
// aligned (16-byte copies).
int mamba_ssd_launch(const void* x, long long x_sb, long long x_st, const void* dt,
                     const void* bm, const void* cm, long long bc_sb, long long bc_st,
                     const void* a, const void* h0, void* y, void* hout, int nb, int T, int H,
                     int P, int S, int heads, int vec_x, int vec_bc, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const ssd::Params p{(const float*)x, (const float*)dt, (const float*)bm, (const float*)cm,
                      (const float*)a, (const float*)h0, (float*)y, (float*)hout,
                      x_sb, x_st, bc_sb, bc_st, T, H, P, heads, (P + 15) / 16, vec_x, vec_bc};
  switch (S) {
    case 16: return ssd::launch<16>(p, nb, s);
    case 32: return ssd::launch<32>(p, nb, s);
    case 64: return ssd::launch<64>(p, nb, s);
    case 128: return ssd::launch<128>(p, nb, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The sequential route: 1 <= P <= kMaxP.
int mamba_seq_launch(const void* x, long long x_sb, long long x_st, const void* dt,
                     const void* bm, const void* cm, long long bc_sb, long long bc_st,
                     const void* a, const void* h0, void* y, void* hout, int nb, int T, int H,
                     int P, int S, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float *fx = (const float*)x, *fdt = (const float*)dt, *fb = (const float*)bm,
              *fc = (const float*)cm, *fa = (const float*)a, *fh = (const float*)h0;
  float *fy = (float*)y, *fo = (float*)hout;
  switch (S) {
    case 16: launch_mamba<16>(fx, x_sb, x_st, fdt, fb, fc, bc_sb, bc_st, fa, fh, fy, fo, nb, T, H, P, s); break;
    case 32: launch_mamba<32>(fx, x_sb, x_st, fdt, fb, fc, bc_sb, bc_st, fa, fh, fy, fo, nb, T, H, P, s); break;
    case 64: launch_mamba<64>(fx, x_sb, x_st, fdt, fb, fc, bc_sb, bc_st, fa, fh, fy, fo, nb, T, H, P, s); break;
    case 128: launch_mamba<128>(fx, x_sb, x_st, fdt, fb, fc, bc_sb, bc_st, fa, fh, fy, fo, nb, T, H, P, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// r, key, val, w, out (nb, T, H, K) float32 contiguous; u (H, K); s0, sout
// (nb, H, K, K) contiguous, s[k, v] at k * K + v.  K in {16, 32, 64}, T >=
// 1; vec: the four operands' rows are 16-byte aligned (16-byte copies).
int rwkv_scan_launch(const void* r, const void* key, const void* val, const void* w,
                     const void* u, const void* s0, void* out, void* sout, int nb, int T, int H,
                     int K, int vec, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float *fr = (const float*)r, *fk = (const float*)key, *fv = (const float*)val,
              *fw = (const float*)w, *fu = (const float*)u, *fs = (const float*)s0;
  float *fo = (float*)out, *fso = (float*)sout;
  switch (K) {
    case 16: return rwkv::launch<16>(fr, fk, fv, fw, fu, fs, fo, fso, nb, T, H, vec, s);
    case 32: return rwkv::launch<32>(fr, fk, fv, fw, fu, fs, fo, fso, nb, T, H, vec, s);
    case 64: return rwkv::launch<64>(fr, fk, fv, fw, fu, fs, fo, fso, nb, T, H, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
