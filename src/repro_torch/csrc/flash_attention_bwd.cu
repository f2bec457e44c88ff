// Flash-attention backward for Hopper (sm_90a).  Plain C entry points,
// bound with ctypes by repro_torch/kernels/flash_attention.py; each
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().
//
// Replaces no Pallas kernel: the JAX package has no backward kernel and
// trains by differentiating XLA's blockwise_attention
// (src/repro/models/attention.py:32).  This is the gradient of exactly
// what flash_attention.cu's forward computes: float32 logits scaled by
// 1/sqrt(D), suffix-aligned queries (query i at key position
// i + Tk - Tq), a key seen when kpos < Tk, and kpos <= qpos if causal, and
// kpos > qpos - window if window > 0, GQA (query head h reads kv head
// h / (Hq / Hkv)), non-causal calls with Tq != Tk.  Operands bf16 or
// float32, D <= 320; dq, dk, dv come out in the operand type, every sum
// taken in float32.
//
// Bound: operations.  Five products of 2 D flops per (query, key) pair
// the mask keeps (S = Q K^T and dP = dO V^T recomputed, dV = P^T dO,
// dK = dS^T Q, dQ = dS K): 3.4e11 flops at B=8, Hq=32, T=2048, D=64
// causal, 0.35 ms at the card's 989 TFLOP/s bf16 tensor rate and 5.1 ms
// at its 67 TFLOP/s float32 CUDA-core rate, against 0.06 ms of bytes.
// This first version runs on the CUDA cores in float32 (which is also
// what holds the float32 route to 1e-5), and does nine products where the
// function needs five (S three times, dP three times); mma.sync / wgmma,
// TMA and the forward writing its LSE are later work.
//
// Design: three launches, no atomics, so a rerun repeats bit for bit.
//   (a) bwd_prep, one CTA per (batch, query head, query tile): recompute
//       each row's log-sum-exp, lse = m + log l, from S over the key tiles
//       the row can see (the forward writes no LSE, so the forward kernels
//       and every serving number stay as they are), and, in the same
//       online pass, delta = sum_j P_ij dP_ij with dP = dO V^T.  That is
//       rowsum(dO o O) for the float32 O the softmax makes: taking delta
//       from the forward's stored output instead (FlashAttention-2's way)
//       uses O rounded to bf16, and that rounding, not the kernel's own,
//       then dominates the bf16 gradients' error, most of all in the rows
//       that see few keys (PERF.md, the training cell's check (a)).
//   (b) bwd_dkdv, one CTA per (batch, kv head, key tile): K and V tiles
//       stay in shared memory; the CTA walks the query heads of its GQA
//       group and, for each, the query tiles that can see the key tile
//       (the causal and window bounds skip the rest): P = exp(S c - lse),
//       dP = dO V^T, dS = P o (dP - delta) into shared memory, then
//       dV += P^T dO and dK += dS^T Q in registers.  Summing the group
//       inside the CTA gives GQA's dK and dV with no atomics.
//   (c) bwd_dq, one CTA per (batch, query head, query tile): Q, dO, lse
//       and delta stay; over the visible key tiles, dS as in (b), then
//       dQ += dS K in registers.
// 256 threads as a 16 x 16 grid; thread (ty, tx) holds rows ty + 16 a and
// columns tx + 16 c of each product (register micro-tiles, two shared
// loads per 2 x 2 to 4 x 20 FMAs).  Tiles are staged as float32 in shared
// memory with a row stride of DP + 1 (no bank conflicts on the key rows);
// D is padded with zero columns to DP in {16, 64, 128, 256, 320}, and the
// tiles are 64 x 64 for DP <= 128 and 32 x 32 above.  Shared memory:
// (b) 51 KB (DP 16), 100 KB (64), 166 KB (128), 140 KB (256), 173 KB (320);
// (a) and (c) a little less.
//
// fault (0 in every real call) plants the faults the chip check must
// catch: 1 the causal mask dropped in (b), 2 delta left zero, 4 a GQA
// group's dK and dV from its first query head only, 8 the scale dropped
// from dS.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFaultCausal = 1, kFaultDelta = 2, kFaultGroup = 4, kFaultScale = 8;

struct Strides {
  long long b, h, t;
};

struct Args {
  const void *q, *k, *v, *dout;
  void *dq, *dk, *dv;
  float *lse, *delta;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int hq, hkv, tq, tk, d, causal, window, fault;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__host__ __device__ constexpr int tile_of(int dp) { return dp <= 128 ? 64 : 32; }

// rows [row0, row0 + ROWS) of a (T, D) operand -> s[r * (DP + 1) + d],
// zero past nrows and past D
template <typename T, int ROWS, int DP>
__device__ __forceinline__ void load_tile(float* s, const T* base, long long st, int row0,
                                          int nrows, int d) {
  for (int e = threadIdx.x; e < ROWS * DP; e += kThreads) {
    const int r = e / DP, c = e % DP;
    float x = 0.f;
    if (row0 + r < nrows && c < d) x = to_f(base[(long long)(row0 + r) * st + c]);
    s[r * (DP + 1) + c] = x;
  }
}

// acc[a][c] = sum_d A[ty + 16 a][d] * B[tx + 16 c][d] over DP columns
template <int TM, int TN, int DP>
__device__ __forceinline__ void row_dot(const float* A, const float* B, float (&acc)[TM][TN],
                                        int ty, int tx) {
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; ++d) {
    float av[TM], bv[TN];
#pragma unroll
    for (int a = 0; a < TM; ++a) av[a] = A[(ty + 16 * a) * (DP + 1) + d];
#pragma unroll
    for (int c = 0; c < TN; ++c) bv[c] = B[(tx + 16 * c) * (DP + 1) + d];
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
  }
}

__device__ __forceinline__ bool seen(int i, int j, const Args& a, bool causal) {
  const int qpos = i + a.tk - a.tq;
  return i < a.tq && j < a.tk && (!causal || j <= qpos) &&
         (a.window <= 0 || j > qpos - a.window);
}

// keys [lo, hi) that query rows [q0, q0 + n) can see
__device__ __forceinline__ void key_range(const Args& a, int q0, int n, int* lo, int* hi) {
  const int off = a.tk - a.tq;
  *hi = a.causal ? min(a.tk, q0 + n + off) : a.tk;
  *lo = a.window > 0 ? max(0, q0 + off - a.window + 1) : 0;
}

// query rows [lo, hi) that can see keys [k0, k0 + n)
__device__ __forceinline__ void query_range(const Args& a, bool causal, int k0, int n, int* lo,
                                            int* hi) {
  const int off = a.tk - a.tq;
  *lo = causal ? max(0, k0 - off) : 0;
  *hi = a.window > 0 ? min(a.tq, k0 + n - 1 + a.window - off) : a.tq;
}

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// (a) lse and delta of one query tile
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) bwd_prep(Args a) {
  constexpr int BQ = tile_of(DP), BK = tile_of(DP), TM = BQ / 16, TN = BK / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* gs = qs + BQ * (DP + 1);            // dO
  float* ks = gs + BQ * (DP + 1);
  float* vs = ks + BK * (DP + 1);
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* kb = (const T*)a.k + b * a.sk.b + hk * a.sk.h;
  const T* vb = (const T*)a.v + b * a.sv.b + hk * a.sv.h;
  load_tile<T, BQ, DP>(qs, (const T*)a.q + b * a.sq.b + h * a.sq.h, a.sq.t, q0, a.tq, a.d);
  load_tile<T, BQ, DP>(gs, (const T*)a.dout + b * a.sdo.b + h * a.sdo.h, a.sdo.t, q0, a.tq,
                       a.d);

  // per row: running max m, sum l of exp(s - m), and sum of exp(s - m) dP
  float m[TM], l[TM], pd[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    m[r] = -INFINITY;
    l[r] = pd[r] = 0.f;
  }
  int lo, hi;
  key_range(a, q0, BQ, &lo, &hi);
  for (int k0 = (lo / BK) * BK; k0 < hi; k0 += BK) {
    __syncthreads();
    load_tile<T, BK, DP>(ks, kb, a.sk.t, k0, a.tk, a.d);
    load_tile<T, BK, DP>(vs, vb, a.sv.t, k0, a.tk, a.d);
    __syncthreads();
    float s[TM][TN], dp[TM][TN];
    row_dot<TM, TN, DP>(qs, ks, s, ty, tx);
    row_dot<TM, TN, DP>(gs, vs, dp, ty, tx);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int i = q0 + ty + 16 * r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        s[r][c] = seen(i, k0 + tx + 16 * c, a, a.causal) ? s[r][c] * a.scale : -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
      mx = group_max(mx);
      const float mn = fmaxf(m[r], mx);
      const bool any = mn != -INFINITY;  // the row has seen a key (the 16 lanes agree)
      float sum = 0.f, dsum = 0.f;
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const float e = (!any || s[r][c] == -INFINITY) ? 0.f : expf(s[r][c] - mn);
        sum += e;
        dsum = fmaf(e, dp[r][c], dsum);
      }
      sum = group_sum(sum);              // every lane of the warp takes part
      dsum = group_sum(dsum);
      if (any) {
        const float alpha = expf(m[r] - mn);
        l[r] = l[r] * alpha + sum;
        pd[r] = pd[r] * alpha + dsum;
        m[r] = mn;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int i = q0 + ty + 16 * r;
    if (tx == 0 && i < a.tq) {
      const long long row = ((long long)b * a.hq + h) * a.tq + i;
      a.lse[row] = m[r] + logf(l[r]);
      a.delta[row] = (a.fault & kFaultDelta) ? 0.f : pd[r] / l[r];
    }
  }
}

// P and dS of one (query tile, key tile) pair from S and dP; P into ps
// (if given) and dS into dss, both [row][BK + 1]
template <int TM, int TN, int BK>
__device__ __forceinline__ void probs_and_ds(const float (&s)[TM][TN], const float (&dp)[TM][TN],
                                             const float* lse, const float* delta, float* ps,
                                             float* dss, int q0, int k0, const Args& a,
                                             bool causal, int ty, int tx) {
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int row = ty + 16 * r;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int col = tx + 16 * c;
      const float p = seen(q0 + row, k0 + col, a, causal)
                          ? expf(s[r][c] * a.scale - lse[row]) : 0.f;
      if (ps) ps[row * (BK + 1) + col] = p;
      dss[row * (BK + 1) + col] = p * (dp[r][c] - delta[row]);
    }
  }
}

// (b) dK and dV of one key tile, summed over the GQA group's query heads
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) bwd_dkdv(Args a) {
  constexpr int BQ = tile_of(DP), BK = tile_of(DP);
  constexpr int TM = BQ / 16, TN = BK / 16, TK = BK / 16, TD = DP / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BK * (DP + 1);
  float* qs = vs + BK * (DP + 1);
  float* gs = qs + BQ * (DP + 1);            // dO
  float* ps = gs + BQ * (DP + 1);
  float* dss = ps + BQ * (BK + 1);
  float* lse = dss + BQ * (BK + 1);
  float* dl = lse + BQ;
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int rep = a.hq / a.hkv;
  const bool causal = a.causal && !(a.fault & kFaultCausal);
  load_tile<T, BK, DP>(ks, (const T*)a.k + b * a.sk.b + hk * a.sk.h, a.sk.t, k0, a.tk, a.d);
  load_tile<T, BK, DP>(vs, (const T*)a.v + b * a.sv.b + hk * a.sv.h, a.sv.t, k0, a.tk, a.d);

  float dk[TK][TD], dv[TK][TD];
#pragma unroll
  for (int r = 0; r < TK; ++r)
#pragma unroll
    for (int c = 0; c < TD; ++c) dk[r][c] = dv[r][c] = 0.f;

  int lo, hi;
  query_range(a, causal, k0, BK, &lo, &hi);
  const int heads = (a.fault & kFaultGroup) ? 1 : rep;
  for (int g = 0; g < heads; ++g) {
    const int h = hk * rep + g;
    const T* qb = (const T*)a.q + b * a.sq.b + h * a.sq.h;
    const T* gb = (const T*)a.dout + b * a.sdo.b + h * a.sdo.h;
    const long long row0 = ((long long)b * a.hq + h) * a.tq;
    for (int q0 = (lo / BQ) * BQ; q0 < hi; q0 += BQ) {
      __syncthreads();
      load_tile<T, BQ, DP>(qs, qb, a.sq.t, q0, a.tq, a.d);
      load_tile<T, BQ, DP>(gs, gb, a.sdo.t, q0, a.tq, a.d);
      if (threadIdx.x < BQ) {
        const int i = q0 + threadIdx.x;
        lse[threadIdx.x] = i < a.tq ? a.lse[row0 + i] : 0.f;
        dl[threadIdx.x] = i < a.tq ? a.delta[row0 + i] : 0.f;
      }
      __syncthreads();
      float s[TM][TN], dp[TM][TN];
      row_dot<TM, TN, DP>(qs, ks, s, ty, tx);
      row_dot<TM, TN, DP>(gs, vs, dp, ty, tx);
      probs_and_ds<TM, TN, BK>(s, dp, lse, dl, ps, dss, q0, k0, a, causal, ty, tx);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: rows are keys ty + 16 r, columns d
#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        float pv[TK], sv[TK], gv[TD], qv[TD];
#pragma unroll
        for (int r = 0; r < TK; ++r) {
          pv[r] = ps[i * (BK + 1) + ty + 16 * r];
          sv[r] = dss[i * (BK + 1) + ty + 16 * r];
        }
#pragma unroll
        for (int c = 0; c < TD; ++c) {
          gv[c] = gs[i * (DP + 1) + tx + 16 * c];
          qv[c] = qs[i * (DP + 1) + tx + 16 * c];
        }
#pragma unroll
        for (int r = 0; r < TK; ++r)
#pragma unroll
          for (int c = 0; c < TD; ++c) {
            dv[r][c] = fmaf(pv[r], gv[c], dv[r][c]);
            dk[r][c] = fmaf(sv[r], qv[c], dk[r][c]);
          }
      }
    }
  }

  const float sc = (a.fault & kFaultScale) ? 1.f : a.scale;
  T* dkb = (T*)a.dk + b * a.sdk.b + hk * a.sdk.h;
  T* dvb = (T*)a.dv + b * a.sdv.b + hk * a.sdv.h;
#pragma unroll
  for (int r = 0; r < TK; ++r) {
    const int j = k0 + ty + 16 * r;
    if (j >= a.tk) continue;
#pragma unroll
    for (int c = 0; c < TD; ++c) {
      const int col = tx + 16 * c;
      if (col < a.d) {
        dkb[(long long)j * a.sdk.t + col] = from_f<T>(dk[r][c] * sc);
        dvb[(long long)j * a.sdv.t + col] = from_f<T>(dv[r][c]);
      }
    }
  }
}

// (c) dQ of one query tile
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) bwd_dq(Args a) {
  constexpr int BQ = tile_of(DP), BK = tile_of(DP);
  constexpr int TM = BQ / 16, TN = BK / 16, TD = DP / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* gs = qs + BQ * (DP + 1);
  float* ks = gs + BQ * (DP + 1);
  float* vs = ks + BK * (DP + 1);
  float* dss = vs + BK * (DP + 1);
  float* lse = dss + BQ * (BK + 1);
  float* dl = lse + BQ;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_tile<T, BQ, DP>(qs, (const T*)a.q + b * a.sq.b + h * a.sq.h, a.sq.t, q0, a.tq, a.d);
  load_tile<T, BQ, DP>(gs, (const T*)a.dout + b * a.sdo.b + h * a.sdo.h, a.sdo.t, q0, a.tq,
                       a.d);
  const long long row0 = ((long long)b * a.hq + h) * a.tq;
  if (threadIdx.x < BQ) {
    const int i = q0 + threadIdx.x;
    lse[threadIdx.x] = i < a.tq ? a.lse[row0 + i] : 0.f;
    dl[threadIdx.x] = i < a.tq ? a.delta[row0 + i] : 0.f;
  }
  const T* kb = (const T*)a.k + b * a.sk.b + hk * a.sk.h;
  const T* vb = (const T*)a.v + b * a.sv.b + hk * a.sv.h;

  float dq[TM][TD];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TD; ++c) dq[r][c] = 0.f;

  int lo, hi;
  key_range(a, q0, BQ, &lo, &hi);
  for (int k0 = (lo / BK) * BK; k0 < hi; k0 += BK) {
    __syncthreads();
    load_tile<T, BK, DP>(ks, kb, a.sk.t, k0, a.tk, a.d);
    load_tile<T, BK, DP>(vs, vb, a.sv.t, k0, a.tk, a.d);
    __syncthreads();
    float s[TM][TN], dp[TM][TN];
    row_dot<TM, TN, DP>(qs, ks, s, ty, tx);
    row_dot<TM, TN, DP>(gs, vs, dp, ty, tx);
    probs_and_ds<TM, TN, BK>(s, dp, lse, dl, nullptr, dss, q0, k0, a, a.causal, ty, tx);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float sv[TM], kv[TD];
#pragma unroll
      for (int r = 0; r < TM; ++r) sv[r] = dss[(ty + 16 * r) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < TD; ++c) kv[c] = ks[j * (DP + 1) + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TD; ++c) dq[r][c] = fmaf(sv[r], kv[c], dq[r][c]);
    }
  }

  const float sc = (a.fault & kFaultScale) ? 1.f : a.scale;
  T* dqb = (T*)a.dq + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i >= a.tq) continue;
#pragma unroll
    for (int c = 0; c < TD; ++c) {
      const int col = tx + 16 * c;
      if (col < a.d) dqb[(long long)i * a.sdq.t + col] = from_f<T>(dq[r][c] * sc);
    }
  }
}

template <int DP>
constexpr size_t smem_prep() { return sizeof(float) * 4 * tile_of(DP) * (DP + 1); }
template <int DP>
constexpr size_t smem_dkdv() {
  return sizeof(float) * (4 * tile_of(DP) * (DP + 1) + 2 * tile_of(DP) * (tile_of(DP) + 1) +
                          2 * tile_of(DP));
}
template <int DP>
constexpr size_t smem_dq() {
  return sizeof(float) * (4 * tile_of(DP) * (DP + 1) + tile_of(DP) * (tile_of(DP) + 1) +
                          2 * tile_of(DP));
}

template <typename T, int DP>
int launch(const Args& a, int batch, cudaStream_t stream) {
  constexpr int BQ = tile_of(DP), BK = tile_of(DP);
  const size_t sp = smem_prep<DP>(), sk = smem_dkdv<DP>(), sq = smem_dq<DP>();
  cudaFuncSetAttribute(bwd_prep<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sp);
  cudaFuncSetAttribute(bwd_dkdv<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sk);
  cudaFuncSetAttribute(bwd_dq<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sq);
  const dim3 gq((a.tq + BQ - 1) / BQ, a.hq, batch), gk((a.tk + BK - 1) / BK, a.hkv, batch);
  bwd_prep<T, DP><<<gq, kThreads, sp, stream>>>(a);
  bwd_dkdv<T, DP><<<gk, kThreads, sk, stream>>>(a);
  bwd_dq<T, DP><<<gq, kThreads, sq, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_any(const Args& a, int batch, cudaStream_t stream) {
  if (a.d <= 16) return launch<T, 16>(a, batch, stream);
  if (a.d <= 64) return launch<T, 64>(a, batch, stream);
  if (a.d <= 128) return launch<T, 128>(a, batch, stream);
  if (a.d <= 256) return launch<T, 256>(a, batch, stream);
  if (a.d <= 320) return launch<T, 320>(a, batch, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// q/dq/dout (B, Hq, Tq, d), k/v/dk/dv (B, Hkv, Tk, d): element strides of
// dims b, h, t (strides: 3 for each of q, k, v, dout, dq, dk, dv, in that
// order), the last dim contiguous; lse and delta (B, Hq, Tq) float32
// scratch.  1 <= d <= 320, Hq % Hkv == 0, Tk >= 1, and Tq <= Tk when causal
// (the wrapper checks).  bf16 (is_f32 = 0) or float32.
int flash_attention_bwd_launch(int is_f32, const void* q, const void* k, const void* v,
                               const void* dout, void* dq, void* dk, void* dv,
                               float* lse, float* delta, const long long* strides,
                               int batch, int hq, int hkv, int tq, int tk, int d, int causal,
                               int window, float scale, int fault, void* stream) {
  if (batch == 0 || hq == 0 || tq == 0) return (int)cudaGetLastError();
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.lse = lse;
  a.delta = delta;
  Strides* dst[7] = {&a.sq, &a.sk, &a.sv, &a.sdo, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 7; ++i) *dst[i] = Strides{strides[3 * i], strides[3 * i + 1],
                                                strides[3 * i + 2]};
  a.hq = hq;
  a.hkv = hkv;
  a.tq = tq;
  a.tk = tk;
  a.d = d;
  a.causal = causal;
  a.window = window;
  a.fault = fault;
  a.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;
  return is_f32 ? launch_any<float>(a, batch, s) : launch_any<__nv_bfloat16>(a, batch, s);
}

}  // extern "C"
