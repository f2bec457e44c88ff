// Sequential scans of the recurrent mixers for Hopper (sm_90a): mamba_scan
// and rwkv_scan.  Plain C entry points, bound with ctypes by
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
// mamba_scan (Mamba2's SSD recurrence, ngroups = 1): one CTA per (batch,
// head), one thread per column p of the head's (d_state x head) state,
// which the thread keeps in registers for the whole walk over T:
//   decay = exp(a[h] * dt[t]),  xdt = x[t, p] * dt[t]
//   h[s, p] = h[s, p] * decay + B[t, s] * xdt        (s < S)
//   y[t, p] = sum_s C[t, s] h[s, p]
// The sum over s stays inside the thread: no reduction crosses threads.
// rwkv_scan (RWKV-6's data-dependent decay): the same layout over the
// (hd_k x hd_v) state, thread v owning column v:
//   kv[k] = key[t, k] * val[t, v]
//   out[t, v] = sum_k r[t, k] (s[k, v] + u[h, k] kv[k])
//   s[k, v] = w[t, k] s[k, v] + kv[k]
// The state updates take the products and sums the JAX step takes, each
// rounded (__fmul_rn, __fadd_rn: no contraction into an FMA), so the final
// state equals the plain version's; the sums over s or k run in another
// order than the einsum's and differ by a few ulps.
// Each CTA stages kChunk steps of the operands every thread of it reads
// (B and C, dt; r, key and w) in shared memory, read by broadcast; x or
// val, one element a thread a step, come straight from global memory
// (neighbouring threads, neighbouring addresses).
// Bound: operations at the float32 rate outside the tensor cores -- five
// (mamba) or seven (rwkv) flops per state element per step against 4 + 4
// bytes of x (val) and y (out) per column per step.  Nothing here is
// designed for speed (a CTA holds 2 warps at the repo's head widths; the
// chunked SSD form is later work).

#include <cuda_runtime.h>

namespace {

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

template <int K>
__global__ void __launch_bounds__(K) rwkv_scan_kernel(
    const float* __restrict__ r, const float* __restrict__ key, const float* __restrict__ val,
    const float* __restrict__ w, const float* __restrict__ u, const float* __restrict__ s0,
    float* __restrict__ out, float* __restrict__ sout, int T, int H) {
  const int bh = blockIdx.x;
  const int b = bh / H, hh = bh % H;
  const int v = threadIdx.x;
  __shared__ float sR[kChunk][K], sK[kChunk][K], sW[kChunk][K], sU[K];

  float st[K];   // st[k] = s[k, v]
  const float* s0p = s0 + (long long)bh * K * K + v;
#pragma unroll
  for (int k = 0; k < K; ++k) st[k] = s0p[(long long)k * K];
  sU[v] = u[(long long)hh * K + v];
  // (b, t, hh, 0) of a contiguous (B, T, H, K) operand
  const long long row0 = ((long long)b * T * H + hh) * K;
  const long long tstride = (long long)H * K;

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int n = min(kChunk, T - t0);
    __syncthreads();
    for (int i = v; i < n * K; i += K) {
      const int j = i / K, k = i % K;
      const long long off = row0 + (t0 + j) * tstride + k;
      sR[j][k] = r[off];
      sK[j][k] = key[off];
      sW[j][k] = w[off];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const long long off = row0 + (t0 + j) * tstride + v;
      const float vv = val[off];
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float kv = __fmul_rn(sK[j][k], vv);
        acc = fmaf(sR[j][k], __fadd_rn(st[k], __fmul_rn(sU[k], kv)), acc);
        st[k] = __fadd_rn(__fmul_rn(sW[j][k], st[k]), kv);
      }
      out[off] = acc;
    }
  }
  float* sop = sout + (long long)bh * K * K + v;
#pragma unroll
  for (int k = 0; k < K; ++k) sop[(long long)k * K] = st[k];
}

template <int S>
void launch_mamba(const float* x, long long x_sb, long long x_st, const float* dt,
                  const float* bm, const float* cm, long long bc_sb, long long bc_st,
                  const float* a, const float* h0, float* y, float* hout, int nb, int T, int H,
                  int P, cudaStream_t s) {
  mamba_scan_kernel<S><<<nb * H, P, 0, s>>>(x, x_sb, x_st, dt, bm, cm, bc_sb, bc_st, a, h0, y,
                                            hout, T, H, P);
}

template <int K>
void launch_rwkv(const float* r, const float* key, const float* val, const float* w,
                 const float* u, const float* s0, float* out, float* sout, int nb, int T, int H,
                 cudaStream_t s) {
  rwkv_scan_kernel<K><<<nb * H, K, 0, s>>>(r, key, val, w, u, s0, out, sout, T, H);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x (nb, T, H, P) float32 at batch / step strides x_sb, x_st (elements),
// each step's (H, P) contiguous; dt (nb, T, H) contiguous; bm, cm (nb, T, S)
// at strides bc_sb, bc_st, each step's S contiguous; a (H,); h0, hout
// (nb, H, S, P) contiguous; y (nb, T, H, P) contiguous.  S in {16, 32, 64,
// 128}, 1 <= P <= kMaxP, T >= 1.
int mamba_scan_launch(const void* x, long long x_sb, long long x_st, const void* dt,
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
// (nb, H, K, K) contiguous, s[k, v] at k * K + v.  K in {16, 32, 64} (at
// 128 the staged chunk would pass 48 KB of static shared memory), T >= 1.
int rwkv_scan_launch(const void* r, const void* key, const void* val, const void* w,
                     const void* u, const void* s0, void* out, void* sout, int nb, int T, int H,
                     int K, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float *fr = (const float*)r, *fk = (const float*)key, *fv = (const float*)val,
              *fw = (const float*)w, *fu = (const float*)u, *fs = (const float*)s0;
  float *fo = (float*)out, *fso = (float*)sout;
  switch (K) {
    case 16: launch_rwkv<16>(fr, fk, fv, fw, fu, fs, fo, fso, nb, T, H, s); break;
    case 32: launch_rwkv<32>(fr, fk, fv, fw, fu, fs, fo, fso, nb, T, H, s); break;
    case 64: launch_rwkv<64>(fr, fk, fv, fw, fu, fs, fo, fso, nb, T, H, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
