// Flash-attention forward for Hopper (sm_90a).  Plain C entry point,
// bound with ctypes by repro_torch/kernels/flash_attention.py; it
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel): online-softmax attention of q (B, Hq, Tq, D) over
// k/v (B, Hkv, Tk, D), bf16 or f32, output in q's type with float32
// accumulation.  Queries are suffix-aligned (query i sits at key
// position i + Tk - Tq); a key is seen when kpos < Tk, and kpos <= qpos
// if causal, and kpos > qpos - window if window > 0.  Query head h reads
// kv head h / (Hq / Hkv) through the pointer arithmetic: K/V are never
// replicated.
//
// Design.  The TPU kernel walks the key blocks as sequential grid steps
// and carries the running max, normaliser and accumulator in VMEM
// scratch.  Here one CTA owns a (batch, head, 64-query tile) and loops
// over 64-key tiles itself, skipping the tiles the causal or window mask
// leaves wholly empty (exact: they add nothing).  The Q tile and the
// current K tile (then the V tile, in the same buffer) sit in shared
// memory as float32, rows padded to D + 1 floats so the 16 keys a
// half-warp reads at one depth fall in 16 banks.  256 threads as 16 x 16:
// thread (ty, tx) holds the scores of query rows 4ty..4ty+3 against keys
// tx + 16j (j < 4), and the accumulator of the same rows at columns
// tx + 16j (j < NJ = ceil(D / 16)) in registers, with the running max
// and normaliser of its rows (the 16 threads of a row reduce with
// shuffles inside their half-warp, so all hold the same values).  A key
// that the mask hides contributes p = 0 outright, so a row that sees no
// key in a tile adds no exp(0) terms (the TPU kernel relied on a later
// rescale to wipe those out), and rows with no key yet keep m = -inf.
// Dynamic shared memory: (128 (D + 1) + 64 * 68) * 4 bytes, 83 KB at
// D = 128 and 182 KB at D = 320 (above 48 KB, so cudaFuncSetAttribute).
//
// Bound: operations.  4 D flops per (query, key) pair the mask keeps,
// 2.75e11 at B=8, Hq=32, T=2048, D=128 causal, 0.28 ms at the card's
// bf16 tensor rate against 0.10 ms of bytes.  This kernel runs on the
// CUDA cores in float32 (no tensor cores, no TMA): the simple version
// that is right; wgmma and a TMA ring are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;            // query rows per CTA
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 256;      // 16 x 16
constexpr int kPStride = kBK + 4;  // rows 4 apart land 16 banks apart

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qs[3], ks[3], vs[3], os[3];  // element strides of dims b, h, t
  int hq, hkv, tq, tk, d, causal, window;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// rows [r0, r0 + kBK) of a (T, D) slice at row stride rs into dst (f32, row
// stride ld); rows at or past n are zero (V rows past Tk must not be NaN:
// p = 0 times NaN is NaN)
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, long long rs,
                                          int r0, int rows, int n, int d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kThreads / 32) {
    const int g = r0 + r;
    float* out = dst + r * ld;
    if (g < n) {
      const T* in = src + (long long)g * rs;
      for (int c = lane; c < d; c += 32) out[c] = to_f(in[c]);
    } else {
      for (int c = lane; c < d; c += 32) out[c] = 0.f;
    }
  }
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  const int ld = p.d + 1;
  float* Qs = smem;              // kBQ x ld
  float* KVs = Qs + kBQ * ld;    // kBK x ld: the K tile, then the V tile
  float* Ps = KVs + kBK * ld;    // kBQ x kPStride

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;   // the heaviest (last) tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int q0 = qt * kBQ;
  const int off = p.tk - p.tq;

  const T* qg = (const T*)p.q + b * p.qs[0] + h * p.qs[1];
  const T* kg = (const T*)p.k + b * p.ks[0] + hk * p.ks[1];
  const T* vg = (const T*)p.v + b * p.vs[0] + hk * p.vs[1];
  load_tile(Qs, ld, qg + (long long)q0 * p.qs[2], p.qs[2], 0, kBQ, p.tq - q0, p.d);

  float acc[4][NJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // the key tiles this query tile can see
  const int qlo = q0 + off;
  const int qhi = min(q0 + kBQ, p.tq) - 1 + off;
  const int khi = p.causal ? min(p.tk, qhi + 1) : p.tk;
  const int klo = p.window > 0 ? max(0, qlo - p.window + 1) : 0;
  const int kt1 = (khi + kBK - 1) / kBK;

  for (int kt = klo / kBK; kt < kt1; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's P.V is done with KVs and Ps
    load_tile(KVs, ld, kg, p.ks[2], k0, kBK, p.tk, p.d);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < p.d; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * ld + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = KVs[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i + off;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool seen = kpos < p.tk && (!p.causal || kpos <= qpos) &&
                          (p.window <= 0 || kpos > qpos - p.window);
        s[i][j] = seen ? s[i][j] * p.scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float m_ref = m_new == -INFINITY ? 0.f : m_new;   // no key seen yet
      const float alpha = expf(m[i] - m_ref);                 // 0 while m[i] = -inf
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_ref);
        Ps[(ty * 4 + i) * kPStride + tx + 16 * j] = pv;
        rs += pv;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }

    __syncthreads();   // every score read K; Ps is written
    load_tile(KVs, ld, vg, p.vs[2], k0, kBK, p.tk, p.d);
    __syncthreads();
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * kPStride + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        const float vv = c < p.d ? KVs[kk * ld + c] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  T* og = (T*)p.o + b * p.os[0] + h * p.os[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.tq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* out = og + (long long)row * p.os[2];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < p.d) out[c] = from_f<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int NJ>
int launch(const Params& p, int batch, cudaStream_t s) {
  const size_t smem = (size_t)((kBQ + kBK) * (p.d + 1) + kBQ * kPStride) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.tq + kBQ - 1) / kBQ, p.hq, batch);
  flash_fwd_kernel<T, NJ><<<grid, kThreads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, int batch, cudaStream_t s) {
  const int nj = (p.d + 15) / 16;
  if (nj <= 1) return launch<T, 1>(p, batch, s);
  if (nj <= 2) return launch<T, 2>(p, batch, s);
  if (nj <= 4) return launch<T, 4>(p, batch, s);
  if (nj <= 8) return launch<T, 8>(p, batch, s);
  if (nj <= 12) return launch<T, 12>(p, batch, s);
  if (nj <= 16) return launch<T, 16>(p, batch, s);
  if (nj <= 20) return launch<T, 20>(p, batch, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// q (B, Hq, Tq, D), k/v (B, Hkv, Tk, D), o (B, Hq, Tq, D): element strides
// of dims b, h, t given, the last dim contiguous; 1 <= D <= 320,
// Hq % Hkv == 0, Tk >= 1, and Tq <= Tk when causal (the wrapper checks).
// is_bf16: 1 for __nv_bfloat16 tensors, 0 for float.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                           long long qsb, long long qsh, long long qst,
                           long long ksb, long long ksh, long long kst,
                           long long vsb, long long vsh, long long vst,
                           long long osb, long long osh, long long ost,
                           int batch, int hq, int hkv, int tq, int tk, int d,
                           int causal, int window, int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (batch == 0 || hq == 0 || tq == 0) return (int)cudaGetLastError();
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.qs[0] = qsb; p.qs[1] = qsh; p.qs[2] = qst;
  p.ks[0] = ksb; p.ks[1] = ksh; p.ks[2] = kst;
  p.vs[0] = vsb; p.vs[1] = vsh; p.vs[2] = vst;
  p.os[0] = osb; p.os[1] = osh; p.os[2] = ost;
  p.hq = hq;
  p.hkv = hkv;
  p.tq = tq;
  p.tk = tk;
  p.d = d;
  p.causal = causal;
  p.window = window;
  p.scale = (float)(1.0 / sqrt((double)d));
  return is_bf16 ? dispatch<__nv_bfloat16>(p, batch, s) : dispatch<float>(p, batch, s);
}

}  // extern "C"
