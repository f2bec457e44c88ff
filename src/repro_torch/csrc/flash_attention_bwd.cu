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
// Bound: operations.  The function needs five products of 2 D flops per
// (query, key) pair the mask keeps (S = Q K^T and dP = dO V^T recomputed,
// dV = P^T dO, dK = dS^T Q, dQ = dS K): 3.4e11 flops at B=8, Hq=32,
// T=2048, D=64 causal, 0.35 ms at the card's 989 TFLOP/s bf16 tensor rate,
// against 0.06 ms of bytes.  This design takes fifteen tensor-core passes
// of 2 D flops a pair on the bf16 route: (a) S, dP; (b) S, dP, dV three
// times, dK three times; (c) S, dP, dQ three times (the float32 P and dS
// go through the tensor cores as three bf16 pieces): 1.05 ms at 989 TFLOP/s
// for that call.  The float32 route takes each product as three TF32
// passes (3xTF32): (a) 6, (b) 12, (c) 9 passes at 495 TFLOP/s.  What it
// still leaves: (c) recomputes S and dP, and (a) the softmax statistics
// the forward could write; the elementwise work between the products (exp,
// the splits, the partial sums) runs on the CUDA cores between waits, so a
// warpgroup's tensor cores idle during it unless another CTA fills them.
//
// Design: three launches, no atomics, so a rerun repeats bit for bit.
//   (a) bwd_prep, one CTA per (batch, query head, query tile): each row's
//       max m of s c (c = log2(e)/sqrt(D)) and 1 / l for l = sum_j
//       2^(s c - m), over the key tiles the row can see (the forward writes
//       no statistics, so the forward kernels and every serving number stay
//       as they are), and, in the same online pass, delta = sum_j P_ij dP_ij
//       with dP = dO V^T.  That is rowsum(dO o O) for the float32 O the
//       softmax makes: taking delta from the forward's stored output instead
//       (FlashAttention-2's way) uses O rounded to bf16, and that rounding
//       then dominates the bf16 gradients' error, most of all in the rows
//       that see few keys (PERF.md, the training cell's check (a)).  The
//       later launches take P = 2^(s c - m) / l: folding log2 l into the
//       exponent (lse) rounds it at |lse| ~ log2 T, ~5e-7 of P.  m, 1 / l
//       and delta go to (3, B, Hq, Tqp) scratch padded to 128 rows, zero past
//       Tq, so (b) copies them by cp.async.
//   (b) bwd_dkdv, one CTA per (batch, kv head, key tile): K and V stay in
//       shared memory; the CTA walks the query heads of its GQA group and,
//       for each, the query tiles that can see the key tile (the causal and
//       window bounds skip the rest).  Keys are the rows: S^T = K Q^T and
//       dP^T = V dO^T, so P^T and dS^T = P^T o (dP^T - delta) come out as
//       accumulator fragments that are the A operand of dV += P^T dO and
//       dK += dS^T Q in registers, with no trip through shared memory.
//       Summing the group inside the CTA gives GQA's dK and dV with no
//       atomics.
//   (c) bwd_dq, one CTA per (batch, query head, query tile): Q, dO and
//       each row's statistics stay; over the visible key tiles, dS as in
//       (b) with queries as the rows, then dQ += dS K.
// The tile walks run heaviest first (causal: (b)'s first key tiles, (a)'s
// and (c)'s last query tiles, of every head).  The per-element mask runs
// only on the tiles that the diagonal, the window edge, Tq or Tk cut, in a
// branch of its own (evaluated inside the elementwise loop it cost (b) a
// quarter of its time).
//
// Products, float32 accumulators:
//   * bf16 at DP = 64 (Wg): wgmma, one warpgroup a CTA owning 64 rows.  S
//     and dP read both operands from 128-byte swizzled shared memory
//     (m64n64k16, issued together, one wait); P and dS enter dV, dK, dQ
//     from registers against the streamed tile read MN-major (the
//     transpose bit).  dV's product is issued before the CUDA cores form
//     dS^T and waited for after.  Other bf16 widths (Bf16): warp mma.sync
//     m16n8k16, operands by ldmatrix (.trans for dV, dK, dQ's right-hand
//     side), rows DP + 8 elements apart (no bank conflicts), each warp 16
//     rows.
//   * bf16 precision: Q, K, V, dO are exact in bf16, so S and dP are one
//     pass each.  P and dS are float32: each is split into three bf16
//     pieces (to nearest even: x = f0 + f1 + f2 to about 2^-27), three
//     passes into one float32 accumulator, the small pieces first.  Two
//     pieces (about 2^-18, the forward's rule for P V) miss the training
//     cell's row gap on its outlier rows (PERF.md, Findings); one misses the
//     1e-3 relative L2 gate (tests/test_torch_flash_bwd_tiles.py, run as a
//     script).  The tensor cores' float32 accumulation drops the bits below
//     the sum's last place (toward zero), ~1e-4 of the sum over a thousand
//     steps, so each tile's dV, dK, dQ is summed in a partial that starts at
//     zero and is added to the accumulator after the tile.
//   * float32 (Tf32): 3xTF32, as flash_attention.cu's flash_fwd_tf32: each
//     operand x split in registers into hi (x rounded to TF32) and lo = x
//     - hi, each product taken as lo*hi + hi*lo + hi*hi, on mma.sync
//     m16n8k8.  S-type products read 128-bit pieces with the head dim
//     walked in a permuted order; P and dS are the accumulator itself as
//     the A operand, so the other operand is read at rows 2t, 2t+1 (32-bit
//     loads).  Tiles read only as row operands are DP + 16 (mod 32) floats
//     apart, tiles read both ways DP + 4.
//   * Staging: every tile by 16-byte cp.async (the wrapper hands over
//     16-byte aligned rows of dt = D rounded up to 8 bf16 or 4 floats;
//     pieces of rows past Tq / Tk and of columns past dt zero-filled),
//     each thread keeping one column piece and stepping its pointers (a
//     copy a few instructions: with a division per piece the copies cost
//     (b) a quarter of its time), the streamed tiles in a ring of two
//     stages: the next query tile ((b)) or key tile ((a), (c)) lands while
//     the current one is multiplied.
//   * Wide heads (mma.sync): a warp's dK and dV (or dQ) accumulators over
//     DP columns take DP / 4 (or DP / 8) registers a thread; from DP = 256
//     they are split by columns between CS warps on the same 16 rows, each
//     of which computes S and dP for those rows itself (2 D more flops a
//     pair per extra warp) rather than passing P through shared memory.
// Instances (rows BM a CTA owns x rows BN a streamed tile, CS): the Inst
// table below the kernels; shared memory of each in its smem() and
// PERF.md.  One instance spills: bf16 (b) at DP = 128 (255 registers and
// 92 bytes of spill stores; a column split that does not spill took
// 7.2 ms against 5.7 at qwen3-4b's call, PERF.md).
//
// probs_bf16: the gradient of the forward's probs_bf16 function (JAX's
// blockwise_attention(probs_bf16=True)): O = sum_j round(p_j) round(V_j) / l
// with p_j = 2^(s c - m) against the row's max, the roundings to bf16
// passing the gradient through unchanged.  So dV = round(p)^T dO / l, dP =
// dO round(V)^T (the float32 route's wrapper hands over V rounded; bf16 V is
// exact), dS = P o (dP - delta) with the float32 P, and delta = dO . O =
// sum_j round(p_j) dP_j / l, which (a) takes in a second pass over its key
// tiles once the row's max is known.  Each of (a) and (b) has an instance of
// its own for it (a template flag); (c) is the same.  The rounding is
// against the row's max over every key (as the plain version's), where the
// forward kernel rounds against its running max.
//
// fault (0 in every real call) plants the faults the chip check must
// catch: 1 the causal mask dropped in (b), 2 delta left zero, 4 a GQA
// group's dK and dV from its first query head only, 8 the scale dropped
// from dS, 16 (bf16 on wgmma, DP = 64) P and dS as two bf16 pieces, the
// third left zero, 32 the probs_bf16 flag ignored.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFaultCausal = 1, kFaultDelta = 2, kFaultGroup = 4, kFaultScale = 8,
              kFaultPieces = 16, kFaultFlag = 32;
constexpr int kPadRows = 128;  // the row statistics are padded to a multiple of this
constexpr int kStages = 2;     // the ring of streamed tiles (3 and 4 measured no faster)

struct Strides {
  long long b, h, t;
};

struct Args {
  const void *q, *k, *v, *dout;
  void *dq, *dk, *dv;
  float *m2, *linv, *delta;    // per row (B, Hq, tqp): max of s c (log2 units), 1 / l, delta
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int batch, hq, hkv, tq, tk, tqp, d, dt, causal, window, probs_bf16, fault;
  float scale, scale_log2;     // 1/sqrt(D), log2(e)/sqrt(D)
};

// --------------------------------------------------------------------------
// device helpers
// --------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x rounded to bf16 (to nearest even), as a float: probs_bf16's P
__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// rows [r0, r0 + rows) of a (T, dt) slice at row stride rs (elements) into
// a tile of DP columns at dst, in 16-byte copies; pieces of rows at or past
// n, or of columns at or past dt, are zero-filled (the copy reads nothing).
// SWZ: the tile is 128-byte swizzled 64-column boxes (Wg's layout), else
// rows ld elements apart.  Where the block's NT threads cover whole rows,
// each thread keeps one column piece and steps its pointers by NT / PER
// rows: a copy is a few instructions, with no division
template <typename T, int NT, int DP, bool SWZ>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, long long rs, int r0,
                                          int rows, int n, int dt) {
  constexpr int E = 16 / sizeof(T), PER = DP / E;   // elements, pieces of a row
  const uint32_t base = smem_u32(dst);
  auto at = [&](int r, int c) -> uint32_t {
    if constexpr (SWZ)
      return base + (c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
    else
      return base + (uint32_t)(r * ld + c * E) * sizeof(T);
  };
  if constexpr (NT % PER == 0) {
    constexpr int STEP = NT / PER;
    static_assert(!SWZ || STEP % 8 == 0, "the swizzle repeats every 8 rows");
    const int c = threadIdx.x % PER, r = threadIdx.x / PER;
    const bool col_in = c * E < dt;
    const T* s = src + (long long)(r0 + r) * rs + c * E;
    uint32_t d = at(r, c);
    const uint32_t dstep = SWZ ? STEP * 128 : STEP * ld * sizeof(T);
    for (int rr = r; rr < rows; rr += STEP, d += dstep, s += STEP * rs) {
      const bool in = col_in && r0 + rr < n;
      cp_async16(d, in ? s : src, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * PER; i += NT) {
      const int r = i / PER, c = i % PER;
      const bool in = r0 + r < n && c * E < dt;
      cp_async16(at(r, c), in ? src + (long long)(r0 + r) * rs + c * E : src, in ? 16 : 0);
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ bool seen(int i, int j, const Args& a, bool causal) {
  const int qpos = i + a.tk - a.tq;
  return i < a.tq && j < a.tk && (!causal || j <= qpos) &&
         (a.window <= 0 || j > qpos - a.window);
}

// true unless every (query, key) pair of rows [q0, q0 + nq) x keys [k0,
// k0 + nk) is seen: the tile needs the per-element mask
__device__ __forceinline__ bool edge_tile(const Args& a, bool causal, int q0, int nq, int k0,
                                          int nk) {
  const int off = a.tk - a.tq;
  return q0 + nq > a.tq || k0 + nk > a.tk || (causal && k0 + nk - 1 > q0 + off) ||
         (a.window > 0 && k0 <= q0 + nq - 1 + off - a.window);
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

// --------------------------------------------------------------------------
// the per-warp routes (Bf16, Tf32): each warp owns 16 rows; R provides
// rows_x_rows and frag_x_rows, this the interface the kernels call
// --------------------------------------------------------------------------
template <class R>
struct PerWarp {
  static constexpr bool kPartial = false;    // no register partial a tile (Wg's)
  template <int NT, int DP, typename T>
  static __device__ __forceinline__ void load(T* dst, int ld, const T* src, long long rs, int r0,
                                              int rows, int n, int dt) {
    load_tile<T, NT, DP, false>(dst, ld, src, rs, r0, rows, n, dt);
  }
  static __device__ __forceinline__ void landed() {}
  // acc1 = A1 . B1^T and acc2 = A2 . B2^T (S and dP of a tile), the warp's
  // rows from r0 (RA, RB: the tiles' rows, Wg's)
  template <int NB, int DP, int RA, int RB, typename T>
  static __device__ __forceinline__ void two_rows_x_rows(float (&acc1)[NB][4], const T* A1,
                                                         float (&acc2)[NB][4], const T* A2, int r0,
                                                         int lda, const T* B1, const T* B2,
                                                         int ldb, int lane) {
    R::template rows_x_rows<NB, DP>(acc1, A1, r0, lda, B1, ldb, lane);
    R::template rows_x_rows<NB, DP>(acc2, A2, r0, lda, B2, ldb, lane);
  }
  // frag_x_rows in two halves, so that Wg's can run while the CUDA cores
  // work: here issue does it all and finish nothing (part, f unused)
  template <int NK, int NJ, int PART, int RB, int NP, int NF, typename T>
  static __device__ __forceinline__ void frag_issue(float (&acc)[NJ][4], float (&)[NP],
                                                    uint32_t (&)[NF][4], const float (&p)[NK][4],
                                                    const T* B, int c0, int ldb, int lane,
                                                    bool /*two: Wg's fault*/) {
    R::template frag_x_rows<NK, NJ, PART>(acc, p, B, c0, ldb, lane);
  }
  template <int NJ, int NP, int NF>
  static __device__ __forceinline__ void frag_finish(float (&)[NJ][4], float (&)[NP],
                                                     uint32_t (&)[NF][4]) {}
};

// --------------------------------------------------------------------------
// bf16 route: mma.sync m16n8k16, ldmatrix
// --------------------------------------------------------------------------
struct Bf16 : PerWarp<Bf16> {
  using T = __nv_bfloat16;
  static constexpr int pitch_rows(int dp) { return dp + 8; }   // 16 bytes mod 128 apart
  static constexpr int pitch_both(int dp) { return dp + 8; }

  static __device__ __forceinline__ void ldsm4(uint32_t addr, uint32_t (&r)[4]) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
  }
  static __device__ __forceinline__ void ldsm4_t(uint32_t addr, uint32_t (&r)[4]) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
  }
  // D (16 x 8, f32) += A (16 x 16, bf16, row) * B (16 x 8, bf16, col)
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
    return *reinterpret_cast<const uint32_t*>(&x);
  }
  // (x, y) -> f0 = bf16x2(x, y) (to nearest even), f1 = bf16x2 of the
  // remainders, f2 = bf16x2 of what those two leave: x = f0 + f1 + f2 to
  // about 2^-27 (two pieces keep about 2^-18)
  static __device__ __forceinline__ void split3(float x, float y, uint32_t& f0, uint32_t& f1,
                                                uint32_t& f2) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const float2 hf = __bfloat1622float2(h);
    x -= hf.x;
    y -= hf.y;
    const __nv_bfloat162 m = __floats2bfloat162_rn(x, y);
    const float2 mf = __bfloat1622float2(m);
    f0 = bits(h);
    f1 = bits(m);
    f2 = bits(__floats2bfloat162_rn(x - mf.x, y - mf.y));
  }
  // the A fragments of k16 step kk of P (16 x 8 NK accumulator fragments),
  // as its three pieces
  template <int NK>
  static __device__ __forceinline__ void pieces(const float (&p)[NK][4], int kk,
                                                uint32_t (&a)[3][4]) {
    split3(p[2 * kk][0], p[2 * kk][1], a[0][0], a[1][0], a[2][0]);
    split3(p[2 * kk][2], p[2 * kk][3], a[0][1], a[1][1], a[2][1]);
    split3(p[2 * kk + 1][0], p[2 * kk + 1][1], a[0][2], a[1][2], a[2][2]);
    split3(p[2 * kk + 1][2], p[2 * kk + 1][3], a[0][3], a[1][3], a[2][3]);
  }

  // acc[n] += A (the warp's 16 rows from r0) . B (rows 8 n .. 8 n + 7)^T over
  // DP columns
  template <int NB, int DP>
  static __device__ __forceinline__ void rows_x_rows(float (&acc)[NB][4], const T* A, int r0,
                                                     int lda, const T* B, int ldb, int lane) {
    const uint32_t a0 = smem_u32(A + (r0 + (lane & 15)) * lda + 8 * (lane >> 4));
    const uint32_t b0 = smem_u32(B + ((lane & 7) + 8 * (lane >> 4)) * ldb + 8 * ((lane >> 3) & 1));
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      uint32_t a[4];
      ldsm4(a0 + 32 * ks, a);
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2) {
        uint32_t b[4];
        ldsm4(b0 + 2 * (16 * n2 * ldb + 16 * ks), b);
        mma(acc[2 * n2], a, b[0], b[1]);
        mma(acc[2 * n2 + 1], a, b[2], b[3]);
      }
    }
  }

  // acc[j] += P . B[:, 8 j .. 8 j + 7]: P (16 x 8 NK) the float32 accumulator
  // fragments of the warp's rows, as three bf16 passes (split3, the small
  // pieces first); B rows 0 .. 8 NK - 1.
  // The tile is summed in partials of PART column blocks that start at zero
  // and are added to acc after it: the tensor cores' float32 accumulation
  // drops the bits below the sum's last place (toward zero), which over a
  // walk of a thousand steps into one accumulator grows to ~1e-4 of it.
  // PART < NJ saves registers and splits P once per partial
  template <int NK, int NJ, int PART>
  static __device__ __forceinline__ void frag_x_rows(float (&acc)[NJ][4], const float (&p)[NK][4],
                                                     const T* B, int c0, int ldb, int lane) {
    constexpr int CH = PART % 4 == 0 ? 4 : 2;  // column blocks whose B fragments load together
    const uint32_t b0 =
        smem_u32(B + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ldb + c0 + 8 * (lane >> 4));
#pragma unroll
    for (int j0 = 0; j0 < NJ; j0 += PART) {
      float part[PART][4] = {};
#pragma unroll
      for (int kk = 0; kk < NK / 2; ++kk) {
        uint32_t a[3][4];
        pieces(p, kk, a);
#pragma unroll
        for (int c0 = 0; c0 < PART; c0 += CH) {
          uint32_t b[CH][2];
#pragma unroll
          for (int c = 0; c < CH; c += 2) {
            uint32_t r[4];
            ldsm4_t(b0 + 2 * (16 * kk * ldb + 8 * (j0 + c0 + c)), r);
            b[c][0] = r[0];
            b[c][1] = r[1];
            b[c + 1][0] = r[2];
            b[c + 1][1] = r[3];
          }
#pragma unroll
          for (int x = 2; x >= 0; --x)
#pragma unroll
            for (int c = 0; c < CH; ++c) mma(part[c0 + c], a[x], b[c][0], b[c][1]);
        }
      }
#pragma unroll
      for (int c = 0; c < PART; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j0 + c][i] += part[c][i];
    }
  }
};

// --------------------------------------------------------------------------
// float32 route: 3xTF32 mma.sync m16n8k8
// --------------------------------------------------------------------------
struct Tf32 : PerWarp<Tf32> {
  using T = float;
  static constexpr int pitch_rows(int dp) { return dp + (dp % 32 ? 32 : 16); }   // 16 mod 32
  static constexpr int pitch_both(int dp) { return dp + 4; }

  // x = hi + lo: hi is x rounded to TF32 (to nearest, ties away from zero,
  // as cvt.rna.tf32.f32), lo = x - hi exactly, passed whole: the tensor
  // cores read the top 19 bits of a .tf32 operand
  static __device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  }
  static __device__ __forceinline__ void split4(float x0, float x1, float x2, float x3,
                                                uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    split(x0, hi[0], lo[0]);
    split(x1, hi[1], lo[1]);
    split(x2, hi[2], lo[2]);
    split(x3, hi[3], lo[3]);
  }
  // D (16 x 8, f32) += A (16 x 8, tf32, row) * B (8 x 8, tf32, col)
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // 3xTF32 into N accumulators d[n0 ..], one pass over them per term (the
  // small terms first), so that back-to-back mmas never share an accumulator
  template <int N, int M>
  static __device__ __forceinline__ void mma3(float (&d)[M][4], int n0, const uint32_t (&ah)[4],
                                              const uint32_t (&al)[4], const uint32_t (&bh)[N][2],
                                              const uint32_t (&bl)[N][2]) {
#pragma unroll
    for (int n = 0; n < N; ++n) mma(d[n0 + n], al, bh[n][0], bh[n][1]);
#pragma unroll
    for (int n = 0; n < N; ++n) mma(d[n0 + n], ah, bl[n][0], bl[n][1]);
#pragma unroll
    for (int n = 0; n < N; ++n) mma(d[n0 + n], ah, bh[n][0], bh[n][1]);
  }

  // acc[n] += A (the warp's 16 rows from r0) . B (rows 8 n .. 8 n + 7)^T over
  // DP columns: lane t takes columns 4t .. 4t + 3 of each 16 for both
  // operands (two 8-column steps), one 128-bit load each
  template <int NB, int DP>
  static __device__ __forceinline__ void rows_x_rows(float (&acc)[NB][4], const T* A, int r0,
                                                     int lda, const T* B, int ldb, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const float* ap = A + (r0 + g) * lda + 4 * t;
    const float* bp = B + g * ldb + 4 * t;
#pragma unroll
    for (int k2 = 0; k2 < DP / 16; ++k2) {
      const float4 x0 = *reinterpret_cast<const float4*>(ap + 16 * k2);
      const float4 x1 = *reinterpret_cast<const float4*>(ap + 8 * lda + 16 * k2);
      float4 y[NB];
#pragma unroll
      for (int n = 0; n < NB; ++n) y[n] = *reinterpret_cast<const float4*>(bp + 8 * n * ldb + 16 * k2);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t ah[4], al[4], bh[NB][2], bl[NB][2];
        if (half == 0)
          split4(x0.x, x1.x, x0.y, x1.y, ah, al);
        else
          split4(x0.z, x1.z, x0.w, x1.w, ah, al);
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          split(half ? y[n].z : y[n].x, bh[n][0], bl[n][0]);
          split(half ? y[n].w : y[n].y, bh[n][1], bl[n][1]);
        }
        mma3<NB>(acc, 0, ah, al, bh, bl);
      }
    }
  }

  // acc[j] += P . B[:, 8 j .. 8 j + 7]: 8-row step kk of B is accumulator
  // block kk of P, its columns in the order 2t, 2t + 1, so the accumulator
  // is the A fragment with no shuffle; B read at rows 8 kk + 2t, 2t + 1.
  // Partials of PART column blocks, as Bf16's
  template <int NK, int NJ, int PART>
  static __device__ __forceinline__ void frag_x_rows(float (&acc)[NJ][4], const float (&p)[NK][4],
                                                     const T* B, int c0, int ldb, int lane) {
    constexpr int CH = PART % 4 == 0 ? 4 : 2;
    const int g = lane >> 2, t = lane & 3;
    const float* bp = B + 2 * t * ldb + c0 + g;
#pragma unroll
    for (int j0 = 0; j0 < NJ; j0 += PART) {
      float part[PART][4] = {};
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t ah[4], al[4];
        split4(p[kk][0], p[kk][2], p[kk][1], p[kk][3], ah, al);
#pragma unroll
        for (int c0 = 0; c0 < PART; c0 += CH) {
          uint32_t bh[CH][2], bl[CH][2];
#pragma unroll
          for (int c = 0; c < CH; ++c) {
            const float* x = bp + 8 * kk * ldb + 8 * (j0 + c0 + c);
            split(x[0], bh[c][0], bl[c][0]);
            split(x[ldb], bh[c][1], bl[c][1]);
          }
          mma3<CH>(part, c0, ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int c = 0; c < PART; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j0 + c][i] += part[c][i];
    }
  }

};

// --------------------------------------------------------------------------
// bf16 route on wgmma (a warpgroup's 64 rows), operands read by the tensor
// cores from 128-byte swizzled shared memory
// --------------------------------------------------------------------------
namespace wgmma {

constexpr int kRow = 128;                    // bytes of a box row: 64 bf16

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// pins registers a wgmma reads or writes across its issue and wait
template <int N>
__device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle (layout type 1);
// offsets in bytes, encoded in 16-byte units
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// D (64 x 64, f32) {=, +}= A (64 x 16, smem) * B (64 x 16, smem), both K-major
__device__ __forceinline__ void ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) {=, +}= A (64 x 16, registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}


// D (64 x 128, f32) {=, +}= A (64 x 16, smem) * B (128 x 16, smem), both K-major
__device__ __forceinline__ void ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}


}  // namespace wgmma

// A tile of R rows x DP columns is DP / 64 boxes of R rows x 128 bytes, box
// x at x R 128, row r at r 128, its 16-byte piece c at (c ^ (r % 8)) 16:
// the layout TMA's 128-byte swizzle writes, here by cp.async (pieces past
// dt zero-filled).  Each warpgroup of the CTA owns 64 rows; S-type
// products read both operands K-major; P, dS enter as register fragments
// split into hi and lo as in Bf16, against the streamed tile read MN-major
// (the transpose bit), one 64-column box at a time.  Each product is
// issued, committed and waited for whole.
struct Wg {
  using T = __nv_bfloat16;
  static constexpr bool kPartial = true;     // frag_issue sums into a register partial
  static constexpr int pitch_rows(int dp) { return dp; }   // a tile is rows x dp, boxed
  static constexpr int pitch_both(int dp) { return dp; }

  template <int NT, int DP>
  static __device__ __forceinline__ void load(T* dst, int ld, const T* src, long long rs, int r0,
                                              int rows, int n, int dt) {
    load_tile<T, NT, DP, true>(dst, ld, src, rs, r0, rows, n, dt);
  }
  // cp.async writes through the generic proxy; wgmma reads through the async one
  static __device__ __forceinline__ void landed() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }

  // acc1 = A1 . B1^T and acc2 = A2 . B2^T over the warpgroup's 64 rows of
  // A (the one holding row r0), issued together, one wait
  template <int NB, int DP, int RA, int RB>
  static __device__ __forceinline__ void two_rows_x_rows(float (&acc1)[NB][4], const T* A1,
                                                         float (&acc2)[NB][4], const T* A2,
                                                         int r0, int /*lda*/, const T* B1,
                                                         const T* B2, int /*ldb*/, int /*lane*/) {
    static_assert((NB == 8 || NB == 16) && RA % 64 == 0 && RB == 8 * NB, "m64n64 or m64n128");
    float(&d1)[4 * NB] = reinterpret_cast<float(&)[4 * NB]>(acc1);
    float(&d2)[4 * NB] = reinterpret_cast<float(&)[4 * NB]>(acc2);
    const uint32_t rows = (r0 & ~63) * wgmma::kRow;
    const uint32_t a1 = smem_u32(A1) + rows, a2 = smem_u32(A2) + rows;
    const uint32_t b1 = smem_u32(B1), b2 = smem_u32(B2);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t ao = (kk / 4) * RA * wgmma::kRow + (kk % 4) * 32;
      const uint32_t bo = (kk / 4) * RB * wgmma::kRow + (kk % 4) * 32;
      if constexpr (NB == 8) {
        wgmma::ss_n64(d1, wgmma::desc(a1 + ao, 16, 1024), wgmma::desc(b1 + bo, 16, 1024), kk > 0);
        wgmma::ss_n64(d2, wgmma::desc(a2 + ao, 16, 1024), wgmma::desc(b2 + bo, 16, 1024), kk > 0);
      } else {
        wgmma::ss_n128(d1, wgmma::desc(a1 + ao, 16, 1024), wgmma::desc(b1 + bo, 16, 1024), kk > 0);
        wgmma::ss_n128(d2, wgmma::desc(a2 + ao, 16, 1024), wgmma::desc(b2 + bo, 16, 1024), kk > 0);
      }
    }
    wgmma::commit();
    wgmma::wait_all();
    wgmma::keep(d1);
    wgmma::keep(d2);
  }

  // acc += P . B (one 64-column box): P (64 x 8 NK) the accumulator
  // fragments, split into three bf16 pieces (f, Bf16::pieces) and issued as
  // three passes into part, which the first starts at zero; the tile's sum
  // is added to acc by frag_finish, after the CUDA cores have done other
  // work (Bf16's reason for the partial).  B is read MN-major.
  template <int NK, int NJ, int PART, int RB, int NP, int NF>
  static __device__ __forceinline__ void frag_issue(float (&)[NJ][4], float (&part)[NP],
                                                    uint32_t (&f)[NF][4], const float (&p)[NK][4],
                                                    const T* B, int /*c0*/, int /*ldb*/,
                                                    int /*lane*/, bool two) {
    static_assert(NK * 8 == RB && NJ == 8 && NP == 32 && NF == 3 * NK / 2, "one box");
    uint32_t(&a)[NK / 2][3][4] = reinterpret_cast<uint32_t(&)[NK / 2][3][4]>(f);
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
      Bf16::pieces(p, kk, a[kk]);
      if (two) a[kk][2][0] = a[kk][2][1] = a[kk][2][2] = a[kk][2][3] = 0u;   // kFaultPieces
    }
    const uint32_t b0 = smem_u32(B);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
      const uint64_t db = wgmma::desc(b0 + kk * 16 * wgmma::kRow, RB * wgmma::kRow, 1024);
#pragma unroll
      for (int x = 2; x >= 0; --x) wgmma::rs_n64(part, a[kk][x], db, kk > 0 || x < 2);
    }
    wgmma::commit();
    wgmma::keep(part);
  }
  template <int NJ, int NP, int NF>
  static __device__ __forceinline__ void frag_finish(float (&acc)[NJ][4], float (&part)[NP],
                                                     uint32_t (&f)[NF][4]) {
    wgmma::wait_all();
    wgmma::keep(part);
#pragma unroll
    for (int i = 0; i < NF; ++i) wgmma::keep(f[i]);
#pragma unroll
    for (int i = 0; i < NP; ++i) acc[i / 4][i % 4] += part[i];
  }
};

// --------------------------------------------------------------------------
// the three launches
// --------------------------------------------------------------------------

// R: route; DP: padded head dim (multiple of 16); BM: rows a CTA owns (16
// a row group of warps); BN: rows of a streamed tile (multiple of 16); CS:
// warps on each row group, each with DP / CS columns of the accumulators;
// MINB: CTAs an SM should hold (__launch_bounds__: registers capped to fit);
// PART: accumulator column blocks a partial sums a tile in (0: all up to 8)
template <class R, int DP_, int BM_, int BN_, int CS_, int MINB_ = 1, int PART_ = 0>
struct Cfg {
  using Route = R;
  using T = typename R::T;
  static constexpr int DP = DP_, BM = BM_, BN = BN_, CS = CS_, kMinBlocks = MINB_;
  static constexpr int kGroups = BM / 16, kWarps = kGroups * CS, kThreads = 32 * kWarps;
  static constexpr int NB = BN / 8;          // S blocks of 8 streamed rows
  static constexpr int NJ = DP / CS / 8;     // accumulator column blocks a warp holds
  static constexpr int PART = PART_ ? PART_ : NJ <= 8 ? NJ : NJ % 4 == 0 ? 4 : 2;
  static constexpr int NP = R::kPartial ? 32 : 1;   // floats of Wg's partial
  static constexpr int LR = R::pitch_rows(DP), LB = R::pitch_both(DP);
  static_assert(BM % 16 == 0 && BN % 16 == 0 && kPadRows % BM == 0 && kPadRows % BN == 0, "tiles");
  static_assert(DP % (8 * CS) == 0 && NJ % PART == 0 && PART % 2 == 0, "column split");
};

// the dynamic shared memory, 1024-byte aligned (swizzled tiles need it);
// every launch asks for 1024 bytes more than its tiles
template <typename T>
__device__ __forceinline__ T* smem_base() {
  extern __shared__ float4 smem4[];
  const uint32_t raw = smem_u32(smem4);
  return reinterpret_cast<T*>(reinterpret_cast<char*>(smem4) + (((raw + 1023u) & ~1023u) - raw));
}

// (a) lse2 and delta of one query tile.  PB (probs_bf16): delta = sum_j
// round(p_j) dP_j / l with p_j = 2^(s c - m) against the row's final max m,
// which the online pass knows only at its end, so a second pass over the
// same key tiles takes it
template <class C, bool PB>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks) bwd_prep(const Args a) {
  using T = typename C::T;
  using R = typename C::Route;
  constexpr int DP = C::DP, BM = C::BM, BN = C::BN, NB = C::NB, NT = C::kThreads, L = C::LR;
  T* Qs = smem_base<T>();
  T* Gs = Qs + BM * L;                       // dO
  T* KV = Gs + BM * L;                       // stage s: K at KV + 2 s BN L, V after it
  constexpr int S = kStages;

  const int per = a.hq * a.batch;
  const int qt = a.tqp / BM - 1 - (int)(blockIdx.x / per), hb = (int)(blockIdx.x % per);
  const int h = hb % a.hq, b = hb / a.hq, hk = h / (a.hq / a.hkv);
  const int q0 = qt * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;
  const long long row0 = ((long long)b * a.hq + h) * a.tqp + q0;
  if (q0 >= a.tq) {                          // a tile of padding rows only
    for (int i = threadIdx.x; i < BM; i += NT) a.m2[row0 + i] = a.linv[row0 + i] = a.delta[row0 + i] = 0.f;
    return;
  }

  const T* kg = (const T*)a.k + b * a.sk.b + hk * a.sk.h;
  const T* vg = (const T*)a.v + b * a.sv.b + hk * a.sv.h;
  int lo, hi;
  key_range(a, q0, BM, &lo, &hi);
  const int kt0 = lo / BN, kt1 = (hi + BN - 1) / BN;
  auto stage = [&](int kt) {                 // key tile kt into its stage, one copy group
    if (kt < kt1) {
      T* st = KV + 2 * ((kt - kt0) % S) * BN * L;
      R::template load<NT, DP>(st, L, kg, a.sk.t, kt * BN, BN, a.tk, a.dt);
      R::template load<NT, DP>(st + BN * L, L, vg, a.sv.t, kt * BN, BN, a.tk, a.dt);
    }
    cp_commit();
  };
  R::template load<NT, DP>(Qs, L, (const T*)a.q + b * a.sq.b + h * a.sq.h, a.sq.t, q0, BM, a.tq, a.dt);
  R::template load<NT, DP>(Gs, L, (const T*)a.dout + b * a.sdo.b + h * a.sdo.h, a.sdo.t, q0, BM, a.tq,
                   a.dt);
  for (int i = 0; i < S - 1; ++i) stage(kt0 + i);

  // per row (g, g + 8): running max m, this lane's sums of p and p dP
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, pd[2] = {0.f, 0.f};
  for (int kt = kt0; kt < kt1; ++kt) {
    const int s = (kt - kt0) % S, k0 = kt * BN;
    stage(kt + S - 1);
    cp_wait<S - 1>();                        // tile kt has landed
    R::landed();
    __syncthreads();
    const T* Ks = KV + 2 * s * BN * L;
    float sc[NB][4] = {}, dp[NB][4] = {};
    R::template two_rows_x_rows<NB, DP, BM, BN>(sc, Qs, dp, Gs, r0, L, Ks, Ks + BN * L, L, lane);

    const bool edge = edge_tile(a, a.causal, q0, BM, k0, BN);
    if (edge) {                              // the per-element mask on cut tiles only
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (!seen(q0 + r0 + g + 8 * (i >> 1), k0 + 8 * n + 2 * t + (i & 1), a, a.causal))
            sc[n][i] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], sc[n][i]);
    float mref[2], rs[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]) * a.scale_log2);
      mref[r] = m_new == -INFINITY ? 0.f : m_new;   // no key seen yet
      const float alpha = ex2(m[r] - mref[r]);     // 0 while m = -inf
      l[r] *= alpha;
      pd[r] *= alpha;
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = ex2(fmaf(sc[n][i], a.scale_log2, -mref[i >> 1]));   // 0 where masked
        rs[i >> 1] += e;
        rd[i >> 1] = fmaf(e, dp[n][i], rd[i >> 1]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += rs[r];
      pd[r] += rd[r];
    }
    __syncthreads();                         // stage s is free for the copy after next
  }

  if constexpr (PB) {                        // the second pass: delta of the rounded P
    const float mf[2] = {m[0] == -INFINITY ? 0.f : m[0], m[1] == -INFINITY ? 0.f : m[1]};
    pd[0] = pd[1] = 0.f;
    for (int i = 0; i < S - 1; ++i) stage(kt0 + i);
    for (int kt = kt0; kt < kt1; ++kt) {
      const int s = (kt - kt0) % S, k0 = kt * BN;
      stage(kt + S - 1);
      cp_wait<S - 1>();
      R::landed();
      __syncthreads();
      const T* Ks = KV + 2 * s * BN * L;
      float sc[NB][4] = {}, dp[NB][4] = {};
      R::template two_rows_x_rows<NB, DP, BM, BN>(sc, Qs, dp, Gs, r0, L, Ks, Ks + BN * L, L, lane);
      const bool edge = edge_tile(a, a.causal, q0, BM, k0, BN);
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool in = !edge || seen(q0 + r0 + g + 8 * (i >> 1), k0 + 8 * n + 2 * t + (i & 1), a,
                                        a.causal);
          const float e = in ? bf16r(ex2(fmaf(sc[n][i], a.scale_log2, -mf[i >> 1]))) : 0.f;
          pd[i >> 1] = fmaf(e, dp[n][i], pd[i >> 1]);
        }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float ls = quad_sum(l[r]), ps = quad_sum(pd[r]);
    const int i = r0 + g + 8 * r;
    if (t == 0) {
      const bool in = q0 + i < a.tq;
      a.m2[row0 + i] = in ? m[r] : 0.f;
      a.linv[row0 + i] = in ? 1.f / ls : 0.f;
      a.delta[row0 + i] = in && !(a.fault & kFaultDelta) ? ps / ls : 0.f;
    }
  }
}

// (b) dK and dV of one key tile, summed over the GQA group's query heads.
// PB (probs_bf16): dV takes P rounded to bf16 (round(p) / l), dS the
// float32 P, so dS is formed before dV's product is issued
template <class C, bool PB>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks) bwd_dkdv(const Args a) {
  using T = typename C::T;
  using R = typename C::Route;
  constexpr int DP = C::DP, BM = C::BM, BN = C::BN, NB = C::NB, NJ = C::NJ, NT = C::kThreads;
  constexpr int LO = C::LR, LS = C::LB;      // owned K, V; streamed Q, dO
  T* Ks = smem_base<T>();
  T* Vs = Ks + BM * LO;
  T* QG = Vs + BM * LO;                      // stage s: Q at QG + 2 s BN LS, dO after it
  constexpr int S = kStages;
  float* LD = reinterpret_cast<float*>(QG + 2 * S * BN * LS);   // stage s: m2, 1 / l, delta at LD + 3 s BN

  const int per = a.hkv * a.batch;
  const int kt = (int)(blockIdx.x / per), hb = (int)(blockIdx.x % per);
  const int hk = hb % a.hkv, b = hb / a.hkv, rep = a.hq / a.hkv;
  const int k0 = kt * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp % C::kGroups), c0 = (DP / C::CS) * (warp / C::kGroups);
  const bool causal = a.causal && !(a.fault & kFaultCausal), two = a.fault & kFaultPieces;

  int lo, hi;
  query_range(a, causal, k0, BM, &lo, &hi);
  const int qt0 = lo / BN, nq = hi > lo ? (hi + BN - 1) / BN - qt0 : 0;
  const int heads = (a.fault & kFaultGroup) ? 1 : rep;
  const int items = heads * nq;              // (head, query tile) pairs, head-major

  float dk[NJ][4] = {}, dv[NJ][4] = {};
  float part[C::NP];                         // Wg: the tile's partial of dV or dK
  uint32_t fr[3 * (NB / 2)][4];              // Wg: P^T or dS^T as three bf16 pieces
  auto issue = [&](int it, int s) {
    const int h = hk * rep + it / nq, q0 = (qt0 + it % nq) * BN;
    T* qs = QG + 2 * s * BN * LS;
    R::template load<NT, DP>(qs, LS, (const T*)a.q + b * a.sq.b + h * a.sq.h, a.sq.t, q0, BN, a.tq, a.dt);
    R::template load<NT, DP>(qs + BN * LS, LS, (const T*)a.dout + b * a.sdo.b + h * a.sdo.h, a.sdo.t, q0,
                     BN, a.tq, a.dt);
    const long long row = ((long long)b * a.hq + h) * a.tqp + q0;
    float* ld = LD + 3 * s * BN;
    for (int i = threadIdx.x; i < 3 * BN / 4; i += NT) {   // BN / 4 pieces of each statistic
      const int x = i / (BN / 4), w = i % (BN / 4);
      const float* src = (x == 0 ? a.m2 : x == 1 ? a.linv : a.delta) + row;
      cp_async16(smem_u32(ld + x * BN + 4 * w), src + 4 * w, 16);
    }
  };

  if (items > 0) {
    R::template load<NT, DP>(Ks, LO, (const T*)a.k + b * a.sk.b + hk * a.sk.h, a.sk.t, k0, BM, a.tk, a.dt);
    R::template load<NT, DP>(Vs, LO, (const T*)a.v + b * a.sv.b + hk * a.sv.h, a.sv.t, k0, BM, a.tk, a.dt);
#pragma unroll 1
    for (int i = 0; i < S - 1; ++i) {        // one copy group each (K, V go with the first)
      if (i < items) issue(i, i);
      cp_commit();
    }
  }
  for (int it = 0; it < items; ++it) {
    const int s = it % S, q0 = (qt0 + it % nq) * BN;
    if (it + S - 1 < items) issue(it + S - 1, (it + S - 1) % S);
    cp_commit();
    cp_wait<S - 1>();                        // item it has landed
    R::landed();
    __syncthreads();
    const T* Qs = QG + 2 * s * BN * LS;
    const T* Gs = Qs + BN * LS;
    const float* m2 = LD + 3 * s * BN;
    const float* li = m2 + BN;
    const float* dl = li + BN;
    // keys are the rows: st[n][i] at key k0 + r0 + g + 8 (i >> 1), query
    // q0 + 8 n + 2 t + (i & 1)
    float st[NB][4] = {}, dpt[NB][4] = {};
    R::template two_rows_x_rows<NB, DP, BM, BN>(st, Ks, dpt, Vs, r0, LO, Qs, Gs, LS, lane);
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = ex2(fmaf(st[n][i], a.scale_log2, -m2[8 * n + 2 * t + (i & 1)]));
        st[n][i] = PB ? e : e * li[8 * n + 2 * t + (i & 1)];
      }
    if (edge_tile(a, causal, q0, BN, k0, BM)) {   // the per-element mask on cut tiles only
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (!seen(q0 + 8 * n + 2 * t + (i & 1), k0 + r0 + g + 8 * (i >> 1), a, causal))
            st[n][i] = 0.f;
    }
    if constexpr (PB) {
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 8 * n + 2 * t + (i & 1);
          dpt[n][i] = st[n][i] * li[c] * (dpt[n][i] - dl[c]);
          st[n][i] = bf16r(st[n][i]) * li[c];
        }
      R::template frag_issue<NB, NJ, C::PART, BN>(dv, part, fr, st, Gs, c0, LS, lane, two);
    } else {
      // dV's product runs while the CUDA cores form dS^T
      R::template frag_issue<NB, NJ, C::PART, BN>(dv, part, fr, st, Gs, c0, LS, lane, two);
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) dpt[n][i] = st[n][i] * (dpt[n][i] - dl[8 * n + 2 * t + (i & 1)]);
    }
    R::template frag_finish<NJ>(dv, part, fr);
    R::template frag_issue<NB, NJ, C::PART, BN>(dk, part, fr, dpt, Qs, c0, LS, lane, two);
    R::template frag_finish<NJ>(dk, part, fr);
    __syncthreads();                         // stage s is free for the copy after next
  }

  const float sc = (a.fault & kFaultScale) ? 1.f : a.scale;
  T* dkb = (T*)a.dk + b * a.sdk.b + hk * a.sdk.h;
  T* dvb = (T*)a.dv + b * a.sdv.b + hk * a.sdv.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = k0 + r0 + g + 8 * r;
    if (j >= a.tk) continue;
#pragma unroll
    for (int n = 0; n < NJ; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * n + 2 * t + e;
        if (col >= a.d) continue;
        dkb[(long long)j * a.sdk.t + col] = from_f<T>(dk[n][2 * r + e] * sc);
        dvb[(long long)j * a.sdv.t + col] = from_f<T>(dv[n][2 * r + e]);
      }
  }
}

// (c) dQ of one query tile
template <class C>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks) bwd_dq(const Args a) {
  using T = typename C::T;
  using R = typename C::Route;
  constexpr int DP = C::DP, BM = C::BM, BN = C::BN, NB = C::NB, NJ = C::NJ, NT = C::kThreads;
  constexpr int LO = C::LR, LS = C::LB;      // owned Q, dO; streamed K, V
  T* Qs = smem_base<T>();
  T* Gs = Qs + BM * LO;
  T* KV = Gs + BM * LO;                      // stage s: K at KV + 2 s BN LS, V after it
  constexpr int S = kStages;

  const int per = a.hq * a.batch;
  const int nt = (a.tq + BM - 1) / BM;
  const int qt = nt - 1 - (int)(blockIdx.x / per), hb = (int)(blockIdx.x % per);
  const int h = hb % a.hq, b = hb / a.hq, hk = h / (a.hq / a.hkv);
  const int q0 = qt * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp % C::kGroups), c0 = (DP / C::CS) * (warp / C::kGroups);
  const long long row0 = ((long long)b * a.hq + h) * a.tqp + q0 + r0 + g;
  const float m2[2] = {a.m2[row0], a.m2[row0 + 8]};
  const float li[2] = {a.linv[row0], a.linv[row0 + 8]};
  const float dl[2] = {a.delta[row0], a.delta[row0 + 8]};
  const bool two = a.fault & kFaultPieces;

  const T* kg = (const T*)a.k + b * a.sk.b + hk * a.sk.h;
  const T* vg = (const T*)a.v + b * a.sv.b + hk * a.sv.h;
  int lo, hi;
  key_range(a, q0, BM, &lo, &hi);
  const int kt0 = lo / BN, kt1 = (hi + BN - 1) / BN;
  auto stage = [&](int kt) {                 // key tile kt into its stage, one copy group
    if (kt < kt1) {
      T* st = KV + 2 * ((kt - kt0) % S) * BN * LS;
      R::template load<NT, DP>(st, LS, kg, a.sk.t, kt * BN, BN, a.tk, a.dt);
      R::template load<NT, DP>(st + BN * LS, LS, vg, a.sv.t, kt * BN, BN, a.tk, a.dt);
    }
    cp_commit();
  };
  R::template load<NT, DP>(Qs, LO, (const T*)a.q + b * a.sq.b + h * a.sq.h, a.sq.t, q0, BM, a.tq, a.dt);
  R::template load<NT, DP>(Gs, LO, (const T*)a.dout + b * a.sdo.b + h * a.sdo.h, a.sdo.t, q0, BM, a.tq,
                   a.dt);
  for (int i = 0; i < S - 1; ++i) stage(kt0 + i);

  float dq[NJ][4] = {};
  float part[C::NP];                         // Wg: the tile's partial of dQ
  uint32_t fr[3 * (NB / 2)][4];              // Wg: dS as three bf16 pieces
  for (int kt = kt0; kt < kt1; ++kt) {
    const int s = (kt - kt0) % S, k0 = kt * BN;
    stage(kt + S - 1);
    cp_wait<S - 1>();                        // tile kt has landed
    R::landed();
    __syncthreads();
    const T* Ks = KV + 2 * s * BN * LS;
    float sc[NB][4] = {}, dp[NB][4] = {};
    R::template two_rows_x_rows<NB, DP, BM, BN>(sc, Qs, dp, Gs, r0, LO, Ks, Ks + BN * LS, LS,
                                                lane);
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sc[n][i] = ex2(fmaf(sc[n][i], a.scale_log2, -m2[i >> 1])) * li[i >> 1];
    if (edge_tile(a, a.causal, q0, BM, k0, BN)) {   // the per-element mask on cut tiles only
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (!seen(q0 + r0 + g + 8 * (i >> 1), k0 + 8 * n + 2 * t + (i & 1), a, a.causal))
            sc[n][i] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) dp[n][i] = sc[n][i] * (dp[n][i] - dl[i >> 1]);   // dS
    R::template frag_issue<NB, NJ, C::PART, BN>(dq, part, fr, dp, Ks, c0, LS, lane, two);
    R::template frag_finish<NJ>(dq, part, fr);
    __syncthreads();                         // stage s is free for the copy after next
  }

  const float sc = (a.fault & kFaultScale) ? 1.f : a.scale;
  T* dqb = (T*)a.dq + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + r0 + g + 8 * r;
    if (i >= a.tq) continue;
#pragma unroll
    for (int n = 0; n < NJ; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * n + 2 * t + e;
        if (col < a.d) dqb[(long long)i * a.sdq.t + col] = from_f<T>(dq[n][2 * r + e] * sc);
      }
  }
}

// dynamic shared memory of each launch (bytes)
template <class C>
constexpr int smem_prep() {
  return (int)sizeof(typename C::T) * (2 * C::BM + 2 * kStages * C::BN) * C::LR + 1024;
}
template <class C>
constexpr int smem_dkdv() {
  return (int)sizeof(typename C::T) * (2 * C::BM * C::LR + 2 * kStages * C::BN * C::LB) +
         12 * kStages * C::BN + 1024;
}
template <class C>
constexpr int smem_dq() {
  return (int)sizeof(typename C::T) * (2 * C::BM * C::LR + 2 * kStages * C::BN * C::LB) + 1024;
}

// one instance: the three launches' configurations for a padded head dim
template <class P, class B, class Q, bool PB>
int launch(const Args& a, cudaStream_t stream) {
  const int sp = smem_prep<P>(), sk = smem_dkdv<B>(), sq = smem_dq<Q>();
  cudaError_t e =
      cudaFuncSetAttribute(bwd_prep<P, PB>, cudaFuncAttributeMaxDynamicSharedMemorySize, sp);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(bwd_dkdv<B, PB>, cudaFuncAttributeMaxDynamicSharedMemorySize, sk);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(bwd_dq<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, sq);
  if (e != cudaSuccess) return (int)e;
  const unsigned per_q = (unsigned)(a.hq * a.batch), per_k = (unsigned)(a.hkv * a.batch);
  bwd_prep<P, PB><<<per_q * (a.tqp / P::BM), P::kThreads, sp, stream>>>(a);
  bwd_dkdv<B, PB><<<per_k * ((a.tk + B::BM - 1) / B::BM), B::kThreads, sk, stream>>>(a);
  bwd_dq<Q><<<per_q * ((a.tq + Q::BM - 1) / Q::BM), Q::kThreads, sq, stream>>>(a);
  return (int)cudaGetLastError();
}

// The instance table: the (a), (b) and (c) configurations for each padded
// head dim, Cfg<route, DP, BM, BN, CS, MINB, PART>.  bf16 at DP = 64 (the
// trained models' heads) runs on wgmma; the other widths on mma.sync, where
// (b)'s dK and dV accumulators take DP / CS / 4 registers a thread and
// S^T, dP^T BN / 4: BN = 32 at DP = 128, and from DP = 256 the columns
// split over CS = 4 warps on 32 keys.  float32: at DP = 128 (b) streams
// 16 queries a tile with a partial of 2 column blocks; from DP = 256 the
// streamed tiles are 16 rows, to fit shared memory.  MINB, PART and the
// tile sizes where the card's timings favoured them (PERF.md, Findings).
template <class R, int DP> struct Inst;
template <> struct Inst<Bf16, 16> {
  using Prep = Cfg<Bf16, 16, 64, 64, 1>;
  using DkDv = Cfg<Bf16, 16, 64, 64, 1>;
  using Dq = Cfg<Bf16, 16, 64, 64, 1>;
};
template <> struct Inst<Bf16, 64> {
  using Prep = Cfg<Wg, 64, 64, 64, 1>;
  using DkDv = Cfg<Wg, 64, 64, 64, 1>;
  using Dq = Cfg<Wg, 64, 64, 64, 1>;
};
template <> struct Inst<Bf16, 128> {
  using Prep = Cfg<Bf16, 128, 64, 64, 1>;
  using DkDv = Cfg<Bf16, 128, 64, 32, 1, 1, 2>;
  using Dq = Cfg<Bf16, 128, 64, 64, 1, 1, 4>;
};
template <int DP> struct InstWide {
  using Prep = Cfg<Bf16, DP, 64, 32, 1>;
  using DkDv = Cfg<Bf16, DP, 32, 32, 4>;
  using Dq = Cfg<Bf16, DP, 64, 32, 2, 1, 2>;
};
template <> struct Inst<Bf16, 256> : InstWide<256> {};
template <> struct Inst<Bf16, 320> : InstWide<320> {};
template <> struct Inst<Tf32, 16> {
  using Prep = Cfg<Tf32, 16, 64, 32, 1>;
  using DkDv = Cfg<Tf32, 16, 64, 32, 1>;
  using Dq = Cfg<Tf32, 16, 64, 32, 1>;
};
template <> struct Inst<Tf32, 64> {
  using Prep = Cfg<Tf32, 64, 64, 32, 1>;
  using DkDv = Cfg<Tf32, 64, 64, 32, 1>;
  using Dq = Cfg<Tf32, 64, 64, 32, 1>;
};
template <> struct Inst<Tf32, 128> {
  using Prep = Cfg<Tf32, 128, 64, 64, 1>;
  using DkDv = Cfg<Tf32, 128, 64, 16, 1, 1, 2>;
  using Dq = Cfg<Tf32, 128, 64, 16, 1, 2, 2>;
};
template <int DP> struct InstWideF {
  using Prep = Cfg<Tf32, DP, 32, 16, 1>;
  using DkDv = Cfg<Tf32, DP, 32, 16, 4>;
  using Dq = Cfg<Tf32, DP, 32, 16, 2>;
};
template <> struct Inst<Tf32, 256> : InstWideF<256> {};
template <> struct Inst<Tf32, 320> : InstWideF<320> {};

template <class R, int DP>
int launch_dp(const Args& a, cudaStream_t stream) {
  using I = Inst<R, DP>;
  return a.probs_bf16 ? launch<typename I::Prep, typename I::DkDv, typename I::Dq, true>(a, stream)
                      : launch<typename I::Prep, typename I::DkDv, typename I::Dq, false>(a, stream);
}

template <int N> struct Dp { static constexpr int value = N; };

// f(Dp<DP>()) for the padded head dim that takes dt columns; -1 past 320
template <class F>
int with_dp(int dt, F&& f) {
  if (dt <= 16) return f(Dp<16>());
  if (dt <= 64) return f(Dp<64>());
  if (dt <= 128) return f(Dp<128>());
  if (dt <= 256) return f(Dp<256>());
  if (dt <= 320) return f(Dp<320>());
  return -1;
}

template <class R>
int launch_any(const Args& a, cudaStream_t stream) {
  const int rc = with_dp(a.dt, [&](auto dp) { return launch_dp<R, decltype(dp)::value>(a, stream); });
  return rc < 0 ? (int)cudaErrorInvalidValue : rc;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// q/dq/dout (B, Hq, Tq, .), k/v/dk/dv (B, Hkv, Tk, .): element strides of
// dims b, h, t (strides: 3 for each of q, k, v, dout, dq, dk, dv, in that
// order), the last dim contiguous.  q, k, v and dout hold dt columns
// (d rounded up to 8 for bf16, 4 for float32, zero past d) in 16-byte
// aligned rows; dq, dk, dv d columns.  lse and delta: (B, Hq, tqp) float32
// scratch, tqp = Tq rounded up to 128.  1 <= d <= 320, Hq % Hkv == 0,
// Tk >= 1, and Tq <= Tk when causal (the wrapper checks).  probs_bf16:
// the gradient of the forward with P and V rounded to bf16 for P V.  bf16
// (is_f32 = 0) or float32.
int flash_attention_bwd_launch(int is_f32, const void* q, const void* k, const void* v,
                               const void* dout, void* dq, void* dk, void* dv, float* stats,
                               const long long* strides,
                               int batch, int hq, int hkv, int tq, int tk, int d, int dt,
                               int causal, int window, int probs_bf16, float scale, int fault,
                               void* stream) {
  if (batch == 0 || hq == 0 || tq == 0) return (int)cudaGetLastError();
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.tqp = (tq + kPadRows - 1) / kPadRows * kPadRows;
  const long long n_rows = (long long)batch * hq * a.tqp;
  a.m2 = stats;
  a.linv = stats + n_rows;
  a.delta = stats + 2 * n_rows;
  Strides* dst[7] = {&a.sq, &a.sk, &a.sv, &a.sdo, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 7; ++i) *dst[i] = Strides{strides[3 * i], strides[3 * i + 1],
                                                strides[3 * i + 2]};
  a.batch = batch;
  a.hq = hq;
  a.hkv = hkv;
  a.tq = tq;
  a.tk = tk;
  a.d = d;
  a.dt = dt;
  a.causal = causal;
  a.window = window;
  a.probs_bf16 = probs_bf16 && !(fault & kFaultFlag);
  a.fault = fault;
  a.scale = scale;
  a.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = (cudaStream_t)stream;
  return is_f32 ? launch_any<Tf32>(a, s) : launch_any<Bf16>(a, s);
}

}  // extern "C"
