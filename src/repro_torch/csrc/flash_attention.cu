// Flash-attention forward for Hopper (sm_90a).  Plain C entry points,
// bound with ctypes by repro_torch/kernels/flash_attention.py; each
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() (or an encoding error of a TMA descriptor).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel): online-softmax attention of q (B, Hq, Tq, D) over
// k/v (B, Hkv, Tk, D), output in q's type with float32 softmax and
// accumulation.  Queries are suffix-aligned (query i sits at key
// position i + Tk - Tq); a key is seen when kpos < Tk, and kpos <= qpos
// if causal, and kpos > qpos - window if window > 0.  Query head h reads
// kv head h / (Hq / Hkv): K/V are never replicated.
//
// Two routes, chosen by dtype in the wrapper, both on the tensor cores:
//   bf16 -> flash_fwd_wgmma (wgmma fed by a TMA ring; its design below);
//   f32  -> flash_fwd_tf32 (3xTF32 mma.sync; its design at namespace f32).
//
// Bound: operations.  The function does 4 D flops per (query, key) pair
// the mask keeps: 2.75e11 at B=8, Hq=32, T=2048, D=128 causal, 0.278 ms
// at the card's 989 TFLOP/s bf16 tensor rate, against 0.10 ms of bytes.
// This kernel does 6 D per pair on the tensor cores (the split of P
// below), so its own floor at peak is 0.42 ms for that call.
//
// Design of flash_fwd_wgmma.  One CTA covers one (batch, query head,
// query tile); the tiles run heaviest first (the last query tiles see the
// most keys).  384 threads in three warpgroups: warpgroup 0 is the
// producer (one thread issues every TMA copy; setmaxnreg gives its
// registers away), warpgroups 1-2 are consumers with 240 registers each.
//   * TMA ring.  The host encodes one tensor map per operand over the
//     strided 4-D view (D, T, H, B) with byte strides, 128-byte swizzle
//     and 64-column boxes, so a row tile is ceil(D / 64) boxes.  TMA
//     zero-fills columns past D and rows past Tq / Tk (a V row past Tk is
//     0, never NaN).  GQA is the kv-head coordinate of the K/V copies.
//     Q lands once; K and V stream through kStages stages, each with a
//     full barrier (TMA bytes arrive) and an empty barrier (both consumer
//     warpgroups have read it), separately for K and V so that S = Q K^T
//     starts while V is in flight.
//   * S = Q K^T: wgmma m64nBKk16, bf16 in, float32 accumulate, both
//     operands K-major in shared memory.  Only key tiles that the mask
//     leaves non-empty are visited, and the per-element mask runs only on
//     the tiles that the diagonal, the window edge or Tk cuts.  The scale
//     and log2(e) fold into one multiplier: p = 2^(s c - m) is one FMA and
//     one MUFU.EX2.  Online softmax in registers: a row's running max and
//     normaliser are shared by the 4 threads holding it (two shuffles); a
//     masked key gives p = 0 outright, m_ref = 0 while the row has seen no
//     key, l >= 1e-30.
//   * Overlap.  Each consumer issues tile j's S = Q K^T and then tile
//     j-1's O += P V, waits for S only, and runs tile j's softmax while
//     P V is still on the tensor cores; the two consumers run unsynchronised,
//     so one's softmax also hides behind the other's products.
//   * O += P V without losing precision.  The tensor cores take P in
//     bf16, which alone would cost 8 bits of each probability.  P is
//     split into P_hi = bf16(P) and P_lo = bf16(P - P_hi) (about 16 bits
//     together) and both go through wgmma into the same float32
//     accumulator.  A comes from registers: the S accumulator fragment
//     converts in place to the A fragment.  B is the V tile as loaded
//     (MN-major, the transpose bit), one m64n64k16 per 64-column box.
//   * Tiles.  D <= 128: 128 query rows (64 per consumer) x 128 keys;
//     D <= 256: 128 x 64 keys.  D <= 320 would need 160 accumulator
//     registers a thread, so the two consumers share 64 query rows and
//     split O's columns (three boxes and two); each computes S for those
//     rows itself (2 D more flops a pair) rather than passing P through
//     shared memory.
//   * probs_bf16 (a compile-time flag, instances of their own): P goes
//     through wgmma as P_hi = bf16(P) alone, V as loaded, into the same
//     float32 accumulator: the JAX package's blockwise_attention(probs_bf16)
//     arithmetic, one PV pass instead of two (4 D flops a pair on the
//     tensor cores, the function's own count).  l still sums P in float32.
//   * Epilogue: O / l rounded to bf16 (round to nearest even) into the
//     consumer's part of the Q tile in the same swizzled layout, then a
//     TMA store into the head-merged output; rows >= Tq and columns >= D
//     are clipped by the copy, never written.
// Dynamic shared memory, 2 stages: 81 KB (D <= 64), 161 KB (D <= 128),
// 145 KB (D <= 192), 193 KB (D <= 256), 201 KB (D <= 320).

#include <cuda.h>            // CUtensorMap and its enums; the encoder comes
                             // from cudaGetDriverEntryPoint (no -lcuda)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

// --------------------------------------------------------------------------
// bf16: tensor cores (wgmma) fed by a TMA ring
// --------------------------------------------------------------------------
namespace tc {

constexpr int kConsumers = 2;                 // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kStages = 2;                    // K and V ring depth
constexpr int kBox = 64;                      // bf16 columns of one 128-byte swizzled box
constexpr int kRow = 128;                     // bytes of one box row
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kEncodeError = 1000;            // + CUresult of a failed tensor-map encode

struct Maps {
  CUtensorMap q, k, v, o;
};

struct Shape {
  int hq, hkv, tq, tk, causal, window;
  float scale_log2;                           // log2(e) / sqrt(D)
};

// NB 64-column boxes of head dim, BK keys a tile; SPLIT: the consumers
// share 64 query rows and split the O columns
template <int NB, int BK, bool SPLIT>
struct Cfg {
  static constexpr int kBQ = SPLIT ? 64 : 128;           // query rows a CTA
  static constexpr int kBK = BK;
  static constexpr int kQBox = kBQ * kRow;               // bytes of one Q box
  static constexpr int kKVBox = BK * kRow;
  static constexpr int kQBytes = NB * kQBox;
  static constexpr int kKVBytes = NB * kKVBox;
  static constexpr int kOB = SPLIT ? (NB + 1) / 2 : NB;  // O boxes a consumer holds
  static constexpr int kBarOff = kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kSmem = kBarOff + 8 * (1 + 4 * kStages) + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-D tensor map into shared memory; completes on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// returns once at most N of this warpgroup's wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
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

// 2^x (MUFU.EX2; 2^-inf = 0, results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// shared-memory matrix descriptor, 128-byte swizzle (layout type 1);
// offsets in bytes, encoded in 16-byte units
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// D (64 x 64, f32) {=, +}= A (64 x 16, smem) * B (64 x 16, smem), both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
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

// D (64 x 128, f32) {=, +}= A (64 x 16, smem) * B (128 x 16, smem), both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                             int accumulate) {
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

// D (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int BK>
__device__ __forceinline__ void wgmma_ss(float (&d)[BK / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (BK == 128) {
    wgmma_ss_n128(d, da, db, accumulate);
  } else {
    wgmma_ss_n64(d, da, db, accumulate);
  }
}

// barriers: Q full, then per stage K full, V full, K empty, V empty
__device__ __forceinline__ uint32_t k_full(uint32_t bars, int s) { return bars + 8u * (1 + s); }
__device__ __forceinline__ uint32_t v_full(uint32_t bars, int s) {
  return bars + 8u * (1 + kStages + s);
}
__device__ __forceinline__ uint32_t k_empty(uint32_t bars, int s) {
  return bars + 8u * (1 + 2 * kStages + s);
}
__device__ __forceinline__ uint32_t v_empty(uint32_t bars, int s) {
  return bars + 8u * (1 + 3 * kStages + s);
}

// one CTA's tile: shared-memory regions and the key tiles it visits
struct Tile {
  uint32_t sQ, sK, sV, bars;
  int q0, h, b, off, q_first, q_last, kt0, kt1;
};

// A consumer warpgroup: query rows [row_off, row_off + 64) of the tile and
// OB O boxes from box B0.  Tile j's S = Q K^T is issued before tile j-1's
// O += P V, and its softmax runs while that product is in flight.  PB: P
// enters P V as bf16(P) alone (probs_bf16), with no P_lo pass.
template <int NB, int BK, bool SPLIT, int OB, int B0, bool PB>
__device__ __forceinline__ void consume(const Maps& maps, const Shape& p, const Tile& c,
                                        int row_off, int cw) {
  using C = Cfg<NB, BK, SPLIT>;
  constexpr int KS = BK / 16;                          // k16 steps of P V
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int qrow = c.q0 + row_off + 16 * warp + lane / 4;   // row of half 0; half 1: + 8

  float o[OB][32];
#pragma unroll
  for (int x = 0; x < OB; ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[x][i] = 0.f;
  float s[BK / 2];
  uint32_t ph[KS][4], pl[KS][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];

  auto issue_s = [&](int stage) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) {
      const uint32_t qa = c.sQ + (kk / 4) * C::kQBox + row_off * kRow + (kk % 4) * 32;
      const uint32_t ka = c.sK + stage * C::kKVBytes + (kk / 4) * C::kKVBox + (kk % 4) * 32;
      wgmma_ss<BK>(s, desc(qa, 16, 1024), desc(ka, 16, 1024), kk > 0);
    }
    wg_commit();
    keep(s);
  };
  auto issue_pv = [&](int stage) {
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int x = 0; x < OB; ++x) {
        const uint32_t va = c.sV + stage * C::kKVBytes + (B0 + x) * C::kKVBox + kk * 16 * kRow;
        const uint64_t dv = desc(va, C::kKVBox, 1024);
        wgmma_rs_n64(o[x], ph[kk], dv);
        if constexpr (!PB) wgmma_rs_n64(o[x], pl[kk], dv);
      }
    wg_commit();
#pragma unroll
    for (int x = 0; x < OB; ++x) keep(o[x]);
  };
  auto pv_done = [&]() {       // O and the P fragments are free again
#pragma unroll
    for (int x = 0; x < OB; ++x) keep(o[x]);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      keep(ph[kk]);
      if constexpr (!PB) keep(pl[kk]);
    }
  };
  // s: raw scores of the tile at key k0 -> probabilities against the new
  // running max; alpha rescales what O and l hold.  s[i] is row qrow +
  // 8 ((i >> 1) & 1), key k0 + 8 (i >> 2) + 2 (lane & 3) + (i & 1).
  auto softmax = [&](int k0) {
    const bool edge = k0 + BK > p.tk || (p.causal && k0 + BK - 1 > c.q_first) ||
                      (p.window > 0 && k0 <= c.q_last - p.window);
    float mx[2] = {-INFINITY, -INFINITY};
    if (edge) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int qpos = qrow + 8 * ((i >> 1) & 1) + c.off;
        const int kpos = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const bool seen = kpos < p.tk && (!p.causal || kpos <= qpos) &&
                          (p.window <= 0 || kpos > qpos - p.window);
        s[i] = seen ? s[i] : -INFINITY;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
    float mref[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh] * p.scale_log2);
      mref[hh] = m_new == -INFINITY ? 0.f : m_new;     // no key seen yet
      alpha[hh] = ex2(m[hh] - mref[hh]);               // 0 while m = -inf
      m[hh] = m_new;
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int hh = (i >> 1) & 1;
      const float e = ex2(fmaf(s[i], p.scale_log2, -mref[hh]));
      s[i] = edge && s[i] == -INFINITY ? 0.f : e;     // a masked key: p = 0 outright
      rs[hh] += s[i];
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + rs[hh];   // this thread's part
  };
  // P = P_hi + P_lo as A fragments (PB: P_hi alone): k16 step kk holds
  // s[8 kk .. 8 kk + 7]
  auto split_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x0 = s[8 * kk + 2 * j], x1 = s[8 * kk + 2 * j + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        ph[kk][j] = bits(hi);
        if constexpr (!PB) {
          const float2 hf = __bfloat1622float2(hi);
          pl[kk][j] = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
        }
      }
  };

  bar_wait(c.bars, 0);                                 // Q
  int stage = 0, pv_stage = 0;
  uint32_t phase = 0, pv_phase = 0;
  for (int kt = c.kt0; kt < c.kt1; ++kt) {
    bar_wait(k_full(c.bars, stage), phase);
    issue_s(stage);
    if (kt > c.kt0) {
      bar_wait(v_full(c.bars, pv_stage), pv_phase);
      issue_pv(pv_stage);
      wg_wait<1>();                                    // S is done, P V may run on
    } else {
      wg_wait<0>();
    }
    keep(s);
    if (t == 0) bar_arrive(k_empty(c.bars, stage));
    softmax(kt * BK);
    if (kt > c.kt0) {
      wg_wait<0>();
      pv_done();
      if (t == 0) bar_arrive(v_empty(c.bars, pv_stage));
#pragma unroll
      for (int x = 0; x < OB; ++x)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[x][i] *= alpha[(i >> 1) & 1];
    }
    split_p();
    pv_stage = stage;
    pv_phase = phase;
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  if (c.kt1 > c.kt0) {
    bar_wait(v_full(c.bars, pv_stage), pv_phase);
    issue_pv(pv_stage);
    wg_wait<0>();
    pv_done();
    if (t == 0) bar_arrive(v_empty(c.bars, pv_stage));
  }

  // epilogue: O / l in bf16 through the Q tile, then a TMA store
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    inv[hh] = 1.f / fmaxf(l[hh], 1e-30f);
  }
  if (SPLIT) named_sync(1, 128 * kConsumers);   // both are done reading the shared Q rows
#pragma unroll
  for (int x = 0; x < OB; ++x)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int rq = row_off + 16 * warp + lane / 4 + 8 * hh;   // row in the tile
        const uint32_t addr = c.sQ + (B0 + x) * C::kQBox + rq * kRow +
                              ((j ^ (rq & 7)) << 4) + (lane & 3) * 4;
        st_shared(addr, bits(__floats2bfloat162_rn(o[x][4 * j + 2 * hh] * inv[hh],
                                                   o[x][4 * j + 2 * hh + 1] * inv[hh])));
      }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  named_sync(2 + cw, 128);
  if (t == 0 && c.q0 + row_off < p.tq) {
#pragma unroll
    for (int x = 0; x < OB; ++x)
      tma_store(&maps.o, c.sQ + (B0 + x) * C::kQBox + row_off * kRow, (B0 + x) * kBox,
                c.q0 + row_off, c.h, c.b);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

template <int NB, int BK, bool SPLIT, bool PB>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ Maps maps, const Shape p) {
  using C = Cfg<NB, BK, SPLIT>;
  extern __shared__ uint8_t smem_raw[];
  Tile c;
  c.sQ = (smem_addr(smem_raw) + 1023u) & ~1023u;    // swizzle atoms: 1024 B
  c.sK = c.sQ + C::kQBytes;                         // kStages x kKVBytes
  c.sV = c.sK + kStages * C::kKVBytes;
  c.bars = c.sQ + C::kBarOff;
  const int qt = gridDim.x - 1 - blockIdx.x;        // the heaviest (last) tiles first
  c.h = blockIdx.y;
  c.b = blockIdx.z;
  c.q0 = qt * C::kBQ;
  c.off = p.tk - p.tq;
  // the key tiles this query tile can see
  c.q_first = c.q0 + c.off;
  c.q_last = min(c.q0 + C::kBQ, p.tq) - 1 + c.off;
  const int khi = p.causal ? min(p.tk, c.q_last + 1) : p.tk;
  const int klo = p.window > 0 ? max(0, c.q_first - p.window + 1) : 0;
  c.kt0 = klo / BK;
  c.kt1 = (khi + BK - 1) / BK;

  const int tid = threadIdx.x;
  if (tid == 0) {
    bar_init(c.bars, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(k_full(c.bars, s), 1);
      bar_init(v_full(c.bars, s), 1);
      bar_init(k_empty(c.bars, s), kConsumers);
      bar_init(v_empty(c.bars, s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid == 0) {
      const int hk = c.h / (p.hq / p.hkv);
      bar_expect_tx(c.bars, C::kQBytes);
      for (int j = 0; j < NB; ++j)
        tma_load(c.sQ + j * C::kQBox, &maps.q, c.bars, j * kBox, c.q0, c.h, c.b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = c.kt0; kt < c.kt1; ++kt) {
        const uint32_t kdst = c.sK + stage * C::kKVBytes, vdst = c.sV + stage * C::kKVBytes;
        bar_wait(k_empty(c.bars, stage), phase ^ 1);
        bar_expect_tx(k_full(c.bars, stage), C::kKVBytes);
        for (int j = 0; j < NB; ++j)
          tma_load(kdst + j * C::kKVBox, &maps.k, k_full(c.bars, stage), j * kBox, kt * BK, hk,
                   c.b);
        bar_wait(v_empty(c.bars, stage), phase ^ 1);
        bar_expect_tx(v_full(c.bars, stage), C::kKVBytes);
        for (int j = 0; j < NB; ++j)
          tma_load(vdst + j * C::kKVBox, &maps.v, v_full(c.bars, stage), j * kBox, kt * BK, hk,
                   c.b);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: S = Q K^T, online softmax, O += P V ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int cw = tid / 128 - 1;                     // consumer 0 or 1
    if constexpr (!SPLIT) {
      consume<NB, BK, SPLIT, NB, 0, PB>(maps, p, c, 64 * cw, cw);
    } else if (cw == 0) {
      consume<NB, BK, SPLIT, C::kOB, 0, PB>(maps, p, c, 0, cw);
    } else {
      consume<NB, BK, SPLIT, NB - C::kOB, C::kOB, PB>(maps, p, c, 0, cw);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)ptr;
  }
  return fn;
}

// a (B, H, T, D) bf16 view as the 4-D map (D, T, H, B): element strides of
// t, h, b; boxes of 64 columns x rows
int encode(CUtensorMap* map, const void* ptr, int d, int t, int h, int b, long long st,
           long long sh, long long sb, int rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)h, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)st * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

struct Args {
  const void *q, *k, *v;
  void* o;
  long long qs[3], ks[3], vs[3], os[3];   // element strides of dims b, h, t
  int batch, dt;                          // dt: the head dim the maps cover
  int probs_bf16;
  Shape shape;
};

constexpr int kWidths = 5;                // instances of one flag value

// width w (head dims up to 64 (w + 1)) with flag PB: f(its Cfg, its kernel)
template <bool PB, typename F>
int with_width(int w, F&& f) {
  switch (w) {
    case 0: return f(Cfg<1, 128, false>{}, flash_fwd_wgmma<1, 128, false, PB>);
    case 1: return f(Cfg<2, 128, false>{}, flash_fwd_wgmma<2, 128, false, PB>);
    case 2: return f(Cfg<3, 64, false>{}, flash_fwd_wgmma<3, 64, false, PB>);
    case 3: return f(Cfg<4, 64, false>{}, flash_fwd_wgmma<4, 64, false, PB>);
    case 4: return f(Cfg<5, 64, true>{}, flash_fwd_wgmma<5, 64, true, PB>);
  }
  return (int)cudaErrorInvalidValue;
}

// instance i: width i % kWidths, probs_bf16 from i >= kWidths
template <typename F>
int with_instance(int i, F&& f) {
  return i < kWidths ? with_width<false>(i, f) : with_width<true>(i - kWidths, f);
}

// launch the instance that takes the call; *instance: its index (-1: none)
int dispatch(const Args& a, int* instance, cudaStream_t stream) {
  const int w = (a.dt + kBox - 1) / kBox - 1;
  *instance = w < 0 || w >= kWidths ? -1 : w + kWidths * (a.probs_bf16 != 0);
  return with_instance(*instance, [&](auto cfg, auto kernel) {
    using C = decltype(cfg);
    const Shape& p = a.shape;
    Maps maps;
    int rc = encode(&maps.q, a.q, a.dt, p.tq, p.hq, a.batch, a.qs[2], a.qs[1], a.qs[0], C::kBQ);
    if (rc == 0)
      rc = encode(&maps.k, a.k, a.dt, p.tk, p.hkv, a.batch, a.ks[2], a.ks[1], a.ks[0], C::kBK);
    if (rc == 0)
      rc = encode(&maps.v, a.v, a.dt, p.tk, p.hkv, a.batch, a.vs[2], a.vs[1], a.vs[0], C::kBK);
    if (rc == 0)
      rc = encode(&maps.o, a.o, a.dt, p.tq, p.hq, a.batch, a.os[2], a.os[1], a.os[0], 64);
    if (rc != 0) return rc;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((p.tq + C::kBQ - 1) / C::kBQ, p.hq, a.batch);
    kernel<<<grid, kThreads, C::kSmem, stream>>>(maps, p);
    return (int)cudaGetLastError();
  });
}

}  // namespace tc


// --------------------------------------------------------------------------
// float32: 3xTF32 on the tensor cores (flash_fwd_tf32)
// --------------------------------------------------------------------------
// The same function in float32: logits, probabilities and the output to
// float32 accuracy (atol = rtol = 3e-5 against the plain version).
//
// Bound: operations.  A kept (query, key) pair costs 4 D flops; at the
// kernel-phase call (2, 16, 4, 777, 777, 128) causal that is 4.95 GFLOP,
// 0.074 ms on the CUDA cores at 67 TFLOP/s.  The tensor cores take TF32,
// which keeps 11 bits of a float32: one TF32 pass misses the gate by
// ~30x.  So each operand x is split into hi (x rounded to TF32) and lo =
// x - hi, and every product is taken as lo*hi + hi*lo + hi*hi into one
// float32 accumulator (CUTLASS's 3xTF32): the dropped lo*lo and the
// roundings leave about 2^-20 of each product, far inside the gate.  Three
// TF32 passes at 495 TFLOP/s bound the call at 0.030 ms.
//
// Design of flash_fwd_tf32.  One CTA covers one (batch, query head,
// 64-query tile); the grid is one dimension, ordered so that the
// heaviest query tiles of every (batch, head) start first.  Four warps
// each own 16 query rows; at D > 192 (SPLIT) eight warps, two on each 16
// rows, each holding half of O's columns and computing S itself.
//   * mma.sync.m16n8k8 tf32 with the operands split in registers, so
//     shared memory holds raw float32 tiles: no hi/lo planes, no
//     transposed copy of V (wgmma's tf32 form takes only K-major
//     operands; V lands MN-major).  At D = 128 a wgmma design with hi/lo
//     planes of Q, K and V (64 KB each at 64 rows) and a ring would not
//     fit two consumer warpgroups in 227 KB.
//   * The split: hi = (bits(x) + 0x1000) & ~0x1FFF rounds to nearest,
//     ties away from zero (what cvt.rna.tf32.f32 does in four SASS
//     instructions, here in two), lo = x - hi exactly, passed whole: the
//     tensor cores read a .tf32 operand's top 19 bits.
//   * Each 3xTF32 product runs one pass per term over all the warp's
//     accumulators (never two mmas in a row on one accumulator), and S's
//     head-dim loop is unrolled at the instance's width.
//   * Shared memory holds the Q tile and one K and one V tile, filled by
//     16-byte cp.async copies (the wrapper hands over 16-byte aligned rows
//     of dt = D rounded up to 4 columns; rows past Tq / Tk zero-filled,
//     columns past dt zeroed once).  V's copy runs under S = Q K^T and the softmax,
//     the next K's under O += P V.  D = 128: 105 KB, two CTAs an SM.
//   * S = Q K^T: the head dim is walked in an order that gives lane t (=
//     lane % 4) columns 4t .. 4t + 3 of each 16 for both operands (two
//     8-column mma steps), so its A and B values are neighbours: one
//     128-bit load each, conflict-free at a row pitch of 16 mod 32 floats.
//   * O += P V: P is the S accumulator itself, read with the keys of each
//     8-key step in the same order (2t, 2t+1), so the accumulator is the A
//     fragment with no shuffle; V is read at those two keys' rows (pitch
//     DP + 4: conflict-free 32-bit loads).
//   * Softmax as the bf16 route: c = log2(e)/sqrt(D) folded into p =
//     2^(s c - m) (one FMA, one MUFU.EX2), the per-element mask only on
//     the tiles that the diagonal, the window edge or Tk cuts, key tiles
//     visited only where the mask leaves them non-empty, m_ref = 0 while a
//     row has seen no key, l >= 1e-30.
//   * probs_bf16 (a compile-time flag, instances of their own): P and V
//     are rounded to bf16 (to nearest even) and O += P V takes one TF32
//     pass: a bf16 value is a TF32 value, so the products are exact and
//     only the float32 accumulation rounds, as in the JAX package's
//     blockwise_attention(probs_bf16).  S = Q K^T stays 3xTF32 and l sums
//     P in float32.  (Rounding before the usual split gives the same sums,
//     lo = 0, but runs the two zero passes: 20% slower on an H100 at the
//     kernel-phase call, scripts/torch_flash_ab.py.)
namespace f32 {

constexpr int kBQ = 64;   // query rows a CTA, 16 a warp

struct Params {
  const float *q, *k, *v;
  float* o;
  long long qs[3], ks[3], vs[3], os[3];   // element strides of dims b, h, t
  int batch, hq, hkv, tq, tk, dt, d, causal, window;   // dt: columns read (d % 4 padded)
  int probs_bf16;
  float scale_log2;                       // log2(e) / sqrt(D)
};

// DP: the widest head dim (a multiple of 16); BK keys a tile; SPLIT: two
// warps on each 16 rows, each with half of O's columns; PB: probs_bf16
template <int DP, int BK, bool SPLIT, bool PB>
struct Cfg {
  static constexpr int kDP = DP;
  static constexpr int kBK = BK;
  static constexpr bool kSplit = SPLIT;
  static constexpr bool kProbsBf16 = PB;
  static constexpr int kThreads = SPLIT ? 256 : 128;
  static constexpr int kLdK = DP + (DP % 32 ? 32 : 16);   // Q and K rows (floats)
  static constexpr int kLdV = DP + 4;   // V rows
  static constexpr int kNJ = (SPLIT ? DP / 2 : DP) / 8;   // O column blocks a warp holds
  static constexpr int kSmem = ((kBQ + BK) * kLdK + BK * kLdV) * 4;
};

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away from zero,
// as cvt.rna.tf32.f32, whose SASS takes four instructions; here an add
// and a mask), lo = x - hi exactly, passed whole: the tensor cores read
// the top 19 bits of a .tf32 operand, so lo is truncated to TF32 there
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// D (16 x 8, f32) += A (16 x 8, tf32, row) * B (8 x 8, tf32, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32 into N accumulators, one pass over them per term (the small
// terms first), so that back-to-back mmas never share an accumulator
// (accumulators d[n0] .. d[n0 + N - 1])
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

// x rounded to bf16 (to nearest even), as the bits of a float32: exact in TF32
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x)) << 16;
}

__device__ __forceinline__ void split4(float x0, float x1, float x2, float x3,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(x0, hi[0], lo[0]);
  split(x1, hi[1], lo[1]);
  split(x2, hi[2], lo[2]);
  split(x3, hi[3], lo[3]);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// rows [r0, r0 + rows) of a (T, dt) slice at row stride rs into dst (row
// pitch ld floats), columns [0, dt) in 16-byte copies (dt % 4 == 0, rows
// 16-byte aligned); rows at or past n are zero-filled.  Thread i copies
// pieces i, i + NT, ...: (row, column) steps by NT without a divide
template <int NT>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src, long long rs,
                                          int r0, int rows, int n, int dt) {
  const uint32_t base = tc::smem_addr(dst);
  const int per_row = dt / 4, step_r = NT / per_row, step_c = 4 * (NT % per_row);
  int r = threadIdx.x / per_row, col = 4 * (threadIdx.x % per_row);
  for (; r < rows; r += step_r) {
    const bool in = r0 + r < n;
    cp_async16(base + 4u * (r * ld + col), in ? src + (r0 + r) * rs + col : src, in ? 16 : 0);
    col += step_c;
    if (col >= dt) {
      col -= dt;
      ++r;
    }
  }
}

// min blocks 1: registers up to 255, never traded for spills to reach an
// occupancy step
template <typename C>
__global__ void __launch_bounds__(C::kThreads, 1) flash_fwd_tf32(const Params p) {
  constexpr int DP = C::kDP, BK = C::kBK, NB = BK / 8, NJ = C::kNJ, NT = C::kThreads;
  constexpr int CH = NJ % 4 == 0 ? 4 : NJ;         // O column blocks an mma3 step takes
  constexpr int LK = C::kLdK, LV = C::kLdV;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);    // kBQ x LK
  float* Ks = Qs + kBQ * LK;                       // BK x LK
  float* Vs = Ks + BK * LK;                        // BK x LV

  // the heaviest (last) query tiles of every (batch, head) first
  const int nq = (p.tq + kBQ - 1) / kBQ, per = p.hq * p.batch;
  const int qt = nq - 1 - (int)(blockIdx.x / per), hb = (int)(blockIdx.x % per);
  const int h = hb % p.hq, b = hb / p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int q0 = qt * kBQ, off = p.tk - p.tq;
  const int q_first = q0 + off, q_last = min(q0 + kBQ, p.tq) - 1 + off;
  const int khi = p.causal ? min(p.tk, q_last + 1) : p.tk;
  const int klo = p.window > 0 ? max(0, q_first - p.window + 1) : 0;
  const int kt0 = klo / BK, kt1 = (khi + BK - 1) / BK;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3);                          // the warp's rows in the tile
  const int c0 = (C::kSplit ? DP / 2 : 0) * (warp >> 2);  // its first O column

  const float* qg = p.q + b * p.qs[0] + h * p.qs[1] + (long long)q0 * p.qs[2];
  const float* kg = p.k + b * p.ks[0] + hk * p.ks[1];
  const float* vg = p.v + b * p.vs[0] + hk * p.vs[1];

  // columns [dt, DP) stay zero: cp.async writes only [0, dt)
  for (int i = threadIdx.x; i < (kBQ + 2 * BK) * (DP - p.dt); i += NT) {
    const int r = i / (DP - p.dt), col = p.dt + i % (DP - p.dt);
    if (r < kBQ + BK)
      Qs[r * LK + col] = 0.f;                       // Q, then K (adjacent, same pitch)
    else
      Vs[(r - kBQ - BK) * LV + col] = 0.f;
  }
  load_tile<NT>(Qs, LK, qg, p.qs[2], 0, kBQ, p.tq - q0, p.dt);
  load_tile<NT>(Ks, LK, kg, p.ks[2], kt0 * BK, BK, p.tk, p.dt);
  cp_commit();

  float o[NJ][4];
#pragma unroll
  for (int n = 0; n < NJ; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float* qa = Qs + (r0 + g) * LK + 4 * t;
  const float* kb = Ks + g * LK + 4 * t;
  const float* vb = Vs + 2 * t * LV + c0 + g;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    cp_wait_all();
    __syncthreads();                               // K (and Q) landed; V is free
    load_tile<NT>(Vs, LV, vg, p.vs[2], k0, BK, p.tk, p.dt);
    cp_commit();

    // S = Q K^T; s[n][i]: row r0 + g + 8 (i >> 1), key k0 + 8 n + 2 t + (i & 1)
    float s[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
    for (int k2 = 0; k2 < DP / 16; ++k2) {         // columns past d are zero
      const float4 x0 = *reinterpret_cast<const float4*>(qa + 16 * k2);
      const float4 x1 = *reinterpret_cast<const float4*>(qa + 8 * LK + 16 * k2);
      float4 y[NB];
#pragma unroll
      for (int n = 0; n < NB; ++n) y[n] = *reinterpret_cast<const float4*>(kb + 8 * n * LK + 16 * k2);
#pragma unroll
      for (int half = 0; half < 2; ++half) {       // 8-column steps 2 k2 and 2 k2 + 1
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
        mma3(s, 0, ah, al, bh, bl);
      }
    }

    // online softmax; the 4 lanes of a quad share a row
    const bool edge = k0 + BK > p.tk || (p.causal && k0 + BK - 1 > q_first) ||
                      (p.window > 0 && k0 <= q_last - p.window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (edge) {
          const int qpos = q0 + r0 + g + 8 * (i >> 1) + off;
          const int kpos = k0 + 8 * n + 2 * t + (i & 1);
          const bool seen = kpos < p.tk && (!p.causal || kpos <= qpos) &&
                            (p.window <= 0 || kpos > qpos - p.window);
          s[n][i] = seen ? s[n][i] : -INFINITY;
        }
        mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
      }
    float mref[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh] * p.scale_log2);
      mref[hh] = m_new == -INFINITY ? 0.f : m_new;   // no key seen yet
      alpha[hh] = tc::ex2(m[hh] - mref[hh]);         // 0 while m = -inf
      m[hh] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = tc::ex2(fmaf(s[n][i], p.scale_log2, -mref[i >> 1]));
        s[n][i] = edge && s[n][i] == -INFINITY ? 0.f : e;   // a masked key: p = 0 outright
        rs[i >> 1] += s[n][i];
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + rs[hh];   // this lane's part
#pragma unroll
    for (int n = 0; n < NJ; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] *= alpha[i >> 1];

    cp_wait_all();
    __syncthreads();                               // V landed; K is free
    if (kt + 1 < kt1) {
      load_tile<NT>(Ks, LK, kg, p.ks[2], k0 + BK, BK, p.tk, p.dt);
      cp_commit();
    }

    // O += P V: 8-key step kk is S block kk, its keys in the order 2t, 2t+1;
    // V's column blocks CH at a time (columns past dt read V's zero pad)
#pragma unroll
    for (int kk = 0; kk < NB; ++kk) {
      if constexpr (C::kProbsBf16) {     // bf16(P) bf16(V), one exact TF32 pass
        const uint32_t a[4] = {bf16_bits(s[kk][0]), bf16_bits(s[kk][2]), bf16_bits(s[kk][1]),
                               bf16_bits(s[kk][3])};
#pragma unroll
        for (int n0 = 0; n0 < NJ; n0 += CH) {
          if (c0 + 8 * n0 < p.dt) {       // CH blocks' loads first, then their mmas
            uint32_t b[CH][2];
#pragma unroll
            for (int j = 0; j < CH; ++j) {
              const float* vp = vb + 8 * kk * LV + 8 * (n0 + j);
              b[j][0] = bf16_bits(vp[0]);
              b[j][1] = bf16_bits(vp[LV]);
            }
#pragma unroll
            for (int j = 0; j < CH; ++j) mma(o[n0 + j], a, b[j][0], b[j][1]);
          }
        }
      } else {
        uint32_t ah[4], al[4];
        split4(s[kk][0], s[kk][2], s[kk][1], s[kk][3], ah, al);
#pragma unroll
        for (int n0 = 0; n0 < NJ; n0 += CH) {
          if (c0 + 8 * n0 < p.dt) {
            uint32_t bh[CH][2], bl[CH][2];
#pragma unroll
            for (int j = 0; j < CH; ++j) {
              const float* vp = vb + 8 * kk * LV + 8 * (n0 + j);
              split(vp[0], bh[j][0], bl[j][0]);
              split(vp[LV], bh[j][1], bl[j][1]);
            }
            mma3(o, n0, ah, al, bh, bl);
          }
        }
      }
    }
  }

  // epilogue: O / l
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    inv[hh] = 1.f / fmaxf(l[hh], 1e-30f);
  }
  float* og = p.o + b * p.os[0] + h * p.os[1];
#pragma unroll
  for (int n = 0; n < NJ; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + r0 + g + 8 * (i >> 1), col = c0 + 8 * n + 2 * t + (i & 1);
      if (row < p.tq && col < p.d) og[row * p.os[2] + col] = o[n][i] * inv[i >> 1];
    }
}

constexpr int kWidths = 7;   // instances of one flag value

// width w with flag PB: f(its Cfg, its kernel); head dims up to 16, 32,
// 64, 128, 192, 256, 320 (past the last, cudaErrorInvalidValue)
template <bool PB, typename F>
int with_width(int w, F&& f) {
  switch (w) {
    case 0: return f(Cfg<16, 64, false, PB>{}, flash_fwd_tf32<Cfg<16, 64, false, PB>>);
    case 1: return f(Cfg<32, 64, false, PB>{}, flash_fwd_tf32<Cfg<32, 64, false, PB>>);
    case 2: return f(Cfg<64, 64, false, PB>{}, flash_fwd_tf32<Cfg<64, 64, false, PB>>);
    case 3: return f(Cfg<128, 64, false, PB>{}, flash_fwd_tf32<Cfg<128, 64, false, PB>>);
    case 4: return f(Cfg<192, 32, false, PB>{}, flash_fwd_tf32<Cfg<192, 32, false, PB>>);
    case 5: return f(Cfg<256, 32, true, PB>{}, flash_fwd_tf32<Cfg<256, 32, true, PB>>);
    case 6: return f(Cfg<320, 32, true, PB>{}, flash_fwd_tf32<Cfg<320, 32, true, PB>>);
  }
  return (int)cudaErrorInvalidValue;
}

// instance i: width i % kWidths, probs_bf16 from i >= kWidths
template <typename F>
int with_instance(int i, F&& f) {
  return i < kWidths ? with_width<false>(i, f) : with_width<true>(i - kWidths, f);
}

// the first width that takes head dim d (-1: none)
int width_of(int d) {
  int dp = 0;
  const auto widest = [&](auto cfg, auto) {
    dp = decltype(cfg)::kDP;
    return 0;
  };
  for (int w = 0; with_width<false>(w, widest) == 0; ++w)
    if (d <= dp) return w;
  return -1;
}

// launch the instance that takes the call; *instance: its index (-1: none)
int dispatch(const Params& p, int* instance, cudaStream_t stream) {
  const int w = width_of(p.d);
  *instance = w < 0 ? -1 : w + kWidths * (p.probs_bf16 != 0);
  return with_instance(*instance, [&](auto cfg, auto kernel) {
    using C = decltype(cfg);
    const long long blocks = (long long)((p.tq + kBQ - 1) / kBQ) * p.hq * p.batch;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)blocks, C::kThreads, C::kSmem, stream>>>(p);
    return (int)cudaGetLastError();
  });
}

}  // namespace f32


extern "C" {

const char* kernel_error_string(int code) {
  if (code >= tc::kEncodeError) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString((cudaError_t)code);
}

// The bf16 route.  q (B, Hq, Tq, dt), k/v (B, Hkv, Tk, dt), o (B, Hq, Tq,
// dt): element strides of dims b, h, t, the last dim contiguous; 16-byte
// aligned base pointers and strides (TMA); 1 <= d <= dt <= 320 with
// columns d..dt zero (d sets the scale), Hq % Hkv == 0, Tk >= 1, and
// Tq <= Tk when causal (the wrapper checks).  *instance: the index of the
// instance launched, as flash_attention_bf16_instance numbers them (-1: none).
int flash_attention_bf16_launch(const void* q, const void* k, const void* v, void* o,
                                long long qsb, long long qsh, long long qst,
                                long long ksb, long long ksh, long long kst,
                                long long vsb, long long vsh, long long vst,
                                long long osb, long long osh, long long ost,
                                int batch, int hq, int hkv, int tq, int tk, int dt, int d,
                                int causal, int window, int probs_bf16, int* instance,
                                void* stream) {
  *instance = -1;
  if (batch == 0 || hq == 0 || tq == 0) return (int)cudaGetLastError();
  tc::Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  const long long strides[4][3] = {{qsb, qsh, qst}, {ksb, ksh, kst}, {vsb, vsh, vst},
                                   {osb, osh, ost}};
  long long* dst[4] = {a.qs, a.ks, a.vs, a.os};
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[i][j];
  a.batch = batch;
  a.dt = dt;
  a.probs_bf16 = probs_bf16;
  a.shape.hq = hq;
  a.shape.hkv = hkv;
  a.shape.tq = tq;
  a.shape.tk = tk;
  a.shape.causal = causal;
  a.shape.window = window;
  a.shape.scale_log2 = (float)(1.4426950408889634 / sqrt((double)d));
  return tc::dispatch(a, instance, (cudaStream_t)stream);
}

// Instance i of the bf16 route (i < 10): the widest head dim it takes, its
// probs_bf16 flag, its registers a thread at launch, local (spill) bytes and
// dynamic shared memory.
int flash_attention_bf16_instance(int i, int* max_d, int* probs_bf16, int* regs,
                                  int* local_bytes, int* smem) {
  return tc::with_instance(i, [&](auto cfg, auto kern) {
    using C = decltype(cfg);
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kern);
    if (err != cudaSuccess) return (int)err;
    *max_d = (i % tc::kWidths + 1) * tc::kBox;
    *probs_bf16 = i >= tc::kWidths;
    *regs = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    *smem = C::kSmem;
    return 0;
  });
}

// The float32 route (flash_fwd_tf32).  q, k, v as above with 16-byte
// aligned rows: 16-byte aligned bases, row, head and batch strides that
// are multiples of 4 elements, 1 <= d <= dt <= 320, dt % 4 == 0, columns
// d..dt zero; o (B, Hq, Tq, d) at its own strides; *instance as above.
int flash_attention_f32_launch(const void* q, const void* k, const void* v, void* o,
                               long long qsb, long long qsh, long long qst,
                               long long ksb, long long ksh, long long kst,
                               long long vsb, long long vsh, long long vst,
                               long long osb, long long osh, long long ost,
                               int batch, int hq, int hkv, int tq, int tk, int dt, int d,
                               int causal, int window, int probs_bf16, int* instance,
                               void* stream) {
  *instance = -1;
  if (batch == 0 || hq == 0 || tq == 0) return (int)cudaGetLastError();
  f32::Params p;
  p.q = (const float*)q;
  p.k = (const float*)k;
  p.v = (const float*)v;
  p.o = (float*)o;
  const long long strides[4][3] = {{qsb, qsh, qst}, {ksb, ksh, kst}, {vsb, vsh, vst},
                                   {osb, osh, ost}};
  long long* dst[4] = {p.qs, p.ks, p.vs, p.os};
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[i][j];
  p.batch = batch;
  p.hq = hq;
  p.hkv = hkv;
  p.tq = tq;
  p.tk = tk;
  p.dt = dt;
  p.d = d;
  p.causal = causal;
  p.window = window;
  p.probs_bf16 = probs_bf16;
  p.scale_log2 = (float)(1.4426950408889634 / sqrt((double)d));
  return f32::dispatch(p, instance, (cudaStream_t)stream);
}

// Instance i of the float32 route, as flash_attention_bf16_instance
// (cudaErrorInvalidValue past the last).
int flash_attention_f32_instance(int i, int* max_d, int* probs_bf16, int* regs,
                                 int* local_bytes, int* smem) {
  return f32::with_instance(i, [&](auto cfg, auto kern) {
    using C = decltype(cfg);
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kern);
    if (err != cudaSuccess) return (int)err;
    *max_d = C::kDP;
    *probs_bf16 = C::kProbsBf16;
    *regs = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    *smem = C::kSmem;
    return 0;
  });
}

}  // extern "C"
