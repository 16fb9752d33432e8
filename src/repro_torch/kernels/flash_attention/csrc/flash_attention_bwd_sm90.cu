// Flash attention, backward, on the Hopper tensor cores (sm_90a).
//
// The route of flash_attention_bwd that route(..., backward=True) in
// kernel.py sends bf16 at head dims (Dk, Dv) = (128, 128) to; everything
// else goes to flash_attention_bwd.cu (SIMT).  It is the gradient of what
// the forward computes (flash_attention_fwd; the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py :: flash_attention_kernel
// has no backward: on the TPU jax.grad differentiates the plain chunked
// attention): same masks (causal, sliding window, kv_len, q_offset), query
// head h reads kv head h / (H / KH), scale 1 / sqrt(D).  With each row's
// lse from the forward and delta = rowsum(dout * o) from the shared pre-pass
// (flash_attention_bwd_delta, flash_attention_bwd.cu):
//   P = exp(S scale - lse) under the masks, dP = dout V^T,
//   dS = P (dP - delta), dV = P^T dout, dK = scale dS^T Q, dQ = scale dS K;
// a row that sees no key has P = 0 (its lse is 0 and never matters).
// Layout: q, dq (B, Sq, H, 128); k, v, dk, dv (B, Sk, KH, 128); dout
// (B, Sq, H, 128), bf16, contiguous; lse and delta (B, H, Sq) f32 with rows
// ld elements apart, ld a multiple of 4.
//
// What bounds it.  At qwen3-1.7b's train shape (q 8x1024x16x128, k/v
// 8x1024x8x128, causal) the gradient needs five products over 6.7e7 visible
// pairs, 8.6e10 FLOP, against 0.2 GB of inputs and outputs: it is bound by
// operations, 0.087 ms at 989 TFLOP/s bf16.  So every product runs as
// wgmma, bf16 operands and f32 accumulators; P and dS are rounded to bf16
// for their products, as the forward rounds P.
//
// Design.  Two kernels after the delta pre-pass, each a block of three
// warpgroups: warpgroup 0 the producer (24 registers; one thread issues
// every TMA copy into a three-stage ring on mbarriers: full, the bytes
// arrived; empty, all 256 consumer threads are done), warpgroups 1 and 2 the
// consumers (240 registers), each owning 64 rows of the block's tile.
//   attn_bwd_dkdv_wgmma: a block owns 128 kv rows of one kv head (K and V
//     loaded once) and walks, for each query head of the GQA group, the
//     64-row q steps that see the tile (Q, dout and their lse and delta rows
//     by TMA).  A consumer computes S^T = K Q^T (its 64 kv rows x 64 q rows,
//     m64n64k16 from shared memory), then dP^T = V dout^T while it forms P^T
//     on S^T's register fragments, then dS^T, then dV += P^T dout and
//     dK += dS^T Q (m64n128k16, P^T and dS^T from registers, dout and Q
//     through the descriptor's transpose bit).  dK and dV (128 f32 registers
//     a thread) are summed over the group in registers and written once: no
//     atomics.
//   attn_bwd_dq_wgmma: a block owns 128 q rows of one head (Q and dout
//     loaded once) and walks the visible 64-row kv tiles; a consumer
//     recomputes S = Q K^T and dP = dout V^T (its 64 q rows), P while dP
//     runs, then dS, then dQ += dS K (K through the transpose bit).  (Issuing
//     a tile's dQ together with the next tile's S and dP was no faster on
//     the card.)
// Seven products where five would do, for no atomics: every sum runs in a
// fixed order, so the result is the same bit for bit on every run.  A
// consumer skips the products of a step none of whose pairs it can see; the
// masks are applied element by element only on steps that some pair of
// which is hidden.  Blocks run heaviest first under causal: kv tile 0 for
// dK/dV, the last q tile for dQ.  Shared memory: dK/dV 64 KB of K and V + 3
// stages x 32.5 KB; dQ 64 KB of Q and dout + 3 stages x 32 KB.

#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 384;   // three warpgroups: producer, two consumers
constexpr int kD = 128;         // Dk = Dv
constexpr int kStages = 3;
constexpr int kBKV = 128;       // dK/dV: kv rows of a block, 64 a consumer
constexpr int kBQ = 64;         //   query rows a step
constexpr int kQRows = 128;     // dQ: query rows of a block, 64 a consumer
constexpr int kKRows = 64;      //   kv rows a step
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  const float* lse;    // (B, H, Sq), rows ld apart
  const float* delta;  // (B, H, Sq), rows ld apart
  int ld;
  int B, Sq, Sk, H, KH;
  int causal;
  int window;      // <= 0: no sliding window
  int q_offset;    // absolute position of q row 0
  int kv_len;      // keys at and beyond kv_len are masked; <= Sk
  float scale;     // 1 / sqrt(D)
};

__device__ __forceinline__ bool visible(const Args& a, int qpos, int kpos) {
  bool vis = kpos < a.kv_len;
  if (a.causal) vis = vis && kpos <= qpos;
  if (a.window > 0) vis = vis && kpos > qpos - a.window;
  return vis;
}

// Shared memory of a dK/dV block, in bytes from a 1024-byte aligned base: K
// and V as 2 chunks of 128 rows x 128 bytes; per stage Q and dout as 2
// chunks of 64 rows, then lse and delta (64 floats each); then the
// mbarriers.
struct DkdvSmem {
  static constexpr int kKV = kBKV * kD * 2;
  static constexpr int kQ = kBQ * kD * 2;
  static constexpr int kRow = kBQ * 4;
  static constexpr int kVOff = kKV;
  static constexpr int kQOff = 2 * kKV;
  static constexpr int kDoOff = kQOff + kStages * kQ;
  static constexpr int kLseOff = kDoOff + kStages * kQ;
  static constexpr int kDeltaOff = kLseOff + kStages * kRow;
  static constexpr int kBarOff = kDeltaOff + kStages * kRow;
  static constexpr int kBars = 1 + 2 * kStages;  // kv, full[], empty[]
  static constexpr int kBytes = kBarOff + 8 * kBars + 1024;  // + room to align the base
  static constexpr int kStageBytes = 2 * kQ + 2 * kRow;
};

// Shared memory of a dQ block: Q and dout as 2 chunks of 128 rows x 128
// bytes; per stage K and V as 2 chunks of 64 rows; then the mbarriers.
struct DqSmem {
  static constexpr int kQ = kQRows * kD * 2;
  static constexpr int kK = kKRows * kD * 2;
  static constexpr int kDoOff = kQ;
  static constexpr int kKOff = 2 * kQ;
  static constexpr int kVOff = kKOff + kStages * kK;
  static constexpr int kBarOff = kVOff + kStages * kK;
  static constexpr int kBars = 1 + 2 * kStages;  // q, full[], empty[]
  static constexpr int kBytes = kBarOff + 8 * kBars + 1024;
};

__device__ __forceinline__ void init_barriers(uint32_t bar0) {
  if (threadIdx.x == 0) {
    mbar_init(bar0, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar0 + 8 * (1 + s), 1);
      mbar_init(bar0 + 8 * (1 + kStages + s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// Rows row0 and row0 + 8 of a consumer's 64 x 128 accumulator, times mul,
// as bf16 into rows out and out + 8 * row_stride.
__device__ __forceinline__ void store_rows(const float (&d)[64], float mul, __nv_bfloat16* out,
                                           size_t row_stride, bool first, bool second) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (!(hh == 0 ? first : second)) continue;
#pragma unroll
    for (int jj = 0; jj < kD / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(out + hh * 8 * row_stride + 8 * jj) =
          __floats2bfloat162_rn(d[4 * jj + 2 * hh] * mul, d[4 * jj + 2 * hh + 1] * mul);
  }
}

// dK and dV of 128 kv rows of one (kv head, batch).  Block w takes kv tile
// w / (KH B), heaviest first under causal, and (kv head, batch) w % (KH B).
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_dkdv_wgmma(const Args a, const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_lse,
                        const __grid_constant__ CUtensorMap tm_delta) {
  using L = DkdvSmem;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint8_t* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bar_kv = base + L::kBarOff;
  auto full = [bar_kv](int s) { return bar_kv + 8 * (1 + s); };
  auto empty = [bar_kv](int s) { return bar_kv + 8 * (1 + kStages + s); };
  auto q_smem = [base](int s) { return base + L::kQOff + s * L::kQ; };
  auto do_smem = [base](int s) { return base + L::kDoOff + s * L::kQ; };

  const int kt = blockIdx.x / (a.KH * a.B), hb = blockIdx.x % (a.KH * a.B);
  const int kvh = hb % a.KH, b = hb / a.KH;
  const int k0 = kt * kBKV, nk = min(kBKV, a.Sk - k0);
  const int group = a.H / a.KH;
  // The query rows [i_lo, i_hi) that can see some key of this tile, and the
  // q steps that hold them, for each head of the group.
  int i_lo = 0, i_hi = a.Sq;
  if (a.causal) i_lo = max(i_lo, k0 - a.q_offset);
  if (a.window > 0) i_hi = min(i_hi, k0 + nk - 1 + a.window - a.q_offset);
  if (k0 >= a.kv_len) i_hi = i_lo;
  const int t_begin = i_lo / kBQ;
  const int n_t = i_hi > i_lo ? (i_hi + kBQ - 1) / kBQ - t_begin : 0;
  const int steps = group * n_t;

  init_barriers(bar_kv);

  if (threadIdx.x < 128) {
    // Producer.  One thread issues every copy; the other warps are done.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0 && steps > 0) {
      mbar_expect_tx(bar_kv, 2 * L::kKV);
#pragma unroll
      for (int c = 0; c < kD / kChunk; ++c) {
        tma_load(base + c * kBKV * kRowBytes, &tm_k, bar_kv, c * kChunk, kvh, k0, b);
        tma_load(base + L::kVOff + c * kBKV * kRowBytes, &tm_v, bar_kv, c * kChunk, kvh, k0, b);
      }
      for (int g = 0; g < steps; ++g) {
        const int h = kvh * group + g / n_t, q0 = (t_begin + g % n_t) * kBQ, s = g % kStages;
        mbar_wait(empty(s), ((g / kStages) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(full(s), L::kStageBytes);
#pragma unroll
        for (int c = 0; c < kD / kChunk; ++c) {
          tma_load(q_smem(s) + c * kBQ * kRowBytes, &tm_q, full(s), c * kChunk, h, q0, b);
          tma_load(do_smem(s) + c * kBQ * kRowBytes, &tm_do, full(s), c * kChunk, h, q0, b);
        }
        tma_load(base + L::kLseOff + s * L::kRow, &tm_lse, full(s), q0, h, b);
        tma_load(base + L::kDeltaOff + s * L::kRow, &tm_delta, full(s), q0, h, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;  // kv rows 64 cw .. 64 cw + 63 of the tile
    const int lane = threadIdx.x % 32, c2 = 2 * (lane % 4);
    const int kr0 = k0 + 64 * cw;                                     // first kv row
    const int krow = kr0 + 16 * (threadIdx.x % 128 / 32) + lane / 4;  // and krow + 8
    const uint32_t k_a = base + 64 * cw * kRowBytes, v_a = k_a + L::kVOff;
    const float sl = a.scale * kLog2e;
    float dk[kD / 2], dv[kD / 2], sc[kBQ / 2], dp[kBQ / 2];
    uint32_t pp[kBQ / 16][4], pd[kBQ / 16][4];  // P^T and dS^T as bf16 A fragments
    zero(dk);
    zero(dv);
    if (steps > 0) mbar_wait(bar_kv, 0);
    for (int g = 0; g < steps; ++g) {
      const int q0 = (t_begin + g % n_t) * kBQ, qp0 = a.q_offset + q0, s = g % kStages;
      const bool none = kr0 >= a.kv_len || (a.causal && kr0 > qp0 + kBQ - 1) ||
                        (a.window > 0 && kr0 + 63 <= qp0 - a.window);
      mbar_wait(full(s), (g / kStages) & 1);
      if (!none) {
        const bool all = kr0 + 63 < a.kv_len && q0 + kBQ <= a.Sq &&
                         (!a.causal || kr0 + 63 <= qp0) &&
                         (a.window <= 0 || kr0 > qp0 + kBQ - 1 - a.window);
        const float* lse = reinterpret_cast<const float*>(smem + L::kLseOff + s * L::kRow);
        const float* dlt = reinterpret_cast<const float*>(smem + L::kDeltaOff + s * L::kRow);
        // S^T first, alone: issued together, S^T and dP^T (and their 16
        // descriptors) beside dK and dV's 128 registers made ptxas spill and
        // serialize the products.  dP^T then runs while P^T is formed.
        wgmma_fence();
        issue_qk<kD, kBQ, kBKV>(sc, k_a, q_smem(s));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        issue_qk<kD, kBQ, kBKV>(dp, v_a, do_smem(s));
        wgmma_commit();
        // Column 8 j + c2 + e of S^T is query row q0 + 8 j + c2 + e.
#pragma unroll
        for (int j = 0; j < kBQ / 8; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(lse + 8 * j + c2);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 8 * j + c2 + e;
              const bool vis = all || (q0 + col < a.Sq && visible(a, qp0 + col, krow + 8 * hh));
              float& x = sc[4 * j + 2 * hh + e];
              x = vis ? exp2f(fmaf(x, sl, -(e ? l2.y : l2.x) * kLog2e)) : 0.f;
            }
        }
        pack_p<kBQ>(sc, pp);
        wgmma_wait<0>();  // dP^T has landed
        fence_regs(dp);
#pragma unroll
        for (int j = 0; j < kBQ / 8; ++j) {
          const float2 d2 = *reinterpret_cast<const float2*>(dlt + 8 * j + c2);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * hh + e;
              dp[i] = sc[i] * (dp[i] - (e ? d2.y : d2.x));
            }
        }
        pack_p<kBQ>(dp, pd);
        wgmma_fence();
        fence_regs(dv);
        fence_regs(dk);
        issue_pv<kD, kBQ>(dv, pp, do_smem(s));
        issue_pv<kD, kBQ>(dk, pd, q_smem(s));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
      }
      mbar_arrive(empty(s));
    }
    // Every row of the tile is written, 0 where no query sees it.
    const size_t row_stride = (size_t)a.KH * kD;
    const size_t at = ((size_t)b * a.Sk + krow) * row_stride + (size_t)kvh * kD + c2;
    store_rows(dk, a.scale, a.dk + at, row_stride, krow < a.Sk, krow + 8 < a.Sk);
    store_rows(dv, 1.f, a.dv + at, row_stride, krow < a.Sk, krow + 8 < a.Sk);
  }
}

// dQ of 128 query rows of one (head, batch).  Block w takes q tile
// w / (H B), counted down from the last (heaviest under causal), and
// (head, batch) w % (H B).
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_dq_wgmma(const Args a, const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v) {
  using L = DqSmem;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_q = base + L::kBarOff;
  auto full = [bar_q](int s) { return bar_q + 8 * (1 + s); };
  auto empty = [bar_q](int s) { return bar_q + 8 * (1 + kStages + s); };
  auto k_smem = [base](int s) { return base + L::kKOff + s * L::kK; };
  auto v_smem = [base](int s) { return base + L::kVOff + s * L::kK; };

  const int n_qt = (a.Sq + kQRows - 1) / kQRows, hb = blockIdx.x % (a.H * a.B);
  const int q0 = (n_qt - 1 - blockIdx.x / (a.H * a.B)) * kQRows;
  const int h = hb % a.H, b = hb / a.H, kvh = h / (a.H / a.KH);
  const int nq = min(kQRows, a.Sq - q0), q_first = a.q_offset + q0;
  // The kv tiles that some row of this q tile can see.
  int kv_end = a.kv_len;
  if (a.causal) kv_end = min(kv_end, q_first + nq);
  const int kv_begin = a.window > 0 ? max(0, q_first - a.window + 1) : 0;
  const int t_begin = kv_begin / kKRows;
  const int t_end = kv_end > kv_begin ? (kv_end + kKRows - 1) / kKRows : t_begin;

  init_barriers(bar_q);

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0 && t_end > t_begin) {
      mbar_expect_tx(bar_q, 2 * L::kQ);
#pragma unroll
      for (int c = 0; c < kD / kChunk; ++c) {
        tma_load(base + c * kQRows * kRowBytes, &tm_q, bar_q, c * kChunk, h, q0, b);
        tma_load(base + L::kDoOff + c * kQRows * kRowBytes, &tm_do, bar_q, c * kChunk, h, q0, b);
      }
      for (int t = t_begin; t < t_end; ++t) {
        const int g = t - t_begin, s = g % kStages;
        mbar_wait(empty(s), ((g / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * L::kK);
#pragma unroll
        for (int c = 0; c < kD / kChunk; ++c) {
          tma_load(k_smem(s) + c * kKRows * kRowBytes, &tm_k, full(s), c * kChunk, kvh,
                   t * kKRows, b);
          tma_load(v_smem(s) + c * kKRows * kRowBytes, &tm_v, full(s), c * kChunk, kvh,
                   t * kKRows, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;  // q rows 64 cw .. 64 cw + 63 of the tile
    const int lane = threadIdx.x % 32, c2 = 2 * (lane % 4);
    const int row = 64 * cw + 16 * (threadIdx.x % 128 / 32) + lane / 4;  // and row + 8
    const int qp_lo = q_first + 64 * cw, qp_hi = qp_lo + 63;
    const uint32_t q_a = base + 64 * cw * kRowBytes, do_a = q_a + L::kDoOff;
    const float sl = a.scale * kLog2e;
    float l2[2], dl[2];  // this thread's rows' lse (times log2 e) and delta
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const bool in = row + 8 * hh < nq;
      const size_t at = ((size_t)b * a.H + h) * a.ld + q0 + row + 8 * hh;
      l2[hh] = in ? a.lse[at] * kLog2e : 0.f;
      dl[hh] = in ? a.delta[at] : 0.f;
    }
    float dq[kD / 2], sc[kKRows / 2], dp[kKRows / 2];
    uint32_t pd[kKRows / 16][4];  // dS as bf16 A fragments
    zero(dq);
    if (t_end > t_begin) mbar_wait(bar_q, 0);
    for (int t = t_begin; t < t_end; ++t) {
      const int g = t - t_begin, s = g % kStages, kp0 = t * kKRows;
      const bool none = 64 * cw >= nq || kp0 >= a.kv_len || (a.causal && kp0 > qp_hi) ||
                        (a.window > 0 && kp0 + kKRows - 1 <= qp_lo - a.window);
      mbar_wait(full(s), (g / kStages) & 1);
      if (!none) {
        wgmma_fence();
        issue_qk<kD, kKRows, kQRows>(sc, q_a, k_smem(s));
        wgmma_commit();
        issue_qk<kD, kKRows, kQRows>(dp, do_a, v_smem(s));
        wgmma_commit();
        const bool all = kp0 + kKRows <= a.kv_len && 64 * cw + 64 <= nq &&
                         (!a.causal || kp0 + kKRows - 1 <= qp_lo) &&
                         (a.window <= 0 || kp0 > qp_hi - a.window);
        wgmma_wait<1>();  // S has landed; P is formed while dP runs
        fence_regs(sc);
#pragma unroll
        for (int j = 0; j < kKRows / 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool vis = all || (row + 8 * hh < nq &&
                                       visible(a, q_first + row + 8 * hh, kp0 + 8 * j + c2 + e));
              float& x = sc[4 * j + 2 * hh + e];
              x = vis ? exp2f(fmaf(x, sl, -l2[hh])) : 0.f;
            }
        wgmma_wait<0>();  // dP has landed
        fence_regs(dp);
#pragma unroll
        for (int j = 0; j < kKRows / 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * hh + e;
              dp[i] = sc[i] * (dp[i] - dl[hh]);
            }
        pack_p<kKRows>(dp, pd);
        wgmma_fence();
        fence_regs(dq);
        issue_pv<kD, kKRows>(dq, pd, k_smem(s));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
      }
      mbar_arrive(empty(s));
    }
    const size_t row_stride = (size_t)a.H * kD;
    store_rows(dq, a.scale, a.dq + ((size_t)b * a.Sq + q0 + row) * row_stride + (size_t)h * kD + c2,
               row_stride, row < nq, row + 8 < nq);
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int launch(const void* q, const void* k, const void* v, const void* dout, const Args& a,
           cudaStream_t stream) {
  if (encode_tiled() == nullptr) return cudaErrorSymbolNotFound;
  // dK/dV: K and V in 128-row boxes, Q and dout in 64-row boxes, lse and
  // delta in 64-float rows; dQ: Q and dout in 128-row boxes, K and V in 64.
  CUtensorMap k128, v128, q64, do64, lse64, delta64, q128, do128, k64, v64;
  CUresult r = encode(&k128, k, a.B, a.Sk, a.KH, kD, kBKV);
  if (r == CUDA_SUCCESS) r = encode(&v128, v, a.B, a.Sk, a.KH, kD, kBKV);
  if (r == CUDA_SUCCESS) r = encode(&q64, q, a.B, a.Sq, a.H, kD, kBQ);
  if (r == CUDA_SUCCESS) r = encode(&do64, dout, a.B, a.Sq, a.H, kD, kBQ);
  if (r == CUDA_SUCCESS) r = encode_rows(&lse64, a.lse, a.B, a.H, a.Sq, a.ld, kBQ);
  if (r == CUDA_SUCCESS) r = encode_rows(&delta64, a.delta, a.B, a.H, a.Sq, a.ld, kBQ);
  if (r == CUDA_SUCCESS) r = encode(&q128, q, a.B, a.Sq, a.H, kD, kQRows);
  if (r == CUDA_SUCCESS) r = encode(&do128, dout, a.B, a.Sq, a.H, kD, kQRows);
  if (r == CUDA_SUCCESS) r = encode(&k64, k, a.B, a.Sk, a.KH, kD, kKRows);
  if (r == CUDA_SUCCESS) r = encode(&v64, v, a.B, a.Sk, a.KH, kD, kKRows);
  if (r != CUDA_SUCCESS) return kTensorMapError | static_cast<int>(r);
  const long long kv_blocks = (long long)((a.Sk + kBKV - 1) / kBKV) * a.KH * a.B;
  const long long q_blocks = (long long)((a.Sq + kQRows - 1) / kQRows) * a.H * a.B;
  if (kv_blocks > 0x7fffffff || q_blocks > 0x7fffffff) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(attn_bwd_dkdv_wgmma, DkdvSmem::kBytes);
  if (err == cudaSuccess) err = set_smem(attn_bwd_dq_wgmma, DqSmem::kBytes);
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv_wgmma<<<(int)kv_blocks, kThreads, DkdvSmem::kBytes, stream>>>(
      a, k128, v128, q64, do64, lse64, delta64);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dq_wgmma<<<(int)q_blocks, kThreads, DqSmem::kBytes, stream>>>(a, q128, do128, k64,
                                                                          v64);
  return cudaGetLastError();
}

}  // namespace

// The tensor-core route's entry point, bf16 at head dims (128, 128) only.
// lse and delta: (B, H, Sq) f32, rows ld apart (ld a multiple of 4, bases
// 16-byte aligned), delta written by flash_attention_bwd_delta before.
// Returns the first CUDA error of the two launches (0 on success),
// cudaErrorInvalidValue for arguments it does not take, or
// kTensorMapError | CUresult when a tensor map cannot be encoded.
extern "C" int flash_attention_bwd_wgmma(const void* q, const void* k, const void* v,
                                         const void* dout, void* dq, void* dk, void* dv,
                                         const float* lse, const float* delta, int ld, int B,
                                         int Sq, int Sk, int H, int KH, int Dk, int Dv,
                                         int causal, int window, int q_offset, int kv_len,
                                         float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || kv_len < 0 ||
      kv_len > Sk || ld < Sq || ld % 4 != 0 || Dk != kD || Dv != kD)
    return cudaErrorInvalidValue;
  const Args a{static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
               static_cast<__nv_bfloat16*>(dv), lse, delta, ld, B, Sq, Sk, H, KH, causal,
               window, q_offset, kv_len, scale};
  return launch(q, k, v, dout, a, static_cast<cudaStream_t>(stream));
}

// The message for any code the backward library's entry points return.
extern "C" const char* flash_attention_bwd_error_string(int err) {
  if (err & kTensorMapError)
    return "cuTensorMapEncodeTiled refused a tensor map (its CUresult is the code's low 16 bits)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
