// Flash attention, backward, on the Hopper tensor cores (sm_90a).
//
// The route of flash_attention_bwd that route(..., backward=True) in
// kernel.py sends bf16 at head dims (Dk, Dv) = (128, 128), (256, 256),
// (96, 64) and (80, 80) to; everything else goes to flash_attention_bwd.cu
// (SIMT).  It
// is the gradient of what the forward computes (flash_attention_fwd; the
// Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py :: flash_attention_kernel
// has no backward: on the TPU jax.grad differentiates the plain chunked
// attention): same masks (causal, sliding window, kv_len, q_offset), query
// head h reads kv head h / (H / KH), scale 1 / sqrt(Dk).  With each row's
// lse from the forward and delta = rowsum(dout * o) from the shared pre-pass
// (flash_attention_bwd_delta, flash_attention_bwd.cu):
//   P = exp(S scale - lse) under the masks, dP = dout V^T,
//   dS = P (dP - delta), dV = P^T dout, dK = scale dS^T Q, dQ = scale dS K;
// a row that sees no key has P = 0 (its lse is 0 and never matters).
// Layout: q, dq (B, Sq, H, Dk); k, dk (B, Sk, KH, Dk); v, dv (B, Sk, KH,
// Dv); dout (B, Sq, H, Dv), bf16, contiguous; lse and delta (B, H, Sq) f32
// with rows ld elements apart, ld a multiple of 4.
//
// What bounds it.  At qwen3-1.7b's train shape (q 8x1024x16x128, k/v
// 8x1024x8x128, causal) the gradient needs five products over 6.7e7 visible
// pairs, 8.6e10 FLOP, against 0.2 GB of inputs and outputs; at
// recurrentgemma-2b's (q 2x4096x10x256, k/v 2x4096x1x256, a 2048-token
// window) 1.26e8 pairs, 3.2e11 FLOP, against 0.1 GB; at minicpm3-4b's
// (q, k 2x4096x48x96, v 2x4096x48x64, causal) 8.1e8 pairs, 6.7e11 FLOP,
// against 0.5 GB; at hubert-xlarge's (q, k, v 2x4096x16x80,
// bidirectional) 5.4e8 pairs, 4.3e11 FLOP, against 0.08 GB.  All are bound
// by operations (0.087, 0.33, 0.68 and 0.43 ms at 989 TFLOP/s bf16), so
// every product runs as wgmma, bf16 operands and f32
// accumulators; P and dS are rounded to bf16 for their products, as the
// forward rounds P.
//
// Design.  Two kernels after the delta pre-pass, each a block of three
// warpgroups: warpgroup 0 the producer (24 registers; one thread issues
// every TMA copy into a ring of stages on mbarriers: full, the bytes
// arrived; empty, all 256 consumer threads are done), warpgroups 1 and 2 the
// consumers (240 registers).  Tiles come in as 64-element (128-byte)
// swizzled chunks of D, through 4-D tensor maps over (D, heads, S, B) that
// zero-fill the ragged edges (and, at Dk 96, columns 96-127 of the second
// chunk, at (80, 80) columns 80-127 of every tile's second chunk: offsets
// and expected bytes count whole chunks, tile_bytes).
//   attn_bwd_dkdv_wgmma<DK, DV>: a block owns the kv rows of one tile of one kv
//     head (K and V loaded once) and walks, for each query head of the GQA
//     group, the 64-row q steps that see the tile (Q, dout and their lse
//     and delta rows by TMA).  dK and dV are summed over the group in
//     registers and written once: no atomics.
//     D 128: 128 kv rows, 64 a consumer.  A consumer computes S^T = K Q^T
//     (its 64 kv rows x 64 q rows, m64n64k16 from shared memory), then
//     dP^T = V dout^T while it forms P^T on S^T's register fragments, then
//     dS^T, then dV += P^T dout and dK += dS^T Q (m64n128k16, P^T and dS^T
//     from registers, dout and Q through the descriptor's transpose bit);
//     dK and dV take 128 f32 registers a thread.
//     (96, 64): D 128's tiles and code (dkdv_consumer_rows).  The products
//     over Dk (S^T = K Q^T) take 6 k16 steps, those over Dv (dP^T = V
//     dout^T) 4, counts fixed by the template.  dK = dS^T Q has N = 96,
//     and its B, Q through the transpose bit, is laid in 64-column chunks
//     (the 128-byte swizzle atom), so it runs at n128 over the zero-filled
//     half chunk: a quarter of that product is wasted, and dK's
//     accumulator takes 64 registers where 48 would do (dK 64 + dV 32 a
//     thread, against 128 at D 128).  Columns 96-127 come out 0 and are
//     never stored.  The other way, Q and K in three 32-column chunks with
//     the 64-byte swizzle and n96, would need a second layout of both
//     tiles, their maps and descriptors for 1/4 of two of seven products.
//     (80, 80): D 128's tiles and code too.  The products over Dk and Dv
//     (S^T = K Q^T, dP^T = V dout^T) take 5 k16 steps each, the fifth in
//     the second chunk.  dK = dS^T Q and dV = P^T dout both have N = 80,
//     and their B operands (Q and dout through the transpose bit) are laid
//     in 64-column atoms along N under the 128-byte swizzle, which no
//     descriptor of n80 describes: both run at n128 over the zero-filled
//     half chunk, 3/8 of each wasted, and dK and dV take 64 registers each,
//     128 a thread as at D 128.  Their columns 80-127 come out 0 and are
//     never stored.  The other way, a 16-column tail of Q and dout in maps
//     of their own with the 32-byte swizzle and an n16 product beside each
//     n64, would need a second layout, map and descriptor of both for 3/8
//     of three of seven products (dQ's too).
//     D 256: dK and dV of 64 rows at 256 columns would take 256 registers a
//     thread, beyond the 240 a consumer has; so a block owns 64 kv rows,
//     shared by both consumers (dkdv_consumer_256), and splits the work
//     FlashAttention-3's way: S^T and dP^T by query columns, dK and dV by
//     head-dim columns, with P^T and dS^T passed through shared memory.
//   attn_bwd_dq_wgmma<DK, DV>: a block owns 128 q rows of one head (Q and
//     dout loaded once) and walks the visible kv tiles, 64 rows a step at D
//     128, (96, 64) and (80, 80) and 32 at D 256 (dQ's 64 x 256 accumulator takes 128
//     registers); a consumer recomputes S = Q K^T and dP = dout V^T (its 64
//     q rows), P while dP runs, then dS, then dQ += dS K (K through the
//     transpose bit; at Dk 96 and 80 n128 over K's zero-filled half chunk,
//     as dK).
//     (Issuing a tile's dQ together with the next tile's S and dP was no
//     faster on the card at D 128.)
// Seven products where five would do, for no atomics: every sum runs in a
// fixed order, so the result is the same bit for bit on every run.  Steps
// that no pair sees are skipped; the masks are applied element by element
// only on steps that some pair of which is hidden.  Blocks run heaviest
// first under causal: kv tile 0 for dK/dV, the last q tile for dQ.  Shared
// memory: dK/dV 64 KB of K and V + 3 stages x 32.5 KB at D 128; 64 KB + 2
// stages x 64.5 KB + 16 KB of P^T and dS^T at D 256, 48 KB + 3 stages x
// 24.5 KB at (96, 64), 64 KB + 3 stages x 32.5 KB at (80, 80); dQ 64 KB of
// Q and dout + 3 stages x 32 KB at D 128 and (80, 80), 128 KB + 3 x 32 KB
// at D 256, 48 KB + 3 x 24 KB at (96, 64).

#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 384;   // three warpgroups: producer, two consumers
constexpr int kBQ = 64;         // dK/dV: query rows a step
constexpr int kQRows = 128;     // dQ: query rows of a block, 64 a consumer
constexpr int kDqStages = 3;    // dQ: stages of K and V
constexpr float kLog2e = 1.4426950408889634f;

// The tiles at each head-dim pair (Dk, Dv).
template <int DK, int DV>
struct Tiles;
template <>
struct Tiles<128, 128> {
  static constexpr int kBKV = 128;   // dK/dV: kv rows of a block, 64 a consumer
  static constexpr int kStages = 3;  //   stages of Q and dout
  static constexpr int kKRows = 64;  // dQ: kv rows a step
};
template <>
struct Tiles<256, 256> {
  static constexpr int kBKV = 64;    // dK/dV: kv rows of a block, all 64 in both consumers
  static constexpr int kStages = 2;
  static constexpr int kKRows = 32;
};
template <>
struct Tiles<96, 64> {  // D 128's: fewer bytes and registers every way
  static constexpr int kBKV = 128;
  static constexpr int kStages = 3;
  static constexpr int kKRows = 64;
};
template <>
struct Tiles<80, 80> {  // D 128's: the same bytes (whole chunks) and registers
  static constexpr int kBKV = 128;
  static constexpr int kStages = 3;
  static constexpr int kKRows = 64;
};

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
  float scale;     // 1 / sqrt(Dk)
};

__device__ __forceinline__ bool visible(const Args& a, int qpos, int kpos) {
  bool vis = kpos < a.kv_len;
  if (a.causal) vis = vis && kpos <= qpos;
  if (a.window > 0) vis = vis && kpos > qpos - a.window;
  return vis;
}

// Shared memory of a dK/dV block, in bytes from a 1024-byte aligned base: K
// and V as chunks(DK) and chunks(DV) chunks of BKV rows x 128 bytes; per
// stage Q and dout likewise of 64 rows; at D 256, P^T and dS^T (64 x 64
// bf16, one chunk each); per stage lse and delta (64 floats each); then the
// mbarriers.
template <int DK, int DV>
struct DkdvSmem {
  static constexpr int kBKV = Tiles<DK, DV>::kBKV, kStages = Tiles<DK, DV>::kStages;
  static constexpr int kK = tile_bytes(kBKV, DK), kV = tile_bytes(kBKV, DV);
  static constexpr int kQ = tile_bytes(kBQ, DK), kDo = tile_bytes(kBQ, DV);
  static constexpr int kRow = kBQ * 4;
  static constexpr int kP = DK == 256 ? kBKV * kBQ * 2 : 0;
  static constexpr int kVOff = kK;
  static constexpr int kQOff = kK + kV;
  static constexpr int kDoOff = kQOff + kStages * kQ;
  static constexpr int kPOff = kDoOff + kStages * kDo;
  static constexpr int kDsOff = kPOff + kP;
  static constexpr int kLseOff = kDsOff + kP;
  static constexpr int kDeltaOff = kLseOff + kStages * kRow;
  static constexpr int kBarOff = kDeltaOff + kStages * kRow;
  static constexpr int kBars = 1 + 2 * kStages;  // kv, full[], empty[]
  static constexpr int kBytes = kBarOff + 8 * kBars + 1024;  // + room to align the base
  static constexpr int kStageBytes = kQ + kDo + 2 * kRow;
  static_assert(kBytes <= 232448, "shared memory beyond 227 KB");
};

// Shared memory of a dQ block: Q and dout as chunks(DK) and chunks(DV)
// chunks of 128 rows x 128 bytes; per stage K and V likewise of KROWS rows;
// then the mbarriers.
template <int DK, int DV>
struct DqSmem {
  static constexpr int kKRows = Tiles<DK, DV>::kKRows, kStages = kDqStages;
  static constexpr int kQ = tile_bytes(kQRows, DK), kDo = tile_bytes(kQRows, DV);
  static constexpr int kK = tile_bytes(kKRows, DK), kV = tile_bytes(kKRows, DV);
  static constexpr int kDoOff = kQ;
  static constexpr int kKOff = kQ + kDo;
  static constexpr int kVOff = kKOff + kStages * kK;
  static constexpr int kBarOff = kVOff + kStages * kV;
  static constexpr int kBars = 1 + 2 * kStages;  // q, full[], empty[]
  static constexpr int kBytes = kBarOff + 8 * kBars + 1024;
  static_assert(kBytes <= 232448, "shared memory beyond 227 KB");  // a block's most
};

// The mbarriers of a block: `bar` for the tiles loaded once, then a ring of
// STAGES stages, full[s] (the bytes arrived) and empty[s] (all 256 consumer
// threads are done with it).
template <int STAGES>
struct Ring {
  uint32_t bar;
  __device__ __forceinline__ uint32_t full(int s) const { return bar + 8 * (1 + s); }
  __device__ __forceinline__ uint32_t empty(int s) const { return bar + 8 * (1 + STAGES + s); }
};

template <int STAGES>
__device__ __forceinline__ void init_barriers(const Ring<STAGES>& ring) {
  if (threadIdx.x == 0) {
    mbar_init(ring.bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(ring.full(s), 1);
      mbar_init(ring.empty(s), 2 * 128);
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

// Rows row0 and row0 + 8 of the first N columns of a consumer's 64-row
// accumulator (2 M columns: at Dk 96, N 96 of 128; at 80, 80 of 128), times
// mul, as bf16 into
// rows out and out + 8 * row_stride.
template <int N, int M>
__device__ __forceinline__ void store_rows(const float (&d)[M], float mul, __nv_bfloat16* out,
                                           size_t row_stride, bool first, bool second) {
  static_assert(N % 8 == 0 && N / 2 <= M, "columns beyond the accumulator");
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (!(hh == 0 ? first : second)) continue;
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(out + hh * 8 * row_stride + 8 * jj) =
          __floats2bfloat162_rn(d[4 * jj + 2 * hh] * mul, d[4 * jj + 2 * hh + 1] * mul);
  }
}

// What a dK/dV block owns: BKV kv rows from k0 of kv head kvh, batch b; and
// the q steps that see them, n_t for each of the group's query heads from
// step t_begin, `steps` in all.  Block w takes kv tile w / (KH B), heaviest
// first under causal, and (kv head, batch) w % (KH B).
struct DkdvWork {
  int k0, kvh, b, group, t_begin, n_t, steps;
};

template <int DK, int DV>
__device__ __forceinline__ DkdvWork dkdv_work(const Args& a) {
  constexpr int kBKV = Tiles<DK, DV>::kBKV;
  const int kt = blockIdx.x / (a.KH * a.B), hb = blockIdx.x % (a.KH * a.B);
  DkdvWork w;
  w.kvh = hb % a.KH;
  w.b = hb / a.KH;
  w.k0 = kt * kBKV;
  w.group = a.H / a.KH;
  const int nk = min(kBKV, a.Sk - w.k0);
  // The query rows [i_lo, i_hi) that can see some key of this tile.
  int i_lo = 0, i_hi = a.Sq;
  if (a.causal) i_lo = max(i_lo, w.k0 - a.q_offset);
  if (a.window > 0) i_hi = min(i_hi, w.k0 + nk - 1 + a.window - a.q_offset);
  if (w.k0 >= a.kv_len) i_hi = i_lo;
  w.t_begin = i_lo / kBQ;
  w.n_t = i_hi > i_lo ? (i_hi + kBQ - 1) / kBQ - w.t_begin : 0;
  w.steps = w.group * w.n_t;
  return w;
}

// The consumers of a dK/dV block at D 128, (96, 64) and (80, 80): consumer
// cw owns kv rows 64 cw .. 64 cw + 63 of the tile and every column of their
// dK and dV (each accumulator at whole chunks: 128 columns at Dk 96, the
// last 32 zero; at (80, 80) dK and dV both 128, the last 48 zero).
template <int DK, int DV>
__device__ __forceinline__ void dkdv_consumer_rows(const Args& a, const DkdvWork& w,
                                                   uint32_t base, const uint8_t* smem,
                                                   const Ring<3>& ring) {
  using L = DkdvSmem<DK, DV>;
  constexpr int kNK = chunks(DK) * kChunk, kNV = chunks(DV) * kChunk;
  auto q_smem = [base](int s) { return base + L::kQOff + s * L::kQ; };
  auto do_smem = [base](int s) { return base + L::kDoOff + s * L::kDo; };
  const int cw = threadIdx.x / 128 - 1;
  const int lane = threadIdx.x % 32, c2 = 2 * (lane % 4);
  const int kr0 = w.k0 + 64 * cw;                                   // first kv row
  const int krow = kr0 + 16 * (threadIdx.x % 128 / 32) + lane / 4;  // and krow + 8
  const uint32_t k_a = base + 64 * cw * kRowBytes, v_a = k_a + L::kVOff;
  const float sl = a.scale * kLog2e;
  float dk[kNK / 2], dv[kNV / 2], sc[kBQ / 2], dp[kBQ / 2];
  uint32_t pp[kBQ / 16][4], pd[kBQ / 16][4];  // P^T and dS^T as bf16 A fragments
  zero(dk);
  zero(dv);
  if (w.steps > 0) mbar_wait(ring.bar, 0);
  for (int g = 0; g < w.steps; ++g) {
    const int q0 = (w.t_begin + g % w.n_t) * kBQ, qp0 = a.q_offset + q0, s = g % L::kStages;
    const bool none = kr0 >= a.kv_len || (a.causal && kr0 > qp0 + kBQ - 1) ||
                      (a.window > 0 && kr0 + 63 <= qp0 - a.window);
    mbar_wait(ring.full(s), (g / L::kStages) & 1);
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
      issue_qk<DK, kBQ, L::kBKV>(sc, k_a, q_smem(s));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      issue_qk<DV, kBQ, L::kBKV>(dp, v_a, do_smem(s));
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
      issue_pv<kNV, kBQ>(dv, pp, do_smem(s));
      issue_pv<kNK, kBQ>(dk, pd, q_smem(s));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
    }
    mbar_arrive(ring.empty(s));
  }
  // Every row of the tile is written, 0 where no query sees it; dK's
  // columns from DK on, and dV's from DV on, are not.
  const size_t k_stride = (size_t)a.KH * DK, v_stride = (size_t)a.KH * DV;
  const size_t row = (size_t)w.b * a.Sk + krow;
  store_rows<DK>(dk, a.scale, a.dk + row * k_stride + (size_t)w.kvh * DK + c2, k_stride,
                 krow < a.Sk, krow + 8 < a.Sk);
  store_rows<DV>(dv, 1.f, a.dv + row * v_stride + (size_t)w.kvh * DV + c2, v_stride,
                 krow < a.Sk, krow + 8 < a.Sk);
}

// The consumers of a dK/dV block at D 256, where 256 columns of dK and dV
// would take 256 registers a thread.  Both take all 64 kv rows of the tile.
// A step's S^T and dP^T (64 kv rows x 64 query rows) are split by query
// columns, 32 a consumer (m64n32k16 over D from shared memory); each forms
// P^T and dS^T on its fragment and writes them, rounded to bf16, to shared
// memory; after a barrier consumer cw owns columns 128 cw .. 128 cw + 127 of
// dK and dV (m64n128k16, P^T and dS^T from shared memory, dout and Q through
// the transpose bit).  A step's dV and dK products run on while the next
// step's stage is awaited and its S^T and dP^T are issued; the barrier
// before the writes waits for both consumers' last products, which read
// P^T and dS^T.
__device__ __forceinline__ void dkdv_consumer_256(const Args& a, const DkdvWork& w, uint32_t base,
                                                  uint8_t* smem, const Ring<2>& ring) {
  using L = DkdvSmem<256, 256>;
  constexpr int kD = 256, kHalf = 128, kCols = 32;
  const int cw = threadIdx.x / 128 - 1;
  const int lane = threadIdx.x % 32, c2 = 2 * (lane % 4), g8 = lane / 4;
  const int wrow = 16 * (threadIdx.x % 128 / 32) + g8;  // and wrow + 8, rows of the tile
  const int krow = w.k0 + wrow;
  const int qc0 = kCols * cw;  // this consumer's first query column of a step
  const uint32_t k_a = base, v_a = base + L::kVOff;
  const float sl = a.scale * kLog2e;
  float dk[kHalf / 2], dv[kHalf / 2], sc[kCols / 2], dp[kCols / 2];
  zero(dk);
  zero(dv);
  int held = -1;  // the stage whose dV and dK products are in flight
  if (w.steps > 0) mbar_wait(ring.bar, 0);
  for (int g = 0; g < w.steps; ++g) {
    const int q0 = (w.t_begin + g % w.n_t) * kBQ, qp0 = a.q_offset + q0, s = g % L::kStages;
    // the same for both consumers, which meet at the barriers of every step
    // not skipped
    const bool none = w.k0 >= a.kv_len || (a.causal && w.k0 > qp0 + kBQ - 1) ||
                      (a.window > 0 && w.k0 + 63 <= qp0 - a.window);
    if (none && held >= 0) {  // release the held stage before waiting for another
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      mbar_arrive(ring.empty(held));
      held = -1;
    }
    mbar_wait(ring.full(s), (g / L::kStages) & 1);
    if (none) {
      mbar_arrive(ring.empty(s));
      continue;
    }
    const uint32_t q_s = base + L::kQOff + s * L::kQ, do_s = base + L::kDoOff + s * L::kDo;
    wgmma_fence();
    issue_qk<kD, kCols, L::kBKV, kBQ>(sc, k_a, q_s + qc0 * kRowBytes);
    wgmma_commit();
    issue_qk<kD, kCols, L::kBKV, kBQ>(dp, v_a, do_s + qc0 * kRowBytes);
    wgmma_commit();
    wgmma_wait<1>();  // S^T has landed, and the last step's dV and dK
    fence_regs(sc);
    if (held >= 0) {
      fence_regs(dv);
      fence_regs(dk);
      mbar_arrive(ring.empty(held));
    }
    const bool all = w.k0 + 63 < a.kv_len && q0 + qc0 + kCols <= a.Sq &&
                     (!a.causal || w.k0 + 63 <= qp0 + qc0) &&
                     (a.window <= 0 || w.k0 > qp0 + qc0 + kCols - 1 - a.window);
    const float* lse = reinterpret_cast<const float*>(smem + L::kLseOff + s * L::kRow) + qc0;
    const float* dlt = reinterpret_cast<const float*>(smem + L::kDeltaOff + s * L::kRow) + qc0;
    // Column 8 j + c2 + e of this consumer's S^T is query row q0 + qc0 + 8 j + c2 + e.
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse + 8 * j + c2);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = qc0 + 8 * j + c2 + e;
          const bool vis = all || (q0 + col < a.Sq && visible(a, qp0 + col, krow + 8 * hh));
          float& x = sc[4 * j + 2 * hh + e];
          x = vis ? exp2f(fmaf(x, sl, -(e ? l2.y : l2.x) * kLog2e)) : 0.f;
        }
    }
    wgmma_wait<0>();  // dP^T has landed
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(dlt + 8 * j + c2);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hh + e;
          dp[i] = sc[i] * (dp[i] - (e ? d2.y : d2.x));
        }
    }
    consumer_sync();  // both consumers' last dV and dK have read P^T and dS^T
    // Row r, query column c of P^T at byte r 128 + 16 ((2 c / 16) ^ (r % 8)) +
    // 2 c % 16: one 128-byte swizzled chunk, as wgmma reads it.
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int at = (wrow + 8 * hh) * kRowBytes + (((4 * cw + j) ^ g8) << 4) + 2 * c2;
        const int i = 4 * j + 2 * hh;
        *reinterpret_cast<__nv_bfloat162*>(smem + L::kPOff + at) =
            __floats2bfloat162_rn(sc[i], sc[i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(smem + L::kDsOff + at) =
            __floats2bfloat162_rn(dp[i], dp[i + 1]);
      }
    fence_proxy_async();
    consumer_sync();  // P^T and dS^T are whole
    wgmma_fence();
    fence_regs(dv);
    fence_regs(dk);
    issue_ss_pv(dv, base + L::kPOff, do_s + 2 * cw * kBQ * kRowBytes);
    issue_ss_pv(dk, base + L::kDsOff, q_s + 2 * cw * kBQ * kRowBytes);
    wgmma_commit();
    held = s;
  }
  if (held >= 0) {
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    mbar_arrive(ring.empty(held));
  }
  // Every row of the tile is written, 0 where no query sees it.
  const size_t row_stride = (size_t)a.KH * kD;
  const size_t at =
      ((size_t)w.b * a.Sk + krow) * row_stride + (size_t)w.kvh * kD + kHalf * cw + c2;
  store_rows<kHalf>(dk, a.scale, a.dk + at, row_stride, krow < a.Sk, krow + 8 < a.Sk);
  store_rows<kHalf>(dv, 1.f, a.dv + at, row_stride, krow < a.Sk, krow + 8 < a.Sk);
}

// dK and dV of BKV kv rows of one (kv head, batch) (dkdv_work).  The
// producer is the same at every head-dim pair; the consumers are not.
template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_dkdv_wgmma(const Args a, const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_lse,
                        const __grid_constant__ CUtensorMap tm_delta) {
  using L = DkdvSmem<DK, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - smem_u32(smem_raw));
  const Ring<L::kStages> ring{base + L::kBarOff};
  const DkdvWork w = dkdv_work<DK, DV>(a);
  init_barriers(ring);

  if (threadIdx.x < 128) {
    // Producer.  One thread issues every copy; the other warps are done.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0 && w.steps > 0) {
      mbar_expect_tx(ring.bar, L::kK + L::kV);
#pragma unroll
      for (int c = 0; c < chunks(DK); ++c)
        tma_load(base + c * L::kBKV * kRowBytes, &tm_k, ring.bar, c * kChunk, w.kvh, w.k0, w.b);
#pragma unroll
      for (int c = 0; c < chunks(DV); ++c)
        tma_load(base + L::kVOff + c * L::kBKV * kRowBytes, &tm_v, ring.bar, c * kChunk, w.kvh,
                 w.k0, w.b);
      for (int g = 0; g < w.steps; ++g) {
        const int h = w.kvh * w.group + g / w.n_t, q0 = (w.t_begin + g % w.n_t) * kBQ;
        const int s = g % L::kStages;
        mbar_wait(ring.empty(s), ((g / L::kStages) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(ring.full(s), L::kStageBytes);
        const uint32_t q_s = base + L::kQOff + s * L::kQ, do_s = base + L::kDoOff + s * L::kDo;
#pragma unroll
        for (int c = 0; c < chunks(DK); ++c)
          tma_load(q_s + c * kBQ * kRowBytes, &tm_q, ring.full(s), c * kChunk, h, q0, w.b);
#pragma unroll
        for (int c = 0; c < chunks(DV); ++c)
          tma_load(do_s + c * kBQ * kRowBytes, &tm_do, ring.full(s), c * kChunk, h, q0, w.b);
        tma_load(base + L::kLseOff + s * L::kRow, &tm_lse, ring.full(s), q0, h, w.b);
        tma_load(base + L::kDeltaOff + s * L::kRow, &tm_delta, ring.full(s), q0, h, w.b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    if constexpr (DK == 256)
      dkdv_consumer_256(a, w, base, smem, ring);
    else
      dkdv_consumer_rows<DK, DV>(a, w, base, smem, ring);
  }
}

// dQ of 128 query rows of one (head, batch).  Block w takes q tile
// w / (H B), counted down from the last (heaviest under causal), and
// (head, batch) w % (H B).
template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_dq_wgmma(const Args a, const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v) {
  using L = DqSmem<DK, DV>;
  constexpr int kKRows = L::kKRows, kNK = chunks(DK) * kChunk;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const Ring<L::kStages> ring{base + L::kBarOff};
  auto k_smem = [base](int s) { return base + L::kKOff + s * L::kK; };
  auto v_smem = [base](int s) { return base + L::kVOff + s * L::kV; };

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

  init_barriers(ring);

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0 && t_end > t_begin) {
      mbar_expect_tx(ring.bar, L::kQ + L::kDo);
#pragma unroll
      for (int c = 0; c < chunks(DK); ++c)
        tma_load(base + c * kQRows * kRowBytes, &tm_q, ring.bar, c * kChunk, h, q0, b);
#pragma unroll
      for (int c = 0; c < chunks(DV); ++c)
        tma_load(base + L::kDoOff + c * kQRows * kRowBytes, &tm_do, ring.bar, c * kChunk, h, q0,
                 b);
      for (int t = t_begin; t < t_end; ++t) {
        const int g = t - t_begin, s = g % L::kStages;
        mbar_wait(ring.empty(s), ((g / L::kStages) & 1) ^ 1);
        mbar_expect_tx(ring.full(s), L::kK + L::kV);
#pragma unroll
        for (int c = 0; c < chunks(DK); ++c)
          tma_load(k_smem(s) + c * kKRows * kRowBytes, &tm_k, ring.full(s), c * kChunk, kvh,
                   t * kKRows, b);
#pragma unroll
        for (int c = 0; c < chunks(DV); ++c)
          tma_load(v_smem(s) + c * kKRows * kRowBytes, &tm_v, ring.full(s), c * kChunk, kvh,
                   t * kKRows, b);
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
    float dq[kNK / 2], sc[kKRows / 2], dp[kKRows / 2];
    uint32_t pd[kKRows / 16][4];  // dS as bf16 A fragments
    zero(dq);
    if (t_end > t_begin) mbar_wait(ring.bar, 0);
    for (int t = t_begin; t < t_end; ++t) {
      const int g = t - t_begin, s = g % L::kStages, kp0 = t * kKRows;
      const bool none = 64 * cw >= nq || kp0 >= a.kv_len || (a.causal && kp0 > qp_hi) ||
                        (a.window > 0 && kp0 + kKRows - 1 <= qp_lo - a.window);
      mbar_wait(ring.full(s), (g / L::kStages) & 1);
      if (!none) {
        wgmma_fence();
        issue_qk<DK, kKRows, kQRows>(sc, q_a, k_smem(s));
        wgmma_commit();
        issue_qk<DV, kKRows, kQRows>(dp, do_a, v_smem(s));
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
        issue_pv<kNK, kKRows>(dq, pd, k_smem(s));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
      }
      mbar_arrive(ring.empty(s));
    }
    const size_t row_stride = (size_t)a.H * DK;  // dQ's columns from DK on are not stored
    store_rows<DK>(dq, a.scale,
                   a.dq + ((size_t)b * a.Sq + q0 + row) * row_stride + (size_t)h * DK + c2,
                   row_stride, row < nq, row + 8 < nq);
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int DK, int DV>
int launch(const void* q, const void* k, const void* v, const void* dout, const Args& a,
           cudaStream_t stream) {
  if (encode_tiled() == nullptr) return cudaErrorSymbolNotFound;
  constexpr int kBKV = Tiles<DK, DV>::kBKV, kKRows = Tiles<DK, DV>::kKRows;
  // dK/dV: K and V in BKV-row boxes, Q and dout in 64-row boxes, lse and
  // delta in 64-float rows; dQ: Q and dout in 128-row boxes, K and V in
  // KROWS-row boxes.
  CUtensorMap k_kv, v_kv, q64, do64, lse64, delta64, q128, do128, k_q, v_q;
  CUresult r = encode(&k_kv, k, a.B, a.Sk, a.KH, DK, kBKV);
  if (r == CUDA_SUCCESS) r = encode(&v_kv, v, a.B, a.Sk, a.KH, DV, kBKV);
  if (r == CUDA_SUCCESS) r = encode(&q64, q, a.B, a.Sq, a.H, DK, kBQ);
  if (r == CUDA_SUCCESS) r = encode(&do64, dout, a.B, a.Sq, a.H, DV, kBQ);
  if (r == CUDA_SUCCESS) r = encode_rows(&lse64, a.lse, a.B, a.H, a.Sq, a.ld, kBQ);
  if (r == CUDA_SUCCESS) r = encode_rows(&delta64, a.delta, a.B, a.H, a.Sq, a.ld, kBQ);
  if (r == CUDA_SUCCESS) r = encode(&q128, q, a.B, a.Sq, a.H, DK, kQRows);
  if (r == CUDA_SUCCESS) r = encode(&do128, dout, a.B, a.Sq, a.H, DV, kQRows);
  if (r == CUDA_SUCCESS) r = encode(&k_q, k, a.B, a.Sk, a.KH, DK, kKRows);
  if (r == CUDA_SUCCESS) r = encode(&v_q, v, a.B, a.Sk, a.KH, DV, kKRows);
  if (r != CUDA_SUCCESS) return kTensorMapError | static_cast<int>(r);
  const long long kv_blocks = (long long)((a.Sk + kBKV - 1) / kBKV) * a.KH * a.B;
  const long long q_blocks = (long long)((a.Sq + kQRows - 1) / kQRows) * a.H * a.B;
  if (kv_blocks > 0x7fffffff || q_blocks > 0x7fffffff) return cudaErrorInvalidValue;
  using Dkdv = DkdvSmem<DK, DV>;
  using Dq = DqSmem<DK, DV>;
  cudaError_t err = set_smem(attn_bwd_dkdv_wgmma<DK, DV>, Dkdv::kBytes);
  if (err == cudaSuccess) err = set_smem(attn_bwd_dq_wgmma<DK, DV>, Dq::kBytes);
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv_wgmma<DK, DV><<<(int)kv_blocks, kThreads, Dkdv::kBytes, stream>>>(
      a, k_kv, v_kv, q64, do64, lse64, delta64);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dq_wgmma<DK, DV><<<(int)q_blocks, kThreads, Dq::kBytes, stream>>>(a, q128, do128,
                                                                             k_q, v_q);
  return cudaGetLastError();
}

}  // namespace

// The tensor-core route's entry point, bf16 at head dims (Dk, Dv) in
// BWD_WGMMA_HEAD_DIMS (kernel.py) only.  lse and delta: (B, H, Sq) f32, rows
// ld apart (ld a multiple of 4, bases 16-byte aligned), delta written by
// flash_attention_bwd_delta before.  Returns the first CUDA error of the two
// launches (0 on success), cudaErrorInvalidValue for arguments it does not
// take, or kTensorMapError | CUresult when a tensor map cannot be encoded.
extern "C" int flash_attention_bwd_wgmma(const void* q, const void* k, const void* v,
                                         const void* dout, void* dq, void* dk, void* dv,
                                         const float* lse, const float* delta, int ld, int B,
                                         int Sq, int Sk, int H, int KH, int Dk, int Dv,
                                         int causal, int window, int q_offset, int kv_len,
                                         float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || kv_len < 0 ||
      kv_len > Sk || ld < Sq || ld % 4 != 0)
    return cudaErrorInvalidValue;
  const Args a{static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
               static_cast<__nv_bfloat16*>(dv), lse, delta, ld, B, Sq, Sk, H, KH, causal,
               window, q_offset, kv_len, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dk == 128 && Dv == 128) return launch<128, 128>(q, k, v, dout, a, s);
  if (Dk == 256 && Dv == 256) return launch<256, 256>(q, k, v, dout, a, s);
  if (Dk == 96 && Dv == 64) return launch<96, 64>(q, k, v, dout, a, s);
  if (Dk == 80 && Dv == 80) return launch<80, 80>(q, k, v, dout, a, s);
  return cudaErrorInvalidValue;
}

// The message for any code the backward library's entry points return.
extern "C" const char* flash_attention_bwd_error_string(int err) {
  if (err & kTensorMapError)
    return "cuTensorMapEncodeTiled refused a tensor map (its CUresult is the code's low 16 bits)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
