// RWKV6 (Finch) WKV recurrence, forward, in chunks on the Hopper tensor
// cores (sm_90a).
//
// The "chunk" route of rwkv6_wkv_fwd, which route() in kernel.py sends bf16
// at head dim 64 and T >= 2 to (rwkv6-7b's prefill); everything else, every
// decode step and all of f32 included, goes to wkv_fwd in rwkv6_wkv_fwd.cu.
// Like that kernel it replaces the Pallas TPU kernel
//   src/repro/kernels/rwkv6_wkv/kernel.py :: rwkv6_wkv_kernel
// (body _wkv_kernel) and computes what it computes: for each (b, h) a 64 x 64
// state S in f32 (S[i][j], i over k, j over v), and for each step t
//   y_t = r_t^T (S + (u . k_t) v_t^T),   S <- diag(w_t) S + k_t v_t^T,
// from s0 (zeros when s0 is null).  r, k, v, w and y are bf16 (B, T, H, 64);
// u (H, 64), s0 and s_last (B, H, 64, 64) are f32; all contiguous.
//
// The chunked form.  Write P(a, b) for the product of w over the steps a <=
// tau < b, per channel (1 when a = b).  Split T into chunks of C = 64 steps
// and each chunk into four sub-chunks of 16.  For t in the chunk that starts
// at c, with S_c the state there and b_q the first step of t's sub-chunk q:
//   y_t = (r_t . P(c, t))^T S_c                               [inter-chunk]
//       + sum_{c <= s < t} A[t][s] v_s + (r_t . u . k_t)^T 1 v_t
//   A[t][s] = sum_i r_t[i] k_s[i] P(s + 1, t)[i]
//   S_{c+C} = diag(P(c, c + C)) S_c + sum_s (k_s . P(s + 1, c + C)) v_s^T.
// For s in an earlier sub-chunk than t, P(s + 1, t) = P(b_q, t) P(s + 1, b_q),
// so that block of A is a product (r . P(b_q, .)) (k . P(. + 1, b_q))^T on the
// tensor cores (mma.sync, 16 rows a warp).  Inside a sub-chunk the same
// holds through its middle step b_q + 8: the 8 x 8 block below the diagonal
// is one more such product, and only the two diagonal 8 x 8 blocks are
// summed on the CUDA cores in f32, each P(s + 1, t) a running product.
//
// Two numeric traps decide the form.  The model's decay w = exp(-exp(x))
// reaches log w of about -100 in one step and is exactly 0 in bf16 now and
// then, so a form that subtracts prefix sums of log w computes
// (-inf) - (-inf) = NaN, and one that puts exp(+sum log w) on one side of a
// product overflows.  Here every P is a product of w, built as a running
// product from the nearest boundary of a chunk, sub-chunk or half of one,
// and every factor is at most 1: w = 0 gives exactly 0 and a tiny product
// underflows to 0, never to inf or NaN.  Second, s_last is held to 1e-5 of
// the plain version, as in f32, which one bf16 rounding of k . P (about
// 2**-9) would miss a hundredfold: the state update multiplies v (exact in
// bf16) by a three-piece bf16 split of the f32 k . P(s + 1, c + C) (hi + mid
// + lo, 24 bits), three products on the tensor cores with S kept in f32 in
// a wgmma accumulator across all chunks.  y (held to 2**-7) takes single
// bf16 roundings of r . P, of S_c, of the decayed r and k of the products
// and of A.
//
// What bounds it.  At the rwkv6-7b prefill shape (8, 1024, 64, 64) the
// function reads r, k, v and w (4 x 67.1 MB) and writes y (67.1 MB) and
// s_last (8.4 MB): 344 MB, 0.103 ms at 3.35 TB/s, against 8.6e9 FLOP of the
// recurrence (0.009 ms on the tensor cores), so bytes set the floor.  The
// chunked form does about 2.4e10 FLOP on the tensor cores (the split state
// update three times) and about 3e8 in f32 on the CUDA cores (the diagonal
// blocks), besides the decays and the operands it writes to shared memory.
// The recurrent kernel is bound by its dependent chain of a step per
// barrier.  Here a block of two warpgroups owns one (b, h) and walks its 16
// chunks, the next chunks' four tiles coming in by TMA (two stages); each
// chunk is a few thousand cycles of independent work shared by 8 warps, two
// on each SM sub-partition, and what holds it is their instruction issue
// (the operands, the decays and the diagonal blocks on the CUDA cores) and
// the 20 products on the tensor cores, not the bytes.
//
// Shared memory (one block an SM, 163 KB): the TMA ring (r, k, v, w tiles of
// 64 x 64 bf16, 128-byte swizzle); the operands built each chunk, in the
// same swizzle (r . P(c, t) and S_c for the inter-chunk product; r . P(b_q,
// t) and k decayed to b_1, b_2, b_3 for the cross-sub-chunk scores; r and k
// decayed through each sub-chunk's middle step; the three pieces of the
// decayed k); per warp its share of the diagonal blocks; y staged for
// coalesced stores.  The ragged last chunk comes in zero-filled and takes w
// = 1 past T, so its padded steps leave the state alone; offsets are 64-bit.

#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kD = 64;        // head dim (the chunk route's only one)
constexpr int kC = 64;        // steps a chunk
constexpr int kSub = 16;      // steps a sub-chunk: one warp of each warpgroup
constexpr int kThreads = 256; // two warpgroups
constexpr int kStages = 2;
constexpr int kTile = kC * kD * 2;  // one 64 x 64 bf16 tile, 8192 bytes

struct Args {
  const float* u;
  const float* s0;  // null: a zero state
  __nv_bfloat16* y;
  float* s_last;
  int T, H;
};

// Byte offsets from a 1024-byte aligned base.
struct Smem {
  static constexpr int kRing = 0;                              // stage s, tile x: r k v w
  static constexpr int kRc = kRing + kStages * 4 * kTile;      // r . P(c, t)
  static constexpr int kRsub = kRc + kTile;                    // r . P(b_q, t)
  static constexpr int kKq = kRsub + kTile;                    // k . P(s + 1, b_q), q = 1, 2, 3
  static constexpr int kRmid = kKq + 6 * kSub * 128;           // r . P(b_q + 8, t), t >= b_q + 8
  static constexpr int kKmid = kRmid + kTile;                  // k . P(s + 1, b_q + 8), s < b_q + 8
  static constexpr int kKe = kKmid + 4 * 8 * 128;              // 3 pieces of k . P(s + 1, c + C)
  static constexpr int kS = kKe + 3 * kTile;                   // S_c in bf16
  static constexpr int kY = kS + kTile;                        // y of the chunk
  static constexpr int kDiag = kY + kTile;                     // per warp: 16 x 17 f32
  static constexpr int kDiagWarp = kSub * 17 * 4;
  static constexpr int kG = kDiag + 8 * kDiagWarp;             // P(b_q, b_q + 16), 4 x 64 f32
  static constexpr int kU = kG + 4 * kD * 4;                   // u of the head
  static constexpr int kBar = kU + kD * 4;                     // one mbarrier a stage
  static constexpr int kBytes = kBar + 8 * kStages + 1024;     // + room to align the base
};

// Rows 8 (q - 1) q .. of the decayed-k region hold k decayed to b_q, 16 q
// rows (q = 1, 2, 3).
__device__ __forceinline__ int kq_row0(int q) { return 8 * (q - 1) * q; }

// A 32-bit word as two bf16 values (the first in the low half) in f32.
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

// Eight bf16 values (16 bytes) in f32.
__device__ __forceinline__ void unpack_bf16x8(const uint4& v, float (&x)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = unpack_bf16(w[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// x = hi + mid + lo, each rounded to bf16: the three pieces hold x's 24 bits.
__device__ __forceinline__ void split3(float x, float& hi, float& mid, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(x));
  const float r1 = x - hi;
  mid = __bfloat162float(__float2bfloat16_rn(r1));
  lo = r1 - mid;
}

// Both warpgroups share the work of a chunk.  Warp q of warpgroup 0 and warp
// 4 + q of warpgroup 1 take sub-chunk q.  Warpgroup 0: P(b_q, t) forwards,
// r . P(c, t) and r . P(b_q, t), k decayed to b_1, b_2, b_3, the diagonal
// blocks' channels 0..31, the cross-sub-chunk scores, and y = (r . P(c, .))
// S_c + A V on wgmma.  Warpgroup 1: P(t + 1, b_q + 16) backwards, the three
// pieces of k decayed to the chunk's end, the diagonal blocks' channels
// 32..63, and the state, which lives in its wgmma accumulator.  Each pass
// loads what it needs before it stores, so that its loads are in flight
// together.
__global__ void __launch_bounds__(kThreads, 1)
    wkv_fwd_chunk(const Args a, const __grid_constant__ CUtensorMap tm_r,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_w) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* const sm = smem_raw + (base - smem_u32(smem_raw));  // base, generic address
  auto word = [sm](uint32_t off) { return *reinterpret_cast<const uint32_t*>(sm + off); };
  auto put = [sm](uint32_t off, uint32_t v) { *reinterpret_cast<uint32_t*>(sm + off) = v; };
  float* const g_sm = reinterpret_cast<float*>(sm + Smem::kG);
  float* const u_sm = reinterpret_cast<float*>(sm + Smem::kU);
  auto tile = [](int s, int x) { return Smem::kRing + (s * 4 + x) * kTile; };  // an offset
  auto full = [base](int s) { return base + Smem::kBar + 8 * s; };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, q = warp % 4;  // warpgroup, and sub-chunk (warp in it)
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int n_chunks = (a.T + kC - 1) / kC;
  const CUtensorMap* maps[4] = {&tm_r, &tm_k, &tm_v, &tm_w};

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (tid < kD) u_sm[tid] = a.u[(size_t)h * kD + tid];
  __syncthreads();
  if (tid == 0) {
    for (int n = 0; n < kStages && n < n_chunks; ++n) {
      mbar_expect_tx(full(n), 4 * kTile);
      for (int x = 0; x < 4; ++x) tma_load(base + tile(n, x), maps[x], full(n), 0, h, n * kC, b);
    }
  }

  // A wgmma accumulator: thread (warp q of its warpgroup, lane = 4 g + c)
  // holds row 16 q + g + 8 hh, column 8 jj + 2 c + e in acc[4 jj + 2 hh + e].
  // Warpgroup 1 keeps S there (S[i][j], i the row), warpgroup 0 each chunk's y.
  const int g = lane / 4, c4 = lane % 4;
  float acc[32];
  if (wg == 1) {
    const float* s0 = a.s0 ? a.s0 + (size_t)bh * kD * kD : nullptr;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          acc[4 * jj + 2 * hh + e] =
              s0 ? s0[(16 * q + g + 8 * hh) * kD + 8 * jj + 2 * c4 + e] : 0.f;
  }
  const int ch = 2 * lane;  // channels ch, ch + 1 in the decay pass
  float* const diag = reinterpret_cast<float*>(sm + Smem::kDiag + warp * Smem::kDiagWarp);
  const float* const diag_other =
      reinterpret_cast<const float*>(sm + Smem::kDiag + (warp ^ 4) * Smem::kDiagWarp);

  for (int n = 0; n < n_chunks; ++n) {
    const int stage = n % kStages, c0 = n * kC;
    const uint32_t t_r = tile(stage, 0), t_k = tile(stage, 1), t_v = base + tile(stage, 2),
                   t_w = tile(stage, 3);

    if (wg == 1) {  // S_c in bf16, the B operand of y's inter-chunk product (MN-major)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          put(Smem::kS + swizzle128(16 * q + g + 8 * hh, 8 * jj + 2 * c4),
              pack_bf16(acc[4 * jj + 2 * hh], acc[4 * jj + 2 * hh + 1]));
    }

    mbar_wait(full(stage), (n / kStages) & 1);

    // Decays of sub-chunk q at channels ch, ch + 1, running products of w (1
    // past T): warpgroup 0 P(b_q, t) forwards, and P(b_q, b_q + 16) to the
    // others; warpgroup 1 P(t + 1, b_q + 16) backwards.  Warpgroup 0 keeps
    // r (rv) and warpgroup 1 k (rv too) of its 16 steps for the operands.
    float2 pr_[kSub], rv[kSub], wv[kSub];
    {
#pragma unroll
      for (int tau = 0; tau < kSub; ++tau) {
        const uint32_t off = swizzle128(q * kSub + tau, ch);
        wv[tau] = unpack_bf16(word(t_w + off));
        rv[tau] = unpack_bf16(word((wg == 0 ? t_r : t_k) + off));
      }
#pragma unroll
      for (int tau = 0; tau < kSub; ++tau)
        if (c0 + q * kSub + tau >= a.T) wv[tau] = make_float2(1.f, 1.f);
      float2 run = make_float2(1.f, 1.f);
      if (wg == 0) {
#pragma unroll
        for (int tau = 0; tau < kSub; ++tau) {
          pr_[tau] = run;
          run.x *= wv[tau].x;
          run.y *= wv[tau].y;
        }
        *reinterpret_cast<float2*>(g_sm + q * kD + ch) = run;
      } else {
#pragma unroll
        for (int tau = kSub - 1; tau >= 0; --tau) {
          pr_[tau] = run;
          run.x *= wv[tau].x;
          run.y *= wv[tau].y;
        }
      }
    }
    __syncthreads();

    // The operands, from P(c, b_q), P(b_q + 16, c + C) and the sub-chunk
    // products between (each a product of whole sub-chunks' P).
    {
      float2 gq[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) gq[p] = *reinterpret_cast<const float2*>(g_sm + p * kD + ch);
      if (wg == 0) {
        float2 before = make_float2(1.f, 1.f);  // P(c, b_q)
#pragma unroll
        for (int p = 0; p < 3; ++p)
          if (p < q) before = make_float2(before.x * gq[p].x, before.y * gq[p].y);
#pragma unroll
        for (int tau = 0; tau < kSub; ++tau) {
          const uint32_t off = swizzle128(q * kSub + tau, ch);
          const float2 r = rv[tau], pf = pr_[tau];
          put(Smem::kRc + off, pack_bf16(r.x * (before.x * pf.x), r.y * (before.y * pf.y)));
          put(Smem::kRsub + off, pack_bf16(r.x * pf.x, r.y * pf.y));
        }
        // r . P(b_q + 8, t) for the second half of the sub-chunk, a running
        // product restarted at its first step
        float2 run = make_float2(1.f, 1.f);
#pragma unroll
        for (int tau = kSub / 2; tau < kSub; ++tau) {
          const float2 r = rv[tau];
          put(Smem::kRmid + swizzle128(q * kSub + tau, ch), pack_bf16(r.x * run.x, r.y * run.y));
          run.x *= wv[tau].x;
          run.y *= wv[tau].y;
        }
      } else {
        float2 after = make_float2(1.f, 1.f);  // P(b_q + 16, c + C)
#pragma unroll
        for (int p = 1; p < 4; ++p)
          if (p > q) after = make_float2(after.x * gq[p].x, after.y * gq[p].y);
#pragma unroll
        for (int tau = 0; tau < kSub; ++tau) {
          const uint32_t off = swizzle128(q * kSub + tau, ch);
          const float2 kd = make_float2(rv[tau].x * pr_[tau].x,
                                        rv[tau].y * pr_[tau].y);  // k . P(s + 1, b_q + 16)
          float hx, mx, lx, hy, my, ly;
          split3(kd.x * after.x, hx, mx, lx);
          split3(kd.y * after.y, hy, my, ly);
          put(Smem::kKe + off, pack_bf16(hx, hy));
          put(Smem::kKe + kTile + off, pack_bf16(mx, my));
          put(Smem::kKe + 2 * kTile + off, pack_bf16(lx, ly));
          float2 to = kd;  // k . P(s + 1, b_p), p = q + 1, q + 2, ...
#pragma unroll
          for (int p = 1; p < 4; ++p) {
            if (p <= q) continue;
            put(Smem::kKq + swizzle128(kq_row0(p) + q * kSub + tau, ch), pack_bf16(to.x, to.y));
            to = make_float2(to.x * gq[p].x, to.y * gq[p].y);
          }
        }
        // k . P(s + 1, b_q + 8) for the first half of the sub-chunk, a running
        // product backwards from its last step
        float2 run = make_float2(1.f, 1.f);
#pragma unroll
        for (int tau = kSub / 2 - 1; tau >= 0; --tau) {
          const float2 k = rv[tau];
          put(Smem::kKmid + swizzle128(q * 8 + tau, ch), pack_bf16(k.x * run.x, k.y * run.y));
          run.x *= wv[tau].x;
          run.y *= wv[tau].y;
        }
      }
    }

    // The diagonal 8 x 8 blocks of sub-chunk q in f32 (the block between
    // them goes to mma.sync below, factored at b_q + 8), over this
    // warpgroup's 32 channels: lane (pr, quarter) takes, in block pr / 4,
    // keys p = pr % 4 and 7 - p (7 steps in all) over channels 32 wg + 8
    // quarter .. + 7, one 16-byte chunk of the bf16 tiles a row; the
    // quarters' sums meet by shuffles, the two warpgroups' where A is read.
    {
      const int pr = lane / 4, qt = lane % 4, cq = 32 * wg + 8 * qt;
      const int blk = 8 * (pr / 4), p = pr % 4;
      const int s1 = blk + p, s2 = blk + 7 - p, switch_at = 7 - p;
      auto row8 = [&](uint32_t t_x, int t, float (&x)[8]) {
        unpack_bf16x8(*reinterpret_cast<const uint4*>(sm + t_x + swizzle128(q * kSub + t, cq)), x);
      };
      float kp[8], k2[8], uu[8], r8[8], out[7];
      row8(t_k, s1, kp);
      row8(t_k, s2, k2);
#pragma unroll
      for (int i = 0; i < 8; ++i) uu[i] = u_sm[cq + i];
      float bonus1 = 0.f, bonus2 = 0.f;
      row8(t_r, s1, r8);
#pragma unroll
      for (int i = 0; i < 8; ++i) bonus1 += r8[i] * uu[i] * kp[i];
      row8(t_r, s2, r8);
#pragma unroll
      for (int i = 0; i < 8; ++i) bonus2 += r8[i] * uu[i] * k2[i];
#pragma unroll
      for (int m = 0; m < 7; ++m) {
        // step m: key s1 at t = s1 + 1 + m until the switch, then key s2 at
        // t = blk + 1 + m; k_s . P(s + 1, t) = k_s . P(s + 1, t - 1) w_{t-1}
        const bool second = m >= switch_at;
        const int t = second ? blk + 1 + m : s1 + 1 + m;
        if (m > 0) {
          float w8[8];
          row8(t_w, t - 1, w8);
          const bool fresh = m == switch_at;
#pragma unroll
          for (int i = 0; i < 8; ++i) kp[i] = fresh ? k2[i] : kp[i] * w8[i];
        }
        row8(t_r, t, r8);
        out[m] = (r8[0] * kp[0] + r8[1] * kp[1] + r8[2] * kp[2] + r8[3] * kp[3]) +
                 (r8[4] * kp[4] + r8[5] * kp[5] + r8[6] * kp[6] + r8[7] * kp[7]);
      }
      // the quarters' sums; every lane of a quarter group then writes the
      // same value (no branch in the loop above)
      bonus1 += __shfl_xor_sync(0xffffffffu, bonus1, 1);
      bonus1 += __shfl_xor_sync(0xffffffffu, bonus1, 2);
      bonus2 += __shfl_xor_sync(0xffffffffu, bonus2, 1);
      bonus2 += __shfl_xor_sync(0xffffffffu, bonus2, 2);
#pragma unroll
      for (int m = 0; m < 7; ++m) {
        out[m] += __shfl_xor_sync(0xffffffffu, out[m], 1);
        out[m] += __shfl_xor_sync(0xffffffffu, out[m], 2);
      }
      diag[s1 * 17 + s1] = bonus1;
      diag[s2 * 17 + s2] = bonus2;
#pragma unroll
      for (int m = 0; m < 7; ++m) {
        const bool second = m >= switch_at;
        diag[(second ? blk + 1 + m : s1 + 1 + m) * 17 + (second ? s2 : s1)] = out[m];
      }
    }
    fence_proxy_async();  // the operands above, to the tensor cores
    __syncthreads();

    if (wg == 0) {
      // A's rows of this warp as wgmma's A fragments: earlier sub-chunks by
      // mma.sync from r . P(b_q, t) and k decayed to b_q; the diagonal
      // block from f32 (zero above the diagonal); later sub-chunks zero.
      uint32_t af[4][4];
      float sc[6][4], mid[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 6; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
      // the block between the diagonal 8 x 8 ones: rows b_q + 8 .. (the
      // fragment's rows g + 8; rows g are not used) against keys b_q ..
      // b_q + 7, through b_q + 8
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int arow = q * kSub + g;
        const uint32_t fa[4] = {word(Smem::kRmid + swizzle128(arow, 16 * kk + 2 * c4)),
                                word(Smem::kRmid + swizzle128(arow + 8, 16 * kk + 2 * c4)),
                                word(Smem::kRmid + swizzle128(arow, 16 * kk + 8 + 2 * c4)),
                                word(Smem::kRmid + swizzle128(arow + 8, 16 * kk + 8 + 2 * c4))};
        const int brow = q * 8 + g;
        mma_16816(mid, fa, word(Smem::kKmid + swizzle128(brow, 16 * kk + 2 * c4)),
                  word(Smem::kKmid + swizzle128(brow, 16 * kk + 8 + 2 * c4)));
      }
      if (q > 0) {
        const int arow = q * kSub + g;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t fa[4];
          fa[0] = word(Smem::kRsub + swizzle128(arow, 16 * kk + 2 * c4));
          fa[1] = word(Smem::kRsub + swizzle128(arow + 8, 16 * kk + 2 * c4));
          fa[2] = word(Smem::kRsub + swizzle128(arow, 16 * kk + 8 + 2 * c4));
          fa[3] = word(Smem::kRsub + swizzle128(arow + 8, 16 * kk + 8 + 2 * c4));
#pragma unroll
          for (int nt = 0; nt < 6; ++nt) {
            if (nt >= 2 * q) continue;
            const int brow = kq_row0(q) + 8 * nt + g;
            mma_16816(sc[nt], fa, word(Smem::kKq + swizzle128(brow, 16 * kk + 2 * c4)),
                      word(Smem::kKq + swizzle128(brow, 16 * kk + 8 + 2 * c4)));
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < q) {
          af[kk][0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
          af[kk][1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
          af[kk][2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
          af[kk][3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
        } else if (kk == q) {  // r: 0 and 3 the diagonal blocks, 1 between, 2 zero
#pragma unroll
          for (int r = 0; r < 4; r += 3) {
            const int row = g + 8 * (r & 1), col = 8 * (r >> 1) + 2 * c4;
            const int i0 = row * 17 + col;
            af[kk][r] = pack_bf16(col <= row ? diag[i0] + diag_other[i0] : 0.f,
                                  col + 1 <= row ? diag[i0 + 1] + diag_other[i0 + 1] : 0.f);
          }
          af[kk][1] = pack_bf16(mid[2], mid[3]);
          af[kk][2] = 0u;
        } else {
#pragma unroll
          for (int r = 0; r < 4; ++r) af[kk][r] = 0u;
        }
      }
      // y = (r . P(c, .)) S_c + A V
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_tb(acc, smem_desc(base + Smem::kRc + kk * 32, 16, 8 * kRowBytes),
                    smem_desc(base + Smem::kS + kk * 16 * kRowBytes, kTile, 8 * kRowBytes),
                    kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc, af[kk], smem_desc(t_v + kk * 16 * kRowBytes, kTile, 8 * kRowBytes));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      // y through shared memory, so that each row goes out in 16-byte stores
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          put(Smem::kY + swizzle128(16 * q + g + 8 * hh, 8 * jj + 2 * c4),
              pack_bf16(acc[4 * jj + 2 * hh], acc[4 * jj + 2 * hh + 1]));
    } else {
      // S <- P(c, c + C) S + (k . P(. + 1, c + C))^T V, in three pieces
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 16 * q + g + 8 * hh;
        const float decay = g_sm[i] * g_sm[kD + i] * g_sm[2 * kD + i] * g_sm[3 * kD + i];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          acc[4 * jj + 2 * hh] *= decay;
          acc[4 * jj + 2 * hh + 1] *= decay;
        }
      }
      wgmma_fence();
#pragma unroll
      for (int piece = 0; piece < 3; ++piece)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_ta_tb(acc,
                         smem_desc(base + Smem::kKe + piece * kTile + kk * 16 * kRowBytes, kTile,
                                   8 * kRowBytes),
                         smem_desc(t_v + kk * 16 * kRowBytes, kTile, 8 * kRowBytes));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncthreads();  // every read of this stage and of the operands is done
    if (tid == 0 && n + kStages < n_chunks) {
      mbar_expect_tx(full(stage), 4 * kTile);
      for (int x = 0; x < 4; ++x)
        tma_load(base + tile(stage, x), maps[x], full(stage), 0, h, (n + kStages) * kC, b);
    }
#pragma unroll
    for (int it = 0; it < kC * 8 / kThreads; ++it) {
      const int idx = it * kThreads + tid, row = idx / 8, chunk = idx % 8;
      if (c0 + row >= a.T) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(sm + Smem::kY + swizzle128(row, 8 * chunk));
      *reinterpret_cast<uint4*>(a.y + (((size_t)b * a.T + c0 + row) * a.H + h) * kD + 8 * chunk) =
          v;
    }
  }

  if (wg == 1) {
    float* const out = a.s_last + (size_t)bh * kD * kD;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(out + (16 * q + g + 8 * hh) * kD + 8 * jj + 2 * c4) =
            make_float2(acc[4 * jj + 2 * hh], acc[4 * jj + 2 * hh + 1]);
  }
}

}  // namespace

// The chunk route's entry point: bf16 at head dim 64; route() in kernel.py
// decides which launches come here.  s0 may be null (a zero state).  Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for arguments
// it does not take, or kTensorMapError | CUresult when a tensor map cannot
// be encoded (an address not 16-byte aligned, say).
extern "C" int rwkv6_wkv_fwd_chunk(const void* r, const void* k, const void* v, const void* w,
                                   const float* u, const float* s0, void* y, float* s_last,
                                   int B, int T, int H, int D, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || D != kD || (long long)B * H > 2147483647LL)
    return cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap maps[4];
  const void* ptrs[4] = {r, k, v, w};
  for (int x = 0; x < 4; ++x) {
    const CUresult res = encode(&maps[x], ptrs[x], B, T, H, kD, kC);
    if (res != CUDA_SUCCESS) return kTensorMapError | static_cast<int>(res);
  }
  cudaError_t err = cudaFuncSetAttribute(wkv_fwd_chunk,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Smem::kBytes);
  if (err != cudaSuccess) return err;
  const Args a{u, s0, static_cast<__nv_bfloat16*>(y), s_last, T, H};
  wkv_fwd_chunk<<<B * H, kThreads, Smem::kBytes, static_cast<cudaStream_t>(stream)>>>(
      a, maps[0], maps[1], maps[2], maps[3]);
  return cudaGetLastError();
}

// The message for any code the library's entry points return.
extern "C" const char* rwkv6_wkv_fwd_error_string(int err) {
  if (err & kTensorMapError)
    return "cuTensorMapEncodeTiled refused a tensor map (its CUresult is the code's low 16 bits)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
