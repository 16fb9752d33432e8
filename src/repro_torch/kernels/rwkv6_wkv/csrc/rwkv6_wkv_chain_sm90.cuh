// RWKV6 (Finch) WKV recurrence: the chained pass over chunks that both
// training routes share, on the Hopper tensor cores (sm_90a), bf16 inputs at
// head dim 64.
//
// Included by rwkv6_wkv_fwd_exact_sm90.cu (the forward of a gradient, route
// "chunk_exact") and rwkv6_wkv_bwd_sm90.cu (the backward, route "chunk");
// each library compiles its own copy.  Write P(a, b) for the product of w
// over the steps a <= tau < b, per channel (1 when a = b), and cut T into
// chunks of C = 64 steps, the chunk n covering c = 64 n <= t < e = c + 64.
// For each (b, h) the pass walks the chunks one after the other with a
// 64 x 64 f32 matrix X in a wgmma accumulator, in one of two directions:
//
//   dir 0, the state: X starts at s0 (or zeros), is written out at each
//     chunk's start (S_c, the state before step c), and then steps over the
//     chunk:   S_e = diag(P(c, e)) S_c + sum_s (k_s . P(s + 1, e)) v_s^T;
//     after the last chunk it is s_last.
//   dir 1, the gradient, from the last chunk to the first: X starts at
//     ds_last (or zeros), the gradient that reaches S_T, is written out at
//     each chunk's end (G_e, the gradient that reaches S_e) and then steps
//     back over it:   G_c = diag(P(c, e)) G_e + sum_t (r_t . P(c, t)) dy_t^T,
//     the gradient that reaches S_c; after the first chunk it is ds0.
//
// Both are one product a chunk on wgmma, (decayed operand)^T times a tile
// that is exact in bf16 (v or dy), accumulated into X in f32.  The decayed
// operand (k . P(s + 1, e) or r . P(c, t)) is not exact in bf16, so it goes
// in as a three-piece split (hi + mid + lo, each rounded to bf16: its 24
// bits), three products, as the forward's chunk route updates its state in
// rwkv6_wkv_fwd_sm90.cu; X thus follows the f32 recurrence to f32 rounding.
// Every P is a running product of w from the nearest boundary of a chunk or
// a sub-chunk of 16 steps, every factor at most 1: w exactly 0 (it is, now
// and then, in bf16) gives exactly 0, and nothing divides by w or takes its
// log.  Steps past T come in zero-filled (TMA) and take w = 1, so they leave
// X alone.
//
// One warpgroup a block walks one (b, h) in one direction (blockIdx.y), with
// the chunks' tiles coming in by TMA two chunks ahead.  What bounds it: per
// chunk three 64 x 64 x 64 products on the tensor cores, the decays and the
// split (a few hundred cycles), and writing X out (16 KB); 2 x 4096 x 64 x
// 64 at rwkv6-7b's train shape writes 134 MB a direction.  The chain over
// T / 64 chunks is the latency each block pays; the two directions and the
// B H heads run side by side.

#pragma once

#include "sm90.cuh"

namespace {
namespace chain {

constexpr int kD = 64;        // head dim
constexpr int kC = 64;        // steps a chunk
constexpr int kSub = 16;      // steps a sub-chunk: one warp each
constexpr int kThreads = 128; // one warpgroup
constexpr int kStages = 2;
constexpr int kTile = kC * kD * 2;  // one 64 x 64 bf16 tile, 8192 bytes

struct Args {
  const float* init[2];  // X's start in each direction: s0, ds_last (null: zeros)
  float* out[2];         // (B H, n_chunks, D, D): S at each chunk's start, G at its end
  float* last[2];        // X at the end: s_last (may be null), ds0 (may be null)
  int T, H;
};

// Byte offsets from a 1024-byte aligned base.
struct Smem {
  static constexpr int kRing = 0;                           // stage s, tile x: w, a, b
  static constexpr int kPieces = kRing + kStages * 3 * kTile;  // 3 pieces of the decayed a
  static constexpr int kG = kPieces + 3 * kTile;            // P(b_q, b_q + 16), 4 x 64 f32
  static constexpr int kBar = kG + 4 * kD * 4;              // one mbarrier a stage
  static constexpr int kBytes = kBar + 8 * kStages + 1024;  // + room to align the base
};

// A 32-bit word as two bf16 values (the first in the low half) in f32.
__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

// x = hi + mid + lo, each rounded to bf16: the three pieces hold x's 24 bits.
__device__ __forceinline__ void split3(float x, float& hi, float& mid, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(x));
  const float r1 = x - hi;
  mid = __bfloat162float(__float2bfloat16_rn(r1));
  lo = r1 - mid;
}

// The tensor maps: w, then a and b of each direction (k and v for the
// state, r and dy for the gradient).  A block of direction 0 reads
// tm_w, tm_a0, tm_b0; of direction 1 tm_w, tm_a1, tm_b1.
__global__ void __launch_bounds__(kThreads, 1)
    wkv_chain(const Args a, const __grid_constant__ CUtensorMap tm_w,
              const __grid_constant__ CUtensorMap tm_a0, const __grid_constant__ CUtensorMap tm_b0,
              const __grid_constant__ CUtensorMap tm_a1,
              const __grid_constant__ CUtensorMap tm_b1) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* const sm = smem_raw + (base - smem_u32(smem_raw));  // base, generic address
  auto word = [sm](uint32_t off) { return *reinterpret_cast<const uint32_t*>(sm + off); };
  auto put = [sm](uint32_t off, uint32_t v) { *reinterpret_cast<uint32_t*>(sm + off) = v; };
  float* const g_sm = reinterpret_cast<float*>(sm + Smem::kG);
  auto tile = [](int s, int x) { return Smem::kRing + (s * 3 + x) * kTile; };  // an offset
  auto full = [base](int s) { return base + Smem::kBar + 8 * s; };

  const int tid = threadIdx.x, q = tid / 32, lane = tid % 32;  // q: the warp, a sub-chunk
  const int dir = blockIdx.y;
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int n_chunks = (a.T + kC - 1) / kC;
  const CUtensorMap* maps[3] = {&tm_w, dir ? &tm_a1 : &tm_a0, dir ? &tm_b1 : &tm_b0};
  auto chunk_at = [dir, n_chunks](int it) { return dir ? n_chunks - 1 - it : it; };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int it = 0; it < kStages && it < n_chunks; ++it) {
      mbar_expect_tx(full(it), 3 * kTile);
      for (int x = 0; x < 3; ++x)
        tma_load(base + tile(it, x), maps[x], full(it), 0, h, chunk_at(it) * kC, b);
    }
  }

  // The accumulator: thread (warp q, lane = 4 g + c4) holds X[16 q + g + 8 hh]
  // [8 jj + 2 c4 + e] in acc[4 jj + 2 hh + e].
  const int g = lane / 4, c4 = lane % 4;
  float acc[32];
  {
    const float* init = a.init[dir] ? a.init[dir] + (size_t)bh * kD * kD : nullptr;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          acc[4 * jj + 2 * hh + e] =
              init ? init[(16 * q + g + 8 * hh) * kD + 8 * jj + 2 * c4 + e] : 0.f;
  }
  float* const out = a.out[dir] + (size_t)bh * n_chunks * kD * kD;
  const int ch = 2 * lane;  // channels ch, ch + 1 in the decay pass

  for (int it = 0; it < n_chunks; ++it) {
    const int n = chunk_at(it), stage = it % kStages, c0 = n * kC;
    const uint32_t t_w = tile(stage, 0), t_a = tile(stage, 1), t_b = base + tile(stage, 2);

    {  // X out: the state at the chunk's start, or the gradient at its end
      float* const o = out + (size_t)n * kD * kD;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(o + (16 * q + g + 8 * hh) * kD + 8 * jj + 2 * c4) =
              make_float2(acc[4 * jj + 2 * hh], acc[4 * jj + 2 * hh + 1]);
    }

    mbar_wait(full(stage), (it / kStages) & 1);

    // Sub-chunk q at channels ch, ch + 1: w (1 past T) and a of its 16
    // steps, a running product of w across it (backwards for the state:
    // P(t + 1, b_q + 16); forwards for the gradient: P(b_q, t)), and its
    // whole product P(b_q, b_q + 16) to the other warps.
    float2 pr_[kSub], av[kSub], wv[kSub];
#pragma unroll
    for (int tau = 0; tau < kSub; ++tau) {
      const uint32_t off = swizzle128(q * kSub + tau, ch);
      wv[tau] = unpack2(word(t_w + off));
      av[tau] = unpack2(word(t_a + off));
    }
#pragma unroll
    for (int tau = 0; tau < kSub; ++tau)
      if (c0 + q * kSub + tau >= a.T) wv[tau] = make_float2(1.f, 1.f);
    float2 run = make_float2(1.f, 1.f);
    if (dir == 0) {
#pragma unroll
      for (int tau = kSub - 1; tau >= 0; --tau) {
        pr_[tau] = run;
        run.x *= wv[tau].x;
        run.y *= wv[tau].y;
      }
    } else {
#pragma unroll
      for (int tau = 0; tau < kSub; ++tau) {
        pr_[tau] = run;
        run.x *= wv[tau].x;
        run.y *= wv[tau].y;
      }
    }
    *reinterpret_cast<float2*>(g_sm + q * kD + ch) = run;
    __syncthreads();

    // The decayed a in three pieces: k . P(s + 1, b_q + 16) P(b_q + 16, e),
    // or r . P(b_q, t) P(c, b_q), each P a product of whole sub-chunks' P.
    {
      float2 other = make_float2(1.f, 1.f);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (dir == 0 ? p <= q : p >= q) continue;
        const float2 gp = *reinterpret_cast<const float2*>(g_sm + p * kD + ch);
        other = make_float2(other.x * gp.x, other.y * gp.y);
      }
#pragma unroll
      for (int tau = 0; tau < kSub; ++tau) {
        const uint32_t off = swizzle128(q * kSub + tau, ch);
        const float2 d = make_float2(av[tau].x * pr_[tau].x, av[tau].y * pr_[tau].y);
        float hx, mx, lx, hy, my, ly;
        split3(d.x * other.x, hx, mx, lx);
        split3(d.y * other.y, hy, my, ly);
        put(Smem::kPieces + off, pack_bf16(hx, hy));
        put(Smem::kPieces + kTile + off, pack_bf16(mx, my));
        put(Smem::kPieces + 2 * kTile + off, pack_bf16(lx, ly));
      }
    }
    fence_proxy_async();  // the pieces, to the tensor cores
    __syncthreads();

    // X <- diag(P(c, e)) X + (decayed a)^T b, in three pieces
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
                       smem_desc(base + Smem::kPieces + piece * kTile + kk * 16 * kRowBytes,
                                 kTile, 8 * kRowBytes),
                       smem_desc(t_b + kk * 16 * kRowBytes, kTile, 8 * kRowBytes));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every read of this stage, of the pieces and of g_sm is done
    if (tid == 0 && it + kStages < n_chunks) {
      mbar_expect_tx(full(stage), 3 * kTile);
      for (int x = 0; x < 3; ++x)
        tma_load(base + tile(stage, x), maps[x], full(stage), 0, h, chunk_at(it + kStages) * kC,
                 b);
    }
  }

  if (a.last[dir]) {
    float* const o = a.last[dir] + (size_t)bh * kD * kD;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(o + (16 * q + g + 8 * hh) * kD + 8 * jj + 2 * c4) =
            make_float2(acc[4 * jj + 2 * hh], acc[4 * jj + 2 * hh + 1]);
  }
}

// Launches the pass in `dirs` directions (1: the state only; 2: both).
// The maps are those of encode() with kC-row boxes; `out` and `last` as
// Args.  Returns the first CUDA error.
inline cudaError_t launch_chain(const Args& a, int BH, int dirs, const CUtensorMap* maps,
                                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(wkv_chain, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Smem::kBytes);
  if (err != cudaSuccess) return err;
  wkv_chain<<<dim3(BH, dirs), kThreads, Smem::kBytes, stream>>>(a, maps[0], maps[1], maps[2],
                                                               maps[3], maps[4]);
  return cudaGetLastError();
}

}  // namespace chain
}  // namespace
