// RWKV6 (Finch) WKV recurrence, backward, in chunks for Hopper (sm_90a):
// the "chunk" route of rwkv6_wkv_bwd, which bwd_route() in kernel.py sends
// bf16 at head dim 64 and T >= 2 to (rwkv6-7b's training); the rest (f32,
// head dims 8, 16 and 32, T = 1) stays on rwkv6_wkv_bwd.cu's "recurrent"
// route.  Like that kernel it is the gradient of the forward, which the
// Pallas TPU kernel
//   src/repro/kernels/rwkv6_wkv/kernel.py :: rwkv6_wkv_kernel
// does not have (on the TPU jax.grad differentiates the plain recurrence,
// src/repro/kernels/rwkv6_wkv/ref.py :: rwkv6_reference).  It computes what
// ref.py :: rwkv6_wkv_bwd_reference computes, with S_t the state before
// step t and G_t the gradient that reaches S_{t+1}:
//   dr_t[i] = sum_j S_t[i][j] dy_t[j] + u[i] k_t[i] (v_t . dy_t)
//   dk_t[i] = u[i] r_t[i] (v_t . dy_t) + sum_j G_t[i][j] v_t[j]
//   dv_t[j] = dy_t[j] sum_i u[i] r_t[i] k_t[i] + sum_i k_t[i] G_t[i][j]
//   dw_t[i] = sum_j S_t[i][j] G_t[i][j]
//   G_{t-1} = diag(w_t) G_t + r_t dy_t^T,  ds0 = G_{-1},
// du[h][i] = sum over b and t of r_t[i] k_t[i] (v_t . dy_t).
//
// Three launches:
//   wkv_chain (rwkv6_wkv_chain_sm90.cuh), both directions side by side: S
//     at each 64-step chunk's start, and G at each chunk's end, chained over
//     the chunks on the tensor cores with f32 accumulators, the decayed
//     operands split in three bf16 pieces; its last G is ds0.
//   wkv_bwd_chunk, one block of two warpgroups a (b, h, chunk): 8192
//     independent jobs at the train shape, described below.
//   wkv_bwd_du_chunks sums the jobs' du partials over b and the chunks in order.
//
// A job.  Write P(a, b) for the product of w over a <= tau < b (1 if a = b)
// and cut the chunk into four sub-chunks of 16 steps, q from b_q to e_q =
// b_q + 16.  Within sub-chunk q, for t in it, with S_b = S_{b_q} and G_E the
// gradient that reaches S_{e_q}:
//   S_t = P(b_q, t) S_b + sum_{s<t} P(s + 1, t) k_s v_s^T
//   G_t = P(t + 1, e_q) G_E + sum_{s'>t} P(t + 1, s') r_s' dy_s'^T
// so every output is a product of a boundary matrix with a tile that is
// exact in bf16, plus sums over the 16 steps of the sub-chunk (u terms
// aside; M[a][b] = dy_a . v_b; A[s'][t] = sum_i r_s'[i] k_t[i] P(t + 1,
// s')[i], the forward's score):
//   dr_t = P(b_q, t) X_t + sum_{s<t} P(s + 1, t) k_s M[t][s],     X_t = S_b dy_t
//   dk_t = P(t + 1, e_q) Y_t + sum_{s'>t} P(t + 1, s') r_s' M[s'][t],  Y_t = G_E v_t
//   dv_t = Z_t + sum_{s'>t} A[s'][t] dy_s',     Z_t = G_E^T (k_t . P(t + 1, e_q))
//   dw_t = P(b_q, t) P(t + 1, e_q) (S_b . G_E over the row)
//        + P(b_q, t) sum_{s'>t} P(t + 1, s') r_s' X_s'
//        + P(t + 1, e_q) sum_{s<t} P(s + 1, t) k_s Y_s
//        + sum_{s<t<s'} P(s + 1, t) P(t + 1, s') k_s r_s' M[s'][s].
// P(b_q, t) P(t + 1, e_q) is two running products, never P(b_q, e_q) /
// w_t: w is exactly 0 at times.
//
// On the tensor cores (wgmma, f32 accumulators), each operand that is not
// exact in bf16 split in three bf16 pieces: M = dY V^T; warpgroup 0 chains
// S_b over the sub-chunks from S_c (as the chain chains chunks) and takes X
// with S_b's pieces in registers as the A operand; warpgroup 1 chains G_E
// from G_e (the decayed r built in registers) and takes Y with G_E's pieces
// in registers and Z with G_E^T's, read transposed (ldmatrix) from the
// pieces it writes to shared memory (Z's decayed k split too: six of the
// nine piece products, the three dropped below 2^-24 of it).  The chain
// step goes first and the small products go to accumulators of their own a
// piece, so that few wait on the one before; X, Y and Z go to shared memory
// a sub-chunk at a time.  On the CUDA cores in f32: the row sums S_b . G_E
// (warpgroup 1 from G_E's pieces, which hold its 24 bits, beside S_b;
// warpgroup 0 the last sub-chunk's, beside G_e); A, by warpgroup 0 once its
// chain is done; then the sums over each sub-chunk, one thread a
// (sub-chunk, channel) walking its 16 steps with running products (the
// triple sum by a carried vector of 16 partial sums), and dv's, one thread a
// (sub-chunk, column).  Every output is thus the f32 recurrence's value to
// f32 rounding, summed in another order, rounded once to bf16 (dr, dk, dv,
// dw) or kept in f32 (du, ds0).  Nothing is summed by atomics and every sum
// runs in a fixed order: two calls on the same inputs give the same bits.
// Steps past T come in zero-filled (TMA) and take w = 1, so they leave every
// state alone, and nothing is written for them.  No load that feeds a
// product's registers sits behind a branch: ptxas would serialize every
// wgmma of the kernel.
//
// What bounds it.  At rwkv6-7b's train shape (2, 4096, 64, 64) in bf16 the
// function reads r, k, v, w and dy (5 x 67.1 MB) and writes dr, dk, dv and
// dw (4 x 67.1 MB): 604 MB, 0.18 ms at 3.35 TB/s; the scratch of S_c and G_e
// adds 2 x 134 MB written and read once.  Its products are about 1.0e10 FLOP
// in the chain and 5.0e6 multiply-adds of bf16 pieces a job in the jobs (8.2e10
// FLOP), 0.09 ms on the tensor cores.  What holds a job is its chain of
// dependent steps at 8 warps an SM (one block an SM: 227 KB of shared
// memory): the two warpgroups' passes over the sub-chunks, each a few
// hundred cycles of splits and stores around its products, then the walk
// over the sub-chunk's steps.

#include <math.h>

#include "sm90.cuh"
#include "rwkv6_wkv_chain_sm90.cuh"

namespace {

constexpr int kD = chain::kD;
constexpr int kC = chain::kC;
constexpr int kSub = chain::kSub;  // 16 steps: four sub-chunks a chunk
constexpr int kTile = chain::kTile;
constexpr int kJobThreads = 256;   // two warpgroups
constexpr int kState = kD * kD * 4;  // one 64 x 64 f32 matrix
enum { kR, kK, kV, kW, kDy, kInputs };  // the tiles, in this order

struct JobArgs {
  const float* u;
  const float* states;  // (B H, n_chunks, D, D): S at each chunk's start
  const float* grads;   // (B H, n_chunks, D, D): G at each chunk's end
  __nv_bfloat16* out[4];  // dr, dk, dv, dw (B, T, H, D)
  float* du_part;       // (B H, n_chunks, D)
  int T, H;
};
enum { kOutDr, kOutDk, kOutDv, kOutDw };

// Byte offsets from a 1024-byte aligned base.
struct JobSmem {
  static constexpr int kIn = 0;                     // tile x at kIn + x kTile
  static constexpr int kKt = kIn + kInputs * kTile;  // 3 pieces of k_s . P(s + 1, e_q)
  static constexpr int kGp = kKt + 3 * kTile;        // 3 pieces of G_E, one sub-chunk's
  static constexpr int kXs = kGp + 3 * kTile;        // X, f32 [t][64]
  static constexpr int kYs = kXs + kC * kD * 4;      // Y, f32 [t][64]
  static constexpr int kZs = kYs + kC * kD * 4;      // Z, f32 [t][64]
  static constexpr int kSf = kZs + kC * kD * 4;      // S_b of sub-chunks 1, 2, f32 [i][j]
  static constexpr int kM = kSf + 2 * kState;        // [q][a][b]: dy_a . v_b
  static constexpr int kA = kM + 4 * kSub * kSub * 4;  // [q][s'][t]: the scores
  static constexpr int kDec = kA + 4 * kSub * kSub * 4;  // [q][64]: P(b_q, e_q)
  static constexpr int kT1 = kDec + 4 * kD * 4;       // [q][64]: S_b . G_E over a row
  static constexpr int kUrk = kT1 + 4 * kD * 4;       // [64]: sum_i u r_t k_t a step
  static constexpr int kU = kUrk + kC * 4;            // [64]
  static constexpr int kBar = kU + kD * 4;
  static constexpr int kBytes = kBar + 8 + 1024;      // + room to align the base
  static constexpr int kDu = kDec;                    // [q][64]: du's partials, at the end
};
static_assert(JobSmem::kBytes <= 232448, "one block an SM");

__device__ __forceinline__ float bf16_at(const uint8_t* p) {
  return __uint_as_float(static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) << 16);
}

// Eight bf16 values (16 bytes) in f32.
__device__ __forceinline__ void unpack8(const uint4& v, float (&x)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// S_b of sub-chunk q (1, 2) is in shared memory: the state pass arrives at
// named barrier 4 + q, the gradient pass waits there.
__device__ __forceinline__ void state_ready(int q) {
  asm volatile("bar.arrive %0, 256;" ::"r"(4 + q) : "memory");
}
__device__ __forceinline__ void wait_state(int q) {
  asm volatile("bar.sync %0, 256;" ::"r"(4 + q) : "memory");
}

// Joins the 128 threads of one warpgroup (named barrier 2 + wg).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
}

#define D8 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])

// O (64 x 16) = A (64 x 16) B^T (+ O if accumulate), A in registers, B 16
// rows K-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : D8
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

#undef D8

// Four 8 x 8 bf16 matrices from shared memory, transposed (ldmatrix): lane
// l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The three bf16 pieces of a 64 x 64 f32 accumulator as wgmma A fragments,
// piece p, k-step kk (the pairs (8 kk + 2 r, 8 kk + 2 r + 1)).
__device__ __forceinline__ void split_fragments(const float (&acc)[32], uint32_t (&ap)[3][4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float h0, m0, l0, h1, m1, l1;
      chain::split3(acc[8 * kk + 2 * r], h0, m0, l0);
      chain::split3(acc[8 * kk + 2 * r + 1], h1, m1, l1);
      ap[0][kk][r] = pack_bf16(h0, h1);
      ap[1][kk][r] = pack_bf16(m0, m1);
      ap[2][kk][r] = pack_bf16(l0, l1);
    }
}

// The six piece products of Z that are kept, z = 0 .. 5: the piece of G_E
// (hi, hi, mid, hi, lo, mid) and of the decayed k (hi, mid, hi, lo, hi, mid).
__device__ constexpr int z_piece_g(int z) { return z == 2 || z == 5 ? 1 : z == 4 ? 2 : 0; }
__device__ constexpr int z_piece_k(int z) { return z == 1 || z == 5 ? 1 : z == 3 ? 2 : 0; }

__global__ void __launch_bounds__(kJobThreads, 1)
    wkv_bwd_chunk(const JobArgs a, const __grid_constant__ CUtensorMap tm_r,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_w,
                  const __grid_constant__ CUtensorMap tm_dy) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* const sm = smem_raw + (base - smem_u32(smem_raw));  // base, generic address
  auto put = [sm](uint32_t off, uint32_t v) { *reinterpret_cast<uint32_t*>(sm + off) = v; };
  auto f32 = [sm](int off) { return reinterpret_cast<float*>(sm + off); };
  const uint32_t bar = base + JobSmem::kBar;

  const int n_chunks = (a.T + kC - 1) / kC;
  const int bh = blockIdx.x / n_chunks, n = blockIdx.x - bh * n_chunks;
  const int b = bh / a.H, h = bh - b * a.H, c0 = n * kC;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, wq = warp % 4;  // warpgroup, warp in it
  const int g = lane / 4, c4 = lane % 4;   // the accumulator's row and column pair

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (tid < kD) f32(JobSmem::kU)[tid] = a.u[(size_t)h * kD + tid];
  __syncthreads();
  if (tid == 0) {
    const CUtensorMap* maps[kInputs] = {&tm_r, &tm_k, &tm_v, &tm_w, &tm_dy};
    mbar_expect_tx(bar, kInputs * kTile);
    for (int x = 0; x < kInputs; ++x)
      tma_load(base + JobSmem::kIn + x * kTile, maps[x], bar, 0, h, c0, b);
  }

  // The accumulator (thread (warp wq, lane 4 g + c4) holds row 16 wq + g + 8
  // hh, columns 8 jj + 2 c4 + e in acc[4 jj + 2 hh + e]): warpgroup 0 S_c,
  // warpgroup 1 G_e, while the tiles come in.
  const size_t chunk_at = ((size_t)bh * n_chunks + n) * kD * kD;
  float acc[32];
  {
    const float* src = (wg == 0 ? a.states : a.grads) + chunk_at;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 v =
            *reinterpret_cast<const float2*>(src + (16 * wq + g + 8 * hh) * kD + 8 * jj + 2 * c4);
        acc[4 * jj + 2 * hh] = v.x;
        acc[4 * jj + 2 * hh + 1] = v.y;
      }
  }
  mbar_wait(bar, 0);

  auto tile_at = [&](int x, int t, int col) {
    return bf16_at(sm + JobSmem::kIn + x * kTile + swizzle128(t, col));
  };
  auto row8 = [&](int x, int t, int col, float (&o)[8]) {
    unpack8(*reinterpret_cast<const uint4*>(sm + JobSmem::kIn + x * kTile + swizzle128(t, col)), o);
  };
  auto valid = [&](int t) { return c0 + t < a.T; };
  auto w8_at = [&](int t, int col, float (&o)[8]) {
    row8(kW, t, col, o);
    if (!valid(t))
#pragma unroll
      for (int x = 0; x < 8; ++x) o[x] = 1.f;
  };

  auto desc_k = [&](int off) { return smem_desc(base + off, 16, 8 * kRowBytes); };  // K-major
  auto desc_mn = [&](int off) { return smem_desc(base + off, kTile, 8 * kRowBytes); };  // MN-major
  if (wg == 0) {
    // M = dY V^T over the chunk on the tensor cores (both exact in bf16); its
    // diagonal 16 x 16 blocks, M[q][a][b] = dy_a . v_b, are warp q's rows.
    float m[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(m, desc_k(JobSmem::kIn + kDy * kTile + kk * 32),
               desc_k(JobSmem::kIn + kV * kTile + kk * 32), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(m);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      if (jj / 2 == wq)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(f32(JobSmem::kM) +
                                     (wq * kSub + g + 8 * hh) * kSub + 8 * (jj % 2) + 2 * c4) =
              make_float2(m[4 * jj + 2 * hh], m[4 * jj + 2 * hh + 1]);
  } else {  // u r . k of step t, two threads a step (channel halves)
    const int t = (tid - 128) / 2, half = tid % 2;
    float s = 0.f;
#pragma unroll 1
    for (int p = 4 * half; p < 4 * half + 4; ++p) {
      float r8[8], k8[8];
      row8(kR, t, 8 * p, r8);
      row8(kK, t, 8 * p, k8);
#pragma unroll
      for (int x = 0; x < 8; ++x) s = fmaf(f32(JobSmem::kU)[8 * p + x] * r8[x], k8[x], s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (half == 0) f32(JobSmem::kUrk)[t] = s;
  }

  {  // warp wq of each warpgroup, sub-chunk wq at channel ch: k_s . P(s + 1,
     // e_q) in three pieces, P a running product backwards across it, and
     // the whole P(b_q, e_q)
    const int ch = 32 * wg + lane;
    float run = 1.f;
#pragma unroll
    for (int tau = kSub - 1; tau >= 0; --tau) {
      const uint32_t off = swizzle128(wq * kSub + tau, ch);
      const float w = bf16_at(sm + JobSmem::kIn + kW * kTile + off);
      const float kd = bf16_at(sm + JobSmem::kIn + kK * kTile + off) * run;
      float hi, mid, lo;
      chain::split3(kd, hi, mid, lo);
      *reinterpret_cast<__nv_bfloat16*>(sm + JobSmem::kKt + off) = __float2bfloat16_rn(hi);
      *reinterpret_cast<__nv_bfloat16*>(sm + JobSmem::kKt + kTile + off) = __float2bfloat16_rn(mid);
      *reinterpret_cast<__nv_bfloat16*>(sm + JobSmem::kKt + 2 * kTile + off) =
          __float2bfloat16_rn(lo);
      run *= valid(wq * kSub + tau) ? w : 1.f;
    }
    f32(JobSmem::kDec)[wq * kD + ch] = run;
  }
  fence_proxy_async();  // the pieces, to the tensor cores
  __syncthreads();

  auto decay_rows = [&](const float (&dec)[2]) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        acc[4 * jj + 2 * hh] *= dec[hh];
        acc[4 * jj + 2 * hh + 1] *= dec[hh];
      }
    }
  };
  auto store_f32 = [&](int off) {  // the accumulator to a [row][col] f32 matrix
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(f32(off) + (16 * wq + g + 8 * hh) * kD + 8 * jj + 2 * c4) =
            make_float2(acc[4 * jj + 2 * hh], acc[4 * jj + 2 * hh + 1]);
  };
  // An m64n16 accumulator (rows = channels, columns = the sub-chunk's steps)
  // to a [t][64] f32 matrix.
  auto store_n16 = [&](const float (&d)[8], int off, int q) {
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          f32(off)[(q * kSub + 8 * jj + 2 * c4 + e) * kD + 16 * wq + g + 8 * hh] =
              d[4 * jj + 2 * hh + e];
  };

  // X (warpgroup 0), Y and Z (1) of each sub-chunk come out of m64n16
  // accumulators (rows the channels, columns its steps) to shared memory.
  uint32_t ap[3][4][4];
  if (wg == 0) {
    // S_b of each sub-chunk: X_t = S_b dy_t for its steps, staged, then S_b
    // <- P(b_q, e_q) S_b + (k . P(. + 1, e_q))^T V over its 16 steps (at q =
    // 3 too: S_b is not read after it).
    float x[3][8];
#pragma unroll 1
    for (int q = 0; q < 4; ++q) {
      if (q == 1 || q == 2) {
        store_f32(JobSmem::kSf + (q - 1) * kState);
        state_ready(q);
      }
      if (q == 3) {  // S_b . G_E over rows 16 wq + g + 8 hh of the last sub-chunk: G_E is G_e
        const float* ge = a.grads + chunk_at;
        float rows[2] = {0.f, 0.f};
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float2 gv = *reinterpret_cast<const float2*>(
                ge + (16 * wq + g + 8 * hh) * kD + 8 * jj + 2 * c4);
            rows[hh] = fmaf(acc[4 * jj + 2 * hh], gv.x, rows[hh]);
            rows[hh] = fmaf(acc[4 * jj + 2 * hh + 1], gv.y, rows[hh]);
          }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          rows[hh] += __shfl_xor_sync(0xffffffffu, rows[hh], 1);
          rows[hh] += __shfl_xor_sync(0xffffffffu, rows[hh], 2);
          if (c4 == 0) f32(JobSmem::kT1)[3 * kD + 16 * wq + g + 8 * hh] = rows[hh];
        }
      }
      split_fragments(acc, ap);
      const float dec[2] = {f32(JobSmem::kDec)[q * kD + 16 * wq + g],
                            f32(JobSmem::kDec)[q * kD + 16 * wq + g + 8]};
      decay_rows(dec);
      // the advance first, then X in an accumulator a piece, in turns
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < 3; ++p)
        wgmma_ss_ta_tb(acc, desc_mn(JobSmem::kKt + p * kTile + q * kSub * kRowBytes),
                       desc_mn(JobSmem::kIn + kV * kTile + q * kSub * kRowBytes));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = 0; p < 3; ++p)
          wgmma_rs_n16(x[p], ap[p][kk],
                       desc_k(JobSmem::kIn + kDy * kTile + q * kSub * kRowBytes + kk * 32), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      float xs[8];
#pragma unroll
      for (int p = 0; p < 3; ++p) fence_regs(x[p]);
#pragma unroll
      for (int e = 0; e < 8; ++e) xs[e] = (x[2][e] + x[1][e]) + x[0][e];
      store_n16(xs, JobSmem::kXs, q);
    }
    {  // while the gradient pass runs, A[q][s'][t] for s' > t: lane (pair pr,
       // quarter e4) takes t = pr and t = 15 - pr (15 keys in all) over
       // channels 16 e4 .. 16 e4 + 15; the quarters meet by shuffles
      const int q = tid / 32, pr = (tid / 4) % 8, e4 = tid % 4;
      float k1[16], k2[16], run[16];
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        row8(kK, q * kSub + pr, 16 * e4 + 8 * h8, *reinterpret_cast<float(*)[8]>(k1 + 8 * h8));
        row8(kK, q * kSub + kSub - 1 - pr, 16 * e4 + 8 * h8,
             *reinterpret_cast<float(*)[8]>(k2 + 8 * h8));
      }
#pragma unroll
      for (int x = 0; x < 16; ++x) run[x] = 1.f;
#pragma unroll 1
      for (int m = 0; m < kSub - 1; ++m) {
        const bool second = m >= kSub - 1 - pr;  // then t = 15 - pr, s' = m + 1
        const int sp = second ? m + 1 : pr + 1 + m, t = second ? kSub - 1 - pr : pr;
        if (m == kSub - 1 - pr)
#pragma unroll
          for (int x = 0; x < 16; ++x) run[x] = 1.f;
        float s = 0.f;
#pragma unroll
        for (int h8 = 0; h8 < 2; ++h8) {
          float r8[8], w8[8];
          row8(kR, q * kSub + sp, 16 * e4 + 8 * h8, r8);
          w8_at(q * kSub + sp, 16 * e4 + 8 * h8, w8);
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            s = fmaf((second ? k2[8 * h8 + x] : k1[8 * h8 + x]) * run[8 * h8 + x], r8[x], s);
            run[8 * h8 + x] *= w8[x];
          }
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (e4 == 0) f32(JobSmem::kA)[(q * kSub + sp) * kSub + t] = s;
      }
    }
  } else {
    // G_E of each sub-chunk, from the last: Y_t = G_E v_t and Z_t = G_E^T
    // (k_t . P(t + 1, e_q)) for its steps, staged, then G_E <- P(b_q, e_q)
    // G_E + (r . P(b_q, .))^T dY over its 16 steps, the decayed r built in
    // registers as wgmma's A fragments.
    // r_t . P(b_q, t) at this thread's fragment of sub-chunk q (rows 16 wq + g
    // + 8 hh, steps 2 c4, 2 c4 + 1, 2 c4 + 8, 2 c4 + 9) in three pieces, P a
    // running product forwards, and the whole P(b_q, e_q) of its rows
    auto r_fragments = [&](int q, uint32_t (&rf)[3][4], float (&dec)[2]) {
      float rd[2][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 16 * wq + g + 8 * hh;
        float pr[kSub], run = 1.f;
#pragma unroll
        for (int tau = 0; tau < kSub; ++tau) {
          const float w = tile_at(kW, q * kSub + tau, i);  // read first: no branch
          pr[tau] = run;
          run *= valid(q * kSub + tau) ? w : 1.f;
        }
        dec[hh] = run;
#pragma unroll
        for (int x = 0; x < 4; ++x) {  // step 2 c4 + x % 2 + 8 (x / 2), picked without a branch
          const int o = x % 2 + 8 * (x / 2);
          const float p = c4 == 0 ? pr[o] : c4 == 1 ? pr[o + 2] : c4 == 2 ? pr[o + 4] : pr[o + 6];
          rd[hh][x] = p * tile_at(kR, q * kSub + 2 * c4 + o, i);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float h0, m0, l0, h1, m1, l1;
        chain::split3(rd[r % 2][(r / 2) * 2], h0, m0, l0);
        chain::split3(rd[r % 2][(r / 2) * 2 + 1], h1, m1, l1);
        rf[0][r] = pack_bf16(h0, h1);
        rf[1][r] = pack_bf16(m0, m1);
        rf[2][r] = pack_bf16(l0, l1);
      }
    };
    float y[3][8], z[3][8];
#pragma unroll 1
    for (int qq = 0; qq < 4; ++qq) {
      const int q = 3 - qq;
      split_fragments(acc, ap);  // G_E's pieces: Y's A fragments, and written out
      warpgroup_sync(1);  // the last sub-chunk's have been read
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // row 16 wq + g + 8 (r % 2), column 16 kk + 8 (r / 2) + 2 c4
          const uint32_t off =
              JobSmem::kGp + swizzle128(16 * wq + g + 8 * (r % 2), 16 * kk + 8 * (r / 2) + 2 * c4);
#pragma unroll
          for (int p = 0; p < 3; ++p) put(off + p * kTile, ap[p][kk][r]);
        }
      float dec[2];
      uint32_t rf[3][4];
      r_fragments(q, rf, dec);
      warpgroup_sync(1);  // every warp's pieces are written
      // G_E^T's pieces as wgmma A fragments (rows j = 16 wq .., k-step kk over
      // i), each 16 x 16 block read transposed
      uint32_t gt[3][4][4];
      {
        const int m = lane / 8, i = lane % 8 + 8 * (m / 2), j = 16 * wq + 8 * (m % 2);
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            ldsm_x4_trans(gt[p][kk], base + JobSmem::kGp + p * kTile + swizzle128(16 * kk + i, j));
      }
      decay_rows(dec);
      // the advance first (the next sub-chunk waits on it), then Y and Z in
      // accumulators of their own a piece (Y) or two piece products (Z),
      // issued in turns so that no product waits on the one before
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < 3; ++p)  // (at q = 0 too: G_E is not read after it)
        wgmma_rs(acc, rf[p], desc_mn(JobSmem::kIn + kDy * kTile + q * kSub * kRowBytes));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int p = 0; p < 3; ++p)
          wgmma_rs_n16(y[p], ap[p][kk],
                       desc_k(JobSmem::kIn + kV * kTile + q * kSub * kRowBytes + kk * 32), kk > 0);
#pragma unroll
        for (int zp = 0; zp < 6; ++zp)
          wgmma_rs_n16(
              z[zp % 3], gt[z_piece_g(zp)][kk],
              desc_k(JobSmem::kKt + z_piece_k(zp) * kTile + q * kSub * kRowBytes + kk * 32),
              kk > 0 || zp >= 3);
      }
      wgmma_commit();
      if (q < 3) {  // while they run: S_b . G_E over rows 16 wq + g + 8 hh, G_E
                    // from its pieces (hi + mid + lo: its 24 bits), S_b at the
                    // same places (the state pass takes the last sub-chunk's)
        if (q > 0) wait_state(q);
        const float* sb = q > 0 ? f32(JobSmem::kSf + (q - 1) * kState) : a.states + chunk_at;
        float rows[2] = {0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float2 hi = chain::unpack2(ap[0][kk][r]), mid = chain::unpack2(ap[1][kk][r]),
                         lo = chain::unpack2(ap[2][kk][r]);
            const float2 sv = *reinterpret_cast<const float2*>(
                sb + (16 * wq + g + 8 * (r % 2)) * kD + 16 * kk + 8 * (r / 2) + 2 * c4);
            rows[r % 2] = fmaf((hi.x + mid.x) + lo.x, sv.x, rows[r % 2]);
            rows[r % 2] = fmaf((hi.y + mid.y) + lo.y, sv.y, rows[r % 2]);
          }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          rows[hh] += __shfl_xor_sync(0xffffffffu, rows[hh], 1);
          rows[hh] += __shfl_xor_sync(0xffffffffu, rows[hh], 2);
          if (c4 == 0) f32(JobSmem::kT1)[q * kD + 16 * wq + g + 8 * hh] = rows[hh];
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        fence_regs(y[p]);
        fence_regs(z[p]);
      }
      float ys[8], zs[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        ys[x] = (y[2][x] + y[1][x]) + y[0][x];
        zs[x] = (z[0][x] + z[1][x]) + z[2][x];
      }
      store_n16(ys, JobSmem::kYs, q);
      store_n16(zs, JobSmem::kZs, q);
    }
  }
  __syncthreads();

  // Thread (sub-chunk q, channel i) walks its 16 steps: dr, dk, dw, du.
  const int q = tid / 64, i = tid % 64;
  const float* const Mq = f32(JobSmem::kM) + q * kSub * kSub;
  auto out_at = [&](int x, int t) {
    return a.out[x] + (((size_t)b * a.T + c0 + t) * a.H + h) * kD + i;
  };
  {
    float kv[kSub], rv[kSub], wv[kSub], X[kSub], Y[kSub];
#pragma unroll
    for (int tau = 0; tau < kSub; ++tau) {
      const int t = q * kSub + tau;
      kv[tau] = tile_at(kK, t, i);
      rv[tau] = tile_at(kR, t, i);
      wv[tau] = valid(t) ? tile_at(kW, t, i) : 1.f;
      X[tau] = f32(JobSmem::kXs)[t * kD + i];
      Y[tau] = f32(JobSmem::kYs)[t * kD + i];
    }
    const float rows = f32(JobSmem::kT1)[q * kD + i];  // S_b . G_E over row i
    const float ui = f32(JobSmem::kU)[i];
    // carried: c[s'] = sum_{s<t} P(s + 1, t) k_s M[s'][s] for s' >= t; Rs =
    // sum_{s<t} P(s + 1, t) k_s Y_s; pre = P(b_q, t)
    float c[kSub], Rs = 0.f, pre = 1.f, du = 0.f;
#pragma unroll
    for (int s = 0; s < kSub; ++s) c[s] = 0.f;
#pragma unroll
    for (int tau = 0; tau < kSub; ++tau) {
      float beta[kSub], run = 1.f;  // beta[s'] = P(t + 1, s') r_s'; run ends at P(t + 1, e_q)
#pragma unroll
      for (int sp = tau + 1; sp < kSub; ++sp) {
        beta[sp] = run * rv[sp];
        run *= wv[sp];
      }
      float t4 = 0.f, dki = 0.f, qx = 0.f;
#pragma unroll
      for (int sp = tau + 1; sp < kSub; ++sp) {
        t4 = fmaf(beta[sp], c[sp], t4);
        dki = fmaf(beta[sp], Mq[sp * kSub + tau], dki);
        qx = fmaf(beta[sp], X[sp], qx);
      }
      const float mtt = Mq[tau * kSub + tau];
      const float dr = fmaf(pre, X[tau], c[tau]) + ui * kv[tau] * mtt;
      const float dk = fmaf(run, Y[tau], dki) + ui * rv[tau] * mtt;
      const float dw = fmaf(pre * run, rows, fmaf(pre, qx, fmaf(run, Rs, t4)));
      du = fmaf(rv[tau] * kv[tau], mtt, du);
      if (valid(q * kSub + tau)) {
        *out_at(kOutDr, q * kSub + tau) = __float2bfloat16_rn(dr);
        *out_at(kOutDk, q * kSub + tau) = __float2bfloat16_rn(dk);
        *out_at(kOutDw, q * kSub + tau) = __float2bfloat16_rn(dw);
      }
#pragma unroll
      for (int sp = tau + 1; sp < kSub; ++sp)
        c[sp] = fmaf(wv[tau], c[sp], kv[tau] * Mq[sp * kSub + tau]);
      Rs = fmaf(wv[tau], Rs, kv[tau] * Y[tau]);
      pre *= wv[tau];
    }
    f32(JobSmem::kDu)[q * kD + i] = du;
  }
  {  // thread (sub-chunk q, column j = i): dv
    const float* const Aq = f32(JobSmem::kA) + q * kSub * kSub;
    float d[kSub];
#pragma unroll
    for (int tau = 0; tau < kSub; ++tau) d[tau] = tile_at(kDy, q * kSub + tau, i);
#pragma unroll
    for (int tau = 0; tau < kSub; ++tau) {
      const int t = q * kSub + tau;
      float s = fmaf(d[tau], f32(JobSmem::kUrk)[t], f32(JobSmem::kZs)[t * kD + i]);
#pragma unroll
      for (int sp = tau + 1; sp < kSub; ++sp) s = fmaf(Aq[sp * kSub + tau], d[sp], s);
      if (valid(t)) *out_at(kOutDv, t) = __float2bfloat16_rn(s);
    }
  }
  __syncthreads();
  if (tid < kD) {
    const float* du = f32(JobSmem::kDu);
    a.du_part[((size_t)bh * n_chunks + n) * kD + tid] =
        ((du[tid] + du[kD + tid]) + du[2 * kD + tid]) + du[3 * kD + tid];
  }
}

// du[h][i] = the jobs' partials summed over b, then the chunks, in order.
__global__ void __launch_bounds__(kD) wkv_bwd_du_chunks(const float* __restrict__ du_part,
                                                        float* __restrict__ du, int B, int H,
                                                        int n_chunks) {
  const int h = blockIdx.x, i = threadIdx.x;
  float sum = 0.f;
  for (int b = 0; b < B; ++b)
    for (int n = 0; n < n_chunks; ++n)
      sum += du_part[(((size_t)b * H + h) * n_chunks + n) * kD + i];
  du[(size_t)h * kD + i] = sum;
}

}  // namespace

// The chunk route's entry point: bf16 at head dim 64; bwd_route() in
// kernel.py decides which launches come here.  s0 and ds_last may be null
// (zeros).  states and grads are scratch of B H ceil(T / 64) D^2 floats
// each, du_part of B H ceil(T / 64) D (rwkv6_wkv_bwd_chunk_steps() gives
// the 64).  Returns cudaGetLastError() after the launches,
// cudaErrorInvalidValue for arguments it does not take, or kTensorMapError |
// CUresult when a tensor map cannot be encoded.
extern "C" int rwkv6_wkv_bwd_chunk(const void* r, const void* k, const void* v, const void* w,
                                   const float* u, const float* s0, const void* dy,
                                   const float* ds_last, void* dr, void* dk, void* dv, void* dw,
                                   float* du, float* ds0, float* states, float* grads,
                                   float* du_part, int B, int T, int H, int D, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || D != kD || (long long)B * H > 2147483647LL)
    return cudaErrorInvalidValue;
  const int n_chunks = (T + kC - 1) / kC;
  if ((long long)B * H * n_chunks > 2147483647LL) return cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap maps[kInputs];
  const void* ptrs[kInputs] = {r, k, v, w, dy};
  for (int x = 0; x < kInputs; ++x) {
    const CUresult res = encode(&maps[x], ptrs[x], B, T, H, kD, kC);
    if (res != CUDA_SUCCESS) return kTensorMapError | static_cast<int>(res);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  chain::Args ca{};
  ca.init[0] = s0;
  ca.init[1] = ds_last;
  ca.out[0] = states;
  ca.out[1] = grads;
  ca.last[0] = nullptr;
  ca.last[1] = ds0;
  ca.T = T;
  ca.H = H;
  const CUtensorMap chain_maps[5] = {maps[kW], maps[kK], maps[kV], maps[kR], maps[kDy]};
  cudaError_t err = chain::launch_chain(ca, B * H, 2, chain_maps, s);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wkv_bwd_chunk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             JobSmem::kBytes);
  if (err != cudaSuccess) return err;
  JobArgs ja{};
  ja.u = u;
  ja.states = states;
  ja.grads = grads;
  ja.out[kOutDr] = static_cast<__nv_bfloat16*>(dr);
  ja.out[kOutDk] = static_cast<__nv_bfloat16*>(dk);
  ja.out[kOutDv] = static_cast<__nv_bfloat16*>(dv);
  ja.out[kOutDw] = static_cast<__nv_bfloat16*>(dw);
  ja.du_part = du_part;
  ja.T = T;
  ja.H = H;
  wkv_bwd_chunk<<<B * H * n_chunks, kJobThreads, JobSmem::kBytes, s>>>(
      ja, maps[kR], maps[kK], maps[kV], maps[kW], maps[kDy]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv_bwd_du_chunks<<<H, kD, 0, s>>>(du_part, du, B, H, n_chunks);
  return cudaGetLastError();
}

extern "C" int rwkv6_wkv_bwd_chunk_steps() { return kC; }

extern "C" const char* rwkv6_wkv_bwd_chunk_error_string(int err) {
  if (err & kTensorMapError)
    return "cuTensorMapEncodeTiled refused a tensor map (its CUresult is the code's low 16 bits)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
