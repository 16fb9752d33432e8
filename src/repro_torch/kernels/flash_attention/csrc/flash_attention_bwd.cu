// Flash attention, backward, for NVIDIA Hopper (sm_90a).
//
// The gradient of what flash_attention_fwd computes.  The Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py :: flash_attention_kernel
// has no backward of its own: on the TPU jax.grad differentiates the plain
// chunked attention.  Here the forward is a kernel, so its gradient is one
// too.  Same masks (causal, sliding window, kv_len, q_offset), the same GQA
// mapping (query head h reads kv head h / (H / KH)) and the same scale
// 1 / sqrt(Dk) as the forward; a query row that sees no key gets dq = 0 and
// adds nothing to dk and dv.  Inputs f32 or bf16, every sum in f32, outputs
// rounded once to the inputs' type.
//
// Layout: q, dq (B, Sq, H, Dk); k, dk (B, Sk, KH, Dk); v, dv (B, Sk, KH, Dv);
// o, dout (B, Sq, H, Dv), all contiguous; lse and delta (B, H, Sq) f32, rows
// ld elements apart: lse as the forward wrote it (each row's log-sum-exp over
// the keys it sees, 0 where it sees none), delta a buffer the caller
// allocates.
//
// Three kernels, run in order on the caller's stream:
//   (a) delta = rowsum(dout * o), a warp a row, its own entry point
//       (flash_attention_bwd_delta), which the tensor-core route shares;
//   (b) dk, dv: one block per (kv tile, kv head, batch) walks the query
//       heads of its GQA group and the q tiles that can see the tile, with
//       P = exp(S - lse) under the masks and dS = P * (dP - delta), dP =
//       dout V^T, and keeps dv += P^T dout and dk += dS^T Q in registers, so
//       the group's sum needs no atomics;
//   (c) dq: one block per (q tile, head, batch) walks the visible kv tiles
//       and keeps dq += dS K in registers.
// (b) and (c) each recompute S and dP: seven products over the visible
// pairs where five would do, in exchange for no atomics and no buffer
// beyond delta.
//
// What bounds it.  At qwen3-1.7b's train shape (q 8x1024x16x128, k/v
// 8x1024x8x128, bf16, causal) the gradient needs five products over the
// 6.7e7 visible pairs, 8.6e10 FLOP, against about 200 MB of inputs and
// outputs: the card's floor is set by operations (0.087 ms at 989 TFLOP/s
// bf16).  This kernel runs its products on the CUDA cores in f32 (fmaf), as
// the forward's SIMT route does, so its ceiling is the f32 FMA rate and the
// shared memory that feeds it: each thread keeps a register tile of each
// product so that a value read from shared memory feeds several FMAs, and
// rows in shared memory are padded to odd strides so that a warp's reads
// fall in distinct banks.  route() in kernel.py sends bf16 at head dims
// (128, 128), (256, 256), (96, 64) and (80, 80) to the tensor-core route
// (flash_attention_bwd_sm90.cu) and everything else here; f32 stays here,
// held to 1e-5 of the plain version, at every head dim.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <type_traits>

// BF16_ON_WGMMA: route()'s rule for this library, a condition on DK and DV
// that kernel.py's build defines (route_condition), true where route()
// sends bf16 to the tensor-core entry point.  No SIMT kernel is compiled
// for those.
#ifndef BF16_ON_WGMMA
#error "BF16_ON_WGMMA is not defined: build this library through kernel.py"
#endif

namespace {

constexpr int kThreads = 128;      // 4 warps
constexpr int kTY = 16;            // threads laid out 16 (rows) x 8 (columns)
constexpr int kTX = 8;             //   for every product

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  const float* lse;    // (B, H, Sq), rows ld apart
  const float* delta;  // (B, H, Sq), rows ld apart
  int ld;
  int B, Sq, Sk, H, KH;
  int causal;
  int window;    // <= 0: no sliding window
  int q_offset;  // absolute position of q row 0
  int kv_len;    // keys at and beyond kv_len are masked; <= Sk
  float scale;
};

__device__ __forceinline__ float load_f32(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, size_t i, float x) { p[i] = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, size_t i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  bool vis = kpos < p.kv_len;
  if (p.causal) vis = vis && kpos <= qpos;
  if (p.window > 0) vis = vis && kpos > qpos - p.window;
  return vis;
}

// Rows [0, n) of a (rows x D) tile of x, starting at element base with
// row_stride elements between rows, into shared memory as f32 with stride
// ld; rows from n on are zero.
template <typename T, int ROWS, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* __restrict__ x,
                                          size_t base, size_t row_stride, int n) {
  for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
    const int r = i / D, d = i % D;
    dst[r * ld + d] = r < n ? load_f32(x, base + r * row_stride + d) : 0.f;
  }
}

// acc[i][j] += sum_d A[ty + 16 i][d] * B[tx + 8 j][d]   (A B^T)
template <int RI, int CJ, int D>
__device__ __forceinline__ void mma_abt(float (&acc)[RI][CJ], const float* A, int lda,
                                        const float* B, int ldb, int ty, int tx) {
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[RI], b[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = A[(ty + kTY * i) * lda + d];
#pragma unroll
    for (int j = 0; j < CJ; ++j) b[j] = B[(tx + kTX * j) * ldb + d];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_r A[r][ty + 16 i] * B[r][tx + 8 j], r < R   (A^T B)
template <int RI, int CJ, int R>
__device__ __forceinline__ void mma_atb(float (&acc)[RI][CJ], const float* A, int lda,
                                        const float* B, int ldb, int ty, int tx) {
#pragma unroll 8
  for (int r = 0; r < R; ++r) {
    float a[RI], b[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = A[r * lda + ty + kTY * i];
#pragma unroll
    for (int j = 0; j < CJ; ++j) b[j] = B[r * ldb + tx + kTX * j];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_c A[ty + 16 i][c] * B[c][tx + 8 j], c < C   (A B)
template <int RI, int CJ, int C>
__device__ __forceinline__ void mma_ab(float (&acc)[RI][CJ], const float* A, int lda,
                                       const float* B, int ldb, int ty, int tx) {
#pragma unroll 8
  for (int c = 0; c < C; ++c) {
    float a[RI], b[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = A[(ty + kTY * i) * lda + c];
#pragma unroll
    for (int j = 0; j < CJ; ++j) b[j] = B[c * ldb + tx + kTX * j];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int RI, int CJ>
__device__ __forceinline__ void zero(float (&acc)[RI][CJ]) {
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
}

// The kv positions [begin, end) that some row of q positions [first, last]
// can see; empty when end <= begin.
__device__ __forceinline__ void kv_span(const Params& p, int first, int last, int& begin,
                                        int& end) {
  end = p.kv_len;
  if (p.causal) end = min(end, last + 1);
  begin = p.window > 0 ? max(0, first - p.window + 1) : 0;
}

// (a) delta = rowsum(dout * o) of each of the B Sq H rows, a warp a row,
// lanes over the columns.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
                   int ld, int Sq, int H, int Dv, long long rows) {
  const int lane = threadIdx.x % 32;
  for (long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32; row < rows;
       row += (long long)gridDim.x * (kThreads / 32)) {
    const size_t base = (size_t)row * Dv;  // row = (b Sq + q) H + h
    float acc = 0.f;
    for (int d = lane; d < Dv; d += 32)
      acc = fmaf(load_f32(dout, base + d), load_f32(o, base + d), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    const int h = (int)(row % H);
    const long long bq = row / H;
    if (lane == 0) delta[((bq / Sq) * H + h) * (size_t)ld + bq % Sq] = acc;
  }
}

// S and dP of one (BQ x BK) tile pair, then P = exp(S * scale - lse) and
// dS = P * (dP - delta) under the masks, written to sP (when given) and sdS.
template <int RQ, int CS, int DK, int DV>
__device__ __forceinline__ void probs_and_dscores(const Params& p, const float* sQ, int ldq,
                                                  const float* sK, int ldk, const float* sdO,
                                                  int ldo, const float* sV, int ldv,
                                                  const float* sLse, const float* sDelta,
                                                  float* sP, float* sdS, int lds, int q_first,
                                                  int nq, int k0, int ty, int tx) {
  float s[RQ][CS], dp[RQ][CS];
  zero(s);
  zero(dp);
  mma_abt<RQ, CS, DK>(s, sQ, ldq, sK, ldk, ty, tx);
  mma_abt<RQ, CS, DV>(dp, sdO, ldo, sV, ldv, ty, tx);
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty + kTY * i;
    const float lse = sLse[r], dlt = sDelta[r];
#pragma unroll
    for (int j = 0; j < CS; ++j) {
      const int c = tx + kTX * j;
      const float pv =
          r < nq && visible(p, q_first + r, k0 + c) ? expf(s[i][j] * p.scale - lse) : 0.f;
      if (sP != nullptr) sP[r * lds + c] = pv;
      sdS[r * lds + c] = pv * (dp[i][j] - dlt);
    }
  }
}

// Rows [0, n) of lse and delta from base into shared memory; 0 beyond.
__device__ __forceinline__ void load_stats(float* sLse, float* sDelta, const Params& p,
                                           size_t base, int n, int rows) {
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    sLse[r] = r < n ? p.lse[base + r] : 0.f;
    sDelta[r] = r < n ? p.delta[base + r] : 0.f;
  }
}

// (b) dk and dv of one (kv tile, kv head, batch).
template <typename T, int DK, int DV, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) attn_bwd_dkdv(const Params p) {
  constexpr int RQ = BQ / kTY, CS = BK / kTX;               // S, dP: BQ x BK
  constexpr int RK = BK / kTY, CK = DK / kTX, CV = DV / kTX;  // dk, dv: BK x D
  constexpr int kQS = DK + 1, kOS = DV + 1, kPS = BK + 1;
  static_assert(BQ % kTY == 0 && BK % kTY == 0 && BK % kTX == 0, "tile shape");
  static_assert(DK % kTX == 0 && DV % kTX == 0, "head dims");
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * kQS;
  float* sQ = sV + BK * kOS;
  float* sdO = sQ + BQ * kQS;
  float* sP = sdO + BQ * kOS;
  float* sdS = sP + BQ * kPS;
  float* sLse = sdS + BQ * kPS;
  float* sDelta = sLse + BQ;

  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ k = static_cast<const T*>(p.k);
  const T* __restrict__ v = static_cast<const T*>(p.v);
  const T* __restrict__ dout = static_cast<const T*>(p.dout);
  T* __restrict__ dk = static_cast<T*>(p.dk);
  T* __restrict__ dv = static_cast<T*>(p.dv);

  const int tid = threadIdx.x, ty = tid / kTX, tx = tid % kTX;
  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int nk = min(BK, p.Sk - k0);
  const int group = p.H / p.KH;
  const size_t q_row = (size_t)p.H * DK, o_row = (size_t)p.H * DV;
  const size_t k_row = (size_t)p.KH * DK, v_row = (size_t)p.KH * DV;
  const size_t k_base = ((size_t)b * p.Sk + k0) * k_row + (size_t)kvh * DK;
  const size_t v_base = ((size_t)b * p.Sk + k0) * v_row + (size_t)kvh * DV;

  load_tile<T, BK, DK>(sK, kQS, k, k_base, k_row, nk);
  load_tile<T, BK, DV>(sV, kOS, v, v_base, v_row, nk);

  // The query rows [i_lo, i_hi) that can see some key of this tile.
  int i_lo = 0, i_hi = p.Sq;
  if (p.causal) i_lo = max(i_lo, k0 - p.q_offset);
  if (p.window > 0) i_hi = min(i_hi, k0 + nk - 1 + p.window - p.q_offset);
  if (k0 >= p.kv_len) i_hi = i_lo;
  const int t_begin = i_lo / BQ;
  const int t_end = i_hi > i_lo ? (i_hi + BQ - 1) / BQ : t_begin;

  float acc_k[RK][CK], acc_v[RK][CV];
  zero(acc_k);
  zero(acc_v);
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    for (int t = t_begin; t < t_end; ++t) {
      const int q0 = t * BQ;
      const int nq = min(BQ, p.Sq - q0);
      __syncthreads();  // the previous step's readers are done with sQ, sdO, sP, sdS
      load_tile<T, BQ, DK>(sQ, kQS, q, ((size_t)b * p.Sq + q0) * q_row + (size_t)h * DK, q_row,
                           nq);
      load_tile<T, BQ, DV>(sdO, kOS, dout, ((size_t)b * p.Sq + q0) * o_row + (size_t)h * DV,
                           o_row, nq);
      load_stats(sLse, sDelta, p, ((size_t)b * p.H + h) * p.ld + q0, nq, BQ);
      __syncthreads();
      probs_and_dscores<RQ, CS, DK, DV>(p, sQ, kQS, sK, kQS, sdO, kOS, sV, kOS, sLse, sDelta, sP,
                                        sdS, kPS, p.q_offset + q0, nq, k0, ty, tx);
      __syncthreads();
      mma_atb<RK, CV, BQ>(acc_v, sP, kPS, sdO, kOS, ty, tx);
      mma_atb<RK, CK, BQ>(acc_k, sdS, kPS, sQ, kQS, ty, tx);
    }
  }

  // Every row of the tile is written, 0 where no query sees it.
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int r = ty + kTY * i;
    if (r >= nk) continue;
#pragma unroll
    for (int j = 0; j < CK; ++j)
      store_f32(dk, k_base + r * k_row + tx + kTX * j, acc_k[i][j] * p.scale);
#pragma unroll
    for (int j = 0; j < CV; ++j) store_f32(dv, v_base + r * v_row + tx + kTX * j, acc_v[i][j]);
  }
}

// (c) dq of one (q tile, head, batch).
template <typename T, int DK, int DV, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq(const Params p) {
  constexpr int RQ = BQ / kTY, CS = BK / kTX, CQ = DK / kTX;
  constexpr int kQS = DK + 1, kOS = DV + 1, kPS = BK + 1;
  static_assert(BQ % kTY == 0 && BK % kTX == 0 && DK % kTX == 0, "tile shape");
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * kQS;
  float* sK = sdO + BQ * kOS;
  float* sV = sK + BK * kQS;
  float* sdS = sV + BK * kOS;
  float* sLse = sdS + BQ * kPS;
  float* sDelta = sLse + BQ;

  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ k = static_cast<const T*>(p.k);
  const T* __restrict__ v = static_cast<const T*>(p.v);
  const T* __restrict__ dout = static_cast<const T*>(p.dout);
  T* __restrict__ dq = static_cast<T*>(p.dq);

  const int tid = threadIdx.x, ty = tid / kTX, tx = tid % kTX;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest causal tile first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KH);
  const int nq = min(BQ, p.Sq - q0);
  const int q_first = p.q_offset + q0;
  const size_t q_row = (size_t)p.H * DK, o_row = (size_t)p.H * DV;
  const size_t k_row = (size_t)p.KH * DK, v_row = (size_t)p.KH * DV;
  const size_t q_base = ((size_t)b * p.Sq + q0) * q_row + (size_t)h * DK;
  const size_t k_base = (size_t)b * p.Sk * k_row + (size_t)kvh * DK;
  const size_t v_base = (size_t)b * p.Sk * v_row + (size_t)kvh * DV;

  load_tile<T, BQ, DK>(sQ, kQS, q, q_base, q_row, nq);
  load_tile<T, BQ, DV>(sdO, kOS, dout, ((size_t)b * p.Sq + q0) * o_row + (size_t)h * DV, o_row,
                       nq);
  load_stats(sLse, sDelta, p, ((size_t)b * p.H + h) * p.ld + q0, nq, BQ);

  int kv_begin, kv_end;
  kv_span(p, q_first, q_first + nq - 1, kv_begin, kv_end);
  const int t_begin = kv_begin / BK;
  const int t_end = kv_end > kv_begin ? (kv_end + BK - 1) / BK : t_begin;

  float acc[RQ][CQ];
  zero(acc);
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    const int nk = min(BK, p.Sk - k0);
    __syncthreads();  // the previous tile's readers are done with sK, sV and sdS
    load_tile<T, BK, DK>(sK, kQS, k, k_base + (size_t)k0 * k_row, k_row, nk);
    load_tile<T, BK, DV>(sV, kOS, v, v_base + (size_t)k0 * v_row, v_row, nk);
    __syncthreads();
    probs_and_dscores<RQ, CS, DK, DV>(p, sQ, kQS, sK, kQS, sdO, kOS, sV, kOS, sLse, sDelta,
                                      nullptr, sdS, kPS, q_first, nq, k0, ty, tx);
    __syncthreads();
    mma_ab<RQ, CQ, BK>(acc, sdS, kPS, sK, kQS, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty + kTY * i;
    if (r >= nq) continue;
#pragma unroll
    for (int j = 0; j < CQ; ++j) store_f32(dq, q_base + r * q_row + tx + kTX * j, acc[i][j] * p.scale);
  }
}

template <typename Kernel>
cudaError_t launch_one(Kernel kernel, dim3 grid, size_t bytes, const Params& p,
                       cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// (b) then (c).  Tiles (rows x rows): (b) BKV kv rows a block, BQB query
// rows a step; (c) BQ query rows a block, BK kv rows a step.  Each keeps its
// register tiles at 64 floats a thread or fewer for the accumulators.
template <typename T, int DK, int DV, int BQ, int BK, int BQB, int BKV>
cudaError_t launch(const Params& p, cudaStream_t s) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> && (BF16_ON_WGMMA)) {
    return cudaErrorInvalidValue;  // never sent here
  } else {
    constexpr int kQS = DK + 1, kOS = DV + 1;
    const size_t dkdv_bytes = sizeof(float) * ((size_t)BKV * (kQS + kOS) + BQB * (kQS + kOS) +
                                               2 * BQB * (BKV + 1) + 2 * BQB);
    const size_t dq_bytes =
        sizeof(float) * ((size_t)BQ * (kQS + kOS) + BK * (kQS + kOS) + BQ * (BK + 1) + 2 * BQ);
    const dim3 q_grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
    const dim3 kv_grid((p.Sk + BKV - 1) / BKV, p.KH, p.B);
    cudaError_t err = launch_one(attn_bwd_dkdv<T, DK, DV, BQB, BKV>, kv_grid, dkdv_bytes, p, s);
    if (err != cudaSuccess) return err;
    return launch_one(attn_bwd_dq<T, DK, DV, BQ, BK>, q_grid, dq_bytes, p, s);
  }
}

// The pairs are BWD_HEAD_DIMS in kernel.py.
template <typename T>
cudaError_t dispatch(const Params& p, int dk, int dv, cudaStream_t s) {
  if (dk == 16 && dv == 16) return launch<T, 16, 16, 64, 64, 32, 64>(p, s);
  if (dk == 32 && dv == 32) return launch<T, 32, 32, 64, 64, 32, 64>(p, s);
  if (dk == 64 && dv == 64) return launch<T, 64, 64, 64, 64, 32, 64>(p, s);
  // hubert-xlarge: 80 and 80 (f32 only: bf16 runs on the tensor cores;
  // bidirectional).  Dk + Dv is
  // 160, as at (96, 64) below, so the same tiles: a dK/dV block keeps 4 x 10
  // + 4 x 10 accumulators a thread, 77 KB of shared memory; a dQ block 4 x
  // 10, 98 KB.
  if (dk == 80 && dv == 80) return launch<T, 80, 80, 64, 64, 32, 64>(p, s);
  // MLA (minicpm3-4b): q and k of 96 (64 + 32 rotary), v of 64 (f32 only:
  // bf16 runs on the tensor cores).  The tiles of 64: a dK/dV block keeps
  // 4 x 12 + 4 x 8 accumulators a thread, 77 KB of shared memory; a dQ
  // block 4 x 12, 98 KB.
  if (dk == 96 && dv == 64) return launch<T, 96, 64, 64, 64, 32, 64>(p, s);
  if (dk == 128 && dv == 128) return launch<T, 128, 128, 64, 32, 32, 32>(p, s);
  // 256 (f32 only: bf16 runs on the tensor cores): dK and dV take 256
  // columns each, so a dK/dV block owns 16 kv rows (2 x 32 accumulators a
  // thread) and takes 16 query rows a step, 68 KB of shared memory and three
  // blocks an SM (32 rows a step, two blocks an SM, ran slower at
  // recurrentgemma's train shape); a dQ block owns 32 query rows, 136 KB.
  if (dk == 256 && dv == 256) return launch<T, 256, 256, 32, 32, 16, 16>(p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// (a), for either route.  dtype: 0 float32, 1 bfloat16; delta: (B, H, Sq)
// f32, rows ld apart.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_bwd_delta(const void* o, const void* dout, float* delta, int ld,
                                         int dtype, int B, int Sq, int H, int Dv,
                                         void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || Dv <= 0 || ld < Sq) return cudaErrorInvalidValue;
  const long long rows = (long long)B * Sq * H, blocks = (rows + 3) / 4;  // 4 warps a block
  const int grid = static_cast<int>(blocks < 65536 ? blocks : 65536);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    attn_bwd_delta<<<grid, kThreads, 0, s>>>(static_cast<const float*>(o),
                                             static_cast<const float*>(dout), delta, ld, Sq, H,
                                             Dv, rows);
  else if (dtype == 1)
    attn_bwd_delta<<<grid, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(o),
                                             static_cast<const __nv_bfloat16*>(dout), delta, ld,
                                             Sq, H, Dv, rows);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// (b) and (c), the SIMT route's entry point.  dtype: 0 float32, 1 bfloat16;
// lse and delta: (B, H, Sq) f32, rows ld apart, delta written by
// flash_attention_bwd_delta before.  Returns the first CUDA error of the two
// launches (0 on success), or cudaErrorInvalidValue for arguments the
// kernels do not take.
extern "C" int flash_attention_bwd_simt(const void* q, const void* k, const void* v,
                                        const void* dout, void* dq, void* dk, void* dv,
                                        const float* lse, const float* delta, int ld, int dtype,
                                        int B, int Sq, int Sk, int H, int KH, int Dk, int Dv,
                                        int causal, int window, int q_offset, int kv_len,
                                        float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || B > 65535 ||
      H > 65535 || kv_len < 0 || kv_len > Sk || ld < Sq)
    return cudaErrorInvalidValue;
  const Params p{q,  k,  v,  dout, dq,     dk,     dv,       lse,    delta, ld,
                 B,  Sq, Sk, H,    KH,     causal, window,   q_offset, kv_len, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, Dk, Dv, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, Dk, Dv, s);
  return cudaErrorInvalidValue;
}
