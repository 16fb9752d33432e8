// Flash attention, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py :: flash_attention_kernel
// (body _attn_kernel).  It computes what that kernel computes: blocked
// online-softmax attention, f32 running max m, denominator l and
// accumulator acc; GQA reads kv head h / group with no copy; causal,
// sliding-window, kv_len and q_offset masks; tiles that no (query, key) pair
// can see are skipped; a row that sees no key outputs 0; Dv may differ from
// Dk.  Inputs are f32 or bf16, the output is in the inputs' type.
//
// Layout: q (B, Sq, H, Dk), k (B, Sk, KH, Dk), v (B, Sk, KH, Dv) and
// o (B, Sq, H, Dv), all contiguous.
//
// The TPU kernel's grid ran (batch, head, q block, kv block) in order on one
// core and carried m, l and acc in VMEM from one kv block to the next.  Here
// one thread block owns one (b, h, q tile) and walks the kv tiles in a loop,
// so the carry stays in the block: m and l in shared memory, acc in
// registers.  K and V tiles are staged in shared memory as f32.
//
// What bounds it.  At the qwen3-1.7b prefill shape (q 8x1024x16x128,
// k/v 8x1024x8x128, bf16, causal) the function needs about 3.4e10 FLOP
// against about 100 MB of inputs and output, so the card's floor is set by
// operations (0.035 ms at 989 TFLOP/s bf16, against 0.030 ms for the bytes).
// This kernel does its products on the CUDA cores in f32 (fmaf): its ceiling
// is the f32 FMA rate and the shared-memory bandwidth that feeds it.  Each
// thread computes a register tile of scores (RQ x CS) and of output
// (RQ x CV), so that each value read from shared memory feeds several FMAs,
// and the rows of Q, K and the score tile are padded to odd strides so that
// a warp's reads fall in distinct banks.  Nothing but q, k, v and o touches
// device memory.  Causal q tiles are launched heaviest first.
//
// Two routes, each its own entry point.  route() in kernel.py, the rule's
// only copy, sends bf16 at (Dk, Dv) = (128, 128), (256, 256), (96, 64) and
// (80, 80), the served shapes, to the tensor-core kernel in flash_attention_fwd_sm90.cu
// (wgmma, TMA) and everything else here: f32 at every head dim (its callers hold it
// to 1e-5 of the plain version, which TF32 would not meet) and bf16 at the
// other head dims.  Neither route falls back to the other.
//
// When the caller passes an lse buffer (training), each row's log-sum-exp
// m + log(l) over the keys it sees goes there for the backward, 0 where it
// sees none.

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
constexpr int kTX = 8;             //   for both products
constexpr float kNegInf = -1e30f;  // start of the running max, as on the TPU

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;    // (B, H, Sq) rows lse_ld apart, or nullptr: nothing written
  int lse_ld;
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

// Shared memory of one block, in floats: Q tile, K tile, V tile, score tile,
// then m, l and alpha for each row.
template <int DK, int DV, int BQ, int BK>
struct Layout {
  static constexpr int kQStride = DK + 1;  // odd strides: a warp's rows hit
  static constexpr int kKStride = DK + 1;  //   distinct banks
  static constexpr int kPStride = BK + 1;
  static constexpr int kQ = BQ * kQStride;
  static constexpr int kK = BK * kKStride;
  static constexpr int kV = BK * DV;
  static constexpr int kP = BQ * kPStride;
  static constexpr size_t kBytes = sizeof(float) * (size_t)(kQ + kK + kV + kP + 3 * BQ);
};

template <typename T, int DK, int DV, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) attn_fwd(const Params p) {
  using L = Layout<DK, DV, BQ, BK>;
  constexpr int RQ = BQ / kTY;        // query rows per thread
  constexpr int CS = BK / kTX;        // score columns per thread
  constexpr int CV = DV / kTX;        // output columns per thread
  constexpr int TPR = kThreads / BQ;  // threads per row in the softmax
  static_assert(BQ % kTY == 0 && BK % kTX == 0 && DV % kTX == 0, "tile shape");
  static_assert(kThreads % BQ == 0 && 32 % TPR == 0 && BK % TPR == 0, "softmax split");

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + L::kQ;
  float* sV = sK + L::kK;
  float* sP = sV + L::kV;
  float* sM = sP + L::kP;
  float* sL = sM + BQ;
  float* sA = sL + BQ;

  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ k = static_cast<const T*>(p.k);
  const T* __restrict__ v = static_cast<const T*>(p.v);
  T* __restrict__ o = static_cast<T*>(p.o);

  const int tid = threadIdx.x;
  const int ty = tid / kTX, tx = tid % kTX;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // last (heaviest causal) tile first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KH);
  const int nq = min(BQ, p.Sq - q0);                  // valid rows in this tile
  const int q_first = p.q_offset + q0;
  const int q_last = q_first + nq - 1;

  const size_t q_row = (size_t)p.H * DK;  // elements between sequence positions
  const size_t k_row = (size_t)p.KH * DK;
  const size_t v_row = (size_t)p.KH * DV;
  const size_t o_row = (size_t)p.H * DV;
  const size_t q_base = ((size_t)b * p.Sq + q0) * q_row + (size_t)h * DK;
  const size_t k_base = (size_t)b * p.Sk * k_row + (size_t)kvh * DK;
  const size_t v_base = (size_t)b * p.Sk * v_row + (size_t)kvh * DV;
  const size_t o_base = ((size_t)b * p.Sq + q0) * o_row + (size_t)h * DV;

  for (int i = tid; i < BQ * DK; i += kThreads) {
    const int r = i / DK, d = i % DK;
    sQ[r * L::kQStride + d] = r < nq ? load_f32(q, q_base + r * q_row + d) : 0.f;
  }
  for (int r = tid; r < BQ; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }

  // The kv tiles that some (query, key) pair of this q tile can see.
  int kv_end = p.kv_len;
  if (p.causal) kv_end = min(kv_end, q_last + 1);
  const int kv_begin = p.window > 0 ? max(0, q_first - p.window + 1) : 0;
  const int t_begin = kv_begin / BK;
  const int t_end = kv_end > kv_begin ? (kv_end + BK - 1) / BK : t_begin;

  float acc[RQ][CV];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CV; ++j) acc[i][j] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's readers are done with sK, sV and sP
    for (int i = tid; i < BK * DK; i += kThreads) {
      const int r = i / DK, d = i % DK;
      sK[r * L::kKStride + d] =
          k0 + r < kv_end ? load_f32(k, k_base + (size_t)(k0 + r) * k_row + d) : 0.f;
    }
    for (int i = tid; i < BK * DV; i += kThreads) {
      const int r = i / DV, d = i % DV;
      sV[r * DV + d] =
          k0 + r < kv_end ? load_f32(v, v_base + (size_t)(k0 + r) * v_row + d) : 0.f;
    }
    __syncthreads();

    // Scores S = scale * Q K^T: each thread rows ty + 16 i, columns tx + 8 j.
    float s[RQ][CS];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CS; ++j) s[i][j] = 0.f;
    // unrolled fully: with a partial unroll ptxas spilled at Dk 96
#pragma unroll
    for (int d = 0; d < DK; ++d) {
      float qv[RQ], kv[CS];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = sQ[(ty + kTY * i) * L::kQStride + d];
#pragma unroll
      for (int j = 0; j < CS; ++j) kv[j] = sK[(tx + kTX * j) * L::kKStride + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty + kTY * i;
      const int qpos = q_first + r;
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        const int c = tx + kTX * j;
        const int kpos = k0 + c;
        bool visible = r < nq && kpos < p.kv_len;
        if (p.causal) visible = visible && kpos <= qpos;
        if (p.window > 0) visible = visible && kpos > qpos - p.window;
        sP[r * L::kPStride + c] = visible ? s[i][j] * p.scale : -INFINITY;
      }
    }
    __syncthreads();

    // Online softmax over this tile: TPR neighbouring threads share a row.
    {
      const int r = tid / TPR, part = tid % TPR;
      float* row = sP + r * L::kPStride;
      float mx = -INFINITY;
      for (int c = part; c < BK; c += TPR) mx = fmaxf(mx, row[c]);
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = part; c < BK; c += TPR) {
        const float e = row[c] == -INFINITY ? 0.f : expf(row[c] - m_new);
        row[c] = e;
        sum += e;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();  // every thread of the row has read sM[r] before it changes
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        sA[r] = alpha;
        sL[r] = alpha * sL[r] + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha * acc + P V: each thread rows ty + 16 i, columns tx + 8 j.
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const float alpha = sA[ty + kTY * i];
#pragma unroll
      for (int j = 0; j < CV; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RQ], vv[CV];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = sP[(ty + kTY * i) * L::kPStride + c];
#pragma unroll
      for (int j = 0; j < CV; ++j) vv[j] = sV[c * DV + tx + kTX * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CV; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();  // sL is final, also when no tile was visible

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty + kTY * i;
    if (r >= nq) continue;
    const float l = sL[r];
#pragma unroll
    for (int j = 0; j < CV; ++j)
      store_f32(o, o_base + r * o_row + tx + kTX * j, l > 0.f ? acc[i][j] / l : 0.f);
  }
  if (p.lse != nullptr)
    for (int r = tid; r < nq; r += kThreads)
      p.lse[((size_t)b * p.H + h) * p.lse_ld + q0 + r] = sL[r] > 0.f ? sM[r] + logf(sL[r]) : 0.f;
}

template <typename T, int DK, int DV, int BQ, int BK>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> && (BF16_ON_WGMMA)) {
    return cudaErrorInvalidValue;  // never sent here
  } else {
    using L = Layout<DK, DV, BQ, BK>;
    auto kernel = attn_fwd<T, DK, DV, BQ, BK>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
    kernel<<<grid, kThreads, L::kBytes, stream>>>(p);
    return cudaGetLastError();
  }
}

// Tiles per head-dim pair: BQ x BK = 64 x 64 up to Dk 64, 64 x 32 at Dk 80,
// 96 and 128, 32 x 32 at 256.  That keeps acc at 64 registers a thread or fewer
// and lets two or more blocks share an SM.  The pairs are HEAD_DIMS in
// kernel.py.
template <typename T>
cudaError_t dispatch(const Params& p, int dk, int dv, cudaStream_t s) {
  if (dk == 16 && dv == 16) return launch<T, 16, 16, 64, 64>(p, s);
  if (dk == 32 && dv == 32) return launch<T, 32, 32, 64, 64>(p, s);
  if (dk == 64 && dv == 64) return launch<T, 64, 64, 64, 64>(p, s);
  if (dk == 80 && dv == 80) return launch<T, 80, 80, 64, 32>(p, s);
  if (dk == 96 && dv == 64) return launch<T, 96, 64, 64, 32>(p, s);
  if (dk == 128 && dv == 128) return launch<T, 128, 128, 64, 32>(p, s);
  if (dk == 256 && dv == 256) return launch<T, 256, 256, 32, 32>(p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// The SIMT route's entry point.  dtype: 0 float32, 1 bfloat16.  lse: (B, H,
// Sq) f32, rows lse_ld apart, or nullptr.  Returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue for arguments the
// kernel does not take.
extern "C" int flash_attention_fwd_simt(const void* q, const void* k, const void* v, void* o,
                                        float* lse, int lse_ld, int dtype, int B, int Sq,
                                        int Sk, int H, int KH, int Dk, int Dv, int causal,
                                        int window, int q_offset, int kv_len, float scale,
                                        void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || B > 65535 || H > 65535 ||
      kv_len < 0 || kv_len > Sk || (lse != nullptr && lse_ld < Sq))
    return cudaErrorInvalidValue;
  const Params p{q,  k, v,  o,      lse,    lse_ld,   B,      Sq,
                 Sk, H, KH, causal, window, q_offset, kv_len, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, Dk, Dv, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, Dk, Dv, s);
  return cudaErrorInvalidValue;
}
