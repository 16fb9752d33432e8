// RG-LRU diagonal linear recurrence, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rglru_scan/kernel.py :: rglru_scan_kernel
// (body _rglru_kernel).  It computes what that kernel computes: for each
// channel (b, w), from h0[b][w] (or 0 when h0 is null), and for each step t
//   h = a[b][t][w] * h + b[b][t][w]
// with h carried in f32, each step's h written in the inputs' type (f32 or
// bf16) and the last h written to h_last in f32.
//
// Layout: a, b and h (B, T, W); h0 and h_last (B, W); all contiguous.
//
// The TPU kernel ran a grid of (batch, channel block, time block) with time
// innermost, sequential on one core, and carried the state from one time
// block to the next in VMEM scratch.  Here channels are independent: one
// thread owns one (b, w) and keeps h in a register across a loop over all T
// steps, so nothing carries between blocks.  Neighbouring threads take
// neighbouring w, so each step's loads and stores coalesce.  A ragged edge
// of W is masked; any T >= 1 is taken; offsets are 64-bit.
//
// Rounding: each step is __fmul_rn then __fadd_rn, two roundings, as the
// plain version's `a * h + b` (two PyTorch kernels) and the JAX package's
// decode step compute it; nvcc would otherwise contract the pair into one
// fmaf.  So the kernel and its plain version agree bit for bit.
//
// What bounds it.  At the recurrentgemma-2b prefill shape (8, 4096, 2560) in
// f32 the function reads a and b (671 MB) and writes h (336 MB) and h_last:
// about 1.007e9 bytes, 0.3005 ms at 3.35 TB/s.  Its 2 FLOP an element
// (1.68e8) are negligible, so bytes set the floor.  That shape gives only
// B x W = 20,480 threads, about 1.2 blocks of 128 for each of the 132 SMs,
// so each warp's progress is bound by the latency of its loads unless many
// are in flight.  The loop is software-pipelined: the next U steps of a and
// b are loaded into registers before this chunk of U steps is computed.  A
// chunked two-pass scan over T, for more threads in flight, is the next
// step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr int U = 8;  // steps loaded ahead

__device__ __forceinline__ float load_f32(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, size_t i, float x) { p[i] = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, size_t i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

template <typename Elem>
__global__ void __launch_bounds__(kThreads)
rglru_fwd(const Elem* __restrict__ a, const Elem* __restrict__ b,
          const float* __restrict__ h0, Elem* __restrict__ h_out,
          float* __restrict__ h_last, int T, int W, int w_blocks) {
  const int bi = blockIdx.x / w_blocks;
  const int w = (blockIdx.x - bi * w_blocks) * kThreads + threadIdx.x;
  if (w >= W) return;
  const size_t state = (size_t)bi * W + w;         // (b, w)
  const size_t base = (size_t)bi * T * W + w;      // (b, 0, w)
  float h = h0 ? h0[state] : 0.f;

  float an[U], bn[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool in = u < T;
    an[u] = in ? load_f32(a, base + (size_t)u * W) : 0.f;
    bn[u] = in ? load_f32(b, base + (size_t)u * W) : 0.f;
  }
  for (int t0 = 0; t0 < T; t0 += U) {
    float ac[U], bc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ac[u] = an[u];
      bc[u] = bn[u];
    }
    // the next chunk's loads go out before this chunk's arithmetic
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + U + u;
      const bool in = t < T;
      an[u] = in ? load_f32(a, base + (size_t)t * W) : 0.f;
      bn[u] = in ? load_f32(b, base + (size_t)t * W) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      if (t < T) {
        h = __fadd_rn(__fmul_rn(ac[u], h), bc[u]);
        store_f32(h_out, base + (size_t)t * W, h);
      }
    }
  }
  h_last[state] = h;
}

template <typename Elem>
cudaError_t launch(const void* a, const void* b, const float* h0, void* h,
                   float* h_last, int B, int T, int W, cudaStream_t stream) {
  const int w_blocks = (W + kThreads - 1) / kThreads;
  rglru_fwd<Elem><<<B * w_blocks, kThreads, 0, stream>>>(
      static_cast<const Elem*>(a), static_cast<const Elem*>(b), h0,
      static_cast<Elem*>(h), h_last, T, W, w_blocks);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  h0 may be null (a zero state).  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int rglru_scan_fwd(const void* a, const void* b, const float* h0, void* h,
                              float* h_last, int dtype, int B, int T, int W,
                              void* stream) {
  if (B <= 0 || T <= 0 || W <= 0 || W > 2147483647 - kThreads ||
      (long long)B * ((W + kThreads - 1) / kThreads) > 2147483647LL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, h0, h, h_last, B, T, W, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, h0, h, h_last, B, T, W, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* rglru_scan_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
