// RG-LRU diagonal linear recurrence, backward, for NVIDIA Hopper (sm_90a).
//
// The gradient of what rglru_scan_fwd.cu computes.  The Pallas TPU kernel
//   src/repro/kernels/rglru_scan/kernel.py :: rglru_scan_kernel
// has no backward of its own: on the TPU jax.grad differentiates the scan.
// Here the forward is a kernel, so its gradient is one too.  For each
// channel (b, w), with c_t the cotangent that reaches h_t, walking t from
// T - 1 down to 0:
//   c_t  = dh[b][t][w] + g,   g = dh_last[b][w] (or 0) at t = T - 1,
//                             g = a[b][t+1][w] * c_{t+1} after,
//   db[b][t][w] = c_t,   da[b][t][w] = c_t * h[b][t-1][w] (h0[b][w], or 0,
//                                                         at t = 0),
// and dh0[b][w] = a[b][0][w] * c_0, the last g.  c and g are carried in
// f32; da and db are written in the inputs' type (f32 or bf16), dh0 in f32.
//
// Layout: a, h, dh, da and db (B, T, W); h0, dh_last and dh0 (B, W); all
// contiguous.  h is the forward's output, so in bf16 da reads the rounded
// state, as the plain version does.
//
// The forward's layout (rglru_scan_fwd.cu): one thread owns one (b, w) and
// keeps c in a register across a loop over all T steps, backwards;
// neighbouring threads take neighbouring w, so each step's loads and stores
// coalesce.  A ragged edge of W is masked; any T >= 1 is taken; offsets are
// 64-bit.
//
// Rounding: each step is __fadd_rn(dh, g), then __fmul_rn for da and for
// the next g, the plain version's `dh + g`, `c * h` and `a * c` (one
// PyTorch kernel each); nvcc would otherwise contract a product and a sum
// into one fmaf.  So the kernel and its plain version agree bit for bit.
//
// What bounds it.  At recurrentgemma-2b's train shape (2, 4096, 2560) in
// f32 the function reads dh, a and h and writes da and db, 20 bytes an
// element, 4.19e8 bytes: 0.125 ms at 3.35 TB/s.  Its 3 FLOP an element are
// negligible, so bytes set the floor.  That shape gives B x W = 5,120
// threads, 40 blocks of 128 for 132 SMs, so each warp's progress is bound
// by the latency of its loads unless many are in flight: the next U steps
// of dh, a and h (3 U loads a thread) are loaded into registers before this
// chunk of U steps is computed.  A chunked two-pass scan over T, for more
// threads in flight, is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr int U = 16;  // steps loaded ahead (8 ran slower at the train shape, 24 no faster)

__device__ __forceinline__ float load_f32(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, size_t i, float x) { p[i] = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, size_t i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

// dh_t, a_t and h_{t-1} of step t (zeros where t < 0).
template <typename Elem>
__device__ __forceinline__ void load_step(const Elem* __restrict__ dh, const Elem* __restrict__ a,
                                          const Elem* __restrict__ h, size_t base, int W, int t,
                                          float h_init, float& dht, float& at, float& hp) {
  const bool in = t >= 0;
  dht = in ? load_f32(dh, base + (size_t)t * W) : 0.f;
  at = in ? load_f32(a, base + (size_t)t * W) : 0.f;
  hp = t >= 1 ? load_f32(h, base + (size_t)(t - 1) * W) : h_init;
}

template <typename Elem>
__global__ void __launch_bounds__(kThreads)
rglru_bwd(const Elem* __restrict__ a, const Elem* __restrict__ h,
          const float* __restrict__ h0, const Elem* __restrict__ dh,
          const float* __restrict__ dh_last, Elem* __restrict__ da, Elem* __restrict__ db,
          float* __restrict__ dh0, int T, int W, int w_blocks) {
  const int bi = blockIdx.x / w_blocks;
  const int w = (blockIdx.x - bi * w_blocks) * kThreads + threadIdx.x;
  if (w >= W) return;
  const size_t state = (size_t)bi * W + w;         // (b, w)
  const size_t base = (size_t)bi * T * W + w;      // (b, 0, w)
  const float h_init = h0 ? h0[state] : 0.f;
  float g = dh_last ? dh_last[state] : 0.f;

  float dn[U], an[U], hn[U];  // step T - 1 - u, then each chunk's next
#pragma unroll
  for (int u = 0; u < U; ++u)
    load_step(dh, a, h, base, W, T - 1 - u, h_init, dn[u], an[u], hn[u]);
  for (int t0 = T - 1; t0 >= 0; t0 -= U) {
    float dc[U], ac[U], hc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      dc[u] = dn[u];
      ac[u] = an[u];
      hc[u] = hn[u];
    }
    // the next chunk's loads go out before this chunk's arithmetic
#pragma unroll
    for (int u = 0; u < U; ++u)
      load_step(dh, a, h, base, W, t0 - U - u, h_init, dn[u], an[u], hn[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 - u;
      if (t >= 0) {
        const float c = __fadd_rn(dc[u], g);
        store_f32(db, base + (size_t)t * W, c);
        store_f32(da, base + (size_t)t * W, __fmul_rn(c, hc[u]));
        g = __fmul_rn(ac[u], c);
      }
    }
  }
  dh0[state] = g;
}

template <typename Elem>
cudaError_t launch(const void* a, const void* h, const float* h0, const void* dh,
                   const float* dh_last, void* da, void* db, float* dh0, int B, int T, int W,
                   cudaStream_t stream) {
  const int w_blocks = (W + kThreads - 1) / kThreads;
  rglru_bwd<Elem><<<B * w_blocks, kThreads, 0, stream>>>(
      static_cast<const Elem*>(a), static_cast<const Elem*>(h), h0,
      static_cast<const Elem*>(dh), dh_last, static_cast<Elem*>(da), static_cast<Elem*>(db),
      dh0, T, W, w_blocks);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  h0 and dh_last may be null (zeros).
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int rglru_scan_bwd(const void* a, const void* h, const float* h0, const void* dh,
                              const float* dh_last, void* da, void* db, float* dh0, int dtype,
                              int B, int T, int W, void* stream) {
  if (B <= 0 || T <= 0 || W <= 0 || W > 2147483647 - kThreads ||
      (long long)B * ((W + kThreads - 1) / kThreads) > 2147483647LL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, h, h0, dh, dh_last, da, db, dh0, B, T, W, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, h, h0, dh, dh_last, da, db, dh0, B, T, W, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* rglru_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
