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
// One thread owns one (b, w) and keeps c in a register across a loop over
// all T steps, backwards, as the forward's thread does; neighbouring threads
// take neighbouring w, so each step's copies and stores coalesce.  A ragged
// edge of W is masked; any T >= 1 is taken; offsets are 64-bit.
//
// Rounding: each step is __fadd_rn(dh, g), then __fmul_rn for da and for
// the next g, the plain version's `dh + g`, `c * h` and `a * c` (one
// PyTorch kernel each); nvcc would otherwise contract a product and a sum
// into one fmaf.  So the kernel and its plain version agree bit for bit.
//
// Two entry points, one a route; kernel.py's bwd_route() picks one:
//   rglru_scan_bwd_tma       rglru_bwd_tma: a, h and dh 16-byte aligned and
//                            a row of W elements a multiple of 16 bytes (every
//                            f32 shape with W a multiple of 4, the train shape
//                            among them); it refuses other tensors;
//   rglru_scan_bwd_prefetch  rglru_bwd, the register-prefetch kernel: any
//                            contiguous tensors (a bf16 row of W = 100, say).
//
// What bounds it.  At recurrentgemma-2b's train shape (2, 4096, 2560) in
// f32 the function reads dh, a and h and writes da and db, 20 bytes an
// element, 4.19e8 bytes: 0.125 ms at 3.35 TB/s.  Its 3 FLOP an element are
// negligible, so bytes set the floor.  That shape has only B x W = 5,120
// channels, 160 warps, each walking 4096 steps.  rglru_bwd keeps the next
// 16 steps of dh, a and h in registers, in blocks of 128 threads: 40 blocks
// on 132 SMs, 1.29 TB/s.  Spread over every SM with each thread's elements
// brought by cp.async, such a kernel still reached only 1.5 TB/s at any ring
// depth: with a load, a store and their 64-bit addresses for every element,
// each warp's instruction stream is the limit, since a warp alone on its SM
// sub-partition waits out each instruction's latency.  So rglru_bwd_tma
// brings each group of kU steps of dh, a and h (a 2-D box of kThreads
// channels x kU steps each) into a ring of kStages groups in shared memory
// by TMA, issued by one thread, walking T backwards; a step is then three
// loads from shared memory, the three operations and two stores to shared
// memory at addresses fixed at compile time, and each group's da and db
// leave by two TMA stores, double-buffered.  The boxes' ragged edges (W, and
// t < 0 past the first step) are zero-filled on the way in and clipped on
// the way out; no box starts before t = 0 (the last group's start at 0, and
// its da and db go out by plain stores).  Its shape was chosen by timing
// variants at the train shape on the H100: 64 channels a block (80 blocks),
// groups of 16 steps, 4 in flight, 64 KB of shared memory a block; groups
// of 8 or 4 steps cost more a step, 2 groups in flight were too few, and 32
// channels a block (160 blocks, every SM) ran 2 % slower.  A chunked
// two-pass scan over T would put more channels in flight but would sum in
// another order and lose the bitwise equality.

#include <stddef.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 64;  // rglru_bwd_tma: channels a block
constexpr int kU = 16;        // steps a group of TMA copies
constexpr int kStages = 4;    // groups in flight
constexpr int kPrefetchThreads = 128;  // rglru_bwd: channels a block
constexpr int U = 16;  // steps loaded ahead (8 ran slower at the train shape, 24 no faster)

__device__ __forceinline__ float load_f32(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, size_t i, float x) { p[i] = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, size_t i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

// One step of the reverse walk, the plain version's rounding: c = dh + g,
// da = c h_{t-1}, and the next g = a c.
__device__ __forceinline__ float step(float dht, float at, float hp, float& g, float& da) {
  const float c = __fadd_rn(dht, g);
  da = __fmul_rn(c, hp);
  g = __fmul_rn(at, c);
  return c;
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
__global__ void __launch_bounds__(kPrefetchThreads)
rglru_bwd(const Elem* __restrict__ a, const Elem* __restrict__ h,
          const float* __restrict__ h0, const Elem* __restrict__ dh,
          const float* __restrict__ dh_last, Elem* __restrict__ da, Elem* __restrict__ db,
          float* __restrict__ dh0, int T, int W, int w_blocks) {
  const int bi = blockIdx.x / w_blocks;
  const int w = (blockIdx.x - bi * w_blocks) * kPrefetchThreads + threadIdx.x;
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float& out, float x) { out = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16& out, float x) {
  out = __float2bfloat16_rn(x);
}

// One box of a 3-D tensor map into global memory from shared memory, at
// coordinates (w, t, b).
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int w, int t,
                                          int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(w), "r"(t), "r"(b)
      : "memory");
}

// Shared memory of rglru_bwd_tma: the ring of kStages groups of dh, a and
// h_{t-1} (each kU rows of kThreads elements, row r the step t0 - (kU - 1 -
// r) of group t0), two buffers of da and db, and a full barrier a stage.
template <typename Elem>
struct TmaSmem {
  alignas(128) Elem in[kStages][3][kU][kThreads];
  alignas(128) Elem out[2][2][kU][kThreads];
  alignas(8) uint64_t full[kStages];
};

template <typename Elem>
__global__ void __launch_bounds__(kThreads)
rglru_bwd_tma(const float* __restrict__ h0, const float* __restrict__ dh_last,
              Elem* __restrict__ da, Elem* __restrict__ db, float* __restrict__ dh0, int T,
              int W, int w_blocks,
              const __grid_constant__ CUtensorMap tm_dh, const __grid_constant__ CUtensorMap tm_a,
              const __grid_constant__ CUtensorMap tm_h, const __grid_constant__ CUtensorMap tm_da,
              const __grid_constant__ CUtensorMap tm_db) {
  extern __shared__ uint8_t smem_raw[];  // TmaSmem, from a 128-byte boundary
  TmaSmem<Elem>& sm = *reinterpret_cast<TmaSmem<Elem>*>(
      smem_raw + ((128 - smem_u32(smem_raw) % 128) % 128));
  const int tid = threadIdx.x;  // channel w0 + tid
  const int bi = blockIdx.x / w_blocks;
  const int w0 = (blockIdx.x - bi * w_blocks) * kThreads, w = w0 + tid;
  const bool real = w < W;
  const size_t state = (size_t)bi * W + w;
  const float h_init = real && h0 ? h0[state] : 0.f;
  float g = real && dh_last ? dh_last[state] : 0.f;
  const int groups = (T + kU - 1) / kU;
  constexpr uint32_t kGroupBytes = 3 * kU * kThreads * sizeof(Elem);

  // group k: steps t0 = T - 1 - k kU down to t0 - kU + 1, the box of rows
  // t0 - kU + 1 .. t0 (h: one row earlier); a box never starts before row
  // 0, so the last group's boxes start at 0 (dh and a: row t, h: row t - 1)
  auto issue = [&](int k) {
    const int s = k % kStages, first = T - k * kU - kU;
    const uint32_t bar = smem_u32(&sm.full[s]);
    mbar_expect_tx(bar, kGroupBytes);
    tma_load(smem_u32(&sm.in[s][0][0][0]), &tm_dh, bar, w0, max(first, 0), bi);
    tma_load(smem_u32(&sm.in[s][1][0][0]), &tm_a, bar, w0, max(first, 0), bi);
    tma_load(smem_u32(&sm.in[s][2][0][0]), &tm_h, bar, w0, max(first - 1, 0), bi);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&sm.full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int k = 0; k < kStages && k < groups; ++k) issue(k);
  }
  __syncthreads();

  for (int k = 0; k < groups; ++k) {
    const int s = k % kStages, o = k & 1, t0 = T - 1 - k * kU;
    if (k >= 2) {  // group k - 2's stores have read this output buffer
      if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      __syncthreads();
    }
    mbar_wait(smem_u32(&sm.full[s]), (k / kStages) & 1);
    if (t0 >= kU) {  // every step of the group has t >= 1
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int r = kU - 1 - u;
        float dav;
        const float c = step(to_f32(sm.in[s][0][r][tid]), to_f32(sm.in[s][1][r][tid]),
                             to_f32(sm.in[s][2][r][tid]), g, dav);
        from_f32(sm.out[o][1][r][tid], c);
        from_f32(sm.out[o][0][r][tid], dav);
      }
    } else {  // the last group: steps t0 .. 0, h_{-1} = h0, stored directly
      const size_t base = (size_t)bi * T * W + w;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int t = t0 - u;
        if (t < 0) break;
        float dav;
        const float hp = t >= 1 ? to_f32(sm.in[s][2][t - 1][tid]) : h_init;
        const float c = step(to_f32(sm.in[s][0][t][tid]), to_f32(sm.in[s][1][t][tid]), hp, g,
                             dav);
        if (real) {
          store_f32(db, base + (size_t)t * W, c);
          store_f32(da, base + (size_t)t * W, dav);
        }
      }
    }
    fence_proxy_async();  // this thread's da and db, to the TMA stores
    __syncthreads();      // and every thread is done with stage s
    if (tid == 0) {
      if (t0 >= kU) {  // a box that starts inside the tensor
        const int first = T - k * kU - kU;
        tma_store(&tm_da, smem_u32(&sm.out[o][0][0][0]), w0, first, bi);
        tma_store(&tm_db, smem_u32(&sm.out[o][1][0][0]), w0, first, bi);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
      if (k + kStages < groups) issue(k + kStages);
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  if (real) dh0[state] = g;
}

// A 3-D map over a contiguous (B, T, W) tensor of elem_bytes elements,
// innermost first, whose box is kThreads elements of W x kU steps x 1 batch.
// Out-of-range elements are zeros on a load and left alone on a store.
CUresult encode_btw(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int elem_bytes,
                    int B, int T, int W) {
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * elem_bytes, (cuuint64_t)T * W * elem_bytes};
  const cuuint32_t box[3] = {(cuuint32_t)kThreads, (cuuint32_t)kU, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode_tiled()(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <typename Elem>
int launch_tma(const void* a, const void* h, const float* h0, const void* dh,
               const float* dh_last, void* da, void* db, float* dh0, int B, int T, int W,
               cudaStream_t stream) {
  constexpr int e = sizeof(Elem);
  const bool aligned = ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(h) |
                         reinterpret_cast<uintptr_t>(dh) | reinterpret_cast<uintptr_t>(da) |
                         reinterpret_cast<uintptr_t>(db)) %
                        16) == 0;
  if (!aligned || ((long long)W * e) % 16 != 0) return cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return cudaErrorSymbolNotFound;
  const CUtensorMapDataType type =
      e == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap maps[5];
  const void* ptrs[5] = {dh, a, h, da, db};
  for (int x = 0; x < 5; ++x) {
    const CUresult r = encode_btw(&maps[x], ptrs[x], type, e, B, T, W);
    if (r != CUDA_SUCCESS) return kTensorMapError | static_cast<int>(r);
  }
  constexpr int bytes = sizeof(TmaSmem<Elem>) + 128;
  const cudaError_t err = cudaFuncSetAttribute(
      rglru_bwd_tma<Elem>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int w_blocks = (W + kThreads - 1) / kThreads;
  rglru_bwd_tma<Elem><<<B * w_blocks, kThreads, bytes, stream>>>(
      h0, dh_last, static_cast<Elem*>(da), static_cast<Elem*>(db), dh0, T, W, w_blocks, maps[0],
      maps[1], maps[2], maps[3], maps[4]);
  return cudaGetLastError();
}

template <typename Elem>
int launch_prefetch(const void* a, const void* h, const float* h0, const void* dh,
                    const float* dh_last, void* da, void* db, float* dh0, int B, int T, int W,
                    cudaStream_t stream) {
  const int w_blocks = (W + kPrefetchThreads - 1) / kPrefetchThreads;
  rglru_bwd<Elem><<<B * w_blocks, kPrefetchThreads, 0, stream>>>(
      static_cast<const Elem*>(a), static_cast<const Elem*>(h), h0,
      static_cast<const Elem*>(dh), dh_last, static_cast<Elem*>(da), static_cast<Elem*>(db),
      dh0, T, W, w_blocks);
  return cudaGetLastError();
}

// Whether B, T and W fit the grid of blocks of `threads` channels.
bool takes(int B, int T, int W, int threads) {
  return B > 0 && T > 0 && W > 0 && W <= 2147483647 - threads &&
         (long long)B * ((W + threads - 1) / threads) <= 2147483647LL;
}

}  // namespace

// Each entry point: dtype 0 float32, 1 bfloat16; h0 and dh_last may be null
// (zeros).  Returns cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for arguments its kernel does not take (the TMA
// route: any of a, h, dh, da and db off a 16-byte boundary, or a row of W
// elements not a multiple of 16 bytes), or kTensorMapError | CUresult when a
// tensor map cannot be encoded.
extern "C" int rglru_scan_bwd_tma(const void* a, const void* h, const float* h0, const void* dh,
                                  const float* dh_last, void* da, void* db, float* dh0,
                                  int dtype, int B, int T, int W, void* stream) {
  if (!takes(B, T, W, kThreads)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_tma<float>(a, h, h0, dh, dh_last, da, db, dh0, B, T, W, s);
  if (dtype == 1)
    return launch_tma<__nv_bfloat16>(a, h, h0, dh, dh_last, da, db, dh0, B, T, W, s);
  return cudaErrorInvalidValue;
}

extern "C" int rglru_scan_bwd_prefetch(const void* a, const void* h, const float* h0,
                                       const void* dh, const float* dh_last, void* da, void* db,
                                       float* dh0, int dtype, int B, int T, int W,
                                       void* stream) {
  if (!takes(B, T, W, kPrefetchThreads)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_prefetch<float>(a, h, h0, dh, dh_last, da, db, dh0, B, T, W, s);
  if (dtype == 1)
    return launch_prefetch<__nv_bfloat16>(a, h, h0, dh, dh_last, da, db, dh0, B, T, W, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* rglru_scan_bwd_error_string(int err) {
  if (err & kTensorMapError)
    return "cuTensorMapEncodeTiled refused a tensor map (its CUresult is the code's low 16 bits)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
