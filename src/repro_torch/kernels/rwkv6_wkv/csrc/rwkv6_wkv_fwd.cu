// RWKV6 (Finch) WKV recurrence, forward, for NVIDIA Hopper (sm_90a).
//
// The "recurrent" route of rwkv6_wkv_fwd: route() in kernel.py sends it f32
// at every head dim, bf16 at head dims 8, 16 and 32, and T = 1, every decode
// step; bf16 prefill at head dim 64 goes to wkv_fwd_chunk in
// rwkv6_wkv_fwd_sm90.cu.  The same kernel also walks the chunks of the
// "chunk_exact" route (rwkv6_wkv_fwd_exact_sm90.cu, the forward of a
// gradient in bf16 at head dim 64): one block a (b, h, chunk of 64 steps),
// each from the chunk's state that the chain there computed, with this
// route's arithmetic step for step.  Replaces the Pallas TPU kernel
//   src/repro/kernels/rwkv6_wkv/kernel.py :: rwkv6_wkv_kernel
// (body _wkv_kernel).  It computes what that kernel computes: for each
// (b, h), a D x D state S in f32, with S[i][j] indexed by i over k and j over
// v, and for each step t
//   y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//   S[i][j] <- w_t[i] S[i][j] + k_t[i] v_t[j]
// from s0 (or zeros when s0 is null).  r, k, v, w are f32 or bf16 and y is
// written in their type; u, s0 and s_last are f32.
//
// Layout: r, k, v, w and y (B, T, H, D); u (H, D); s0 and s_last
// (B, H, D, D); all contiguous.
//
// The TPU kernel's grid ran (batch, head, time block) in order on one core
// and carried S in VMEM scratch from one time block to the next.  Here one
// thread block of D threads owns one (b, h) and walks all T steps in a loop,
// so the state never leaves the block: thread j keeps column j of S in D
// registers.  Each step the block stages (r_i, k_i, w_i, u_i k_i) as one
// float4 per i in shared memory, double-buffered, so one __syncthreads() a
// step suffices; thread j also holds v_t[j] in a register.  The next step's
// loads are issued before this step's arithmetic.  Any T >= 1 is taken;
// offsets are 64-bit.
//
// What bounds it.  At the rwkv6-7b prefill shape (8, 1024, 64, 64) in bf16
// the function reads r, k, v, w (4 x 67.1 MB), writes y (67.1 MB) and
// writes s_last (8.4 MB): about 344 MB, 0.10 ms at 3.35 TB/s.  Its 4 D^2
// FLOP per (b, h, t), 8.6e9 in all, take 0.13 ms even at the CUDA cores'
// f32 rate, so bytes set the floor.  This first version is limited by
// neither: each of the B x H blocks runs its T steps one after the other,
// with a barrier and a dependent chain of D FMAs per step, and holds only D
// threads.  That is what the chunk route is for; a decode step (T = 1) has
// no chain, and f32 stays here because its callers hold it to 1e-5 of the
// plain version step by step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, size_t i, float x) { p[i] = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, size_t i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;
  const float* s0;  // null: a zero state
  void* y;
  float* s_last;
  int T, H;
  // The chunk_exact route's walk: block (b h) n_chunks + n walks steps
  // chunk n .. from states[b h][n] (D x D f32) and writes no s_last.  The
  // recurrent route: states null, one chunk of T steps, from s0.
  const float* states;
  int chunk, n_chunks;
};

template <typename Elem, int D>
__global__ void __launch_bounds__(D) wkv_fwd(Params p) {
  const Elem* __restrict__ r = static_cast<const Elem*>(p.r);
  const Elem* __restrict__ k = static_cast<const Elem*>(p.k);
  const Elem* __restrict__ v = static_cast<const Elem*>(p.v);
  const Elem* __restrict__ w = static_cast<const Elem*>(p.w);
  Elem* __restrict__ y = static_cast<Elem*>(p.y);

  __shared__ float4 s_rkwu[2][D];  // (r_i, k_i, w_i, u_i k_i) of one step

  const int j = threadIdx.x;
  const int bh = blockIdx.x / p.n_chunks;  // b * H + h
  const int n = blockIdx.x - bh * p.n_chunks;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int t0 = n * p.chunk, t_end = min(p.T, t0 + p.chunk);
  const size_t step = (size_t)p.H * D;                     // stride of t
  size_t off = (((size_t)b * p.T + t0) * p.H + h) * D + j;  // (b, t0, h, j)
  const size_t s_off = (size_t)bh * D * D + j;             // (b, h, 0, j)
  const float uj = p.u[h * D + j];

  float S[D];  // S[i] is S[i][j]
  const float* init = p.states ? p.states + (size_t)blockIdx.x * D * D + j
                      : p.s0     ? p.s0 + s_off
                                 : nullptr;
#pragma unroll
  for (int i = 0; i < D; ++i) S[i] = init ? init[(size_t)i * D] : 0.f;

  float kj = load_f32(k, off);
  s_rkwu[0][j] = make_float4(load_f32(r, off), kj, load_f32(w, off), uj * kj);
  float vj = load_f32(v, off);
  __syncthreads();

  for (int t = t0; t < t_end; ++t) {
    const int cur = (t - t0) & 1;
    const bool more = t + 1 < t_end;
    const size_t off_next = off + step;
    float rn = 0.f, kn = 0.f, wn = 0.f, vn = 0.f;
    if (more) {
      rn = load_f32(r, off_next);
      kn = load_f32(k, off_next);
      wn = load_f32(w, off_next);
      vn = load_f32(v, off_next);
    }
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float4 q = s_rkwu[cur][i];
      acc = fmaf(q.x, fmaf(q.w, vj, S[i]), acc);
      S[i] = fmaf(q.z, S[i], q.y * vj);
    }
    store_f32(y, off, acc);
    if (more) {
      // the other buffer was last read in step t - 1, before its barrier
      s_rkwu[cur ^ 1][j] = make_float4(rn, kn, wn, uj * kn);
      vj = vn;
      off = off_next;
    }
    __syncthreads();
  }

  if (p.states) return;
#pragma unroll
  for (int i = 0; i < D; ++i) p.s_last[s_off + (size_t)i * D] = S[i];
}

template <typename Elem, int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  wkv_fwd<Elem, D><<<B * p.H * p.n_chunks, D, 0, stream>>>(p);
  return cudaGetLastError();
}

// Keep the head sizes in step with HEAD_DIMS in kernel.py.
template <typename Elem>
cudaError_t dispatch(const Params& p, int B, int D, cudaStream_t s) {
  if (D == 8) return launch<Elem, 8>(p, B, s);
  if (D == 16) return launch<Elem, 16>(p, B, s);
  if (D == 32) return launch<Elem, 32>(p, B, s);
  if (D == 64) return launch<Elem, 64>(p, B, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// The recurrent route's entry point.  dtype: 0 float32, 1 bfloat16.  s0 may
// be null (a zero state).  Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for arguments the kernel does not take;
// rwkv6_wkv_fwd_error_string (rwkv6_wkv_fwd_sm90.cu) gives the message.
extern "C" int rwkv6_wkv_fwd_recurrent(const void* r, const void* k, const void* v,
                                       const void* w, const float* u, const float* s0, void* y,
                                       float* s_last, int dtype, int B, int T, int H, int D,
                                       void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || (long long)B * H > 2147483647LL)
    return cudaErrorInvalidValue;
  const Params p{r, k, v, w, u, s0, y, s_last, T, H, nullptr, T, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, B, D, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, B, D, s);
  return cudaErrorInvalidValue;
}

// The chunk_exact route's walk, which rwkv6_wkv_fwd_chunk_exact
// (rwkv6_wkv_fwd_exact_sm90.cu) launches after its chain: bf16 at head dim
// 64, one block a (b, h, chunk of `chunk` steps), each from states[b h][n]
// (B H ceil(T / chunk) D^2 f32), y only.  Returns cudaGetLastError().
extern "C" int rwkv6_wkv_fwd_walk_chunks(const void* r, const void* k, const void* v,
                                         const void* w, const float* u, const float* states,
                                         void* y, int chunk, int B, int T, int H,
                                         void* stream) {
  const int n_chunks = (T + chunk - 1) / chunk;
  if ((long long)B * H * n_chunks > 2147483647LL) return cudaErrorInvalidValue;
  const Params p{r, k, v, w, u, nullptr, y, nullptr, T, H, states, chunk, n_chunks};
  return launch<__nv_bfloat16, 64>(p, B, static_cast<cudaStream_t>(stream));
}
