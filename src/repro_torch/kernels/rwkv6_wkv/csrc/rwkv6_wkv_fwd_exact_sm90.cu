// RWKV6 (Finch) WKV recurrence, forward, in chunks for Hopper (sm_90a), with
// y the recurrent route's: the "chunk_exact" route of rwkv6_wkv_fwd, which
// route() in kernel.py sends the forward of a gradient to in bf16 at head
// dim 64 with T >= 2 (rwkv6-7b's training).  Like the other routes it
// replaces the Pallas TPU kernel
//   src/repro/kernels/rwkv6_wkv/kernel.py :: rwkv6_wkv_kernel
// and computes, for each (b, h) from s0 (zeros when s0 is null),
//   y_t = r_t^T (S_t + (u . k_t) v_t^T),   S_{t+1} = diag(w_t) S_t + k_t v_t^T.
//
// Why not the serving chunk route (rwkv6_wkv_fwd_sm90.cu).  Its y takes
// single bf16 roundings of r . P, of S_c, of the decayed r and k and of the
// scores: 2.9e-3 relative on its cases against the recurrent route's
// 2.3e-4, which moved the bf16 gradients of rwkv6-7b's train slice past
// 2e-2 (PERF.md).  The backward differentiates the exact recurrence, so
// the forward of a gradient has to give y to f32 rounding, rounded once;
// and the slice's bf16 gradients follow each rounding of y (a y one bf16
// step off at a few elements moved them by half the slice's limit), so y
// is best the recurrent route's own.  Why not the recurrent route: it walks
// each (b, h)'s T steps as one chain, 128 blocks of 2 warps at the train
// shape.  Here two launches:
//   wkv_chain (rwkv6_wkv_chain_sm90.cuh), direction 0: S_c at each 64-step
//     chunk's start, chained over the chunks on the tensor cores with an f32
//     accumulator and the decayed k in three bf16 pieces (its 24 bits), and
//     s_last after the last;
//   wkv_fwd (rwkv6_wkv_fwd.cu, the recurrent route's kernel) with one block
//     a (b, h, chunk), 8192 at the train shape, each walking its chunk's
//     64 steps from S_c with that route's arithmetic, step for step: y is
//     the recurrent route's wherever S_c, from the chain, rounds as the
//     4096-step walk does, and otherwise differs from it by f32 rounding.
// Nothing divides by w, nothing forms a prefix sum of log w: every decay is
// a running product of w, every factor at most 1.
//
// What bounds it.  At rwkv6-7b's train shape (2, 4096, 64, 64) it reads r,
// k, v and w (4 x 67.1 MB) and writes y (67.1 MB) and s_last (2.1 MB), 338
// MB, 0.10 ms at 3.35 TB/s, and the chunk states, 134 MB written and read
// once.  The walks, 3 D^2 operations a (b, h, t), 1.3e10, are about 0.2 ms
// of the CUDA cores at full issue; each step of a block is a dependent chain
// of 64 FMAs, and about nine blocks an SM hide each other's chains.

#include "sm90.cuh"
#include "rwkv6_wkv_chain_sm90.cuh"

// The recurrent route's kernel over chunks from given states
// (rwkv6_wkv_fwd.cu).
extern "C" int rwkv6_wkv_fwd_walk_chunks(const void* r, const void* k, const void* v,
                                         const void* w, const float* u, const float* states,
                                         void* y, int chunk, int B, int T, int H, void* stream);

// The chunk_exact route's entry point: bf16 at head dim 64; route() in
// kernel.py decides which launches come here.  s0 may be null (a zero
// state).  states is scratch of B H ceil(T / 64) D^2 floats
// (rwkv6_wkv_fwd_chunk_steps() gives the 64).  Returns cudaGetLastError()
// after the launches, cudaErrorInvalidValue for arguments it does not
// take, or kTensorMapError | CUresult when a tensor map cannot be encoded
// (rwkv6_wkv_fwd_error_string reads either).
extern "C" int rwkv6_wkv_fwd_chunk_exact(const void* r, const void* k, const void* v,
                                         const void* w, const float* u, const float* s0, void* y,
                                         float* s_last, float* states, int B, int T, int H, int D,
                                         void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || D != chain::kD || (long long)B * H > 2147483647LL)
    return cudaErrorInvalidValue;
  const int n_chunks = (T + chain::kC - 1) / chain::kC;
  if ((long long)B * H * n_chunks > 2147483647LL) return cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap maps[3];
  const void* ptrs[3] = {w, k, v};
  for (int x = 0; x < 3; ++x) {
    const CUresult res = encode(&maps[x], ptrs[x], B, T, H, chain::kD, chain::kC);
    if (res != CUDA_SUCCESS) return kTensorMapError | static_cast<int>(res);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  chain::Args ca{};
  ca.init[0] = s0;
  ca.out[0] = states;
  ca.last[0] = s_last;
  ca.T = T;
  ca.H = H;
  // direction 1 is not launched: its maps repeat direction 0's
  const CUtensorMap chain_maps[5] = {maps[0], maps[1], maps[2], maps[1], maps[2]};
  const cudaError_t err = chain::launch_chain(ca, B * H, 1, chain_maps, s);
  if (err != cudaSuccess) return err;
  return rwkv6_wkv_fwd_walk_chunks(r, k, v, w, u, states, y, chain::kC, B, T, H, stream);
}

extern "C" int rwkv6_wkv_fwd_chunk_steps() { return chain::kC; }
