// RWKV6 (Finch) WKV recurrence, backward, for NVIDIA Hopper (sm_90a).
//
// The gradient of what rwkv6_wkv_fwd.cu and rwkv6_wkv_fwd_sm90.cu compute.
// The Pallas TPU kernel
//   src/repro/kernels/rwkv6_wkv/kernel.py :: rwkv6_wkv_kernel
// has no backward of its own: on the TPU jax.grad differentiates the plain
// recurrence (src/repro/kernels/rwkv6_wkv/ref.py :: rwkv6_reference, a
// lax.scan).  Here the forward is a kernel, so its gradient is one too.  For
// each (b, h), with S_t the D x D state before step t (S[i][j], i over k, j
// over v; S_0 = s0, or zeros) and G_t the gradient that reaches S_{t+1}
// (G_{T-1} = ds_last, or zeros), walking t from T - 1 down to 0:
//   dr_t[i] = sum_j S_t[i][j] dy_t[j] + u[i] k_t[i] (v_t . dy_t)
//   dk_t[i] = u[i] r_t[i] (v_t . dy_t) + sum_j G_t[i][j] v_t[j]
//   dv_t[j] = dy_t[j] sum_i u[i] r_t[i] k_t[i] + sum_i k_t[i] G_t[i][j]
//   dw_t[i] = sum_j S_t[i][j] G_t[i][j]
//   G_{t-1}[i][j] = w_t[i] G_t[i][j] + r_t[i] dy_t[j],   ds0 = G_{-1},
// and du[h][i] = sum over b and t of r_t[i] k_t[i] (v_t . dy_t).  Every sum
// is in f32; dr, dk, dv and dw are written in the inputs' type (f32 or
// bf16), du and ds0 in f32.  ref.py :: rwkv6_wkv_bwd_reference is the plain
// version.
//
// Layout: r, k, v, w, dy and dr, dk, dv, dw (B, T, H, D); u and du (H, D);
// s0, ds_last and ds0 (B, H, D, D); all contiguous.  Any T >= 1 is taken,
// head dims 8, 16, 32 and 64 (HEAD_DIMS in kernel.py); offsets are 64-bit.
//
// The numeric constraint.  The model's decay w = exp(-exp(x)) is exactly 0
// in bf16 at times (log w reaches -100 in a step) and exactly 1 at others.
// So no state is rebuilt from a later one (that divides by w), and nothing
// forms a prefix product or a prefix sum of log w: dw_t needs S_t and G_t at
// the same t, and S_t comes from a forward walk from s0, with S saved at the
// start of every chunk of kC = 8 steps.
//
// Three kernels, in order on the stream, one launch of the entry point:
//   wkv_bwd_fwd  one block of D threads a (b, h); thread i keeps row i of S
//                in registers and walks t forward from s0.  At each chunk's
//                start it writes S to the checkpoints (ck, column-major so a
//                warp's stores coalesce); each step it writes dr_t[i], adds
//                r_t[i] k_t[i] (v_t . dy_t) to its du, and thread 0 writes
//                v_t . dy_t (vdy) for the next kernel.  Then its du partial.
//   wkv_bwd_rev  one block of 2D threads a (b, h), walking the chunks from
//                the last.  Threads 0..D-1 (row layout, thread i row i of S
//                and of G): load the chunk's checkpoint, walk its steps
//                forward again writing each S_t row to shared memory, then
//                walk them backwards: dw_t[i] and dk_t[i] from their own
//                row, then G's row update.  Threads D..2D-1 (column layout,
//                thread j column j of G) walk the same steps backwards
//                meanwhile, needing no S: dv_t[j], then G's column update;
//                at the end they write ds0 (coalesced).  So every sum is
//                inside one thread and no step needs a reduction across
//                threads.  Both layouts update G by the same two roundings,
//                __fmaf_rn(w, g, __fmul_rn(r, dy)), so their copies agree
//                to the bit; S likewise in both walks, from the same
//                checkpoints.
//   wkv_bwd_du   du[h][i] = the per-(b, h) partials summed over b in order.
// Each chunk's r, k, v, w and dy come into shared memory as f32, double-
// buffered: the next chunk's loads go out into registers before this
// chunk's arithmetic, so one __syncthreads() a chunk suffices.  Nothing is
// summed by atomics, and every sum runs in a fixed order (four partial sums
// a dot product, then (a0 + a1) + (a2 + a3)): two calls on the same inputs
// give the same bits.
//
// Scratch (the wrapper allocates it; the kernels allocate nothing).  The
// checkpoints: B H ceil(T / kC) D^2 f32, 1.07 GB at rwkv6-7b's train shape
// (2, 4096, 64, 64), written and read once each, and freed when the call
// returns (remat runs one layer's backward at a time); vdy, B H T f32 (2.1
// MB there); the du partials, B H D f32.  Shared memory of wkv_bwd_rev:
// kC S rows of D + 4 floats for each of its D rows (the 4 keep a quarter
// warp's float4 accesses on distinct banks), 139,264 bytes at D = 64, one
// more such row for G while the rows of S are walked again (17,408 bytes),
// two stages of kC steps of 5 D floats (20,480 bytes) and u, 177,472 bytes
// in all; one block an SM.
//
// What bounds it.  At rwkv6-7b's train shape (2, 4096, 64, 64) in bf16 the
// function reads r, k, v, w and dy (5 x 67.1 MB) and writes dr, dk, dv and
// dw (4 x 67.1 MB): 604 MB, 0.18 ms at 3.35 TB/s.  Its arithmetic, about
// 14 D^2 FLOP a (b, h, t) (the S walk and the G walk 3 D^2 each, dr, dk,
// dv and dw 2 D^2 each), is 3.0e10 FLOP, 0.45 ms at the CUDA cores' 67
// TFLOP/s in f32, so operations set the floor.  This first version is held
// by neither: each of the B x H blocks walks its T steps one after the
// other (twice), each SM holds one block of 4 warps, and a step of a row
// thread is about 4 D dependent-chain FMAs and D / 4 float4 loads from
// shared memory.  A chunked form on the tensor cores, as the forward's
// chunk route, is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kC = 8;       // steps a chunk: a checkpoint at each chunk's start
constexpr int kFields = 5;  // staged inputs a step: r, k, v, w, dy
constexpr int kR = 0, kK = 1, kV = 2, kW = 3, kDy = 4;

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
  const float* s0;       // null: a zero state
  const void* dy;
  const float* ds_last;  // null: zero
  void* dr;
  void* dk;
  void* dv;
  void* dw;
  float* du;
  float* ds0;
  float* ck;       // (B H, n_chunks, D, D): S at each chunk's start, [j][i]
  float* vdy;      // (B H, T): v_t . dy_t
  float* du_part;  // (B, H, D)
  int B, T, H, n_chunks;
};

// sum_q a[q] . b[q] over D / 4 float4 pairs, four partial sums in a fixed order.
template <int D>
__device__ __forceinline__ float dot(const float4* a, const float4* b) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int q = 0; q < D / 4; ++q) {
    const float4 x = a[q], y = b[q];
    s0 = fmaf(x.x, y.x, s0);
    s1 = fmaf(x.y, y.y, s1);
    s2 = fmaf(x.z, y.z, s2);
    s3 = fmaf(x.w, y.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// sum_j x[j] b[j] with x in registers, the same order as dot().
template <int D>
__device__ __forceinline__ float dot_reg(const float (&x)[D], const float4* b) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int q = 0; q < D / 4; ++q) {
    const float4 y = b[q];
    s0 = fmaf(x[4 * q], y.x, s0);
    s1 = fmaf(x[4 * q + 1], y.y, s1);
    s2 = fmaf(x[4 * q + 2], y.z, s2);
    s3 = fmaf(x[4 * q + 3], y.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// x[j] <- a x[j] + c b[j], rounded twice (the product c b[j], then the fma).
template <int D>
__device__ __forceinline__ void decay_add(float (&x)[D], float a, float c, const float4* b) {
#pragma unroll
  for (int q = 0; q < D / 4; ++q) {
    const float4 y = b[q];
    x[4 * q] = __fmaf_rn(a, x[4 * q], __fmul_rn(c, y.x));
    x[4 * q + 1] = __fmaf_rn(a, x[4 * q + 1], __fmul_rn(c, y.y));
    x[4 * q + 2] = __fmaf_rn(a, x[4 * q + 2], __fmul_rn(c, y.z));
    x[4 * q + 3] = __fmaf_rn(a, x[4 * q + 3], __fmul_rn(c, y.w));
  }
}

// One field of one step in a stage: D floats, 16-byte aligned.
__device__ __forceinline__ float* field(float* stage, int buf, int s, int f, int D) {
  return stage + ((buf * kC + s) * kFields + f) * D;
}

template <typename Elem, int D>
__global__ void __launch_bounds__(D) wkv_bwd_fwd(Params p) {
  const Elem* __restrict__ r = static_cast<const Elem*>(p.r);
  const Elem* __restrict__ k = static_cast<const Elem*>(p.k);
  const Elem* __restrict__ v = static_cast<const Elem*>(p.v);
  const Elem* __restrict__ w = static_cast<const Elem*>(p.w);
  const Elem* __restrict__ dy = static_cast<const Elem*>(p.dy);
  Elem* __restrict__ dr = static_cast<Elem*>(p.dr);

  __shared__ __align__(16) float stage[2 * kC * kFields * D];

  const int i = threadIdx.x;
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const size_t step = (size_t)p.H * D;                    // stride of t
  const size_t base = ((size_t)b * p.T * p.H + h) * D + i;  // (b, 0, h, i)
  const float ui = p.u[h * D + i];

  float S[D];  // row i of the state
  const float* s0 = p.s0 ? p.s0 + ((size_t)bh * D + i) * D : nullptr;
#pragma unroll
  for (int j = 0; j < D; ++j) S[j] = s0 ? s0[j] : 0.f;

  float pre[kC][kFields];  // the next chunk's inputs at channel i
  auto load = [&](int t0) {
#pragma unroll
    for (int s = 0; s < kC; ++s) {
      const bool in = t0 + s < p.T;
      const size_t off = base + (size_t)(t0 + s) * step;
      pre[s][kR] = in ? load_f32(r, off) : 0.f;
      pre[s][kK] = in ? load_f32(k, off) : 0.f;
      pre[s][kV] = in ? load_f32(v, off) : 0.f;
      pre[s][kW] = in ? load_f32(w, off) : 0.f;
      pre[s][kDy] = in ? load_f32(dy, off) : 0.f;
    }
  };
  load(0);
  float du = 0.f;  // the chunks' sums, each chunk's summed apart first
  for (int c = 0; c < p.n_chunks; ++c) {
    const int buf = c & 1;
    const int t0 = c * kC;
    const int n = min(kC, p.T - t0);
#pragma unroll
    for (int s = 0; s < kC; ++s)
#pragma unroll
      for (int f = 0; f < kFields; ++f) field(stage, buf, s, f, D)[i] = pre[s][f];
    // the other buffer was last read in chunk c - 1, before this barrier
    __syncthreads();
    if (c + 1 < p.n_chunks) load(t0 + kC);  // out before this chunk's arithmetic

    float* ck = p.ck + ((size_t)bh * p.n_chunks + c) * D * D + i;
#pragma unroll
    for (int j = 0; j < D; ++j) ck[(size_t)j * D] = S[j];

    float du_chunk = 0.f;
#pragma unroll 1
    for (int s = 0; s < n; ++s) {
      const float4* v4 = reinterpret_cast<const float4*>(field(stage, buf, s, kV, D));
      const float4* dy4 = reinterpret_cast<const float4*>(field(stage, buf, s, kDy, D));
      const float ri = field(stage, buf, s, kR, D)[i];
      const float ki = field(stage, buf, s, kK, D)[i];
      const float wi = field(stage, buf, s, kW, D)[i];
      const float vdy = dot<D>(v4, dy4);
      const float sdy = dot_reg<D>(S, dy4);
      const size_t off = base + (size_t)(t0 + s) * step;
      store_f32(dr, off, fmaf(ui * ki, vdy, sdy));
      du_chunk = fmaf(ri * ki, vdy, du_chunk);
      if (i == 0) p.vdy[(size_t)bh * p.T + t0 + s] = vdy;
      decay_add<D>(S, wi, ki, v4);
    }
    du += du_chunk;
  }
  p.du_part[(size_t)bh * D + i] = du;
}

template <int D>
constexpr size_t rev_smem_bytes() {
  return sizeof(float) * ((size_t)(kC + 1) * D * (D + 4) + 2 * kC * kFields * D + D + 2 * kC);
}

template <typename Elem, int D>
__global__ void __launch_bounds__(2 * D) wkv_bwd_rev(Params p) {
  const Elem* __restrict__ r = static_cast<const Elem*>(p.r);
  const Elem* __restrict__ k = static_cast<const Elem*>(p.k);
  const Elem* __restrict__ v = static_cast<const Elem*>(p.v);
  const Elem* __restrict__ w = static_cast<const Elem*>(p.w);
  const Elem* __restrict__ dy = static_cast<const Elem*>(p.dy);

  extern __shared__ float4 smem4[];
  float* states = reinterpret_cast<float*>(smem4);  // [kC][D][D + 4]
  float* gpark = states + kC * D * (D + 4);          // [D][D + 4]: G's rows
  float* stage = gpark + D * (D + 4);                // [2][kC][kFields][D]
  float* su = stage + 2 * kC * kFields * D;          // [D]: u of head h
  float* svdy = su + D;                              // [2][kC]

  const bool row = threadIdx.x < D;
  const int x = row ? threadIdx.x : threadIdx.x - D;  // i (row) or j (column)
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const size_t step = (size_t)p.H * D;
  const size_t base = ((size_t)b * p.T * p.H + h) * D + x;  // (b, 0, h, x)
  const float* u = p.u + h * D;
  const float ux = u[x];

  // G: row x (row layout) or column x (column layout) of the gradient that
  // reaches the state after the step being walked.
  float G[D];
  const float* ds = p.ds_last ? p.ds_last + (size_t)bh * D * D : nullptr;
#pragma unroll
  for (int y = 0; y < D; ++y)
    G[y] = ds ? (row ? ds[(size_t)x * D + y] : ds[(size_t)y * D + x]) : 0.f;
  if (!row) su[x] = ux;  // read after the first chunk's barrier

  // The next chunk's inputs at channel x: r, k and w (row threads), v and
  // dy (column threads; those with x < kC also one step's vdy).
  float pa[kC], pb[kC], pc[kC], pv = 0.f;
  auto load = [&](int t0) {
#pragma unroll
    for (int s = 0; s < kC; ++s) {
      const bool in = t0 + s < p.T;
      const size_t off = base + (size_t)(t0 + s) * step;
      pa[s] = in ? load_f32(row ? r : v, off) : 0.f;
      pb[s] = in ? load_f32(row ? k : dy, off) : 0.f;
      pc[s] = in && row ? load_f32(w, off) : 0.f;
    }
    if (!row && x < kC && t0 + x < p.T) pv = p.vdy[(size_t)bh * p.T + t0 + x];
  };
  load((p.n_chunks - 1) * kC);
  for (int c = p.n_chunks - 1; c >= 0; --c) {
    const int buf = (p.n_chunks - 1 - c) & 1;
    const int t0 = c * kC;
    const int n = min(kC, p.T - t0);
#pragma unroll
    for (int s = 0; s < kC; ++s) {
      field(stage, buf, s, row ? kR : kV, D)[x] = pa[s];
      field(stage, buf, s, row ? kK : kDy, D)[x] = pb[s];
      if (row) field(stage, buf, s, kW, D)[x] = pc[s];
    }
    if (!row && x < kC) svdy[buf * kC + x] = pv;
    // the other buffer was last read in chunk c + 1, before this barrier
    __syncthreads();
    if (c > 0) load(t0 - kC);  // out before this chunk's arithmetic

    if (row) {
      const int i = x;
      float S[D];
      // G waits in shared memory while S walks, so the two rows never
      // share the registers
      float4* grow = reinterpret_cast<float4*>(gpark + (size_t)i * (D + 4));
#pragma unroll
      for (int q = 0; q < D / 4; ++q)
        grow[q] = make_float4(G[4 * q], G[4 * q + 1], G[4 * q + 2], G[4 * q + 3]);
      const float* ck = p.ck + ((size_t)bh * p.n_chunks + c) * D * D + i;
#pragma unroll
      for (int j = 0; j < D; ++j) S[j] = ck[(size_t)j * D];
      // the chunk's states S_t, t = t0 .. t0 + n - 1, row i of each
#pragma unroll 1
      for (int s = 0; s < n; ++s) {
        float4* srow = reinterpret_cast<float4*>(states + ((size_t)s * D + i) * (D + 4));
#pragma unroll
        for (int q = 0; q < D / 4; ++q)
          srow[q] = make_float4(S[4 * q], S[4 * q + 1], S[4 * q + 2], S[4 * q + 3]);
        decay_add<D>(S, field(stage, buf, s, kW, D)[i], field(stage, buf, s, kK, D)[i],
                     reinterpret_cast<const float4*>(field(stage, buf, s, kV, D)));
      }
#pragma unroll
      for (int q = 0; q < D / 4; ++q) {
        const float4 g = grow[q];
        G[4 * q] = g.x;
        G[4 * q + 1] = g.y;
        G[4 * q + 2] = g.z;
        G[4 * q + 3] = g.w;
      }
      Elem* __restrict__ dk = static_cast<Elem*>(p.dk);
      Elem* __restrict__ dw = static_cast<Elem*>(p.dw);
#pragma unroll 1
      for (int s = n - 1; s >= 0; --s) {
        const float4* srow =
            reinterpret_cast<const float4*>(states + ((size_t)s * D + i) * (D + 4));
        const float4* v4 = reinterpret_cast<const float4*>(field(stage, buf, s, kV, D));
        const float4* dy4 = reinterpret_cast<const float4*>(field(stage, buf, s, kDy, D));
        const float ri = field(stage, buf, s, kR, D)[i];
        const float wi = field(stage, buf, s, kW, D)[i];
        const float vdy = svdy[buf * kC + s];
        // one pass over the row: dw = S_t . G and G . v_t in dot()'s order,
        // then G's update (decay_add's roundings), each element as it goes
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f, b0 = 0.f, b1 = 0.f, b2 = 0.f, b3 = 0.f;
#pragma unroll
        for (int q = 0; q < D / 4; ++q) {
          const float4 sq = srow[q], vq = v4[q], dq = dy4[q];
          a0 = fmaf(G[4 * q], sq.x, a0);
          a1 = fmaf(G[4 * q + 1], sq.y, a1);
          a2 = fmaf(G[4 * q + 2], sq.z, a2);
          a3 = fmaf(G[4 * q + 3], sq.w, a3);
          b0 = fmaf(G[4 * q], vq.x, b0);
          b1 = fmaf(G[4 * q + 1], vq.y, b1);
          b2 = fmaf(G[4 * q + 2], vq.z, b2);
          b3 = fmaf(G[4 * q + 3], vq.w, b3);
          G[4 * q] = __fmaf_rn(wi, G[4 * q], __fmul_rn(ri, dq.x));
          G[4 * q + 1] = __fmaf_rn(wi, G[4 * q + 1], __fmul_rn(ri, dq.y));
          G[4 * q + 2] = __fmaf_rn(wi, G[4 * q + 2], __fmul_rn(ri, dq.z));
          G[4 * q + 3] = __fmaf_rn(wi, G[4 * q + 3], __fmul_rn(ri, dq.w));
        }
        const size_t off = base + (size_t)(t0 + s) * step;
        store_f32(dw, off, (a0 + a1) + (a2 + a3));
        store_f32(dk, off, fmaf(ux * ri, vdy, (b0 + b1) + (b2 + b3)));
      }
    } else {
      const int j = x;
      Elem* __restrict__ dv = static_cast<Elem*>(p.dv);
#pragma unroll 1
      for (int s = n - 1; s >= 0; --s) {
        const float4* r4 = reinterpret_cast<const float4*>(field(stage, buf, s, kR, D));
        const float4* k4 = reinterpret_cast<const float4*>(field(stage, buf, s, kK, D));
        const float4* w4 = reinterpret_cast<const float4*>(field(stage, buf, s, kW, D));
        const float4* u4 = reinterpret_cast<const float4*>(su);
        const float dyj = field(stage, buf, s, kDy, D)[j];
        // one pass over the column: sum_i (u[i] r_t[i]) k_t[i] and k_t . G
        // in dot()'s order, then G's update, rounded as the row threads
        // round it, each element as it goes
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f, b0 = 0.f, b1 = 0.f, b2 = 0.f, b3 = 0.f;
#pragma unroll
        for (int q = 0; q < D / 4; ++q) {
          const float4 uq = u4[q], rq = r4[q], kq = k4[q], wq = w4[q];
          a0 = fmaf(uq.x * rq.x, kq.x, a0);
          a1 = fmaf(uq.y * rq.y, kq.y, a1);
          a2 = fmaf(uq.z * rq.z, kq.z, a2);
          a3 = fmaf(uq.w * rq.w, kq.w, a3);
          b0 = fmaf(G[4 * q], kq.x, b0);
          b1 = fmaf(G[4 * q + 1], kq.y, b1);
          b2 = fmaf(G[4 * q + 2], kq.z, b2);
          b3 = fmaf(G[4 * q + 3], kq.w, b3);
          G[4 * q] = __fmaf_rn(wq.x, G[4 * q], __fmul_rn(rq.x, dyj));
          G[4 * q + 1] = __fmaf_rn(wq.y, G[4 * q + 1], __fmul_rn(rq.y, dyj));
          G[4 * q + 2] = __fmaf_rn(wq.z, G[4 * q + 2], __fmul_rn(rq.z, dyj));
          G[4 * q + 3] = __fmaf_rn(wq.w, G[4 * q + 3], __fmul_rn(rq.w, dyj));
        }
        store_f32(dv, base + (size_t)(t0 + s) * step,
                  fmaf(dyj, (a0 + a1) + (a2 + a3), (b0 + b1) + (b2 + b3)));
      }
    }
  }
  if (!row) {
    float* ds0 = p.ds0 + (size_t)bh * D * D + x;
#pragma unroll
    for (int i = 0; i < D; ++i) ds0[(size_t)i * D] = G[i];
  }
}

// du[h][i] = sum over b, in order, of the per-(b, h) partials.
template <int D>
__global__ void __launch_bounds__(D) wkv_bwd_du(const float* __restrict__ du_part,
                                                float* __restrict__ du, int B, int H) {
  const int h = blockIdx.x;
  const int i = threadIdx.x;
  float sum = 0.f;
  for (int b = 0; b < B; ++b) sum += du_part[((size_t)b * H + h) * D + i];
  du[(size_t)h * D + i] = sum;
}

template <typename Elem, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int blocks = p.B * p.H;
  wkv_bwd_fwd<Elem, D><<<blocks, D, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t bytes = rev_smem_bytes<D>();
  err = cudaFuncSetAttribute(wkv_bwd_rev<Elem, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  wkv_bwd_rev<Elem, D><<<blocks, 2 * D, bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv_bwd_du<D><<<p.H, D, 0, stream>>>(p.du_part, p.du, p.B, p.H);
  return cudaGetLastError();
}

// Keep the head sizes in step with HEAD_DIMS in kernel.py.
template <typename Elem>
cudaError_t dispatch(const Params& p, int D, cudaStream_t s) {
  if (D == 8) return launch<Elem, 8>(p, s);
  if (D == 16) return launch<Elem, 16>(p, s);
  if (D == 32) return launch<Elem, 32>(p, s);
  if (D == 64) return launch<Elem, 64>(p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// The backward's entry point.  dtype: 0 float32, 1 bfloat16 (r, k, v, w, dy
// and dr, dk, dv, dw).  s0 and ds_last may be null (zeros).  ck, vdy and
// du_part are scratch of B H ceil(T / kC) D^2, B H T and B H D floats
// (rwkv6_wkv_bwd_checkpoint_steps() gives kC).  Returns cudaGetLastError()
// after the launches (0 on success), or cudaErrorInvalidValue for arguments
// the kernels do not take.
extern "C" int rwkv6_wkv_bwd(const void* r, const void* k, const void* v, const void* w,
                             const float* u, const float* s0, const void* dy,
                             const float* ds_last, void* dr, void* dk, void* dv, void* dw,
                             float* du, float* ds0, float* ck, float* vdy, float* du_part,
                             int dtype, int B, int T, int H, int D, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || (long long)B * H > 2147483647LL)
    return cudaErrorInvalidValue;
  const Params p{r,  k,  v,  w,   u,  s0, dy,  ds_last, dr, dk,
                 dv, dw, du, ds0, ck, vdy, du_part, B, T, H, (T + kC - 1) / kC};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, D, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, D, s);
  return cudaErrorInvalidValue;
}

extern "C" int rwkv6_wkv_bwd_checkpoint_steps() { return kC; }

extern "C" const char* rwkv6_wkv_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
