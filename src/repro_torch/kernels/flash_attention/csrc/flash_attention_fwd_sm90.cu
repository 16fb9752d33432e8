// Flash attention, forward, on the Hopper tensor cores (sm_90a).
//
// The bf16 route of flash_attention_fwd at head dims (Dk, Dv) = (128, 128)
// and (256, 256); every other dtype and head dim goes to attn_fwd in
// flash_attention_fwd.cu, whose C entry point dispatches here.  Like that
// kernel it replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py :: flash_attention_kernel
// (body _attn_kernel) and computes what it computes: online softmax with f32
// running max m, denominator l and accumulator; head h reads kv head
// h / (H / KH); causal, sliding-window, kv_len and q_offset masks; tiles that
// no (query, key) pair can see are skipped; a row that sees no key outputs 0.
// Layout: q (B, Sq, H, D), k and v (B, Sk, KH, D), o (B, Sq, H, D), bf16,
// contiguous.
//
// What bounds it.  At the served prefill shapes the function needs 3.4e10
// FLOP (qwen3-1.7b, q 8x1024x16x128) and 8.3e11 FLOP (recurrentgemma-2b, q
// 8x4096x16x256, one kv head, window 2048) against 0.1 GB and 0.6 GB of
// inputs and output: it is bound by operations, 989 TFLOP/s in bf16 on the
// tensor cores.  The CUDA cores' f32 FMAs reach 67, so both products run as
// wgmma, bf16 in and f32 out.
//
// Design.  A persistent grid, one block an SM, walks a static list of work
// items (128 query rows of one (b, h)), heaviest causal q tile first.  A
// block has three warpgroups.  Warpgroup 0 is the producer: cut to 24
// registers, one thread brings each item's Q and then each visible K and V
// tile by TMA into a two-stage ring guarded by mbarriers (full: the bytes
// arrived; empty: all 256 consumer threads are done with it; K and V are
// released apart, and Q after the item's last S), running ahead across item
// boundaries, so the next item's loads overlap this one's last products and
// its epilogue.  Warpgroups 1 and 2 are the consumers, raised to 240
// registers, each owning 64 query rows of the item:
//   S = Q K^T       wgmma m64 n BK k16, Q and K from shared memory;
//   masks and the online softmax on S's register fragment, exp2 with the
//                   scale folded in as log2(e) / sqrt(Dk);
//   O = alpha O + P V   wgmma m64 n Dv k16, P rounded to bf16 in registers
//                   (the A operand), V from shared memory through the
//                   descriptor's transpose bit, so V is never transposed
//                   in memory; l sums the same rounded P.
// Tile t's S is issued together with tile t-1's P V, so tile t's softmax
// runs while P V is on the tensor cores (and the two consumers, unsynced,
// overlap each other too).  TMA tiles are 64 elements (128 bytes) of D wide
// with the 128-byte swizzle, D split into 64-element chunks laid one after
// another; a 4-D tensor map over (D, heads, S, B) zero-fills the ragged edge
// of Sq and Sk inside each batch.  Tile BQ x BK = 128 x 128 at D 128 and
// 128 x 64 at D 256: Q 64 KB + 2 stages x (K 32 KB + V 32 KB) = 192 KB of
// shared memory.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 384;   // three warpgroups: producer, two consumers
constexpr int kBQ = 128;        // query rows of a work item, 64 per consumer
constexpr int kChunk = 64;      // bf16 elements in one 128-byte swizzle row
constexpr int kRowBytes = 128;
constexpr int kStages = 2;
// Returned, or'ed with the CUresult, when a tensor map cannot be encoded.
constexpr int kTensorMapError = 1 << 16;

struct Args {
  __nv_bfloat16* o;
  int B, Sq, H, KH;
  int causal;
  int window;      // <= 0: no sliding window
  int q_offset;    // absolute position of q row 0
  int kv_len;      // keys at and beyond kv_len are masked; <= Sk
  float scale_log2;  // log2(e) / sqrt(Dk)
};

// Shared memory of one block, in bytes from a 1024-byte aligned base: Q as
// D/64 chunks of 128 rows x 128 bytes; per stage K and V as D/64 chunks of BK
// rows x 128 bytes; then the mbarriers.
template <int DK, int DV, int BK>
struct Smem {
  static constexpr int kQ = kBQ * DK * 2;
  static constexpr int kK = BK * DK * 2;
  static constexpr int kV = BK * DV * 2;
  static constexpr int kKOff = kQ;
  static constexpr int kVOff = kKOff + kStages * kK;
  static constexpr int kBarOff = kVOff + kStages * kV;
  // q, empty_q, full_k[], full_v[], empty_k[], empty_v[]
  static constexpr int kBars = 2 + 4 * kStages;
  static constexpr int kBytes = kBarOff + 8 * kBars + 1024;  // + room to align the base
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Whether the phase of parity `parity` has completed (after a short wait in
// the hardware).
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Returns once the phase of parity `parity` has completed.  (A bounded wait
// that traps on timeout makes ptxas 12.9 ignore setmaxnreg and spill.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// One box of a 4-D tensor map, at coordinates (d, head, row, batch), into
// shared memory; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// wgmma's shared-memory matrix descriptor, 128-byte swizzle.  For a K-major
// operand (Q, K) the stride byte offset (SBO) steps from one group of 8 rows
// to the next (8 x 128 bytes) and the leading byte offset is unused; for an
// MN-major operand (V) SBO steps over 8 rows of k and LBO from one 64-element
// chunk of the N dimension to the next.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define D8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// S (64 x 64) = A (64 x 16) B^T (+ S if accumulate), A and B K-major in
// shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        D8(0), D8(8), D8(16), D8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// S (64 x 128) = A (64 x 16) B^T (+ S if accumulate), A and B K-major in
// shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// O (64 x 128) += A (64 x 16) B, A in registers, B MN-major in shared memory
// (the last 1: B transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 256) += A (64 x 16) B, A in registers, B MN-major in shared memory
// (the last 1: B transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56),
        D8(64), D8(72), D8(80), D8(88), D8(96), D8(104), D8(112), D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef D8

// Accumulator fragments of wgmma m64nN (f32): thread t of the warpgroup, in
// warp w = t / 32 with lane = 4 g + c, holds for each 8-column block j the
// values d[4j + 2h + e] at row 16 w + g + 8 h and column 8 j + 2 c + e
// (h, e in {0, 1}).  The A operand of m64n?k16 from registers has the same
// shape for its 16 columns, so S's block pair (2 kk, 2 kk + 1) packed as bf16
// pairs is P's A fragment for k-step kk.

// Issues S = Q K^T over D in k16 steps; step kk reads 32 bytes into chunk
// kk / 4 of Q's 64 rows (q_smem) and of the K tile (k_smem).
template <int DK, int BK>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], uint32_t q_smem, uint32_t k_smem) {
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    const uint32_t step = (kk % 4) * 32;
    wgmma_ss(sc, smem_desc(q_smem + (kk / 4) * kBQ * kRowBytes + step, 16, 8 * kRowBytes),
             smem_desc(k_smem + (kk / 4) * BK * kRowBytes + step, 16, 8 * kRowBytes), kk > 0);
  }
}

// Issues O += P V over the tile's keys in k16 steps; step kk reads keys
// 16 kk .. 16 kk + 15 of the V tile, 2048 bytes on.
template <int DV, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[DV / 2], const uint32_t (&p)[BK / 16][4],
                                         uint32_t v_smem) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs(o, p[kk], smem_desc(v_smem + kk * 16 * kRowBytes, BK * kRowBytes, 8 * kRowBytes));
}

// Masks and online softmax of one tile's scores, for this thread's two rows
// (qpos0 and qpos0 + 8) and the keys from k0: updates the running max m,
// returns in alpha the factor for O and l, and replaces each score by its
// weight exp2(S sl - m sl) rounded to bf16 (held as f32), whose sum over
// this thread's columns goes to rs.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], float (&m)[2], float (&alpha)[2],
                                             float (&rs)[2], const Args& a, int k0, int qpos0,
                                             bool all_visible) {
  const int col0 = 2 * (threadIdx.x % 4);
  if (!all_visible) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qpos = qpos0 + 8 * hh, kpos = k0 + 8 * j + col0 + e;
          bool visible = kpos < a.kv_len;
          if (a.causal) visible = visible && kpos <= qpos;
          if (a.window > 0) visible = visible && kpos > qpos - a.window;
          if (!visible) sc[4 * j + 2 * hh + e] = -INFINITY;
        }
  }
  const float sl = a.scale_log2;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {  // the row max over the 4 threads of a row
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[hh], mx);
    // a row that has seen no key yet keeps m = -inf; 0 stands in for it so
    // that exp2 gives 0 for its hidden scores, never (-inf) - (-inf)
    const float m_sl = m_new == -INFINITY ? 0.f : m_new * sl;
    alpha[hh] = exp2f(m[hh] * sl - m_sl);
    m[hh] = m_new;
    rs[hh] = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * hh + e];
        x = __bfloat162float(__float2bfloat16_rn(exp2f(fmaf(x, sl, -m_sl))));
        rs[hh] += x;
      }
  }
}

// P's A fragments from the weights softmax_tile left in sc (exact: they are
// bf16 values already).
template <int BK>
__device__ __forceinline__ void pack_p(const float (&sc)[BK / 2], uint32_t (&p)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const __nv_bfloat162 pk = __floats2bfloat162_rn(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
      p[kk][r] = *reinterpret_cast<const uint32_t*>(&pk);
    }
}

// One work item: 128 query rows of one (b, h), and the kv tiles that some
// (query, key) pair of them can see.
struct Item {
  int q0, h, b, nq, q_first, q_last, t_begin, t_end;
};

// Item w of the launch.  Items run heaviest q tile first: w / (H B) counts
// down the q tiles, w % (H B) walks the heads, then the batches.
template <int BK>
__device__ __forceinline__ Item item_at(const Args& a, int w) {
  Item it;
  const int nqt = (a.Sq + kBQ - 1) / kBQ, hb = w % (a.H * a.B);
  it.q0 = (nqt - 1 - w / (a.H * a.B)) * kBQ;
  it.h = hb % a.H;
  it.b = hb / a.H;
  it.nq = min(kBQ, a.Sq - it.q0);
  it.q_first = a.q_offset + it.q0;
  it.q_last = it.q_first + it.nq - 1;
  int kv_end = a.kv_len;
  if (a.causal) kv_end = min(kv_end, it.q_last + 1);
  const int kv_begin = a.window > 0 ? max(0, it.q_first - a.window + 1) : 0;
  it.t_begin = kv_begin / BK;
  it.t_end = kv_end > kv_begin ? (kv_end + BK - 1) / BK : it.t_begin;
  return it;
}

// A persistent grid: block i takes items i, i + gridDim.x, ...  Every tile
// of every item goes through one ring, so the producer loads the next item's
// Q and first tiles while the consumers finish the current one.
template <int DK, int DV, int BK>
__global__ void __launch_bounds__(kThreads, 1)
    attn_fwd_wgmma(const Args a, const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v) {
  using L = Smem<DK, DV, BK>;
  static_assert(DK % kChunk == 0 && DV % kChunk == 0 && BK % 16 == 0, "tile shape");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  // mbarriers: Q, or K or V of stage s, arrived (full); all 256 consumer
  // threads are done with Q, or with K or V of stage s (empty)
  const uint32_t bar_q = base + L::kBarOff, empty_q = bar_q + 8;
  auto full_k = [bar_q](int s) { return bar_q + 8 * (2 + s); };
  auto full_v = [bar_q](int s) { return bar_q + 8 * (2 + kStages + s); };
  auto empty_k = [bar_q](int s) { return bar_q + 8 * (2 + 2 * kStages + s); };
  auto empty_v = [bar_q](int s) { return bar_q + 8 * (2 + 3 * kStages + s); };
  auto k_smem = [base](int s) { return base + L::kKOff + s * L::kK; };
  auto v_smem = [base](int s) { return base + L::kVOff + s * L::kV; };
  const int n_items = (a.Sq + kBQ - 1) / kBQ * a.H * a.B;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(empty_q, 2 * 128);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 2 * 128);
      mbar_init(empty_v(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // g counts the kv tiles this block has put through the ring, j its items;
  // both roles count alike, so they agree on each stage and phase.
  if (threadIdx.x < 128) {
    // Producer.  One thread issues every copy; the other warps are done.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int g = 0, j = 0;
      for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++j) {
        const Item it = item_at<BK>(a, w);
        const int kvh = it.h / (a.H / a.KH);
        mbar_wait(empty_q, (j & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(bar_q, L::kQ);
#pragma unroll
        for (int c = 0; c < DK / kChunk; ++c)
          tma_load(base + c * kBQ * kRowBytes, &tm_q, bar_q, c * kChunk, it.h, it.q0, it.b);
        for (int t = it.t_begin; t < it.t_end; ++t, ++g) {
          const int s = g % kStages;
          const uint32_t parity = ((g / kStages) & 1) ^ 1;
          mbar_wait(empty_k(s), parity);
          mbar_expect_tx(full_k(s), L::kK);
#pragma unroll
          for (int c = 0; c < DK / kChunk; ++c)
            tma_load(k_smem(s) + c * BK * kRowBytes, &tm_k, full_k(s), c * kChunk, kvh, t * BK,
                     it.b);
          mbar_wait(empty_v(s), parity);
          mbar_expect_tx(full_v(s), L::kV);
#pragma unroll
          for (int c = 0; c < DV / kChunk; ++c)
            tma_load(v_smem(s) + c * BK * kRowBytes, &tm_v, full_v(s), c * kChunk, kvh, t * BK,
                     it.b);
        }
      }
    }
  } else {
    // Consumers.  Tile t's S = Q K^T is issued together with tile t-1's
    // O += P V, so the softmax of tile t runs while P V is on the tensor
    // cores; P is packed and O rescaled by tile t's alpha once P V has
    // landed.  K of a stage is released as soon as its product is done, V
    // after P V, and Q after the item's last S.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;  // rows 64 cw .. 64 cw + 63 of the tile
    const int lane = threadIdx.x % 32;
    const int row0 = 64 * cw + 16 * (threadIdx.x % 128 / 32) + lane / 4;  // and row0 + 8
    const uint32_t q_smem = base + 64 * cw * kRowBytes;
    float o[DV / 2], m[2], l[2], sc[BK / 2], alpha[2], rs[2];
    uint32_t p[BK / 16][4];  // P of the tile whose P V is next

    int g = 0, j = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++j) {
      const Item it = item_at<BK>(a, w);
      const int qpos0 = it.q_first + row0;
      auto all_visible = [&](int k0) {  // no pair of the tile is hidden
        return k0 + BK <= a.kv_len && (!a.causal || k0 + BK - 1 <= it.q_first) &&
               (a.window <= 0 || k0 > it.q_last - a.window);
      };
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
      m[0] = m[1] = -INFINITY;  // running max of the raw scores
      l[0] = l[1] = 0.f;        // this thread's part of the row sums

      mbar_wait(bar_q, j & 1);
      if (it.t_begin < it.t_end) {
        const int s = g % kStages;
        mbar_wait(full_k(s), (g / kStages) & 1);
        wgmma_fence();
        issue_qk<DK, BK>(sc, q_smem, k_smem(s));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        mbar_arrive(empty_k(s));
        softmax_tile<BK>(sc, m, alpha, l, a, it.t_begin * BK, qpos0,
                         all_visible(it.t_begin * BK));
        pack_p<BK>(sc, p);
      }
      for (int t = it.t_begin + 1; t < it.t_end; ++t) {
        const int gi = g + t - it.t_begin, s = gi % kStages, sp = (gi - 1) % kStages;
        mbar_wait(full_k(s), (gi / kStages) & 1);
        wgmma_fence();
        issue_qk<DK, BK>(sc, q_smem, k_smem(s));
        wgmma_commit();
        mbar_wait(full_v(sp), ((gi - 1) / kStages) & 1);
        fence_regs(o);
        issue_pv<DV, BK>(o, p, v_smem(sp));
        wgmma_commit();
        wgmma_wait<1>();  // S has landed; P V may still run
        fence_regs(sc);
        mbar_arrive(empty_k(s));
        softmax_tile<BK>(sc, m, alpha, rs, a, t * BK, qpos0, all_visible(t * BK));
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(empty_v(sp));
        pack_p<BK>(sc, p);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) l[hh] = alpha[hh] * l[hh] + rs[hh];
#pragma unroll
        for (int jj = 0; jj < DV / 8; ++jj) {
          o[4 * jj] *= alpha[0];
          o[4 * jj + 1] *= alpha[0];
          o[4 * jj + 2] *= alpha[1];
          o[4 * jj + 3] *= alpha[1];
        }
      }
      mbar_arrive(empty_q);  // every S of this item is done
      if (it.t_begin < it.t_end) {
        const int gi = g + it.t_end - 1 - it.t_begin, s = gi % kStages;
        mbar_wait(full_v(s), (gi / kStages) & 1);
        wgmma_fence();
        fence_regs(o);
        issue_pv<DV, BK>(o, p, v_smem(s));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(empty_v(s));
      }
      g += it.t_end - it.t_begin;

      // O / l, or 0 where the row saw no key.
      const int col0 = 2 * (lane % 4);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float sum = l[hh];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const int r = row0 + 8 * hh;
        if (r >= it.nq) continue;
        const float inv = sum > 0.f ? 1.f / sum : 0.f;
        __nv_bfloat16* out =
            a.o + ((size_t)it.b * a.Sq + it.q0 + r) * a.H * DV + (size_t)it.h * DV + col0;
#pragma unroll
        for (int jj = 0; jj < DV / 8; ++jj)
          *reinterpret_cast<__nv_bfloat162*>(out + 8 * jj) =
              __floats2bfloat162_rn(o[4 * jj + 2 * hh] * inv, o[4 * jj + 2 * hh + 1] * inv);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled (its CUDA 12.0 signature), through the
// runtime, so that the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 4-D map over a contiguous bf16 (B, S, heads, D) tensor, innermost first,
// whose box is 64 elements of D x 1 head x `rows` rows x 1 batch, with the
// 128-byte swizzle.  Out-of-range rows are filled with zeros.
CUresult encode(CUtensorMap* map, const void* ptr, int B, int S, int heads, int D, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kChunk, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DK, int DV, int BK>
int launch(const void* q, const void* k, const void* v, const Args& a, int Sk,
           cudaStream_t stream) {
  using L = Smem<DK, DV, BK>;
  if (encode_tiled() == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  CUresult r = encode(&tq, q, a.B, a.Sq, a.H, DK, kBQ);
  if (r == CUDA_SUCCESS) r = encode(&tk, k, a.B, Sk, a.KH, DK, BK);
  if (r == CUDA_SUCCESS) r = encode(&tv, v, a.B, Sk, a.KH, DV, BK);
  if (r != CUDA_SUCCESS) return kTensorMapError | static_cast<int>(r);
  auto kernel = attn_fwd_wgmma<DK, DV, BK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long items = (long long)((a.Sq + kBQ - 1) / kBQ) * a.H * a.B;
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(items < sms ? items : sms);  // one block an SM
  kernel<<<grid, kThreads, L::kBytes, stream>>>(a, tq, tk, tv);
  return cudaGetLastError();
}

}  // namespace

// The bf16 tensor-core route, called by flash_attention_fwd's C entry point
// for the (Dk, Dv) pairs below; keep them in step with WGMMA_HEAD_DIMS in
// kernel.py.  Returns cudaGetLastError() after the launch, cudaErrorInvalidValue
// for head dims it does not take, or kTensorMapError | CUresult when a tensor
// map cannot be encoded (an address not 16-byte aligned, say): see
// flash_attention_fwd_sm90_error_string.
int flash_attention_fwd_sm90(const void* q, const void* k, const void* v, void* o, int B,
                             int Sq, int Sk, int H, int KH, int Dk, int Dv, int causal,
                             int window, int q_offset, int kv_len, float scale,
                             cudaStream_t s) {
  const Args a{static_cast<__nv_bfloat16*>(o), B, Sq, H, KH, causal, window, q_offset, kv_len,
               scale * 1.4426950408889634f};
  if (Dk == 128 && Dv == 128) return launch<128, 128, 128>(q, k, v, a, Sk, s);
  if (Dk == 256 && Dv == 256) return launch<256, 256, 64>(q, k, v, a, Sk, s);
  return cudaErrorInvalidValue;
}

// The message for a code of flash_attention_fwd_sm90's own, else nullptr.
const char* flash_attention_fwd_sm90_error_string(int err) {
  if (err & kTensorMapError)
    return "cuTensorMapEncodeTiled refused a tensor map (its CUresult is the code's low 16 bits)";
  return nullptr;
}
