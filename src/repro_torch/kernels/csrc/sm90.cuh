// What the kernels on the Hopper tensor cores share (flash_attention_fwd_sm90.cu,
// flash_attention_bwd_sm90.cu, rwkv6_wkv_fwd_sm90.cu): mbarriers, TMA loads
// and tensor maps, wgmma's shared-memory descriptors and the products on
// bf16 operands with f32 accumulators, sm_90a only.  build.py passes nvcc
// -I to this directory.
//
// Tiles in shared memory.  A bf16 tile of R rows x D columns comes in by TMA
// as chunks(D) chunks, each R rows of 64 elements (128 bytes) with the
// 128-byte swizzle, chunk c at byte c R 128; every chunk starts on a
// 1024-byte boundary.  Where D is not a multiple of 64 (Dk 96, D 80) the
// last chunk's columns past D are zeros, which TMA fills in and counts among the
// bytes a barrier expects (tile_bytes).  Such a tile is a K-major operand of
// wgmma when D is the product's depth (Q and K in S = Q K^T) and an MN-major
// one, through the descriptor's transpose bit, when its rows are the depth
// (V in O += P V): then N runs over whole chunks, the 128-byte swizzle's
// 64-column atoms, and a product whose N is not a multiple of 64 (Dv 80)
// runs at the next one over the zero columns.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;      // bf16 elements in one 128-byte swizzle row
constexpr int kRowBytes = 128;
// Returned, or'ed with the CUresult, when a tensor map cannot be encoded.
constexpr int kTensorMapError = 1 << 16;

// The 64-element chunks of a row of d elements, the last zero-filled past d.
__host__ __device__ constexpr int chunks(int d) { return (d + kChunk - 1) / kChunk; }
// The bytes of a tile of `rows` rows of d elements in shared memory, and the
// bytes its TMA loads bring (the zero-filled columns included).
__host__ __device__ constexpr int tile_bytes(int rows, int d) {
  return rows * chunks(d) * kRowBytes;
}

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

// One box of a 3-D tensor map, at coordinates (row, head, batch).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(row), "r"(head), "r"(batch)
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

// Makes this thread's writes to shared memory visible to the tensor cores'
// reads (wgmma's operands from shared memory).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Joins the 256 threads of the two consumer warpgroups (named barrier 1).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

#define D8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// S (64 x 32) = A (64 x 16) B^T (+ S if accumulate), A and B K-major in
// shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        D8(0), D8(8)
      : "l"(da), "l"(db), "r"(accumulate));
}

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

// O (64 x 64) = A (64 x 16) B (+ O if accumulate), A K-major and B MN-major
// in shared memory (the last 1: B transposed).
__device__ __forceinline__ void wgmma_ss_tb(float (&d)[32], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      :
        D8(0), D8(8), D8(16), D8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// O (64 x 64) += A (64 x 16) B, A and B both MN-major in shared memory (both
// transposed): A's rows in memory are its 16 columns of depth.
__device__ __forceinline__ void wgmma_ss_ta_tb(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      :
        D8(0), D8(8), D8(16), D8(24)
      : "l"(da), "l"(db), "r"(1));
}

// O (64 x 64) += A (64 x 16) B, A in registers, B MN-major in shared memory
// (the last 1: B transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
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

// O (64 x 128) += A (64 x 16) B, A K-major and B MN-major in shared memory
// (the last 1: B transposed).
__device__ __forceinline__ void wgmma_ss_tb(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      :
        D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(da), "l"(db), "r"(1));
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

// Issues S = A B^T over D in k16 steps: A is 64 rows of a tile of AROWS
// rows (a_smem points at its first row), B is BN rows of a tile of BROWS
// rows; step kk reads 32 bytes into chunk kk / 4 of each.  D / 16 steps, a
// compile-time count: at D 96 six, the last two in chunk 1, whose zero half
// is never read; at D 80 five, the fifth in chunk 1.
template <int D, int BN, int AROWS, int BROWS = BN>
__device__ __forceinline__ void issue_qk(float (&sc)[BN / 2], uint32_t a_smem, uint32_t b_smem) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t step = (kk % 4) * 32;
    wgmma_ss(sc, smem_desc(a_smem + (kk / 4) * AROWS * kRowBytes + step, 16, 8 * kRowBytes),
             smem_desc(b_smem + (kk / 4) * BROWS * kRowBytes + step, 16, 8 * kRowBytes), kk > 0);
  }
}

// Issues O += P V over a tile of BK rows (the depth) in k16 steps; step kk
// reads rows 16 kk .. 16 kk + 15 of the V tile, 2048 bytes on.
template <int DV, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[DV / 2], const uint32_t (&p)[BK / 16][4],
                                         uint32_t v_smem) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs(o, p[kk], smem_desc(v_smem + kk * 16 * kRowBytes, BK * kRowBytes, 8 * kRowBytes));
}

// Issues O (64 x 128) += A B over BK = 64 rows of depth in k16 steps, A a
// 64 x 64 tile in shared memory (one chunk), B 128 columns (two chunks) of a
// tile of BK rows through the transpose bit.
__device__ __forceinline__ void issue_ss_pv(float (&o)[64], uint32_t a_smem, uint32_t b_smem) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_tb(o, smem_desc(a_smem + kk * 32, 16, 8 * kRowBytes),
                smem_desc(b_smem + kk * 16 * kRowBytes, 64 * kRowBytes, 8 * kRowBytes));
}

// The A fragments of an m64 x BK accumulator's values, rounded to bf16.
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

// The warp-wide product C (16 x 8) += A (16 x 16) B (16 x 8), bf16 in, f32
// out (mma.sync, the pre-Hopper tensor-core path, for products narrower than
// wgmma's 64 rows).  Lane 4 g + c holds A's a[0] (row g, columns 2c, 2c+1),
// a[1] (row g + 8), a[2] (row g, columns 8 + 2c, 8 + 2c + 1), a[3] (row g +
// 8, those columns); B's b0 (rows 2c, 2c+1 of column g), b1 (rows 8 + 2c,
// 8 + 2c + 1); C's c[0], c[1] (row g, columns 2c, 2c+1), c[2], c[3] (row
// g + 8): the layout of one 8-column block of a wgmma accumulator.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The byte offset of bf16 element (row, col) in a tile of 64-element
// (128-byte) rows with the 128-byte swizzle, as TMA writes it and wgmma
// reads it when the tile starts on a 1024-byte boundary: the 16-byte chunk
// col / 8 of a row moves to chunk (col / 8) xor (row % 8).
__device__ __forceinline__ uint32_t swizzle128(int row, int col) {
  return row * kRowBytes + ((((col >> 3) ^ row) & 7) << 4) + ((col & 7) << 1);
}

// Two floats rounded to bf16 and packed as one 32-bit word, the first in
// the low half (the lower address).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 pk = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&pk);
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
// 128-byte swizzle.  Out-of-range rows, and columns past D in a box from
// column 64 of a D of 80 or 96, are filled with zeros.
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

// A 3-D map over an f32 (B, heads, S) tensor whose rows start `ld` elements
// apart (ld a multiple of 4: 16 bytes), whose box is `rows` elements of one
// row.  Out-of-range elements (S and beyond) are filled with zeros.
CUresult encode_rows(CUtensorMap* map, const float* ptr, int B, int heads, int S, int ld,
                     int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)S, (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 4, (cuuint64_t)heads * ld * 4};
  const cuuint32_t box[3] = {(cuuint32_t)rows, 1, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(ptr), dims,
                        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace
