// Flash attention, forward, on the Hopper tensor cores (sm_90a).
//
// The route of flash_attention_fwd that route() in kernel.py sends bf16 at
// head dims (Dk, Dv) = (128, 128), (256, 256), (96, 64) and (80, 80) to;
// everything else goes to attn_fwd in flash_attention_fwd.cu.  Like that kernel it
// replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py :: flash_attention_kernel
// (body _attn_kernel) and computes what it computes: online softmax with f32
// running max m, denominator l and accumulator; head h reads kv head
// h / (H / KH); causal, sliding-window, kv_len and q_offset masks; tiles that
// no (query, key) pair can see are skipped; a row that sees no key outputs 0.
// Layout: q (B, Sq, H, Dk), k (B, Sk, KH, Dk), v (B, Sk, KH, Dv), o (B, Sq,
// H, Dv), bf16, contiguous.  When the caller passes an lse buffer
// (training), each row's log-sum-exp over the keys it sees goes there, for
// the backward.
//
// What bounds it.  At the served prefill shapes the function needs 3.4e10
// FLOP (qwen3-1.7b, q 8x1024x16x128) and 8.3e11 FLOP (recurrentgemma-2b, q
// 8x4096x16x256, one kv head, window 2048) against 0.1 GB and 0.6 GB of
// inputs and output: it is bound by operations, 989 TFLOP/s in bf16 on the
// tensor cores.  minicpm3-4b's MLA prefill (q and k 8x1024x48x96, v
// 8x1024x48x64) needs 6.45e10 FLOP against 0.25 GB, about even (0.065 ms
// by operations, 0.075 by bytes); its train shape (2x4096, the same heads)
// 2.58e11 FLOP against the same 0.25 GB, bound by operations.
// hubert-xlarge's encode (q, k, v 8x1024x16x80, bidirectional) needs
// 4.29e10 FLOP against 0.08 GB (0.043 ms by operations, 0.025 by bytes).
// The CUDA
// cores' f32 FMAs reach 67, so both products run as wgmma, bf16 in and f32
// out.
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
// shared memory.  At (Dk, Dv) = (96, 64), 128 x 128: Dk comes in as two
// chunks whose second is zero past column 96 (the map's D is 96, so TMA
// fills it), and every offset and expected byte count counts whole chunks
// (tile_bytes); S takes 6 k16 steps, a count fixed by the template, which
// never read the zero half, and P V runs at n64; Q 32 KB + 2 stages x (K
// 32 KB + V 16 KB) = 128 KB.  At (80, 80), D 128's tiles: Q, K and V each
// come in as two chunks whose second is zero past column 80; S takes 5 k16
// steps, and P V runs at n128 over V's zero-filled half chunk, since under
// the 128-byte swizzle an MN-major B operand (V through the transpose bit)
// is laid in 64-column atoms along N, so n80 is no layout its descriptor
// describes.  O's accumulator is sized by whole chunks (64 registers a
// thread, as at D 128); its columns 80-127 come out 0 and are never
// stored; 3/8 of P V is wasted.  The other way, a 16-column tail of V in a
// second map with the 32-byte swizzle and an n16 product beside the n64
// one, would need a second layout, map and descriptor of V for 3/8 of one
// of two products.  Q 32 KB + 2 stages x (K 32 KB + V 32 KB) = 160 KB.

#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 384;   // three warpgroups: producer, two consumers
constexpr int kBQ = 128;        // query rows of a work item, 64 per consumer
constexpr int kStages = 2;

struct Args {
  __nv_bfloat16* o;
  float* lse;      // (B, H, Sq) rows lse_ld apart, or nullptr: nothing written
  int lse_ld;
  int B, Sq, H, KH;
  int causal;
  int window;      // <= 0: no sliding window
  int q_offset;    // absolute position of q row 0
  int kv_len;      // keys at and beyond kv_len are masked; <= Sk
  float scale_log2;  // log2(e) / sqrt(Dk)
};

// Shared memory of one block, in bytes from a 1024-byte aligned base: Q as
// chunks(DK) chunks of 128 rows x 128 bytes; per stage K and V as chunks(DK)
// and chunks(DV) chunks of BK rows x 128 bytes; then the mbarriers.
template <int DK, int DV, int BK>
struct Smem {
  static constexpr int kQ = tile_bytes(kBQ, DK);
  static constexpr int kK = tile_bytes(BK, DK);
  static constexpr int kV = tile_bytes(BK, DV);
  static constexpr int kKOff = kQ;
  static constexpr int kVOff = kKOff + kStages * kK;
  static constexpr int kBarOff = kVOff + kStages * kV;
  // q, empty_q, full_k[], full_v[], empty_k[], empty_v[]
  static constexpr int kBars = 2 + 4 * kStages;
  static constexpr int kBytes = kBarOff + 8 * kBars + 1024;  // + room to align the base
  static_assert(kBytes <= 232448, "shared memory beyond 227 KB");
};

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
  // P V's N: Dv at whole chunks (128 at Dv 80, the columns past Dv 0)
  constexpr int kNV = chunks(DV) * kChunk;
  static_assert(DK % 16 == 0 && DV % 16 == 0 && BK % 16 == 0, "tile shape");
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
        for (int c = 0; c < chunks(DK); ++c)
          tma_load(base + c * kBQ * kRowBytes, &tm_q, bar_q, c * kChunk, it.h, it.q0, it.b);
        for (int t = it.t_begin; t < it.t_end; ++t, ++g) {
          const int s = g % kStages;
          const uint32_t parity = ((g / kStages) & 1) ^ 1;
          mbar_wait(empty_k(s), parity);
          mbar_expect_tx(full_k(s), L::kK);
#pragma unroll
          for (int c = 0; c < chunks(DK); ++c)
            tma_load(k_smem(s) + c * BK * kRowBytes, &tm_k, full_k(s), c * kChunk, kvh, t * BK,
                     it.b);
          mbar_wait(empty_v(s), parity);
          mbar_expect_tx(full_v(s), L::kV);
#pragma unroll
          for (int c = 0; c < chunks(DV); ++c)
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
    float o[kNV / 2], m[2], l[2], sc[BK / 2], alpha[2], rs[2];
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
      for (int i = 0; i < kNV / 2; ++i) o[i] = 0.f;
      m[0] = m[1] = -INFINITY;  // running max of the raw scores
      l[0] = l[1] = 0.f;        // this thread's part of the row sums

      mbar_wait(bar_q, j & 1);
      if (it.t_begin < it.t_end) {
        const int s = g % kStages;
        mbar_wait(full_k(s), (g / kStages) & 1);
        wgmma_fence();
        issue_qk<DK, BK, kBQ>(sc, q_smem, k_smem(s));
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
        issue_qk<DK, BK, kBQ>(sc, q_smem, k_smem(s));
        wgmma_commit();
        mbar_wait(full_v(sp), ((gi - 1) / kStages) & 1);
        fence_regs(o);
        issue_pv<kNV, BK>(o, p, v_smem(sp));
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
        for (int jj = 0; jj < DV / 8; ++jj) {  // the columns past Dv stay 0
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
        issue_pv<kNV, BK>(o, p, v_smem(s));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(empty_v(s));
      }
      g += it.t_end - it.t_begin;

      // O / l, or 0 where the row saw no key; and, when asked, the row's
      // lse = m sqrt(Dk)^-1 + log(l), 0 where it saw no key.
      const int col0 = 2 * (lane % 4);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float sum = l[hh];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const int r = row0 + 8 * hh;
        if (r >= it.nq) continue;
        const float inv = sum > 0.f ? 1.f / sum : 0.f;
        if (a.lse != nullptr && col0 == 0)
          a.lse[((size_t)it.b * a.H + it.h) * a.lse_ld + it.q0 + r] =
              sum > 0.f ? (m[hh] * a.scale_log2 + log2f(sum)) * 0.6931471805599453f : 0.f;
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

// The tensor-core route's entry point, bf16 only; route() in kernel.py
// decides which launches come here.  lse: (B, H, Sq) f32, rows lse_ld apart,
// or nullptr.  Returns cudaGetLastError() after the launch,
// cudaErrorInvalidValue for arguments it does not take, or
// kTensorMapError | CUresult when a tensor map cannot be encoded (an address
// not 16-byte aligned, say): see flash_attention_fwd_error_string.
extern "C" int flash_attention_fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                                         float* lse, int lse_ld, int B, int Sq, int Sk, int H,
                                         int KH, int Dk, int Dv, int causal, int window,
                                         int q_offset, int kv_len, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || kv_len < 0 || kv_len > Sk ||
      (lse != nullptr && lse_ld < Sq))
    return cudaErrorInvalidValue;
  const Args a{static_cast<__nv_bfloat16*>(o), lse, lse_ld, B, Sq, H, KH, causal, window,
               q_offset, kv_len, scale * 1.4426950408889634f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dk == 128 && Dv == 128) return launch<128, 128, 128>(q, k, v, a, Sk, s);
  if (Dk == 256 && Dv == 256) return launch<256, 256, 64>(q, k, v, a, Sk, s);
  if (Dk == 96 && Dv == 64) return launch<96, 64, 128>(q, k, v, a, Sk, s);
  if (Dk == 80 && Dv == 80) return launch<80, 80, 128>(q, k, v, a, Sk, s);
  return cudaErrorInvalidValue;
}

// The message for any code the forward library's entry points return.
extern "C" const char* flash_attention_fwd_error_string(int err) {
  if (err & kTensorMapError)
    return "cuTensorMapEncodeTiled refused a tensor map (its CUresult is the code's low 16 bits)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
