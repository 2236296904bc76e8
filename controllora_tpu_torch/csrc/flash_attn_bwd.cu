// Non-causal dense flash attention, backward, for NVIDIA Hopper (sm_90a).
//
// Replaces four Pallas TPU kernels of the JAX package, the backward halves of its two
// flash attentions:
//   K3  controllora_tpu/ops/pallas_attention_vjp.py::_bwd_dkv_kernel (via _bwd): dK and
//       dV, one program per KV tile looping over query tiles. Entry point
//       k3_flash_bwd_dkv.
//   K4  pallas_attention_vjp.py::_bwd_dq_kernel: dQ, one program per query tile looping
//       over KV tiles. Entry point k4_flash_bwd_dq.
//   K5  the backward of jax's stock TPU flash attention, which
//       controllora_tpu/ops/attention.py::_flash_stock reaches
//       (jax/experimental/pallas/ops/tpu/flash_attention.py):
//       _flash_attention_dkv_kernel -> k5_stock_flash_bwd_dkv, and
//       _flash_attention_dq_kernel  -> k5_stock_flash_bwd_dq.
// Two kernels serve all four: flash_bwd_dkv_kernel (dK, dV) and flash_bwd_dq_kernel
// (dQ). With P = exp(S * scale - LSE) recomputed from Q and K:
//   dV = P^T dO,   dP = dO V^T,   dS = P * (dP - Dcap),
//   dK = dS^T Q * scale,   dQ = dS K * scale.
// K3/K4 take O's LSE from the forward kernel K2 (flash_attn_fwd.cu). K5 takes the
// stock residuals m (the row max of S * scale) and l (the normaliser at m), and the
// kernels form LSE = m + log(l) as they read a row, since exp(S * scale - m) / l =
// exp(S * scale - LSE). Dcap = rowsum(dO * O) (K5's di) comes from the caller, as the
// JAX backwards compute it outside their kernels. Every row term is (B*H, Lq) fp32.
// The softmax scale is a runtime argument of either sign: P = 2^(S * scale * log2(e) -
// LSE * log2(e)) needs no running max, so unlike the forward nothing is negated.
//
// Layout: (B, H, L, D) tensors read by their element strides (D contiguous) through
// 4-D TMA tensor maps (hopper.cuh::encode_heads). K3/K4 pass the (B, L, H*D)
// projections as one such view, K5 the head-split views its caller hands it, so no
// head split, merge, pad or slice copy is made. dO shares q's strides and dQ is written
// by them; dK and dV are written by k's.
//
// What bounds them on the H100: at the training shapes (L = 4096, D = 40) both are
// compute bound (dK/dV runs four L x L x D products per head, dQ three, against ~8 L D
// bytes), so the work is in the tensor-core products and in the exponentials of P (one
// per score, against 3-4 x 48 multiply-adds). Both are built like the forward
// (flash_attn_fwd.cu; hopper.cuh):
//   * one stationary tile a block, 64 rows for each of two consumer warpgroups: dK/dV
//     keeps 128 keys (their K and V rows), dQ 128 queries (their Q and dO rows), each
//     loaded once by TMA, 128-byte swizzled;
//   * a ring of the other side's 64-row tiles: a producer warpgroup keeps them in flight
//     through 3 stages with a full and an empty mbarrier each, and gives its registers
//     to the consumers (setmaxnreg 40 / 232: its one working warp keeps a loop of loads);
//   * wgmma for every product: S (S^T for dK/dV) and dP (dP^T) with both operands from
//     shared memory (K-major), issued back to back; then the accumulating products with
//     P and dS rounded to bf16 from the accumulators straight into the A operand, and
//     the B operand (dO, Q or K: a row per token) read through the transpose bit of
//     bf16 wgmma, as the forward reads V. S, P and dS never touch shared memory;
//   * head dims up to 160 (the UNets' 40, 64, 80 and SD1.5's level-2 160; 40 runs its
//     products at depth 48 and is padded to 64 in shared memory by TMA zero fill, 88-152
//     run at depth 160 the same way);
//   * no atomics: each block writes its own rows of dK and dV, or of dQ, once
//     (deterministic);
//   * ragged L: TMA zero-fills rows past L. P (and so dS) is set to 0 by index for the
//     ring's rows at or past their length: queries past Lq for dK/dV, whose LSE is not
//     defined (exp(0 - garbage) could be inf, and inf * 0 is NaN), keys past Lk for dQ,
//     where S = 0 is not P = 0. The stationary rows past L are computed on zeros and
//     never stored.
//
// dK/dV (flash_bwd_dkv_kernel): P^T's columns are queries, so each thread needs the LSE
// and Dcap of its 16 columns. They ride in the ring stage beside Q and dO: the producer
// warp's lanes copy them with plain loads (a head's row of them starts at any element,
// and a TMA box needs 16 bytes; 1-D boxes stopped the kernel at ragged Lq) and arrive on
// the stage's full barrier. Four accumulators are live: S^T, dP^T and, across all query
// tiles, dK and dV (up to 144 registers a thread at D 80).
//
// dK/dV at D 160 (DS 160, the wide instance): two 64 x 160 fp32 accumulators are 160
// registers a thread, which with S^T, dP^T and the A fragments do not fit in the 232
// that setmaxnreg gives a consumer. So a block keeps 64 keys, and its two consumer
// warpgroups share the work by output: one accumulates dV (S^T, P^T, dV += P^T dO), the
// other dK (S^T and dP^T, dS^T, dK += dS^T Q), each in 80 registers, with dV and dK at
// wgmma N 160 (B read through the transpose bit over three 64-column chunks, the last
// one half zero filled). S^T is formed by both: five products a tile where the narrow
// instances do four, and the dV warpgroup idles for about a third of each tile. K and V
// (64 rows) and three 49 KB stages of Q, dO and their rows take 196 KB. One consumer
// template (dkv_consumer) serves both designs: it keeps dV, dK or both.
//
// dQ (flash_bwd_dq_kernel): rows are queries, so each thread keeps the LSE and Dcap of
// its two rows in registers for the whole block, and the ring carries K and V only. The
// K tile that fed S is also the B operand of dQ += dS K. At DS 160 the same design
// holds dQ in 80 registers a thread (N 160); Q and dO (128 rows of 160) take 96 KB, so
// the ring has 2 stages (193 KB in all).

#include <climits>
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int kConsumerWarps = 8;                      // two consumer warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 128;    // and a producer warpgroup
constexpr int kRowBytes = 128;                         // one 64-column swizzle span of bf16
constexpr float kLog2e = 1.4426950408889634f;

// What both kernels read besides their four tensor maps.
struct BwdParams {
  const float* lse;   // (B*H, Lq): LSE, or K5's m when l is set
  const float* l;     // K5's normaliser (B*H, Lq), or null
  const float* dcap;  // (B*H, Lq)
  bf16* out0;         // dK, or dQ
  bf16* out1;         // dV, or null
  long long sb, sh, sl;  // element strides of the outputs: k's for dK/dV, q's for dQ
  int B, H, Lq, Lk, D;
  float scale;       // softmax scale: dK = dS^T Q * scale, dQ = dS K * scale
  float scale_log2;  // scale * log2(e): P = 2^(S * scale_log2 - LSE * log2(e))
};

// The LSE of row i: lse[i], or K5's m + log(l) where l is set (l >= 1: the row max's
// own term).
__device__ __forceinline__ float row_lse(const float* lse, const float* l, size_t i) {
  return l == nullptr ? lse[i] : lse[i] + __logf(l[i]);
}

// ---------------------------------------------------------------- dK, dV

// DS: head dim rounded up to 16 (the depth of S^T and the width of dK, dV). Up to DS 80
// each consumer warpgroup owns 64 keys and both their dK and dV (128 keys a block); the
// wide instance (DS 160) keeps 64 keys a block, one warpgroup accumulating their dV and
// the other their dK (dkv_consumer).
template <int DS, int STAGES>
struct DkvCfg {
  static constexpr bool kWide = DS > 80;
  static constexpr int kDS = DS, kStages = STAGES;
  static constexpr int kCh = (DS + 63) / 64;        // 64-column chunks
  static constexpr int kKeys = kWide ? 64 : 128;    // keys a block
  static constexpr int kQRows = 64;                 // queries a stage
  static constexpr int kKChunk = kKeys * kRowBytes;
  static constexpr int kKBytes = kCh * kKChunk;     // one of K, V
  static constexpr int kQChunk = kQRows * kRowBytes;
  static constexpr int kQBytes = kCh * kQChunk;     // one of Q, dO at one stage
  static constexpr int kStage = 2 * kQBytes + 1024; // Q, dO, LSE and Dcap (256 bytes each)
  static constexpr int kAcc = DS / 2;               // dK or dV accumulator registers
  static constexpr int kQTileRows = kQRows, kKTileRows = kKeys;  // TMA box rows
  static constexpr size_t kSmem =
      1024 + 2 * (size_t)kKBytes + (size_t)STAGES * kStage + 8 * (2 * STAGES + 1);
  static_assert(DS % 16 == 0 && (DS <= 80 || DS == 160),
                "the backward covers head dims up to 160");
  static_assert(kSmem <= 232448, "a block has 227 KB of shared memory");
};

// One consumer warpgroup of the dK/dV kernel over the 64 keys at k_tile / v_tile (rows
// key_row + g and + 8 of this warp's 16): for each query tile, S^T = K Q^T, P^T and
// (with DK) dP^T = V dO^T and dS^T; then dV += P^T dO (DV) and dK += dS^T Q (DK, scaled
// at the end), each in DS / 2 registers a thread. The narrow instances keep both (DV
// and DK); the wide one gives dV to one warpgroup and dK to the other, both forming S^T
// for the same keys: five products a tile where the narrow instances do four, the price
// of keeping one 64 x DS accumulator a thread instead of two.
template <class C, bool DV, bool DK>
__device__ __forceinline__ void dkv_consumer(const unsigned char* k_tile,
                                             const unsigned char* v_tile,
                                             const unsigned char* ring, uint64_t* full,
                                             uint64_t* empty, uint64_t* kv_full,
                                             const BwdParams& p, int n_q, int key_row,
                                             long long head, int lane) {
  constexpr int DS = C::kDS, STAGES = C::kStages;
  const int g = lane >> 2, t4 = lane & 3;
  float dk[DK ? C::kAcc : 1], dv[DV ? C::kAcc : 1];
#pragma unroll
  for (int i = 0; i < C::kAcc; ++i) {
    if constexpr (DK) dk[i] = 0.f;
    if constexpr (DV) dv[i] = 0.f;
  }

  mbar_wait(kv_full, 0);
  for (int j = 0; j < n_q; ++j) {
    const int s = j % STAGES;
    mbar_wait(&full[s], (j / STAGES) & 1);
    const unsigned char* q_tile = ring + (size_t)s * C::kStage;
    const unsigned char* do_tile = q_tile + C::kQBytes;
    const float* lse = reinterpret_cast<const float*>(q_tile + 2 * C::kQBytes);
    const float* dcap = lse + C::kQRows;

    // S^T = K Q^T (and for dK, dP^T = V dO^T): 64 keys x 64 queries each, unscaled
    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DS / 16; ++kk)
      ss_step<64>(st, k_tile, q_tile, kk, C::kKChunk, C::kQChunk);
    wgmma_commit();
    if constexpr (DK) {
#pragma unroll
      for (int kk = 0; kk < DS / 16; ++kk)
        ss_step<64>(dpt, v_tile, do_tile, kk, C::kKChunk, C::kQChunk);
      wgmma_commit();
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs<32>(st);

    // P^T = exp(S^T * scale - LSE) by query column (n-tile n holds columns 8n + 2 t4,
    // +1); 0 for queries at or past Lq
    const int q0 = j * C::kQRows;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = n * 8 + t4 * 2;
      const float2 ls = *reinterpret_cast<const float2*>(lse + col);
      const float l0 = ls.x * kLog2e, l1 = ls.y * kLog2e;
      const bool ok0 = q0 + col < p.Lq, ok1 = q0 + col + 1 < p.Lq;
      st[4 * n] = ok0 ? ex2(fmaf(st[4 * n], p.scale_log2, -l0)) : 0.f;
      st[4 * n + 1] = ok1 ? ex2(fmaf(st[4 * n + 1], p.scale_log2, -l1)) : 0.f;
      st[4 * n + 2] = ok0 ? ex2(fmaf(st[4 * n + 2], p.scale_log2, -l0)) : 0.f;
      st[4 * n + 3] = ok1 ? ex2(fmaf(st[4 * n + 3], p.scale_log2, -l1)) : 0.f;
    }

    // the A operands: P^T for dV; dS^T = P^T * (dP^T - Dcap), by query column, for dK
    uint32_t pa[4][4], da[4][4];
    if constexpr (DV) {
#pragma unroll
      for (int t = 0; t < 4; ++t) acc_to_a(pa[t], st, t);
    }
    if constexpr (DK) {
      wgmma_wait<0>();
      fence_regs<32>(dpt);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 dc = *reinterpret_cast<const float2*>(dcap + n * 8 + t4 * 2);
        dpt[4 * n] = st[4 * n] * (dpt[4 * n] - dc.x);
        dpt[4 * n + 1] = st[4 * n + 1] * (dpt[4 * n + 1] - dc.y);
        dpt[4 * n + 2] = st[4 * n + 2] * (dpt[4 * n + 2] - dc.x);
        dpt[4 * n + 3] = st[4 * n + 3] * (dpt[4 * n + 3] - dc.y);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) acc_to_a(da[t], dpt, t);
    }

    // dV += P^T dO and dK += dS^T Q over the tile's 64 queries (4 k-steps of 16 queries,
    // 2 x 1024 bytes further along K each), B read through the transpose bit
    wgmma_fence();
    if constexpr (DV) {
#pragma unroll
      for (int t = 0; t < 4; ++t)
        rs_step<DS>(dv, pa[t], desc_sw128(do_tile + t * 2048, C::kQChunk, 1024));
    }
    if constexpr (DK) {
#pragma unroll
      for (int t = 0; t < 4; ++t)
        rs_step<DS>(dk, da[t], desc_sw128(q_tile + t * 2048, C::kQChunk, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    if constexpr (DV) {
      fence_regs<C::kAcc>(dv);
      fence_regs<16>(&pa[0][0]);
    }
    if constexpr (DK) {
      fence_regs<C::kAcc>(dk);
      fence_regs<16>(&da[0][0]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // ------------------------------------------------------------------ epilogue
  if constexpr (DK)
    store_acc_bf16<DS>(p.out0 + head, p.sl, dk, p.scale, p.scale, key_row + g, p.Lk, 0, p.D,
                       t4);
  if constexpr (DV)
    store_acc_bf16<DS>(p.out1 + head, p.sl, dv, 1.f, 1.f, key_row + g, p.Lk, 0, p.D, t4);
}

template <int DS, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const BwdParams p) {
  using C = DkvCfg<DS, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* k_smem = base;
  unsigned char* v_smem = base + C::kKBytes;
  unsigned char* ring = v_smem + C::kKBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + (size_t)STAGES * C::kStage);
  uint64_t* empty = full + STAGES;
  uint64_t* kv_full = empty + STAGES;

  // block -> (batch*head, key tile)
  const int k_tiles = (p.Lk + C::kKeys - 1) / C::kKeys;
  const int kt = blockIdx.x % k_tiles, bh = blockIdx.x / k_tiles;
  const int b = bh / p.H, h = bh % p.H;
  const int key0 = kt * C::kKeys;
  const int n_q = (p.Lq + C::kQRows - 1) / C::kQRows;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA arrival and the producer warp's 32 lanes
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(kv_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ---------------------------------------------------------------- producer
    // One warp: lane 0 issues the TMA copies of K, V, Q and dO; the 32 lanes copy
    // the stage's LSE and Dcap values and arrive once each.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == kConsumerWarps) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * C::kKBytes);
        for (int c = 0; c < C::kCh; ++c) {
          tma_load_4d(k_smem + c * C::kKChunk, &tk, kv_full, c * 64, h, key0, b);
          tma_load_4d(v_smem + c * C::kKChunk, &tv, kv_full, c * 64, h, key0, b);
        }
      }
      const size_t row0 = (size_t)bh * p.Lq;
      for (int j = 0; j < n_q; ++j) {
        const int s = j % STAGES;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        unsigned char* stage = ring + (size_t)s * C::kStage;
        const int q0 = j * C::kQRows;
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * C::kQBytes);
          for (int c = 0; c < C::kCh; ++c) {
            tma_load_4d(stage + c * C::kQChunk, &tq, &full[s], c * 64, h, q0, b);
            tma_load_4d(stage + C::kQBytes + c * C::kQChunk, &tdo, &full[s], c * 64, h, q0,
                        b);
          }
        }
        float* rows = reinterpret_cast<float*>(stage + 2 * C::kQBytes);
        for (int i = lane; i < C::kQRows; i += 32) {  // 0 past Lq: masked by index below
          const bool ok = q0 + i < p.Lq;
          rows[i] = ok ? row_lse(p.lse, p.l, row0 + q0 + i) : 0.f;
          rows[C::kQRows + i] = ok ? p.dcap[row0 + q0 + i] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ------------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp / 4, wl = warp % 4;
  const long long head = b * p.sb + h * p.sh;
  if constexpr (C::kWide) {  // 64 keys: warpgroup 0 accumulates their dV, 1 their dK
    if (wg == 0)
      dkv_consumer<C, true, false>(k_smem, v_smem, ring, full, empty, kv_full, p, n_q,
                                   key0 + wl * 16, head, lane);
    else
      dkv_consumer<C, false, true>(k_smem, v_smem, ring, full, empty, kv_full, p, n_q,
                                   key0 + wl * 16, head, lane);
  } else {  // 128 keys: each warpgroup its 64 keys' dK and dV
    dkv_consumer<C, true, true>(k_smem + wg * 64 * kRowBytes, v_smem + wg * 64 * kRowBytes,
                                ring, full, empty, kv_full, p, n_q, key0 + wg * 64 + wl * 16,
                                head, lane);
  }
}

// ---------------------------------------------------------------- dQ

template <int DS, int STAGES>
struct DqCfg {
  static constexpr int kCh = (DS + 63) / 64;        // 64-column chunks
  static constexpr int kQueries = 128;              // queries a block, 64 a warpgroup
  static constexpr int kKeys = 64;                  // keys a stage
  static constexpr int kChunk = 64 * kRowBytes;     // 64 rows of one 64-column chunk
  static constexpr int kTileBytes = kCh * kChunk;   // 64 rows, every chunk
  static constexpr int kQBytes = 2 * kTileBytes;    // one of Q, dO: both warpgroups' rows
  static constexpr int kStage = 2 * kTileBytes;     // K and V
  static constexpr int kAcc = DS / 2;               // dQ accumulator registers
  static constexpr int kQTileRows = 64, kKTileRows = kKeys;  // TMA box rows
  static constexpr size_t kSmem =
      1024 + 2 * (size_t)kQBytes + (size_t)STAGES * kStage + 8 * (2 * STAGES + 1);
  static_assert(DS % 16 == 0 && (DS <= 80 || DS == 160),
                "the backward covers head dims up to 160");
  static_assert(kSmem <= 232448, "a block has 227 KB of shared memory");
};

template <int DS, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, const BwdParams p) {
  using C = DqCfg<DS, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_smem = base;  // warpgroup r's 64 rows at r * kTileBytes
  unsigned char* do_smem = base + C::kQBytes;
  unsigned char* ring = do_smem + C::kQBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + (size_t)STAGES * C::kStage);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;

  // block -> (batch*head, query tile)
  const int q_tiles = (p.Lq + C::kQueries - 1) / C::kQueries;
  const int qt = blockIdx.x % q_tiles, bh = blockIdx.x / q_tiles;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = qt * C::kQueries;
  const int n_k = (p.Lk + C::kKeys - 1) / C::kKeys;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ---------------------------------------------------------------- producer
    // One thread issues every TMA copy: Q and dO once, then K and V by stage.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(q_full, 2 * C::kQBytes);
      for (int r = 0; r < 2; ++r)
        for (int c = 0; c < C::kCh; ++c) {
          const int off = r * C::kTileBytes + c * C::kChunk;
          tma_load_4d(q_smem + off, &tq, q_full, c * 64, h, q0 + r * 64, b);
          tma_load_4d(do_smem + off, &tdo, q_full, c * 64, h, q0 + r * 64, b);
        }
      for (int j = 0; j < n_k; ++j) {
        const int s = j % STAGES;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], C::kStage);
        unsigned char* stage = ring + (size_t)s * C::kStage;
        for (int c = 0; c < C::kCh; ++c) {
          tma_load_4d(stage + c * C::kChunk, &tk, &full[s], c * 64, h, j * C::kKeys, b);
          tma_load_4d(stage + C::kTileBytes + c * C::kChunk, &tv, &full[s], c * 64, h,
                      j * C::kKeys, b);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp / 4, wl = warp % 4;
  const int g = lane >> 2, t4 = lane & 3;
  const unsigned char* q_tile = q_smem + wg * C::kTileBytes;  // this warpgroup's queries
  const unsigned char* do_tile = do_smem + wg * C::kTileBytes;

  // this thread's query rows r0 and r0 + 8 (accumulator registers 4n, 4n + 1 and
  // 4n + 2, 4n + 3): their LSE * log2(e) and Dcap, 0 past Lq (never stored)
  const int r0 = q0 + wg * 64 + wl * 16 + g;
  float lse2[2], dc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    const size_t row = (size_t)bh * p.Lq + r;
    lse2[i] = r < p.Lq ? row_lse(p.lse, p.l, row) * kLog2e : 0.f;
    dc[i] = r < p.Lq ? p.dcap[row] : 0.f;
  }

  float dq[C::kAcc];
#pragma unroll
  for (int i = 0; i < C::kAcc; ++i) dq[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int j = 0; j < n_k; ++j) {
    const int s = j % STAGES;
    mbar_wait(&full[s], (j / STAGES) & 1);
    const unsigned char* k_tile = ring + (size_t)s * C::kStage;
    const unsigned char* v_tile = k_tile + C::kTileBytes;

    // S = Q K^T and dP = dO V^T: 64 queries x 64 keys each, unscaled
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DS / 16; ++kk)
      ss_step<64>(sc, q_tile, k_tile, kk, C::kChunk, C::kChunk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DS / 16; ++kk)
      ss_step<64>(dp, do_tile, v_tile, kk, C::kChunk, C::kChunk);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs<32>(sc);

    // P = exp(S * scale - LSE) by query row; 0 for keys at or past Lk
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      sc[4 * n] = ex2(fmaf(sc[4 * n], p.scale_log2, -lse2[0]));
      sc[4 * n + 1] = ex2(fmaf(sc[4 * n + 1], p.scale_log2, -lse2[0]));
      sc[4 * n + 2] = ex2(fmaf(sc[4 * n + 2], p.scale_log2, -lse2[1]));
      sc[4 * n + 3] = ex2(fmaf(sc[4 * n + 3], p.scale_log2, -lse2[1]));
    }
    const int key0 = j * C::kKeys;
    if (key0 + C::kKeys > p.Lk) {  // the ragged tail
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (key0 + (i / 4) * 8 + t4 * 2 + (i & 1) >= p.Lk) sc[i] = 0.f;
    }
    wgmma_wait<0>();
    fence_regs<32>(dp);

    // dS = P * (dP - Dcap), by query row
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      dp[4 * n] = sc[4 * n] * (dp[4 * n] - dc[0]);
      dp[4 * n + 1] = sc[4 * n + 1] * (dp[4 * n + 1] - dc[0]);
      dp[4 * n + 2] = sc[4 * n + 2] * (dp[4 * n + 2] - dc[1]);
      dp[4 * n + 3] = sc[4 * n + 3] * (dp[4 * n + 3] - dc[1]);
    }

    // dQ += dS K over the tile's 64 keys (4 k-steps of 16), K read through the
    // transpose bit
    uint32_t da[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) acc_to_a(da[t], dp, t);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t)  // 16 keys (2 x 1024 bytes) further along K
      rs_step<DS>(dq, da[t], desc_sw128(k_tile + t * 2048, C::kChunk, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<C::kAcc>(dq);
    fence_regs<16>(&da[0][0]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // ------------------------------------------------------------------ epilogue
  store_acc_bf16<DS>(p.out0 + b * p.sb + h * p.sh, p.sl, dq, p.scale, p.scale, r0, p.Lq, 0,
                     p.D, t4);
}

// ---------------------------------------------------------------- launches

struct Views {
  HeadView q, dout, k, v;  // dout shares q's length, v k's
};

// Encode the four tensor maps (q and dO in boxes of C::kQTileRows rows, k and v of
// C::kKTileRows) and launch `kernel` over `blocks` blocks.
template <class C, class Kernel>
cudaError_t launch(Kernel kernel, long long blocks, const Views& x, const BwdParams& p,
                   cudaStream_t stream) {
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  CUtensorMap tq, tdo, tk, tv;
  cudaError_t err = encode_heads(&tq, x.q, p.B, p.H, p.Lq, p.D, C::kQTileRows);
  if (err == cudaSuccess)
    err = encode_heads(&tdo, x.dout, p.B, p.H, p.Lq, p.D, C::kQTileRows);
  if (err == cudaSuccess) err = encode_heads(&tk, x.k, p.B, p.H, p.Lk, p.D, C::kKTileRows);
  if (err == cudaSuccess) err = encode_heads(&tv, x.v, p.B, p.H, p.Lk, p.D, C::kKTileRows);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)C::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kThreads, C::kSmem, stream>>>(tq, tdo, tk, tv, p);
  return cudaGetLastError();
}

// Instances: D <= 48 (the UNet's 40) runs its products at depth 48, D <= 64 and
// D <= 80 as they are, 88-160 (SD1.5's level-2 160; 96 and 128, which jax's stock
// kernel takes) at depth 160; f is called with the instance's DS.
template <class F>
cudaError_t with_ds(int D, F&& f) {
  if (D <= 48) return f(std::integral_constant<int, 48>{});
  if (D <= 64) return f(std::integral_constant<int, 64>{});
  if (D <= 80) return f(std::integral_constant<int, 80>{});
  return f(std::integral_constant<int, 160>{});
}

cudaError_t run_dkv(const Views& x, const BwdParams& p, cudaStream_t stream) {
  return with_ds(p.D, [&](auto ds) {
    using C = DkvCfg<decltype(ds)::value, 3>;
    const long long blocks = (long long)p.B * p.H * ((p.Lk + C::kKeys - 1) / C::kKeys);
    return launch<C>(flash_bwd_dkv_kernel<decltype(ds)::value, 3>, blocks, x, p, stream);
  });
}

// dQ: 3 stages of K and V up to DS 80; 2 at DS 160, where Q and dO take 96 KB.
cudaError_t run_dq(const Views& x, const BwdParams& p, cudaStream_t stream) {
  return with_ds(p.D, [&](auto ds) {
    constexpr int DS = decltype(ds)::value, S = DS > 80 ? 2 : 3;
    using C = DqCfg<DS, S>;
    const long long blocks = (long long)p.B * p.H * ((p.Lq + C::kQueries - 1) / C::kQueries);
    return launch<C>(flash_bwd_dq_kernel<DS, S>, blocks, x, p, stream);
  });
}

bool valid_shape(int B, int H, int Lq, int Lk, int D) {
  return B >= 1 && H >= 1 && Lq >= 1 && Lk >= 1 && D >= 8 && D % 8 == 0 && D <= 160;
}

// out: the view whose strides the outputs take.
BwdParams make_params(const void* lse, const void* l, const void* dcap, void* out0,
                      void* out1, HeadView out, int B, int H, int Lq, int Lk, int D,
                      float scale) {
  return {(const float*)lse, (const float*)l, (const float*)dcap, (bf16*)out0, (bf16*)out1,
          out.sb, out.sh, out.sl, B, H, Lq, Lk, D, scale, scale * kLog2e};
}

Views projections(const void* q, const void* k, const void* v, const void* dout, int H,
                  int Lq, int Lk, int D) {
  return {projection_view(q, Lq, H, D), projection_view(dout, Lq, H, D),
          projection_view(k, Lk, H, D), projection_view(v, Lk, H, D)};
}

Views strided(const void* q, const void* k, const void* v, const void* dout, long long q_sb,
              long long q_sh, long long q_sl, long long k_sb, long long k_sh, long long k_sl) {
  return {{q, q_sb, q_sh, q_sl}, {dout, q_sb, q_sh, q_sl}, {k, k_sb, k_sh, k_sl},
          {v, k_sb, k_sh, k_sl}};
}

}  // namespace

// Head dims up to 160 (the UNets' 40, 64, 80 and 160; the VAE's D = 512 attention is
// frozen and never differentiated, and wider heads are refused with
// cudaErrorInvalidValue).
// Each entry point returns the cudaError_t of its launch (0 = success).

// K3: dK, dV (B, Lk, H*D) bf16 from the (B, L, H*D) projections and K2's LSE.
extern "C" int k3_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* dcap,
                                void* dk, void* dv, int B, int H, int Lq, int Lk, int D,
                                float scale, void* stream) {
  if (!valid_shape(B, H, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  const Views x = projections(q, k, v, dout, H, Lq, Lk, D);
  const BwdParams p = make_params(lse, nullptr, dcap, dk, dv, x.k, B, H, Lq, Lk, D, scale);
  return (int)run_dkv(x, p, (cudaStream_t)stream);
}

// K4: dQ (B, Lq, H*D) bf16.
extern "C" int k4_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse, const void* dcap,
                               void* dq, int B, int H, int Lq, int Lk, int D, float scale,
                               void* stream) {
  if (!valid_shape(B, H, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  const Views x = projections(q, k, v, dout, H, Lq, Lk, D);
  const BwdParams p = make_params(lse, nullptr, dcap, dq, nullptr, x.q, B, H, Lq, Lk, D, scale);
  return (int)run_dq(x, p, (cudaStream_t)stream);
}

// K5 over (B, H, L, D) tensors given by element strides (b, h, l; D contiguous): q and
// dout share q's, k and v k's. m, l and di are (B, H, Lq) fp32. dK and dV are written
// with k's strides.
extern "C" int k5_stock_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                      const void* dout, const void* m, const void* l,
                                      const void* di, void* dk, void* dv, int B, int H,
                                      int Lq, int Lk, int D, long long q_sb,
                                      long long q_sh, long long q_sl, long long k_sb,
                                      long long k_sh, long long k_sl, float scale,
                                      void* stream) {
  if (!valid_shape(B, H, Lq, Lk, D) || m == nullptr || l == nullptr)
    return (int)cudaErrorInvalidValue;
  const Views x = strided(q, k, v, dout, q_sb, q_sh, q_sl, k_sb, k_sh, k_sl);
  const BwdParams p = make_params(m, l, di, dk, dv, x.k, B, H, Lq, Lk, D, scale);
  return (int)run_dkv(x, p, (cudaStream_t)stream);
}

// K5 dQ, written with q's strides.
extern "C" int k5_stock_flash_bwd_dq(const void* q, const void* k, const void* v,
                                     const void* dout, const void* m, const void* l,
                                     const void* di, void* dq, int B, int H, int Lq,
                                     int Lk, int D, long long q_sb, long long q_sh,
                                     long long q_sl, long long k_sb, long long k_sh,
                                     long long k_sl, float scale, void* stream) {
  if (!valid_shape(B, H, Lq, Lk, D) || m == nullptr || l == nullptr)
    return (int)cudaErrorInvalidValue;
  const Views x = strided(q, k, v, dout, q_sb, q_sh, q_sl, k_sb, k_sh, k_sl);
  const BwdParams p = make_params(m, l, di, dq, nullptr, x.q, B, H, Lq, Lk, D, scale);
  return (int)run_dq(x, p, (cudaStream_t)stream);
}
