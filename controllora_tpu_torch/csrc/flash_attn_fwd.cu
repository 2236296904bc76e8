// Non-causal dense flash attention, forward only, for NVIDIA Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels, each the forward of one flash attention:
//   K1  controllora_tpu/ops/pallas_attention.py::_attn_kernel (flash_attention_fwd),
//       reached through biased_attention: attention over (q + q_bias, k + k_bias,
//       v + v_bias) with the folded ControlLoRA biases. Entry point k1_biased_flash_fwd.
//   K2  controllora_tpu/ops/pallas_attention_vjp.py::_fwd_kernel (_fwd): the same
//       attention, also writing LSE = m + log(l) per query row. Entry point
//       k2_flash_fwd_lse.
//   K5  the forward of jax's stock TPU flash attention, which
//       controllora_tpu/ops/attention.py::_flash_stock reaches
//       (jax/experimental/pallas/ops/tpu/flash_attention.py::_flash_attention_kernel):
//       a runtime softmax scale, and the residuals m (the row max of S * scale) and l
//       (the normaliser at m) in place of LSE. Entry point k5_stock_flash_fwd; its
//       backward is in flash_attn_bwd.cu, with K3 and K4.
//
// All three are one kernel. It reads (B, H, L, D) tensors by their strides (D
// contiguous): a TMA tensor map views each as the 4-D tensor (D, H, L, B), so a box is
// one head's rows of one batch, and the copy engine fills columns past D and rows past
// L with zeros. K1 and K2 pass the (B, L, H*D) projection layout as one such view, and
// K5 the head-split views its caller hands it, so no head split, merge, pad or slice
// copy goes through device memory. O is written by q's strides.
//
// What bounds it on the H100: at the main path's shapes (L 4096, D 40 or 512) the work
// is 4*L*L*D flops against 8*L*D bytes per head, so it is bound by operations: the
// two products S = Q K^T and O = P V, and at D 40 also the exponentials of the softmax
// (one per score, against 88 multiply-adds). The first design ran both products on
// Ampere's warp-level tensor-core product, put S and P through shared memory with four
// block barriers per key tile, and loaded K/V through registers between those
// barriers. This design:
//   * wgmma: consumer warpgroups each own 64 query rows and issue wgmma.mma_async for
//     S = Q K^T with Q and K read from shared memory, and for O += P V with P in
//     registers and V read from shared memory in its row-per-key layout through the
//     transpose bit of bf16 wgmma;
//   * softmax in registers: the online softmax (running max, normalizer and
//     accumulator in fp32) works on the S accumulator with quad shuffles; P is rounded
//     to bf16 and repacked from the accumulator layout straight into the A operand.
//     S and P never touch shared memory;
//   * a TMA ring: one producer thread keeps K/V tiles in flight through a ring of 2-3
//     stages (a full and an empty mbarrier each) while the consumers compute; Q loads
//     once per block. The copies land 128-byte swizzled, as the wgmma descriptors read
//     them, so no thread spends registers or instructions on loads;
//   * head dims up to 80 (the UNet's 40, 64 and 80): two consumer warpgroups, 128 query
//     rows per block, 64-key tiles. D 40 is padded to 64 in shared memory (TMA zero
//     fills the 24 columns by itself), but S issues only the 3 k-steps of depth 48 that
//     hold data, and P V runs N = 48; so the multiplies are those of padding to 48 and
//     the loads need no second box or 32-byte swizzle;
//   * head dims 88-160 (SD1.5's level-2 160; 96 and 128, which jax's stock kernel
//     takes): the narrow design at DS 160, zero filled from D up to 160 as the backward
//     does. Each consumer warpgroup owns 64 query rows and a 64 x 160 fp32 O (80
//     registers); S issues the 10 k-steps of depth 16 that hold data over three 64-column
//     chunks (the third half zero filled), and O += P V runs at wgmma N 160 with V read
//     through the transpose bit from the start of chunk 0 over all three (the layout of
//     the backward's dV += P^T dO at N 160), so no operand starts mid swizzle atom. Three
//     consumer warpgroups, 192 query rows a block, 64-key tiles through 3 stages: Q 72 KB
//     + 3 x 48 KB of K and V, 217 KB, one block an SM. The producer is a warpgroup that
//     gives its registers to the consumers (setmaxnreg 24 / 160: O, S (32), P's fragments
//     (16) and the softmax state fit without a spill). At SD1.5's 1536² level 2, (1, 8,
//     2304, 160), 192-row blocks are 96 for 132 SMs, one wave; 128-row blocks (two
//     consumer warpgroups) are 144, a full wave and a tail of 12, and took 0.089 ms of
//     device time where 192 rows take 0.064 (chip_smoke.py's K2 row on an H100 SXM at
//     700 W); splitting the keys of the 144 blocks gained little, the combine's fp32
//     round trip of O eating the shorter tail. The instance takes key splits (up to 8)
//     where the query tiles alone leave SMs idle (batch 1 with few heads; the wrapper's
//     plan, kv_splits, as in the wide design); K5 never splits;
//   * wide heads (the VAE's single D 512 head; D 168-504 zero filled to 512): a 64 x 512
//     fp32 accumulator would need 256 registers a thread, so two consumer
//     warpgroups share the block's 64 query rows and each owns 256 output columns (128
//     registers). Each computes the whole S tile itself (the two agree bit for bit),
//     which costs 1.5x the products of a shared S but needs no exchange. 32-key tiles
//     keep two stages of K and V (64 KB each) beside Q (64 KB). The producer is a whole
//     warpgroup that gives its registers to the consumers (setmaxnreg 24 / 240): with
//     one producer warp, 9 warps put 3 on one SM quarter and cap every thread at 168
//     registers, and ptxas then serialised the wgmma and spilled. Where the query tiles
//     alone leave SMs idle (batch 1: 64 tiles for 132 SMs), the wrapper splits the key
//     range over `splits` blocks, each writing its normalised fp32 O and its LSE, and a
//     combine kernel merges them. The wrapper plans the split from the tile sizes that
//     flash_fwd_tiles reports, so they are set in this file only;
//   * K1's biases: a pre-pass (bias_add_kernel) writes the bf16 sums q + q_bias,
//     k + k_bias, v + v_bias once per call into scratch the wrapper allocates, rounded
//     to bf16 as the JAX caller rounds them; the main kernel then reads the sums
//     through its tensor maps. The first design added each K/V bias in every one of
//     the 64 query blocks of a head.
//   * ragged L: keys at or past Lk are masked to -inf in the S accumulator; query rows
//     past Lq read zeros and are not stored.
// The tensor maps are encoded on the host at each call (cuTensorMapEncodeTiled, found
// through cudaGetDriverEntryPointByVersion, so the library is linked without -lcuda).

#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int kChunkCols = 64;             // columns of one swizzle span
constexpr int kRowBytes = kChunkCols * 2;  // 128

struct Params {
  bf16* o;          // (B, H, Lq, D) by the strides o_sb, o_sh, o_sl; when splits == 1
  float* lse;       // (B*H, Lq) or null, written when splits == 1
  float* m;         // K5's residuals (B*H, Lq) or null (then l is null too): the row max
  float* l;         //   of S * scale and the normaliser at it; only when splits == 1
  float* o_part;    // (splits, B*H, Lq, D) fp32, normalised per split, when splits > 1
  float* lse_part;  // (splits, B*H, Lq), when splits > 1
  long long o_sb, o_sh, o_sl;
  int B, H, Lq, Lk, D, splits;
  float scale_log2;  // |softmax scale| * log2(e): the kernel works in powers of 2
  int negate;        // the scale is negative: S is negated, so that S * scale keeps its max
};

// DS: head dim rounded up to 16 (the depth of S); WIDE: the wide-head design.
template <int DS, int BN, int STAGES, bool WIDE>
struct Cfg {
  static constexpr int kDS = DS, kBN = BN, kStages = STAGES;
  static constexpr bool kWide = WIDE;
  // consumer warpgroups: three at DS 160 (192 query rows a block), else two
  static constexpr int kWG = !WIDE && DS == 160 ? 3 : 2;
  static constexpr int kConsumerWarps = 4 * kWG;
  // a producer warpgroup that hands its registers to the consumers (setmaxnreg), where
  // O is wide: the wide design and the narrow one at DS 160
  static constexpr bool kProducerGroup = WIDE || DS > 80;
  // key splits a query tile may take (the wrapper's plan, through flash_fwd_tiles)
  static constexpr int kMaxSplits = kProducerGroup ? 8 : 1;
  static constexpr int kCh = (DS + kChunkCols - 1) / kChunkCols;  // 64-column chunks
  static constexpr int kRows = WIDE ? 64 : 64 * kWG;              // query rows a block
  static constexpr int kN = WIDE ? 256 : DS;  // output columns of one warpgroup
  static constexpr int kQChunk = 64 * kRowBytes;
  static constexpr int kQBytes = (kRows / 64) * kCh * kQChunk;
  static constexpr int kKVChunk = BN * kRowBytes;
  static constexpr int kKVBytes = kCh * kKVChunk;  // one of K, V at one stage
  static constexpr int kS = BN / 2;                // S accumulator registers
  static constexpr int kO = kN / 2;                // O accumulator registers
  // up to DS 80: one producer warp (9 warps; two blocks an SM at D <= 64). DS 160 and
  // wide: a producer warpgroup, so that setmaxnreg can move its registers to the
  // consumers (24 + 2 x 240 or 3 x 160 a thread slot): with 9 warps one SM quarter holds
  // 3 and caps them at 168.
  static constexpr int kThreads = 32 * kConsumerWarps + (kProducerGroup ? 128 : 32);
  // registers a consumer thread takes (setmaxnreg) beside the producer warpgroup's 24
  static constexpr int kConsumerRegs = (65536 - 128 * 24) / (128 * kWG) / 8 * 8;
  static constexpr size_t kSmem =
      1024 + kQBytes + (size_t)STAGES * 2 * kKVBytes + 8 * (2 * STAGES + 1);
  static_assert(!WIDE || DS == 512, "the wide design covers 512 columns");
  static_assert(WIDE || DS <= 80 || DS == 160,
                "the narrow design covers head dims up to 80, and 160");
  static_assert(kSmem <= 232448, "a block has 227 KB of shared memory");
};

template <int DS, int BN, int STAGES, bool WIDE>
__global__ void __launch_bounds__(Cfg<DS, BN, STAGES, WIDE>::kThreads, (WIDE || DS > 64) ? 1 : 2)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = Cfg<DS, BN, STAGES, WIDE>;
  constexpr int kConsumerWarps = C::kConsumerWarps;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_smem = base;
  unsigned char* kv_smem = base + C::kQBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(kv_smem + (size_t)STAGES * 2 * C::kKVBytes);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;

  // block -> (batch, head, key split, query tile)
  const int q_tiles = (p.Lq + C::kRows - 1) / C::kRows;
  int idx = blockIdx.x;
  const int qt = idx % q_tiles;
  idx /= q_tiles;
  const int split = idx % p.splits;
  idx /= p.splits;
  const int h = idx % p.H, b = idx / p.H;
  const int q0 = qt * C::kRows;
  const int n_all = (p.Lk + BN - 1) / BN;
  const int per_split = (n_all + p.splits - 1) / p.splits;
  const int t_begin = split * per_split;
  const int n_tiles = max(0, min(n_all, t_begin + per_split) - t_begin);

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
    // Every chunk is loaded, also those wholly past D (zeros), so that the products
    // run over compile-time depths.
    if constexpr (C::kProducerGroup) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(q_full, (C::kRows / 64) * C::kCh * C::kQChunk);
      for (int r = 0; r < C::kRows / 64; ++r)
        for (int c = 0; c < C::kCh; ++c)
          tma_load_4d(q_smem + (r * C::kCh + c) * C::kQChunk, &tq, q_full, c * kChunkCols, h,
                      q0 + r * 64, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * C::kKVBytes);
        unsigned char* ks = kv_smem + (size_t)s * 2 * C::kKVBytes;
        unsigned char* vs = ks + C::kKVBytes;
        const int key0 = (t_begin + j) * BN;
        for (int c = 0; c < C::kCh; ++c) {
          tma_load_4d(ks + c * C::kKVChunk, &tk, &full[s], c * kChunkCols, h, key0, b);
          tma_load_4d(vs + c * C::kKVChunk, &tv, &full[s], c * kChunkCols, h, key0, b);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------------ consumers
  if constexpr (C::kProducerGroup)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));
  const int wg = warp / 4, wl = warp % 4;
  const int g = lane >> 2, t4 = lane & 3;
  // narrow: warpgroup wg owns rows q0 + 64 wg.. and all columns;
  // wide: both own rows q0.., warpgroup wg owns columns 256 wg..
  const int row_base = WIDE ? q0 : q0 + wg * 64;
  const int col_base = WIDE ? wg * C::kN : 0;
  const unsigned char* q_tile = q_smem + (WIDE ? 0 : wg * C::kCh * C::kQChunk);

  float o[C::kO];
#pragma unroll
  for (int i = 0; i < C::kO; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g and g + 8

  mbar_wait(q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    mbar_wait(&full[s], (j / STAGES) & 1);
    const unsigned char* ks = kv_smem + (size_t)s * 2 * C::kKVBytes;
    const unsigned char* vs = ks + C::kKVBytes;

    // S = Q K^T (unscaled), 64 rows x BN keys
    float sacc[C::kS];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DS / 16; ++kk)
      ss_step<BN>(sacc, q_tile, ks, kk, C::kQChunk, C::kKVChunk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<C::kS>(sacc);
    if (p.negate) {
#pragma unroll
      for (int i = 0; i < C::kS; ++i) sacc[i] = -sacc[i];
    }

    const int key0 = (t_begin + j) * BN;
    if (key0 + BN > p.Lk) {  // the ragged tail: keys at or past Lk do not exist
#pragma unroll
      for (int i = 0; i < C::kS; ++i)
        if (key0 + (i / 4) * 8 + t4 * 2 + (i & 1) >= p.Lk) sacc[i] = -INFINITY;
    }

    // online softmax in registers; a row's values sit in the 4 lanes of a quad
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < C::kS / 4; ++n) {
      mx0 = fmaxf(mx0, fmaxf(sacc[4 * n], sacc[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(sacc[4 * n + 2], sacc[4 * n + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0 * p.scale_log2), mn1 = fmaxf(m1, mx1 * p.scale_log2);
    const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < C::kS / 4; ++n) {
      sacc[4 * n] = ex2(fmaf(sacc[4 * n], p.scale_log2, -mn0));
      sacc[4 * n + 1] = ex2(fmaf(sacc[4 * n + 1], p.scale_log2, -mn0));
      sacc[4 * n + 2] = ex2(fmaf(sacc[4 * n + 2], p.scale_log2, -mn1));
      sacc[4 * n + 3] = ex2(fmaf(sacc[4 * n + 3], p.scale_log2, -mn1));
      sum0 += sacc[4 * n] + sacc[4 * n + 1];
      sum1 += sacc[4 * n + 2] + sacc[4 * n + 3];
    }
    l0 = l0 * a0 + sum0;  // this thread's part of the row sums: reduced at the end
    l1 = l1 * a1 + sum1;

    // O = alpha O + P V, P from registers (A fragment of k-step t: n-tiles 2t, 2t + 1)
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int t = 0; t < BN / 16; ++t) acc_to_a(pa[t], sacc, t);
#pragma unroll
    for (int i = 0; i < C::kO; i += 4) {
      o[i] *= a0;
      o[i + 1] *= a0;
      o[i + 2] *= a1;
      o[i + 3] *= a1;
    }
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < BN / 16; ++t) {
      // 16 keys (2 x 1024 bytes) further along K; the next 64 columns C::kKVChunk on
      const uint64_t db =
          desc_sw128(vs + (col_base / kChunkCols) * C::kKVChunk + t * 2048, C::kKVChunk, 1024);
      rs_step<C::kN>(o, pa[t], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<C::kO>(o);
    fence_regs<4 * (BN / 16)>(&pa[0][0]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // ------------------------------------------------------------------ epilogue
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int r0 = row_base + wl * 16 + g;
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  constexpr float kLn2 = 0.6931471805599453f;
  const float lse0 = l0 > 0.f ? (m0 + __log2f(l0)) * kLn2 : -INFINITY;
  const float lse1 = l1 > 0.f ? (m1 + __log2f(l1)) * kLn2 : -INFINITY;
  const size_t bh = (size_t)b * p.H + h;
  const bool write_rows = t4 == 0 && (!WIDE || wg == 0);
  if (p.splits == 1) {
    store_acc_bf16<C::kN>(p.o + b * p.o_sb + h * p.o_sh, p.o_sl, o, inv0, inv1, r0, p.Lq,
                          col_base, p.D, t4);
    if (write_rows) {
      const size_t row0 = bh * p.Lq + r0;
      if (p.lse != nullptr) {
        if (r0 < p.Lq) p.lse[row0] = lse0;
        if (r0 + 8 < p.Lq) p.lse[row0 + 8] = lse1;
      }
      if (p.m != nullptr) {  // m back from base 2; l is the same sum in either base
        if (r0 < p.Lq) {
          p.m[row0] = m0 * kLn2;
          p.l[row0] = l0;
        }
        if (r0 + 8 < p.Lq) {
          p.m[row0 + 8] = m1 * kLn2;
          p.l[row0 + 8] = l1;
        }
      }
    }
  } else {
    const size_t part = (size_t)split * p.B * p.H + bh;  // (split, b*H + h)
    float* out = p.o_part + part * p.Lq * p.D;
#pragma unroll
    for (int n = 0; n < C::kO / 4; ++n) {
      const int col = col_base + n * 8 + t4 * 2;
      if (col >= p.D) continue;
      if (r0 < p.Lq)
        *reinterpret_cast<float2*>(out + (size_t)r0 * p.D + col) =
            make_float2(o[4 * n] * inv0, o[4 * n + 1] * inv0);
      if (r0 + 8 < p.Lq)
        *reinterpret_cast<float2*>(out + (size_t)(r0 + 8) * p.D + col) =
            make_float2(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
    }
    if (write_rows) {
      if (r0 < p.Lq) p.lse_part[part * p.Lq + r0] = lse0;
      if (r0 + 8 < p.Lq) p.lse_part[part * p.Lq + r0 + 8] = lse1;
    }
  }
}

// Merge the key splits: LSE = logsumexp over splits of LSE_s, O = sum_s exp(LSE_s - LSE)
// O_s. One thread per (row, 8 columns); O in the (B, Lq, H*D) layout.
__global__ void combine_splits_kernel(const float* __restrict__ o_part,
                                      const float* __restrict__ lse_part, bf16* __restrict__ o,
                                      float* __restrict__ lse, int splits, int BH, int H, int Lq,
                                      int D) {
  const int groups = D / 8;
  const long long total = (long long)BH * Lq * groups;
  const size_t part_stride = (size_t)BH * Lq;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int grp = (int)(i % groups);
    const long long row = i / groups;  // bh * Lq + l
    float mx = -INFINITY;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, lse_part[s * part_stride + row]);
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float wsum = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float ls = lse_part[s * part_stride + row];
      if (ls == -INFINITY) continue;
      const float w = __expf(ls - mx);
      wsum += w;
      const float* src = o_part + (s * part_stride + row) * D + grp * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += w * src[e];
    }
    const int bh = (int)(row / Lq), l = (int)(row % Lq);
    const int b = bh / H, h = bh % H;
    bf16* dst = o + ((size_t)b * Lq + l) * H * D + (size_t)h * D + grp * 8;
    const float inv = 1.f / wsum;
#pragma unroll
    for (int e = 0; e < 8; e += 2)
      *reinterpret_cast<__nv_bfloat162*>(dst + e) =
          __floats2bfloat162_rn(acc[e] * inv, acc[e + 1] * inv);
    if (lse != nullptr && grp == 0) lse[row] = mx + __logf(wsum);
  }
}

// out = bf16(x + bias[batch % bias_batch]) over a (B, L, H*D) tensor, 8 values a thread.
__global__ void bias_add_kernel(const bf16* __restrict__ x, const bf16* __restrict__ bias,
                                bf16* __restrict__ out, long long per_batch, int bias_batch,
                                long long n8) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n8;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e = i * 8, b = e / per_batch;
    uint4 xv = reinterpret_cast<const uint4*>(x)[i];
    const uint4 bv =
        *reinterpret_cast<const uint4*>(bias + (b % bias_batch) * per_batch + (e - b * per_batch));
    bf16* xs = reinterpret_cast<bf16*>(&xv);
    const bf16* bs = reinterpret_cast<const bf16*>(&bv);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      xs[k] = __float2bfloat16(__bfloat162float(xs[k]) + __bfloat162float(bs[k]));
    reinterpret_cast<uint4*>(out)[i] = xv;
  }
}

cudaError_t bias_add(const bf16* x, const bf16* bias, bf16* out, int B, int L, int inner,
                     int bias_batch, cudaStream_t stream) {
  const long long per_batch = (long long)L * inner, n8 = per_batch * B / 8;
  const int blocks = (int)std::min<long long>((n8 + 255) / 256, 132LL * 16);
  bias_add_kernel<<<blocks, 256, 0, stream>>>(x, bias, out, per_batch, bias_batch, n8);
  return cudaGetLastError();
}

template <class C>
cudaError_t launch(HeadView q, HeadView k, HeadView v, const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = encode_heads(&tq, q, p.B, p.H, p.Lq, p.D, 64);
  if (err == cudaSuccess) err = encode_heads(&tk, k, p.B, p.H, p.Lk, p.D, C::kBN);
  if (err == cudaSuccess) err = encode_heads(&tv, v, p.B, p.H, p.Lk, p.D, C::kBN);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_kernel<C::kDS, C::kBN, C::kStages, C::kWide>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::kSmem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)p.B * p.H * p.splits * ((p.Lq + C::kRows - 1) / C::kRows);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, C::kThreads, C::kSmem, stream>>>(tq, tk, tv, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const long long work = (long long)p.B * p.H * p.Lq * (p.D / 8);
  const int cblocks = (int)std::min<long long>((work + 255) / 256, 132LL * 16);
  combine_splits_kernel<<<cblocks, 256, 0, stream>>>(p.o_part, p.lse_part, p.o, p.lse,
                                                     p.splits, p.B * p.H, p.H, p.Lq, p.D);
  return cudaGetLastError();
}

// Instances: D <= 48 (the UNet's 40) pads to 48, D <= 64 and D <= 80 run as they are,
// 88-160 (SD1.5's level 2) run at DS 160, anything wider up to 512 takes the wide
// design. f is called with the instance's Cfg.
template <class F>
cudaError_t with_instance(int D, F&& f) {
  if (D < 8 || D % 8 != 0 || D > 512) return cudaErrorInvalidValue;
  if (D <= 48) return f(Cfg<48, 64, 3, false>{});
  if (D <= 64) return f(Cfg<64, 64, 3, false>{});
  if (D <= 80) return f(Cfg<80, 64, 2, false>{});
  if (D <= 160) return f(Cfg<160, 64, 3, false>{});
  return f(Cfg<512, 32, 2, true>{});
}

cudaError_t dispatch(HeadView q, HeadView k, HeadView v, Params p, cudaStream_t stream) {
  if (p.B < 1 || p.H < 1 || p.Lq < 1 || p.Lk < 1 || p.splits < 1 ||
      (p.splits > 1 && (p.o_part == nullptr || p.lse_part == nullptr || p.m != nullptr)) ||
      (p.m == nullptr) != (p.l == nullptr))
    return cudaErrorInvalidValue;
  return with_instance(p.D, [&](auto cfg) {
    using C = decltype(cfg);
    if (p.splits > C::kMaxSplits) return cudaErrorInvalidValue;
    return launch<C>(q, k, v, p, stream);
  });
}

// O in the (B, L, H*D) projection layout (K1, K2); K5 sets its own strides.
Params make_params(void* o, void* lse, void* o_part, void* lse_part, int B, int H, int Lq,
                   int Lk, int D, float scale, int splits) {
  Params p;
  p.o = (bf16*)o;
  p.lse = (float*)lse;
  p.m = p.l = nullptr;
  p.o_part = (float*)o_part;
  p.lse_part = (float*)lse_part;
  const HeadView ov = projection_view(o, Lq, H, D);
  p.o_sb = ov.sb;
  p.o_sh = ov.sh;
  p.o_sl = ov.sl;
  p.B = B;
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.D = D;
  p.splits = splits;
  p.scale_log2 = fabsf(scale) * 1.4426950408889634f;
  p.negate = scale < 0.f;
  return p;
}

}  // namespace

// The tiles of the instance that takes head dim D: query rows a block, keys a tile, and
// the most key splits a query tile may take (1: the instance does not split). The
// wrapper plans its splits from these (ops/flash_attention.py::kv_splits).
extern "C" int flash_fwd_tiles(int D, int* rows, int* keys, int* max_splits) {
  return (int)with_instance(D, [&](auto cfg) {
    using C = decltype(cfg);
    *rows = C::kRows;
    *keys = C::kBN;
    *max_splits = C::kMaxSplits;
    return cudaSuccess;
  });
}

// K1: O =softmax((q + q_bias)(k + k_bias)^T * scale)(v + v_bias). Any bias pointer
// may be null; a bias has bias_batch rows of batch and B % bias_batch == 0. The sums
// go to q_sum, k_sum, v_sum (scratch of q's shape, needed where the bias is given).
// o_part / lse_part: scratch for `splits` key splits (heads over 80 only), else null.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int k1_biased_flash_fwd(const void* q, const void* k, const void* v,
                                   const void* q_bias, const void* k_bias,
                                   const void* v_bias, int q_bias_batch,
                                   int k_bias_batch, int v_bias_batch, void* q_sum,
                                   void* k_sum, void* v_sum, void* o, void* o_part,
                                   void* lse_part, int B, int H, int Lq, int Lk, int D,
                                   float scale, int splits, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const void* in[3] = {q, k, v};
  const void* bias[3] = {q_bias, k_bias, v_bias};
  void* sum[3] = {q_sum, k_sum, v_sum};
  const int bias_batch[3] = {q_bias_batch, k_bias_batch, v_bias_batch};
  const int len[3] = {Lq, Lk, Lk};
  for (int i = 0; i < 3; ++i) {
    if (bias[i] == nullptr) continue;
    if (sum[i] == nullptr || bias_batch[i] < 1 || B % bias_batch[i]) return cudaErrorInvalidValue;
    const cudaError_t err = bias_add((const bf16*)in[i], (const bf16*)bias[i], (bf16*)sum[i], B,
                                     len[i], H * D, bias_batch[i], st);
    if (err != cudaSuccess) return (int)err;
    in[i] = sum[i];
  }
  return (int)dispatch(projection_view(in[0], Lq, H, D), projection_view(in[1], Lk, H, D),
                       projection_view(in[2], Lk, H, D),
                       make_params(o, nullptr, o_part, lse_part, B, H, Lq, Lk, D, scale, splits),
                       st);
}

// K2: O = softmax(q k^T * scale) v and lse[b*H + h, l] = logsumexp of row l (fp32).
extern "C" int k2_flash_fwd_lse(const void* q, const void* k, const void* v, void* o,
                                void* lse, void* o_part, void* lse_part, int B, int H, int Lq,
                                int Lk, int D, float scale, int splits, void* stream) {
  return (int)dispatch(projection_view(q, Lq, H, D), projection_view(k, Lk, H, D),
                       projection_view(v, Lk, H, D),
                       make_params(o, lse, o_part, lse_part, B, H, Lq, Lk, D, scale, splits),
                       (cudaStream_t)stream);
}

// K5 forward over (B, H, L, D) tensors given by element strides (b, h, l; D
// contiguous): q and o share q's, k and v share k's. O = softmax(q k^T * scale) v, and
// m, l (B, H, Lq) fp32: m the row max of the scaled logits, l = sum exp(S * scale - m).
// One pass over the keys (no split, so no merge of (m, l) is needed: the stock
// training batch gives enough query tiles). Returns the cudaError_t of the launch.
extern "C" int k5_stock_flash_fwd(const void* q, const void* k, const void* v, void* o,
                                  void* m, void* l, int B, int H, int Lq, int Lk, int D,
                                  long long q_sb, long long q_sh, long long q_sl,
                                  long long k_sb, long long k_sh, long long k_sl,
                                  float scale, void* stream) {
  if (m == nullptr || l == nullptr) return (int)cudaErrorInvalidValue;
  Params p = make_params(o, nullptr, nullptr, nullptr, B, H, Lq, Lk, D, scale, 1);
  p.m = (float*)m;
  p.l = (float*)l;
  p.o_sb = q_sb;
  p.o_sh = q_sh;
  p.o_sl = q_sl;
  return (int)dispatch({q, q_sb, q_sh, q_sl}, {k, k_sb, k_sh, k_sl}, {v, k_sb, k_sh, k_sl},
                       p, (cudaStream_t)stream);
}
