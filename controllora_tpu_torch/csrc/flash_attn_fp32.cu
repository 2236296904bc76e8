// Non-causal dense flash attention in fp32, forward and backward, for NVIDIA Hopper
// (sm_90a): the fp32 route of K1-K5.
//
// The JAX package's flash kernels take any float dtype: they cast each block to fp32
// and multiply with fp32 results, and write their outputs in the input dtype. Its fp32
// stacks (training under --mixed_precision no, the smoke stacks, the SDXL refiner as
// scripts/serve.py serves it) reach them with fp32 inputs. The wgmma kernels of
// flash_attn_fwd.cu and flash_attn_bwd.cu take bf16 only; this file holds their fp32
// counterparts:
//   flash_fwd_3xtf32_kernel       K1  controllora_tpu/ops/pallas_attention.py::_attn_kernel
//   (head dims up to 80),             (entry point k1_biased_flash_fwd_f32, with
//   flash_fwd_d160_3xtf32_kernel      bias_add_f32_kernel adding the biases in fp32 first,
//   (88-160) and                      as the JAX caller adds them),
//   flash_fwd_wide_3xtf32_kernel
//   (168-512)
//                                 K2  controllora_tpu/ops/pallas_attention_vjp.py::_fwd_kernel
//                                     (k2_flash_fwd_lse_f32: O and LSE),
//                                 K5  the forward of jax's stock TPU flash attention
//                                     (jax/experimental/pallas/ops/tpu/flash_attention.py::
//                                     _flash_attention_kernel, reached through
//                                     controllora_tpu/ops/attention.py::_flash_stock;
//                                     k5_stock_flash_fwd_f32: O, m and l);
//   flash_bwd_dkv_3xtf32_kernel   K3  pallas_attention_vjp.py::_bwd_dkv_kernel
//   (head dims up to 80) and          (k3_flash_bwd_dkv_f32) and K5's
//   flash_bwd_dkv_d160_3xtf32_kernel  _flash_attention_dkv_kernel (k5_stock_flash_bwd_dkv_f32);
//   (88-160)
//   flash_bwd_dq_3xtf32_kernel    K4  pallas_attention_vjp.py::_bwd_dq_kernel
//   (up to 80) and                    (k4_flash_bwd_dq_f32) and K5's _flash_attention_dq_kernel
//   flash_bwd_dq_d160_3xtf32_kernel   (k5_stock_flash_bwd_dq_f32).
//   (88-160)
// Each entry point has the C signature of its bf16 namesake, so the wrappers in
// ops/flash_attention.py and ops/flash_stock.py pick one by the inputs' dtype.
//
// What bounds them on the H100: the products. At the fp32 paths' shapes (L 4096, D 8-80
// or 512) the work is 4 L^2 D flops a head forward (dK/dV 8, dQ 6) against ~16 L D
// bytes, so operations bound them by far. The products must be fp32-accurate: the JAX
// kernels multiply fp32 blocks with fp32 results, and the port runs fp32 with TF32 off
// (outputs within 1e-4 * max(1, max|ref|) of fp32). One TF32 product keeps 11 bits of
// each operand and misses that bound; three do not (tests/test_torch_tf32_split.py
// emulates both). So every kernel here runs every product as 3xTF32 on the tensor
// cores: each operand x is split into hi = x with its 13 low mantissa bits dropped and
// lo = tf32_rna(x - hi) (cvt.rna.tf32.f32's rounding), and a product is lo*hi + hi*lo +
// hi*hi into one fp32 accumulator, the two small terms first. Their bound is the
// card's 495 TF32 TFLOP/s over three, 165 TFLOP/s. Every operand is split explicitly
// (no product reads raw fp32 and leaves the truncation to the tensor core).
//
// The 3xTF32 kernels are built like the bf16 ones (hopper.cuh): a producer warpgroup
// and consumer warpgroups that issue wgmma.mma_async (m64nNk8, tf32; wgmma_tf32.cuh)
// from registers or 128-byte swizzled shared memory, the online softmax on the
// accumulators in registers, and TMA tensor maps over (B, H, L, D) fp32 views by their
// strides (encode_heads with fp32: 32 floats a swizzle span, zero filled past L and past
// D). What differs is the split and one layout constraint: tf32 wgmma reads a shared
// operand K-major only (it has no transpose bit), so an operand whose reduction runs
// over tokens (V in O += P V, dO in dV += P^T dO, Q in dK += dS^T Q, K in dQ += dS K)
// is needed with the tokens contiguous, which TMA cannot give. So the kernels split as
// well as copy: one thread keeps TMA loads of raw fp32 tiles in flight through a ring
// of mbarriers, and the split writes each raw tile's hi and lo in the same swizzled
// layout and the transposed ones (V^T, Q^T, dO^T, K^T, hi and lo) with the tokens
// contiguous, then fences the async proxy before wgmma reads them. In the forward up
// to D 80, dK/dV and dQ the producer warpgroups' threads split and arrive on a
// "derived" barrier that the consumers wait on; in the wide forward each consumer
// warpgroup splits its own next step while its products run. The split sets the pace
// (a build that skipped it ran far faster), so each thread issues its shared-memory
// loads in batches (split_tile) and rounds with integer operations (tf32_rna).
// P and dS are split in registers and go in as the A operand (but in the wide
// forward). An accumulator holds columns 2 t4 and
// 2 t4 + 1 of each 8 where a tf32 A fragment holds t4 and t4 + 4, so the transposed
// tiles store each 8-token group in the order 0 2 4 6 1 3 5 7: the A fragment then
// reads the accumulator's registers as they are (acc_to_a_tf32).
//
//   * forward, D <= 80 (flash_fwd_3xtf32_kernel): two consumer warpgroups own 64 query
//     rows each (128 a block) and keep Q's hi and lo A fragments in registers for the
//     whole key loop (loaded once from global memory, zeros past Lq and D); 64-key
//     tiles; each derived stage holds K hi, K lo (one 128-byte span per 32 columns) and
//     V^T hi, lo (D rows of 64 keys). Raw and derived stages, shared memory:
//       D 8: 2 + 2, 72 KB; D 16: 2 + 2, 80 KB; D 32: 2 + 2, 96 KB; D 40: 2 + 2,
//       168 KB; D 64 (also 48, 56): 2 + 2, 192 KB; D 80: 1 + 2, 224 KB.
//     D 40 runs its products at depth 40 (k8 steps) and O at N = 40. Up to D 40 two
//     producer warpgroups split (512 threads); registers a thread (setmaxnreg):
//     consumers 184, 216 or 224 (up to D 40, 64, 80), producers the rest (72, 72, 56).
//   * forward, D 168-512 (flash_fwd_wide_3xtf32_kernel) and 88-160
//     (flash_fwd_d160_3xtf32_kernel), one template (wide_fwd): 64 query rows a block and
//     64-key tiles. Q with its lo (256 KB) cannot stay resident, and a 64 x 512 fp32 O
//     needs 256 registers a thread, so the two consumer warpgroups split the head: each
//     owns 256 columns of O (128 registers) and forms S over its own 256 columns of the
//     head, and the two partial S tiles are exchanged through shared memory and added
//     (a + b == b + a, so both hold the same bits and run the same softmax). P's hi
//     (written by one warpgroup) and lo (by the other) then take the exchange buffer's
//     place as a shared A operand: their 64 registers beside the 128 of O made ptxas
//     spill and serialise the wgmma. Q and K are streamed in 32-column chunks per key
//     tile (Q is re-read from L2 for every key tile), V in 32-column chunks; so a tile
//     takes 16 steps a warpgroup, 8 of S (Q and K chunk: hi in place, lo beside) and 8
//     of O (the V chunk, its V^T hi and lo). Two producer threads only copy (one per
//     warpgroup, 24 registers), and each consumer warpgroup (240) splits step i + 1
//     while the products of step i run: with the producer's four warps splitting for
//     both, the first design of this kernel ran at 23% of its bound (chip_smoke.py's
//     timing). Shared memory: 3
//     stages of 32 KB per warpgroup and the 32 KB exchange: 224 KB. Heads of 168-504 are
//     zero filled to 512. Heads of 88-160 are zero filled to 160, five spans: warpgroup 0
//     forms S over spans 0-2 and owns O's spans 0-1, warpgroup 1 S over 3-4 and O's 2-4,
//     so a key tile takes five steps of each and O 48 registers. Ownership is by whole
//     spans: a split inside one would start a TMA box and a K-major operand mid swizzle
//     span. The 128-row alternative (each warpgroup all 160 columns of its 64 rows, O 80
//     registers, P split in registers) must split Q again for every key tile as this
//     design does, and holds K, V^T and Q's hi and lo for both warpgroups in the same
//     227 KB; this one reuses the D 512 kernel whole.
//   * dK/dV, D <= 80 (flash_bwd_dkv_3xtf32_kernel): keys stay stationary, 64 per
//     consumer warpgroup. K and V are loaded once and split in place (hi) beside their
//     lo; S^T = K Q^T and dP^T = V dO^T read both operands from shared memory, dV +=
//     P^T dO and dK += dS^T Q take P^T and dS^T from registers and dO^T, Q^T from the
//     derived buffer. Query tiles of 32 rows come through a ring of raw Q/dO stages; the
//     transform writes Q, dO hi and lo, Q^T and dO^T hi and lo, and the tile's LSE (K5:
//     m + log l) and Dcap rows into one derived buffer. Shared memory:
//       D 8, 16, 32: 2 warpgroups (128 keys), 2 raw stages, 112 KB at D 32;
//       D 40: 2 warpgroups, 2 raw stages, 212 KB; D 64 (also 48, 56): 224 KB;
//       D 80: 1 warpgroup (64 keys), 1 raw stage, 208 KB.
//     Two producer warpgroups split; registers: consumers 192 (232 with one warpgroup),
//     producers 64 (136). One derived buffer fits beside the resident K and V; its two
//     parts are released apart (the Q, dO part once S^T and dP^T are formed, the
//     transposed part at the tile's end), so the next tile's split overlaps this one's
//     products.
//   * dQ, D <= 80 (flash_bwd_dq_3xtf32_kernel): queries stay stationary, 64 per consumer
//     warpgroup, each thread with its two rows' LSE (K5: m + log l) and Dcap in
//     registers. The ring carries raw K and V tiles; each derived stage holds K hi, lo
//     (the B operand of S = Q K^T), V hi, lo (of dP = dO V^T) and K^T hi, lo (of dQ +=
//     dS K, which reduces over keys: D rows of the tile's keys). dS is split in
//     registers into the A operand, a k-step of 8 keys at a time. Instances, shared
//     memory:
//       D 8, 16, 32: 2 consumer warpgroups (128 queries), Q and dO as hi and lo A
//       fragments in registers (loaded once), 64-key tiles, 2 raw + 3 derived stages,
//       140, 152, 176 KB; D 40: the same with 1 + 2 stages, 200 KB (2 + 2 do not fit);
//       D 64 (also 48, 56): 1 consumer warpgroup (64 queries), Q in registers and dO's
//       hi and lo split once into shared memory (both as fragments, 2 DP registers, do
//       not fit beside S, dP and dQ), 32-key tiles (64-key stages do not fit beside
//       dO), 2 + 3 stages, 208 KB; D 80: the same with 1 + 2 stages, 208 KB.
//     Two producer warpgroups split; registers: consumers 184 up to D 32, 200 at D 40,
//     232 with one warpgroup; producers 72, 56, 136.
//   * dK/dV and dQ, D 88-160 (flash_bwd_dkv_d160_3xtf32_kernel,
//     flash_bwd_dq_d160_3xtf32_kernel): 64 stationary rows a block, each consumer
//     warpgroup holding one stationary operand raw in registers and splitting it a k-step
//     at a time; 16-row streamed tiles, the transposed tiles in the 64-byte swizzle;
//     their section below has the design and budgets.
//   * ragged L: scores of keys at or past Lk are -inf in the forward and P is 0 by index
//     in dQ, and P^T is 0 by index for queries at or past Lq in dK/dV; stationary rows
//     past L are computed on zeros and never stored. The softmax scale is a runtime
//     argument of either sign; the forward tracks its running max on S * scale *
//     log2(e).
// The fp32 loads need a 16-byte aligned base and D and every element stride a multiple
// of 4 floats: 16 bytes, what TMA asks and what dQ's 16-byte loads of dO take
// (ops/flash_attention.py::vector_geometry checks the same on the host). The launch
// bounds name one block an SM: with the thread count alone ptxas capped some instances
// and spilled.

#include <algorithm>
#include <climits>
#include <type_traits>

#include "hopper.cuh"
#include "wgmma_tf32.cuh"

namespace {

using hopper::encode_heads;
using hopper::HeadView;
using hopper::projection_view;
using hopper::smem_u32;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------- 3xTF32

using hopper::desc_sw128;
using hopper::ex2;
using hopper::fence_regs;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_init_fence;
using hopper::mbar_wait;
using hopper::tma_load_4d;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;

constexpr int kSpan = 32;           // fp32 columns of one 128-byte swizzle span
constexpr int kSpanRow = 128;       // bytes of a row of one span
constexpr int kProducerBar = 1;     // named barrier of the producer warpgroup
constexpr int kExchangeBar = 2;     // named barriers of the wide forward's consumers (2, 3)

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Order this thread's generic shared-memory writes before later async-proxy accesses
// (wgmma reads, TMA writes) to the same memory.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// x with its 13 low mantissa bits dropped: the tf32 value hi of the split.
__device__ __forceinline__ uint32_t tf32_hi(float x) { return __float_as_uint(x) & 0xffffe000u; }

// x rounded to tf32, to nearest with ties away from zero: what cvt.rna.tf32.f32 computes
// for finite x, in two integer operations (the magnitude's bits + half a tf32 unit, then
// truncated; a carry into the exponent is the rounding up it should be): with the
// conversion instruction the splits ran slower, and the outputs were the same bits.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to about 2^-22 |x|: hi = tf32_hi(x), lo = tf32_rna(x - hi) (x - hi is exact).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_hi(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(const float4& x, uint4& hi, uint4& lo) {
  split(x.x, hi.x, lo.x);
  split(x.y, hi.y, lo.y);
  split(x.z, hi.z, lo.z);
  split(x.w, hi.w, lo.w);
}

// Byte offset of (row, column c < 32) in a 128-byte swizzled span (1024-byte aligned):
// the 16-byte unit c / 4 of a row is stored at unit c / 4 ^ row % 8.
__device__ __forceinline__ int sw128(int row, int c) {
  return row * kSpanRow + ((((c >> 2) ^ row) & 7) << 4) + (c & 3) * 4;
}

// Byte offset of the 16-byte unit u (< 4) of row n in a tile of 64-byte rows in the
// 64-byte swizzle (1024-byte aligned; 8-row atoms of 512 bytes): the unit is stored at
// u ^ (n / 2) % 4, as TMA's and wgmma's 64-byte swizzle place it.
__device__ __forceinline__ int sw64(int n, int u) { return n * 64 + (((u ^ (n >> 1)) & 3) << 4); }

// Shared-memory descriptor of a K-major operand in 128-byte swizzled spans: k-step kk
// (8 tf32 columns, 32 bytes) of a tile whose span s starts at tile + s * span_bytes.
__device__ __forceinline__ uint64_t kdesc(const unsigned char* tile, int kk, int span_bytes) {
  return desc_sw128(tile + (kk >> 2) * span_bytes + (kk & 3) * 32, 16, 1024);
}

// Shared-memory descriptor of a K-major operand in the 64-byte swizzle (layout type 2):
// k-step t (8 tf32 columns, 32 bytes) of a tile of 64-byte rows (sw64), 8-row atoms 512
// bytes apart.
__device__ __forceinline__ uint64_t kdesc64(const unsigned char* tile, int t) {
  const uint64_t addr = smem_u32(tile + t * 32);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(512 >> 4) << 32) | (2ull << 62);
}

// The split A fragments of k-step t (accumulator columns 8t..8t + 7) of a 64-row fp32
// accumulator: a[0..3] = columns 2 t4 and 2 t4 + 1 of rows g, g + 8 as logical columns
// t4 and t4 + 4 of the fragment, so the B operand stores the 8 tokens as 0 2 4 6 1 3 5 7.
__device__ __forceinline__ void acc_to_a_tf32(uint32_t* hi, uint32_t* lo, const float* acc, int t) {
  split(acc[4 * t], hi[0], lo[0]);
  split(acc[4 * t + 2], hi[1], lo[1]);
  split(acc[4 * t + 1], hi[2], lo[2]);
  split(acc[4 * t + 3], hi[3], lo[3]);
}

// The split A fragments of a 64-row operand for every k-step of the head, from global
// memory: rows r0 and r0 + 8 of x (row stride sl), zeros past L and past D.
template <int DP>
__device__ __forceinline__ void load_a_tf32(uint32_t (&hi)[DP / 8][4], uint32_t (&lo)[DP / 8][4],
                                            const float* x, long long sl, int r0, int L, int D,
                                            int t4) {
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + 8 * (e & 1), col = kk * 8 + t4 + 4 * (e >> 1);
      split(row < L && col < D ? x[row * sl + col] : 0.f, hi[kk][e], lo[kk][e]);
    }
}

// d (64 x N) [+]= A B over `steps` k-steps of depth 8, 3xTF32, both operands from
// shared memory: A's rows in a_hi / a_lo (spans a_span bytes apart), B's in b_hi / b_lo;
// `overwrite` starts d from the first product.
template <int N>
__device__ __forceinline__ void ss_3xtf32(float* d, const unsigned char* a_hi,
                                          const unsigned char* a_lo, int a_span,
                                          const unsigned char* b_hi, const unsigned char* b_lo,
                                          int b_span, int steps, bool overwrite) {
#pragma unroll
  for (int kk = 0; kk < steps; ++kk) {
    const uint64_t ah = kdesc(a_hi, kk, a_span), al = kdesc(a_lo, kk, a_span);
    const uint64_t bh = kdesc(b_hi, kk, b_span), bl = kdesc(b_lo, kk, b_span);
    hopper::wgmma_tf32_ss<N>(d, al, bh, !(overwrite && kk == 0));
    hopper::wgmma_tf32_ss<N>(d, ah, bl, 1);
    hopper::wgmma_tf32_ss<N>(d, ah, bh, 1);
  }
}

// d (64 x N) += A (registers, hi and lo) B (shared, hi and lo), one k-step, 3xTF32.
template <int N>
__device__ __forceinline__ void rs_3xtf32(float* d, const uint32_t* a_hi, const uint32_t* a_lo,
                                          uint64_t b_hi, uint64_t b_lo, int accumulate) {
  hopper::wgmma_tf32_rs<N>(d, a_lo, b_hi, accumulate);
  hopper::wgmma_tf32_rs<N>(d, a_hi, b_lo, 1);
  hopper::wgmma_tf32_rs<N>(d, a_hi, b_hi, 1);
}

// hi and lo of a tile as TMA writes it (SPANS spans of ROWS rows, span s at s * ROWS *
// 128 bytes), into tiles of the same layout (hi may be src itself); 16-byte units at or
// past column COLS are skipped (no k-step reads them). NT threads, this one tid. Each
// thread loads kBatch units before it writes any: stores that may alias the next loads
// would otherwise keep one load in flight, and the copy would wait on shared memory.
constexpr int kBatch = 4;

template <int ROWS, int SPANS, int COLS, int NT>
__device__ __forceinline__ void split_tile(const unsigned char* src, unsigned char* hi,
                                           unsigned char* lo, int tid) {
  constexpr int kUnits = SPANS * ROWS * 8, kIter = (kUnits + NT - 1) / NT;
#pragma unroll 1
  for (int it = 0; it < kIter; it += kBatch) {
    float4 x[kBatch];
    bool ok[kBatch];
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      const int u = tid + (it + e) * NT, r = (u >> 3) % ROWS;
      const int col = (u / (ROWS * 8)) * kSpan + (((u & 7) ^ (r & 7)) << 2);
      ok[e] = it + e < kIter && u < kUnits && col < COLS;
      if (ok[e]) x[e] = *reinterpret_cast<const float4*>(src + u * 16);
    }
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      if (!ok[e]) continue;
      const int u = tid + (it + e) * NT;
      uint4 h, l;
      split4(x[e], h, l);
      *reinterpret_cast<uint4*>(hi + u * 16) = h;
      *reinterpret_cast<uint4*>(lo + u * 16) = l;
    }
  }
}

// The transpose of a TOKENS x COLS tile as TMA writes it (spans of 32 columns, a row a
// token), split: COLS rows of TOKENS tokens (span s of 32 tokens at s * COLS * 128
// bytes, swizzled), each 8-token group stored in the order 0 2 4 6 1 3 5 7. A thread
// writes one 16-byte unit of hi and of lo from four tokens of one column, kBatch units'
// loads first as in split_tile.
template <int TOKENS, int COLS, int NT>
__device__ __forceinline__ void transpose_split(const unsigned char* src, unsigned char* hi,
                                                unsigned char* lo, int tid) {
  constexpr int kItems = COLS * TOKENS / 4, kIter = (kItems + NT - 1) / NT;
#pragma unroll 1
  for (int it = 0; it < kIter; it += kBatch) {
    float4 x[kBatch];
    bool ok[kBatch];
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      const int i = tid + (it + e) * NT;
      ok[e] = it + e < kIter && i < kItems;
      if (!ok[e]) continue;
      const int n = i % COLS, u = i / COLS;   // column, output unit along the tokens
      const int k0 = (u >> 1) * 8 + (u & 1);  // tokens k0, k0 + 2, k0 + 4, k0 + 6
      const unsigned char* col = src + (n >> 5) * (TOKENS * kSpanRow);
      x[e].x = *reinterpret_cast<const float*>(col + sw128(k0, n & 31));
      x[e].y = *reinterpret_cast<const float*>(col + sw128(k0 + 2, n & 31));
      x[e].z = *reinterpret_cast<const float*>(col + sw128(k0 + 4, n & 31));
      x[e].w = *reinterpret_cast<const float*>(col + sw128(k0 + 6, n & 31));
    }
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      if (!ok[e]) continue;
      const int i = tid + (it + e) * NT, n = i % COLS, u = i / COLS;
      uint4 h, l;
      split4(x[e], h, l);
      const int off = (u >> 3) * (COLS * kSpanRow) + n * kSpanRow + ((((u & 7) ^ n) & 7) << 4);
      *reinterpret_cast<uint4*>(hi + off) = h;
      *reinterpret_cast<uint4*>(lo + off) = l;
    }
  }
}

// The same for a 16-token tile (spans of 16 rows): COLS rows of the 16 tokens, 64 bytes
// each in the 64-byte swizzle (sw64). A thread takes whole columns: it reads a column's
// 16 tokens (a warp's threads read 32 neighbouring columns of one token, so no two
// share a bank) and writes the row's four 16-byte units of hi and of lo.
template <int COLS, int NT>
__device__ __forceinline__ void transpose_split16(const unsigned char* src, unsigned char* hi,
                                                  unsigned char* lo, int tid) {
#pragma unroll 1
  for (int n = tid; n < COLS; n += NT) {
    const unsigned char* col = src + (n >> 5) * (16 * kSpanRow) + (n & 3) * 4;
    const int q = (n >> 2) & 7;  // the column's 16-byte unit, swizzled by the row
    float x[16];
#pragma unroll
    for (int k = 0; k < 8; ++k) {  // tokens k and k + 8 share a swizzle phase
      x[k] = *reinterpret_cast<const float*>(col + k * kSpanRow + ((q ^ k) << 4));
      x[k + 8] = *reinterpret_cast<const float*>(col + (k + 8) * kSpanRow + ((q ^ k) << 4));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k0 = (u >> 1) * 8 + (u & 1);  // tokens k0, k0 + 2, k0 + 4, k0 + 6
      uint4 h, l;
      split4(make_float4(x[k0], x[k0 + 2], x[k0 + 4], x[k0 + 6]), h, l);
      *reinterpret_cast<uint4*>(hi + sw64(n, u)) = h;
      *reinterpret_cast<uint4*>(lo + sw64(n, u)) = l;
    }
  }
}

// ---------------------------------------------------------------- forward

struct FwdParams {
  HeadView q, k, v;     // (B, H, L, D) fp32 by element strides
  float* o;             // written by the strides o_sb, o_sh, o_sl
  long long o_sb, o_sh, o_sl;
  float* lse;           // (B*H, Lq) or null
  float* m;             // K5's residuals (B*H, Lq) or null (then l is null too): the row
  float* l;             //   max of S * scale and the normaliser at it
  int B, H, Lq, Lk, D;
  float scale_log2;     // softmax scale * log2(e), of either sign
};

constexpr int kFwdKeys = 64;  // keys a tile (both forward designs)

// The online softmax of one 64-key tile of S (64 rows x 64 keys, unscaled) in the
// accumulator: scaled to base 2, keys at or past Lk masked, P = 2^(S - m) in place,
// m (rows g and g + 8) and this thread's parts of l updated; returns the factors alpha
// by which the rows' O must be rescaled.
__device__ __forceinline__ float2 softmax_tile(float* s, float& m0, float& m1, float& l0,
                                               float& l1, float scale_log2, int key0, int Lk,
                                               int t4) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] *= scale_log2;
  if (key0 + kFwdKeys > Lk) {  // the ragged tail: keys at or past Lk do not exist
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (key0 + (i / 4) * 8 + t4 * 2 + (i & 1) >= Lk) s[i] = -INFINITY;
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: key0 < Lk
  const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    s[4 * n] = ex2(s[4 * n] - mn0);
    s[4 * n + 1] = ex2(s[4 * n + 1] - mn0);
    s[4 * n + 2] = ex2(s[4 * n + 2] - mn1);
    s[4 * n + 3] = ex2(s[4 * n + 3] - mn1);
    sum0 += s[4 * n] + s[4 * n + 1];
    sum1 += s[4 * n + 2] + s[4 * n + 3];
  }
  l0 = l0 * a0 + sum0;
  l1 = l1 * a1 + sum1;
  return make_float2(a0, a1);
}

// Rows r0 and r0 + 8 of an fp32 accumulator over N columns (col0.. of the head), times
// mul0 / mul1, at out + row * row_stride + column; columns at or past D and rows at or
// past L are not stored.
template <int N>
__device__ __forceinline__ void store_acc_f32(float* out, long long row_stride, const float* acc,
                                              float mul0, float mul1, int r0, int L, int col0,
                                              int D, int t4) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    const int col = col0 + n * 8 + t4 * 2;
    if (col >= D) continue;
    if (r0 < L)
      *reinterpret_cast<float2*>(out + r0 * row_stride + col) =
          make_float2(acc[4 * n] * mul0, acc[4 * n + 1] * mul0);
    if (r0 + 8 < L)
      *reinterpret_cast<float2*>(out + (r0 + 8) * row_stride + col) =
          make_float2(acc[4 * n + 2] * mul1, acc[4 * n + 3] * mul1);
  }
}

// The epilogue of both forward designs: the row sums reduced over the quad, O = acc / l
// (N columns from col0, none at or past col_end), and, by the threads with write_rows,
// LSE or K5's m and l.
template <int N>
__device__ __forceinline__ void fwd_epilogue(const FwdParams& p, const float* o, float m0,
                                             float m1, float l0, float l1, int b, int h,
                                             int r0, int col0, int col_end, int t4,
                                             bool write_rows) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  store_acc_f32<N>(p.o + b * p.o_sb + h * p.o_sh, p.o_sl, o, 1.f / l0, 1.f / l1, r0, p.Lq,
                   col0, min(p.D, col_end), t4);
  if (!write_rows) return;
  const size_t row = ((size_t)b * p.H + h) * p.Lq + r0;
  const float m[2] = {m0, m1}, l[2] = {l0, l1};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (r0 + 8 * i >= p.Lq) continue;
    if (p.lse != nullptr) p.lse[row + 8 * i] = (m[i] + log2f(l[i])) * kLn2;
    if (p.m != nullptr) {  // m back from base 2; l is the same sum in either base
      p.m[row + 8 * i] = m[i] * kLn2;
      p.l[row + 8 * i] = l[i];
    }
  }
}

// DP: the head dim rounded up to an instance (8, 16, 32, 40, 64, 80); RAW / DER: raw
// and derived stages.
template <int DP, int RAW, int DER>
struct FwdCfg {
  static constexpr int kDP = DP, kRaw = RAW, kDer = DER;
  static constexpr int kSpans = (DP + kSpan - 1) / kSpan;   // spans of a raw row
  static constexpr int kRows = 128;                         // queries a block
  static constexpr int kTile = kSpans * kFwdKeys * kSpanRow;  // raw K or V, K hi or lo
  static constexpr int kVT = (kFwdKeys / kSpan) * DP * kSpanRow;  // V^T hi or lo
  static constexpr int kRawStage = 2 * kTile;
  static constexpr int kDerStage = 2 * kTile + 2 * kVT;
  // producer warpgroups: two split twice as fast where the consumers' registers leave
  // room for them (up to D 40, the main path's)
  static constexpr int kPW = DP <= 40 ? 2 : 1;
  static constexpr int kProducerThreads = 128 * kPW;
  static constexpr int kThreads = 256 + kProducerThreads;  // two consumer warpgroups
  // registers a thread (setmaxnreg): the consumers hold Q's fragments (DP), O (DP / 2)
  // and S with P's fragments (96); the producers' batched copies take the rest
  // (setmaxnreg moves registers within the block's launch allocation, 128 a thread at
  // 512 threads and 168 at 384: asking for more blocks the warps for good)
  static constexpr int kConsumerRegs = DP <= 40 ? 184 : DP <= 64 ? 216 : 224;
  static constexpr int kProducerRegs =
      (kThreads * (65536 / kThreads / 8 * 8) - 256 * kConsumerRegs) / kProducerThreads / 8 * 8;
  static constexpr size_t kSmem =
      1024 + (size_t)RAW * kRawStage + (size_t)DER * kDerStage + 8 * (RAW + 2 * DER);
  static_assert(DP % 8 == 0 && DP <= 80, "the narrow forward covers head dims up to 80");
  static_assert(kProducerRegs >= 56, "the producers' batched copies need 56 registers");
};

template <int DP, int RAW, int DER>
__global__ void __launch_bounds__(FwdCfg<DP, RAW, DER>::kThreads, 1)
    flash_fwd_3xtf32_kernel(const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv, const FwdParams p) {
  using C = FwdCfg<DP, RAW, DER>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* raw = base;                                // RAW x (K, V)
  unsigned char* der = raw + (size_t)RAW * C::kRawStage;    // DER x (K hi, lo, V^T hi, lo)
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(der + (size_t)DER * C::kDerStage);
  uint64_t* der_full = raw_full + RAW;
  uint64_t* der_empty = der_full + DER;

  const int q_tiles = (p.Lq + C::kRows - 1) / C::kRows;
  const int qt = blockIdx.x % q_tiles, bh = blockIdx.x / q_tiles;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = qt * C::kRows;
  const int n_tiles = (p.Lk + kFwdKeys - 1) / kFwdKeys;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < RAW; ++s) mbar_init(&raw_full[s], 1);
    for (int s = 0; s < DER; ++s) {
      mbar_init(&der_full[s], 1);
      mbar_init(&der_empty[s], 8);  // the consumer warps
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    // ---------------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs));
    const int tid = threadIdx.x - 256;
    auto issue = [&](int j) {
      const int s = j % RAW;
      unsigned char* ks = raw + (size_t)s * C::kRawStage;
      mbar_expect_tx(&raw_full[s], C::kRawStage);
      for (int c = 0; c < C::kSpans; ++c) {
        tma_load_4d(ks + c * (kFwdKeys * kSpanRow), &tk, &raw_full[s], c * kSpan, h,
                    j * kFwdKeys, b);
        tma_load_4d(ks + C::kTile + c * (kFwdKeys * kSpanRow), &tv, &raw_full[s], c * kSpan, h,
                    j * kFwdKeys, b);
      }
    };
    if (tid == 0)
      for (int j = 0; j < RAW && j < n_tiles; ++j) issue(j);
    for (int j = 0; j < n_tiles; ++j) {
      const int rs = j % RAW, ds = j % DER;
      mbar_wait(&raw_full[rs], (j / RAW) & 1);
      mbar_wait(&der_empty[ds], ((j / DER) & 1) ^ 1);
      const unsigned char* ks = raw + (size_t)rs * C::kRawStage;
      unsigned char* d = der + (size_t)ds * C::kDerStage;
      split_tile<kFwdKeys, C::kSpans, DP, C::kProducerThreads>(ks, d, d + C::kTile, tid);
      transpose_split<kFwdKeys, DP, C::kProducerThreads>(ks + C::kTile, d + 2 * C::kTile,
                                                         d + 2 * C::kTile + C::kVT, tid);
      fence_async_shared();
      named_sync(kProducerBar, C::kProducerThreads);  // raw stage read, derived one written
      if (tid == 0) {
        mbar_arrive(&der_full[ds]);
        if (j + RAW < n_tiles) issue(j + RAW);
      }
    }
    return;
  }

  // ------------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));
  const int wg = warp / 4, wl = warp % 4;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = q0 + wg * 64 + wl * 16 + g;  // this thread's rows r0 and r0 + 8

  // Q's hi and lo A fragments for every k-step of the head, zeros past Lq and past D
  uint32_t qh[DP / 8][4], ql[DP / 8][4];
  load_a_tf32<DP>(qh, ql, static_cast<const float*>(p.q.base) + b * p.q.sb + h * p.q.sh,
                  p.q.sl, r0, p.Lq, p.D, t4);

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int ds = j % DER;
    mbar_wait(&der_full[ds], (j / DER) & 1);
    const unsigned char* d = der + (size_t)ds * C::kDerStage;
    const unsigned char* k_hi = d;
    const unsigned char* k_lo = d + C::kTile;
    const unsigned char* vt_hi = d + 2 * C::kTile;
    const unsigned char* vt_lo = vt_hi + C::kVT;

    // S = Q K^T (unscaled), 64 rows x 64 keys
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk)
      rs_3xtf32<64>(s, qh[kk], ql[kk], kdesc(k_hi, kk, kFwdKeys * kSpanRow),
                    kdesc(k_lo, kk, kFwdKeys * kSpanRow), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(s);

    const float2 alpha = softmax_tile(s, m0, m1, l0, l1, p.scale_log2, j * kFwdKeys, p.Lk, t4);

    // O = alpha O + P V, P split in registers, V^T from the derived stage
    uint32_t ph[8][4], pl[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) acc_to_a_tf32(ph[t], pl[t], s, t);
#pragma unroll
    for (int i = 0; i < DP / 2; i += 4) {
      o[i] *= alpha.x;
      o[i + 1] *= alpha.x;
      o[i + 2] *= alpha.y;
      o[i + 3] *= alpha.y;
    }
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 8; ++t)
      rs_3xtf32<DP>(o, ph[t], pl[t], kdesc(vt_hi, t, DP * kSpanRow),
                    kdesc(vt_lo, t, DP * kSpanRow), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DP / 2>(o);
    fence_regs<32>(&ph[0][0]);
    fence_regs<32>(&pl[0][0]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&der_empty[ds]);
  }
  fwd_epilogue<DP>(p, o, m0, m1, l0, l1, b, h, r0, 0, DP, t4, t4 == 0);
}

// The wide designs (D 88-160 and up to 512): STAGES stages per consumer warpgroup, each
// 32 KB: the raw tiles TMA writes (Q and K chunks, split to hi in place; or a V chunk)
// and the derived ones (Q and K lo; or V^T hi and lo). The head is SPANS spans of 32
// columns; warpgroup 0 forms S over spans [0, S0) and owns O's spans [0, O0), warpgroup
// 1 the rest, so a key tile takes S0 + O0 steps of warpgroup 0 and the rest of 1.
template <int STAGES, int SPANS, int S0, int O0>
struct WideCfg {
  static constexpr int kStages = STAGES, kSpans = SPANS, kS0 = S0, kO0 = O0;
  static constexpr int kRows = 64;              // queries a block
  // O spans a warpgroup holds registers for: the larger of the two parts
  static constexpr int kOSpans = O0 > SPANS - O0 ? O0 : SPANS - O0;
  static constexpr int kChunk = 64 * kSpanRow;  // one 64-row span: 8 KB
  static constexpr int kStage = 4 * kChunk;
  static constexpr int kExchange = 32 * 128 * 4;  // one warpgroup's S tile, or P hi or lo
  static constexpr int kThreads = 384;
  static constexpr size_t kSmem =
      1024 + 2 * (size_t)STAGES * kStage + 2 * kExchange + 8 * 4 * STAGES;
  static_assert(0 < S0 && S0 < SPANS && 0 < O0 && O0 < SPANS, "both warpgroups take spans");
  static_assert(S0 + O0 == SPANS, "the two warpgroups take equal steps a key tile");
};

// D 512: 8 + 8 spans each; D 88-160: S over 3 + 2 spans and O over 2 + 3, five steps a
// tile for each warpgroup (a 2.5 / 2.5 split would start an operand mid span).
using Wide = WideCfg<3, 16, 8, 8>;
using Wide160 = WideCfg<3, 5, 3, 2>;

constexpr int kWarpgroupBar = 4;  // the wide forward's per-warpgroup barriers (4, 5)

template <class C>
__device__ __forceinline__ void wide_fwd(const CUtensorMap* tq, const CUtensorMap* tk,
                                         const CUtensorMap* tv, const FwdParams& p) {
  constexpr int S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* stages = base;  // warpgroup w's at w * S * kStage
  float* xch = reinterpret_cast<float*>(stages + 2 * (size_t)S * C::kStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(xch + 2 * C::kExchange / 4);  // [w * S + s]
  uint64_t* empty = full + 2 * S;

  const int q_tiles = (p.Lq + C::kRows - 1) / C::kRows;
  const int qt = blockIdx.x % q_tiles, bh = blockIdx.x / q_tiles;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = qt * C::kRows;
  const int n_tiles = (p.Lk + kFwdKeys - 1) / kFwdKeys;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // the warps of the stage's warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  // warpgroup w's spans: S over [s_first, s_first + n_s), O over [o_first, o_first + n_o);
  // its steps: n_s + n_o a tile, n_s of S (its Q and K chunk) then n_o of O (V chunk)
  auto spans = [](int w, int& s_first, int& n_s, int& o_first, int& n_o) {
    s_first = w == 0 ? 0 : C::kS0;
    n_s = w == 0 ? C::kS0 : C::kSpans - C::kS0;
    o_first = w == 0 ? 0 : C::kO0;
    n_o = w == 0 ? C::kO0 : C::kSpans - C::kO0;
  };

  if (warp >= 8) {
    // ---------------------------------------------------------------- producer
    // Warp 8 + w keeps warpgroup w's TMA loads in flight; the copies are all it does.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    const int w = warp - 8;
    if (w < 2 && lane == 0) {
      int s_first, n_s, o_first, n_o;
      spans(w, s_first, n_s, o_first, n_o);
      const int per_tile = C::kSpans, n_steps = n_tiles * per_tile;  // n_s + n_o
      for (int i = 0; i < n_steps; ++i) {
        const int s = i % S, r = i % per_tile, key0 = (i / per_tile) * kFwdKeys;
        uint64_t* f = &full[w * S + s];
        mbar_wait(&empty[w * S + s], ((i / S) & 1) ^ 1);
        unsigned char* st = stages + (size_t)(w * S + s) * C::kStage;
        if (r < n_s) {
          mbar_expect_tx(f, 2 * C::kChunk);
          tma_load_4d(st, tq, f, (s_first + r) * kSpan, h, q0, b);
          tma_load_4d(st + C::kChunk, tk, f, (s_first + r) * kSpan, h, key0, b);
        } else {
          mbar_expect_tx(f, C::kChunk);
          tma_load_4d(st, tv, f, (o_first + r - n_s) * kSpan, h, key0, b);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------------ consumers
  // Each warpgroup splits its own stages: the split of step i + 1 runs while the
  // products of step i are in flight, and eight warps split where the producer's four
  // could not keep up (they set the pace of the first design).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wg = warp / 4, wl = warp % 4;
  const int g = lane >> 2, t4 = lane & 3;
  const int wtid = threadIdx.x % 128;
  const int r0 = q0 + wl * 16 + g;
  int s_first, n_s, o_first, n_o;
  spans(wg, s_first, n_s, o_first, n_o);
  const int per_tile = C::kSpans, n_steps = n_tiles * per_tile;  // n_s + n_o
  unsigned char* my = stages + (size_t)wg * S * C::kStage;
  uint64_t* my_full = full + wg * S;
  uint64_t* my_empty = empty + wg * S;

  // Split step i's raw tiles (hi in place, lo beside; or V^T hi and lo) once they are in.
  auto split_step = [&](int i) {
    const int s = i % S;
    unsigned char* st = my + (size_t)s * C::kStage;
    mbar_wait(&my_full[s], (i / S) & 1);
    if (i % per_tile < n_s) {
      split_tile<64, 1, kSpan, 128>(st, st, st + 2 * C::kChunk, wtid);
      split_tile<64, 1, kSpan, 128>(st + C::kChunk, st + C::kChunk, st + 3 * C::kChunk, wtid);
    } else {
      transpose_split<kFwdKeys, kSpan, 128>(st, st + 2 * C::kChunk, st + 3 * C::kChunk, wtid);
    }
    fence_async_shared();
    named_sync(kWarpgroupBar + wg, 128);
  };
  // Step i's products are done: its stage may take TMA writes again.
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&my_empty[i % S]);
  };

  float o[C::kOSpans * 16];
#pragma unroll
  for (int i = 0; i < C::kOSpans * 16; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  int step = 0;
  split_step(0);

  for (int j = 0; j < n_tiles; ++j) {
    // this warpgroup's part of S = Q K^T over its spans of the head
    float s[32];
#pragma unroll 1
    for (int c = 0; c < n_s; ++c, ++step) {
      const unsigned char* st = my + (size_t)(step % S) * C::kStage;
      wgmma_fence();
      ss_3xtf32<64>(s, st, st + 2 * C::kChunk, C::kChunk, st + C::kChunk, st + 3 * C::kChunk,
                    C::kChunk, 4, c == 0);
      wgmma_commit();
      split_step(step + 1);  // an O step follows the last S step
      wgmma_wait<0>();
      release(step);
    }
    fence_regs<32>(s);

    // S = the sum of both parts: each warpgroup adds the other's tile to its own
    float* mine = xch + wg * (C::kExchange / 4);
    const float* other = xch + (1 - wg) * (C::kExchange / 4);
    named_sync(kExchangeBar + 1, 256);  // both are done with the last tile's P
#pragma unroll
    for (int i = 0; i < 32; ++i) mine[i * 128 + wtid] = s[i];
    named_sync(kExchangeBar, 256);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] += other[i * 128 + wtid];
    named_sync(kExchangeBar + 1, 256);  // both have read: the buffer takes P next

    const float2 alpha = softmax_tile(s, m0, m1, l0, l1, p.scale_log2, j * kFwdKeys, p.Lk, t4);
    // P (the same bits in both warpgroups) into the exchange buffer as the A operand of
    // O += P V, hi by warpgroup 0 and lo by warpgroup 1: 64 rows of 64 keys in two
    // swizzled spans, each 8-key group in the order of V^T's (0 2 4 6 1 3 5 7)
    {
      unsigned char* pt = reinterpret_cast<unsigned char*>(xch) + wg * C::kExchange;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int n = i / 4, row = wl * 16 + g + 8 * ((i >> 1) & 1);
        const int pos = (n & 3) * 8 + 4 * (i & 1) + t4;  // keys 8n + 2 t4 (+1)
        uint32_t hi, lo;
        split(s[i], hi, lo);
        *reinterpret_cast<uint32_t*>(pt + (n >> 2) * C::kChunk + sw128(row, pos)) =
            wg == 0 ? hi : lo;
      }
      fence_async_shared();
    }
#pragma unroll
    for (int i = 0; i < C::kOSpans * 16; i += 4) {
      o[i] *= alpha.x;
      o[i + 1] *= alpha.x;
      o[i + 2] *= alpha.y;
      o[i + 3] *= alpha.y;
    }
    named_sync(kExchangeBar, 256);  // P is in
    const unsigned char* p_hi = reinterpret_cast<const unsigned char*>(xch);
    const unsigned char* p_lo = p_hi + C::kExchange;

    // O (this warpgroup's spans of the head) += P V, 32 columns a step
#pragma unroll
    for (int c = 0; c < C::kOSpans; ++c) {
      if (c >= n_o) break;
      const unsigned char* st = my + (size_t)(step % S) * C::kStage;
      wgmma_fence();
      ss_3xtf32<kSpan>(o + c * 16, p_hi, p_lo, C::kChunk, st + 2 * C::kChunk,
                       st + 3 * C::kChunk, kSpan * kSpanRow, 8, false);
      wgmma_commit();
      if (step + 1 < n_steps) split_step(step + 1);  // the next tile's first S step
      wgmma_wait<0>();
      release(step);
      ++step;
    }
    fence_regs<C::kOSpans * 16>(o);
  }
  fwd_epilogue<C::kOSpans * kSpan>(p, o, m0, m1, l0, l1, b, h, r0, o_first * kSpan,
                                   (o_first + n_o) * kSpan, t4, t4 == 0 && wg == 0);
}

// D 168-512, zero filled to 512: each warpgroup 8 spans of S and 8 of O a key tile.
__global__ void __launch_bounds__(384, 1)
    flash_fwd_wide_3xtf32_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv, const FwdParams p) {
  wide_fwd<Wide>(&tq, &tk, &tv, p);
}

// D 88-160, zero filled to 160: five steps a key tile for each warpgroup.
__global__ void __launch_bounds__(384, 1)
    flash_fwd_d160_3xtf32_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv, const FwdParams p) {
  wide_fwd<Wide160>(&tq, &tk, &tv, p);
}

// out = x + bias[batch % bias_batch] over a (B, L, H*D) fp32 tensor, 4 values a thread.
__global__ void bias_add_f32_kernel(const float4* __restrict__ x, const float4* __restrict__ bias,
                                    float4* __restrict__ out, long long per_batch4,
                                    int bias_batch, long long n4) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const long long b = i / per_batch4;
    const float4 xv = x[i];
    const float4 bv = bias[(b % bias_batch) * per_batch4 + (i - b * per_batch4)];
    out[i] = make_float4(xv.x + bv.x, xv.y + bv.y, xv.z + bv.z, xv.w + bv.w);
  }
}

cudaError_t bias_add_f32(const void* x, const void* bias, void* out, int B, int L, int inner,
                         int bias_batch, cudaStream_t stream) {
  const long long per4 = (long long)L * inner / 4, n4 = per4 * B;
  const int blocks = (int)std::min<long long>((n4 + 255) / 256, 132LL * 16);
  bias_add_f32_kernel<<<blocks, 256, 0, stream>>>((const float4*)x, (const float4*)bias,
                                                  (float4*)out, per4, bias_batch, n4);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- backward

struct BwdParams {
  HeadView q, k, v, dout;  // dout shares q's length
  const float* lse;        // (B*H, Lq): LSE, or K5's m when l is set
  const float* l;          // K5's normaliser (B*H, Lq), or null
  const float* dcap;       // (B*H, Lq)
  float* out0;             // dK, or dQ
  float* out1;             // dV, or null
  long long sb, sh, sl;    // element strides of the outputs: k's for dK/dV, q's for dQ
  int B, H, Lq, Lk, D;
  float scale;       // softmax scale: dK = dS^T Q * scale, dQ = dS K * scale
  float scale_log2;  // scale * log2(e): P = 2^(S * scale_log2 - LSE * log2(e))
};

constexpr int kDkvQueries = 32;  // queries a tile of the dK/dV kernel

// DP: the head dim rounded up to an instance; NW consumer warpgroups of 64 keys; RAW
// raw stages of Q and dO.
template <int DP, int NW, int RAW>
struct DkvCfg {
  static constexpr int kDP = DP, kNW = NW, kRaw = RAW;
  static constexpr int kSpans = (DP + kSpan - 1) / kSpan;
  static constexpr int kKeys = 64 * NW;                              // keys a block
  static constexpr int kQueries = kDkvQueries;                       // queries a tile
  static constexpr int kKTile = kSpans * kKeys * kSpanRow;           // K, K lo, V, V lo
  static constexpr int kQTile = kSpans * kDkvQueries * kSpanRow;     // raw Q or dO; hi, lo
  static constexpr int kTTile = DP * kSpanRow;                       // Q^T or dO^T, hi or lo
  static constexpr int kDer = 4 * kQTile + 4 * kTTile + 2 * kDkvQueries * 4;
  static constexpr int kProducerThreads = 256;  // two producer warpgroups split
  static constexpr int kThreads = 128 * NW + kProducerThreads;
  // registers a thread (setmaxnreg): consumers 192 (one warpgroup: 232), producers
  // the rest
  static constexpr int kConsumerRegs = NW == 2 ? 192 : 232;
  static constexpr int kProducerRegs =  // within the launch allocation (FwdCfg)
      (kThreads * (65536 / kThreads / 8 * 8) - 128 * NW * kConsumerRegs) / kProducerThreads /
      8 * 8;
  static constexpr size_t kSmem = 1024 + 4 * (size_t)kKTile + (size_t)RAW * 2 * kQTile + kDer +
                                  8 * (RAW + 6);
  static_assert(DP % 8 == 0 && DP <= 80, "the backward covers head dims up to 80");
};

template <int DP, int NW, int RAW>
__global__ void __launch_bounds__(DkvCfg<DP, NW, RAW>::kThreads, 1)
    flash_bwd_dkv_3xtf32_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tdo,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv, const BwdParams p) {
  using C = DkvCfg<DP, NW, RAW>;
  constexpr int kQ = kDkvQueries;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* k_hi = base;  // raw K, split in place
  unsigned char* k_lo = k_hi + C::kKTile;
  unsigned char* v_hi = k_lo + C::kKTile;
  unsigned char* v_lo = v_hi + C::kKTile;
  unsigned char* raw = v_lo + C::kKTile;  // RAW x (Q, dO)
  unsigned char* der = raw + (size_t)RAW * 2 * C::kQTile;
  unsigned char* q_hi = der;
  unsigned char* q_lo = q_hi + C::kQTile;
  unsigned char* do_hi = q_lo + C::kQTile;
  unsigned char* do_lo = do_hi + C::kQTile;
  unsigned char* qt_hi = do_lo + C::kQTile;
  unsigned char* qt_lo = qt_hi + C::kTTile;
  unsigned char* dot_hi = qt_lo + C::kTTile;
  unsigned char* dot_lo = dot_hi + C::kTTile;
  float* rows = reinterpret_cast<float*>(dot_lo + C::kTTile);  // LSE * log2(e), Dcap
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(der + C::kDer);
  uint64_t* kv_full = raw_full + RAW;
  uint64_t* kv_ready = kv_full + 1;
  // the derived buffer in two parts, each with a full and an empty barrier: A (Q, dO
  // hi and lo, the rows), which S^T and dP^T read, and B (Q^T, dO^T), which dV and dK
  // read; A of the next tile is split while the consumers finish this one, B while
  // they form the next one's S^T and dP^T
  uint64_t* a_full = kv_ready + 1;
  uint64_t* a_empty = a_full + 1;
  uint64_t* b_full = a_empty + 1;
  uint64_t* b_empty = b_full + 1;

  const int k_tiles = (p.Lk + C::kKeys - 1) / C::kKeys;
  const int kt = blockIdx.x % k_tiles, bh = blockIdx.x / k_tiles;
  const int b = bh / p.H, h = bh % p.H;
  const int key0 = kt * C::kKeys;
  const int n_q = (p.Lq + kQ - 1) / kQ;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < RAW; ++s) mbar_init(&raw_full[s], 1);
    mbar_init(kv_full, 1);
    mbar_init(kv_ready, 1);
    mbar_init(a_full, 1);
    mbar_init(a_empty, 4 * NW);
    mbar_init(b_full, 1);
    mbar_init(b_empty, 4 * NW);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * NW) {
    // ---------------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs));
    const int tid = threadIdx.x - 128 * NW;
    constexpr int NT = C::kProducerThreads;
    auto issue = [&](int j) {
      const int s = j % RAW;
      unsigned char* qs = raw + (size_t)s * 2 * C::kQTile;
      mbar_expect_tx(&raw_full[s], 2 * C::kQTile);
      for (int c = 0; c < C::kSpans; ++c) {
        tma_load_4d(qs + c * (kQ * kSpanRow), &tq, &raw_full[s], c * kSpan, h, j * kQ, b);
        tma_load_4d(qs + C::kQTile + c * (kQ * kSpanRow), &tdo, &raw_full[s], c * kSpan, h,
                    j * kQ, b);
      }
    };
    if (tid == 0) {
      mbar_expect_tx(kv_full, 2 * C::kKTile);
      for (int c = 0; c < C::kSpans; ++c) {
        tma_load_4d(k_hi + c * (C::kKeys * kSpanRow), &tk, kv_full, c * kSpan, h, key0, b);
        tma_load_4d(v_hi + c * (C::kKeys * kSpanRow), &tv, kv_full, c * kSpan, h, key0, b);
      }
      for (int j = 0; j < RAW && j < n_q; ++j) issue(j);
    }
    mbar_wait(kv_full, 0);
    split_tile<C::kKeys, C::kSpans, DP, NT>(k_hi, k_hi, k_lo, tid);
    split_tile<C::kKeys, C::kSpans, DP, NT>(v_hi, v_hi, v_lo, tid);
    fence_async_shared();
    named_sync(kProducerBar, NT);
    if (tid == 0) mbar_arrive(kv_ready);

    const size_t row0 = (size_t)bh * p.Lq;
    for (int j = 0; j < n_q; ++j) {
      const int rs = j % RAW;
      mbar_wait(&raw_full[rs], (j / RAW) & 1);
      mbar_wait(a_empty, (j & 1) ^ 1);
      const unsigned char* qs = raw + (size_t)rs * 2 * C::kQTile;
      split_tile<kQ, C::kSpans, DP, NT>(qs, q_hi, q_lo, tid);
      split_tile<kQ, C::kSpans, DP, NT>(qs + C::kQTile, do_hi, do_lo, tid);
      if (tid < kQ) {  // 0 past Lq: those queries are masked by index
        const int q = j * kQ + tid;
        float lse2 = 0.f, dc = 0.f;
        if (q < p.Lq) {
          const size_t r = row0 + q;
          lse2 = (p.l == nullptr ? p.lse[r] : p.lse[r] + logf(p.l[r])) * kLog2e;
          dc = p.dcap[r];
        }
        rows[tid] = lse2;
        rows[kQ + tid] = dc;
      }
      fence_async_shared();
      named_sync(kProducerBar, NT);
      if (tid == 0) mbar_arrive(a_full);
      mbar_wait(b_empty, (j & 1) ^ 1);
      transpose_split<kQ, DP, NT>(qs, qt_hi, qt_lo, tid);
      transpose_split<kQ, DP, NT>(qs + C::kQTile, dot_hi, dot_lo, tid);
      fence_async_shared();
      named_sync(kProducerBar, NT);  // the raw stage is read: it takes the next copy
      if (tid == 0) {
        mbar_arrive(b_full);
        if (j + RAW < n_q) issue(j + RAW);
      }
    }
    return;
  }

  // ------------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));
  const int wg = warp / 4, wl = warp % 4;
  const int g = lane >> 2, t4 = lane & 3;
  constexpr int kKSpan = C::kKeys * kSpanRow;  // bytes of one span of the resident tiles
  const int a_off = wg * 64 * kSpanRow;        // this warpgroup's 64 keys

  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(kv_ready, 0);
  for (int j = 0; j < n_q; ++j) {
    mbar_wait(a_full, j & 1);

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 32 queries each, unscaled
    float st[16], dpt[16];
    wgmma_fence();
    ss_3xtf32<kQ>(st, k_hi + a_off, k_lo + a_off, kKSpan, q_hi, q_lo, kQ * kSpanRow, DP / 8,
                  true);
    wgmma_commit();
    ss_3xtf32<kQ>(dpt, v_hi + a_off, v_lo + a_off, kKSpan, do_hi, do_lo, kQ * kSpanRow, DP / 8,
                  true);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs<16>(st);

    // P^T = exp(S^T * scale - LSE) by query column; 0 for queries at or past Lq
    const int q0 = j * kQ;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = n * 8 + t4 * 2;
      const float2 ls = *reinterpret_cast<const float2*>(rows + col);
      const bool ok0 = q0 + col < p.Lq, ok1 = q0 + col + 1 < p.Lq;
      st[4 * n] = ok0 ? ex2(fmaf(st[4 * n], p.scale_log2, -ls.x)) : 0.f;
      st[4 * n + 1] = ok1 ? ex2(fmaf(st[4 * n + 1], p.scale_log2, -ls.y)) : 0.f;
      st[4 * n + 2] = ok0 ? ex2(fmaf(st[4 * n + 2], p.scale_log2, -ls.x)) : 0.f;
      st[4 * n + 3] = ok1 ? ex2(fmaf(st[4 * n + 3], p.scale_log2, -ls.y)) : 0.f;
    }
    wgmma_wait<0>();
    fence_regs<16>(dpt);

    // dS^T = P^T * (dP^T - Dcap), by query column
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float2 dc = *reinterpret_cast<const float2*>(rows + kQ + n * 8 + t4 * 2);
      dpt[4 * n] = st[4 * n] * (dpt[4 * n] - dc.x);
      dpt[4 * n + 1] = st[4 * n + 1] * (dpt[4 * n + 1] - dc.y);
      dpt[4 * n + 2] = st[4 * n + 2] * (dpt[4 * n + 2] - dc.x);
      dpt[4 * n + 3] = st[4 * n + 3] * (dpt[4 * n + 3] - dc.y);
    }
    __syncwarp();  // this warp's products and row reads of part A are done
    if (lane == 0) mbar_arrive(a_empty);

    // dV += P^T dO and dK += dS^T Q over the tile's 32 queries (4 k-steps of 8)
    uint32_t ph[4][4], pl[4][4], dh[4][4], dl[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      acc_to_a_tf32(ph[t], pl[t], st, t);
      acc_to_a_tf32(dh[t], dl[t], dpt, t);
    }
    mbar_wait(b_full, j & 1);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t)
      rs_3xtf32<DP>(dv, ph[t], pl[t], kdesc(dot_hi, t, DP * kSpanRow),
                    kdesc(dot_lo, t, DP * kSpanRow), 1);
#pragma unroll
    for (int t = 0; t < 4; ++t)
      rs_3xtf32<DP>(dk, dh[t], dl[t], kdesc(qt_hi, t, DP * kSpanRow),
                    kdesc(qt_lo, t, DP * kSpanRow), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DP / 2>(dv);
    fence_regs<DP / 2>(dk);
    fence_regs<16>(&ph[0][0]);
    fence_regs<16>(&pl[0][0]);
    fence_regs<16>(&dh[0][0]);
    fence_regs<16>(&dl[0][0]);
    __syncwarp();
    if (lane == 0) mbar_arrive(b_empty);
  }

  // ------------------------------------------------------------------ epilogue
  const int r0 = key0 + wg * 64 + wl * 16 + g;
  const long long head = b * p.sb + h * p.sh;
  store_acc_f32<DP>(p.out0 + head, p.sl, dk, p.scale, p.scale, r0, p.Lk, 0, p.D, t4);
  store_acc_f32<DP>(p.out1 + head, p.sl, dv, 1.f, 1.f, r0, p.Lk, 0, p.D, t4);
}

// ---------------------------------------------------------------- dQ

// DP: the head dim rounded up to an instance; NW consumer warpgroups of 64 queries;
// KEYS keys a tile; RAW raw stages (K, V) and DER derived ones (K, V, K^T: hi and lo).
// With two consumer warpgroups (up to D 40) each thread keeps Q's and dO's hi and lo A
// fragments in registers; with one (D 64, 80) Q's, and dO's hi and lo tiles sit in
// shared memory, split once at the block's start.
template <int DP, int NW, int KEYS, int RAW, int DER>
struct DqCfg {
  static constexpr int kDP = DP, kNW = NW, kKeys = KEYS, kRaw = RAW, kDer = DER;
  static constexpr bool kDoSmem = NW == 1;
  static constexpr int kSpans = (DP + kSpan - 1) / kSpan;
  static constexpr int kRows = 64 * NW;                       // queries a block
  static constexpr int kTile = kSpans * KEYS * kSpanRow;      // raw K or V; K or V hi or lo
  static constexpr int kKT = (KEYS / kSpan) * DP * kSpanRow;  // K^T hi or lo
  static constexpr int kRawStage = 2 * kTile;
  static constexpr int kDerStage = 4 * kTile + 2 * kKT;
  static constexpr int kDoTile = kDoSmem ? kSpans * 64 * kSpanRow : 0;  // dO hi or lo
  static constexpr int kProducerThreads = 256;  // two producer warpgroups split
  static constexpr int kThreads = 128 * NW + kProducerThreads;
  // registers a thread (setmaxnreg): the consumers hold the A fragments (2 DP with two
  // warpgroups, DP with one), dQ (DP / 2), S and dP (KEYS) or dS's fragments (KEYS);
  // the producers take the rest of the launch allocation (FwdCfg)
  static constexpr int kConsumerRegs = NW == 1 ? 232 : DP <= 32 ? 184 : 200;
  static constexpr int kProducerRegs =
      (kThreads * (65536 / kThreads / 8 * 8) - 128 * NW * kConsumerRegs) / kProducerThreads /
      8 * 8;
  static constexpr size_t kSmem = 1024 + (size_t)RAW * kRawStage + (size_t)DER * kDerStage +
                                  2 * (size_t)kDoTile + 8 * (RAW + 2 * DER);
  static_assert(DP % 8 == 0 && DP <= 80, "the backward covers head dims up to 80");
  static_assert(KEYS % kSpan == 0 && (NW == 1 || NW == 2), "dQ tile shape");
  static_assert(kProducerRegs >= 56, "the producers' batched copies need 56 registers");
  static_assert(kSmem <= 232448, "a block has 227 KB of shared memory");
};

constexpr int kDqConsumerBar = 2;  // named barrier of the dQ kernel's one consumer warpgroup

// Rows [r0, r0 + 64) of a head (row stride sl) split into hi and lo tiles laid out as
// TMA lays out a raw tile (SPANS spans of 64 rows, 128-byte swizzled); zeros past L and
// past D; 16-byte units at or past column COLS are skipped (no k-step reads them). NT
// threads, this one tid.
template <int SPANS, int COLS, int NT>
__device__ __forceinline__ void split_rows(const float* src, long long sl, int r0, int L, int D,
                                           unsigned char* hi, unsigned char* lo, int tid) {
#pragma unroll 1
  for (int u = tid; u < SPANS * 64 * 8; u += NT) {
    const int s = u / (64 * 8), r = (u / 8) % 64, c = (u % 8) * 4, col = s * kSpan + c;
    if (col >= COLS) continue;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < L && col < D) x = *reinterpret_cast<const float4*>(src + (r0 + r) * sl + col);
    uint4 h, l;
    split4(x, h, l);
    const int off = s * (64 * kSpanRow) + sw128(r, c);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

template <int DP, int NW, int KEYS, int RAW, int DER>
__global__ void __launch_bounds__(DqCfg<DP, NW, KEYS, RAW, DER>::kThreads, 1)
    flash_bwd_dq_3xtf32_kernel(const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv, const BwdParams p) {
  using C = DqCfg<DP, NW, KEYS, RAW, DER>;
  constexpr int kKSpan = KEYS * kSpanRow;  // bytes of one span of a K or V tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* raw = base;                              // RAW x (K, V)
  unsigned char* der = raw + (size_t)RAW * C::kRawStage;  // DER x (K, V, K^T: hi, lo)
  unsigned char* do_hi = der + (size_t)DER * C::kDerStage;
  unsigned char* do_lo = do_hi + C::kDoTile;
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(do_lo + C::kDoTile);
  uint64_t* der_full = raw_full + RAW;
  uint64_t* der_empty = der_full + DER;

  const int q_tiles = (p.Lq + C::kRows - 1) / C::kRows;
  const int qt = blockIdx.x % q_tiles, bh = blockIdx.x / q_tiles;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = qt * C::kRows;
  const int n_tiles = (p.Lk + KEYS - 1) / KEYS;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < RAW; ++s) mbar_init(&raw_full[s], 1);
    for (int s = 0; s < DER; ++s) {
      mbar_init(&der_full[s], 1);
      mbar_init(&der_empty[s], 4 * NW);  // the consumer warps
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * NW) {
    // ---------------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs));
    const int tid = threadIdx.x - 128 * NW;
    constexpr int NT = C::kProducerThreads;
    auto issue = [&](int j) {
      const int s = j % RAW;
      unsigned char* ks = raw + (size_t)s * C::kRawStage;
      mbar_expect_tx(&raw_full[s], C::kRawStage);
      for (int c = 0; c < C::kSpans; ++c) {
        tma_load_4d(ks + c * kKSpan, &tk, &raw_full[s], c * kSpan, h, j * KEYS, b);
        tma_load_4d(ks + C::kTile + c * kKSpan, &tv, &raw_full[s], c * kSpan, h, j * KEYS, b);
      }
    };
    if (tid == 0)
      for (int j = 0; j < RAW && j < n_tiles; ++j) issue(j);
    for (int j = 0; j < n_tiles; ++j) {
      const int rs = j % RAW, ds = j % DER;
      mbar_wait(&raw_full[rs], (j / RAW) & 1);
      mbar_wait(&der_empty[ds], ((j / DER) & 1) ^ 1);
      const unsigned char* ks = raw + (size_t)rs * C::kRawStage;
      unsigned char* d = der + (size_t)ds * C::kDerStage;
      split_tile<KEYS, C::kSpans, DP, NT>(ks, d, d + C::kTile, tid);
      split_tile<KEYS, C::kSpans, DP, NT>(ks + C::kTile, d + 2 * C::kTile, d + 3 * C::kTile,
                                          tid);
      transpose_split<KEYS, DP, NT>(ks, d + 4 * C::kTile, d + 4 * C::kTile + C::kKT, tid);
      fence_async_shared();
      named_sync(kProducerBar, NT);  // raw stage read, derived one written
      if (tid == 0) {
        mbar_arrive(&der_full[ds]);
        if (j + RAW < n_tiles) issue(j + RAW);
      }
    }
    return;
  }

  // ------------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));
  const int wg = warp / 4, wl = warp % 4;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = q0 + wg * 64 + wl * 16 + g;  // this thread's rows r0 and r0 + 8

  // Q's hi and lo A fragments, and dO's (with one warpgroup: dO's hi and lo tiles in
  // shared memory), zeros past Lq and past D
  const float* qg = static_cast<const float*>(p.q.base) + b * p.q.sb + h * p.q.sh;
  const float* dog = static_cast<const float*>(p.dout.base) + b * p.dout.sb + h * p.dout.sh;
  uint32_t qh[DP / 8][4], ql[DP / 8][4], oh[DP / 8][4], ol[DP / 8][4];
  load_a_tf32<DP>(qh, ql, qg, p.q.sl, r0, p.Lq, p.D, t4);
  if constexpr (C::kDoSmem) {
    split_rows<C::kSpans, DP, 128>(dog, p.dout.sl, q0, p.Lq, p.D, do_hi, do_lo, threadIdx.x);
    fence_async_shared();
    named_sync(kDqConsumerBar, 128);
  } else {
    load_a_tf32<DP>(oh, ol, dog, p.dout.sl, r0, p.Lq, p.D, t4);
  }

  // the rows' LSE * log2(e) (K5: m + log l) and Dcap, 0 past Lq (never stored)
  float lse2[2], dc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    const size_t row = (size_t)bh * p.Lq + r;
    lse2[i] = dc[i] = 0.f;
    if (r < p.Lq) {
      lse2[i] = (p.l == nullptr ? p.lse[row] : p.lse[row] + logf(p.l[row])) * kLog2e;
      dc[i] = p.dcap[row];
    }
  }

  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int ds = j % DER;
    mbar_wait(&der_full[ds], (j / DER) & 1);
    const unsigned char* k_hi = der + (size_t)ds * C::kDerStage;
    const unsigned char* k_lo = k_hi + C::kTile;
    const unsigned char* v_hi = k_lo + C::kTile;
    const unsigned char* v_lo = v_hi + C::kTile;
    const unsigned char* kt_hi = v_lo + C::kTile;
    const unsigned char* kt_lo = kt_hi + C::kKT;

    // S = Q K^T and dP = dO V^T: 64 queries x KEYS keys each, unscaled
    float s[KEYS / 2], dp[KEYS / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk)
      rs_3xtf32<KEYS>(s, qh[kk], ql[kk], kdesc(k_hi, kk, kKSpan), kdesc(k_lo, kk, kKSpan),
                      kk > 0);
    wgmma_commit();
    if constexpr (C::kDoSmem) {
      ss_3xtf32<KEYS>(dp, do_hi, do_lo, 64 * kSpanRow, v_hi, v_lo, kKSpan, DP / 8, true);
    } else {
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk)
        rs_3xtf32<KEYS>(dp, oh[kk], ol[kk], kdesc(v_hi, kk, kKSpan), kdesc(v_lo, kk, kKSpan),
                        kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs<KEYS / 2>(s);

    // P = 2^(S * scale * log2(e) - LSE * log2(e)) by query row; 0 for keys at or past
    // Lk (there S is 0, from TMA's zero fill, and P would not be)
#pragma unroll
    for (int i = 0; i < KEYS / 2; ++i) s[i] = ex2(fmaf(s[i], p.scale_log2, -lse2[(i >> 1) & 1]));
    const int key0 = j * KEYS;
    if (key0 + KEYS > p.Lk) {  // the ragged tail
#pragma unroll
      for (int i = 0; i < KEYS / 2; ++i)
        if (key0 + (i / 4) * 8 + t4 * 2 + (i & 1) >= p.Lk) s[i] = 0.f;
    }
    wgmma_wait<0>();
    fence_regs<KEYS / 2>(dp);

    // dS = P (dP - Dcap), by query row
#pragma unroll
    for (int i = 0; i < KEYS / 2; ++i) dp[i] = s[i] * (dp[i] - dc[(i >> 1) & 1]);

    // dQ += dS K over the tile's keys: dS split in registers a k-step at a time, K^T
    // from the derived stage
    uint32_t dh[KEYS / 8][4], dl[KEYS / 8][4];
#pragma unroll
    for (int t = 0; t < KEYS / 8; ++t) acc_to_a_tf32(dh[t], dl[t], dp, t);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < KEYS / 8; ++t)
      rs_3xtf32<DP>(dq, dh[t], dl[t], kdesc(kt_hi, t, DP * kSpanRow),
                    kdesc(kt_lo, t, DP * kSpanRow), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DP / 2>(dq);
    fence_regs<KEYS / 2>(&dh[0][0]);
    fence_regs<KEYS / 2>(&dl[0][0]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&der_empty[ds]);
  }

  // ------------------------------------------------------------------ epilogue
  store_acc_f32<DP>(p.out0 + b * p.sb + h * p.sh, p.sl, dq, p.scale, p.scale, r0, p.Lq, 0,
                    p.D, t4);
}

// ---------------------------------------------------------------- backward, D 88-160

// Heads wider than 80 (SD1.5's level-2 160; 96 and 128, which jax's stock kernel takes)
// are zero filled to 160, five spans, and run on their own instances of both backward
// kernels. The D <= 80 design keeps its stationary operands (K and V, or Q and dO)
// split into hi and lo in shared memory, and 64 rows of 160 split that way take 160 KB
// before one streamed tile. But those four are the A operands of their products (K of S^T
// = K Q^T, V of dP^T = V dO^T; Q of S = Q K^T, dO of dP = dO V^T), and tf32 wgmma takes A
// from registers. So each consumer warpgroup takes one stationary operand and holds its
// raw fragments in registers for the whole block (80 a thread, loaded once from the TMA
// tile), splitting them a k-step at a time into a ring of two register sets just before
// that step's three wgmma (reg_products): hi and lo of all 20 k-steps would take 160.
// With an accumulator of 64 x 160 (80 registers) beside them, a consumer takes 208 and
// the producer warpgroup 88. The warpgroups exchange P (or P^T) through shared memory,
// two tiles deep (one named barrier a tile). Once both hold their fragments (kv_held,
// qo_held), the stationary tiles' 80 KB become the second stage of the derived buffer,
// so that the producer splits tile j + 1 while the consumers multiply tile j.
// Streamed tiles are 16 rows: at 32, two stages of the derived buffer would not fit.
// The producer splits a raw stage's two tensors as one tile of ten spans (split_tile)
// and transposes them by whole columns (transpose_split16). A 16-token row of a
// transposed tile (Q^T, dO^T, K^T: the B operands of dK, dV and dQ, tokens contiguous)
// is 64 bytes, half a 128-byte span, which desc_sw128 cannot describe; those tiles are
// laid out and read in wgmma's 64-byte swizzle mode instead (sw64, kdesc64: rows of 64
// bytes, 8-row atoms of 512 bytes), which keeps both the transpose's 16-byte stores and
// the tensor core's reads free of bank conflicts. Products run at wgmma N 16 (S^T, dP^T,
// S, dP: 20 k-steps) or N 160 (dK, dV, dQ: 2 k-steps), three wgmma a k-step.
//   * dK/dV (flash_bwd_dkv_d160_3xtf32_kernel): 64 keys a block. Warpgroup 0 holds K:
//     S^T, P^T (by query column: 0 at or past Lq) and dV += P^T dO; warpgroup 1 holds V:
//     dP^T, dS^T = P^T (dP^T - Dcap) with P^T from warpgroup 0, and dK += dS^T Q. Each
//     accumulates one output in 80 registers, as the bf16 DS 160 instance does
//     (flash_attn_bwd.cu), and neither forms S^T twice. 16-query tiles of Q and dO come
//     through 2 raw stages; the derived buffer is in two parts released apart, as at D
//     <= 80: A (Q, dO hi and lo, beside the tile's LSE (K5: m + log l) and Dcap rows),
//     which S^T and dP^T read, and B (Q^T, dO^T hi and lo), which dV and dK read.
//     Shared memory: K and V (then stage 1 of A and B) 80 KB, raw stages 40 KB, stage 0
//     of A and B 80 KB, the exchange 8 KB: 209 KB.
//   * dQ (flash_bwd_dq_d160_3xtf32_kernel): 64 queries a block, each thread with its two
//     rows' LSE (K5: m + log l) and Dcap in registers. Warpgroup 0 holds Q: S, P (0 for
//     keys at or past Lk); warpgroup 1 holds dO: dP, dS = P (dP - Dcap) with P from
//     warpgroup 0, and dQ += dS K. The ring carries raw 16-key tiles of K and V (3
//     stages); a derived stage holds K hi, lo (B of S = Q K^T), V hi, lo (B of dP = dO
//     V^T) and K^T hi, lo (B of dQ += dS K). Shared memory: Q and dO (then derived stage
//     1) 80 KB, raw stages 60 KB, derived stage 0 60 KB, the exchange 8 KB: 209 KB.

constexpr int kWideDP = 160;                       // the head, zero filled past D
constexpr int kWideSpans = kWideDP / kSpan;        // 5
constexpr int kWideRows = 64;                      // stationary rows a block
constexpr int kWideTile = 16;                      // streamed rows a tile
constexpr int kWideRing = 2;  // register sets of the stationary fragments (3 spilled)
constexpr int kStatSpan = kWideRows * kSpanRow;    // 8 KB: one span of a stationary tile
constexpr int kStatTile = kWideSpans * kStatSpan;  // 40 KB: 64 rows of 160, raw
constexpr int kRowSpan = kWideTile * kSpanRow;     // 2 KB: one span of a streamed tile
constexpr int kRowTile = kWideSpans * kRowSpan;    // 10 KB: 16 rows of 160 (raw, hi or lo)
constexpr int kColRow = kWideTile * 4;             // 64 bytes: a row of a transposed tile
constexpr int kColTile = kWideDP * kColRow;        // 10 KB: 160 rows of 16 tokens, hi or lo

// The raw A fragment of k-step kk of a 64-row stationary tile as TMA writes it (spans of
// 64 rows, kStatSpan apart): rows r and r + 8 at columns 8 kk + t4 and + 4, in
// load_a_tf32's order.
__device__ __forceinline__ void stat_a_raw(float* x, const unsigned char* tile, int r, int kk,
                                           int t4) {
  const unsigned char* s = tile + (kk >> 2) * kStatSpan;
  const int c = (kk & 3) * 8 + t4;
  x[0] = *reinterpret_cast<const float*>(s + sw128(r, c));
  x[1] = *reinterpret_cast<const float*>(s + sw128(r + 8, c));
  x[2] = *reinterpret_cast<const float*>(s + sw128(r, c + 4));
  x[3] = *reinterpret_cast<const float*>(s + sw128(r + 8, c + 4));
}

__device__ __forceinline__ void split_a(uint32_t* hi, uint32_t* lo, const float* x) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(x[e], hi[e], lo[e]);
}

// acc (64 x 160) += A B over a 16-token tile: A (P^T, dS^T or dS, 64 x 16) split from
// the accumulator x in registers, B's hi and lo the transposed tiles (kdesc64).
__device__ __forceinline__ void col_products(float* acc, const float* x, const unsigned char* b_hi,
                                             const unsigned char* b_lo) {
  uint32_t ah[kWideTile / 8][4], al[kWideTile / 8][4];
#pragma unroll
  for (int t = 0; t < kWideTile / 8; ++t) acc_to_a_tf32(ah[t], al[t], x, t);
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < kWideTile / 8; ++t)
    rs_3xtf32<kWideDP>(acc, ah[t], al[t], kdesc64(b_hi, t), kdesc64(b_lo, t), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<kWideDP / 2>(acc);
  fence_regs<kWideTile / 2>(&ah[0][0]);
  fence_regs<kWideTile / 2>(&al[0][0]);
}

// d = A B^T (64 x 16, unscaled) over the head's 20 k-steps: A's raw fragments held in
// registers (x, this thread's rows of a stationary tile, loaded once a block) and split
// a k-step at a time into a ring of kWideRing register sets, each set written once the
// group that last read it is done; B's hi and lo from a streamed tile's derived spans (16 rows,
// kRowSpan apart). Each k-step's three products are one commit group.
__device__ __forceinline__ void reg_products(float* d, float (&x)[kWideDP / 8][4],
                                             const unsigned char* b_hi,
                                             const unsigned char* b_lo) {
  constexpr int kSteps = kWideDP / 8, R = kWideRing;
  uint32_t ah[R][4], al[R][4];
  split_a(ah[0], al[0], x[0]);
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const int c = kk % R, n = (kk + 1) % R;
    wgmma_fence();
    rs_3xtf32<kWideTile>(d, ah[c], al[c], kdesc(b_hi, kk, kRowSpan), kdesc(b_lo, kk, kRowSpan),
                         kk > 0);
    wgmma_commit();
    if (kk + 1 < kSteps) {
      wgmma_wait<R - 1>();  // the group of step kk + 1 - R, set n's reader
      fence_regs<4>(ah[n]);
      fence_regs<4>(al[n]);
      fence_regs<4>(x[kk + 1]);  // else the compiler splits every step up front
      split_a(ah[n], al[n], x[kk + 1]);
    }
  }
  wgmma_wait<0>();
  fence_regs<kWideTile / 2>(d);
  fence_regs<4 * R>(&ah[0][0]);
  fence_regs<4 * R>(&al[0][0]);
}

// dK/dV at D 88-160: 64 keys a block (kKeys), 16-query tiles (kQueries) through kRaw raw
// stages of Q and dO, and two stages of each part of the derived buffer, A (Q, dO hi and
// lo) and B (Q^T, dO^T hi and lo): stage 0 of each has its own room, stage 1 takes K's
// (A) and V's (B) once the consumers hold them in registers. Byte offsets from the
// block's 1024-byte aligned base (constants, so that the consumers address all of it
// from one register).
struct DkvWide {
  static constexpr int kKeys = kWideRows, kQueries = kWideTile, kRaw = 2;
  static constexpr int kRawStage = 2 * kRowTile;
  static constexpr int kDerA = 4 * kRowTile;  // = kStatTile: stage 1 is K's room
  static constexpr int kDerB = 4 * kColTile;  // = kStatTile: stage 1 is V's room
  static constexpr int kExchange = 128 * (kWideTile / 2) * 4;  // a warpgroup's P^T tile
  static constexpr int kOffK = 0, kOffV = kStatTile, kOffRaw = 2 * kStatTile;
  static constexpr int kOffA0 = kOffRaw + kRaw * kRawStage, kOffB0 = kOffA0 + kDerA;
  static constexpr int kOffXch = kOffB0 + kDerB;        // P^T, two tiles
  static constexpr int kOffRows = kOffXch + 2 * kExchange;  // per stage: LSE * log2(e), Dcap
  static constexpr int kOffBars = kOffRows + 2 * 2 * kWideTile * 4;
  static constexpr size_t kSmem = 1024 + kOffBars + 8 * (kRaw + 10);  // DkvBars
  static constexpr int kThreads = 384;  // two consumer warpgroups and a producer warpgroup
  static constexpr int kConsumerRegs = 208;
  static constexpr int kProducerRegs =  // within the launch allocation (FwdCfg)
      (kThreads * (65536 / kThreads / 8 * 8) - 256 * kConsumerRegs) / 128 / 8 * 8;
  static_assert(kDerA == kStatTile && kDerB == kStatTile, "stage 1 fills K's and V's rooms");
  static_assert(kProducerRegs >= 56, "the producer's batched copies need 56 registers");
  static_assert(kSmem <= 232448, "a block has 227 KB of shared memory");
};

// The barriers of the D 160 dK/dV kernel: raw_full of the raw stages; by stage of the
// derived buffer a_full, a_empty (part A), b_full, b_empty (part B); kv_full (K and V
// in), kv_held (the consumers hold them in registers: stage 1 may overwrite them).
struct DkvBars {
  uint64_t raw_full[DkvWide::kRaw], a_full[2], a_empty[2], b_full[2], b_empty[2];
  uint64_t kv_full, kv_held;
};

static_assert(sizeof(DkvBars) == 8 * (DkvWide::kRaw + 10), "DkvWide::kSmem counts them");

constexpr int kWideExchangeBar = 2;  // named barrier of the two consumer warpgroups (P)

// One consumer warpgroup of the D 160 dK/dV kernel, its stationary operand's raw
// fragments (K with DV, else V) in registers. With DV: S^T = K Q^T, P^T (into the
// exchange buffer of the tile's parity), dV += P^T dO; else dP^T = V dO^T, P^T from
// the exchange, dS^T = P^T (dP^T - Dcap), dK += dS^T Q (scaled at the store). Rows r and
// r + 8 of the block's 64 keys; wtid this thread's index in its warpgroup.
template <bool DV>
__device__ __forceinline__ void dkv_wide_consumer(const BwdParams& p, unsigned char* base,
                                                  int n_q, int key0, long long head, int r,
                                                  int wtid, int lane) {
  using C = DkvWide;
  constexpr int kQ = kWideTile;
  const int t4 = lane & 3;
  DkvBars* bars = reinterpret_cast<DkvBars*>(base + C::kOffBars);
  float acc[kWideDP / 2];  // dV or dK
#pragma unroll
  for (int i = 0; i < kWideDP / 2; ++i) acc[i] = 0.f;

  mbar_wait(&bars->kv_full, 0);
  float x[kWideDP / 8][4];  // K's or V's raw fragments, every k-step
#pragma unroll
  for (int kk = 0; kk < kWideDP / 8; ++kk)
    stat_a_raw(x[kk], base + (DV ? C::kOffK : C::kOffV), r, kk, t4);
  __syncwarp();
  if (lane == 0) mbar_arrive(&bars->kv_held);

  for (int j = 0; j < n_q; ++j) {
    const int s = j & 1, phase = (j >> 1) & 1;
    const unsigned char* a = base + (s ? C::kOffK : C::kOffA0);  // Q hi, dO hi, Q lo, dO lo
    const float* rs = reinterpret_cast<const float*>(base + C::kOffRows) + s * 2 * kQ;
    float* pt = reinterpret_cast<float*>(base + C::kOffXch) + s * (128 * kQ / 2);
    mbar_wait(&bars->a_full[s], phase);

    // S^T = K Q^T (dV) or dP^T = V dO^T (dK): 64 keys x 16 queries, unscaled
    float st[kQ / 2];
    if constexpr (DV) reg_products(st, x, a, a + 2 * kRowTile);
    else reg_products(st, x, a + kRowTile, a + 3 * kRowTile);

    const int q0 = j * kQ;
    if constexpr (DV) {
      // P^T = exp(S^T * scale - LSE) by query column; 0 for queries at or past Lq
#pragma unroll
      for (int n = 0; n < kQ / 8; ++n) {
        const int col = n * 8 + t4 * 2;
        const float2 ls = *reinterpret_cast<const float2*>(rs + col);
        const bool ok0 = q0 + col < p.Lq, ok1 = q0 + col + 1 < p.Lq;
        st[4 * n] = ok0 ? ex2(fmaf(st[4 * n], p.scale_log2, -ls.x)) : 0.f;
        st[4 * n + 1] = ok1 ? ex2(fmaf(st[4 * n + 1], p.scale_log2, -ls.y)) : 0.f;
        st[4 * n + 2] = ok0 ? ex2(fmaf(st[4 * n + 2], p.scale_log2, -ls.x)) : 0.f;
        st[4 * n + 3] = ok1 ? ex2(fmaf(st[4 * n + 3], p.scale_log2, -ls.y)) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kQ / 2; ++i) pt[i * 128 + wtid] = st[i];
      named_sync(kWideExchangeBar, 256);  // P^T is in
    } else {
      // dS^T = P^T * (dP^T - Dcap), by query column
      named_sync(kWideExchangeBar, 256);
#pragma unroll
      for (int n = 0; n < kQ / 8; ++n) {
        const float2 dc = *reinterpret_cast<const float2*>(rs + kQ + n * 8 + t4 * 2);
        st[4 * n] = pt[(4 * n) * 128 + wtid] * (st[4 * n] - dc.x);
        st[4 * n + 1] = pt[(4 * n + 1) * 128 + wtid] * (st[4 * n + 1] - dc.y);
        st[4 * n + 2] = pt[(4 * n + 2) * 128 + wtid] * (st[4 * n + 2] - dc.x);
        st[4 * n + 3] = pt[(4 * n + 3) * 128 + wtid] * (st[4 * n + 3] - dc.y);
      }
    }
    __syncwarp();  // this warp's products and row reads of part A are done
    if (lane == 0) mbar_arrive(&bars->a_empty[s]);

    // dV += P^T dO or dK += dS^T Q over the tile's 16 queries: dO^T or Q^T of part B
    // (Q^T hi, dO^T hi, Q^T lo, dO^T lo)
    const unsigned char* bt = base + (s ? C::kOffV : C::kOffB0) + (DV ? kColTile : 0);
    mbar_wait(&bars->b_full[s], phase);
    col_products(acc, st, bt, bt + 2 * kColTile);
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars->b_empty[s]);
  }

  // ------------------------------------------------------------------ epilogue
  if constexpr (DV) store_acc_f32<kWideDP>(p.out1 + head, p.sl, acc, 1.f, 1.f, key0 + r, p.Lk, 0,
                                           p.D, t4);
  else store_acc_f32<kWideDP>(p.out0 + head, p.sl, acc, p.scale, p.scale, key0 + r, p.Lk, 0,
                              p.D, t4);
}

__global__ void __launch_bounds__(DkvWide::kThreads, 1)
    flash_bwd_dkv_d160_3xtf32_kernel(const __grid_constant__ CUtensorMap tq,
                                     const __grid_constant__ CUtensorMap tdo,
                                     const __grid_constant__ CUtensorMap tk,
                                     const __grid_constant__ CUtensorMap tv, const BwdParams p) {
  using C = DkvWide;
  constexpr int kQ = kWideTile;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  DkvBars* bars = reinterpret_cast<DkvBars*>(base + C::kOffBars);

  const int k_tiles = (p.Lk + C::kKeys - 1) / C::kKeys;
  const int kt = blockIdx.x % k_tiles, bh = blockIdx.x / k_tiles;
  const int b = bh / p.H, h = bh % p.H;
  const int key0 = kt * C::kKeys;
  const int n_q = (p.Lq + kQ - 1) / kQ;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kRaw; ++s) mbar_init(&bars->raw_full[s], 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&bars->a_full[s], 1);
      mbar_init(&bars->a_empty[s], 8);  // the consumer warps
      mbar_init(&bars->b_full[s], 1);
      mbar_init(&bars->b_empty[s], 8);
    }
    mbar_init(&bars->kv_full, 1);
    mbar_init(&bars->kv_held, 8);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    // ---------------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs));
    const int tid = threadIdx.x - 256;
    unsigned char* raw = base + C::kOffRaw;  // kRaw x (Q, dO)
    float* rows = reinterpret_cast<float*>(base + C::kOffRows);
    auto issue = [&](int j) {
      const int s = j % C::kRaw;
      unsigned char* qs = raw + (size_t)s * C::kRawStage;
      uint64_t* full = &bars->raw_full[s];
      mbar_expect_tx(full, C::kRawStage);
      for (int c = 0; c < kWideSpans; ++c) {
        tma_load_4d(qs + c * kRowSpan, &tq, full, c * kSpan, h, j * kQ, b);
        tma_load_4d(qs + kRowTile + c * kRowSpan, &tdo, full, c * kSpan, h, j * kQ, b);
      }
    };
    if (tid == 0) {
      mbar_expect_tx(&bars->kv_full, 2 * kStatTile);
      for (int c = 0; c < kWideSpans; ++c) {
        tma_load_4d(base + C::kOffK + c * kStatSpan, &tk, &bars->kv_full, c * kSpan, h, key0, b);
        tma_load_4d(base + C::kOffV + c * kStatSpan, &tv, &bars->kv_full, c * kSpan, h, key0, b);
      }
      for (int j = 0; j < C::kRaw && j < n_q; ++j) issue(j);
    }

    const size_t row0 = (size_t)bh * p.Lq;
    for (int j = 0; j < n_q; ++j) {
      const int rs = j % C::kRaw, s = j & 1, phase = ((j >> 1) & 1) ^ 1;
      unsigned char* a = base + (s ? C::kOffK : C::kOffA0);  // stage 1: K's and V's rooms
      unsigned char* bt = base + (s ? C::kOffV : C::kOffB0);
      mbar_wait(&bars->raw_full[rs], (j / C::kRaw) & 1);
      if (j == 1) mbar_wait(&bars->kv_held, 0);
      mbar_wait(&bars->a_empty[s], phase);
      const unsigned char* qs = raw + (size_t)rs * C::kRawStage;
      // Q and dO, the raw stage's ten spans as one tile: hi and lo 20 KB apart
      split_tile<kQ, 2 * kWideSpans, 2 * kWideDP, 128>(qs, a, a + 2 * kRowTile, tid);
      if (tid < kQ) {  // 0 past Lq: those queries are masked by index
        const int q = j * kQ + tid;
        float lse2 = 0.f, dc = 0.f;
        if (q < p.Lq) {
          const size_t r = row0 + q;
          lse2 = (p.l == nullptr ? p.lse[r] : p.lse[r] + logf(p.l[r])) * kLog2e;
          dc = p.dcap[r];
        }
        rows[s * 2 * kQ + tid] = lse2;
        rows[s * 2 * kQ + kQ + tid] = dc;
      }
      fence_async_shared();
      named_sync(kProducerBar, 128);
      if (tid == 0) mbar_arrive(&bars->a_full[s]);
      mbar_wait(&bars->b_empty[s], phase);
      // Q^T and dO^T: 320 rows, Q's columns then dO's
      transpose_split16<2 * kWideDP, 128>(qs, bt, bt + 2 * kColTile, tid);
      fence_async_shared();
      named_sync(kProducerBar, 128);  // the raw stage is read: it takes the next copy
      if (tid == 0) {
        mbar_arrive(&bars->b_full[s]);
        if (j + C::kRaw < n_q) issue(j + C::kRaw);
      }
    }
    return;
  }

  // ------------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));
  const int r = (warp % 4) * 16 + (lane >> 2);  // this thread's keys r and r + 8 of the 64
  const long long head = b * p.sb + h * p.sh;
  if (warp < 4)
    dkv_wide_consumer<true>(p, base, n_q, key0, head, r, threadIdx.x % 128, lane);
  else
    dkv_wide_consumer<false>(p, base, n_q, key0, head, r, threadIdx.x % 128, lane);
}

// dQ at D 88-160: 64 queries a block (kRows), 16-key tiles (kKeys) through kRaw raw
// stages of K and V, and two derived stages (K hi, V hi, K lo, V lo, K^T hi, K^T lo):
// stage 0 has its own room, stage 1 takes Q's and dO's once the consumers hold them in
// registers. Byte offsets from the block's 1024-byte aligned base, as in DkvWide.
struct DqWide {
  static constexpr int kRows = kWideRows, kKeys = kWideTile, kRaw = 3;
  static constexpr int kRawStage = 2 * kRowTile;
  static constexpr int kDerStage = 4 * kRowTile + 2 * kColTile;
  static constexpr int kExchange = 128 * (kWideTile / 2) * 4;  // a warpgroup's P tile
  static constexpr int kOffQ = 0, kOffDO = kStatTile, kOffRaw = 2 * kStatTile;
  static constexpr int kOffD0 = kOffRaw + kRaw * kRawStage;
  static constexpr int kOffXch = kOffD0 + kDerStage;  // P, two tiles
  static constexpr int kOffBars = kOffXch + 2 * kExchange;
  static constexpr size_t kSmem = 1024 + kOffBars + 8 * (kRaw + 6);  // DqBars
  static constexpr int kThreads = 384;  // two consumer warpgroups and a producer warpgroup
  static constexpr int kConsumerRegs = DkvWide::kConsumerRegs;
  static constexpr int kProducerRegs = DkvWide::kProducerRegs;
  static_assert(kDerStage <= 2 * kStatTile, "stage 1 fits in Q's and dO's rooms");
  static_assert(kSmem <= 232448, "a block has 227 KB of shared memory");
};

// The barriers of the D 160 dQ kernel: raw_full of the raw stages; der_full and
// der_empty of the derived stages; qo_full (Q and dO in), qo_held (the consumers hold
// them in registers: stage 1 may overwrite them).
struct DqBars {
  uint64_t raw_full[DqWide::kRaw], der_full[2], der_empty[2], qo_full, qo_held;
};

static_assert(sizeof(DqBars) == 8 * (DqWide::kRaw + 6), "DqWide::kSmem counts them");

// One consumer warpgroup of the D 160 dQ kernel, its stationary operand's raw fragments
// (Q, else with DQ dO) in registers. Warpgroup 0: S = Q K^T, P = exp(S * scale - LSE)
// (into the exchange buffer of the tile's parity); with DQ: dP = dO V^T, P from the
// exchange, dS = P (dP - Dcap), dQ += dS K (scaled at the store). Rows r and r + 8 of
// the block's 64 queries (q0 + r the first); wtid this thread's index in its warpgroup.
template <bool DQ>
__device__ __forceinline__ void dq_wide_consumer(const BwdParams& p, unsigned char* base,
                                                 int n_tiles, int q0, int bh, long long head,
                                                 int r, int wtid, int lane) {
  using C = DqWide;
  constexpr int kK = kWideTile;
  const int t4 = lane & 3, r0 = q0 + r;
  DqBars* bars = reinterpret_cast<DqBars*>(base + C::kOffBars);

  // the rows' LSE * log2(e) (K5: m + log l) and Dcap, 0 past Lq (never stored)
  float lse2[2], dc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t row = (size_t)bh * p.Lq + r0 + 8 * i;
    lse2[i] = dc[i] = 0.f;
    if (r0 + 8 * i < p.Lq) {
      lse2[i] = (p.l == nullptr ? p.lse[row] : p.lse[row] + logf(p.l[row])) * kLog2e;
      dc[i] = p.dcap[row];
    }
  }
  float dq[DQ ? kWideDP / 2 : 1];
#pragma unroll
  for (int i = 0; i < (DQ ? kWideDP / 2 : 1); ++i) dq[i] = 0.f;

  mbar_wait(&bars->qo_full, 0);
  float x[kWideDP / 8][4];  // Q's or dO's raw fragments, every k-step
#pragma unroll
  for (int kk = 0; kk < kWideDP / 8; ++kk)
    stat_a_raw(x[kk], base + (DQ ? C::kOffDO : C::kOffQ), r, kk, t4);
  __syncwarp();
  if (lane == 0) mbar_arrive(&bars->qo_held);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j & 1;
    const unsigned char* d = base + (s ? C::kOffQ : C::kOffD0);  // K, V hi; K, V lo; K^T
    float* pt = reinterpret_cast<float*>(base + C::kOffXch) + s * (128 * kK / 2);
    mbar_wait(&bars->der_full[s], (j >> 1) & 1);

    float sc[kK / 2];  // S, or with DQ dP: 64 queries x 16 keys, unscaled
    if constexpr (!DQ) {
      reg_products(sc, x, d, d + 2 * kRowTile);
      // P = 2^(S * scale * log2(e) - LSE * log2(e)) by query row, 0 for keys at or past
      // Lk (there S is 0, from TMA's zero fill, and P would not be)
      const int key0 = j * kK;
#pragma unroll
      for (int i = 0; i < kK / 2; ++i) {
        const bool ok = key0 + (i / 4) * 8 + t4 * 2 + (i & 1) < p.Lk;
        pt[i * 128 + wtid] = ok ? ex2(fmaf(sc[i], p.scale_log2, -lse2[(i >> 1) & 1])) : 0.f;
      }
      named_sync(kWideExchangeBar, 256);  // P is in
    } else {
      reg_products(sc, x, d + kRowTile, d + 3 * kRowTile);
      named_sync(kWideExchangeBar, 256);
      // dS = P (dP - Dcap), by query row; dQ += dS K over the tile's 16 keys
#pragma unroll
      for (int i = 0; i < kK / 2; ++i) sc[i] = pt[i * 128 + wtid] * (sc[i] - dc[(i >> 1) & 1]);
      col_products(dq, sc, d + 4 * kRowTile, d + 4 * kRowTile + kColTile);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars->der_empty[s]);
  }

  // ------------------------------------------------------------------ epilogue
  if constexpr (DQ)
    store_acc_f32<kWideDP>(p.out0 + head, p.sl, dq, p.scale, p.scale, r0, p.Lq, 0, p.D, t4);
}

__global__ void __launch_bounds__(DqWide::kThreads, 1)
    flash_bwd_dq_d160_3xtf32_kernel(const __grid_constant__ CUtensorMap tq,
                                    const __grid_constant__ CUtensorMap tdo,
                                    const __grid_constant__ CUtensorMap tk,
                                    const __grid_constant__ CUtensorMap tv, const BwdParams p) {
  using C = DqWide;
  constexpr int kK = kWideTile;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  DqBars* bars = reinterpret_cast<DqBars*>(base + C::kOffBars);

  const int q_tiles = (p.Lq + C::kRows - 1) / C::kRows;
  const int qt = blockIdx.x % q_tiles, bh = blockIdx.x / q_tiles;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = qt * C::kRows;
  const int n_tiles = (p.Lk + kK - 1) / kK;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kRaw; ++s) mbar_init(&bars->raw_full[s], 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&bars->der_full[s], 1);
      mbar_init(&bars->der_empty[s], 8);  // the consumer warps
    }
    mbar_init(&bars->qo_full, 1);
    mbar_init(&bars->qo_held, 8);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    // ---------------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs));
    const int tid = threadIdx.x - 256;
    unsigned char* raw = base + C::kOffRaw;  // kRaw x (K, V)
    auto issue = [&](int j) {
      const int s = j % C::kRaw;
      unsigned char* ks = raw + (size_t)s * C::kRawStage;
      uint64_t* full = &bars->raw_full[s];
      mbar_expect_tx(full, C::kRawStage);
      for (int c = 0; c < kWideSpans; ++c) {
        tma_load_4d(ks + c * kRowSpan, &tk, full, c * kSpan, h, j * kK, b);
        tma_load_4d(ks + kRowTile + c * kRowSpan, &tv, full, c * kSpan, h, j * kK, b);
      }
    };
    if (tid == 0) {
      mbar_expect_tx(&bars->qo_full, 2 * kStatTile);
      for (int c = 0; c < kWideSpans; ++c) {
        tma_load_4d(base + C::kOffQ + c * kStatSpan, &tq, &bars->qo_full, c * kSpan, h, q0, b);
        tma_load_4d(base + C::kOffDO + c * kStatSpan, &tdo, &bars->qo_full, c * kSpan, h, q0, b);
      }
      for (int j = 0; j < C::kRaw && j < n_tiles; ++j) issue(j);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int rs = j % C::kRaw, s = j & 1;
      unsigned char* d = base + (s ? C::kOffQ : C::kOffD0);  // stage 1: Q's and dO's rooms
      mbar_wait(&bars->raw_full[rs], (j / C::kRaw) & 1);
      if (j == 1) mbar_wait(&bars->qo_held, 0);
      mbar_wait(&bars->der_empty[s], ((j >> 1) & 1) ^ 1);
      const unsigned char* ks = raw + (size_t)rs * C::kRawStage;
      // K and V, the raw stage's ten spans as one tile: hi and lo 20 KB apart; then K^T
      split_tile<kK, 2 * kWideSpans, 2 * kWideDP, 128>(ks, d, d + 2 * kRowTile, tid);
      transpose_split16<kWideDP, 128>(ks, d + 4 * kRowTile, d + 4 * kRowTile + kColTile, tid);
      fence_async_shared();
      named_sync(kProducerBar, 128);  // raw stage read, derived one written
      if (tid == 0) {
        mbar_arrive(&bars->der_full[s]);
        if (j + C::kRaw < n_tiles) issue(j + C::kRaw);
      }
    }
    return;
  }

  // ------------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));
  const int r = (warp % 4) * 16 + (lane >> 2);  // this thread's rows r and r + 8 of the 64
  const long long head = b * p.sb + h * p.sh;
  if (warp < 4)
    dq_wide_consumer<false>(p, base, n_tiles, q0, bh, head, r, threadIdx.x % 128, lane);
  else
    dq_wide_consumer<true>(p, base, n_tiles, q0, bh, head, r, threadIdx.x % 128, lane);
}

// ---------------------------------------------------------------- launches

// Set the kernel's dynamic shared memory and launch it over `blocks` blocks.
template <class Kernel, class... Args>
cudaError_t run(Kernel kernel, long long blocks, int threads, size_t smem, cudaStream_t stream,
                const Args&... args) {
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// Forward instances by head dim: D rounded up to 8, 16, 32, 40, 64 or 80 in the narrow
// design, 88-160 and 168-512 in the wide one (zero filled to 160 or 512). f is called
// with the instance's Cfg.
template <class F>
cudaError_t with_fwd_cfg(int D, F&& f) {
  if (D < 8 || D % 8 != 0 || D > 512) return cudaErrorInvalidValue;
  if (D <= 8) return f(FwdCfg<8, 2, 2>{});
  if (D <= 16) return f(FwdCfg<16, 2, 2>{});
  if (D <= 32) return f(FwdCfg<32, 2, 2>{});
  if (D <= 40) return f(FwdCfg<40, 2, 2>{});
  if (D <= 64) return f(FwdCfg<64, 2, 2>{});
  if (D <= 80) return f(FwdCfg<80, 1, 2>{});
  if (D <= 160) return f(Wide160{});
  return f(Wide{});
}

// dK/dV instances: D rounded up as in the forward; two consumer warpgroups up to D 64,
// one (and one raw stage) at D 80, where two would not fit in shared memory; 88-160 the
// D 160 instance (DkvWide).
template <class F>
cudaError_t with_dkv_cfg(int D, F&& f) {
  if (D < 8 || D % 8 != 0 || D > kWideDP) return cudaErrorInvalidValue;
  if (D <= 8) return f(DkvCfg<8, 2, 2>{});
  if (D <= 16) return f(DkvCfg<16, 2, 2>{});
  if (D <= 32) return f(DkvCfg<32, 2, 2>{});
  if (D <= 40) return f(DkvCfg<40, 2, 2>{});
  if (D <= 64) return f(DkvCfg<64, 2, 2>{});
  if (D <= 80) return f(DkvCfg<80, 1, 1>{});
  return f(DkvWide{});
}

// dQ instances: D rounded up as in the forward. Up to D 40 two consumer warpgroups
// (128 queries) with Q and dO in registers and 64-key tiles; at D 64 and 80 one (64
// queries) with dO in shared memory and 32-key tiles: there the fragments would not fit
// in registers, nor 64-key stages beside dO in shared memory; 88-160 the D 160 instance
// (DqWide).
template <class F>
cudaError_t with_dq_cfg(int D, F&& f) {
  if (D < 8 || D % 8 != 0 || D > kWideDP) return cudaErrorInvalidValue;
  if (D <= 8) return f(DqCfg<8, 2, 64, 2, 3>{});
  if (D <= 16) return f(DqCfg<16, 2, 64, 2, 3>{});
  if (D <= 32) return f(DqCfg<32, 2, 64, 2, 3>{});
  if (D <= 40) return f(DqCfg<40, 2, 64, 1, 2>{});
  if (D <= 64) return f(DqCfg<64, 1, 32, 2, 3>{});
  if (D <= 80) return f(DqCfg<80, 1, 32, 1, 2>{});
  return f(DqWide{});
}

// What the loads need: a 16-byte aligned base and element strides in whole 16-byte
// units (D % 8 == 0 is checked with the instance).
bool aligned(const HeadView& x) {
  return reinterpret_cast<uintptr_t>(x.base) % 16 == 0 && x.sb % 4 == 0 && x.sh % 4 == 0 &&
         x.sl % 4 == 0 && x.sb >= 0 && x.sh >= 0 && x.sl >= 0;
}

cudaError_t run_fwd(const FwdParams& p, cudaStream_t stream) {
  if (p.B < 1 || p.H < 1 || p.Lq < 1 || p.Lk < 1 || !aligned(p.q) || !aligned(p.k) ||
      !aligned(p.v) || (p.m == nullptr) != (p.l == nullptr))
    return cudaErrorInvalidValue;
  return with_fwd_cfg(p.D, [&](auto cfg) {
    using C = decltype(cfg);
    const long long blocks = (long long)p.B * p.H * ((p.Lq + C::kRows - 1) / C::kRows);
    CUtensorMap tq, tk, tv;
    cudaError_t err = encode_heads(&tk, p.k, p.B, p.H, p.Lk, p.D, kFwdKeys, true);
    if (err == cudaSuccess) err = encode_heads(&tv, p.v, p.B, p.H, p.Lk, p.D, kFwdKeys, true);
    if (err != cudaSuccess) return err;
    if constexpr (std::is_same_v<C, Wide> || std::is_same_v<C, Wide160>) {
      err = encode_heads(&tq, p.q, p.B, p.H, p.Lq, p.D, C::kRows, true);
      if (err != cudaSuccess) return err;
      return run(std::is_same_v<C, Wide> ? flash_fwd_wide_3xtf32_kernel
                                         : flash_fwd_d160_3xtf32_kernel,
                 blocks, C::kThreads, C::kSmem, stream, tq, tk, tv, p);
    } else {
      return run(flash_fwd_3xtf32_kernel<C::kDP, C::kRaw, C::kDer>, blocks, C::kThreads,
                 C::kSmem, stream, tk, tv, p);
    }
  });
}

// O in the (B, L, H*D) projection layout (K1, K2); K5 sets its own strides.
FwdParams fwd_params(HeadView q, HeadView k, HeadView v, void* o, int B, int H, int Lq,
                     int Lk, int D, float scale) {
  const HeadView ov = projection_view(o, Lq, H, D);
  FwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = (float*)o;
  p.o_sb = ov.sb;
  p.o_sh = ov.sh;
  p.o_sl = ov.sl;
  p.lse = p.m = p.l = nullptr;
  p.B = B;
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.D = D;
  p.scale_log2 = scale * kLog2e;
  return p;
}

struct Views {
  HeadView q, dout, k, v;  // dout shares q's length, v k's
};

bool valid_bwd(const Views& x, int B, int H, int Lq, int Lk) {
  return B >= 1 && H >= 1 && Lq >= 1 && Lk >= 1 && aligned(x.q) && aligned(x.dout) &&
         aligned(x.k) && aligned(x.v);
}

// out: the view whose strides the outputs take.
BwdParams bwd_params(const Views& x, const void* lse, const void* l, const void* dcap,
                     void* out0, void* out1, HeadView out, int B, int H, int Lq, int Lk,
                     int D, float scale) {
  BwdParams p;
  p.q = x.q;
  p.k = x.k;
  p.v = x.v;
  p.dout = x.dout;
  p.lse = (const float*)lse;
  p.l = (const float*)l;
  p.dcap = (const float*)dcap;
  p.out0 = (float*)out0;
  p.out1 = (float*)out1;
  p.sb = out.sb;
  p.sh = out.sh;
  p.sl = out.sl;
  p.B = B;
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.D = D;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  return p;
}

cudaError_t run_dkv(const Views& x, const BwdParams& p, cudaStream_t stream) {
  if (!valid_bwd(x, p.B, p.H, p.Lq, p.Lk)) return cudaErrorInvalidValue;
  return with_dkv_cfg(p.D, [&](auto cfg) {
    using C = decltype(cfg);
    CUtensorMap tq, tdo, tk, tv;
    cudaError_t err = encode_heads(&tq, x.q, p.B, p.H, p.Lq, p.D, C::kQueries, true);
    if (err == cudaSuccess)
      err = encode_heads(&tdo, x.dout, p.B, p.H, p.Lq, p.D, C::kQueries, true);
    if (err == cudaSuccess) err = encode_heads(&tk, x.k, p.B, p.H, p.Lk, p.D, C::kKeys, true);
    if (err == cudaSuccess) err = encode_heads(&tv, x.v, p.B, p.H, p.Lk, p.D, C::kKeys, true);
    if (err != cudaSuccess) return err;
    const long long blocks = (long long)p.B * p.H * ((p.Lk + C::kKeys - 1) / C::kKeys);
    if constexpr (std::is_same_v<C, DkvWide>)
      return run(flash_bwd_dkv_d160_3xtf32_kernel, blocks, C::kThreads, C::kSmem, stream, tq,
                 tdo, tk, tv, p);
    else
      return run(flash_bwd_dkv_3xtf32_kernel<C::kDP, C::kNW, C::kRaw>, blocks, C::kThreads,
                 C::kSmem, stream, tq, tdo, tk, tv, p);
  });
}

cudaError_t run_dq(const Views& x, const BwdParams& p, cudaStream_t stream) {
  if (!valid_bwd(x, p.B, p.H, p.Lq, p.Lk)) return cudaErrorInvalidValue;
  return with_dq_cfg(p.D, [&](auto cfg) {
    using C = decltype(cfg);
    CUtensorMap tk, tv;
    cudaError_t err = encode_heads(&tk, x.k, p.B, p.H, p.Lk, p.D, C::kKeys, true);
    if (err == cudaSuccess) err = encode_heads(&tv, x.v, p.B, p.H, p.Lk, p.D, C::kKeys, true);
    if (err != cudaSuccess) return err;
    const long long blocks = (long long)p.B * p.H * ((p.Lq + C::kRows - 1) / C::kRows);
    if constexpr (std::is_same_v<C, DqWide>) {  // Q and dO by TMA too
      CUtensorMap tq, tdo;
      err = encode_heads(&tq, x.q, p.B, p.H, p.Lq, p.D, C::kRows, true);
      if (err == cudaSuccess)
        err = encode_heads(&tdo, x.dout, p.B, p.H, p.Lq, p.D, C::kRows, true);
      if (err != cudaSuccess) return err;
      return run(flash_bwd_dq_d160_3xtf32_kernel, blocks, C::kThreads, C::kSmem, stream, tq, tdo,
                 tk, tv, p);
    } else {
      return run(flash_bwd_dq_3xtf32_kernel<C::kDP, C::kNW, C::kKeys, C::kRaw, C::kDer>, blocks,
                 C::kThreads, C::kSmem, stream, tk, tv, p);
    }
  });
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

// Each entry point takes the arguments of its bf16 namesake (flash_attn_fwd.cu,
// flash_attn_bwd.cu) on fp32 tensors and returns the cudaError_t of its launches
// (0 = success). The forward takes head dims up to 512, the backward up to 160.

// The tiles of the fp32 forward instance that takes head dim D: query rows a block (128
// up to D 80, 64 above), keys a tile (64), and 1: it never splits the key range
// (ops/flash_attention.py::kv_splits). The fp32 namesake of flash_attn_fwd.cu's
// flash_fwd_tiles.
extern "C" int flash_fwd_tiles_f32(int D, int* rows, int* keys, int* max_splits) {
  return (int)with_fwd_cfg(D, [&](auto cfg) {
    using C = decltype(cfg);
    *rows = C::kRows;
    *keys = kFwdKeys;
    *max_splits = 1;
    return cudaSuccess;
  });
}

// K1 in fp32: the biased sums q + q_bias, k + k_bias, v + v_bias are written in fp32
// to q_sum, k_sum, v_sum (where the bias is given), then attended. splits must be 1
// (o_part and lse_part unused).
extern "C" int k1_biased_flash_fwd_f32(const void* q, const void* k, const void* v,
                                       const void* q_bias, const void* k_bias,
                                       const void* v_bias, int q_bias_batch,
                                       int k_bias_batch, int v_bias_batch, void* q_sum,
                                       void* k_sum, void* v_sum, void* o, void* o_part,
                                       void* lse_part, int B, int H, int Lq, int Lk, int D,
                                       float scale, int splits, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (splits != 1 || D % 8 != 0) return (int)cudaErrorInvalidValue;
  const void* in[3] = {q, k, v};
  const void* bias[3] = {q_bias, k_bias, v_bias};
  void* sum[3] = {q_sum, k_sum, v_sum};
  const int bias_batch[3] = {q_bias_batch, k_bias_batch, v_bias_batch};
  const int len[3] = {Lq, Lk, Lk};
  for (int i = 0; i < 3; ++i) {
    if (bias[i] == nullptr) continue;
    if (sum[i] == nullptr || bias_batch[i] < 1 || B % bias_batch[i]) return cudaErrorInvalidValue;
    const cudaError_t err = bias_add_f32(in[i], bias[i], sum[i], B, len[i], H * D, bias_batch[i], st);
    if (err != cudaSuccess) return (int)err;
    in[i] = sum[i];
  }
  return (int)run_fwd(fwd_params(projection_view(in[0], Lq, H, D), projection_view(in[1], Lk, H, D),
                                 projection_view(in[2], Lk, H, D), o, B, H, Lq, Lk, D, scale),
                      st);
}

// K2 in fp32: O and lse[b*H + h, l] = logsumexp of row l. splits must be 1.
extern "C" int k2_flash_fwd_lse_f32(const void* q, const void* k, const void* v, void* o,
                                    void* lse, void* o_part, void* lse_part, int B, int H,
                                    int Lq, int Lk, int D, float scale, int splits,
                                    void* stream) {
  if (splits != 1 || lse == nullptr) return (int)cudaErrorInvalidValue;
  FwdParams p = fwd_params(projection_view(q, Lq, H, D), projection_view(k, Lk, H, D),
                           projection_view(v, Lk, H, D), o, B, H, Lq, Lk, D, scale);
  p.lse = (float*)lse;
  return (int)run_fwd(p, (cudaStream_t)stream);
}

// K5 forward in fp32 over (B, H, L, D) tensors given by element strides: q and o share
// q's, k and v k's; m and l (B, H, Lq).
extern "C" int k5_stock_flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                      void* m, void* l, int B, int H, int Lq, int Lk, int D,
                                      long long q_sb, long long q_sh, long long q_sl,
                                      long long k_sb, long long k_sh, long long k_sl,
                                      float scale, void* stream) {
  if (m == nullptr || l == nullptr) return (int)cudaErrorInvalidValue;
  FwdParams p = fwd_params({q, q_sb, q_sh, q_sl}, {k, k_sb, k_sh, k_sl}, {v, k_sb, k_sh, k_sl},
                           o, B, H, Lq, Lk, D, scale);
  p.o_sb = q_sb;
  p.o_sh = q_sh;
  p.o_sl = q_sl;
  p.m = (float*)m;
  p.l = (float*)l;
  return (int)run_fwd(p, (cudaStream_t)stream);
}

// K3 in fp32: dK, dV (B, Lk, H*D) from the projections and K2's LSE.
extern "C" int k3_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* dcap,
                                    void* dk, void* dv, int B, int H, int Lq, int Lk, int D,
                                    float scale, void* stream) {
  const Views x = projections(q, k, v, dout, H, Lq, Lk, D);
  return (int)run_dkv(x, bwd_params(x, lse, nullptr, dcap, dk, dv, x.k, B, H, Lq, Lk, D, scale),
                      (cudaStream_t)stream);
}

// K4 in fp32: dQ (B, Lq, H*D).
extern "C" int k4_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* dcap,
                                   void* dq, int B, int H, int Lq, int Lk, int D, float scale,
                                   void* stream) {
  const Views x = projections(q, k, v, dout, H, Lq, Lk, D);
  return (int)run_dq(x, bwd_params(x, lse, nullptr, dcap, dq, nullptr, x.q, B, H, Lq, Lk, D,
                                   scale),
                     (cudaStream_t)stream);
}

// K5 dK, dV in fp32 over (B, H, L, D) strided tensors (q and dout share q's strides, k
// and v k's), from the forward's m and l and di, each (B, H, Lq); written by k's strides.
extern "C" int k5_stock_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                          const void* dout, const void* m, const void* l,
                                          const void* di, void* dk, void* dv, int B, int H,
                                          int Lq, int Lk, int D, long long q_sb,
                                          long long q_sh, long long q_sl, long long k_sb,
                                          long long k_sh, long long k_sl, float scale,
                                          void* stream) {
  if (m == nullptr || l == nullptr) return (int)cudaErrorInvalidValue;
  const Views x = strided(q, k, v, dout, q_sb, q_sh, q_sl, k_sb, k_sh, k_sl);
  return (int)run_dkv(x, bwd_params(x, m, l, di, dk, dv, x.k, B, H, Lq, Lk, D, scale),
                      (cudaStream_t)stream);
}

// K5 dQ in fp32, written by q's strides.
extern "C" int k5_stock_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                         const void* dout, const void* m, const void* l,
                                         const void* di, void* dq, int B, int H, int Lq,
                                         int Lk, int D, long long q_sb, long long q_sh,
                                         long long q_sl, long long k_sb, long long k_sh,
                                         long long k_sl, float scale, void* stream) {
  if (m == nullptr || l == nullptr) return (int)cudaErrorInvalidValue;
  const Views x = strided(q, k, v, dout, q_sb, q_sh, q_sl, k_sb, k_sh, k_sl);
  return (int)run_dq(x, bwd_params(x, m, l, di, dq, nullptr, x.q, B, H, Lq, Lk, D, scale),
                     (cudaStream_t)stream);
}
