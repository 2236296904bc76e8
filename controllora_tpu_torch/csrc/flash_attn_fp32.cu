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
//   (head dims up to 80) and          (entry point k1_biased_flash_fwd_f32, with
//   flash_fwd_wide_3xtf32_kernel      bias_add_f32_kernel adding the biases in fp32 first,
//   (up to 512)                       as the JAX caller adds them),
//                                 K2  controllora_tpu/ops/pallas_attention_vjp.py::_fwd_kernel
//                                     (k2_flash_fwd_lse_f32: O and LSE),
//                                 K5  the forward of jax's stock TPU flash attention
//                                     (jax/experimental/pallas/ops/tpu/flash_attention.py::
//                                     _flash_attention_kernel, reached through
//                                     controllora_tpu/ops/attention.py::_flash_stock;
//                                     k5_stock_flash_fwd_f32: O, m and l);
//   flash_bwd_dkv_3xtf32_kernel   K3  pallas_attention_vjp.py::_bwd_dkv_kernel
//                                     (k3_flash_bwd_dkv_f32) and K5's
//                                     _flash_attention_dkv_kernel (k5_stock_flash_bwd_dkv_f32);
//   flash_bwd_dq_f32_kernel       K4  pallas_attention_vjp.py::_bwd_dq_kernel
//                                     (k4_flash_bwd_dq_f32) and K5's _flash_attention_dq_kernel
//                                     (k5_stock_flash_bwd_dq_f32).
// Each entry point has the C signature of its bf16 namesake, so the wrappers in
// ops/flash_attention.py and ops/flash_stock.py pick one by the inputs' dtype.
//
// What bounds them on the H100: the products. At the fp32 paths' shapes (L 4096, D 8-80
// or 512) the work is 4 L^2 D flops a head forward (dK/dV 8, dQ 6) against ~16 L D
// bytes, so operations bound them by far. The products must be fp32-accurate: the JAX
// kernels multiply fp32 blocks with fp32 results, and the port runs fp32 with TF32 off
// (outputs within 1e-4 * max(1, max|ref|) of fp32). One TF32 product keeps 11 bits of
// each operand and misses that bound; three do not (tests/test_torch_tf32_split.py
// emulates both). So the forward and dK/dV run every product as 3xTF32 on the tensor
// cores: each operand x is split into hi = x with its 13 low mantissa bits dropped and
// lo = tf32_rna(x - hi) (cvt.rna.tf32.f32's rounding), and a product is lo*hi + hi*lo +
// hi*hi into one fp32 accumulator, the two small terms first. Their bound is the
// card's 495 TF32 TFLOP/s over three, 165 TFLOP/s. Every operand is split explicitly
// (no product reads raw fp32 and leaves the truncation to the tensor core). The dQ
// kernel is still the first design, fp32 FMA on the CUDA cores (67 TFLOP/s; described
// at the kernel).
//
// The 3xTF32 kernels are built like the bf16 ones (hopper.cuh): a producer warpgroup
// and consumer warpgroups that issue wgmma.mma_async (m64nNk8, tf32; wgmma_tf32.cuh)
// from registers or 128-byte swizzled shared memory, the online softmax on the
// accumulators in registers, and TMA tensor maps over (B, H, L, D) fp32 views by their
// strides (encode_heads with fp32: 32 floats a swizzle span, zero filled past L and past
// D). What differs is the split and one layout constraint: tf32 wgmma reads a shared
// operand K-major only (it has no transpose bit), so an operand whose reduction runs
// over tokens (V in O += P V, dO in dV += P^T dO, Q in dK += dS^T Q) is needed with the
// tokens contiguous, which TMA cannot give. So the kernels split as well as copy: one
// thread keeps TMA loads of raw fp32 tiles in flight through a ring of mbarriers, and
// the split writes each raw tile's hi and lo in the same swizzled layout and the
// transposed ones (V^T, Q^T, dO^T, hi and lo) with the tokens contiguous, then fences
// the async proxy before wgmma reads them. In the forward up to D 80 and in dK/dV the
// producer warpgroup's 128 threads split and arrive on a "derived" barrier that the
// consumers wait on; in the wide forward each consumer warpgroup splits its own next
// step while its products run. The split sets the pace (a build that skipped it ran
// far faster), so each thread issues its shared-memory loads in batches (split_tile)
// and rounds with integer operations (tf32_rna).
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
//   * forward, D up to 512 (flash_fwd_wide_3xtf32_kernel): 64 query rows a block and
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
//     stages of 32 KB per warpgroup and the 32 KB exchange: 224 KB. Narrower heads above
//     80 are zero filled to 512.
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
//   * ragged L: scores of keys at or past Lk are -inf in the forward, and P^T is 0 by
//     index for queries at or past Lq in dK/dV; stationary rows past L are computed on
//     zeros and never stored. The softmax scale is a runtime argument of either sign;
//     the forward tracks its running max on S * scale * log2(e).
// The fp32 loads need a 16-byte aligned base and D and every element stride a multiple
// of 4 floats: 16 bytes, what TMA asks and what the dQ kernel's cp.async copies take
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

// ---------------------------------------------------------------- the dQ kernel's tiles
//
// The dQ kernel (flash_bwd_dq_f32_kernel) is the first design of this file: products
// as fp32 FMA on the CUDA cores, as an SGEMM does. A block keeps R stationary query
// rows (Q and dO) in shared memory and streams C-key stages of K and V through two
// cp.async stages (16 bytes a copy, zero filled past L and past D); thread t owns the
// stationary rows (t / CG) * TM .. + TM, and register micro-tiles hold its part of S,
// dP and dQ; dS goes through shared memory. Head dims padded to 16, 32, 48, 64 or 80.

// ---------------------------------------------------------------- copies

// 16 bytes from global to shared memory without passing through registers; zeros where
// !ok (then nothing is read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------- tiles

// R stationary rows against C streamed rows a step, NT threads in row groups of CG
// lanes (see the header); rows of DP floats (the head dim padded) in shared memory.
template <int DP, int R, int C, int CG, int NT>
struct Tile {
  static constexpr int kDP = DP, kR = R, kC = C, kCG = CG, kNT = NT;
  static constexpr int kStride = DP + 4;  // floats a shared row: distinct banks by row
  static constexpr int kPStride = C + 4;  // floats a shared row of P or dS
  static constexpr int kTM = R * CG / NT;  // stationary rows a thread
  static constexpr int kTN = C / CG;       // streamed rows a thread (product over D)
  static constexpr int kCD = DP / 4 / CG;  // float4 head chunks a thread (product into D)
  static_assert(DP % 8 == 0 && NT % 32 == 0 && 32 % CG == 0, "tile shape");
  static_assert(C % CG == 0 && C % 4 == 0 && (DP / 4) % CG == 0, "tile shape");
  static_assert(kTM >= 1 && kTM * (NT / CG) == R, "tile shape");
};

// Rows [r0, r0 + ROWS) of one head (element row stride sl) into shared rows; rows at or
// past L and columns at or past D are zero filled. Every thread of the block takes part.
template <class T, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long sl, int r0,
                                          int L, int D) {
  constexpr int kC4 = T::kDP / 4;
  for (int i = threadIdx.x; i < ROWS * kC4; i += T::kNT) {
    const int r = i / kC4, c = (i - r * kC4) * 4;
    const bool ok = r0 + r < L && c < D;
    cp_async16(dst + r * T::kStride + c, ok ? src + (r0 + r) * sl + c : src, ok);
  }
}

// acc[i][j] = x[row i] . y[row j] over the head dim: the thread's TM stationary rows
// (x) against its TN streamed rows (y).
template <class T>
__device__ __forceinline__ void dot_rows(float (&acc)[T::kTM][T::kTN], const float* x,
                                         const float* y, int rg, int cg) {
#pragma unroll
  for (int i = 0; i < T::kTM; ++i)
#pragma unroll
    for (int j = 0; j < T::kTN; ++j) acc[i][j] = 0.f;
  const float* xr = x + rg * T::kTM * T::kStride;
  const float* yr = y + cg * T::kStride;
#pragma unroll 4
  for (int d = 0; d < T::kDP; d += 4) {
    float4 a[T::kTM];
#pragma unroll
    for (int i = 0; i < T::kTM; ++i)
      a[i] = *reinterpret_cast<const float4*>(xr + i * T::kStride + d);
#pragma unroll
    for (int j = 0; j < T::kTN; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(yr + j * T::kCG * T::kStride + d);
#pragma unroll
      for (int i = 0; i < T::kTM; ++i) {
        acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
      }
    }
  }
}

__device__ __forceinline__ float lane4(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& z) {
  acc.x = fmaf(w, z.x, acc.x);
  acc.y = fmaf(w, z.y, acc.y);
  acc.z = fmaf(w, z.z, acc.z);
  acc.w = fmaf(w, z.w, acc.w);
}

__device__ __forceinline__ void scale4(float4& acc, float s) {
  acc.x *= s;
  acc.y *= s;
  acc.z *= s;
  acc.w *= s;
}

// acc[i][c] += sum over the C streamed rows j of pm[row i][j] * z[row j][chunk c]: the
// thread's TM stationary rows of P (or dS, rows of kPStride floats) times the streamed
// rows' head columns in its float4 chunks.
template <class T>
__device__ __forceinline__ void acc_rows(float4 (&acc)[T::kTM][T::kCD], const float* pm,
                                         const float* z, int rg, int cg) {
  const float* pr = pm + rg * T::kTM * T::kPStride;
  const float* zc = z + 4 * cg;
#pragma unroll 2
  for (int j = 0; j < T::kC; j += 4) {
    float4 w[T::kTM];
#pragma unroll
    for (int i = 0; i < T::kTM; ++i)
      w[i] = *reinterpret_cast<const float4*>(pr + i * T::kPStride + j);
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int c = 0; c < T::kCD; ++c) {
        const float4 zv =
            *reinterpret_cast<const float4*>(zc + (j + k) * T::kStride + 4 * c * T::kCG);
#pragma unroll
        for (int i = 0; i < T::kTM; ++i) fma4(acc[i][c], lane4(w[i], k), zv);
      }
  }
}

template <class T>
__device__ __forceinline__ void zero(float4 (&acc)[T::kTM][T::kCD]) {
#pragma unroll
  for (int i = 0; i < T::kTM; ++i)
#pragma unroll
    for (int c = 0; c < T::kCD; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Row i of the thread's accumulator, times mul, into out (a row of the head) at the
// thread's chunks below D.
template <class T>
__device__ __forceinline__ void store_row(float* out, const float4 (&acc)[T::kTM][T::kCD],
                                          int i, float mul, int cg, int D) {
#pragma unroll
  for (int c = 0; c < T::kCD; ++c) {
    const int col = 4 * (cg + c * T::kCG);
    if (col < D) {
      float4 x = acc[i][c];
      scale4(x, mul);
      *reinterpret_cast<float4*>(out + col) = x;
    }
  }
}

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

// Shared-memory descriptor of a K-major operand in 128-byte swizzled spans: k-step kk
// (8 tf32 columns, 32 bytes) of a tile whose span s starts at tile + s * span_bytes.
__device__ __forceinline__ uint64_t kdesc(const unsigned char* tile, int kk, int span_bytes) {
  return desc_sw128(tile + (kk >> 2) * span_bytes + (kk & 3) * 32, 16, 1024);
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
// (N columns from col0), and, by the threads with write_rows, LSE or K5's m and l.
template <int N>
__device__ __forceinline__ void fwd_epilogue(const FwdParams& p, const float* o, float m0,
                                             float m1, float l0, float l1, int b, int h,
                                             int r0, int col0, int t4, bool write_rows) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  store_acc_f32<N>(p.o + b * p.o_sb + h * p.o_sh, p.o_sl, o, 1.f / l0, 1.f / l1, r0, p.Lq,
                   col0, p.D, t4);
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
  {
    const float* qg = static_cast<const float*>(p.q.base) + b * p.q.sb + h * p.q.sh;
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + 8 * (e & 1), col = kk * 8 + t4 + 4 * (e >> 1);
        split(row < p.Lq && col < p.D ? qg[row * p.q.sl + col] : 0.f, qh[kk][e], ql[kk][e]);
      }
  }

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
  fwd_epilogue<DP>(p, o, m0, m1, l0, l1, b, h, r0, 0, t4, t4 == 0);
}

// The wide design (D up to 512): STAGES stages per consumer warpgroup, each 32 KB: the
// raw tiles TMA writes (Q and K chunks, split to hi in place; or a V chunk) and the
// derived ones (Q and K lo; or V^T hi and lo).
template <int STAGES>
struct WideCfg {
  static constexpr int kStages = STAGES;
  static constexpr int kRows = 64;              // queries a block
  static constexpr int kCols = 256;             // columns of the head a warpgroup owns
  static constexpr int kSteps = kCols / kSpan;  // S steps (and O steps) a tile
  static constexpr int kChunk = 64 * kSpanRow;  // one 64-row span: 8 KB
  static constexpr int kStage = 4 * kChunk;
  static constexpr int kExchange = 32 * 128 * 4;  // one warpgroup's S tile, or P hi or lo
  static constexpr int kThreads = 384;
  static constexpr size_t kSmem =
      1024 + 2 * (size_t)STAGES * kStage + 2 * kExchange + 8 * 4 * STAGES;
};

constexpr int kWarpgroupBar = 4;  // the wide forward's per-warpgroup barriers (4, 5)

__global__ void __launch_bounds__(384, 1)
    flash_fwd_wide_3xtf32_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv, const FwdParams p) {
  using C = WideCfg<3>;
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
  // a warpgroup's steps: 16 a tile, 8 of S (its Q and K chunk c) then 8 of O (V chunk c)
  const int n_steps = n_tiles * 2 * C::kSteps;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // the warps of the stage's warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    // ---------------------------------------------------------------- producer
    // Warp 8 + w keeps warpgroup w's TMA loads in flight; the copies are all it does.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    const int w = warp - 8;
    if (w < 2 && lane == 0) {
      for (int i = 0; i < n_steps; ++i) {
        const int s = i % S, r = i % (2 * C::kSteps);
        const int col = (w * C::kSteps + r % C::kSteps) * kSpan, key0 = (i / (2 * C::kSteps)) * kFwdKeys;
        uint64_t* f = &full[w * S + s];
        mbar_wait(&empty[w * S + s], ((i / S) & 1) ^ 1);
        unsigned char* st = stages + (size_t)(w * S + s) * C::kStage;
        if (r < C::kSteps) {
          mbar_expect_tx(f, 2 * C::kChunk);
          tma_load_4d(st, &tq, f, col, h, q0, b);
          tma_load_4d(st + C::kChunk, &tk, f, col, h, key0, b);
        } else {
          mbar_expect_tx(f, C::kChunk);
          tma_load_4d(st, &tv, f, col, h, key0, b);
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
  unsigned char* my = stages + (size_t)wg * S * C::kStage;
  uint64_t* my_full = full + wg * S;
  uint64_t* my_empty = empty + wg * S;

  // Split step i's raw tiles (hi in place, lo beside; or V^T hi and lo) once they are in.
  auto split_step = [&](int i) {
    const int s = i % S;
    unsigned char* st = my + (size_t)s * C::kStage;
    mbar_wait(&my_full[s], (i / S) & 1);
    if (i % (2 * C::kSteps) < C::kSteps) {
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

  float o[C::kCols / 2];
#pragma unroll
  for (int i = 0; i < C::kCols / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  int step = 0;
  split_step(0);

  for (int j = 0; j < n_tiles; ++j) {
    // this warpgroup's half of S = Q K^T over its 8 chunks of the head
    float s[32];
#pragma unroll 1
    for (int c = 0; c < C::kSteps; ++c, ++step) {
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

    // S = the sum of both halves: each warpgroup adds the other's tile to its own
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
    for (int i = 0; i < C::kCols / 2; i += 4) {
      o[i] *= alpha.x;
      o[i + 1] *= alpha.x;
      o[i + 2] *= alpha.y;
      o[i + 3] *= alpha.y;
    }
    named_sync(kExchangeBar, 256);  // P is in
    const unsigned char* p_hi = reinterpret_cast<const unsigned char*>(xch);
    const unsigned char* p_lo = p_hi + C::kExchange;

    // O (this warpgroup's 256 columns) += P V, 32 columns a step
#pragma unroll
    for (int c = 0; c < C::kSteps; ++c, ++step) {
      const unsigned char* st = my + (size_t)(step % S) * C::kStage;
      wgmma_fence();
      ss_3xtf32<kSpan>(o + c * 16, p_hi, p_lo, C::kChunk, st + 2 * C::kChunk,
                       st + 3 * C::kChunk, kSpan * kSpanRow, 8, false);
      wgmma_commit();
      if (step + 1 < n_steps) split_step(step + 1);  // the next tile's first S step
      wgmma_wait<0>();
      release(step);
    }
    fence_regs<C::kCols / 2>(o);
  }
  fwd_epilogue<C::kCols>(p, o, m0, m1, l0, l1, b, h, r0, wg * C::kCols, t4,
                         t4 == 0 && wg == 0);
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

// dQ: R queries a block (Q and dO stationary, each thread's rows' LSE and Dcap in
// registers), C-key stages of K and V.
template <int DP, int R, int C, int CG, int NT>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dq_f32_kernel(const BwdParams p) {
  using T = Tile<DP, R, C, CG, NT>;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + R * T::kStride;
  float* ring = do_s + R * T::kStride;        // two stages of K and V
  float* ds_s = ring + 4 * C * T::kStride;    // dS, R x C

  // block -> (batch*head, query tile)
  const int q_tiles = (p.Lq + R - 1) / R;
  const int qt = blockIdx.x % q_tiles, bh = blockIdx.x / q_tiles;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = qt * R;
  const float* qg = static_cast<const float*>(p.q.base) + b * p.q.sb + h * p.q.sh;
  const float* dog = static_cast<const float*>(p.dout.base) + b * p.dout.sb + h * p.dout.sh;
  const float* kg = static_cast<const float*>(p.k.base) + b * p.k.sb + h * p.k.sh;
  const float* vg = static_cast<const float*>(p.v.base) + b * p.v.sb + h * p.v.sh;
  const int n_k = (p.Lk + C - 1) / C;

  load_rows<T, R>(q_s, qg, p.q.sl, q0, p.Lq, p.D);
  load_rows<T, R>(do_s, dog, p.dout.sl, q0, p.Lq, p.D);
  load_rows<T, C>(ring, kg, p.k.sl, 0, p.Lk, p.D);
  load_rows<T, C>(ring + C * T::kStride, vg, p.v.sl, 0, p.Lk, p.D);
  cp_async_commit();

  const int rg = threadIdx.x / CG, cg = threadIdx.x % CG;
  // this thread's query rows: LSE * log2(e) and Dcap, 0 past Lq (never stored)
  float lse2[T::kTM], dc[T::kTM];
#pragma unroll
  for (int i = 0; i < T::kTM; ++i) {
    const int row = q0 + rg * T::kTM + i;
    const size_t r = (size_t)bh * p.Lq + row;
    lse2[i] = 0.f;
    dc[i] = 0.f;
    if (row < p.Lq) {
      lse2[i] = (p.l == nullptr ? p.lse[r] : p.lse[r] + logf(p.l[r])) * kLog2e;
      dc[i] = p.dcap[r];
    }
  }
  float4 dq[T::kTM][T::kCD];
  zero<T>(dq);

  for (int j = 0; j < n_k; ++j) {
    cp_async_wait_all();
    __syncthreads();  // stage j is in; every thread is done with stage j - 1 and dS
    if (j + 1 < n_k) {
      float* next = ring + ((j + 1) & 1) * 2 * C * T::kStride;
      load_rows<T, C>(next, kg, p.k.sl, (j + 1) * C, p.Lk, p.D);
      load_rows<T, C>(next + C * T::kStride, vg, p.v.sl, (j + 1) * C, p.Lk, p.D);
      cp_async_commit();
    }
    const float* ks = ring + (j & 1) * 2 * C * T::kStride;
    const float* vs = ks + C * T::kStride;

    // S = Q K^T and dP = dO V^T, unscaled; P = exp(S * scale - LSE), 0 for keys at or
    // past Lk; dS = P (dP - Dcap)
    float s[T::kTM][T::kTN], dp[T::kTM][T::kTN];
    dot_rows<T>(s, q_s, ks, rg, cg);
    dot_rows<T>(dp, do_s, vs, rg, cg);
    const int key0 = j * C;
#pragma unroll
    for (int t = 0; t < T::kTN; ++t) {
      const int col = cg + t * CG;
      const bool ok = key0 + col < p.Lk;
#pragma unroll
      for (int i = 0; i < T::kTM; ++i) {
        const float pv = ok ? exp2f(fmaf(s[i][t], p.scale_log2, -lse2[i])) : 0.f;
        ds_s[(rg * T::kTM + i) * T::kPStride + col] = pv * (dp[i][t] - dc[i]);
      }
    }
    __syncthreads();  // dS is in
    acc_rows<T>(dq, ds_s, ks, rg, cg);  // dQ += dS K
  }

#pragma unroll
  for (int i = 0; i < T::kTM; ++i) {
    const int row = q0 + rg * T::kTM + i;
    if (row >= p.Lq) continue;
    store_row<T>(p.out0 + b * p.sb + h * p.sh + row * p.sl, dq, i, p.scale, cg, p.D);
  }
}

// ---------------------------------------------------------------- launches

template <class T>
size_t dq_smem() {
  return sizeof(float) * ((2 * (size_t)T::kR + 4 * (size_t)T::kC) * T::kStride +
                          (size_t)T::kR * T::kPStride);
}

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
// design, anything wider up to 512 in the wide one. f is called with the instance's Cfg.
using Wide = WideCfg<3>;

template <class F>
cudaError_t with_fwd_cfg(int D, F&& f) {
  if (D < 8 || D % 8 != 0 || D > 512) return cudaErrorInvalidValue;
  if (D <= 8) return f(FwdCfg<8, 2, 2>{});
  if (D <= 16) return f(FwdCfg<16, 2, 2>{});
  if (D <= 32) return f(FwdCfg<32, 2, 2>{});
  if (D <= 40) return f(FwdCfg<40, 2, 2>{});
  if (D <= 64) return f(FwdCfg<64, 2, 2>{});
  if (D <= 80) return f(FwdCfg<80, 1, 2>{});
  return f(Wide{});
}

// dK/dV instances: D rounded up as in the forward; two consumer warpgroups up to D 64,
// one (and one raw stage) at D 80, where two would not fit in shared memory.
template <class F>
cudaError_t with_dkv_cfg(int D, F&& f) {
  if (D < 8 || D % 8 != 0 || D > 80) return cudaErrorInvalidValue;
  if (D <= 8) return f(DkvCfg<8, 2, 2>{});
  if (D <= 16) return f(DkvCfg<16, 2, 2>{});
  if (D <= 32) return f(DkvCfg<32, 2, 2>{});
  if (D <= 40) return f(DkvCfg<40, 2, 2>{});
  if (D <= 64) return f(DkvCfg<64, 2, 2>{});
  return f(DkvCfg<80, 1, 1>{});
}

// The dQ kernel's instances: D padded to DP columns in shared memory (zero filled).
template <class F>
cudaError_t with_bwd_tile(int D, F&& f) {
  if (D < 8 || D % 8 != 0 || D > 80) return cudaErrorInvalidValue;
  if (D <= 16) return f(Tile<16, 64, 32, 4, 128>{});
  if (D <= 32) return f(Tile<32, 64, 32, 8, 128>{});
  if (D <= 48) return f(Tile<48, 64, 32, 4, 128>{});
  if (D <= 64) return f(Tile<64, 64, 32, 8, 128>{});
  return f(Tile<80, 64, 32, 4, 128>{});
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
    if constexpr (std::is_same_v<C, Wide>) {
      err = encode_heads(&tq, p.q, p.B, p.H, p.Lq, p.D, C::kRows, true);
      if (err != cudaSuccess) return err;
      return run(flash_fwd_wide_3xtf32_kernel, blocks, C::kThreads, C::kSmem, stream, tq, tk,
                 tv, p);
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
    cudaError_t err = encode_heads(&tq, x.q, p.B, p.H, p.Lq, p.D, kDkvQueries, true);
    if (err == cudaSuccess)
      err = encode_heads(&tdo, x.dout, p.B, p.H, p.Lq, p.D, kDkvQueries, true);
    if (err == cudaSuccess) err = encode_heads(&tk, x.k, p.B, p.H, p.Lk, p.D, C::kKeys, true);
    if (err == cudaSuccess) err = encode_heads(&tv, x.v, p.B, p.H, p.Lk, p.D, C::kKeys, true);
    if (err != cudaSuccess) return err;
    const long long blocks = (long long)p.B * p.H * ((p.Lk + C::kKeys - 1) / C::kKeys);
    return run(flash_bwd_dkv_3xtf32_kernel<C::kDP, C::kNW, C::kRaw>, blocks, C::kThreads,
               C::kSmem, stream, tq, tdo, tk, tv, p);
  });
}

cudaError_t run_dq(const Views& x, const BwdParams& p, cudaStream_t stream) {
  if (!valid_bwd(x, p.B, p.H, p.Lq, p.Lk)) return cudaErrorInvalidValue;
  return with_bwd_tile(p.D, [&](auto tile) {
    using T = decltype(tile);
    const long long blocks = (long long)p.B * p.H * ((p.Lq + T::kR - 1) / T::kR);
    return run(flash_bwd_dq_f32_kernel<T::kDP, T::kR, T::kC, T::kCG, T::kNT>, blocks, T::kNT,
               dq_smem<T>(), stream, p);
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
// (0 = success). The forward takes head dims up to 512, the backward up to 80.

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
