// Helpers shared by the mma.sync flash-attention backward kernels (K4 in
// flash_attn_bwd.cu, K5's backward in flash_stock.cu): the bf16 tensor-core product,
// fragment packing, the tile loaders and the fragment helpers. The forward kernels
// (flash_attn_fwd.cu) and K3 run on wgmma and TMA instead (hopper.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;  // 4 warps per block

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Two fp32 values rounded to one packed bf16 pair (lo in the low half).
__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  return pack2(__float2bfloat16(lo), __float2bfloat16(hi));
}

// c (16x8, fp32) += a (16x16, bf16, row major) * b (16x8, bf16, column major)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [row0, row0 + nrows) of head h of a (B, L, H*D) tensor into shared memory
// laid out [nrows][ld]. Rows at or past L and columns in [D, DP) are zero.
template <int DP>
__device__ __forceinline__ void load_tile(bf16* s, int ld, int nrows,
                                          const bf16* __restrict__ x, int b, int h,
                                          int row0, int L, int H, int D) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks per shared-memory row
  const size_t row_stride = (size_t)H * D;
  for (int idx = threadIdx.x; idx < nrows * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < L && c < D)
      val = *reinterpret_cast<const uint4*>(
          x + ((size_t)b * L + row) * row_stride + (size_t)h * D + c);
    *reinterpret_cast<uint4*>(s + r * ld + c) = val;
  }
}

// Rows [row0, row0 + nrows) of one head given by its first row `x` and its row stride
// (elements; a multiple of 8) into shared memory laid out [nrows][ld]; columns in
// [D, DP) are zero. Every row must exist (the caller's length is whole tiles).
template <int DP>
__device__ __forceinline__ void load_rows(bf16* s, int ld, int nrows,
                                          const bf16* __restrict__ x,
                                          long long row_stride, int row0, int D) {
  constexpr int kChunks = DP / 8;
  for (int idx = threadIdx.x; idx < nrows * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (c < D)
      val = *reinterpret_cast<const uint4*>(x + (row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(s + r * ld + c) = val;
  }
}

// ---------------------------------------------------------------- backward tiles

constexpr int kB = 64;  // rows of every backward tile (queries and keys)

template <int DP>
struct BwdTile {
  static constexpr int kLD = DP + 8;    // bf16 row stride of the shared tiles
  static constexpr int kNT = kB / 8;    // n-tiles across the 64 columns of S
  static constexpr int kND = DP / 8;    // n-tiles across the head dim
  static_assert(DP % 16 == 0, "DP must be a multiple of 16");
  static constexpr size_t kSmem = 4 * (size_t)kB * kLD * sizeof(bf16) +
                                  3 * (size_t)kB * sizeof(float);
};

// A fragment (16 x 16, rows row0.., columns kk..) from a shared tile with stride ld.
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* base, int ld, int kk,
                                       int g, int t4) {
  a[0] = ld32(base + g * ld + kk + t4 * 2);
  a[1] = ld32(base + (g + 8) * ld + kk + t4 * 2);
  a[2] = ld32(base + g * ld + kk + 8 + t4 * 2);
  a[3] = ld32(base + (g + 8) * ld + kk + 8 + t4 * 2);
}

// A fragment of k-slice j (columns 16j..16j+15) from the fp32 C fragments of
// n-tiles 2j and 2j+1, rounded to bf16.
__device__ __forceinline__ void frag_to_a(uint32_t* a, const float* c0, const float* c1) {
  a[0] = pack2f(c0[0], c0[1]);
  a[1] = pack2f(c0[2], c0[3]);
  a[2] = pack2f(c1[0], c1[1]);
  a[3] = pack2f(c1[2], c1[3]);
}

// acc (16 x DP) += a (16 x 16) * X[rows 16j.., all DP columns], X a shared tile.
template <int DP>
__device__ __forceinline__ void mma_rows(float (*acc)[4], const uint32_t* a,
                                         const bf16* x, int j, int g, int t4) {
  using T = BwdTile<DP>;
#pragma unroll
  for (int n = 0; n < T::kND; ++n) {
    const bf16* xb = x + (j * 16 + t4 * 2) * T::kLD + n * 8 + g;
    mma_bf16(acc[n], a, pack2(xb[0], xb[T::kLD]), pack2(xb[8 * T::kLD], xb[9 * T::kLD]));
  }
}

// Store rows (lo, hi = lo + 8) of a warp's 16 x DP fp32 accumulator, times mul, as
// bf16 into one head given by its first row `out` and its row stride (elements).
// Rows at or past L are not stored.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, long long row_stride,
                                           float (*acc)[4], float mul, int row_lo, int L,
                                           int D, int t4) {
  using T = BwdTile<DP>;
#pragma unroll
  for (int n = 0; n < T::kND; ++n) {
    const int col = n * 8 + t4 * 2;
    if (col >= D) continue;
    if (row_lo < L)
      *reinterpret_cast<__nv_bfloat162*>(out + row_lo * row_stride + col) =
          __floats2bfloat162_rn(acc[n][0] * mul, acc[n][1] * mul);
    if (row_lo + 8 < L)
      *reinterpret_cast<__nv_bfloat162*>(out + (row_lo + 8) * row_stride + col) =
          __floats2bfloat162_rn(acc[n][2] * mul, acc[n][3] * mul);
  }
}

}  // namespace flash
