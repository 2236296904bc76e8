// Helpers shared by the flash-attention kernels (flash_attn_fwd.cu, flash_attn_bwd.cu):
// the bf16 tensor-core product, fragment packing and the tile loader that reads one
// head of the (B, L, H*D) projection layout into shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;   // 4 warps per block
constexpr float kNegInf = -1e30f;

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
// laid out [nrows][ld], plus the bias row of batch b % bias_batch when bias is given.
// Rows at or past L and columns in [D, DP) are zero.
template <int DP>
__device__ __forceinline__ void load_tile(bf16* s, int ld, int nrows,
                                          const bf16* __restrict__ x,
                                          const bf16* __restrict__ bias, int b,
                                          int bias_batch, int h, int row0, int L,
                                          int H, int D) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks per shared-memory row
  const size_t row_stride = (size_t)H * D;
  for (int idx = threadIdx.x; idx < nrows * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < L && c < D) {
      val = *reinterpret_cast<const uint4*>(
          x + ((size_t)b * L + row) * row_stride + (size_t)h * D + c);
      if (bias != nullptr) {
        const uint4 bv = *reinterpret_cast<const uint4*>(
            bias + ((size_t)(b % bias_batch) * L + row) * row_stride + (size_t)h * D + c);
        bf16* xv = reinterpret_cast<bf16*>(&val);
        const bf16* bb = reinterpret_cast<const bf16*>(&bv);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          xv[e] = __float2bfloat16(__bfloat162float(xv[e]) + __bfloat162float(bb[e]));
      }
    }
    *reinterpret_cast<uint4*>(s + r * ld + c) = val;
  }
}

}  // namespace flash
