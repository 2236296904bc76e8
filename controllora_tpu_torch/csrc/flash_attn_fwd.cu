// Non-causal dense flash attention, forward only, for NVIDIA Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   K1  controllora_tpu/ops/pallas_attention.py::_attn_kernel (flash_attention_fwd),
//       reached through biased_attention: attention over (q + q_bias, k + k_bias,
//       v + v_bias) with the folded ControlLoRA biases. Entry point k1_biased_flash_fwd.
//   K2  controllora_tpu/ops/pallas_attention_vjp.py::_fwd_kernel (_fwd): the same
//       attention, also writing LSE = m + log(l) per query row. Entry point
//       k2_flash_fwd_lse.
//
// Both read and write the (B, L, H*D) projection layout directly (head h of row l is
// the D-wide slice at column h*D), so the caller needs no head split, merge, pad or
// slice copies. Bias rows broadcast over the batch by tiling: batch b reads bias
// batch b % bias_batch, which is the [uncond || cond] CFG layout of the JAX UNet.
//
// What bounds it on the H100: at the serving shapes (L = 4096, D = 40 or 512) the
// kernel is compute bound (4*L*L*D flops against 8*L*D bytes per head), so the work is
// in the two products S = Q K^T and O = P V. They run on the tensor cores through
// mma.sync m16n8k16 (bf16 in, fp32 accumulate). The design is the simple one:
//   * one block of 4 warps per (batch*head, BM query rows); a loop over 64-key tiles
//     with Q, K, V tiles in shared memory, loaded with 16-byte vector loads and the
//     biases added on load (no biased copy goes through device memory);
//   * S goes through shared memory, the online softmax (running max m, normalizer l,
//     fp32) runs with BM rows spread over the 128 threads, and P goes back to shared
//     memory as bf16 for the second product;
//   * the fp32 output accumulator stays in registers. Head dims that are not a
//     multiple of 16 (SD1.5's 40) are zero padded to DP inside shared memory only.
//     Wide heads (the VAE's single D = 512 head) take 16-row query tiles and split
//     the output columns over the 4 warps, so the accumulator is 64 floats a thread;
//   * ragged L: KV columns past Lk are masked to -1e30 and query rows past Lq are
//     neither loaded nor stored, so any length works without padding in memory.
// The three stages of each KV step (S, online softmax, P V) live in flash_common.cuh,
// shared with K5's forward (flash_stock.cu). It does not yet pipeline loads
// (cp.async / TMA) or use wgmma: later work.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <int DP, int BM>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ q_bias,
                     const bf16* __restrict__ k_bias, const bf16* __restrict__ v_bias,
                     int q_bias_batch, int k_bias_batch, int v_bias_batch,
                     bf16* __restrict__ o, float* __restrict__ lse, int H, int Lq,
                     int Lk, int D, float scale) {
  using T = Tile<DP, BM>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BM * T::kLDQ;
  bf16* Vs = Ks + kBN * T::kLDQ;
  float* Ss = reinterpret_cast<float*>(Vs + kBN * T::kLDQ);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + BM * T::kLDS);
  float* row_m = reinterpret_cast<float*>(Ps + BM * T::kLDP);
  float* row_l = row_m + BM;
  float* row_a = row_l + BM;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group / column pair
  const int wm = warp / T::kWN, wn = warp % T::kWN;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BM;

  load_tile<DP>(Qs, T::kLDQ, BM, q, q_bias, b, q_bias_batch, h, q0, Lq, H, D);
  if (tid < BM) {
    row_m[tid] = kNegInf;
    row_l[tid] = 0.f;
  }
  float acc[T::kNTO][4];
#pragma unroll
  for (int nt = 0; nt < T::kNTO; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  const int n_kv = (Lk + kBN - 1) / kBN;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kBN;
    __syncthreads();  // the previous tile's readers of K, V and P are done
    load_tile<DP>(Ks, T::kLDQ, kBN, k, k_bias, b, k_bias_batch, h, k0, Lk, H, D);
    load_tile<DP>(Vs, T::kLDQ, kBN, v, v_bias, b, v_bias_batch, h, k0, Lk, H, D);
    __syncthreads();

    fwd_scores<DP, BM>(Ss, Qs, Ks, scale, Lk - k0);
    __syncthreads();
    fwd_softmax<DP, BM>(Ss, Ps, row_m, row_l, row_a);
    __syncthreads();
    fwd_accumulate<DP, BM>(acc, Ps, Vs, row_a);
  }
  __syncthreads();

  const int r0 = wm * 16 + g;
  const float inv_lo = 1.f / row_l[r0], inv_hi = 1.f / row_l[r0 + 8];
  const size_t row_stride = (size_t)H * D;
#pragma unroll
  for (int nt = 0; nt < T::kNTO; ++nt) {
    const int col = (wn * T::kNTO + nt) * 8 + t4 * 2;
    if (col >= D) continue;
    if (q0 + r0 < Lq) {
      *reinterpret_cast<__nv_bfloat162*>(
          o + ((size_t)b * Lq + q0 + r0) * row_stride + (size_t)h * D + col) =
          __floats2bfloat162_rn(acc[nt][0] * inv_lo, acc[nt][1] * inv_lo);
    }
    if (q0 + r0 + 8 < Lq) {
      *reinterpret_cast<__nv_bfloat162*>(
          o + ((size_t)b * Lq + q0 + r0 + 8) * row_stride + (size_t)h * D + col) =
          __floats2bfloat162_rn(acc[nt][2] * inv_hi, acc[nt][3] * inv_hi);
    }
  }
  if (lse != nullptr && tid < BM && q0 + tid < Lq)
    lse[(size_t)bh * Lq + q0 + tid] = row_m[tid] + logf(row_l[tid]);
}

template <int DP, int BM>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* qb,
                   const bf16* kb, const bf16* vb, int qbb, int kbb, int vbb, bf16* o,
                   float* lse, int B, int H, int Lq, int Lk, int D, float scale,
                   cudaStream_t stream) {
  const size_t smem = Tile<DP, BM>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DP, BM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + BM - 1) / BM, B * H);
  flash_fwd_kernel<DP, BM><<<grid, kThreads, smem, stream>>>(
      q, k, v, qb, kb, vb, qbb, kbb, vbb, o, lse, H, Lq, Lk, D, scale);
  return cudaGetLastError();
}

// One instance per head dim the ported models give: 40 (SD1.5 UNet), 80 (its 768²
// tail) and 512 (VAE). Any other D (a multiple of 8, <= 512) is zero padded to the
// next instance. The 512 instance takes 16-row query tiles so the per-thread
// accumulator stays within the register file.
cudaError_t dispatch(const bf16* q, const bf16* k, const bf16* v, const bf16* qb,
                     const bf16* kb, const bf16* vb, int qbb, int kbb, int vbb, bf16* o,
                     float* lse, int B, int H, int Lq, int Lk, int D, float scale,
                     cudaStream_t stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || D < 8 || D % 8 != 0 || B * H > 65535)
    return cudaErrorInvalidValue;
#define CL_LAUNCH(DP, BM) \
  return launch<DP, BM>(q, k, v, qb, kb, vb, qbb, kbb, vbb, o, lse, B, H, Lq, Lk, D, scale, stream)
  if (D <= 48) CL_LAUNCH(48, 64);
  if (D <= 80) CL_LAUNCH(80, 64);
  if (D <= 512) CL_LAUNCH(512, 16);
#undef CL_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// K1: O = softmax((q + q_bias)(k + k_bias)^T * scale)(v + v_bias). Any bias pointer
// may be null; a bias has bias_batch rows of batch and B % bias_batch == 0.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int k1_biased_flash_fwd(const void* q, const void* k, const void* v,
                                   const void* q_bias, const void* k_bias,
                                   const void* v_bias, int q_bias_batch,
                                   int k_bias_batch, int v_bias_batch, void* o, int B,
                                   int H, int Lq, int Lk, int D, float scale,
                                   void* stream) {
  return (int)dispatch((const bf16*)q, (const bf16*)k, (const bf16*)v,
                       (const bf16*)q_bias, (const bf16*)k_bias, (const bf16*)v_bias,
                       q_bias_batch, k_bias_batch, v_bias_batch, (bf16*)o, nullptr, B, H,
                       Lq, Lk, D, scale, (cudaStream_t)stream);
}

// K2: O = softmax(q k^T * scale) v and lse[b*H + h, l] = logsumexp of row l (fp32).
extern "C" int k2_flash_fwd_lse(const void* q, const void* k, const void* v, void* o,
                                void* lse, int B, int H, int Lq, int Lk, int D,
                                float scale, void* stream) {
  return (int)dispatch((const bf16*)q, (const bf16*)k, (const bf16*)v, nullptr, nullptr,
                       nullptr, 1, 1, 1, (bf16*)o, (float*)lse, B, H, Lq, Lk, D, scale,
                       (cudaStream_t)stream);
}
