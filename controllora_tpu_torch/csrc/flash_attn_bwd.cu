// Non-causal dense flash attention, backward, for NVIDIA Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package, the backward of its
// differentiable flash attention (controllora_tpu/ops/pallas_attention_vjp.py, _bwd):
//   K3  _bwd_dkv_kernel: dK and dV, one program per KV tile looping over query tiles.
//       Entry point k3_flash_bwd_dkv.
//   K4  _bwd_dq_kernel: dQ, one program per query tile looping over KV tiles.
//       Entry point k4_flash_bwd_dq.
// Both take O's LSE from the forward kernel K2 (flash_attn_fwd.cu) and
// Dcap = rowsum(dO * O), which the caller computes (as the JAX _bwd does outside its
// kernels), both (B*H, Lq) fp32. With P = exp(S*scale - LSE) recomputed from Q and K:
//   dV = P^T dO,   dP = dO V^T,   dS = P * (dP - Dcap),
//   dK = dS^T Q * scale,   dQ = dS K * scale.
//
// Layout: q, k, v, dO, dQ, dK, dV are the (B, L, H*D) projections (head h of row l is
// the D-wide slice at column h*D), read with strides like the forward kernels, so
// the caller makes no head split, merge, pad or slice copies.
//
// What bounds it on the H100: at the training shapes (L = 4096, D = 40) each kernel
// is compute bound (K3 runs four L x L x D products per head, K4 three), so the work
// is in the tensor-core products: mma.sync m16n8k16, bf16 in, fp32 accumulate. The
// design is the simple one:
//   * one block of 4 warps per (batch*head, 64-row tile); each warp owns 16 rows of
//     the tile (keys in K3, queries in K4) against all 64 columns of the other side;
//   * the tiles (Q, K, V, dO) sit in shared memory, zero padded from D to DP; S and
//     dP stay in registers, and P and dS are rounded to bf16 straight from the
//     accumulator fragments into the A operand of the next product (the m16n8 C
//     layout of two neighbouring n-tiles is the m16k16 A layout), so neither goes
//     through shared memory;
//   * K3 computes S^T = K Q^T and dP^T = V dO^T directly, so P^T and dS^T are its
//     A operands; the dK and dV accumulators (16 rows x DP each per warp) stay in
//     fp32 registers across all query tiles and are written once, without atomics,
//     so the result is deterministic;
//   * ragged L: P is set to 0 by index for query rows >= Lq (their LSE is not
//     defined: exp(0 - garbage) could be inf, and inf * 0 is NaN) and for KV columns
//     >= Lk; rows past L are loaded as zeros and never stored.
// The fragment helpers (load_a, frag_to_a, mma_rows, store_rows) live in
// flash_common.cuh, shared with K5's backward (flash_stock.cu). It does not yet
// pipeline loads (cp.async / TMA) or use wgmma: later work.

#include "flash_common.cuh"

namespace {

using namespace flash;

// K3: one block per (batch*head, 64 keys); loops over all query tiles.
template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dcap,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Lq,
                         int Lk, int D, float scale) {
  using T = BwdTile<DP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kB * T::kLD;
  bf16* Qs = Vs + kB * T::kLD;
  bf16* dOs = Qs + kB * T::kLD;
  float* lse_s = reinterpret_cast<float*>(dOs + kB * T::kLD);
  float* dcap_s = lse_s + kB;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kB;
  const int key_lo = k0 + warp * 16 + g;  // this thread's key rows: key_lo, key_lo + 8

  load_tile<DP>(Ks, T::kLD, kB, k, b, h, k0, Lk, H, D);
  load_tile<DP>(Vs, T::kLD, kB, v, b, h, k0, Lk, H, D);
  float dk_acc[T::kND][4], dv_acc[T::kND][4];
#pragma unroll
  for (int n = 0; n < T::kND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const bf16* ka = Ks + warp * 16 * T::kLD;
  const bf16* va = Vs + warp * 16 * T::kLD;
  const int n_q = (Lq + kB - 1) / kB;
  for (int i = 0; i < n_q; ++i) {
    const int q0 = i * kB;
    __syncthreads();  // the previous tile's readers of Q, dO, LSE and Dcap are done
    load_tile<DP>(Qs, T::kLD, kB, q, b, h, q0, Lq, H, D);
    load_tile<DP>(dOs, T::kLD, kB, dout, b, h, q0, Lq, H, D);
    if (tid < kB) {
      const bool ok = q0 + tid < Lq;
      lse_s[tid] = ok ? lse[(size_t)bh * Lq + q0 + tid] : 0.f;
      dcap_s[tid] = ok ? dcap[(size_t)bh * Lq + q0 + tid] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys by the tile's 64 queries
    float s[T::kNT][4], dp[T::kNT][4];
#pragma unroll
    for (int nt = 0; nt < T::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t a[4], av[4];
      load_a(a, ka, T::kLD, kk, g, t4);
      load_a(av, va, T::kLD, kk, g, t4);
#pragma unroll
      for (int nt = 0; nt < T::kNT; ++nt) {
        const bf16* qb = Qs + (nt * 8 + g) * T::kLD + kk + t4 * 2;
        mma_bf16(s[nt], a, ld32(qb), ld32(qb + 8));
        const bf16* ob = dOs + (nt * 8 + g) * T::kLD + kk + t4 * 2;
        mma_bf16(dp[nt], av, ld32(ob), ld32(ob + 8));
      }
    }

    // P^T = exp(S^T * scale - LSE) and dS^T = P^T * (dP^T - Dcap), in place
#pragma unroll
    for (int nt = 0; nt < T::kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + t4 * 2 + (e & 1);
        const int key = e < 2 ? key_lo : key_lo + 8;
        const bool ok = q0 + col < Lq && key < Lk;
        const float p = ok ? __expf(s[nt][e] * scale - lse_s[col]) : 0.f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - dcap_s[col]);
      }
    }

    // dV += P^T dO and dK += dS^T Q over the tile's 64 queries
#pragma unroll
    for (int j = 0; j < T::kNT / 2; ++j) {
      uint32_t ap[4], ads[4];
      frag_to_a(ap, s[2 * j], s[2 * j + 1]);
      frag_to_a(ads, dp[2 * j], dp[2 * j + 1]);
      mma_rows<DP>(dv_acc, ap, dOs, j, g, t4);
      mma_rows<DP>(dk_acc, ads, Qs, j, g, t4);
    }
  }

  const long long row_stride = (long long)H * D;
  const size_t head = (size_t)b * Lk * H * D + (size_t)h * D;
  store_rows<DP>(dk + head, row_stride, dk_acc, scale, key_lo, Lk, D, t4);
  store_rows<DP>(dv + head, row_stride, dv_acc, 1.f, key_lo, Lk, D, t4);
}

// K4: one block per (batch*head, 64 queries); loops over all KV tiles.
template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ dcap,
                        bf16* __restrict__ dq, int H, int Lq, int Lk, int D,
                        float scale) {
  using T = BwdTile<DP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kB * T::kLD;
  bf16* Ks = dOs + kB * T::kLD;
  bf16* Vs = Ks + kB * T::kLD;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kB;
  const int row_lo = q0 + warp * 16 + g;  // this thread's query rows: row_lo, row_lo + 8

  load_tile<DP>(Qs, T::kLD, kB, q, b, h, q0, Lq, H, D);
  load_tile<DP>(dOs, T::kLD, kB, dout, b, h, q0, Lq, H, D);
  const bool ok_lo = row_lo < Lq, ok_hi = row_lo + 8 < Lq;
  const float lse_lo = ok_lo ? lse[(size_t)bh * Lq + row_lo] : 0.f;
  const float lse_hi = ok_hi ? lse[(size_t)bh * Lq + row_lo + 8] : 0.f;
  const float dcap_lo = ok_lo ? dcap[(size_t)bh * Lq + row_lo] : 0.f;
  const float dcap_hi = ok_hi ? dcap[(size_t)bh * Lq + row_lo + 8] : 0.f;
  float dq_acc[T::kND][4];
#pragma unroll
  for (int n = 0; n < T::kND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  const bf16* qa = Qs + warp * 16 * T::kLD;
  const bf16* oa = dOs + warp * 16 * T::kLD;
  const int n_kv = (Lk + kB - 1) / kB;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kB;
    __syncthreads();  // the previous tile's readers of K and V are done
    load_tile<DP>(Ks, T::kLD, kB, k, b, h, k0, Lk, H, D);
    load_tile<DP>(Vs, T::kLD, kB, v, b, h, k0, Lk, H, D);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: this warp's 16 queries by the tile's 64 keys
    float s[T::kNT][4], dp[T::kNT][4];
#pragma unroll
    for (int nt = 0; nt < T::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t a[4], ao[4];
      load_a(a, qa, T::kLD, kk, g, t4);
      load_a(ao, oa, T::kLD, kk, g, t4);
#pragma unroll
      for (int nt = 0; nt < T::kNT; ++nt) {
        const bf16* kb = Ks + (nt * 8 + g) * T::kLD + kk + t4 * 2;
        mma_bf16(s[nt], a, ld32(kb), ld32(kb + 8));
        const bf16* vb = Vs + (nt * 8 + g) * T::kLD + kk + t4 * 2;
        mma_bf16(dp[nt], ao, ld32(vb), ld32(vb + 8));
      }
    }

    // dS = P * (dP - Dcap), P = exp(S * scale - LSE), into s
#pragma unroll
    for (int nt = 0; nt < T::kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e >= 2;
        const bool ok = (hi ? ok_hi : ok_lo) && k0 + nt * 8 + t4 * 2 + (e & 1) < Lk;
        const float p = ok ? __expf(s[nt][e] * scale - (hi ? lse_hi : lse_lo)) : 0.f;
        s[nt][e] = p * (dp[nt][e] - (hi ? dcap_hi : dcap_lo));
      }
    }

    // dQ += dS K over the tile's 64 keys
#pragma unroll
    for (int jj = 0; jj < T::kNT / 2; ++jj) {
      uint32_t ads[4];
      frag_to_a(ads, s[2 * jj], s[2 * jj + 1]);
      mma_rows<DP>(dq_acc, ads, Ks, jj, g, t4);
    }
  }

  store_rows<DP>(dq + (size_t)b * Lq * H * D + (size_t)h * D, (long long)H * D, dq_acc,
                 scale, row_lo, Lq, D, t4);
}

template <int DP>
cudaError_t launch_dkv(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                       const float* lse, const float* dcap, bf16* dk, bf16* dv, int B,
                       int H, int Lq, int Lk, int D, float scale, cudaStream_t stream) {
  const size_t smem = BwdTile<DP>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lk + kB - 1) / kB, B * H);
  flash_bwd_dkv_kernel<DP><<<grid, kThreads, smem, stream>>>(q, k, v, dout, lse, dcap,
                                                             dk, dv, H, Lq, Lk, D, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                      const float* lse, const float* dcap, bf16* dq, int B, int H,
                      int Lq, int Lk, int D, float scale, cudaStream_t stream) {
  const size_t smem = BwdTile<DP>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + kB - 1) / kB, B * H);
  flash_bwd_dq_kernel<DP><<<grid, kThreads, smem, stream>>>(q, k, v, dout, lse, dcap, dq,
                                                            H, Lq, Lk, D, scale);
  return cudaGetLastError();
}

bool valid_shape(int B, int H, int Lq, int Lk, int D) {
  return B >= 1 && H >= 1 && Lq >= 1 && Lk >= 1 && D >= 8 && D % 8 == 0 && D <= 80 &&
         B * H <= 65535;
}

}  // namespace

// One instance per head dim the trained UNet gives: DP 48 (D = 40 at 512²) and 80
// (its 768² tail); D <= 48 pads to 48, D <= 80 to 80. Wider heads are refused
// (cudaErrorInvalidValue): the only one on the training path is the VAE's D = 512,
// which is frozen and never differentiated.

// K3: dK, dV (B, Lk, H*D) bf16. Returns the cudaError_t of the launch (0 = success).
extern "C" int k3_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* dcap,
                                void* dk, void* dv, int B, int H, int Lq, int Lk, int D,
                                float scale, void* stream) {
  if (!valid_shape(B, H, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
#define CL_LAUNCH(DP)                                                                    \
  return (int)launch_dkv<DP>((const bf16*)q, (const bf16*)k, (const bf16*)v,            \
                             (const bf16*)dout, (const float*)lse, (const float*)dcap,  \
                             (bf16*)dk, (bf16*)dv, B, H, Lq, Lk, D, scale,              \
                             (cudaStream_t)stream)
  if (D <= 48) CL_LAUNCH(48);
  CL_LAUNCH(80);
#undef CL_LAUNCH
}

// K4: dQ (B, Lq, H*D) bf16. Returns the cudaError_t of the launch (0 = success).
extern "C" int k4_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse, const void* dcap,
                               void* dq, int B, int H, int Lq, int Lk, int D, float scale,
                               void* stream) {
  if (!valid_shape(B, H, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
#define CL_LAUNCH(DP)                                                                   \
  return (int)launch_dq<DP>((const bf16*)q, (const bf16*)k, (const bf16*)v,            \
                            (const bf16*)dout, (const float*)lse, (const float*)dcap,  \
                            (bf16*)dq, B, H, Lq, Lk, D, scale, (cudaStream_t)stream)
  if (D <= 48) CL_LAUNCH(48);
  CL_LAUNCH(80);
#undef CL_LAUNCH
}
