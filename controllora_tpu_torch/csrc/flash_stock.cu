// K5: the stock flash attention's backward for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels that the JAX package reaches through
// controllora_tpu/ops/attention.py::_flash_stock (jax's bundled
// jax/experimental/pallas/ops/tpu/flash_attention.py):
//   forward  _flash_attention_kernel      -> k5_stock_flash_fwd, the wgmma forward
//                                            kernel of K1/K2 (flash_attn_fwd.cu)
//   dK, dV   _flash_attention_dkv_kernel  -> k5_stock_flash_bwd_dkv (here)
//   dQ       _flash_attention_dq_kernel   -> k5_stock_flash_bwd_dq (here)
//
// The stock contract, which differs from K2-K4 (flash_attn_*.cu):
//   * a runtime softmax scale, applied after Q K^T (not fixed to D^-1/2);
//   * the forward keeps two fp32 residuals per query row, the row max m of the
//     scaled logits and the normalizer l = sum exp(S * scale - m) (the stock kernel
//     stores each lane-broadcast as (B, H, L, 128); here one value a row, (B, H, L));
//   * the backward recomputes P = exp(S * scale - m) / l, then
//       dV += P^T dO,  dS = P * (dP - di) * scale,  dK += dS^T Q,  dQ += dS K,
//     with di = rowsum(dO * O) computed by the caller in fp32 (the stock
//     _flash_attention_bwd does it outside its kernels);
//   * whole tiles: L is a multiple of the stock block (>= 128), so nothing is masked;
//   * (B, H, L, D) tensors given by element strides (D contiguous), so the caller's
//     head-split views of the (B, L, H*D) projections need no copy.
//
// What bounds it on the H100: at the training shape (16, 8, 4096, 40) both kernels are
// compute bound (dK/dV runs four L x L x D products per head, dQ three, against ~8 L D
// bytes per head), so the work is in tensor-core products: mma.sync m16n8k16, bf16
// in, fp32 accumulate. The design is K4's (flash_attn_bwd.cu): one block per
// (batch*head, 64-row tile), S and dP in registers, P and dS rounded to bf16 straight
// into the next product's A operand, the dK/dV (or dQ) accumulators in fp32 registers
// written once, without atomics (deterministic). It does not yet pipeline loads or
// use wgmma: K3's Hopper design (flash_attn_bwd.cu) is the template for dK/dV.

#include "flash_common.cuh"

namespace {

using namespace flash;

// Element strides of a (B, H, L, D) tensor whose last dimension is contiguous.
struct Strides {
  long long b, h, l;
};

__device__ __forceinline__ long long head_offset(Strides s, int b, int h) {
  return b * s.b + h * s.h;
}

// ---------------------------------------------------------------- dK, dV

// One block per (batch*head, 64 keys); loops over all query tiles.
template <int DP>
__global__ void __launch_bounds__(kThreads)
    k5_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ m, const float* __restrict__ l,
                  const float* __restrict__ di, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int H, int Lq, int Lk, int D, Strides qs,
                  Strides ks, float scale) {
  using T = BwdTile<DP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kB * T::kLD;
  bf16* Qs = Vs + kB * T::kLD;
  bf16* dOs = Qs + kB * T::kLD;
  float* m_s = reinterpret_cast<float*>(dOs + kB * T::kLD);
  float* il_s = m_s + kB;  // 1 / l
  float* di_s = il_s + kB;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kB;
  const long long qoff = head_offset(qs, b, h), koff = head_offset(ks, b, h);

  load_rows<DP>(Ks, T::kLD, kB, k + koff, ks.l, k0, D);
  load_rows<DP>(Vs, T::kLD, kB, v + koff, ks.l, k0, D);
  float dk_acc[T::kND][4], dv_acc[T::kND][4];
#pragma unroll
  for (int n = 0; n < T::kND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const bf16* ka = Ks + warp * 16 * T::kLD;
  const bf16* va = Vs + warp * 16 * T::kLD;
  for (int q0 = 0; q0 < Lq; q0 += kB) {
    __syncthreads();  // the previous tile's readers of Q, dO, m, l and di are done
    load_rows<DP>(Qs, T::kLD, kB, q + qoff, qs.l, q0, D);
    load_rows<DP>(dOs, T::kLD, kB, dout + qoff, qs.l, q0, D);
    if (tid < kB) {
      const size_t row = (size_t)bh * Lq + q0 + tid;
      m_s[tid] = m[row];
      il_s[tid] = 1.f / l[row];
      di_s[tid] = di[row];
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

    // P^T = exp(S^T * scale - m) / l and dS^T = P^T * (dP^T - di) * scale, in place
#pragma unroll
    for (int nt = 0; nt < T::kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + t4 * 2 + (e & 1);
        const float p = __expf(s[nt][e] * scale - m_s[col]) * il_s[col];
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - di_s[col]) * scale;
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

  const int key_lo = k0 + warp * 16 + g;  // this thread's key rows: key_lo, key_lo + 8
  store_rows<DP>(dk + koff, ks.l, dk_acc, 1.f, key_lo, Lk, D, t4);
  store_rows<DP>(dv + koff, ks.l, dv_acc, 1.f, key_lo, Lk, D, t4);
}

// ---------------------------------------------------------------- dQ

// One block per (batch*head, 64 queries); loops over all KV tiles.
template <int DP>
__global__ void __launch_bounds__(kThreads)
    k5_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ m, const float* __restrict__ l,
                 const float* __restrict__ di, bf16* __restrict__ dq, int H, int Lq,
                 int Lk, int D, Strides qs, Strides ks, float scale) {
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
  const long long qoff = head_offset(qs, b, h), koff = head_offset(ks, b, h);

  load_rows<DP>(Qs, T::kLD, kB, q + qoff, qs.l, q0, D);
  load_rows<DP>(dOs, T::kLD, kB, dout + qoff, qs.l, q0, D);
  const size_t lo = (size_t)bh * Lq + row_lo, hi = lo + 8;
  const float m_lo = m[lo], m_hi = m[hi];
  const float il_lo = 1.f / l[lo], il_hi = 1.f / l[hi];
  const float di_lo = di[lo], di_hi = di[hi];
  float dq_acc[T::kND][4];
#pragma unroll
  for (int n = 0; n < T::kND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  const bf16* qa = Qs + warp * 16 * T::kLD;
  const bf16* oa = dOs + warp * 16 * T::kLD;
  for (int k0 = 0; k0 < Lk; k0 += kB) {
    __syncthreads();  // the previous tile's readers of K and V are done
    load_rows<DP>(Ks, T::kLD, kB, k + koff, ks.l, k0, D);
    load_rows<DP>(Vs, T::kLD, kB, v + koff, ks.l, k0, D);
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

    // dS = P * (dP - di) * scale, P = exp(S * scale - m) / l, into s
#pragma unroll
    for (int nt = 0; nt < T::kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool upper = e >= 2;
        const float p = __expf(s[nt][e] * scale - (upper ? m_hi : m_lo)) *
                        (upper ? il_hi : il_lo);
        s[nt][e] = p * (dp[nt][e] - (upper ? di_hi : di_lo)) * scale;
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

  store_rows<DP>(dq + qoff, qs.l, dq_acc, 1.f, row_lo, Lq, D, t4);
}

// ---------------------------------------------------------------- launches

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int DP>
cudaError_t launch_dkv(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                       const float* m, const float* l, const float* di, bf16* dk,
                       bf16* dv, int B, int H, int Lq, int Lk, int D, Strides qs,
                       Strides ks, float scale, cudaStream_t stream) {
  const size_t smem = BwdTile<DP>::kSmem;
  cudaError_t err = set_smem(k5_dkv_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  k5_dkv_kernel<DP><<<dim3(Lk / kB, B * H), kThreads, smem, stream>>>(
      q, k, v, dout, m, l, di, dk, dv, H, Lq, Lk, D, qs, ks, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                      const float* m, const float* l, const float* di, bf16* dq, int B,
                      int H, int Lq, int Lk, int D, Strides qs, Strides ks, float scale,
                      cudaStream_t stream) {
  const size_t smem = BwdTile<DP>::kSmem;
  cudaError_t err = set_smem(k5_dq_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  k5_dq_kernel<DP><<<dim3(Lq / kB, B * H), kThreads, smem, stream>>>(
      q, k, v, dout, m, l, di, dq, H, Lq, Lk, D, qs, ks, scale);
  return cudaGetLastError();
}

// Whole 64-row tiles on both sides, head dims the instances take, one grid row per
// (batch, head).
bool valid_shape(int B, int H, int Lq, int Lk, int D) {
  return B >= 1 && H >= 1 && Lq >= kB && Lk >= kB && Lq % kB == 0 && Lk % kB == 0 &&
         D >= 8 && D % 8 == 0 && D <= 80 && B * H <= 65535;
}

}  // namespace

// One instance per head dim the trained UNet gives on this path: DP 48 (SD1.5's
// D = 40) and 80 (its 768² tail); any other D (a multiple of 8) is zero padded to the
// next instance; wider heads are refused (cudaErrorInvalidValue): the VAE encoder's
// D = 512 attention is frozen and never differentiated. Each entry point returns the
// cudaError_t of its launch.

// dK, dV with the strides of k (v, dk and dv share them); dout shares q's.
extern "C" int k5_stock_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                      const void* dout, const void* m, const void* l,
                                      const void* di, void* dk, void* dv, int B, int H,
                                      int Lq, int Lk, int D, long long q_sb,
                                      long long q_sh, long long q_sl, long long k_sb,
                                      long long k_sh, long long k_sl, float scale,
                                      void* stream) {
  if (!valid_shape(B, H, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_sl}, ks{k_sb, k_sh, k_sl};
#define CL_LAUNCH(DP)                                                                  \
  return (int)launch_dkv<DP>((const bf16*)q, (const bf16*)k, (const bf16*)v,           \
                             (const bf16*)dout, (const float*)m, (const float*)l,      \
                             (const float*)di, (bf16*)dk, (bf16*)dv, B, H, Lq, Lk, D,  \
                             qs, ks, scale, (cudaStream_t)stream)
  if (D <= 48) CL_LAUNCH(48);
  CL_LAUNCH(80);
#undef CL_LAUNCH
}

// dQ with the strides of q (dout and dq share them).
extern "C" int k5_stock_flash_bwd_dq(const void* q, const void* k, const void* v,
                                     const void* dout, const void* m, const void* l,
                                     const void* di, void* dq, int B, int H, int Lq,
                                     int Lk, int D, long long q_sb, long long q_sh,
                                     long long q_sl, long long k_sb, long long k_sh,
                                     long long k_sl, float scale, void* stream) {
  if (!valid_shape(B, H, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_sl}, ks{k_sb, k_sh, k_sl};
#define CL_LAUNCH(DP)                                                                  \
  return (int)launch_dq<DP>((const bf16*)q, (const bf16*)k, (const bf16*)v,            \
                            (const bf16*)dout, (const float*)m, (const float*)l,       \
                            (const float*)di, (bf16*)dq, B, H, Lq, Lk, D, qs, ks,      \
                            scale, (cudaStream_t)stream)
  if (D <= 48) CL_LAUNCH(48);
  CL_LAUNCH(80);
#undef CL_LAUNCH
}
