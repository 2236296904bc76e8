// Non-causal dense flash attention in fp32, forward and backward, for NVIDIA Hopper
// (sm_90a): the fp32 route of K1-K5.
//
// The JAX package's flash kernels take any float dtype: they cast each block to fp32
// and multiply with fp32 results, and write their outputs in the input dtype. Its fp32
// stacks (training under --mixed_precision no, the smoke stacks, the SDXL refiner as
// scripts/serve.py serves it) reach them with fp32 inputs. The wgmma kernels of
// flash_attn_fwd.cu and flash_attn_bwd.cu take bf16 only; this file holds their fp32
// counterparts, one kernel per role as there:
//   flash_fwd_f32_kernel      K1  controllora_tpu/ops/pallas_attention.py::_attn_kernel
//                                 (entry point k1_biased_flash_fwd_f32, with
//                                 bias_add_f32_kernel adding the biases in fp32 first,
//                                 as the JAX caller adds them),
//                             K2  controllora_tpu/ops/pallas_attention_vjp.py::_fwd_kernel
//                                 (k2_flash_fwd_lse_f32: O and LSE),
//                             K5  the forward of jax's stock TPU flash attention
//                                 (jax/experimental/pallas/ops/tpu/flash_attention.py::
//                                 _flash_attention_kernel, reached through
//                                 controllora_tpu/ops/attention.py::_flash_stock;
//                                 k5_stock_flash_fwd_f32: O, m and l);
//   flash_bwd_dkv_f32_kernel  K3  pallas_attention_vjp.py::_bwd_dkv_kernel
//                                 (k3_flash_bwd_dkv_f32) and K5's
//                                 _flash_attention_dkv_kernel (k5_stock_flash_bwd_dkv_f32);
//   flash_bwd_dq_f32_kernel   K4  pallas_attention_vjp.py::_bwd_dq_kernel
//                                 (k4_flash_bwd_dq_f32) and K5's _flash_attention_dq_kernel
//                                 (k5_stock_flash_bwd_dq_f32).
// Each entry point has the C signature of its bf16 namesake, so the wrappers in
// ops/flash_attention.py and ops/flash_stock.py pick one by the inputs' dtype.
//
// What bounds them on the H100: the products. At the fp32 paths' shapes (L 4096, D
// 8-80 or 512) the work is 4 L^2 D flops a head forward (dK/dV 8, dQ 6) against ~16 L D
// bytes, so operations bound them by far. The products must be fp32-accurate: the JAX
// kernels multiply fp32 blocks with fp32 results, and the port runs fp32 with TF32
// off. The tensor cores reach fp32 accuracy only as 3xTF32 (three TF32 products a
// product, 165 TFLOP/s of the card's 495), and tf32 wgmma reads its B operand K-major
// only, so P V and the backward's products would need V, dO, Q and K transposed in
// shared memory. This first design runs every product as fp32 FMA on the CUDA cores
// (67 TFLOP/s), as an SGEMM does:
//   * a block keeps R stationary rows (queries for the forward and dQ, keys for dK/dV)
//     in shared memory and streams the other side's rows through two stages filled by
//     cp.async (16 bytes a copy, zero filled past L and past D), so the next tile's
//     loads overlap this tile's products;
//   * register micro-tiles: thread t owns the stationary rows (t / CG) * TM .. + TM; in
//     a product over the head dim (S = Q K^T, dP = dO V^T) its columns are the streamed
//     rows t % CG + j * CG, each read as float4 along the head dim; in a product into
//     the head dim (O += P V, dV += P^T dO, dK += dS^T Q, dQ += dS K) its columns are the
//     float4 chunks t % CG + c * CG of the head. Shared rows are DP + 4 floats apart, so
//     the float4 reads of distinct rows fall in distinct banks;
//   * the online softmax in registers: a row's scores sit in the CG neighbouring lanes
//     of its row group, which reduce the row max with shuffles; P (and dS) go through
//     shared memory from the layout of the first product to that of the second;
//   * head dims padded to DP = 16, 32, 48, 64 or 80 (64 stationary rows, 32-row stream
//     tiles, 128 threads), and D up to 512 padded to 512 (32 rows, 16-row tiles, 256
//     threads: 200 KB of shared memory). No key split: the 32- and 64-row query tiles
//     give batch-1 shapes enough blocks;
//   * ragged L: scores of keys at or past Lk are -inf in the forward and P = 0 by index
//     in the backward (queries past Lq for dK/dV, keys past Lk for dQ); stationary rows
//     past L are computed on zeros and never stored;
//   * the softmax scale is a runtime argument of either sign, the forward tracks its
//     running max on S * scale * log2(e), and K5's backward forms LSE = m + log(l) as it
//     reads a row, as the bf16 kernels do.
// Loads are plain (cp.async): a 16-byte aligned base, D and every element stride a
// multiple of 4 (ops/flash_attention.py::vector_geometry checks the same on the host).
// The kernels' launch bounds name one block an SM as the minimum: with the thread count
// alone, ptxas capped some instances at 96 or 128 registers and spilled.

#include <algorithm>
#include <climits>

#include "hopper.cuh"

namespace {

using hopper::HeadView;
using hopper::projection_view;
using hopper::smem_u32;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------- copies

// 16 bytes from global to shared memory without passing through registers; zeros where
// !ok (then nothing is read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
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

template <int DP, int R, int C, int CG, int NT>
__global__ void __launch_bounds__(NT, 1) flash_fwd_f32_kernel(const FwdParams p) {
  using T = Tile<DP, R, C, CG, NT>;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // R query rows
  float* kv_s = q_s + R * T::kStride;            // two stages of K and V, C rows each
  float* p_s = kv_s + 4 * C * T::kStride;        // P, R x C

  // block -> (batch, head, query tile)
  const int q_tiles = (p.Lq + R - 1) / R;
  const int qt = blockIdx.x % q_tiles, bh = blockIdx.x / q_tiles;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = qt * R;
  const float* qg = static_cast<const float*>(p.q.base) + b * p.q.sb + h * p.q.sh;
  const float* kg = static_cast<const float*>(p.k.base) + b * p.k.sb + h * p.k.sh;
  const float* vg = static_cast<const float*>(p.v.base) + b * p.v.sb + h * p.v.sh;
  const int n_tiles = (p.Lk + C - 1) / C;

  load_rows<T, R>(q_s, qg, p.q.sl, q0, p.Lq, p.D);
  load_rows<T, C>(kv_s, kg, p.k.sl, 0, p.Lk, p.D);
  load_rows<T, C>(kv_s + C * T::kStride, vg, p.v.sl, 0, p.Lk, p.D);
  cp_async_commit();

  const int rg = threadIdx.x / CG, cg = threadIdx.x % CG;
  float4 o[T::kTM][T::kCD];
  zero<T>(o);
  float m[T::kTM], l[T::kTM];  // running max of S * scale * log2(e), this thread's sums
#pragma unroll
  for (int i = 0; i < T::kTM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j is in; every thread is done with tile j - 1 and its P
    if (j + 1 < n_tiles) {
      float* next = kv_s + ((j + 1) & 1) * 2 * C * T::kStride;
      load_rows<T, C>(next, kg, p.k.sl, (j + 1) * C, p.Lk, p.D);
      load_rows<T, C>(next + C * T::kStride, vg, p.v.sl, (j + 1) * C, p.Lk, p.D);
      cp_async_commit();
    }
    const float* ks = kv_s + (j & 1) * 2 * C * T::kStride;
    const float* vs = ks + C * T::kStride;

    float s[T::kTM][T::kTN];
    dot_rows<T>(s, q_s, ks, rg, cg);
    const int key0 = j * C;
#pragma unroll
    for (int i = 0; i < T::kTM; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < T::kTN; ++t) {
        s[i][t] = key0 + cg + t * CG < p.Lk ? s[i][t] * p.scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[i][t]);
      }
#pragma unroll
      for (int off = 1; off < CG; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);  // finite: key0 < Lk is in every row's reduction
      const float alpha = exp2f(m[i] - mn);
      m[i] = mn;
      float sum = 0.f;
      float* prow = p_s + (rg * T::kTM + i) * T::kPStride + cg;
#pragma unroll
      for (int t = 0; t < T::kTN; ++t) {
        const float e = exp2f(s[i][t] - mn);
        sum += e;
        prow[t * CG] = e;
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < T::kCD; ++c) scale4(o[i][c], alpha);
    }
    __syncthreads();  // P is in
    acc_rows<T>(o, p_s, vs, rg, cg);
  }

  // ------------------------------------------------------------------ epilogue
#pragma unroll
  for (int i = 0; i < T::kTM; ++i)
#pragma unroll
    for (int off = 1; off < CG; off <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
#pragma unroll
  for (int i = 0; i < T::kTM; ++i) {
    const int row = q0 + rg * T::kTM + i;
    if (row >= p.Lq) continue;
    store_row<T>(p.o + b * p.o_sb + h * p.o_sh + row * p.o_sl, o, i, 1.f / l[i], cg, p.D);
    if (cg == 0) {
      const size_t r = (size_t)bh * p.Lq + row;
      if (p.lse != nullptr) p.lse[r] = (m[i] + log2f(l[i])) * kLn2;
      if (p.m != nullptr) {  // m back from base 2; l is the same sum in either base
        p.m[r] = m[i] * kLn2;
        p.l[r] = l[i];
      }
    }
  }
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

// dK, dV: R keys a block (K and V stationary), C-query stages of Q, dO and their row
// terms (LSE or m, l, Dcap).
template <int DP, int R, int C, int CG, int NT>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dkv_f32_kernel(const BwdParams p) {
  using T = Tile<DP, R, C, CG, NT>;
  constexpr int kStage = 2 * C * T::kStride + 3 * C;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + R * T::kStride;
  float* ring = v_s + R * T::kStride;  // two stages
  float* p_s = ring + 2 * kStage;      // P^T, R x C
  float* ds_s = p_s + R * T::kPStride;  // dS^T

  // block -> (batch*head, key tile)
  const int k_tiles = (p.Lk + R - 1) / R;
  const int kt = blockIdx.x % k_tiles, bh = blockIdx.x / k_tiles;
  const int b = bh / p.H, h = bh % p.H;
  const int key0 = kt * R;
  const float* qg = static_cast<const float*>(p.q.base) + b * p.q.sb + h * p.q.sh;
  const float* dog = static_cast<const float*>(p.dout.base) + b * p.dout.sb + h * p.dout.sh;
  const float* kg = static_cast<const float*>(p.k.base) + b * p.k.sb + h * p.k.sh;
  const float* vg = static_cast<const float*>(p.v.base) + b * p.v.sb + h * p.v.sh;
  const size_t row0 = (size_t)bh * p.Lq;
  const int n_q = (p.Lq + C - 1) / C;

  auto load_stage = [&](int j) {
    float* stage = ring + (j & 1) * kStage;
    const int q0 = j * C;
    load_rows<T, C>(stage, qg, p.q.sl, q0, p.Lq, p.D);
    load_rows<T, C>(stage + C * T::kStride, dog, p.dout.sl, q0, p.Lq, p.D);
    float* rows = stage + 2 * C * T::kStride;
    for (int i = threadIdx.x; i < C; i += NT) {  // 0 past Lq: masked by index below
      const bool ok = q0 + i < p.Lq;
      const size_t r = ok ? row0 + q0 + i : 0;
      cp_async4(rows + i, p.lse + r, ok);
      if (p.l != nullptr) cp_async4(rows + C + i, p.l + r, ok);
      cp_async4(rows + 2 * C + i, p.dcap + r, ok);
    }
  };
  load_rows<T, R>(k_s, kg, p.k.sl, key0, p.Lk, p.D);
  load_rows<T, R>(v_s, vg, p.v.sl, key0, p.Lk, p.D);
  load_stage(0);
  cp_async_commit();

  const int rg = threadIdx.x / CG, cg = threadIdx.x % CG;
  float4 dk[T::kTM][T::kCD], dv[T::kTM][T::kCD];
  zero<T>(dk);
  zero<T>(dv);

  for (int j = 0; j < n_q; ++j) {
    cp_async_wait_all();
    __syncthreads();  // stage j is in; every thread is done with stage j - 1
    if (j + 1 < n_q) {
      load_stage(j + 1);
      cp_async_commit();
    }
    const float* qs = ring + (j & 1) * kStage;
    const float* dos = qs + C * T::kStride;
    const float* rows = dos + C * T::kStride;

    // S^T = K Q^T (unscaled), then P^T = exp(S^T * scale - LSE) by query column, 0 for
    // queries at or past Lq. P^T goes to shared memory before dP^T is formed, so that
    // only one of the two score tiles is live beside the dK and dV accumulators.
    const int q0 = j * C;
    {
      float st[T::kTM][T::kTN];
      dot_rows<T>(st, k_s, qs, rg, cg);
#pragma unroll
      for (int t = 0; t < T::kTN; ++t) {
        const int col = cg + t * CG;
        const bool ok = q0 + col < p.Lq;
        const float lse2 =
            (p.l == nullptr ? rows[col] : rows[col] + logf(rows[C + col])) * kLog2e;
#pragma unroll
        for (int i = 0; i < T::kTM; ++i)
          p_s[(rg * T::kTM + i) * T::kPStride + col] =
              ok ? exp2f(fmaf(st[i][t], p.scale_log2, -lse2)) : 0.f;
      }
    }
    // dP^T = V dO^T (unscaled), dS^T = P^T (dP^T - Dcap): each thread reads back the P^T
    // values it wrote
    {
      float dpt[T::kTM][T::kTN];
      dot_rows<T>(dpt, v_s, dos, rg, cg);
#pragma unroll
      for (int t = 0; t < T::kTN; ++t) {
        const int col = cg + t * CG;
        const float dc = rows[2 * C + col];
#pragma unroll
        for (int i = 0; i < T::kTM; ++i) {
          const int at = (rg * T::kTM + i) * T::kPStride + col;
          ds_s[at] = p_s[at] * (dpt[i][t] - dc);
        }
      }
    }
    __syncthreads();  // P^T and dS^T are in
    acc_rows<T>(dv, p_s, dos, rg, cg);  // dV += P^T dO
    acc_rows<T>(dk, ds_s, qs, rg, cg);  // dK += dS^T Q
  }

#pragma unroll
  for (int i = 0; i < T::kTM; ++i) {
    const int row = key0 + rg * T::kTM + i;
    if (row >= p.Lk) continue;
    const long long at = b * p.sb + h * p.sh + row * p.sl;
    store_row<T>(p.out0 + at, dk, i, p.scale, cg, p.D);
    store_row<T>(p.out1 + at, dv, i, 1.f, cg, p.D);
  }
}

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
size_t fwd_smem() {
  return sizeof(float) * ((size_t)(T::kR + 4 * T::kC) * T::kStride + (size_t)T::kR * T::kPStride);
}

template <class T>
size_t dkv_smem() {
  return sizeof(float) * (2 * (size_t)T::kR * T::kStride +
                          2 * (2 * (size_t)T::kC * T::kStride + 3 * T::kC) +
                          2 * (size_t)T::kR * T::kPStride);
}

template <class T>
size_t dq_smem() {
  return sizeof(float) * ((2 * (size_t)T::kR + 4 * (size_t)T::kC) * T::kStride +
                          (size_t)T::kR * T::kPStride);
}

// Set the kernel's dynamic shared memory and launch it over `blocks` blocks.
template <class Kernel, class P>
cudaError_t run(Kernel kernel, long long blocks, int threads, size_t smem, const P& p,
                cudaStream_t stream) {
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Instances by head dim: D padded to DP columns in shared memory (zero filled).
template <class F>
cudaError_t with_fwd_tile(int D, F&& f) {
  if (D < 8 || D % 8 != 0 || D > 512) return cudaErrorInvalidValue;
  if (D <= 16) return f(Tile<16, 64, 32, 4, 128>{});
  if (D <= 32) return f(Tile<32, 64, 32, 8, 128>{});
  if (D <= 48) return f(Tile<48, 64, 32, 4, 128>{});
  if (D <= 64) return f(Tile<64, 64, 32, 8, 128>{});
  if (D <= 80) return f(Tile<80, 64, 32, 4, 128>{});
  return f(Tile<512, 32, 16, 16, 256>{});
}

template <class F>
cudaError_t with_bwd_tile(int D, F&& f) {
  if (D < 8 || D % 8 != 0 || D > 80) return cudaErrorInvalidValue;
  if (D <= 16) return f(Tile<16, 64, 32, 4, 128>{});
  if (D <= 32) return f(Tile<32, 64, 32, 8, 128>{});
  if (D <= 48) return f(Tile<48, 64, 32, 4, 128>{});
  if (D <= 64) return f(Tile<64, 64, 32, 8, 128>{});
  return f(Tile<80, 64, 32, 4, 128>{});
}

// The plain loads' alignment: a 16-byte aligned base and element strides in whole
// float4s (D % 8 == 0 is checked with the instance).
bool aligned(const HeadView& x) {
  return reinterpret_cast<uintptr_t>(x.base) % 16 == 0 && x.sb % 4 == 0 && x.sh % 4 == 0 &&
         x.sl % 4 == 0 && x.sb >= 0 && x.sh >= 0 && x.sl >= 0;
}

cudaError_t run_fwd(const FwdParams& p, cudaStream_t stream) {
  if (p.B < 1 || p.H < 1 || p.Lq < 1 || p.Lk < 1 || !aligned(p.q) || !aligned(p.k) ||
      !aligned(p.v) || (p.m == nullptr) != (p.l == nullptr))
    return cudaErrorInvalidValue;
  return with_fwd_tile(p.D, [&](auto tile) {
    using T = decltype(tile);
    const long long blocks = (long long)p.B * p.H * ((p.Lq + T::kR - 1) / T::kR);
    return run(flash_fwd_f32_kernel<T::kDP, T::kR, T::kC, T::kCG, T::kNT>, blocks, T::kNT,
               fwd_smem<T>(), p, stream);
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
  return with_bwd_tile(p.D, [&](auto tile) {
    using T = decltype(tile);
    const long long blocks = (long long)p.B * p.H * ((p.Lk + T::kR - 1) / T::kR);
    return run(flash_bwd_dkv_f32_kernel<T::kDP, T::kR, T::kC, T::kCG, T::kNT>, blocks,
               T::kNT, dkv_smem<T>(), p, stream);
  });
}

cudaError_t run_dq(const Views& x, const BwdParams& p, cudaStream_t stream) {
  if (!valid_bwd(x, p.B, p.H, p.Lq, p.Lk)) return cudaErrorInvalidValue;
  return with_bwd_tile(p.D, [&](auto tile) {
    using T = decltype(tile);
    const long long blocks = (long long)p.B * p.H * ((p.Lq + T::kR - 1) / T::kR);
    return run(flash_bwd_dq_f32_kernel<T::kDP, T::kR, T::kC, T::kCG, T::kNT>, blocks,
               T::kNT, dq_smem<T>(), p, stream);
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

// The tiles of the fp32 forward instance that takes head dim D: query rows a block,
// keys a tile, and 1: it never splits the key range (ops/flash_attention.py::kv_splits).
// The fp32 namesake of flash_attn_fwd.cu's flash_fwd_tiles.
extern "C" int flash_fwd_tiles_f32(int D, int* rows, int* keys, int* max_splits) {
  return (int)with_fwd_tile(D, [&](auto tile) {
    using T = decltype(tile);
    *rows = T::kR;
    *keys = T::kC;
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
