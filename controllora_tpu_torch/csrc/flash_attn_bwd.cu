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
// the D-wide slice at column h*D), so the caller makes no head split, merge, pad or
// slice copies.
//
// What bounds them on the H100: at the training shapes (L = 4096, D = 40) each kernel
// is compute bound (K3 runs four L x L x D products per head, K4 three), so the work
// is in the tensor-core products, and in K3 also in the exponentials of P (one per
// score, against 4 x 48 multiply-adds).
//
// K3 is built like the forward kernels (flash_attn_fwd.cu; hopper.cuh):
//   * one block per (batch*head, 128 keys): two consumer warpgroups own 64 keys each,
//     whose K and V rows TMA loads once, 128-byte swizzled, through the same 4-D
//     tensor map of the projection as the forward;
//   * a ring of query tiles: one producer warp keeps tiles of 64 queries of Q and dO
//     (TMA), with those queries' LSE and Dcap (fp32; plain loads, since a head's row
//     of them starts at any element and a TMA box needs 16 bytes), in flight through a
//     ring of 3 stages with a full and an empty mbarrier each;
//   * four wgmma a query tile: S^T = K Q^T and dP^T = V dO^T with both operands from
//     shared memory (K-major), issued back to back; then dV += P^T dO and
//     dK += dS^T Q with P^T and dS^T rounded to bf16 from the accumulators straight
//     into the A operand, and dO and Q read through the transpose bit of bf16 wgmma,
//     as the forward reads V. S, P and dS never touch shared memory. P's columns are
//     queries, so each thread reads the LSE and Dcap of its 16 columns from the stage
//     once a tile;
//   * head dims up to 80 (the UNet's 40, 64 and 80; 40 padded to 48 in the products,
//     to 64 in shared memory by TMA zero fill). Four accumulators are live (S^T, dP^T
//     and, across all query tiles, dK and dV: up to 144 registers a thread at D 80),
//     so the producer is a whole warpgroup that gives its registers to the consumers
//     (setmaxnreg 40 / 232: its one working warp keeps a loop of loads), as the
//     forward's wide design does;
//   * no atomics: each block writes its keys' dK and dV rows once (deterministic);
//   * ragged L: TMA zero-fills rows past L; P (and so dS) is set to 0 by index for
//     queries at or past Lq, whose LSE is not defined (exp(0 - garbage) could be inf,
//     and inf * 0 is NaN); keys past Lk are computed on zeros and never stored.
//
// K4 still runs the first design: one block of 4 warps per (batch*head, 64 queries),
// each warp 16 rows against all 64 keys of a tile with mma.sync m16n8k16, the tiles
// loaded through registers into shared memory (load_tile), the accumulators in fp32
// registers written once. Its fragment helpers live in flash_common.cuh, shared with
// K5's backward (flash_stock.cu).

#include <climits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
using namespace hopper;

// ---------------------------------------------------------------- K3 (wgmma)

constexpr int kConsumerWarps = 8;  // two consumer warpgroups
constexpr int kRowBytes = 128;     // one 64-column swizzle span of bf16

struct DkvParams {
  const float* lse;   // (B*H, Lq)
  const float* dcap;  // (B*H, Lq)
  bf16* dk;
  bf16* dv;
  int B, H, Lq, Lk, D;
  float scale;       // softmax scale: dK = dS^T Q * scale
  float scale_log2;  // scale * log2(e): P = 2^(S * scale_log2 - LSE * log2(e))
};

// DS: head dim rounded up to 16 (the depth of S^T and the width of dK, dV).
template <int DS, int STAGES>
struct DkvCfg {
  static constexpr int kCh = (DS + 63) / 64;        // 64-column chunks
  static constexpr int kKeys = 128;                 // keys a block, 64 a warpgroup
  static constexpr int kQRows = 64;                 // queries a stage
  static constexpr int kKChunk = kKeys * kRowBytes;
  static constexpr int kKBytes = kCh * kKChunk;     // one of K, V
  static constexpr int kQChunk = kQRows * kRowBytes;
  static constexpr int kQBytes = kCh * kQChunk;     // one of Q, dO at one stage
  static constexpr int kStage = 2 * kQBytes + 1024; // Q, dO, LSE and Dcap (256 bytes each)
  static constexpr int kAcc = DS / 2;               // dK or dV accumulator registers
  static constexpr int kThreads = 32 * kConsumerWarps + 128;
  static constexpr size_t kSmem =
      1024 + 2 * (size_t)kKBytes + (size_t)STAGES * kStage + 8 * (2 * STAGES + 1);
  static_assert(DS % 16 == 0 && DS <= 80, "K3 covers head dims up to 80");
};

template <int DS, int STAGES>
__global__ void __launch_bounds__(DkvCfg<DS, STAGES>::kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const DkvParams p) {
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
    // the stage's LSE and Dcap values (a head's row of them starts at any element, not
    // on the 16 bytes a TMA box needs) and arrive once each.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == kConsumerWarps) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * C::kKBytes);
        for (int c = 0; c < C::kCh; ++c) {
          tma_load_4d(k_smem + c * C::kKChunk, &tk, kv_full, c * 64, h, key0, b);
          tma_load_4d(v_smem + c * C::kKChunk, &tv, kv_full, c * 64, h, key0, b);
        }
      }
      const float* lse = p.lse + (size_t)bh * p.Lq;
      const float* dcap = p.dcap + (size_t)bh * p.Lq;
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
          rows[i] = ok ? lse[q0 + i] : 0.f;
          rows[C::kQRows + i] = ok ? dcap[q0 + i] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ------------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp / 4, wl = warp % 4;
  const int g = lane >> 2, t4 = lane & 3;
  const unsigned char* k_tile = k_smem + wg * 64 * kRowBytes;  // this warpgroup's keys
  const unsigned char* v_tile = v_smem + wg * 64 * kRowBytes;
  constexpr float kLog2e = 1.4426950408889634f;

  float dk[C::kAcc], dv[C::kAcc];
#pragma unroll
  for (int i = 0; i < C::kAcc; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int j = 0; j < n_q; ++j) {
    const int s = j % STAGES;
    mbar_wait(&full[s], (j / STAGES) & 1);
    const unsigned char* q_tile = ring + (size_t)s * C::kStage;
    const unsigned char* do_tile = q_tile + C::kQBytes;
    const float* lse = reinterpret_cast<const float*>(q_tile + 2 * C::kQBytes);
    const float* dcap = lse + C::kQRows;

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries each, unscaled
    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DS / 16; ++kk)
      ss_step<64>(st, k_tile, q_tile, kk, C::kKChunk, C::kQChunk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DS / 16; ++kk)
      ss_step<64>(dpt, v_tile, do_tile, kk, C::kKChunk, C::kQChunk);
    wgmma_commit();
    wgmma_wait<1>();
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
    wgmma_wait<0>();
    fence_regs<32>(dpt);

    // dS^T = P^T * (dP^T - Dcap), by query column
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 dc = *reinterpret_cast<const float2*>(dcap + n * 8 + t4 * 2);
      dpt[4 * n] = st[4 * n] * (dpt[4 * n] - dc.x);
      dpt[4 * n + 1] = st[4 * n + 1] * (dpt[4 * n + 1] - dc.y);
      dpt[4 * n + 2] = st[4 * n + 2] * (dpt[4 * n + 2] - dc.x);
      dpt[4 * n + 3] = st[4 * n + 3] * (dpt[4 * n + 3] - dc.y);
    }

    // dV += P^T dO and dK += dS^T Q over the tile's 64 queries (4 k-steps of 16)
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      acc_to_a(pa[t], st, t);
      acc_to_a(da[t], dpt, t);
    }
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t)  // 16 queries (2 x 1024 bytes) further along K
      rs_step<DS>(dv, pa[t], desc_sw128(do_tile + t * 2048, C::kQChunk, 1024));
#pragma unroll
    for (int t = 0; t < 4; ++t)
      rs_step<DS>(dk, da[t], desc_sw128(q_tile + t * 2048, C::kQChunk, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<C::kAcc>(dv);
    fence_regs<C::kAcc>(dk);
    fence_regs<16>(&pa[0][0]);
    fence_regs<16>(&da[0][0]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // ------------------------------------------------------------------ epilogue
  const int r0 = key0 + wg * 64 + wl * 16 + g;
  const long long row_stride = (long long)p.H * p.D;
  const size_t head = (size_t)b * p.Lk * row_stride + (size_t)h * p.D;
  store_acc_bf16<DS>(p.dk + head, row_stride, dk, p.scale, p.scale, r0, p.Lk, 0, p.D, t4);
  store_acc_bf16<DS>(p.dv + head, row_stride, dv, 1.f, 1.f, r0, p.Lk, 0, p.D, t4);
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

template <int DS, int STAGES>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const DkvParams& p, cudaStream_t stream) {
  using C = DkvCfg<DS, STAGES>;
  const long long blocks = (long long)p.B * p.H * ((p.Lk + C::kKeys - 1) / C::kKeys);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  CUtensorMap tq, tdo, tk, tv;
  cudaError_t err = encode_heads(&tq, projection_view(q, p.Lq, p.H, p.D), p.B, p.H, p.Lq,
                                 p.D, C::kQRows);
  if (err == cudaSuccess)
    err = encode_heads(&tdo, projection_view(dout, p.Lq, p.H, p.D), p.B, p.H, p.Lq, p.D,
                       C::kQRows);
  if (err == cudaSuccess)
    err = encode_heads(&tk, projection_view(k, p.Lk, p.H, p.D), p.B, p.H, p.Lk, p.D, C::kKeys);
  if (err == cudaSuccess)
    err = encode_heads(&tv, projection_view(v, p.Lk, p.H, p.D), p.B, p.H, p.Lk, p.D, C::kKeys);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dkv_kernel<DS, STAGES>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, C::kThreads, C::kSmem, stream>>>(tq, tdo, tk, tv, p);
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

// Head dims up to 80 (the UNet's 40, 64 and 80; the VAE's D = 512 attention is frozen
// and never differentiated, and wider heads are refused with cudaErrorInvalidValue).
// K3's instances: D <= 48 (40 pads to 48), <= 64 and <= 80; K4's: DP 48 and 80.

// K3: dK, dV (B, Lk, H*D) bf16. Returns the cudaError_t of the launches (0 = success).
extern "C" int k3_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* dcap,
                                void* dk, void* dv, int B, int H, int Lq, int Lk, int D,
                                float scale, void* stream) {
  if (!valid_shape(B, H, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  const DkvParams p{(const float*)lse, (const float*)dcap, (bf16*)dk, (bf16*)dv, B, H,
                    Lq, Lk, D, scale, scale * 1.4426950408889634f};
  const cudaStream_t st = (cudaStream_t)stream;
  if (D <= 48) return (int)launch_dkv<48, 3>(q, k, v, dout, p, st);
  if (D <= 64) return (int)launch_dkv<64, 3>(q, k, v, dout, p, st);
  return (int)launch_dkv<80, 3>(q, k, v, dout, p, st);
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
