// Flash attention forward, dQ and dK/dV for Hopper (sm_90a), bf16 in and
// out, f32 accumulation.  Plain C entry points, bound from Python with
// ctypes (tpumon_torch/loadgen/kernels.py); each returns cudaGetLastError().
//
// Replaces the three Pallas kernels of tpumon/loadgen/kernels.py:
//   flash_fwd_kernel     <- _flash_kernel          (launched by _flash_fwd_pallas)
//   flash_bwd_dq_kernel  <- _flash_bwd_dq_kernel   (+ _rebuild_tile)
//   flash_bwd_dkv_kernel <- _flash_bwd_dkv_kernel  (+ _rebuild_tile)
//
// Layout: q, k, v, o, dO, dQ, dK, dV are contiguous (BH, S, D) bf16; lse and
// delta are contiguous (BH, S) f32.  D is 64 or 128; S is any length (rows
// past S are zero-filled on load, masked out of the softmax and never
// stored).
//
// Design.  The Pallas grid runs its last axis in order and carries the
// online-softmax state (m, l, acc) or the dQ/dK/dV sums in VMEM scratch
// from one grid step to the next.  Hopper blocks run in no order, so each
// block here owns one output tile and walks the other sequence axis in a
// loop of its own, with the carries in registers and shared memory: one
// block per (bh, 64-row q tile) for the forward pass and dQ, one per (bh,
// 64-row k tile) for dK/dV.  No atomics.  The kernels' 64x64 tile is their
// own choice, independent of the block sizes the Python contract takes.
// Four warps each own 16 rows of the tile; tile products run on the tensor
// cores through WMMA (16x16x16 bf16 mma.sync, f32 accumulate) out of shared
// memory; the softmax and the dS arithmetic are f32 on the CUDA cores.
// Causal tiles wholly in the future are skipped (the Pallas rule
// (i+1)*bq-1 >= j*bk); dK/dV start their q loop at the first live q tile.
// A row whose running max is still -inf keeps it there without forming
// exp(-inf - -inf); the backward pass rebuilds p = exp(s - lse) and masks
// p to 0 wherever the forward pass masked s.
//
// Bound.  At the bench shapes (BH=64, S=256, D=128) the three kernels must
// move about 16, 20 and 24 MiB (each input read once, each output written
// once) and do 1.1, 1.6 and 2.2 GFLOP of tile products, so all three are
// bound by device memory, not by the tensor cores.  This design reads each
// K/V (or Q/dO) tile once per block that needs it: a q tile re-reads the
// K/V tiles at or before it, so device traffic is up to twice the bound's
// bytes at S=256, mostly served from the 50 MB L2.  What it does not do
// yet: TMA loads, wgmma, and overlapping the next tile's load with this
// tile's products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;  // query rows per tile
constexpr int BN = 64;  // key rows per tile (equal to BM: the skip rules assume it)
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int PAD_H = 8;  // bf16 row padding: 16-byte rows, shifted banks
constexpr int PAD_F = 4;  // f32 row padding

static_assert(BM == NWARPS * 16, "one warp per 16 rows of a tile");
static_assert(BM == BN, "causal skip rules assume square tiles");

// Shared-memory geometry for head dim D.  Every region is a multiple of
// 128 bytes, so regions laid end to end keep WMMA's 32-byte alignment.
template <int D>
struct Geo {
  static constexpr int LDH = D + PAD_H;   // bf16 (64 x D) tiles
  static constexpr int LDO = D + PAD_F;   // f32 (64 x D) accumulators
  static constexpr int LDS = BN + PAD_F;  // f32 (64 x 64) score tiles
  static constexpr int LDP = BN + PAD_H;  // bf16 (64 x 64) p / dS tiles
  static constexpr size_t TILE_H = size_t(BM) * LDH * sizeof(bf16);
  static constexpr size_t ACC_F = size_t(BM) * LDO * sizeof(float);
  static constexpr size_t SCORE_F = size_t(BM) * LDS * sizeof(float);
  static constexpr size_t PROB_H = size_t(BM) * LDP * sizeof(bf16);
  static constexpr size_t ROW_F = size_t(BM) * sizeof(float);
  // forward: Q K V | S | P | O
  static constexpr size_t FWD = 3 * TILE_H + SCORE_F + PROB_H + ACC_F;
  // dQ: Q dO K V | S dP | dS | dQ | lse delta
  static constexpr size_t DQ = 4 * TILE_H + 2 * SCORE_F + PROB_H + ACC_F + 2 * ROW_F;
  // dK/dV: K V Q dO | S dP | P dS | dK dV | lse delta
  static constexpr size_t DKV = 4 * TILE_H + 2 * SCORE_F + 2 * PROB_H + 2 * ACC_F + 2 * ROW_F;
  static_assert(TILE_H % 128 == 0 && ACC_F % 128 == 0 && SCORE_F % 128 == 0 &&
                    PROB_H % 128 == 0 && ROW_F % 128 == 0,
                "regions must keep 128-byte alignment");
};

// C (16 x 16*NT, f32, shared, row-major) = or += A (16 x 16*KT) * B (16*KT x 16*NT).
// A(m, k) is A[m*lda + k] when LA is row_major, A[k*lda + m] when col_major;
// B(k, n) is B[k*ldb + n] when LB is row_major, B[n*ldb + k] when col_major.
template <typename LA, typename LB, int NT, int KT, bool ACC>
__device__ __forceinline__ void warp_gemm(float* C, int ldc, const bf16* A, int lda,
                                          const bf16* B, int ldb) {
#pragma unroll 1
  for (int n = 0; n < NT; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    if constexpr (ACC) {
      wmma::load_matrix_sync(c, C + n * 16, ldc, wmma::mem_row_major);
    } else {
      wmma::fill_fragment(c, 0.0f);
    }
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
      const bf16* pa;
      const bf16* pb;
      if constexpr (std::is_same<LA, wmma::row_major>::value) {
        pa = A + k * 16;
      } else {
        pa = A + k * 16 * lda;
      }
      if constexpr (std::is_same<LB, wmma::row_major>::value) {
        pb = B + k * 16 * ldb + n * 16;
      } else {
        pb = B + n * 16 * ldb + k * 16;
      }
      wmma::load_matrix_sync(a, pa, lda);
      wmma::load_matrix_sync(b, pb, ldb);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(C + n * 16, c, ldc, wmma::mem_row_major);
  }
}

// Rows [row0, row0 + 64) of one (S, D) head into a padded shared tile, 16
// bytes a thread; rows at or past S read as zeros.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0, int S) {
  constexpr int VEC = 8;
  constexpr int PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < BM * PER_ROW; i += NTHREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) {
      val = *reinterpret_cast<const uint4*>(src + size_t(row0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * Geo<D>::LDH + c) = val;
  }
}

__device__ __forceinline__ void load_row_vec(float* dst, const float* src, int row0, int S,
                                             float fill) {
  for (int i = threadIdx.x; i < BM; i += NTHREADS) {
    dst[i] = (row0 + i < S) ? src[row0 + i] : fill;
  }
}

__device__ __forceinline__ void zero_f32(float* dst, int n) {
  for (int i = threadIdx.x; i < n; i += NTHREADS) dst[i] = 0.0f;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Rows [r0, r0+16) of a (64 x D) f32 shared tile, times `mul`, to bf16 rows
// of the output head; rows at or past S are not stored.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float* acc, int row0, int r0,
                                           int S, int lane) {
  for (int r = r0; r < r0 + 16; ++r) {
    if (row0 + r >= S) break;
    for (int c = lane; c < D; c += 32) {
      dst[size_t(row0 + r) * D + c] = __float2bfloat16(acc[r * Geo<D>::LDO + c]);
    }
  }
}

// Forward: grid (q tiles, BH).  O and lse for one 64-row q tile.
template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int S, int causal, float scale) {
  using G = Geo<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BM * G::LDH;
  bf16* Vs = Ks + BN * G::LDH;
  float* Ss = reinterpret_cast<float*>(Vs + BN * G::LDH);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + BM * G::LDS);
  float* Os = reinterpret_cast<float*>(Ps + BM * G::LDP);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const size_t head = size_t(bh) * S * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;

  load_rows<D>(Qs, q + head, q0, S);
  zero_f32(Os, BM * G::LDO);

  // online-softmax carries of this warp's 16 rows; every lane holds all
  // 16 (the values are warp-reduced, so the lanes agree)
  float m_run[16], l_run[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.0f;
  }

  const int nk = (S + BN - 1) / BN;
  const int kend = causal ? min(nk, (q0 + BM - 1) / BN + 1) : nk;
  for (int kt = 0; kt < kend; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<D>(Ks, k + head, k0, S);
    load_rows<D>(Vs, v + head, k0, S);
    __syncthreads();

    warp_gemm<wmma::row_major, wmma::col_major, BN / 16, D / 16, false>(
        Ss + r0 * G::LDS, G::LDS, Qs + r0 * G::LDH, G::LDH, Ks, G::LDH);
    __syncwarp();

#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      const int gi = q0 + r;
      float s[2];
      bool ok[2];
      float mx = -INFINITY;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        const int gj = k0 + c;
        ok[h] = gj < S && (!causal || gj <= gi);
        s[h] = ok[h] ? Ss[r * G::LDS + c] * scale : -INFINITY;
        mx = fmaxf(mx, s[h]);
      }
      mx = warp_max(mx);
      const float m_old = m_run[rr];
      const float m_new = fmaxf(m_old, mx);
      const float m_safe = (m_new == -INFINITY) ? 0.0f : m_new;
      float psum = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p = ok[h] ? expf(s[h] - m_safe) : 0.0f;
        Ps[r * G::LDP + lane + 32 * h] = __float2bfloat16(p);
        psum += p;
      }
      psum = warp_sum(psum);
      const float corr = (m_old == -INFINITY) ? 0.0f : expf(m_old - m_safe);
      for (int c = lane; c < D; c += 32) Os[r * G::LDO + c] *= corr;
      m_run[rr] = m_new;
      l_run[rr] = l_run[rr] * corr + psum;
    }
    __syncwarp();

    warp_gemm<wmma::row_major, wmma::row_major, D / 16, BN / 16, true>(
        Os + r0 * G::LDO, G::LDO, Ps + r0 * G::LDP, G::LDP, Vs, G::LDH);
  }
  __syncwarp();

#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr;
    const int gi = q0 + r;
    if (gi < S) {
      const float l_safe = fmaxf(l_run[rr], 1e-20f);
      for (int c = lane; c < D; c += 32) {
        o[head + size_t(gi) * D + c] = __float2bfloat16(Os[r * G::LDO + c] / l_safe);
      }
      if (lane == 0) lse[size_t(bh) * S + gi] = m_run[rr] + logf(l_safe);
    }
  }
}

// p and dS of one 64x64 tile from the raw scores S = Q K^T and dP = dO V^T
// (rows [r0, r0+16) of the shared tiles), both stored as bf16.
template <int D>
__device__ __forceinline__ void rebuild_rows(const float* Ss, const float* dPs, const float* lse_s,
                                             const float* delta_s, bf16* Ps, bf16* dSs, int q0,
                                             int k0, int r0, int S, int causal, float scale,
                                             int lane) {
  using G = Geo<D>;
  for (int r = r0; r < r0 + 16; ++r) {
    const int gi = q0 + r;
    const float lse_r = lse_s[r];
    const float delta_r = delta_s[r];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = lane + 32 * h;
      const int gj = k0 + c;
      const bool ok = gi < S && gj < S && (!causal || gj <= gi);
      const float p = ok ? expf(Ss[r * G::LDS + c] * scale - lse_r) : 0.0f;
      const float ds = p * (dPs[r * G::LDS + c] - delta_r) * scale;
      if (Ps != nullptr) Ps[r * G::LDP + c] = __float2bfloat16(p);
      dSs[r * G::LDP + c] = __float2bfloat16(ds);
    }
  }
}

// dQ: grid (q tiles, BH).  dQ_i = sum_j dS_ij K_j over the live k tiles.
template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int S, int causal, float scale) {
  using G = Geo<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BM * G::LDH;
  bf16* Ks = dOs + BM * G::LDH;
  bf16* Vs = Ks + BN * G::LDH;
  float* Ss = reinterpret_cast<float*>(Vs + BN * G::LDH);
  float* dPs = Ss + BM * G::LDS;
  bf16* dSs = reinterpret_cast<bf16*>(dPs + BM * G::LDS);
  float* dQs = reinterpret_cast<float*>(dSs + BM * G::LDP);
  float* lse_s = dQs + BM * G::LDO;
  float* delta_s = lse_s + BM;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const size_t head = size_t(bh) * S * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;

  load_rows<D>(Qs, q + head, q0, S);
  load_rows<D>(dOs, dout + head, q0, S);
  load_row_vec(lse_s, lse + size_t(bh) * S, q0, S, INFINITY);
  load_row_vec(delta_s, delta + size_t(bh) * S, q0, S, 0.0f);
  zero_f32(dQs, BM * G::LDO);

  const int nk = (S + BN - 1) / BN;
  const int kend = causal ? min(nk, (q0 + BM - 1) / BN + 1) : nk;
  for (int kt = 0; kt < kend; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    load_rows<D>(Ks, k + head, k0, S);
    load_rows<D>(Vs, v + head, k0, S);
    __syncthreads();

    warp_gemm<wmma::row_major, wmma::col_major, BN / 16, D / 16, false>(
        Ss + r0 * G::LDS, G::LDS, Qs + r0 * G::LDH, G::LDH, Ks, G::LDH);
    warp_gemm<wmma::row_major, wmma::col_major, BN / 16, D / 16, false>(
        dPs + r0 * G::LDS, G::LDS, dOs + r0 * G::LDH, G::LDH, Vs, G::LDH);
    __syncwarp();
    rebuild_rows<D>(Ss, dPs, lse_s, delta_s, nullptr, dSs, q0, k0, r0, S, causal, scale, lane);
    __syncwarp();
    warp_gemm<wmma::row_major, wmma::row_major, D / 16, BN / 16, true>(
        dQs + r0 * G::LDO, G::LDO, dSs + r0 * G::LDP, G::LDP, Ks, G::LDH);
  }
  __syncwarp();
  store_rows<D>(dq + head, dQs, q0, r0, S, lane);
}

// dK/dV: grid (k tiles, BH).  dV_j = sum_i P_ij^T dO_i, dK_j = sum_i dS_ij^T Q_i
// over the live q tiles.
template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int causal,
                         float scale) {
  using G = Geo<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BN * G::LDH;
  bf16* Qs = Vs + BN * G::LDH;
  bf16* dOs = Qs + BM * G::LDH;
  float* Ss = reinterpret_cast<float*>(dOs + BM * G::LDH);
  float* dPs = Ss + BM * G::LDS;
  bf16* Ps = reinterpret_cast<bf16*>(dPs + BM * G::LDS);
  bf16* dSs = Ps + BM * G::LDP;
  float* dKs = reinterpret_cast<float*>(dSs + BM * G::LDP);
  float* dVs = dKs + BN * G::LDO;
  float* lse_s = dVs + BN * G::LDO;
  float* delta_s = lse_s + BM;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BN;
  const size_t head = size_t(bh) * S * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;

  load_rows<D>(Ks, k + head, k0, S);
  load_rows<D>(Vs, v + head, k0, S);
  zero_f32(dKs, BN * G::LDO);
  zero_f32(dVs, BN * G::LDO);

  const int nq = (S + BM - 1) / BM;
  // first q tile with a row at or past k0: (i+1)*BM-1 >= k0
  const int qstart = causal ? k0 / BM : 0;
  for (int qt = qstart; qt < nq; ++qt) {
    const int q0 = qt * BM;
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_rows<D>(Qs, q + head, q0, S);
    load_rows<D>(dOs, dout + head, q0, S);
    load_row_vec(lse_s, lse + size_t(bh) * S, q0, S, INFINITY);
    load_row_vec(delta_s, delta + size_t(bh) * S, q0, S, 0.0f);
    __syncthreads();

    // this warp's 16 q rows against the block's 64 keys
    warp_gemm<wmma::row_major, wmma::col_major, BN / 16, D / 16, false>(
        Ss + r0 * G::LDS, G::LDS, Qs + r0 * G::LDH, G::LDH, Ks, G::LDH);
    warp_gemm<wmma::row_major, wmma::col_major, BN / 16, D / 16, false>(
        dPs + r0 * G::LDS, G::LDS, dOs + r0 * G::LDH, G::LDH, Vs, G::LDH);
    __syncwarp();
    rebuild_rows<D>(Ss, dPs, lse_s, delta_s, Ps, dSs, q0, k0, r0, S, causal, scale, lane);
    __syncthreads();  // the transposed products read every warp's rows

    // this warp's 16 keys: P^T and dS^T are the column-major views of P, dS
    warp_gemm<wmma::col_major, wmma::row_major, D / 16, BM / 16, true>(
        dVs + r0 * G::LDO, G::LDO, Ps + r0, G::LDP, dOs, G::LDH);
    warp_gemm<wmma::col_major, wmma::row_major, D / 16, BM / 16, true>(
        dKs + r0 * G::LDO, G::LDO, dSs + r0, G::LDP, Qs, G::LDH);
  }
  __syncwarp();
  store_rows<D>(dk + head, dKs, k0, r0, S, lane);
  store_rows<D>(dv + head, dVs, k0, r0, S, lane);
}

template <typename... KArgs, typename... Args>
int launch(void (*kern)(KArgs...), size_t smem, dim3 grid, cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kern<<<grid, NTHREADS, smem, stream>>>(args...);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int tpumon_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                     int S, int D, int causal, float scale, void* stream) {
  const dim3 grid((S + BM - 1) / BM, BH);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  bf16* O = static_cast<bf16*>(o);
  float* L = static_cast<float*>(lse);
  switch (D) {
    case 64:
      return launch(flash_fwd_kernel<64>, Geo<64>::FWD, grid, st, Q, K, V, O, L, S, causal, scale);
    case 128:
      return launch(flash_fwd_kernel<128>, Geo<128>::FWD, grid, st, Q, K, V, O, L, S, causal,
                    scale);
    default:
      return int(cudaErrorInvalidValue);
  }
}

int tpumon_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, int BH, int S, int D,
                        int causal, float scale, void* stream) {
  const dim3 grid((S + BM - 1) / BM, BH);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  const bf16* dO = static_cast<const bf16*>(dout);
  const float* L = static_cast<const float*>(lse);
  const float* Dl = static_cast<const float*>(delta);
  bf16* dQ = static_cast<bf16*>(dq);
  switch (D) {
    case 64:
      return launch(flash_bwd_dq_kernel<64>, Geo<64>::DQ, grid, st, Q, K, V, dO, L, Dl, dQ, S,
                    causal, scale);
    case 128:
      return launch(flash_bwd_dq_kernel<128>, Geo<128>::DQ, grid, st, Q, K, V, dO, L, Dl, dQ, S,
                    causal, scale);
    default:
      return int(cudaErrorInvalidValue);
  }
}

int tpumon_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv, int BH, int S,
                         int D, int causal, float scale, void* stream) {
  const dim3 grid((S + BN - 1) / BN, BH);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  const bf16* dO = static_cast<const bf16*>(dout);
  const float* L = static_cast<const float*>(lse);
  const float* Dl = static_cast<const float*>(delta);
  bf16* dK = static_cast<bf16*>(dk);
  bf16* dV = static_cast<bf16*>(dv);
  switch (D) {
    case 64:
      return launch(flash_bwd_dkv_kernel<64>, Geo<64>::DKV, grid, st, Q, K, V, dO, L, Dl, dK, dV,
                    S, causal, scale);
    case 128:
      return launch(flash_bwd_dkv_kernel<128>, Geo<128>::DKV, grid, st, Q, K, V, dO, L, Dl, dK,
                    dV, S, causal, scale);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
