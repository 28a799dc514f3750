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
// Shared design.  The Pallas grid runs its last axis in order and carries
// the online-softmax state (m, l, acc) or the dQ/dK/dV sums in VMEM scratch
// from one grid step to the next.  Hopper blocks run in no order, so each
// block here owns one output tile and walks the other sequence axis in a
// loop of its own: one block per (bh, 64-row q tile) for the forward pass
// and dQ, one per (bh, 64-key tile) for dK/dV.  Each output element is
// summed in a fixed order by one thread: no atomics, deterministic.
// 64-row tiles on both axes, so the Pallas causal skip rule
// (i+1)*bq-1 >= j*bk keeps key tile j for q tile i iff j <= i.  A row
// whose running max is still -inf
// never forms exp(-inf - -inf); the backward pass rebuilds p = exp(s - lse)
// and masks p to 0 wherever the forward pass masked s.
//
// flash_fwd_kernel.  One warpgroup (four warps) owns 64 q rows.  Q and the
// K/V tiles sit in shared memory in the 128-byte-swizzle layout that the
// warpgroup products read: S = Q K^T is wgmma m64n64k16 with both operands
// from shared memory, straight into registers; the online softmax runs on
// that accumulator (each warp holds its 16 rows as mma.sync C fragments:
// one FFMA and one ex2 an element, a row's max and sum over the four lanes
// that share it, two shuffles each); P is packed to bf16 straight from the
// accumulator into the A registers of O += P V, wgmma m64n{D}k16 with V
// read transposed from shared memory; O (64 x D f32) is rescaled and summed
// in registers.  K/V tiles stream through a two-stage ring with cp.async
// (16 bytes a thread, zero fill past S; a proxy fence hands them to the
// tensor cores): tile j+1 is in flight while tile j's products run, one
// barrier a tile.  The epilogue stages O as bf16 in the Q tile and writes
// 16-byte stores.  82 KiB of shared memory at D=128: two blocks an SM.
// Blocks run in order of work, the q tiles with the most live key tiles
// first, except that the second round of blocks (one an SM) runs lightest
// first, so that the two blocks an SM holds balance each other.
//
// flash_bwd_dq_kernel.  The forward kernel's machinery on other tiles: one
// warpgroup owns 64 q rows, with Q and dO resident in shared memory in the
// same swizzled layout, and each thread keeps the lse (in log2 units) and
// delta of its two rows in registers, loaded once.  For each live key tile,
// S = Q K^T and dP = dO V^T are two groups of wgmma m64n64k16 from shared
// memory, committed apart, so p = exp2(s*scale*log2e - lse*log2e) runs on
// S's accumulator while dP's product finishes.  dS = p (dP - delta) scale is
// formed on the accumulators and packed to bf16 straight into the A
// registers of dQ += dS K, wgmma m64n{D}k16 with K read transposed, as the
// forward pass reads V.  dQ (64 x D f32) stays in registers for the whole
// loop.  K and V stream through the forward pass's two-stage ring; its one
// barrier a tile also keeps a stage from being refilled before every warp's
// dQ product has read its K.  Block order and epilogue (dQ staged as bf16 in
// the Q tile, 16-byte stores) are the forward pass's.  97 KiB of shared
// memory at D=128: two blocks an SM.
//
// flash_bwd_dkv_kernel.  Each block owns one 64-key tile, K and V resident
// in shared memory; four warps each own 16 keys and hold their dK and dV
// (16 x D f32) in registers.  For each live q tile a warp forms the
// transposed tiles S^T = K Q^T and dP^T = V dO^T directly (keys as rows: A
// fragments from its own K/V rows, B fragments from Q/dO rows), then
// p = exp(s*scale - lse) and dS = p (dP - delta) scale in registers, with
// lse and delta per column.  With keys as rows, P^T and dS^T are
// accumulator fragments that pack straight into the A fragments of
// dV += P^T dO and dK += dS^T Q (B fragments through ldmatrix.trans): no
// score tile goes through shared memory.  At D=128 a pass covers 32 q
// columns, so that its S^T and dP^T fit in registers beside dK and dV
// without spilling.  Q, dO, lse and delta stream through a two-stage
// cp.async ring; the epilogue stages dK and dV in the warp's own K and V
// rows for 16-byte stores.  103 KiB of shared memory at D=128: two blocks
// an SM.  Key tiles with the most live q tiles go first.
//
// Bound.  At the bench shapes (BH=64, S=256, D=128) the three kernels must
// move about 16, 20 and 24 MiB (each input read once, each output written
// once: for dQ, Q, K, V and dO read and dQ written, 4 MiB each) and do 1.1,
// 1.6 and 2.2 GFLOP of tile products, so all three are bound by device
// memory, not by the tensor cores.  What they do about it: no score tile,
// probability or partial sum ever leaves the SM, so device memory sees the
// inputs and outputs only, plus the K/V (or Q/dO) tiles that each block
// re-reads, mostly from the 50 MB L2.  What they do not do: wgmma in the
// dK/dV kernel, overlap of the forward pass's softmax with the next tile's
// products, TMA tile loads, a persistent grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "mma.cuh"

namespace {

constexpr int BM = 64;  // query rows per tile
constexpr int BN = 64;  // key rows per tile (equal to BM: the skip rules assume it)
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int PAD_H = 8;  // bf16 row padding: 16-byte rows, shifted banks
constexpr float LOG2E = 1.4426950408889634f;

static_assert(BM == NWARPS * 16, "one warp per 16 rows of a tile");
static_assert(BM == BN, "causal skip rules assume square tiles");

// ---- padded tiles (dK/dV kernel) and fragment helpers ------------------------

// A (64 x D) bf16 tile in shared memory, rows padded by 16 bytes: the eight
// row addresses of an ldmatrix land in eight distinct bank groups.
template <int D>
struct Tile {
  static constexpr int LD = D + PAD_H;
  static constexpr int ELEMS = BM * LD;
  static constexpr size_t BYTES = size_t(ELEMS) * sizeof(bf16);
  static_assert(BYTES % 128 == 0, "tiles laid end to end keep 128-byte alignment");
};

// Rows [row0, row0 + 64) of one (S, D) head into a padded tile with
// cp.async, 16 bytes a thread over THREADS threads; rows at or past S read
// as zeros.  The caller commits.
template <int D, int THREADS>
__device__ __forceinline__ void tile_async(bf16* dst, const bf16* head, int row0, int S,
                                           int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks of a row
  static_assert((BM * CH) % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int n = 0; n < BM * CH / THREADS; ++n) {
    const int i = tid + n * THREADS;
    const int r = i / CH;
    const int c = (i % CH) * 8;
    const bool ok = row0 + r < S;
    cp_async_16(dst + r * Tile<D>::LD + c, ok ? head + size_t(row0 + r) * D + c : head, ok);
  }
}

// A warp's 16 rows of f32 accumulator fragments (D/8 n8 tiles; rows g and
// g+8 scaled by mul[0] and mul[1]) as bf16 through `stage`, the warp's own
// 16 rows of a padded shared tile, then to rows [row0, row0 + 16) of the
// output head with 16-byte stores; rows at or past S are not stored.
template <int D>
__device__ __forceinline__ void store_frags(bf16* out, const float (&acc)[D / 8][4],
                                            const float (&mul)[2], bf16* stage, int row0, int S,
                                            int lane) {
  constexpr int LD = Tile<D>::LD;
  constexpr int CH = D / 8;
  const int g = lane / 4;
  const int t = lane % 4;
  __syncwarp();  // the warp's last ldmatrix reads of `stage` are done
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(stage + g * LD + j * 8 + 2 * t) =
        pack_bf16(acc[j][0] * mul[0], acc[j][1] * mul[0]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LD + j * 8 + 2 * t) =
        pack_bf16(acc[j][2] * mul[1], acc[j][3] * mul[1]);
  }
  __syncwarp();
#pragma unroll
  for (int n = 0; n < 16 * CH / 32; ++n) {
    const int i = lane + n * 32;
    const int r = i / CH;
    const int c = (i % CH) * 8;
    if (row0 + r < S) {
      *reinterpret_cast<uint4*>(out + size_t(row0 + r) * D + c) =
          *reinterpret_cast<const uint4*>(stage + r * LD + c);
    }
  }
}

// max and sum over the four lanes that share a row of an accumulator
// fragment
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// 2^x on the special-function unit (subnormal results flush to 0; 2^-inf
// is 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- the forward and dQ kernels on warpgroup products (wgmma) -----------------

// A (ROWS x D) bf16 tile in the layout wgmma reads with 128-byte swizzle:
// D/64 column blocks of ROWS rows of 128 bytes each, the 16-byte chunk j of
// row r stored at chunk j ^ (r % 8).  Offset in elements of (r, c).
template <int ROWS>
__device__ __forceinline__ int sw_off(int r, int c) {
  return (c / 64) * ROWS * 64 + r * 64 + ((((c % 64) / 8) ^ (r & 7)) * 8) + (c % 8);
}

// Rows [row0, row0 + ROWS) of one (S, D) head into a swizzled tile with
// cp.async, 16 bytes a thread; rows at or past S read as zeros.
template <int D, int THREADS, int ROWS>
__device__ __forceinline__ void sw_tile_async(bf16* dst, const bf16* head, int row0, int S,
                                              int tid) {
  constexpr int CH = D / 8;
  static_assert((ROWS * CH) % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int n = 0; n < ROWS * CH / THREADS; ++n) {
    const int i = tid + n * THREADS;
    const int r = i / CH;
    const int c = (i % CH) * 8;
    const bool ok = row0 + r < S;
    cp_async_16(dst + sw_off<ROWS>(r, c), ok ? head + size_t(row0 + r) * D + c : head, ok);
  }
}

// Geometry: Q (and dO for the dQ kernel), then a two-stage ring of (K, V)
// tiles, all swizzled, from a 1024-byte aligned base.
template <int D>
struct Sw {
  static constexpr int TE = 64 * D;  // elements of a 64-row tile
  static constexpr size_t TILE = size_t(TE) * sizeof(bf16);
  static constexpr size_t FWD = 1024 + TILE * 5;
  static constexpr size_t DQ = 1024 + TILE * 6;
};

// The first 1024-byte aligned address of dynamic shared memory: the
// swizzle pattern repeats every 1024 bytes.
__device__ __forceinline__ bf16* sw_base(unsigned char* raw) {
  return reinterpret_cast<bf16*>(raw + ((1024 - (smem_addr(raw) & 1023)) & 1023));
}

// This block's q tile and head on a 1-D grid of (q tiles x BH): blocks in
// order of work, heaviest q tiles first, except that the second round
// (wave = the SM count) goes lightest first.
__device__ __forceinline__ void block_tile(int S, int BH, int wave, int& qt, int& bh) {
  int r = blockIdx.x;
  if (r >= wave && r < 2 * wave) {
    r = wave + (min(int(gridDim.x), 2 * wave) - 1 - r);
  }
  qt = (S + BM - 1) / BM - 1 - r / BH;
  bh = r % BH;
}

// Top of key tile kt of the two-stage (K, V) ring: from kt = 1 on, wait for
// tile kt's copies, hand them to the async proxy, and pass a barrier, after
// which no warp reads tile kt - 1 any more; then start tile kt + 1 into that
// stage.  Returns tile kt's K (its V follows at + TE).
template <int D>
__device__ __forceinline__ const bf16* ring_step(bf16* ring, const bf16* kh, const bf16* vh,
                                                 int kt, int kend, int S) {
  constexpr int TE = Sw<D>::TE;
  if (kt > 0) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();  // tile kt has landed; every warp is done with tile kt - 1
  }
  if (kt + 1 < kend) {
    bf16* nxt = ring + ((kt + 1) & 1) * 2 * TE;
    sw_tile_async<D, NTHREADS, 64>(nxt, kh, (kt + 1) * BN, S, threadIdx.x);
    sw_tile_async<D, NTHREADS, 64>(nxt + TE, vh, (kt + 1) * BN, S, threadIdx.x);
    cp_async_commit();
  }
  return ring + (kt & 1) * 2 * TE;
}

// d (64 x 64) = A B^T over D, A and B swizzled (64 x D) tiles, both K-major
// in shared memory: k16 step kk is 32 bytes into column block kk / 4.
// Emits the k16 steps; the caller fences before and commits after.
template <int D>
__device__ __forceinline__ void wgmma_abt(float (&d)[BN / 8][4], const bf16* A, const bf16* B) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * 64 * 64 + (kk % 4) * 16;
    wgmma_m64n64k16_ss(d, wgmma_desc(A + off, 16, 1024), wgmma_desc(B + off, 16, 1024), kk > 0);
  }
}

// acc (64 x D) += P B, P (64 x 64) bf16 in A registers (k16 step kk in
// pa[kk]), B a swizzled (64 x D) tile of keys x D, D contiguous, read
// transposed: k16 step kk is 16 rows (2048 bytes) down the tile, column
// blocks 64 rows (8192 bytes) apart.  Emits the k16 steps; the caller
// fences and commits.
template <int D>
__device__ __forceinline__ void wgmma_pb(float (&acc)[D / 8][4], const uint32_t (&pa)[BN / 16][4],
                                         const bf16* B) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint64_t db = wgmma_desc(B + kk * 16 * 64, 64 * 64 * 2, 1024);
    if constexpr (D == 128) {
      wgmma_m64n128k16_rs(acc, pa[kk], db);
    } else {
      wgmma_m64n64k16_rs(acc, pa[kk], db);
    }
  }
}

// Score tile kt of q tile qt to -inf wherever the forward pass masks it:
// the causal diagonal tile and keys at or past S, edge tiles only.
// row_lo: this lane's first row (its second is row_lo + 8).
__device__ __forceinline__ void mask_scores(float (&s)[BN / 8][4], int kt, int qt, int row_lo,
                                            int S, int causal) {
  const int k0 = kt * BN;
  if (!((causal && kt == qt) || k0 + BN > S)) return;
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + j * 8 + 2 * t + (e & 1);
      const int row = row_lo + (e >> 1) * 8;
      if (col >= S || (causal && col > row)) s[j][e] = -INFINITY;
    }
  }
}

// Epilogue: this warp's 16 rows of acc (64 x D f32, rows g and g+8 scaled
// by mul[0] and mul[1]) as bf16 into its rows of the swizzled tile `stage`,
// then 16-byte stores to rows [q0, q0 + 64) of the output head; rows at or
// past S are not stored.  The caller has passed a barrier after the
// block's last read of `stage`.
template <int D>
__device__ __forceinline__ void store_sw(bf16* out, const float (&acc)[D / 8][4],
                                         const float (&mul)[2], bf16* stage, int q0, int S) {
  constexpr int CH = D / 8;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(stage + sw_off<64>(r0 + g, c)) =
        pack_bf16(acc[j][0] * mul[0], acc[j][1] * mul[0]);
    *reinterpret_cast<uint32_t*>(stage + sw_off<64>(r0 + g + 8, c)) =
        pack_bf16(acc[j][2] * mul[1], acc[j][3] * mul[1]);
  }
  __syncwarp();
#pragma unroll
  for (int n = 0; n < 16 * CH / 32; ++n) {
    const int i = lane + n * 32;
    const int rr = r0 + i / CH;
    const int c = (i % CH) * 8;
    if (q0 + rr < S) {
      *reinterpret_cast<uint4*>(out + size_t(q0 + rr) * D + c) =
          *reinterpret_cast<const uint4*>(stage + sw_off<64>(rr, c));
    }
  }
}

// Forward: grid (BH * q tiles), one warpgroup.  O and lse for one 64-row q
// tile.
template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int S, int causal, float scale, int BH,
                     int wave) {
  static_assert(NTHREADS == 128, "one warpgroup a block");
  constexpr int TE = Sw<D>::TE;
  constexpr int NO = D / 8;   // n8 tiles of O
  constexpr int NS = BN / 8;  // n8 tiles of S
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = sw_base(smem_raw);
  bf16* ring = Qs + TE;  // stage s: K at 2s, V at 2s + 1

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  int qt, bh;
  block_tile(S, BH, wave, qt, bh);
  const int q0 = qt * BM;
  const size_t head = size_t(bh) * S * D;
  const bf16* kh = k + head;
  const bf16* vh = v + head;
  const int nk = (S + BN - 1) / BN;
  const int kend = causal ? min(nk, qt + 1) : nk;  // at least 1

  sw_tile_async<D, NTHREADS, 64>(Qs, q + head, q0, S, threadIdx.x);
  sw_tile_async<D, NTHREADS, 64>(ring, kh, 0, S, threadIdx.x);
  sw_tile_async<D, NTHREADS, 64>(ring + TE, vh, 0, S, threadIdx.x);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();  // Q and the first tiles have landed for the whole block

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  float s[NS][4];
#pragma unroll
  for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};
  const float sl2 = scale * LOG2E;
  const int row_lo = q0 + warp * 16 + g;

  for (int kt = 0; kt < kend; ++kt) {
    const bf16* Ks = ring_step<D>(ring, kh, vh, kt, kend, S);
    const bf16* Vs = Ks + TE;

    wgmma_hold(s);
    wgmma_fence();
    wgmma_abt<D>(s, Qs, Ks);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(s);

    mask_scores(s, kt, qt, row_lo, S, causal);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float msc[2], corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = quad_max(mx[h]);
      msc[h] = (m_new == -INFINITY) ? 0.0f : m_new * sl2;
      corr[h] = fast_exp2(fmaf(m_run[h], sl2, -msc[h]));
      m_run[h] = m_new;
    }
    float psum[2] = {0.0f, 0.0f};
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = fast_exp2(fmaf(s[j][e], sl2, -msc[e >> 1]));
        psum[e >> 1] += p[e];
      }
      pa[j / 2][(j % 2) * 2] = pack_bf16(p[0], p[1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_run[h] = fmaf(l_run[h], corr[h], psum[h]);
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // O += P V: P from registers, V read transposed
    wgmma_hold(acc);
    wgmma_fence();
    wgmma_pb<D>(acc, pa, Vs);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(acc);
  }
  float l_safe[2], inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_safe[h] = fmaxf(quad_sum(l_run[h]), 1e-20f);
    inv[h] = 1.0f / l_safe[h];
  }
  __syncthreads();  // the warpgroup's last reads of Q are done
  store_sw<D>(o + head, acc, inv, Qs, q0, S);
  if (lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_lo + 8 * h;
      if (row < S) lse[size_t(bh) * S + row] = m_run[h] * scale + logf(l_safe[h]);
    }
  }
}

// dQ: grid (BH * q tiles), one warpgroup.  dQ_i = sum_j dS_ij K_j over the
// live key tiles, for one 64-row q tile.
template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int S, int causal, float scale, int BH,
                        int wave) {
  static_assert(NTHREADS == 128, "one warpgroup a block");
  constexpr int TE = Sw<D>::TE;
  constexpr int NQ = D / 8;   // n8 tiles of dQ
  constexpr int NS = BN / 8;  // n8 tiles of S and dP
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = sw_base(smem_raw);
  bf16* dOs = Qs + TE;
  bf16* ring = dOs + TE;  // stage s: K at 2s, V at 2s + 1

  const int lane = threadIdx.x % 32;
  int qt, bh;
  block_tile(S, BH, wave, qt, bh);
  const int q0 = qt * BM;
  const size_t head = size_t(bh) * S * D;
  const bf16* kh = k + head;
  const bf16* vh = v + head;
  const int nk = (S + BN - 1) / BN;
  const int kend = causal ? min(nk, qt + 1) : nk;  // at least 1

  sw_tile_async<D, NTHREADS, 64>(Qs, q + head, q0, S, threadIdx.x);
  sw_tile_async<D, NTHREADS, 64>(dOs, dout + head, q0, S, threadIdx.x);
  sw_tile_async<D, NTHREADS, 64>(ring, kh, 0, S, threadIdx.x);
  sw_tile_async<D, NTHREADS, 64>(ring + TE, vh, 0, S, threadIdx.x);
  cp_async_commit();

  // this lane's rows: -lse in log2 units and delta * scale; a row at or
  // past S takes lse = +inf, so its p is 0
  const int row_lo = q0 + (threadIdx.x / 32) * 16 + lane / 4;
  float nlse[2], dsc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_lo + 8 * h;
    const bool ok = row < S;
    nlse[h] = ok ? -lse[size_t(bh) * S + row] * LOG2E : -INFINITY;
    dsc[h] = ok ? delta[size_t(bh) * S + row] * scale : 0.0f;
  }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();  // Q, dO and the first tiles have landed for the whole block

  float acc[NQ][4];
#pragma unroll
  for (int j = 0; j < NQ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  float s[NS][4], dp[NS][4];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
  }
  const float sl2 = scale * LOG2E;

  for (int kt = 0; kt < kend; ++kt) {
    const bf16* Ks = ring_step<D>(ring, kh, vh, kt, kend, S);
    const bf16* Vs = Ks + TE;

    // S = Q K^T and dP = dO V^T, two groups in flight: p is formed on S
    // while dP's product runs
    wgmma_hold(s);
    wgmma_hold(dp);
    wgmma_fence();
    wgmma_abt<D>(s, Qs, Ks);
    wgmma_commit();
    wgmma_abt<D>(dp, dOs, Vs);
    wgmma_commit();
    wgmma_wait<1>();
    wgmma_hold(s);

    mask_scores(s, kt, qt, row_lo, S, causal);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = fast_exp2(fmaf(s[j][e], sl2, nlse[e >> 1]));
    }
    wgmma_wait<0>();
    wgmma_hold(dp);

    // dS = p (dP - delta) scale, packed into the A registers of dQ += dS K
    uint32_t da[BN / 16][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      float d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) d[e] = s[j][e] * fmaf(dp[j][e], scale, -dsc[e >> 1]);
      da[j / 2][(j % 2) * 2] = pack_bf16(d[0], d[1]);
      da[j / 2][(j % 2) * 2 + 1] = pack_bf16(d[2], d[3]);
    }
    wgmma_hold(acc);
    wgmma_fence();
    wgmma_pb<D>(acc, da, Ks);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(acc);
  }
  __syncthreads();  // the warpgroup's last reads of Q are done
  const float one[2] = {1.0f, 1.0f};
  store_sw<D>(dq + head, acc, one, Qs, q0, S);
}

// Dynamic shared memory of the dK/dV kernel: K, V, then a two-stage ring of
// (Q, dO, lse and delta rows).
template <int D>
struct DkvSmem {
  static constexpr size_t VEC = 2 * BM * sizeof(float);  // lse, delta
  static constexpr size_t STAGE = 2 * Tile<D>::BYTES + VEC;
  static constexpr size_t BYTES = 2 * Tile<D>::BYTES + 2 * STAGE;
  static_assert(VEC % 128 == 0, "stages keep 128-byte alignment");
};

// Q, dO, lse and delta of q tile `qt` into ring stage `st`, cp.async over the
// block (one f32 of lse or delta a thread); the caller commits.
template <int D>
__device__ __forceinline__ void dkv_stage_async(unsigned char* st, const bf16* qh, const bf16* doh,
                                                const float* lse_h, const float* delta_h, int qt,
                                                int S) {
  static_assert(NTHREADS == 2 * BM, "one thread per lse or delta element");
  tile_async<D, NTHREADS>(reinterpret_cast<bf16*>(st), qh, qt * BM, S, threadIdx.x);
  tile_async<D, NTHREADS>(reinterpret_cast<bf16*>(st + Tile<D>::BYTES), doh, qt * BM, S,
                          threadIdx.x);
  const float* src = threadIdx.x < BM ? lse_h : delta_h;
  const int row = qt * BM + threadIdx.x % BM;
  const bool ok = row < S;
  cp_async_4(reinterpret_cast<float*>(st + 2 * Tile<D>::BYTES) + threadIdx.x,
             ok ? src + row : src, ok);
}

// dK/dV: grid (BH, key tiles).  dV_j = sum_i P_ij^T dO_i and dK_j = sum_i
// dS_ij^T Q_i over the live q tiles, for one 64-key tile.
template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int causal,
                         float scale) {
  using G = DkvSmem<D>;
  constexpr int LD = Tile<D>::LD;
  constexpr int KD = D / 16;  // k16 steps of K Q^T and V dO^T
  constexpr int ND = D / 8;   // n8 tiles of dK and dV
  // q columns a pass: at D=128 the pass's S^T and dP^T fit in registers
  // beside dK and dV (128 f32 a lane) only half a tile at a time
  constexpr int QC = D == 128 ? 32 : 64;
  constexpr int NQ = QC / 8;  // n8 tiles of a pass's transposed score tiles
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + Tile<D>::ELEMS;
  unsigned char* ring = smem + 2 * Tile<D>::BYTES;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int bh = blockIdx.x;
  const int kt = blockIdx.y;  // lowest key tiles (most live q tiles) first
  const int k0 = kt * BN;
  const size_t head = size_t(bh) * S * D;
  const bf16* qh = q + head;
  const bf16* doh = dout + head;
  const float* lse_h = lse + size_t(bh) * S;
  const float* delta_h = delta + size_t(bh) * S;
  const int nq = (S + BM - 1) / BM;
  const int qstart = causal ? kt : 0;  // first live q tile
  const int n = nq - qstart;

  tile_async<D, NTHREADS>(Ks, k + head, k0, S, threadIdx.x);
  tile_async<D, NTHREADS>(Vs, v + head, k0, S, threadIdx.x);
  dkv_stage_async<D>(ring, qh, doh, lse_h, delta_h, qstart, S);
  cp_async_commit();

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.0f;
  }
  const float sl2 = scale * LOG2E;
  const int key_lo = k0 + 16 * warp + g;  // this lane's keys: key_lo, key_lo + 8
  const bf16* Kw = Ks + (16 * warp + lane % 16) * LD + (lane / 16) * 8;
  const bf16* Vw = Vs + (16 * warp + lane % 16) * LD + (lane / 16) * 8;

  for (int it = 0; it < n; ++it) {
    const int qt = qstart + it;
    const int q0 = qt * BM;
    cp_async_wait<0>();
    __syncthreads();  // tile `it` has landed; every warp is done with tile it - 1
    if (it + 1 < n) {
      dkv_stage_async<D>(ring + ((it + 1) & 1) * G::STAGE, qh, doh, lse_h, delta_h, qt + 1, S);
      cp_async_commit();
    }
    const unsigned char* st = ring + (it & 1) * G::STAGE;
    const bf16* Qs = reinterpret_cast<const bf16*>(st);
    const bf16* dOs = reinterpret_cast<const bf16*>(st + Tile<D>::BYTES);
    const float* lse_s = reinterpret_cast<const float*>(st + 2 * Tile<D>::BYTES);
    const float* delta_s = lse_s + BM;

    const bool edge = (causal && qt == kt) || q0 + BM > S;
#pragma unroll 1
    for (int c0 = 0; c0 < BM; c0 += QC) {
      // S^T = K Q^T and dP^T = V dO^T over q columns [c0, c0 + QC), keys
      // as rows: Q and dO rows are the col-major B fragments
      float sp[NQ][4], dp[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sp[j][e] = dp[j][e] = 0.0f;
      }
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t a[4];
        ldmatrix_x4(a, Kw + kd * 16);
#pragma unroll
        for (int j = 0; j < NQ; j += 2) {
          uint32_t b[4];
          ldmatrix_x4(b, Qs + (c0 + j * 8 + lane % 8 + (lane / 16) * 8) * LD + kd * 16 +
                             ((lane / 8) % 2) * 8);
          mma_bf16(sp[j], a, b[0], b[1]);
          mma_bf16(sp[j + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t a[4];
        ldmatrix_x4(a, Vw + kd * 16);
#pragma unroll
        for (int j = 0; j < NQ; j += 2) {
          uint32_t b[4];
          ldmatrix_x4(b, dOs + (c0 + j * 8 + lane % 8 + (lane / 16) * 8) * LD + kd * 16 +
                             ((lane / 8) % 2) * 8);
          mma_bf16(dp[j], a, b[0], b[1]);
          mma_bf16(dp[j + 1], a, b[2], b[3]);
        }
      }

      // p = exp(s*scale - lse) and dS = p (dP - delta) scale, lse and delta
      // by column; mask the causal diagonal tile and q rows at or past S
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const int c = c0 + j * 8 + 2 * t;
        const float2 L = *reinterpret_cast<const float2*>(lse_s + c);
        const float2 Dl = *reinterpret_cast<const float2*>(delta_s + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse_c = (e & 1) ? L.y : L.x;
          const float delta_c = (e & 1) ? Dl.y : Dl.x;
          float p = fast_exp2(fmaf(sp[j][e], sl2, -lse_c * LOG2E));
          if (edge) {
            const int col = q0 + c + (e & 1);
            const int key = key_lo + (e >> 1) * 8;
            if (col >= S || (causal && key > col)) p = 0.0f;
          }
          sp[j][e] = p;
          dp[j][e] = p * (dp[j][e] - delta_c) * scale;
        }
      }

      // dV += P^T dO, then dK += dS^T Q: two n8 tiles of P^T (dS^T) are
      // one k16 A fragment; dO and Q rows through ldmatrix.trans are B
#pragma unroll
      for (int kk = 0; kk < NQ / 2; ++kk) {
        const uint32_t a[4] = {pack_bf16(sp[2 * kk][0], sp[2 * kk][1]),
                               pack_bf16(sp[2 * kk][2], sp[2 * kk][3]),
                               pack_bf16(sp[2 * kk + 1][0], sp[2 * kk + 1][1]),
                               pack_bf16(sp[2 * kk + 1][2], sp[2 * kk + 1][3])};
#pragma unroll
        for (int j = 0; j < ND; j += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, dOs + (c0 + kk * 16 + lane % 16) * LD + j * 8 + (lane / 16) * 8);
          mma_bf16(dva[j], a, b[0], b[1]);
          mma_bf16(dva[j + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < NQ / 2; ++kk) {
        const uint32_t a[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                               pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                               pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                               pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
        for (int j = 0; j < ND; j += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, Qs + (c0 + kk * 16 + lane % 16) * LD + j * 8 + (lane / 16) * 8);
          mma_bf16(dka[j], a, b[0], b[1]);
          mma_bf16(dka[j + 1], a, b[2], b[3]);
        }
      }
    }
  }

  // this warp alone read its K and V rows, so they stage its dK and dV rows
  const float one[2] = {1.0f, 1.0f};
  store_frags<D>(dk + head, dka, one, Ks + 16 * warp * LD, k0 + 16 * warp, S, lane);
  store_frags<D>(dv + head, dva, one, Vs + 16 * warp * LD, k0 + 16 * warp, S, lane);
}

// ---- launch -------------------------------------------------------------------

constexpr int MAX_DEVICES = 64;
// per device: its SM count once every kernel's shared-memory limit is set
std::atomic<int> g_sms[MAX_DEVICES];

template <typename... KArgs>
cudaError_t allow_smem(void (*kern)(KArgs...), size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

// The current device's SM count; on a device's first call, also raise
// every kernel's dynamic shared-memory limit, once per kernel
// instantiation, not at every launch.
cudaError_t device_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  int n = g_sms[dev].load(std::memory_order_acquire);
  if (n > 0) {
    *sms = n;
    return cudaSuccess;
  }
  const cudaError_t errs[] = {
      allow_smem(flash_fwd_kernel<64>, Sw<64>::FWD),
      allow_smem(flash_fwd_kernel<128>, Sw<128>::FWD),
      allow_smem(flash_bwd_dq_kernel<64>, Sw<64>::DQ),
      allow_smem(flash_bwd_dq_kernel<128>, Sw<128>::DQ),
      allow_smem(flash_bwd_dkv_kernel<64>, DkvSmem<64>::BYTES),
      allow_smem(flash_bwd_dkv_kernel<128>, DkvSmem<128>::BYTES),
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev),
  };
  for (cudaError_t e : errs) {
    if (e != cudaSuccess) return e;
  }
  g_sms[dev].store(n, std::memory_order_release);
  *sms = n;
  return cudaSuccess;
}

template <typename... KArgs, typename... Args>
int launch(void (*kern)(KArgs...), size_t smem, dim3 grid, int threads, cudaStream_t stream,
           Args... args) {
  int sms = 0;
  const cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return int(err);
  kern<<<grid, threads, smem, stream>>>(args...);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int tpumon_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                     int S, int D, int causal, float scale, void* stream) {
  int sms = 0;  // the wave of the block order
  const cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(BH * ((S + BM - 1) / BM));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  bf16* O = static_cast<bf16*>(o);
  float* L = static_cast<float*>(lse);
  switch (D) {
    case 64:
      return launch(flash_fwd_kernel<64>, Sw<64>::FWD, grid, NTHREADS, st, Q, K, V, O, L, S,
                    causal, scale, BH, sms);
    case 128:
      return launch(flash_fwd_kernel<128>, Sw<128>::FWD, grid, NTHREADS, st, Q, K, V, O, L, S,
                    causal, scale, BH, sms);
    default:
      return int(cudaErrorInvalidValue);
  }
}

int tpumon_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, int BH, int S, int D,
                        int causal, float scale, void* stream) {
  int sms = 0;  // the wave of the block order
  const cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(BH * ((S + BM - 1) / BM));
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
      return launch(flash_bwd_dq_kernel<64>, Sw<64>::DQ, grid, NTHREADS, st, Q, K, V, dO, L, Dl,
                    dQ, S, causal, scale, BH, sms);
    case 128:
      return launch(flash_bwd_dq_kernel<128>, Sw<128>::DQ, grid, NTHREADS, st, Q, K, V, dO, L,
                    Dl, dQ, S, causal, scale, BH, sms);
    default:
      return int(cudaErrorInvalidValue);
  }
}

int tpumon_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv, int BH, int S,
                         int D, int causal, float scale, void* stream) {
  const dim3 grid(BH, (S + BN - 1) / BN);
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
      return launch(flash_bwd_dkv_kernel<64>, DkvSmem<64>::BYTES, grid, NTHREADS, st, Q, K, V, dO,
                    L, Dl, dK, dV, S, causal, scale);
    case 128:
      return launch(flash_bwd_dkv_kernel<128>, DkvSmem<128>::BYTES, grid, NTHREADS, st, Q, K, V,
                    dO, L, Dl, dK, dV, S, causal, scale);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
