// Load-shaping kernels for Hopper (sm_90a): a tensor-core burn and a
// device-memory stream.  Plain C entry points, bound from Python with ctypes
// (tpumon_torch/loadgen/kernels.py); each returns cudaGetLastError().
//
// Replaces the two load-shaping Pallas kernels of tpumon/loadgen/kernels.py:
//   mxu_kernel    <- _mxu_kernel     (launched by mxu_burn)
//   stream_kernel <- _stream_kernel  (launched by hbm_stream)
//
// Each pins one axis of the card at a time, so that the monitor's
// utilization fields can be checked against a load whose shape is known:
// mxu_kernel keeps the tensor cores busy and barely touches device memory;
// stream_kernel moves every byte once and does one multiply-add per element.
//
// mxu_kernel.  `iters` chained products acc = bf16(acc @ w), accumulated in
// f32 within a step and rounded to bf16 between steps, as the Pallas body's
// .astype(acc.dtype) does.  x is (n, T, T), w is (T, T), both bf16, at the
// reference's tile T=256; each of the n tiles is an independent chain
// through the same w.
//   Design.  The Pallas kernel holds one (T, T) tile and w in VMEM, which is
//   many megabytes; at T=256 x and w take 128 KiB each, and a block gets at
//   most 227 KiB of shared memory.  Row r of acc @ w depends only on row r of
//   acc, so a tile's rows split across blocks with no traffic between them:
//   each block keeps the whole of w resident in shared memory (T x T) and
//   owns a strip of ROWS=128 rows of one tile (128 x T), and runs all `iters`
//   steps there, touching device memory only to load x and w and to store
//   the result.  Eight warps, 2 x 4 over the strip: each owns 64 rows by T/4
//   columns, with its f32 sums in registers.  The products are
//   mma.sync.m16n8k16 (bf16 in, f32 accumulate) on fragments loaded with
//   ldmatrix from padded rows (T+8 bf16: consecutive rows shift by one
//   16-byte bank group, so ldmatrix is conflict-free).  A step ends with a
//   barrier (every warp has read the whole strip), the bf16-rounded sums
//   written back over the strip (round to nearest even, as torch's .to()
//   does), and a second barrier.  One block per SM at T=256 (198 KiB of
//   shared memory), so the wrapper's caller runs enough tiles to give every
//   SM a block: two blocks per tile.
//   Bound.  n * iters * 2 * T^3 tensor-core FLOPs against 2 * T^2 * (2n + 1)
//   bytes: far past the card's ridge point, bound by operations.  What it
//   does not do: wgmma (the only way to the full tensor-core rate), and it
//   reloads each warp's A and B fragments from shared memory at every k
//   step (128 bytes per mma), which caps it below the tensor cores' peak.
//
// stream_kernel.  o = x * 1.0001f + 0.25f elementwise over f32.  The Pallas
// grid of (256, 1024) blocks computes the same function elementwise, so one
// grid-stride loop over the flattened array takes its place: 16-byte vector
// loads and stores, then a scalar tail.  The product and the sum are
// __fmul_rn and __fadd_rn: left to itself nvcc contracts a*b+c into one FMA,
// which rounds once where x * 1.0001 + 0.25 in PyTorch (and in the Pallas
// body) rounds twice, so the result would part from its plain version by
// an ulp.  With two roundings it equals the plain version bit for bit.
//   Bound.  8 bytes of device traffic per element (one read, one write)
//   against 2 FLOPs: bound by device memory.  Enough blocks to fill every SM
//   (2048 threads each) keep one 16-byte load per thread in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

// ---- stream_kernel ------------------------------------------------------------

constexpr int STREAM_THREADS = 256;
constexpr int STREAM_BLOCKS_PER_SM = 8;  // 2048 threads: a full SM
constexpr float STREAM_MUL = 1.0001f;
constexpr float STREAM_ADD = 0.25f;

__device__ __forceinline__ float stream_op(float v) {
  return __fadd_rn(__fmul_rn(v, STREAM_MUL), STREAM_ADD);
}

__global__ void __launch_bounds__(STREAM_THREADS)
    stream_kernel(const float* __restrict__ x, float* __restrict__ o, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nvec = n / 4;
  const float4* xv = reinterpret_cast<const float4*>(x);
  float4* ov = reinterpret_cast<float4*>(o);
  for (long long i = tid; i < nvec; i += stride) {
    float4 v = xv[i];
    v.x = stream_op(v.x);
    v.y = stream_op(v.y);
    v.z = stream_op(v.z);
    v.w = stream_op(v.w);
    ov[i] = v;
  }
  for (long long i = nvec * 4 + tid; i < n; i += stride) o[i] = stream_op(x[i]);
}

// ---- mxu_kernel -----------------------------------------------------------------

constexpr int T = 256;         // tile width
constexpr int MXU_ROWS = 128;  // rows of a tile per block
constexpr int MXU_WARPS = 8;   // 2 (rows) x 4 (columns)
constexpr int MXU_THREADS = MXU_WARPS * 32;
constexpr int LD = T + 8;      // padded bf16 row: 16 bytes more
constexpr int WARP_COLS = T / 4;
constexpr int NT = WARP_COLS / 8;  // n8 tiles per warp
constexpr int MT = 64 / 16;        // m16 tiles per warp
constexpr size_t MXU_SMEM = size_t(T + MXU_ROWS) * LD * sizeof(bf16);
static_assert(T % MXU_ROWS == 0, "a tile splits into whole strips");
static_assert(NT % 2 == 0, "B fragments load two n8 tiles at a time");

// rows [0, rows) of a row-major (rows x T) bf16 matrix, global <-> padded shared
__device__ __forceinline__ void load_padded(bf16* dst, const bf16* src, int rows) {
  constexpr int PER_ROW = T / 8;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += MXU_THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * 8;
    *reinterpret_cast<uint4*>(dst + r * LD + c) =
        *reinterpret_cast<const uint4*>(src + size_t(r) * T + c);
  }
}

__device__ __forceinline__ void store_padded(bf16* dst, const bf16* src, int rows) {
  constexpr int PER_ROW = T / 8;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += MXU_THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * 8;
    *reinterpret_cast<uint4*>(dst + size_t(r) * T + c) =
        *reinterpret_cast<const uint4*>(src + r * LD + c);
  }
}

// Grid (T / MXU_ROWS strips, n tiles).
__global__ void __launch_bounds__(MXU_THREADS, 1)
    mxu_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ o,
               int iters) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ws = reinterpret_cast<bf16*>(smem);
  bf16* As = Ws + T * LD;

  const size_t strip = (size_t(blockIdx.y) * T + size_t(blockIdx.x) * MXU_ROWS) * T;
  load_padded(Ws, w, T);
  load_padded(As, x + strip, MXU_ROWS);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = (warp / 4) * 64;
  const int col0 = (warp % 4) * WARP_COLS;
  const int g = lane / 4;  // mma fragment row group
  const int t = lane % 4;  // thread within the group
  // ldmatrix.x4 row addresses: lanes 0-15 rows 0-15 of the first 8 columns,
  // lanes 16-31 the same rows of the next 8
  const int lrow = lane % 16;
  const int lcol = (lane / 16) * 8;

  for (int it = 0; it < iters; ++it) {
    float c[MT][NT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int nj = 0; nj < NT; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[mi][nj][e] = 0.0f;

#pragma unroll 2
    for (int kk = 0; kk < T; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        ldmatrix_x4(a[mi], As + (row0 + mi * 16 + lrow) * LD + kk + lcol);
#pragma unroll
      for (int nj = 0; nj < NT; nj += 2) {
        // w is (k, n) row-major: the transposed load gives the col-major
        // B fragments of n8 tiles nj (regs 0, 1) and nj + 1 (regs 2, 3)
        uint32_t b[4];
        ldmatrix_x4_trans(b, Ws + (kk + lrow) * LD + col0 + nj * 8 + lcol);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          mma_bf16(c[mi][nj], a[mi], b[0], b[1]);
          mma_bf16(c[mi][nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp has read the whole strip of this step

#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int nj = 0; nj < NT; ++nj) {
        // accumulator fragment: (row g, cols 2t, 2t+1) and (row g+8, same)
        bf16* p = As + (row0 + mi * 16 + g) * LD + col0 + nj * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(c[mi][nj][0], c[mi][nj][1]);
        *reinterpret_cast<__nv_bfloat162*>(p + 8 * LD) =
            __floats2bfloat162_rn(c[mi][nj][2], c[mi][nj][3]);
      }
    __syncthreads();  // the next step reads the rounded strip
  }

  store_padded(o + strip, As, MXU_ROWS);
}

}  // namespace

extern "C" {

// x, o: n contiguous (256, 256) bf16 tiles; w: one (256, 256) bf16 tile.
// iters <= 0 copies x, as a loop of no steps returns its carry.
int tpumon_mxu_burn(const void* x, const void* w, void* o, int n, int iters, void* stream) {
  if (n <= 0 || n > 65535) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(mxu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(MXU_SMEM));
  if (err != cudaSuccess) return int(err);
  mxu_kernel<<<dim3(T / MXU_ROWS, n), MXU_THREADS, MXU_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(o), iters);
  return int(cudaGetLastError());
}

// x, o: n contiguous f32 values, both 16-byte aligned.
int tpumon_hbm_stream(const void* x, void* o, long long n, void* stream) {
  if (n <= 0) return int(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  const long long work = (n / 4 > 0 ? n / 4 : n);
  const long long need = (work + STREAM_THREADS - 1) / STREAM_THREADS;
  const long long cap = (long long)sms * STREAM_BLOCKS_PER_SM;
  const int blocks = int(need < cap ? need : cap);
  stream_kernel<<<blocks, STREAM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o), n);
  return int(cudaGetLastError());
}

}  // extern "C"
