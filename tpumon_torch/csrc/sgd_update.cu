// The train step's fused SGD update for Hopper (sm_90a).  Plain C entry
// point, bound from Python with ctypes (tpumon_torch/loadgen/kernels.py,
// sgd_update); returns cudaGetLastError().
//
// Replaces no TPU kernel.  The JAX package's jitted train step
// (tpumon/loadgen/model.py, train_step) leaves the update to XLA, which
// fuses it with the step's casts.  The port's CUDA graph step
// (tpumon_torch/loadgen/graph.py) captured the same work as eager ops: the
// forward's f32 -> bf16 cast of every leaf, the gradients' bf16 -> f32 cast,
// lr * g, t - lr * g and the copy back, five passes and 40 bytes an element.
//
// sgd_update_kernel.  For every element of every float leaf:
//   t' = t - lr * g    in f32, the product and the difference rounded
//                      separately (__fmul_rn, __fsub_rn), as PyTorch's two
//                      kernels round them: left to itself nvcc contracts
//                      them into one FMA, which rounds once
//   master <- t'
//   work   <- bf16(t') round to nearest even, as Tensor.to(torch.bfloat16)
// where t is the f32 master weight, g the bf16 gradient widened exactly to
// f32, and work the bf16 working copy that the next step's forward reads.
// So the masters equal, bit for bit, those of the unfused update
// (tpumon_torch/loadgen/model.py, _sgd) after any number of steps.
//   Design.  One launch walks every leaf.  The leaves travel by value in the
//   kernel's parameter space, a table of pointers, lengths and first blocks
//   (at most MAX_LEAVES), so a CUDA graph records the table with the launch:
//   a captured step's buffers never move.  Each block owns one TILE of one
//   leaf, which it finds by scanning the table's first blocks (the same
//   entries for every thread of the block, read from the constant bank).
//   Where a leaf's three pointers are 16-byte aligned a thread moves 8
//   elements a vector step: two float4 loads of the master, one 16-byte load
//   of 8 bf16 gradients, two float4 stores and one 16-byte store of the copy.
//   A leaf's last n % 8 elements, and every element of an unaligned leaf, go
//   one at a time.
//   Bound.  12 bytes of device traffic an element (the f32 master read and
//   written, the bf16 gradient read, the bf16 copy written) against 2 FLOPs:
//   bound by device memory.  The bench model's 20,976,640 elements move
//   251.7 MB a step, 75.1 us at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int VEC = 8;                   // elements a vector step
constexpr int TILE = THREADS * VEC * 2;  // elements a block
constexpr int MAX_LEAVES = 64;

struct Leaf {
  float* master;
  const bf16* grad;
  bf16* work;
  long long n;
  long long block0;  // the leaf's first block
  int aligned;       // all three pointers 16-byte aligned
};

struct Table {
  Leaf leaf[MAX_LEAVES];
  int count;
};
static_assert(sizeof(Table) <= 4096, "a kernel's parameters take at most 4 KiB");

__device__ __forceinline__ float step(float t, float g, float lr) {
  return __fsub_rn(t, __fmul_rn(lr, g));
}

__global__ void __launch_bounds__(THREADS) sgd_update_kernel(const Table table, float lr) {
  int l = 0;
  while (l + 1 < table.count && (long long)blockIdx.x >= table.leaf[l + 1].block0) ++l;
  float* __restrict__ master = table.leaf[l].master;
  const bf16* __restrict__ grad = table.leaf[l].grad;
  bf16* __restrict__ work = table.leaf[l].work;
  const long long n = table.leaf[l].n;
  const long long base = ((long long)blockIdx.x - table.leaf[l].block0) * TILE;
  const long long end = base + TILE < n ? base + TILE : n;
  long long i = base + threadIdx.x;
  if (table.leaf[l].aligned) {
    const long long vend = base + (end - base) / VEC * VEC;
    for (long long v = base + (long long)threadIdx.x * VEC; v < vend;
         v += (long long)THREADS * VEC) {
      float4* m = reinterpret_cast<float4*>(master + v);
      float4 a = m[0], b = m[1];
      const uint4 graw = *reinterpret_cast<const uint4*>(grad + v);
      const __nv_bfloat162* gv = reinterpret_cast<const __nv_bfloat162*>(&graw);
      const float2 g0 = __bfloat1622float2(gv[0]), g1 = __bfloat1622float2(gv[1]);
      const float2 g2 = __bfloat1622float2(gv[2]), g3 = __bfloat1622float2(gv[3]);
      a.x = step(a.x, g0.x, lr);
      a.y = step(a.y, g0.y, lr);
      a.z = step(a.z, g1.x, lr);
      a.w = step(a.w, g1.y, lr);
      b.x = step(b.x, g2.x, lr);
      b.y = step(b.y, g2.y, lr);
      b.z = step(b.z, g3.x, lr);
      b.w = step(b.w, g3.y, lr);
      m[0] = a;
      m[1] = b;
      uint4 wraw;
      __nv_bfloat162* w2 = reinterpret_cast<__nv_bfloat162*>(&wraw);
      w2[0] = __floats2bfloat162_rn(a.x, a.y);
      w2[1] = __floats2bfloat162_rn(a.z, a.w);
      w2[2] = __floats2bfloat162_rn(b.x, b.y);
      w2[3] = __floats2bfloat162_rn(b.z, b.w);
      *reinterpret_cast<uint4*>(work + v) = wraw;
    }
    i = vend + threadIdx.x;
  }
  for (; i < end; i += THREADS) {
    const float t = step(master[i], __bfloat162float(grad[i]), lr);
    master[i] = t;
    work[i] = __float2bfloat16_rn(t);
  }
}

}  // namespace

extern "C" {

// masters, grads, works: host arrays of `count` device pointers, leaf l's f32
// master, bf16 gradient and bf16 working copy, each of sizes[l] (> 0)
// contiguous elements; sizes: a host array of `count` long longs.  The
// arrays are read before the call returns.
int tpumon_sgd_update(const void* masters, const void* grads, const void* works,
                      const void* sizes, int count, float lr, void* stream) {
  if (count <= 0 || count > MAX_LEAVES) return int(cudaErrorInvalidValue);
  const auto m = static_cast<float* const*>(masters);
  const auto g = static_cast<const bf16* const*>(grads);
  const auto w = static_cast<bf16* const*>(works);
  const auto n = static_cast<const long long*>(sizes);
  Table table{};
  long long blocks = 0;
  for (int l = 0; l < count; ++l) {
    if (n[l] <= 0) return int(cudaErrorInvalidValue);
    Leaf& e = table.leaf[l];
    e.master = m[l];
    e.grad = g[l];
    e.work = w[l];
    e.n = n[l];
    e.block0 = blocks;
    e.aligned = ((uintptr_t(m[l]) | uintptr_t(g[l]) | uintptr_t(w[l])) % 16) == 0;
    blocks += (n[l] + TILE - 1) / TILE;
  }
  table.count = count;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  sgd_update_kernel<<<unsigned(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(table, lr);
  return int(cudaGetLastError());
}

}  // extern "C"
