// Fused SGD (momentum, weight decay) over every parameter in one launch,
// for Hopper (sm_90a):
//
//     g   <- grad + wd * p          (skipped when wd == 0)
//     buf <- momentum * buf + g
//     p   <- p - lr * buf
//
// Replaces tpu_ddp/ops/pallas/sgd.py:fused_sgd_step (the Pallas kernel
// _sgd_kernel behind _sgd_leaf), which runs one pass per leaf with p and
// buf aliased to its outputs. Here p and buf are updated in place and all
// leaves go in ONE launch: a table of (p, g, buf, n) per leaf and the
// first chunk of each leaf travel as a kernel parameter (under 4 KB), so
// there is no device-side table to keep in sync and no copy per step.
//
// What bounds it on this card: bytes. Per element it reads p, g, buf and
// writes p, buf (20 bytes) for five flops. Each block takes one chunk of
// kChunk elements of one leaf and streams it with 16-byte loads (scalar
// for a ragged tail or unaligned pointers).
//
// The step guard (tpu_ddp/resilience/guard.py's select_update) gates the
// update on the device: `skip` points at a 0-d f32 flag that the guard
// computed on the card, and every block reads it and returns without
// writing when it is nonzero, so a flagged step leaves p and buf exactly
// as they were and the host never waits for the flag. A null `skip` is
// the ungated update. The arithmetic is the same either way.
//
// Rounding: the _rn intrinsics keep nvcc from contracting a multiply and
// an add into one fused operation, so every element rounds exactly as the
// plain PyTorch version (ops/sgd.py:fused_sgd_step_ref) rounds it, op by
// op: the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 80;
constexpr int kThreads = 256;
constexpr int kVecPerThread = 4;
constexpr int kChunk = kThreads * 4 * kVecPerThread;  // 4096 elements

struct SgdTable {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  float* b[kMaxLeaves];
  int n[kMaxLeaves];
  int chunk0[kMaxLeaves + 1];  // first chunk of each leaf; [leaves] = total
};

__device__ __forceinline__ void update(float& p, float g, float& b, float lr,
                                       float momentum, float wd) {
  if (wd != 0.f) g = __fadd_rn(g, __fmul_rn(wd, p));
  b = __fadd_rn(__fmul_rn(momentum, b), g);
  p = __fsub_rn(p, __fmul_rn(lr, b));
}

__global__ void __launch_bounds__(kThreads)
sgd_kernel(const SgdTable table, int leaves, float lr, float momentum,
           float wd, int vec, const float* skip) {
  if (skip != nullptr && *skip != 0.f) return;  // uniform over the grid
  const int chunk = blockIdx.x;
  int leaf = 0;
  while (leaf + 1 < leaves && table.chunk0[leaf + 1] <= chunk) ++leaf;
  const int n = table.n[leaf];
  const int begin = (chunk - table.chunk0[leaf]) * kChunk;
  const int end = min(n, begin + kChunk);
  float* p = table.p[leaf];
  const float* g = table.g[leaf];
  float* b = table.b[leaf];
  int scalar_from = begin;
  if (vec) {
    // begin is a multiple of 4 and the pointers are 16-byte aligned.
    const int vec_end = begin + ((end - begin) & ~3);
    for (int i = begin + threadIdx.x * 4; i < vec_end; i += kThreads * 4) {
      float4 pv = *reinterpret_cast<const float4*>(p + i);
      const float4 gv = __ldg(reinterpret_cast<const float4*>(g + i));
      float4 bv = *reinterpret_cast<const float4*>(b + i);
      update(pv.x, gv.x, bv.x, lr, momentum, wd);
      update(pv.y, gv.y, bv.y, lr, momentum, wd);
      update(pv.z, gv.z, bv.z, lr, momentum, wd);
      update(pv.w, gv.w, bv.w, lr, momentum, wd);
      *reinterpret_cast<float4*>(p + i) = pv;
      *reinterpret_cast<float4*>(b + i) = bv;
    }
    scalar_from = vec_end;
  }
  for (int i = scalar_from + threadIdx.x; i < end; i += kThreads) {
    float pv = p[i];
    float bv = b[i];
    update(pv, __ldg(g + i), bv, lr, momentum, wd);
    p[i] = pv;
    b[i] = bv;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. p, g, b are host arrays of
// `leaves` device addresses (int64) of f32 tensors and n their element
// counts; leaves <= 80 (the wrapper splits larger sets). vec = 1 when
// every pointer is 16-byte aligned. skip is a device address of one f32
// (nonzero: write nothing) or null. Returns the CUDA error code of the
// launch (0 on success); -1 if the table does not fit.
extern "C" int tdt_sgd(const int64_t* p, const int64_t* g, const int64_t* b,
                       const int64_t* n, int leaves, float lr,
                       float momentum, float wd, int vec,
                       const float* skip, void* stream) {
  if (leaves < 1 || leaves > kMaxLeaves) return -1;
  SgdTable table;
  int chunks = 0;
  for (int i = 0; i < leaves; ++i) {
    table.p[i] = reinterpret_cast<float*>(p[i]);
    table.g[i] = reinterpret_cast<const float*>(g[i]);
    table.b[i] = reinterpret_cast<float*>(b[i]);
    table.n[i] = static_cast<int>(n[i]);
    table.chunk0[i] = chunks;
    chunks += static_cast<int>((n[i] + kChunk - 1) / kChunk);
  }
  table.chunk0[leaves] = chunks;
  if (chunks == 0) return 0;
  sgd_kernel<<<chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, leaves, lr, momentum, wd, vec, skip);
  return static_cast<int>(cudaGetLastError());
}
