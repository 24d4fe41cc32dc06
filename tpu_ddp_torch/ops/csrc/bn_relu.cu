// Fused BatchNorm (current-batch statistics) + ReLU for Hopper (sm_90a):
// the forward and backward halves, four kernels and two small combines.
//
// Replaces tpu_ddp/ops/pallas/bn_relu.py:batch_norm_relu, whose custom VJP
// runs four Pallas kernels over the NHWC activation viewed as (R, C):
//
//   _stats_kernel       per-channel sum and sum of squares (f32)
//   _norm_relu_kernel   y = relu((x - mean) * (inv * scale) + bias)
//   _bwd_stats_kernel   ReLU mask folded into gy; sum(gy), sum(gy * x_hat)
//   _bwd_dx_kernel      dx = (scale * inv / R) * (R*gy - sum(gy)
//                                                 - x_hat * sum(gy * x_hat))
//
// What bounds it on this card: bytes. Each element is read once or twice
// and written at most once, with a handful of flops: 32 bytes per element
// over the four kernels (forward 4 + 8, backward 8 + 12), far below the
// ~295 flop per byte where the arithmetic would become the limit. The
// design streams rows with coalesced 16-byte loads and keeps everything
// per channel in registers:
//
//   - A thread owns VEC (4, or 1 when C % 4 != 0) consecutive channels and
//     strides over the rows of its block; the threads of a block that own
//     the same channels are its "lanes". C is the contiguous axis, so a
//     warp reads whole row segments (for C = 64, two 256-byte rows).
//   - The TPU kernel carries its per-channel sums across sequential grid
//     steps. Blocks on this card run in parallel and in no order, so the
//     reductions are two-stage: each block sums its rows lane by lane,
//     then its lanes in a fixed order, and writes f32 partials (blocks, C);
//     a second small kernel sums the partials in block order. No atomics:
//     a run gives the same bits every time.
//   - The elementwise passes load their per-channel vectors once per
//     thread. They use the _rn intrinsics, so nvcc does not contract a
//     multiply and an add into one fused operation: an element rounds as
//     the plain PyTorch version (ops/bn_relu.py) rounds it, op by op.
//   - The variance is the reference's max(E[x^2] - mean^2, 0); inv is
//     1 / sqrt(var + eps).
//
// The wrapper (ops/bn_relu.py) passes only C-contiguous f32 tensors,
// chooses VEC from C and the pointers' alignment, and sizes the grid from
// the SM count.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// The thread's place: channel group (VEC channels), row lane, lanes per
// block, channel groups per block.
struct Layout {
  int cg;
  int local;
  int lane;
  int lanes;
  int cgb;
  bool active;
};

template <int VEC>
__device__ __forceinline__ Layout layout(int C) {
  Layout l;
  const int cg_total = C / VEC;  // the wrapper guarantees C % VEC == 0
  l.cgb = min(cg_total, kThreads);
  l.lanes = kThreads / l.cgb;
  l.local = threadIdx.x % l.cgb;
  l.lane = threadIdx.x / l.cgb;
  l.cg = blockIdx.y * l.cgb + l.local;
  l.active = l.lane < l.lanes && l.cg < cg_total;
  return l;
}

template <int VEC>
struct Vec;

template <>
struct Vec<1> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    v[0] = __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    p[0] = v[0];
  }
};

template <>
struct Vec<4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// Sum two per-thread accumulators over the block's lanes, in lane order,
// and write them to row blockIdx.x of the (blocks, C) partials.
template <int VEC>
__device__ __forceinline__ void block_partials(const Layout& l,
                                               const float* a,
                                               const float* b, int C,
                                               float* sa, float* sb,
                                               float* pa, float* pb) {
  const int width = l.cgb * VEC;  // channels this block covers
  if (l.lane < l.lanes) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      sa[l.lane * width + l.local * VEC + j] = a[j];
      sb[l.lane * width + l.local * VEC + j] = b[j];
    }
  }
  __syncthreads();
  const int c0 = blockIdx.y * width;
  for (int t = threadIdx.x; t < width; t += kThreads) {
    const int c = c0 + t;
    if (c < C) {
      float s = 0.f;
      float q = 0.f;
      for (int ln = 0; ln < l.lanes; ++ln) {
        s += sa[ln * width + t];
        q += sb[ln * width + t];
      }
      pa[static_cast<size_t>(blockIdx.x) * C + c] = s;
      pb[static_cast<size_t>(blockIdx.x) * C + c] = q;
    }
  }
}

// Forward stage 1: per-block partial sums of x and x*x.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
bn_stats_kernel(const float* __restrict__ x, int R, int C,
                int rows_per_block, float* __restrict__ ps,
                float* __restrict__ pq) {
  __shared__ float sa[kThreads * VEC];
  __shared__ float sb[kThreads * VEC];
  const Layout l = layout<VEC>(C);
  float s[VEC];
  float q[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    s[j] = 0.f;
    q[j] = 0.f;
  }
  if (l.active) {
    const int r0 = blockIdx.x * rows_per_block;
    const int r1 = min(R, r0 + rows_per_block);
    const float* base = x + static_cast<size_t>(l.cg) * VEC;
    for (int r = r0 + l.lane; r < r1; r += l.lanes) {
      float v[VEC];
      Vec<VEC>::load(base + static_cast<size_t>(r) * C, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        s[j] += v[j];
        q[j] = fmaf(v[j], v[j], q[j]);
      }
    }
  }
  block_partials<VEC>(l, s, q, C, sa, sb, ps, pq);
}

// Forward stage 2: mean and inv per channel, partials summed in order.
__global__ void bn_stats_finish_kernel(const float* __restrict__ ps,
                                       const float* __restrict__ pq,
                                       int blocks, int C, float count,
                                       float eps, float* __restrict__ mean,
                                       float* __restrict__ inv) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s = 0.f;
  float q = 0.f;
  for (int b = 0; b < blocks; ++b) {
    s += ps[static_cast<size_t>(b) * C + c];
    q += pq[static_cast<size_t>(b) * C + c];
  }
  const float m = s / count;
  const float var = fmaxf(q / count - m * m, 0.f);
  mean[c] = m;
  inv[c] = 1.f / sqrtf(var + eps);
}

// y = relu((x - mean) * (inv * scale) + bias), rounded op by op.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
bn_norm_relu_kernel(const float* __restrict__ x,
                    const float* __restrict__ mean,
                    const float* __restrict__ inv,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, float* __restrict__ y,
                    int R, int C, int rows_per_block) {
  const Layout l = layout<VEC>(C);
  if (!l.active) return;
  const size_t off = static_cast<size_t>(l.cg) * VEC;
  float m[VEC], a[VEC], sc[VEC], b[VEC];
  Vec<VEC>::load(mean + off, m);
  Vec<VEC>::load(inv + off, a);
  Vec<VEC>::load(scale + off, sc);
  Vec<VEC>::load(bias + off, b);
#pragma unroll
  for (int j = 0; j < VEC; ++j) a[j] = __fmul_rn(a[j], sc[j]);
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(R, r0 + rows_per_block);
  for (int r = r0 + l.lane; r < r1; r += l.lanes) {
    const size_t i = static_cast<size_t>(r) * C + off;
    float v[VEC];
    Vec<VEC>::load(x + i, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float t =
          __fadd_rn(__fmul_rn(__fsub_rn(v[j], m[j]), a[j]), b[j]);
      v[j] = t > 0.f ? t : 0.f;
    }
    Vec<VEC>::store(y + i, v);
  }
}

// Backward stage 1: per-block partials of sum(gy) and sum(gy * x_hat),
// gy = g where the forward output was positive, else 0.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
bn_bwd_stats_kernel(const float* __restrict__ x,
                    const float* __restrict__ g,
                    const float* __restrict__ mean,
                    const float* __restrict__ inv,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, int R, int C,
                    int rows_per_block, float* __restrict__ pdb,
                    float* __restrict__ pds) {
  __shared__ float sa[kThreads * VEC];
  __shared__ float sb[kThreads * VEC];
  const Layout l = layout<VEC>(C);
  float db[VEC];
  float ds[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    db[j] = 0.f;
    ds[j] = 0.f;
  }
  if (l.active) {
    const size_t off = static_cast<size_t>(l.cg) * VEC;
    float m[VEC], iv[VEC], sc[VEC], b[VEC];
    Vec<VEC>::load(mean + off, m);
    Vec<VEC>::load(inv + off, iv);
    Vec<VEC>::load(scale + off, sc);
    Vec<VEC>::load(bias + off, b);
    const int r0 = blockIdx.x * rows_per_block;
    const int r1 = min(R, r0 + rows_per_block);
    for (int r = r0 + l.lane; r < r1; r += l.lanes) {
      const size_t i = static_cast<size_t>(r) * C + off;
      float xv[VEC], gv[VEC];
      Vec<VEC>::load(x + i, xv);
      Vec<VEC>::load(g + i, gv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xh = __fmul_rn(__fsub_rn(xv[j], m[j]), iv[j]);
        const float yv = __fadd_rn(__fmul_rn(xh, sc[j]), b[j]);
        const float gy = yv > 0.f ? gv[j] : 0.f;
        db[j] += gy;
        ds[j] = fmaf(gy, xh, ds[j]);
      }
    }
  }
  block_partials<VEC>(l, db, ds, C, sa, sb, pdb, pds);
}

// Backward stage 2: dbias and dscale per channel, partials in order.
__global__ void bn_bwd_finish_kernel(const float* __restrict__ pdb,
                                     const float* __restrict__ pds,
                                     int blocks, int C,
                                     float* __restrict__ dbias,
                                     float* __restrict__ dscale) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float db = 0.f;
  float ds = 0.f;
  for (int b = 0; b < blocks; ++b) {
    db += pdb[static_cast<size_t>(b) * C + c];
    ds += pds[static_cast<size_t>(b) * C + c];
  }
  dbias[c] = db;
  dscale[c] = ds;
}

// dx = ((scale * inv) * (1/R)) * ((R * gy - dbias) - x_hat * dscale),
// rounded op by op.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
bn_bwd_dx_kernel(const float* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ mean,
                 const float* __restrict__ inv,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias,
                 const float* __restrict__ dbias,
                 const float* __restrict__ dscale, float* __restrict__ dx,
                 int R, int C, int rows_per_block, float count,
                 float inv_count) {
  const Layout l = layout<VEC>(C);
  if (!l.active) return;
  const size_t off = static_cast<size_t>(l.cg) * VEC;
  float m[VEC], iv[VEC], sc[VEC], b[VEC], db[VEC], ds[VEC], k[VEC];
  Vec<VEC>::load(mean + off, m);
  Vec<VEC>::load(inv + off, iv);
  Vec<VEC>::load(scale + off, sc);
  Vec<VEC>::load(bias + off, b);
  Vec<VEC>::load(dbias + off, db);
  Vec<VEC>::load(dscale + off, ds);
#pragma unroll
  for (int j = 0; j < VEC; ++j) k[j] = __fmul_rn(__fmul_rn(sc[j], iv[j]),
                                                 inv_count);
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(R, r0 + rows_per_block);
  for (int r = r0 + l.lane; r < r1; r += l.lanes) {
    const size_t i = static_cast<size_t>(r) * C + off;
    float xv[VEC], gv[VEC];
    Vec<VEC>::load(x + i, xv);
    Vec<VEC>::load(g + i, gv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float xh = __fmul_rn(__fsub_rn(xv[j], m[j]), iv[j]);
      const float yv = __fadd_rn(__fmul_rn(xh, sc[j]), b[j]);
      const float gy = yv > 0.f ? gv[j] : 0.f;
      float t = __fsub_rn(__fmul_rn(count, gy), db[j]);
      t = __fsub_rn(t, __fmul_rn(xh, ds[j]));
      xv[j] = __fmul_rn(k[j], t);
    }
    Vec<VEC>::store(dx + i, xv);
  }
}

dim3 grid_for(int blocks, int C, int vec) {
  const int cg_total = C / vec;
  const int cgb = cg_total < kThreads ? cg_total : kThreads;
  return dim3(blocks, (cg_total + cgb - 1) / cgb);
}

int rows_per_block(int R, int blocks) { return (R + blocks - 1) / blocks; }

dim3 finish_grid(int C) { return dim3((C + kThreads - 1) / kThreads); }

}  // namespace

// Plain C entry points, loaded with ctypes. Every tensor is f32 and
// C-contiguous: x and g are (R, C), the channel vectors (C,), the
// partials (blocks, C). vec is 4 (C % 4 == 0 and every pointer 16-byte
// aligned) or 1. Each returns the CUDA error code of its launches.

extern "C" int tdt_bn_stats(const void* x, int R, int C, int vec,
                            int blocks, void* ps, void* pq, float eps,
                            void* mean, void* inv, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(blocks, C, vec);
  const int rpb = rows_per_block(R, blocks);
  const float* xp = static_cast<const float*>(x);
  float* psp = static_cast<float*>(ps);
  float* pqp = static_cast<float*>(pq);
  if (vec == 4) {
    bn_stats_kernel<4><<<grid, kThreads, 0, st>>>(xp, R, C, rpb, psp, pqp);
  } else {
    bn_stats_kernel<1><<<grid, kThreads, 0, st>>>(xp, R, C, rpb, psp, pqp);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_stats_finish_kernel<<<finish_grid(C), kThreads, 0, st>>>(
      psp, pqp, blocks, C, static_cast<float>(R), eps,
      static_cast<float*>(mean), static_cast<float*>(inv));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tdt_bn_norm_relu(const void* x, const void* mean,
                                const void* inv, const void* scale,
                                const void* bias, void* y, int R, int C,
                                int vec, int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(blocks, C, vec);
  const int rpb = rows_per_block(R, blocks);
  const float* xp = static_cast<const float*>(x);
  const float* mp = static_cast<const float*>(mean);
  const float* ip = static_cast<const float*>(inv);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  float* yp = static_cast<float*>(y);
  if (vec == 4) {
    bn_norm_relu_kernel<4><<<grid, kThreads, 0, st>>>(xp, mp, ip, sp, bp,
                                                      yp, R, C, rpb);
  } else {
    bn_norm_relu_kernel<1><<<grid, kThreads, 0, st>>>(xp, mp, ip, sp, bp,
                                                      yp, R, C, rpb);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tdt_bn_bwd_stats(const void* x, const void* g,
                                const void* mean, const void* inv,
                                const void* scale, const void* bias, int R,
                                int C, int vec, int blocks, void* pdb,
                                void* pds, void* dbias, void* dscale,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(blocks, C, vec);
  const int rpb = rows_per_block(R, blocks);
  const float* xp = static_cast<const float*>(x);
  const float* gp = static_cast<const float*>(g);
  const float* mp = static_cast<const float*>(mean);
  const float* ip = static_cast<const float*>(inv);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  float* pdbp = static_cast<float*>(pdb);
  float* pdsp = static_cast<float*>(pds);
  if (vec == 4) {
    bn_bwd_stats_kernel<4><<<grid, kThreads, 0, st>>>(
        xp, gp, mp, ip, sp, bp, R, C, rpb, pdbp, pdsp);
  } else {
    bn_bwd_stats_kernel<1><<<grid, kThreads, 0, st>>>(
        xp, gp, mp, ip, sp, bp, R, C, rpb, pdbp, pdsp);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_bwd_finish_kernel<<<finish_grid(C), kThreads, 0, st>>>(
      pdbp, pdsp, blocks, C, static_cast<float*>(dbias),
      static_cast<float*>(dscale));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tdt_bn_bwd_dx(const void* x, const void* g, const void* mean,
                             const void* inv, const void* scale,
                             const void* bias, const void* dbias,
                             const void* dscale, void* dx, int R, int C,
                             int vec, int blocks, float count,
                             float inv_count, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(blocks, C, vec);
  const int rpb = rows_per_block(R, blocks);
  const float* xp = static_cast<const float*>(x);
  const float* gp = static_cast<const float*>(g);
  const float* mp = static_cast<const float*>(mean);
  const float* ip = static_cast<const float*>(inv);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  const float* dbp = static_cast<const float*>(dbias);
  const float* dsp = static_cast<const float*>(dscale);
  float* dxp = static_cast<float*>(dx);
  if (vec == 4) {
    bn_bwd_dx_kernel<4><<<grid, kThreads, 0, st>>>(
        xp, gp, mp, ip, sp, bp, dbp, dsp, dxp, R, C, rpb, count, inv_count);
  } else {
    bn_bwd_dx_kernel<1><<<grid, kThreads, 0, st>>>(
        xp, gp, mp, ip, sp, bp, dbp, dsp, dxp, R, C, rpb, count, inv_count);
  }
  return static_cast<int>(cudaGetLastError());
}
