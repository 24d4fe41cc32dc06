// Fused BatchNorm (current-batch statistics) + ReLU for Hopper (sm_90a):
// the forward and backward halves, four kernels.
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
//     two reductions (bn_stats, bn_bwd_stats) combine across blocks inside
//     one launch (the "one_pass" kernels below):
//       * a block owns at most 32 channel groups (128 channels), so that
//         each lane walks many rows and a wide layer's combine spreads
//         over several column blocks (grid.y);
//       * each thread keeps U row loads in flight per step, into U
//         separate accumulators summed in a fixed order;
//       * the blocks of a thread-block cluster (up to 8 along grid.x) sum
//         their lanes in lane order, then the cluster's first block sums
//         the cluster's blocks in rank order through distributed shared
//         memory and writes one f32 partial row;
//       * that block fences, adds one to its column's arrival counter,
//         and the last to arrive sums every partial row with all its
//         threads (contiguous ranges per lane, lanes in order through
//         shared memory), writes mean and inv (dbias and dscale) and sets
//         the counter back to 0.
//     Every sum runs in an order fixed by the launch's shape, whichever
//     block arrives last, so a launch gives the same bits every time; no
//     float atomics. The counters live in a small zeroed workspace that
//     the wrapper allocates once per (device, stream) and that each
//     launch leaves zeroed.
//   - The previous design, a partials kernel and a second launch whose
//     threads each walk every block's partial of one channel in order
//     ("two_stage"), stays beside it for the same-run comparison.
//   - The elementwise passes load their per-channel vectors once per
//     thread. Every kernel uses the _rn intrinsics, so nvcc does not
//     contract a multiply and an add into one fused operation: an element
//     rounds as the plain PyTorch version (ops/bn_relu.py) rounds it, op
//     by op, and the reductions differ from it only in summation order
//     (the two-stage kernels keep their fused x*x and gy*x_hat).
//   - The variance is the reference's max(E[x^2] - mean^2, 0); inv is
//     1 / sqrt(var + eps). The variance clamp and the forward ReLU use
//     max_nan, which keeps a NaN as the plain versions' clamp_min and the
//     TPU kernel's jnp.maximum do (fmaxf would return the 0). The
//     backward's mask, g where y > 0 else 0, is the plain versions' and
//     the TPU kernel's jnp.where as it stands: a NaN y masks its g to 0,
//     and a NaN x_hat still reaches dscale and dx through the product.
//
// The wrapper (ops/bn_relu.py) passes only C-contiguous f32 tensors,
// chooses VEC from C and the pointers' alignment, and sizes the grids
// from the SM count (and, for the one-pass kernels, their occupancy).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
// The one-pass reductions: channel groups per block, most blocks in a
// cluster, and the column counters a workspace holds.
constexpr int kOnePassGroups = 32;
constexpr int kMaxCluster = 8;
constexpr int kCounters = 1024;

// max(v, lo) that keeps a NaN v (fmaxf returns lo for a NaN v); on every
// other input the same bits as the `v > lo ? v : lo` it replaces.
__device__ __forceinline__ float max_nan(float v, float lo) {
  return (v > lo || v != v) ? v : lo;
}

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
__device__ __forceinline__ Layout layout(int C, int max_groups = kThreads) {
  Layout l;
  const int cg_total = C / VEC;  // the wrapper guarantees C % VEC == 0
  l.cgb = min(cg_total, max_groups);
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
  // Through L2 only: partials that other blocks of this launch wrote.
  static __device__ __forceinline__ void load_cg(const float* p, float* v) {
    v[0] = __ldcg(p);
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
  static __device__ __forceinline__ void load_cg(const float* p, float* v) {
    const float4 t = __ldcg(reinterpret_cast<const float4*>(p));
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

// Two-stage bn_stats, stage 1: per-block partial sums of x and x*x.
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

// Two-stage bn_stats, stage 2: mean and inv per channel, partials
// summed in order.
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
  const float var = max_nan(q / count - m * m, 0.f);
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
      v[j] = max_nan(t, 0.f);
    }
    Vec<VEC>::store(y + i, v);
  }
}

// Two-stage bn_bwd_stats, stage 1: per-block partials of sum(gy) and
// sum(gy * x_hat), gy = g where the forward output was positive, else 0.
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

// Two-stage bn_bwd_stats, stage 2: dbias and dscale per channel,
// partials in order.
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

// ---- the one-pass reductions ---------------------------------------------

// Row loads each thread keeps in flight per step (one accumulator set
// each): bn_stats reads x alone, bn_bwd_stats x and g.
constexpr int kStatsUnroll = 4;
constexpr int kBwdUnroll = 2;

// Block b of the grid's rows [b * R / n, (b + 1) * R / n): with n <= R
// (the wrapper's plan) every block has rows, and their counts differ by
// at most one.
__device__ __forceinline__ int2 block_rows(int R) {
  const long long b = blockIdx.x;
  const long long n = gridDim.x;
  return make_int2(static_cast<int>(b * R / n),
                   static_cast<int>((b + 1) * R / n));
}

// Sum U accumulator sets into the first, in set order.
template <int U, int VEC>
__device__ __forceinline__ void fold(float (&a)[U][VEC]) {
#pragma unroll
  for (int u = 1; u < U; ++u) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) a[0][j] += a[u][j];
  }
}

// Sum two per-thread accumulators over the block's lanes, in lane order,
// into ra and rb (l.cgb * VEC entries each: the block's channels).
template <int VEC>
__device__ __forceinline__ void lane_sums(const Layout& l, const float* a,
                                          const float* b, float* sa,
                                          float* sb, float* ra, float* rb) {
  const int width = l.cgb * VEC;
  if (l.lane < l.lanes) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      sa[l.lane * width + l.local * VEC + j] = a[j];
      sb[l.lane * width + l.local * VEC + j] = b[j];
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < width; t += kThreads) {
    float s = 0.f;
    float q = 0.f;
    for (int ln = 0; ln < l.lanes; ++ln) {
      s += sa[ln * width + t];
      q += sb[ln * width + t];
    }
    ra[t] = s;
    rb[t] = q;
  }
  __syncthreads();
}

// The combine across blocks, after lane_sums. The first block of each
// cluster (K blocks along grid.x) sums its blocks' ra, rb in rank order
// through distributed shared memory and writes partial row blockIdx.x / K
// of pa, pb (gridDim.x / K rows of C floats each). It then arrives on its
// column's counter; the last block to arrive sums every partial row of
// the column (each lane a contiguous range, four loads in flight, lanes
// in order), leaves the per-channel totals in ra, rb, sets the counter
// back to 0 and returns true. Every other block returns false.
template <int VEC>
__device__ __forceinline__ bool combine(const Layout& l, int C, float* sa,
                                        float* sb, float* ra, float* rb,
                                        float* pa, float* pb,
                                        unsigned* counters) {
  __shared__ int last;
  cg::cluster_group cluster = cg::this_cluster();
  const int K = static_cast<int>(cluster.num_blocks());
  const int width = l.cgb * VEC;
  const int parts = static_cast<int>(gridDim.x) / K;
  const bool leader = cluster.block_rank() == 0;
  cluster.sync();  // every block's lane sums are in place
  if (leader && threadIdx.x < 2 * width) {
    const int t = threadIdx.x % width;
    float* src = threadIdx.x < width ? ra : rb;
    float part[kMaxCluster];  // every remote read in flight at once
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k) {
      part[k] = k < K ? *cluster.map_shared_rank(src + t, k) : 0.f;
    }
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k) sum += part[k];
    const int c = blockIdx.y * width + t;
    if (c < C) {
      (threadIdx.x < width ? pa : pb)[
          static_cast<size_t>(blockIdx.x / K) * C + c] = sum;
    }
  }
  cluster.sync();  // no block leaves while the leader reads its sums
  if (!leader) return false;
  __threadfence();  // this block's partial row, before its arrival
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counters + blockIdx.y, 1u) ==
           static_cast<unsigned>(parts - 1);
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();  // every arrival's partial row, before the reads
  float a[4][VEC];
  float b[4][VEC];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      a[u][j] = 0.f;
      b[u][j] = 0.f;
    }
  }
  if (l.active) {
    const int p0 = static_cast<int>(static_cast<long long>(l.lane) * parts /
                                    l.lanes);
    const int p1 = static_cast<int>(
        static_cast<long long>(l.lane + 1) * parts / l.lanes);
    const size_t off = static_cast<size_t>(l.cg) * VEC;
    for (int p = p0; p < p1; p += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (p + u < p1) {
          float va[VEC], vb[VEC];
          Vec<VEC>::load_cg(pa + static_cast<size_t>(p + u) * C + off, va);
          Vec<VEC>::load_cg(pb + static_cast<size_t>(p + u) * C + off, vb);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            a[u][j] += va[j];
            b[u][j] += vb[j];
          }
        }
      }
    }
  }
  fold<4, VEC>(a);
  fold<4, VEC>(b);
  lane_sums<VEC>(l, a[0], b[0], sa, sb, ra, rb);
  if (threadIdx.x == 0) counters[blockIdx.y] = 0u;
  return true;
}

// bn_stats in one launch: per-channel sums of x and x*x, combined across
// blocks, then mean and inv. Grid (blocks, column blocks), clusters of K
// along x.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
bn_stats_onepass_kernel(const float* __restrict__ x, int R, int C,
                        float* __restrict__ ps, float* __restrict__ pq,
                        unsigned* __restrict__ counters, float count,
                        float eps, float* __restrict__ mean,
                        float* __restrict__ inv) {
  constexpr int U = kStatsUnroll;
  __shared__ float sa[kThreads * VEC];
  __shared__ float sb[kThreads * VEC];
  __shared__ float ra[kOnePassGroups * VEC];
  __shared__ float rb[kOnePassGroups * VEC];
  const Layout l = layout<VEC>(C, kOnePassGroups);
  float s[U][VEC];
  float q[U][VEC];
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      s[u][j] = 0.f;
      q[u][j] = 0.f;
    }
  }
  if (l.active) {
    const int2 rows = block_rows(R);
    const float* base = x + static_cast<size_t>(l.cg) * VEC;
    const int step = l.lanes;
    int r = rows.x + l.lane;
    for (; r + (U - 1) * step < rows.y; r += U * step) {
      float v[U][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        Vec<VEC>::load(base + static_cast<size_t>(r + u * step) * C, v[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          s[u][j] += v[u][j];
          q[u][j] = __fadd_rn(q[u][j], __fmul_rn(v[u][j], v[u][j]));
        }
      }
    }
#pragma unroll
    for (int u = 0; u + 1 < U; ++u) {  // the last rows, fewer than U
      if (r + u * step < rows.y) {
        float v[VEC];
        Vec<VEC>::load(base + static_cast<size_t>(r + u * step) * C, v);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          s[u][j] += v[j];
          q[u][j] = __fadd_rn(q[u][j], __fmul_rn(v[j], v[j]));
        }
      }
    }
  }
  fold<U, VEC>(s);
  fold<U, VEC>(q);
  lane_sums<VEC>(l, s[0], q[0], sa, sb, ra, rb);
  if (!combine<VEC>(l, C, sa, sb, ra, rb, ps, pq, counters)) return;
  const int width = l.cgb * VEC;
  for (int t = threadIdx.x; t < width; t += kThreads) {
    const int c = blockIdx.y * width + t;
    if (c < C) {
      const float m = __fdiv_rn(ra[t], count);
      const float var = max_nan(
          __fsub_rn(__fdiv_rn(rb[t], count), __fmul_rn(m, m)), 0.f);
      mean[c] = m;
      inv[c] = 1.f / sqrtf(__fadd_rn(var, eps));
    }
  }
}

// One row of x and g into the accumulators db, ds: the ReLU-masked
// gradient and its product with x_hat, rounded as the plain version.
template <int VEC>
__device__ __forceinline__ void bwd_terms(const float* xv, const float* gv,
                                          const float* m, const float* iv,
                                          const float* sc, const float* b,
                                          float* db, float* ds) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float xh = __fmul_rn(__fsub_rn(xv[j], m[j]), iv[j]);
    const float yv = __fadd_rn(__fmul_rn(xh, sc[j]), b[j]);
    const float gy = yv > 0.f ? gv[j] : 0.f;
    db[j] += gy;
    ds[j] = __fadd_rn(ds[j], __fmul_rn(gy, xh));
  }
}

// bn_bwd_stats in one launch: per-channel sum(gy) and sum(gy * x_hat),
// gy = g where the forward output was positive, else 0.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
bn_bwd_stats_onepass_kernel(const float* __restrict__ x,
                            const float* __restrict__ g,
                            const float* __restrict__ mean,
                            const float* __restrict__ inv,
                            const float* __restrict__ scale,
                            const float* __restrict__ bias, int R, int C,
                            float* __restrict__ pdb,
                            float* __restrict__ pds,
                            unsigned* __restrict__ counters,
                            float* __restrict__ dbias,
                            float* __restrict__ dscale) {
  constexpr int U = kBwdUnroll;
  __shared__ float sa[kThreads * VEC];
  __shared__ float sb[kThreads * VEC];
  __shared__ float ra[kOnePassGroups * VEC];
  __shared__ float rb[kOnePassGroups * VEC];
  const Layout l = layout<VEC>(C, kOnePassGroups);
  float db[U][VEC];
  float ds[U][VEC];
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      db[u][j] = 0.f;
      ds[u][j] = 0.f;
    }
  }
  if (l.active) {
    const size_t off = static_cast<size_t>(l.cg) * VEC;
    float m[VEC], iv[VEC], sc[VEC], b[VEC];
    Vec<VEC>::load(mean + off, m);
    Vec<VEC>::load(inv + off, iv);
    Vec<VEC>::load(scale + off, sc);
    Vec<VEC>::load(bias + off, b);
    const int2 rows = block_rows(R);
    const int step = l.lanes;
    int r = rows.x + l.lane;
    for (; r + (U - 1) * step < rows.y; r += U * step) {
      float xv[U][VEC], gv[U][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const size_t i = static_cast<size_t>(r + u * step) * C + off;
        Vec<VEC>::load(x + i, xv[u]);
        Vec<VEC>::load(g + i, gv[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        bwd_terms<VEC>(xv[u], gv[u], m, iv, sc, b, db[u], ds[u]);
      }
    }
#pragma unroll
    for (int u = 0; u + 1 < U; ++u) {  // the last rows, fewer than U
      if (r + u * step < rows.y) {
        const size_t i = static_cast<size_t>(r + u * step) * C + off;
        float xv[VEC], gv[VEC];
        Vec<VEC>::load(x + i, xv);
        Vec<VEC>::load(g + i, gv);
        bwd_terms<VEC>(xv, gv, m, iv, sc, b, db[u], ds[u]);
      }
    }
  }
  fold<U, VEC>(db);
  fold<U, VEC>(ds);
  lane_sums<VEC>(l, db[0], ds[0], sa, sb, ra, rb);
  if (!combine<VEC>(l, C, sa, sb, ra, rb, pdb, pds, counters)) return;
  const int width = l.cgb * VEC;
  for (int t = threadIdx.x; t < width; t += kThreads) {
    const int c = blockIdx.y * width + t;
    if (c < C) {
      dbias[c] = ra[t];
      dscale[c] = rb[t];
    }
  }
}

// Column blocks of a one-pass grid, or -1 when the plan is not one the
// kernels take: 1 <= cluster <= kMaxCluster, blocks a multiple of cluster
// and at most R, at most kCounters column blocks.
int onepass_columns(int R, int C, int vec, int blocks, int cluster) {
  const int groups = C / vec;
  const int cgb = groups < kOnePassGroups ? groups : kOnePassGroups;
  const int cols = (groups + cgb - 1) / cgb;
  if (cluster < 1 || cluster > kMaxCluster || blocks < cluster ||
      blocks % cluster != 0 || blocks > R || cols > kCounters) {
    return -1;
  }
  return cols;
}

template <typename... Params, typename... Args>
int launch_clustered(void (*kernel)(Params...), int blocks, int cols,
                     int cluster, cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, cols);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, args...));
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
// tdt_bn_stats and tdt_bn_bwd_stats are the two-stage reductions.

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

// The one-pass reductions. blocks (a multiple of cluster, at most R) and
// cluster (1 to 8) come from the wrapper's plan; the partials hold
// blocks / cluster rows of C floats each; counters is the zeroed
// workspace of the stream (at least one per column block), which the
// launch leaves zeroed. Returns cudaErrorInvalidValue for a plan the
// kernels do not take.
extern "C" int tdt_bn_stats_onepass(const void* x, int R, int C, int vec,
                                    int blocks, int cluster, void* ps,
                                    void* pq, void* counters, float eps,
                                    void* mean, void* inv, void* stream) {
  const int cols = onepass_columns(R, C, vec, blocks, cluster);
  if (cols < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* psp = static_cast<float*>(ps);
  float* pqp = static_cast<float*>(pq);
  unsigned* cp = static_cast<unsigned*>(counters);
  float* mp = static_cast<float*>(mean);
  float* ip = static_cast<float*>(inv);
  const float count = static_cast<float>(R);
  if (vec == 4) {
    return launch_clustered(bn_stats_onepass_kernel<4>, blocks, cols,
                            cluster, st, xp, R, C, psp, pqp, cp, count, eps,
                            mp, ip);
  }
  return launch_clustered(bn_stats_onepass_kernel<1>, blocks, cols, cluster,
                          st, xp, R, C, psp, pqp, cp, count, eps, mp, ip);
}

extern "C" int tdt_bn_bwd_stats_onepass(
    const void* x, const void* g, const void* mean, const void* inv,
    const void* scale, const void* bias, int R, int C, int vec, int blocks,
    int cluster, void* pdb, void* pds, void* counters, void* dbias,
    void* dscale, void* stream) {
  const int cols = onepass_columns(R, C, vec, blocks, cluster);
  if (cols < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* gp = static_cast<const float*>(g);
  const float* mp = static_cast<const float*>(mean);
  const float* ip = static_cast<const float*>(inv);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  float* pdbp = static_cast<float*>(pdb);
  float* pdsp = static_cast<float*>(pds);
  unsigned* cp = static_cast<unsigned*>(counters);
  float* dbp = static_cast<float*>(dbias);
  float* dsp = static_cast<float*>(dscale);
  if (vec == 4) {
    return launch_clustered(bn_bwd_stats_onepass_kernel<4>, blocks, cols,
                            cluster, st, xp, gp, mp, ip, sp, bp, R, C, pdbp,
                            pdsp, cp, dbp, dsp);
  }
  return launch_clustered(bn_bwd_stats_onepass_kernel<1>, blocks, cols,
                          cluster, st, xp, gp, mp, ip, sp, bp, R, C, pdbp,
                          pdsp, cp, dbp, dsp);
}

// Resident blocks per SM of a one-pass kernel (bwd 0: bn_stats, 1:
// bn_bwd_stats) at vec, into *out: the wrapper sizes the grid to fill
// every SM once at this occupancy.
extern "C" int tdt_bn_onepass_blocks_per_sm(int bwd, int vec, int* out) {
  cudaError_t err;
  if (bwd) {
    err = vec == 4 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         out, bn_bwd_stats_onepass_kernel<4>, kThreads, 0)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         out, bn_bwd_stats_onepass_kernel<1>, kThreads, 0);
  } else {
    err = vec == 4 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         out, bn_stats_onepass_kernel<4>, kThreads, 0)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         out, bn_stats_onepass_kernel<1>, kThreads, 0);
  }
  return static_cast<int>(err);
}
