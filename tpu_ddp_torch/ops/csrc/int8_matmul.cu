// Weight-only int8 matmul for Hopper (sm_90a):
//
//     out[m, n] = (sum_k f32(x[m, k]) * f32(q[k, n])) * s[n]
//
// Replaces tpu_ddp/ops/pallas/quant_matmul.py:int8_matmul (the Pallas
// kernel _qmm_kernel behind _qmm): every x element and every int8 weight
// converted to f32, an f32 accumulate over K, and the per-output-column
// scale applied in the epilogue.
//
// What bounds it on this card: bytes. On the serving path M is the slot
// bank (8 rows) or one prefill chunk (32 rows) while the weight panel is
// a whole projection (K x N int8, up to 64 MB for the LM head), so the
// arithmetic intensity is at most 2 * 32 FLOP per weight byte, far below
// the ~295 FLOP/byte where the tensor cores become the limit. Both
// designs stream q once; two launches of either give the same bits.
//
// mma (int8_matmul_mma_kernel; bf16 x, 16-byte-aligned x rows and q, N a
// multiple of 16: every serving shape):
//   - An int8 weight is exact in bf16 (|q| <= 128 < 2^8), so bf16
//     tensor-core products with f32 accumulation compute the same sums as
//     the f32 path, in another order. The weight is the wide side: a
//     block owns 128 output columns, each warp 64 of them as four m16
//     tiles of mma.sync.m16n8k16, and the M rows of x are the narrow n8
//     side (one product per 8 rows, up to MT = 32 rows per grid.z slice).
//   - The weight panel streams through a four-stage ring of TMA copies
//     (a 64-row x 128-column tile a stage, one copy completing on an
//     mbarrier; x's matching columns beside it by 16-byte cp.async), so
//     three stages are in flight while one is multiplied; two warps split
//     each stage's 64 rows 32 apiece. A cp.async ring of 16-byte copies
//     was slower on the H100 at every depth, stage height, tile width and
//     L2 prefetch hint tried.
//   - int8 -> bf16 is converted in registers with no I2F: a thread reads
//     32-bit words of 4 neighbouring columns, and the A-fragment rows are
//     assigned to columns so that byte j of a word feeds m16 tile j; a
//     byte pair becomes a bf16x2 by one byte permute, two masks that give
//     bf16(128 + (b & 0x7f)) and bf16(128 + (b & 0x80)), and one exact
//     bf16x2 subtract.
//   - x (the B operand) is read from shared memory as 32-bit k pairs from
//     rows padded by 16 bytes; the q tile lies in the TMA's 128-byte
//     swizzle. Both reads are free of bank conflicts.
//   - The K splits of a column tile (at most 16) form one thread-block
//     cluster: each block leaves its sum in shared memory and the blocks
//     then sum every split's share through distributed shared memory,
//     splits in a fixed order, and apply the scale. No partials go to
//     device memory and no second launch is needed.
//
// simt (int8_matmul_kernel; f32 x, the parity path, and ragged shapes):
//   - a block owns a tile of kBlockN = 128 output columns and all M rows
//     (up to MT = 32 rows per grid.z slice); one warp spans the 128
//     columns, each thread reading one char4 (4 columns) per k row, so a
//     warp reads one contiguous 128-byte row segment per k;
//   - kWarpsK warps split the block's K range row by row (k, k+8, ...),
//     so the 8 warps together read 8 consecutive rows per step;
//   - x is staged in shared memory as f32 in chunks of kChunkK columns and
//     read as a broadcast (all lanes of a warp read the same element);
//   - each thread keeps MT x 4 partial sums in registers; M, K and N need
//     no alignment; a ragged N takes a scalar path for the weight loads.
//
// simt: when the column tiles alone cannot fill the card (N = 2048 gives
// 16 tiles for 132 SMs), K is split across grid.y; each split writes an
// f32 partial and a second small kernel sums the splits in a fixed order
// and applies the scale, so results do not depend on timing.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kColsPerThread = 4;
constexpr int kThreadsX = 32;
constexpr int kBlockN = kThreadsX * kColsPerThread;  // 128 columns
constexpr int kWarpsK = 8;
constexpr int kThreads = kThreadsX * kWarpsK;        // 256 threads
constexpr int kChunkK = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int MT>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ s, float* __restrict__ out,
                   float* __restrict__ partial, int M, int K, int N,
                   int k_per_split) {
  __shared__ float xs[MT][kChunkK];
  __shared__ __align__(16) float red[kWarpsK][kBlockN];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const int n0 = blockIdx.x * kBlockN + tx * kColsPerThread;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  // q rows start at k * N bytes: 4-byte aligned for every k only when
  // N % 4 == 0 (the wrapper checks the base pointer).
  const bool vec = (N % kColsPerThread) == 0;

  float acc[MT][kColsPerThread];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[m][j] = 0.f;

  for (int kc = k_begin; kc < k_end; kc += kChunkK) {
    const int kn = min(kChunkK, k_end - kc);
    __syncthreads();  // the previous chunk's xs reads are done
    for (int i = tid; i < MT * kChunkK; i += kThreads) {
      const int m = i / kChunkK;
      const int kk = i - m * kChunkK;
      float v = 0.f;
      if (m0 + m < M && kk < kn) {
        v = to_f32(x[static_cast<size_t>(m0 + m) * K + kc + kk]);
      }
      xs[m][kk] = v;
    }
    __syncthreads();
    if (n0 < N) {
#pragma unroll 4
      for (int kk = ty; kk < kn; kk += kWarpsK) {
        const int8_t* row = q + static_cast<size_t>(kc + kk) * N + n0;
        float w[kColsPerThread];
        if (vec) {
          const char4 c = __ldg(reinterpret_cast<const char4*>(row));
          w[0] = static_cast<float>(c.x);
          w[1] = static_cast<float>(c.y);
          w[2] = static_cast<float>(c.z);
          w[3] = static_cast<float>(c.w);
        } else {
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) {
            w[j] = (n0 + j < N) ? static_cast<float>(__ldg(row + j)) : 0.f;
          }
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = xs[m][kk];
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) {
            acc[m][j] = fmaf(xv, w[j], acc[m][j]);
          }
        }
      }
    }
  }

  // Sum the kWarpsK partial sums of each column, one row at a time.
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m0 + m < M) {  // uniform across the block
      *reinterpret_cast<float4*>(&red[ty][tx * kColsPerThread]) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      __syncthreads();
      if (tid < kBlockN) {
        const int n = blockIdx.x * kBlockN + tid;
        if (n < N) {
          float sum = 0.f;
#pragma unroll
          for (int w = 0; w < kWarpsK; ++w) sum += red[w][tid];
          const size_t row = static_cast<size_t>(m0 + m);
          if (partial == nullptr) {
            out[row * N + n] = sum * s[n];
          } else {
            partial[(static_cast<size_t>(split) * M + row) * N + n] = sum;
          }
        }
      }
      __syncthreads();
    }
  }
}

// out[i] = s[n] * sum over splits of partial[split, i], splits in order.
__global__ void splitk_reduce_kernel(const float* __restrict__ partial,
                                     const float* __restrict__ s,
                                     float* __restrict__ out, int M, int N,
                                     int splits) {
  const size_t total = static_cast<size_t>(M) * N;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float sum = 0.f;
  for (int sp = 0; sp < splits; ++sp) sum += partial[sp * total + i];
  out[i] = sum * s[i % N];
}

template <typename T, int MT>
void launch(const void* x, const int8_t* q, const float* s, float* out,
            float* partial, int M, int K, int N, int splits,
            int k_per_split, cudaStream_t stream) {
  const dim3 grid((N + kBlockN - 1) / kBlockN, splits, (M + MT - 1) / MT);
  const dim3 block(kThreadsX, kWarpsK);
  int8_matmul_kernel<T, MT><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), q, s, out, splits > 1 ? partial : nullptr,
      M, K, N, k_per_split);
}

template <typename T>
void launch_rows(const void* x, const int8_t* q, const float* s, float* out,
                 float* partial, int M, int K, int N, int splits,
                 int k_per_split, cudaStream_t stream) {
  if (M <= 8) {
    launch<T, 8>(x, q, s, out, partial, M, K, N, splits, k_per_split, stream);
  } else if (M <= 16) {
    launch<T, 16>(x, q, s, out, partial, M, K, N, splits, k_per_split,
                  stream);
  } else {
    launch<T, 32>(x, q, s, out, partial, M, K, N, splits, k_per_split,
                  stream);
  }
}

// ---- mma route: bf16 tensor cores, TMA ring --------------------------------

constexpr int kMmaBN = 128;       // output columns per block: one 128-byte row
constexpr int kMmaBK = 64;        // k rows per stage
constexpr int kMmaStages = 4;
constexpr int kMmaThreads = 128;  // warps: 2 column halves x 2 k halves
constexpr int kMaxClusterSplits = 16;  // a non-portable cluster size
constexpr int kQTile = kMmaBK * kMmaBN;  // bytes of one staged q tile
constexpr int kXRowElems = kMmaBK + 8;   // staged x row (bf16), padded

template <int MT>
__host__ __device__ constexpr int mma_x_stage_bytes() {
  return MT * kXRowElems * 2;
}
// The q ring (1024-byte aligned for the swizzle), the x ring, one barrier
// per stage, and slack to align the base. After the loop the q ring holds
// the two k halves' partial sums (2 * MT * kMmaBN floats).
template <int MT>
__host__ __device__ constexpr int mma_smem_bytes() {
  return 1024 + kMmaStages * (kQTile + mma_x_stage_bytes<MT>() + 8);
}
static_assert(2 * 32 * kMmaBN * 4 <= kMmaStages * kQTile,
              "the partial sums must fit in the q ring");

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// {lo = byte j of wa, hi = byte j of wb} as bf16x2 (j a constant after
// unrolling), exactly: for an int8 b, bf16 bits 0x4300 | (b & 0x7f) are
// 128 + (b & 0x7f) and 0x4300 | (b & 0x80) are 128 or 256, whose
// difference is b.
__device__ __forceinline__ uint32_t i8x2_bf16x2(uint32_t wa, uint32_t wb,
                                                int j) {
  const uint32_t p = __byte_perm(wa, wb, j | ((4 + j) << 8));
  const uint32_t mag = (p & 0x007F007Fu) | 0x43004300u;
  const uint32_t off = (p & 0x00800080u) | 0x43004300u;
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&mag),
                             *reinterpret_cast<const __nv_bfloat162*>(&off));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Block (128-column tile, K split, row tile of MT); the K splits of a
// tile form one cluster along grid.y. Warp w owns columns 64 (w & 1) ..
// + 63 of the tile and k rows 32 (w >> 1) .. + 31 of every stage. Lane
// (g = lane / 4, t = lane % 4): row g of m16 tile j is the warp's column
// 4 g + j and row g + 8 its column 32 + 4 g + j, so the word of columns
// 4 g .. 4 g + 3 in one k row holds a value of all four tiles. A staged q
// row is one 128-byte line in the TMA's 128-byte swizzle: its 16-byte
// chunk c lies at chunk c ^ (row % 8), which also keeps the word reads
// free of bank conflicts.
template <int MT>
__global__ void __launch_bounds__(kMmaThreads)
int8_matmul_mma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ s, float* __restrict__ out,
                       int M, int K, int N, int k_per_split) {
  constexpr int XSTAGE = mma_x_stage_bytes<MT>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t qring = (raw + 1023) & ~1023u;
  const uint32_t xring = qring + kMmaStages * kQTile;
  const uint32_t bar0 = xring + kMmaStages * XSTAGE;
  unsigned char* smem = smem_raw + (qring - raw);  // generic view of qring

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wc = warp & 1, wk = warp >> 1;
  const int n0 = blockIdx.x * kMmaBN;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int n_it = (k_end - k_begin + kMmaBK - 1) / kMmaBK;

  // One stage: a 64 x 128 q tile by one TMA copy (rows past K, columns
  // past N arrive as zeros; a split ends on a stage boundary or at K) and
  // MT x 64 x columns by 16-byte cp.async copies, zero past k_end or M.
  auto load = [&](int it) {
    const int slot = it % kMmaStages;
    const int k0 = k_begin + it * kMmaBK;
    if (tid == 0) {
      const uint32_t bar = bar0 + 8 * slot;
      mbar_expect(bar, kQTile);
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
          ::"r"(qring + slot * kQTile), "l"(reinterpret_cast<uint64_t>(&tq)),
          "r"(n0), "r"(k0), "r"(bar)
          : "memory");
    }
    const uint32_t xs = xring + slot * XSTAGE;
    for (int i = tid; i < MT * kMmaBK / 8; i += kMmaThreads) {
      const int r = i / (kMmaBK / 8), c = 8 * (i % (kMmaBK / 8));
      const bool ok = m0 + r < M && k0 + c < k_end;
      cp_async16(xs + 2 * (r * kXRowElems + c),
                 ok ? x + static_cast<size_t>(m0 + r) * K + k0 + c : x, ok);
    }
  };

  if (tid == 0) {
    for (int i = 0; i < kMmaStages; ++i) mbar_init(bar0 + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[4][MT / 8][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < MT / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][i][e] = 0.f;

#pragma unroll
  for (int it = 0; it < kMmaStages - 1; ++it) {
    if (it < n_it) load(it);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int it = 0; it < n_it; ++it) {
    const int slot = it % kMmaStages;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kMmaStages - 2)
                 : "memory");
    mbar_wait(bar0 + 8 * slot, (it / kMmaStages) & 1);
    __syncthreads();  // this stage landed; the stage reloaded below is free
    if (it + kMmaStages - 1 < n_it) load(it + kMmaStages - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    const unsigned char* qt = smem + slot * kQTile;
    const __nv_bfloat16* xt = reinterpret_cast<const __nv_bfloat16*>(
        smem_raw + (xring - raw) + slot * XSTAGE);
#pragma unroll
    for (int u = 0; u < 2; ++u) {  // this warp's two k16 steps
      const int k16 = 32 * wk + 16 * u;
      uint32_t lo[4], hi[4];  // k rows 2t, 2t+1, 2t+8, 2t+9
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = k16 + 2 * t + (r & 1) + 8 * (r >> 1);
        const int chunk = 4 * wc + g / 4;  // columns 64 wc + 4 g
        const unsigned char* line = qt + row * kMmaBN + 4 * (g % 4);
        lo[r] = *reinterpret_cast<const uint32_t*>(
            line + 16 * (chunk ^ (row % 8)));
        hi[r] = *reinterpret_cast<const uint32_t*>(
            line + 16 * ((chunk + 2) ^ (row % 8)));
      }
      uint32_t b[MT / 8][2];
#pragma unroll
      for (int i = 0; i < MT / 8; ++i) {
        const __nv_bfloat16* row = xt + (8 * i + g) * kXRowElems + k16 + 2 * t;
        b[i][0] = *reinterpret_cast<const uint32_t*>(row);
        b[i][1] = *reinterpret_cast<const uint32_t*>(row + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t a0 = i8x2_bf16x2(lo[0], lo[1], j);
        const uint32_t a1 = i8x2_bf16x2(hi[0], hi[1], j);
        const uint32_t a2 = i8x2_bf16x2(lo[2], lo[3], j);
        const uint32_t a3 = i8x2_bf16x2(hi[2], hi[3], j);
#pragma unroll
        for (int i = 0; i < MT / 8; ++i) {
          mma_bf16(acc[j][i], a0, a1, a2, a3, b[i][0], b[i][1]);
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // every stage is consumed: the q ring is free

  // red[h][m][c]: k half h's sum for row m and tile column c; then the
  // block's sum, k halves in order, replaces red[0].
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < MT / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 8 * i + 2 * t + (e & 1);
        const int c = 64 * wc + 4 * g + j + 32 * (e >> 1);
        red[(wk * MT + m) * kMmaBN + c] = acc[j][i][e];
      }
  __syncthreads();
  for (int i = tid; i < MT * kMmaBN; i += kMmaThreads) {
    red[i] += red[MT * kMmaBN + i];
  }
  // Block r of the cluster sums its share of the tile over every split's
  // shared memory, splits in order (the same bits every launch), and
  // applies the scale.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's sums are in place
  const int splits = static_cast<int>(gridDim.y);
  const int share = (MT * kMmaBN + splits - 1) / splits;
  const int end = min(MT * kMmaBN, (split + 1) * share);
  for (int i = split * share + tid; i < end; i += kMmaThreads) {
    const int m = i / kMmaBN, n = n0 + i % kMmaBN;
    float part[kMaxClusterSplits];  // every remote read in flight at once
#pragma unroll
    for (int sp = 0; sp < kMaxClusterSplits; ++sp) {
      part[sp] = sp < splits ? cluster.map_shared_rank(red, sp)[i] : 0.f;
    }
    float sum = 0.f;
#pragma unroll
    for (int sp = 0; sp < kMaxClusterSplits; ++sp) sum += part[sp];
    if (m0 + m < M && n < N) {
      out[static_cast<size_t>(m0 + m) * N + n] = sum * s[n];
    }
  }
  cluster.sync();  // no block leaves while another reads its sums
}

// The 2-D tensor map (N, K) of the int8 (K, N) weight: a 128 x 64 box,
// 128-byte swizzle, zeros past the edges.
bool weight_map(CUtensorMap* map, const void* q, int K, int N) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(K)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N)};
  const cuuint32_t box[2] = {kMmaBN, kMmaBK};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(q),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MT>
int launch_mma(const CUtensorMap& tq, const void* x, const float* s,
               float* out, int M, int K, int N, int splits, int k_per_split,
               cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<MT>();
  cudaError_t err = cudaFuncSetAttribute(
      int8_matmul_mma_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(int8_matmul_mma_kernel<MT>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kMmaBN - 1) / kMmaBN, splits, (M + MT - 1) / MT);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, int8_matmul_mma_kernel<MT>, tq,
      static_cast<const __nv_bfloat16*>(x), s, out, M, K, N, k_per_split));
}

int reduce_splits(float* partial, const float* s, float* out, int M, int N,
                  int splits, cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(M) * N;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  splitk_reduce_kernel<<<blocks, threads, 0, st>>>(partial, s, out, M, N,
                                                   splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. x is (M, K) row-major f32
// (x_is_bf16 == 0) or bf16 (x_is_bf16 == 1); q is (K, N) row-major int8;
// s is (N,) f32; out is (M, N) f32. partial holds splits * M * N f32 and
// is read only when splits > 1; k_per_split * splits must cover K.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int tdt_int8_matmul(const void* x, int x_is_bf16, const void* q,
                               const void* s, void* out, void* partial,
                               int M, int K, int N, int splits,
                               int k_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(s);
  float* op = static_cast<float*>(out);
  float* pp = static_cast<float*>(partial);
  if (x_is_bf16) {
    launch_rows<__nv_bfloat16>(x, qp, sp, op, pp, M, K, N, splits,
                               k_per_split, st);
  } else {
    launch_rows<float>(x, qp, sp, op, pp, M, K, N, splits, k_per_split, st);
  }
  return reduce_splits(pp, sp, op, M, N, splits, st);
}

// The mma route: the same arguments but partial, for bf16 x (M, K) with
// K % 8 == 0, x and q 16-byte aligned and N % 16 == 0 (the TMA's and the
// 16-byte copies' terms); any M. The 1 to 16 K splits of a tile form one
// cluster and sum in shared memory; k_per_split must be a multiple of 64
// (a stage) when splits > 1. Returns cudaErrorInvalidValue if the weight's
// tensor map cannot be encoded.
extern "C" int tdt_int8_matmul_mma(const void* x, const void* q,
                                   const void* s, void* out, int M, int K,
                                   int N, int splits, int k_per_split,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(s);
  float* op = static_cast<float*>(out);
  CUtensorMap tq;
  if (splits < 1 || splits > kMaxClusterSplits ||
      (splits > 1 && k_per_split % kMmaBK != 0) || !weight_map(&tq, q, K, N)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M <= 8) {
    return launch_mma<8>(tq, x, sp, op, M, K, N, splits, k_per_split, st);
  }
  if (M <= 16) {
    return launch_mma<16>(tq, x, sp, op, M, K, N, splits, k_per_split, st);
  }
  return launch_mma<32>(tq, x, sp, op, M, K, N, splits, k_per_split, st);
}
