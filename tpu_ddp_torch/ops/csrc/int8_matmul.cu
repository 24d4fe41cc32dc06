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
// the ~295 FLOP/byte where the tensor cores become the limit. The design
// therefore spends its effort on streaming q once and coalesced:
//
//   - a block owns a tile of kBlockN = 128 output columns and all M rows
//     (up to MT = 32 rows per grid.z slice); one warp spans the 128
//     columns, each thread reading one char4 (4 columns) per k row, so a
//     warp reads one contiguous 128-byte row segment per k;
//   - kWarpsK warps split the block's K range row by row (k, k+8, ...),
//     so the 8 warps together read 8 consecutive rows per step;
//   - x is staged in shared memory as f32 in chunks of kChunkK columns and
//     read as a broadcast (all lanes of a warp read the same element);
//   - each thread keeps MT x 4 partial sums in registers;
//   - when the column tiles alone cannot fill the card (N = 2048 gives 16
//     tiles for 132 SMs), K is split across grid.y; each split writes an
//     f32 partial and a second small kernel sums the splits in a fixed
//     order and applies the scale, so results do not depend on timing.
//
// No tensor cores, TMA or pipelining yet: a simple kernel that is right
// comes first. M, K and N need no alignment; a ragged N takes a scalar
// path for the weight loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(M) * N;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  splitk_reduce_kernel<<<blocks, threads, 0, st>>>(pp, sp, op, M, N, splits);
  return static_cast<int>(cudaGetLastError());
}
