// Flash attention for Hopper (sm_90a): the forward, the dk/dv sweep and
// the dq sweep of an exact softmax attention over (B, L, H, D) tensors,
// causal or not, with grouped-query K/V (KV heads shared by H / KV
// consecutive q heads).
//
// Replaces the three Pallas calls of tpu_ddp/ops/pallas/flash_attention.py:
//   tdt_flash_fwd(_wgmma)    <- _fwd_kernel via _fwd_impl (call at :193)
//   tdt_flash_bwd_kv(_wgmma) <- _bwd_kv_kernel            (call at :334)
//   tdt_flash_bwd_q(_wgmma)  <- _bwd_q_kernel             (call at :357)
// with the same arithmetic: scores s = (q . k) * scale in f32, masked by
// absolute position with the -1e30 sentinel (never -inf, so that
// m_prev - m_new stays finite), an f32 online-softmax state, p rounded to
// the input type before p . v, the logsumexp saved for the backward, and
// in the backward p = exp(s - lse), ds = p * (dp - delta) * scale with p
// and ds rounded to the input type before their products.
//
// What bounds it on this card: operations. At TransformerLM-large's
// shape (B*H = 64, L = 2048, D = 128, bf16, causal) the forward does
// 2 * L^2 * D * B*H = 6.9e10 FLOP (after causal skipping) against 134 MB
// of q, k, v and o: about 500 FLOP per byte, above the ~295 where the
// tensor cores and not HBM become the limit; the two backward sweeps do
// 7 products per (q, k) pair (s and dp are recomputed in both, the price
// of a deterministic dq without atomics): 2.9 ms at the bf16 peak for
// the 12 layers of one LM-large step. So the design keeps the (L, L)
// scores out of device memory and feeds the tensor cores.
//
// Two designs:
//
// mma.sync (every kernel for f32, D other than 64 and 128, and inputs
// the TMA cannot address):
//   - FA-2 shape. A block of 4 warps owns a 64-row tile (q rows in the
//     forward and the dq sweep, kv rows in the dk/dv sweep) and loops over
//     64-row tiles of the other side, staged in shared memory. Each warp
//     owns 16 rows, and its accumulators (o, dq, or dk and dv) stay in
//     registers for the whole loop.
//   - Products run on the tensor cores with mma.sync.m16n8k16 (bf16 in,
//     f32 accumulate). The f32 path, the parity path, runs the same code
//     with the tensor-core product replaced by f32 FMAs in the same
//     register layout: no TF32 anywhere.
//   - The score tile lives in the mma accumulator layout, so the row max
//     and row sum of the online softmax are a register reduction plus two
//     shuffles. p (and ds) go through shared memory, rounded to the input
//     type, as the A operand of the next product.
//   - L is masked inside the kernel (rows >= L are neither read as keys
//     nor stored), and a head dim D < 64 or 64 < D < 128 is zero-filled
//     inside the shared tiles up to 64 or 128 (the _pad_d rule) with
//     scale = 1/sqrt(true D). Inputs are read through their (B, L, H)
//     strides with D contiguous, so v may be a strided view of the fused
//     qkv product.
//   - Tiles load synchronously, and the B operands of p . v, ds^T . q,
//     p^T . dO and ds . k are gathered with 16-bit shared-memory loads.
//
// wgmma (every kernel for bf16, D in {64, 128}, TMA-addressable inputs:
// the LM's main path):
//   - One warpgroup per block owns 64 rows (q rows in the forward and dq,
//     kv rows in dk/dv) and keeps that side's tiles resident; the other
//     side's two tiles stream through a two-stage ring of TMA copies
//     completing on mbarriers, so the next pair loads while this one is
//     multiplied.
//   - Every product is a wgmma (m64nNk16, bf16 in, f32 accumulate). The
//     scores come from shared memory (both operands K-major); p (forward),
//     p^T and ds^T (dk/dv) or ds (dq) are formed in registers, rounded to
//     bf16 in place and fed as the register A operand of the next wgmma,
//     whose B (V, dO, q or K) is read MN-major from the same swizzled
//     tile: no shared-memory round trip, no 16-bit gathers.
//   - Tiles are stored in the 128-byte swizzle both the TMA and wgmma
//     name; rows past L arrive as zeros (and q rows past L get lse = +inf,
//     so p = 0), so only the causal diagonal tile (and in the forward a
//     ragged last tile, whose zero keys score 0) runs the per-element
//     mask. exp(s * scale - m) is one FMA and one ex2 with log2 e folded
//     into the scale and m (the forward's running max, the backward's lse).
//   - The dk/dv block loops over every q head of its KV group, so a KV
//     head's gradient sums in registers: no atomics, the same bits every
//     run, in both designs. Causal tile pairs entirely above the diagonal
//     are skipped, and the heaviest tiles are scheduled first.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 64;    // q rows per tile (16 per warp in fwd and dq)
constexpr int kBK = 64;    // kv rows per tile (16 per warp in dk/dv)
constexpr int kPad = 8;    // padding (elements) at the end of every tile row
constexpr float kNegInf = -1e30f;

struct Strides {  // element strides of q, k, v and dO along B, L, H
  long long qb, ql, qh, kb, kl, kh, vb, vl, vh, db, dl, dh;
};

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// c[16 x 8] += A[16 x 16] . B[16 x 8] on one warp, in the register layout
// of mma.sync.m16n8k16: lane (g = lane / 4, t = lane % 4) holds
// c = {C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]}.
// A[m][k] = a[m * lda + k]; B[k][n] = b[k * ldbk + n * ldbn]. KCONTIG
// says ldbk == 1, so two neighbours along k load as one 32-bit word.
template <bool KCONTIG>
__device__ __forceinline__ void mma16816(float c[4], const bf16* a, int lda,
                                         const bf16* b, int ldbk, int ldbn,
                                         int g, int t) {
  const uint32_t a0 = *reinterpret_cast<const uint32_t*>(a + g * lda + 2 * t);
  const uint32_t a1 =
      *reinterpret_cast<const uint32_t*>(a + (g + 8) * lda + 2 * t);
  const uint32_t a2 =
      *reinterpret_cast<const uint32_t*>(a + g * lda + 2 * t + 8);
  const uint32_t a3 =
      *reinterpret_cast<const uint32_t*>(a + (g + 8) * lda + 2 * t + 8);
  uint32_t b0, b1;
  if (KCONTIG) {
    b0 = *reinterpret_cast<const uint32_t*>(b + g * ldbn + 2 * t);
    b1 = *reinterpret_cast<const uint32_t*>(b + g * ldbn + 2 * t + 8);
  } else {
    const bf16* col = b + g * ldbn;
    b0 = pack_bf16(col[(2 * t) * ldbk], col[(2 * t + 1) * ldbk]);
    b1 = pack_bf16(col[(2 * t + 8) * ldbk], col[(2 * t + 9) * ldbk]);
  }
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The same product in f32 FMAs, same operands and register layout.
template <bool KCONTIG>
__device__ __forceinline__ void mma16816(float c[4], const float* a, int lda,
                                         const float* b, int ldbk, int ldbn,
                                         int g, int t) {
  const float* a_lo = a + g * lda;
  const float* a_hi = a + (g + 8) * lda;
  const float* b_0 = b + (2 * t) * ldbn;
  const float* b_1 = b + (2 * t + 1) * ldbn;
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const float x0 = a_lo[kk], x1 = a_hi[kk];
    const float y0 = b_0[kk * ldbk], y1 = b_1[kk * ldbk];
    c[0] = fmaf(x0, y0, c[0]);
    c[1] = fmaf(x0, y1, c[1]);
    c[2] = fmaf(x1, y0, c[2]);
    c[3] = fmaf(x1, y1, c[3]);
  }
}

// Rows [row0, row0 + ROWS) of one head (row r at src + r * ld, D
// contiguous elements) into a shared ROWS x DP tile of row stride
// DP + kPad, zero-filling rows >= L and columns >= D. vec: 16-byte
// loads (the wrapper checked alignment, strides and D).
template <typename T, int ROWS, int DP>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long ld,
                                          int row0, int L, int D, int vec) {
  constexpr int RS = DP + kPad;
  if (vec) {
    constexpr int V = 16 / static_cast<int>(sizeof(T));
    constexpr int CPR = DP / V;
    for (int i = threadIdx.x; i < ROWS * CPR; i += kThreads) {
      const int r = i / CPR;
      const int c = (i - r * CPR) * V;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < L && c < D) {
        val = *reinterpret_cast<const uint4*>(
            src + static_cast<long long>(row0 + r) * ld + c);
      }
      *reinterpret_cast<uint4*>(dst + r * RS + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += kThreads) {
      const int r = i / DP;
      const int c = i - r * DP;
      T val = from_f32<T>(0.f);
      if (row0 + r < L && c < D) {
        val = src[static_cast<long long>(row0 + r) * ld + c];
      }
      dst[r * RS + c] = val;
    }
  }
}

__device__ __forceinline__ float row_max4(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float row_sum4(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Number of kv tiles a q tile starting at q0 sees (causal: none wholly
// above the diagonal, _block_visible).
__device__ __forceinline__ int kv_tiles(int q0, int L, int causal) {
  const int n = (L + kBK - 1) / kBK;
  return causal ? min(n, (q0 + kBQ - 1) / kBK + 1) : n;
}

// Store a warp's 16 x DP accumulator rows (this lane's rows[0] and
// rows[1]) to an output of row stride ld, D valid columns, rows < L.
template <typename T, int DP>
__device__ __forceinline__ void store_rows(T* out, long long ld,
                                           const float (&acc)[DP / 8][4],
                                           const int (&rows)[2], int L,
                                           int D, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= L) continue;
    T* dst = out + static_cast<long long>(rows[i]) * ld;
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int d = nt * 8 + 2 * t + jj;
        if (d < D) dst[d] = from_f32<T>(acc[nt][2 * i + jj]);
      }
    }
  }
}

// ---- forward ---------------------------------------------------------------

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Strides st, int H, int KV, int L,
                 int D, float scale, int causal, int vec) {
  constexpr int RS = DP + kPad;
  constexpr int PRS = kBK + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kBQ * RS;
  T* Vs = Ks + kBK * RS;
  T* Ps = Vs + kBK * RS;

  const int n_qt = (L + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);  // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16;
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};

  load_tile<T, kBQ, DP>(Qs, q + b * st.qb + h * st.qh, st.ql, q0, L, D, vec);
  const T* kb = k + b * st.kb + kvh * st.kh;
  const T* vb = v + b * st.vb + kvh * st.vh;

  float acc[DP / 8][4];
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;
  float m_i[2] = {kNegInf, kNegInf};
  float l_i[2] = {0.f, 0.f};

  const int n_kt = kv_tiles(q0, L, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K/V reads are done
    load_tile<T, kBK, DP>(Ks, kb, st.kl, k0, L, D, vec);
    load_tile<T, kBK, DP>(Vs, vb, st.vl, k0, L, D, vec);
    __syncthreads();

    // s = q . k^T for this warp's 16 rows and the tile's 64 keys.
    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = 0.f;
    for (int kc = 0; kc < DP; kc += 16) {
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        mma16816<true>(s[nt], Qs + wr * RS + kc, RS, Ks + nt * 8 * RS + kc,
                       1, RS, g, t);
      }
    }

    // Scale, mask by absolute position, and the online-softmax update.
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = rows[j >> 1];
        const int c = k0 + nt * 8 + 2 * t + (j & 1);
        const bool ok = r < L && c < L && (!causal || c <= r);
        s[nt][j] = ok ? s[nt][j] * scale : kNegInf;
        mt[j >> 1] = fmaxf(mt[j >> 1], s[nt][j]);
      }
    }
    float m_new[2], alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_new[i] = fmaxf(m_i[i], row_max4(mt[i]));
      alpha[i] = expf(m_i[i] - m_new[i]);
    }
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[nt][j] - m_new[j >> 1]);
        ps[j >> 1] += p;
        Ps[(wr + g + 8 * (j >> 1)) * PRS + nt * 8 + 2 * t + (j & 1)] =
            from_f32<T>(p);  // p rounded to v's type before p . v
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_i[i] = alpha[i] * l_i[i] + row_sum4(ps[i]);
      m_i[i] = m_new[i];
    }
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nt][j] *= alpha[j >> 1];
    __syncwarp();  // this warp's p rows are in shared memory

    // acc += p . v
    for (int kc = 0; kc < kBK; kc += 16) {
#pragma unroll
      for (int nt = 0; nt < DP / 8; ++nt) {
        mma16816<false>(acc[nt], Ps + wr * PRS + kc, PRS,
                        Vs + kc * RS + nt * 8, RS, 1, g, t);
      }
    }
  }

  // o = acc / l and lse = m + log(l), l floored at 1e-30 as in _fwd_kernel.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= L) continue;
    const float l_safe = fmaxf(l_i[i], 1e-30f);
    if (t == 0) {
      lse[static_cast<long long>(bh) * L + rows[i]] = m_i[i] + logf(l_safe);
    }
    T* dst = o + (static_cast<long long>(b) * L + rows[i]) * H * D +
             static_cast<long long>(h) * D;
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int d = nt * 8 + 2 * t + jj;
        if (d < D) dst[d] = from_f32<T>(acc[nt][2 * i + jj] / l_safe);
      }
    }
  }
}

// ---- backward: dk/dv -------------------------------------------------------

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, Strides st, int H, int KV, int L,
                    int D, float scale, int causal, int vec) {
  constexpr int RS = DP + kPad;
  constexpr int PRS = kBQ + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kBK * RS;
  T* Qs = Vs + kBK * RS;
  T* Os = Qs + kBQ * RS;   // dO
  T* PTs = Os + kBQ * RS;  // p^T, rounded
  T* DSs = PTs + kBK * PRS;  // ds^T, rounded
  float* Ls = reinterpret_cast<float*>(DSs + kBK * PRS);
  float* Dl = Ls + kBQ;

  const int k0 = blockIdx.x * kBK;
  const int bkv = blockIdx.y;
  const int b = bkv / KV, kvh = bkv - b * KV;
  const int group = H / KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16;
  const int krows[2] = {k0 + wr + g, k0 + wr + g + 8};

  load_tile<T, kBK, DP>(Ks, k + b * st.kb + kvh * st.kh, st.kl, k0, L, D,
                        vec);
  load_tile<T, kBK, DP>(Vs, v + b * st.vb + kvh * st.vh, st.vl, k0, L, D,
                        vec);

  float dk_acc[DP / 8][4], dv_acc[DP / 8][4];
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[nt][j] = dv_acc[nt][j] = 0.f;

  const int n_qt = (L + kBQ - 1) / kBQ;
  const int qt0 = causal ? k0 / kBQ : 0;  // first q tile that sees this one
  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const T* qb = q + b * st.qb + h * st.qh;
    const T* ob = dout + b * st.db + h * st.dh;
    const float* lb = lse + (static_cast<long long>(b) * H + h) * L;
    const float* db = delta + (static_cast<long long>(b) * H + h) * L;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // the previous tile's reads are done
      load_tile<T, kBQ, DP>(Qs, qb, st.ql, q0, L, D, vec);
      load_tile<T, kBQ, DP>(Os, ob, st.dl, q0, L, D, vec);
      for (int i = threadIdx.x; i < kBQ; i += kThreads) {
        const bool in = q0 + i < L;
        Ls[i] = in ? lb[q0 + i] : 0.f;
        Dl[i] = in ? db[q0 + i] : 0.f;
      }
      __syncthreads();

      // s^T = k . q^T and dp^T = v . dO^T for this warp's 16 kv rows.
      float sT[kBQ / 8][4], dpT[kBQ / 8][4];
#pragma unroll
      for (int nt = 0; nt < kBQ / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) sT[nt][j] = dpT[nt][j] = 0.f;
      for (int kc = 0; kc < DP; kc += 16) {
#pragma unroll
        for (int nt = 0; nt < kBQ / 8; ++nt) {
          mma16816<true>(sT[nt], Ks + wr * RS + kc, RS,
                         Qs + nt * 8 * RS + kc, 1, RS, g, t);
          mma16816<true>(dpT[nt], Vs + wr * RS + kc, RS,
                         Os + nt * 8 * RS + kc, 1, RS, g, t);
        }
      }
#pragma unroll
      for (int nt = 0; nt < kBQ / 8; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kr = krows[j >> 1];
          const int qi = nt * 8 + 2 * t + (j & 1);
          const int qc = q0 + qi;
          const bool ok = kr < L && qc < L && (!causal || kr <= qc);
          float p = 0.f, ds = 0.f;
          if (ok) {
            p = expf(sT[nt][j] * scale - Ls[qi]);
            ds = p * (dpT[nt][j] - Dl[qi]) * scale;
          }
          const int idx = (wr + g + 8 * (j >> 1)) * PRS + qi;
          PTs[idx] = from_f32<T>(p);
          DSs[idx] = from_f32<T>(ds);
        }
      }
      __syncwarp();

      // dv += p^T . dO and dk += ds^T . q
      for (int kc = 0; kc < kBQ; kc += 16) {
#pragma unroll
        for (int nt = 0; nt < DP / 8; ++nt) {
          mma16816<false>(dv_acc[nt], PTs + wr * PRS + kc, PRS,
                          Os + kc * RS + nt * 8, RS, 1, g, t);
          mma16816<false>(dk_acc[nt], DSs + wr * PRS + kc, PRS,
                          Qs + kc * RS + nt * 8, RS, 1, g, t);
        }
      }
    }
  }

  const long long ld = static_cast<long long>(KV) * D;
  const long long base = static_cast<long long>(b) * L * ld +
                         static_cast<long long>(kvh) * D;
  store_rows<T, DP>(dk + base, ld, dk_acc, krows, L, D, t);
  store_rows<T, DP>(dv + base, ld, dv_acc, krows, L, D, t);
}

// ---- backward: dq ----------------------------------------------------------

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   Strides st, int H, int KV, int L, int D, float scale,
                   int causal, int vec) {
  constexpr int RS = DP + kPad;
  constexpr int PRS = kBK + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Os = Qs + kBQ * RS;  // dO
  T* Ks = Os + kBQ * RS;
  T* Vs = Ks + kBK * RS;
  T* DSs = Vs + kBK * RS;  // ds, rounded

  const int n_qt = (L + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);  // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16;
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};

  load_tile<T, kBQ, DP>(Qs, q + b * st.qb + h * st.qh, st.ql, q0, L, D, vec);
  load_tile<T, kBQ, DP>(Os, dout + b * st.db + h * st.dh, st.dl, q0, L, D,
                        vec);
  const T* kb = k + b * st.kb + kvh * st.kh;
  const T* vb = v + b * st.vb + kvh * st.vh;
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long at = static_cast<long long>(bh) * L + rows[i];
    lse_r[i] = rows[i] < L ? lse[at] : 0.f;
    dl_r[i] = rows[i] < L ? delta[at] : 0.f;
  }

  float dq_acc[DP / 8][4];
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) dq_acc[nt][j] = 0.f;

  const int n_kt = kv_tiles(q0, L, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    load_tile<T, kBK, DP>(Ks, kb, st.kl, k0, L, D, vec);
    load_tile<T, kBK, DP>(Vs, vb, st.vl, k0, L, D, vec);
    __syncthreads();

    // s = q . k^T and dp = dO . v^T for this warp's 16 q rows.
    float s[kBK / 8][4], dp[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = dp[nt][j] = 0.f;
    for (int kc = 0; kc < DP; kc += 16) {
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        mma16816<true>(s[nt], Qs + wr * RS + kc, RS, Ks + nt * 8 * RS + kc,
                       1, RS, g, t);
        mma16816<true>(dp[nt], Os + wr * RS + kc, RS, Vs + nt * 8 * RS + kc,
                       1, RS, g, t);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = rows[j >> 1];
        const int c = k0 + nt * 8 + 2 * t + (j & 1);
        const bool ok = r < L && c < L && (!causal || c <= r);
        float ds = 0.f;
        if (ok) {
          const float p = expf(s[nt][j] * scale - lse_r[j >> 1]);
          ds = p * (dp[nt][j] - dl_r[j >> 1]) * scale;
        }
        DSs[(wr + g + 8 * (j >> 1)) * PRS + nt * 8 + 2 * t + (j & 1)] =
            from_f32<T>(ds);
      }
    }
    __syncwarp();

    // dq += ds . k
    for (int kc = 0; kc < kBK; kc += 16) {
#pragma unroll
      for (int nt = 0; nt < DP / 8; ++nt) {
        mma16816<false>(dq_acc[nt], DSs + wr * PRS + kc, PRS,
                        Ks + kc * RS + nt * 8, RS, 1, g, t);
      }
    }
  }

  const long long ld = static_cast<long long>(H) * D;
  const long long base = static_cast<long long>(b) * L * ld +
                         static_cast<long long>(h) * D;
  store_rows<T, DP>(dq + base, ld, dq_acc, rows, L, D, t);
}

// ---- backward on wgmma and TMA (bf16, D in {64, 128}) ----------------------
//
// One warpgroup (128 threads) per block. Every tile is 64 rows of D
// columns, stored as D / 64 panels of 64 columns (128 bytes a row) in the
// 128-byte swizzle that both the TMA copy and the wgmma descriptor name;
// each panel is 8 KB and 1024-byte aligned. A tile serves as a K-major
// operand (its rows are M or N, its columns the depth) and, in the
// products whose depth runs over rows, as an MN-major B operand.

constexpr int kRows = 64;            // rows of every tile: one warpgroup's M
constexpr int kPanel = kRows * 128;  // bytes of one 64-column panel
constexpr float kLog2e = 1.4426950408889634f;

// wgmma shared-memory matrix descriptor, 128-byte swizzle (layout type 1):
// start address, leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// A tile as a K-major operand, depth step kk (columns 16 kk .. 16 kk + 15):
// within a 128-byte row the step is a 32-byte offset the swizzle applies
// to; 8-row groups lie 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return gmma_desc(tile + (kk >> 2) * kPanel + (kk & 3) * 32, 16, 1024);
}

// A tile as an MN-major B operand, depth step kk (rows 16 kk .. 16 kk +
// 15): 8-row groups 1024 bytes apart along the depth, 64-column panels
// kPanel bytes apart along N.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return gmma_desc(tile + kk * 16 * 128, kPanel, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile(
      "wgmma.commit_group.sync.aligned;\n"
      "wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from touching accumulators across the asynchronous
// products: after the wait, each register is pinned in place.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d[64 x 64] (+)= A . B with A and B K-major in shared memory (both
// descriptors); acc = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x 64] += A . B: A (64 x 16, bf16) from registers in the
// accumulator layout of a preceding wgmma, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d[64 x 128] += A . B: A (64 x 16, bf16) from registers in the
// accumulator layout of a preceding wgmma, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row, row + 64) of one head into a swizzled tile at dst, one TMA
// copy per 64-column panel; rows past L arrive as zeros. The tensor map
// is 4-D (D, heads, L, B) with a (64, 1, 64, 1) box.
template <int DP>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int head, int row,
                                         int batch) {
#pragma unroll
  for (int p = 0; p < DP / 64; ++p) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        ::"r"(dst + p * kPanel), "l"(reinterpret_cast<uint64_t>(map)),
        "r"(64 * p), "r"(head), "r"(row), "r"(batch), "r"(bar)
        : "memory");
  }
}

template <int DP>
__host__ __device__ constexpr int tile_bytes() {
  return kRows * DP * 2;
}

// Shared memory of both wgmma sweeps: two resident tiles, two stages of
// two streamed tiles, the dk/dv sweep's per-stage lse and delta rows, two
// barriers, and slack to align the base to 1024 bytes.
template <int DP>
constexpr size_t wgmma_smem() {
  return 6 * tile_bytes<DP>() + 2 * 2 * kRows * sizeof(float) + 16 + 1024;
}

// Store a warpgroup's 64 x DP accumulator (this thread's rows r and r + 8
// of the tile starting at row0) as bf16 rows of stride ld, rows < L.
template <int DP>
__device__ __forceinline__ void store_tile(bf16* out, long long ld,
                                           const float (&acc)[DP / 2],
                                           int row0, int r, int L, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r + 8 * i;
    if (row >= L) continue;
    bf16* dst = out + static_cast<long long>(row) * ld + 2 * t;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
}

// dk/dv sweep, replacing _bwd_kv_kernel (tpu_ddp/ops/pallas/
// flash_attention.py:228); bound by its 4 products per (q, k) pair at
// the bf16 tensor-core peak. Block (kv tile, batch x KV head) keeps its K
// and V tiles resident and streams (q, dO) tiles of every q head of the
// group and every visible q tile through a two-stage TMA ring: the next
// pair loads while the tensor cores work on this one. s^T = K . q^T and
// dp^T = V . dO^T come from shared memory; p^T and ds^T are formed in
// registers and feed dv += p^T . dO and dk += ds^T . q as the register A
// operand, with dO and q read MN-major. exp(s * scale - lse) is computed
// as exp2(s * scale * log2 e - lse * log2 e), one FMA and one ex2.
template <int DP>
__global__ void __launch_bounds__(128, 2)
flash_bwd_kv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int H, int KV, int L, float scale,
                          float scale_log2, int causal) {
  constexpr int TILE = tile_bytes<DP>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t Ks = base, Vs = base + TILE, Ss = base + 2 * TILE;
  float* rowv = reinterpret_cast<float*>(smem_raw + (base - raw) + 6 * TILE);
  const uint32_t bar0 = smem_u32(rowv + 4 * kRows);

  const int kt = blockIdx.x, k0 = kt * kRows;  // heaviest tiles first
  const int b = blockIdx.y / KV, kvh = blockIdx.y - b * KV;
  const int group = H / KV;
  const int n_qt = (L + kRows - 1) / kRows;
  const int qt0 = causal ? kt : 0;  // first q tile that sees this one
  const int nvis = n_qt - qt0;
  const int n_it = group * nvis;  // (q head, q tile) pairs
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t = lane % 4;
  const int r0 = 16 * warp + lane / 4;  // this thread's rows r0, r0 + 8

  auto head_of = [&](int it) { return kvh * group + it / nvis; };
  auto row_of = [&](int it) { return (qt0 + it % nvis) * kRows; };
  auto stage = [&](int it) { return Ss + (it & 1) * 2 * TILE; };
  auto load_q_do = [&](int it) {
    const uint32_t bar = bar0 + 8 * (it & 1);
    mbar_expect(bar, 2 * TILE + (it == 0 ? 2 * TILE : 0));
    tma_tile<DP>(stage(it), &tq, bar, head_of(it), row_of(it), b);
    tma_tile<DP>(stage(it) + TILE, &tdo, bar, head_of(it), row_of(it), b);
  };
  // Thread i < 64 stages lse * log2 e of q row i (+inf past L, so that
  // p = 0 there), thread 64 + i stages delta (0 past L).
  auto row_value = [&](int it) -> float {
    const int q = row_of(it) + (tid & 63);
    const long long at =
        (static_cast<long long>(b) * H + head_of(it)) * L + q;
    if (tid < kRows) {
      return q < L ? lse[at] * kLog2e : __int_as_float(0x7f800000);
    }
    return q < L ? delta[at] : 0.f;
  };

  if (tid == 0) {
    mbar_init(bar0);
    mbar_init(bar0 + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    load_q_do(0);  // the barrier of stage 0 also counts K and V
    tma_tile<DP>(Ks, &tk, bar0, kvh, k0, b);
    tma_tile<DP>(Vs, &tv, bar0, kvh, k0, b);
    if (n_it > 1) load_q_do(1);
  }
  rowv[tid] = row_value(0);
  __syncthreads();

  float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const float next = it + 1 < n_it ? row_value(it + 1) : 0.f;
    const uint32_t Qst = stage(it), Ost = Qst + TILE;
    const float* rv = rowv + (it & 1) * 2 * kRows;
    const int q0 = row_of(it);
    mbar_wait(bar0 + 8 * (it & 1), (it >> 1) & 1);

    float sT[32], dpT[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wgmma_ss(sT, desc_k(Ks, kk), desc_k(Qst, kk), kk);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wgmma_ss(dpT, desc_k(Vs, kk), desc_k(Ost, kk), kk);
    }
    wg_commit_wait();
    pin(sT);
    pin(dpT);

    // Only the diagonal tile is masked: kv row k0 + r sees q row q0 + c
    // iff k0 + r <= q0 + c.
    const bool diag = causal && q0 < k0 + kRows;
    uint32_t pa[16], da[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        const int r = r0 + 8 * (e >> 1);
        float p = exp2f(fmaf(sT[4 * j + e], scale_log2, -rv[c]));
        if (diag && k0 + r > q0 + c) p = 0.f;
        sT[4 * j + e] = p;
        dpT[4 * j + e] = p * (dpT[4 * j + e] - rv[kRows + c]) * scale;
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      pa[i] = pack2(sT[2 * i], sT[2 * i + 1]);     // p^T rounded to bf16
      da[i] = pack2(dpT[2 * i], dpT[2 * i + 1]);   // ds^T rounded to bf16
    }

    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      wgmma_rs(dv_acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
               pa[4 * kk + 3], desc_mn(Ost, kk));
    }
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      wgmma_rs(dk_acc, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
               da[4 * kk + 3], desc_mn(Qst, kk));
    }
    wg_commit_wait();
    pin(dv_acc);
    pin(dk_acc);

    if (it + 1 < n_it) rowv[((it + 1) & 1) * 2 * kRows + tid] = next;
    __syncthreads();  // every read of this stage is done
    if (tid == 0 && it + 2 < n_it) load_q_do(it + 2);
  }

  const long long ld = static_cast<long long>(KV) * DP;
  const long long off = static_cast<long long>(b) * L * ld +
                        static_cast<long long>(kvh) * DP;
  store_tile<DP>(dk + off, ld, dk_acc, k0, r0, L, t);
  store_tile<DP>(dv + off, ld, dv_acc, k0, r0, L, t);
}

// dq sweep, replacing _bwd_q_kernel (flash_attention.py:268); bound by
// its 3 products per (q, k) pair. Block (q tile, batch x head) keeps its
// q and dO tiles resident and streams (K, V) tiles through a two-stage
// TMA ring. s = q . K^T and dp = dO . V^T come from shared memory; ds is
// formed in registers and feeds dq += ds . K as the register A operand,
// with K read MN-major. Keys past L need no mask: their K and V rows
// arrive as zeros, so they add nothing to dq.
template <int DP>
__global__ void __launch_bounds__(128, 2)
flash_bwd_q_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int H, int KV, int L,
                         float scale, float scale_log2, int causal) {
  constexpr int TILE = tile_bytes<DP>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t Qs = base, Os = base + TILE, Ss = base + 2 * TILE;
  const uint32_t bar0 =
      smem_u32(smem_raw + (base - raw) + 6 * TILE + 4 * kRows * 4);

  const int n_qt = (L + kRows - 1) / kRows;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);  // heaviest first
  const int q0 = qt * kRows;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KV);
  const int n_kt = causal ? qt + 1 : n_qt;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t = lane % 4;
  const int r0 = 16 * warp + lane / 4;

  auto stage = [&](int kt) { return Ss + (kt & 1) * 2 * TILE; };
  auto load_k_v = [&](int kt) {
    const uint32_t bar = bar0 + 8 * (kt & 1);
    mbar_expect(bar, 2 * TILE + (kt == 0 ? 2 * TILE : 0));
    tma_tile<DP>(stage(kt), &tk, bar, kvh, kt * kRows, b);
    tma_tile<DP>(stage(kt) + TILE, &tv, bar, kvh, kt * kRows, b);
  };

  if (tid == 0) {
    mbar_init(bar0);
    mbar_init(bar0 + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    load_k_v(0);  // the barrier of stage 0 also counts q and dO
    tma_tile<DP>(Qs, &tq, bar0, h, q0, b);
    tma_tile<DP>(Os, &tdo, bar0, h, q0, b);
    if (n_kt > 1) load_k_v(1);
  }
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = q0 + r0 + 8 * i;
    const long long at = static_cast<long long>(bh) * L + q;
    lse2[i] = q < L ? lse[at] * kLog2e : 0.f;
    dl[i] = q < L ? delta[at] : 0.f;
  }

  float dq_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq_acc[i] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const uint32_t Kst = stage(kt), Vst = Kst + TILE;
    const int k0 = kt * kRows;
    mbar_wait(bar0 + 8 * (kt & 1), (kt >> 1) & 1);

    float s[32], dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wgmma_ss(s, desc_k(Qs, kk), desc_k(Kst, kk), kk);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wgmma_ss(dp, desc_k(Os, kk), desc_k(Vst, kk), kk);
    }
    wg_commit_wait();
    pin(s);
    pin(dp);

    const bool diag = causal && k0 + kRows > q0;
    uint32_t da[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        const int i = e >> 1;
        float p = exp2f(fmaf(s[4 * j + e], scale_log2, -lse2[i]));
        if (diag && k0 + c > q0 + r0 + 8 * i) p = 0.f;
        dp[4 * j + e] = p * (dp[4 * j + e] - dl[i]) * scale;
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) da[i] = pack2(dp[2 * i], dp[2 * i + 1]);

    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      wgmma_rs(dq_acc, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
               da[4 * kk + 3], desc_mn(Kst, kk));
    }
    wg_commit_wait();
    pin(dq_acc);

    __syncthreads();  // every read of this stage is done
    if (tid == 0 && kt + 2 < n_kt) load_k_v(kt + 2);
  }

  const long long ld = static_cast<long long>(H) * DP;
  store_tile<DP>(dq + static_cast<long long>(b) * L * ld +
                     static_cast<long long>(h) * DP,
                 ld, dq_acc, q0, r0, L, t);
}

// Forward, replacing _fwd_kernel (tpu_ddp/ops/pallas/flash_attention.py:
// 125, called through _fwd_impl at :193); bound by its 2 products per
// (q, k) pair at the bf16 tensor-core peak. Block (batch x head, q tile;
// the heaviest q tiles first across every head) keeps its 64 q rows
// resident and streams (K, V) tiles through a two-stage TMA ring. s =
// q . K^T comes from shared memory (both K-major); the online softmax
// runs on the accumulator rows in registers, in log2 units (scale * log2
// e folded into one FMA before ex2); p is rounded to bf16 in place and
// feeds o += p . V as the register A operand, with V read MN-major. Only
// the causal diagonal tile and a ragged last tile (keys past L arrive as
// zero rows, whose score 0 is not -inf) run the per-element mask. o is
// normalised in registers, written into the q tile's swizzled panels and
// stored by TMA (rows past L are clipped); lse = m + log(l) in f32.
template <int DP>
__global__ void __launch_bounds__(128, 2)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to,
                       float* __restrict__ lse, int H, int KV, int L,
                       float scale_log2, int causal) {
  constexpr int TILE = tile_bytes<DP>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t Qs = base, Ss = base + TILE;
  const uint32_t bar0 = base + 5 * TILE;

  const int bh = blockIdx.x;
  const int n_qt = (L + kRows - 1) / kRows;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.y);  // heaviest first
  const int q0 = qt * kRows;
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KV);
  const int n_kt = causal ? qt + 1 : n_qt;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t = lane % 4;
  const int r0 = 16 * warp + lane / 4;  // this thread's rows r0, r0 + 8

  auto stage = [&](int kt) { return Ss + (kt & 1) * 2 * TILE; };
  auto load_k_v = [&](int kt) {
    const uint32_t bar = bar0 + 8 * (kt & 1);
    mbar_expect(bar, 2 * TILE + (kt == 0 ? TILE : 0));
    tma_tile<DP>(stage(kt), &tk, bar, kvh, kt * kRows, b);
    tma_tile<DP>(stage(kt) + TILE, &tv, bar, kvh, kt * kRows, b);
  };

  if (tid == 0) {
    mbar_init(bar0);
    mbar_init(bar0 + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    load_k_v(0);  // the barrier of stage 0 also counts q
    tma_tile<DP>(Qs, &tq, bar0, h, q0, b);
    if (n_kt > 1) load_k_v(1);
  }

  float o_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o_acc[i] = 0.f;
  float m_i[2] = {kNegInf, kNegInf};  // running max, log2 units
  float l_i[2] = {0.f, 0.f};          // running sum of unrounded p

  for (int kt = 0; kt < n_kt; ++kt) {
    const uint32_t Kst = stage(kt), Vst = Kst + TILE;
    const int k0 = kt * kRows;
    mbar_wait(bar0 + 8 * (kt & 1), (kt >> 1) & 1);

    float s[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wgmma_ss(s, desc_k(Qs, kk), desc_k(Kst, kk), kk);
    }
    wg_commit_wait();
    pin(s);

    // Scale into log2 units; mask by absolute position where a tile needs
    // it (q row q0 + r sees key k0 + c iff c < L and, causal, k0 + c <= q0
    // + r) with the -1e30 sentinel, as _fwd_kernel masks.
    const bool mask = (causal && k0 + kRows > q0) || k0 + kRows > L;
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = s[4 * j + e] * scale_log2;
        if (mask) {
          const int c = k0 + 8 * j + 2 * t + (e & 1);
          const int r = q0 + r0 + 8 * (e >> 1);
          if (c >= L || (causal && c > r)) v = kNegInf;
        }
        s[4 * j + e] = v;
        mt[e >> 1] = fmaxf(mt[e >> 1], v);
      }
    }
    float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m_i[i], row_max4(mt[i]));
      alpha[i] = exp2f(m_i[i] - m_new);
      m_i[i] = m_new;
    }
    uint32_t pa[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[4 * j + e] - m_i[e >> 1]);
        ps[e >> 1] += p;
        s[4 * j + e] = p;
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      pa[i] = pack2(s[2 * i], s[2 * i + 1]);  // p rounded to bf16
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_i[i] = alpha[i] * l_i[i] + row_sum4(ps[i]);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o_acc[4 * j + e] *= alpha[e >> 1];
    }

    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      wgmma_rs(o_acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
               pa[4 * kk + 3], desc_mn(Vst, kk));
    }
    wg_commit_wait();
    pin(o_acc);

    __syncthreads();  // every read of this stage is done
    if (tid == 0 && kt + 2 < n_kt) load_k_v(kt + 2);
  }

  // o = acc / max(l, 1e-30) and lse = m + log(l), as _fwd_kernel ends.
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l_safe = fmaxf(l_i[i], 1e-30f);
    inv[i] = 1.f / l_safe;
    const int row = q0 + r0 + 8 * i;
    if (t == 0 && row < L) {
      lse[static_cast<long long>(bh) * L + row] =
          m_i[i] * (1.f / kLog2e) + logf(l_safe);
    }
  }
  // Into the q tile (free since the last stage's barrier), in the 128-byte
  // swizzle the TMA store reads: 16-byte chunk c of row r lies at chunk
  // c ^ (r % 8).
  unsigned char* qtile = smem_raw + (Qs - raw);
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      const int off = (j / 8) * kPanel + r * 128 + (((j % 8) ^ (r % 8)) * 16) +
                      4 * t;
      *reinterpret_cast<uint32_t*>(qtile + off) =
          pack2(o_acc[4 * j + 2 * i] * inv[i], o_acc[4 * j + 2 * i + 1] * inv[i]);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int p = 0; p < DP / 64; ++p) {
      asm volatile(
          "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
          "[%0, {%2, %3, %4, %5}], [%1];\n"
          ::"l"(reinterpret_cast<uint64_t>(&to)), "r"(Qs + p * kPanel),
          "r"(64 * p), "r"(h), "r"(q0), "r"(b)
          : "memory");
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ---- launchers -------------------------------------------------------------

template <typename T, int DP>
size_t fwd_smem() {
  return sizeof(T) * ((kBQ + 2 * kBK) * (DP + kPad) + kBQ * (kBK + kPad));
}

template <typename T, int DP>
size_t bwd_kv_smem() {
  return sizeof(T) * ((2 * kBK + 2 * kBQ) * (DP + kPad) +
                      2 * kBK * (kBQ + kPad)) +
         2 * kBQ * sizeof(float);
}

template <typename T, int DP>
size_t bwd_q_smem() {
  return sizeof(T) * ((2 * kBQ + 2 * kBK) * (DP + kPad) + kBQ * (kBK + kPad));
}

template <typename T, int DP>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, const Strides& st, int B, int H, int KV, int L,
               int D, float scale, int causal, int vec, cudaStream_t stream) {
  const size_t smem = fwd_smem<T, DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      st, H, KV, L, D, scale, causal, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int launch_bwd_kv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, const Strides& st, int B, int H, int KV,
                  int L, int D, float scale, int causal, int vec,
                  cudaStream_t stream) {
  const size_t smem = bwd_kv_smem<T, DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kv_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kBK - 1) / kBK, B * KV);
  flash_bwd_kv_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), st, H, KV, L, D, scale,
      causal, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int launch_bwd_q(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, const Strides& st, int B, int H, int KV, int L,
                 int D, float scale, int causal, int vec,
                 cudaStream_t stream) {
  const size_t smem = bwd_q_smem<T, DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_q_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kBQ - 1) / kBQ, B * H);
  flash_bwd_q_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), st, H, KV, L, D, scale, causal, vec);
  return static_cast<int>(cudaGetLastError());
}

// The 4-D tensor map (D, heads, L, B) of a bf16 (B, L, heads, D) tensor
// with element strides (sb, sl, sh) and D contiguous: a (64, 1, 64, 1)
// box, 128-byte swizzle, zeros past the edges.
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int L, int heads,
                int D, long long sb, long long sl, long long sh) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sl) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, kRows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Maps {
  CUtensorMap q, k, v, dout;
};

// Maps of q, k, v and dO; false if any cannot be encoded.
bool bwd_maps(Maps* m, const void* q, const void* k, const void* v,
              const void* dout, const Strides& st, int B, int H, int KV,
              int L, int D) {
  return tensor_map(&m->q, q, B, L, H, D, st.qb, st.ql, st.qh) &&
         tensor_map(&m->k, k, B, L, KV, D, st.kb, st.kl, st.kh) &&
         tensor_map(&m->v, v, B, L, KV, D, st.vb, st.vl, st.vh) &&
         tensor_map(&m->dout, dout, B, L, H, D, st.db, st.dl, st.dh);
}

template <int DP>
int launch_bwd_kv_wgmma(const Maps& m, const void* lse, const void* delta,
                        void* dk, void* dv, int B, int H, int KV, int L,
                        float scale, int causal, cudaStream_t stream) {
  const size_t smem = wgmma_smem<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kv_wgmma_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kRows - 1) / kRows, B * KV);
  flash_bwd_kv_wgmma_kernel<DP><<<grid, 128, smem, stream>>>(
      m.q, m.k, m.v, m.dout, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, KV, L, scale, scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_bwd_q_wgmma(const Maps& m, const void* lse, const void* delta,
                       void* dq, int B, int H, int KV, int L, float scale,
                       int causal, cudaStream_t stream) {
  const size_t smem = wgmma_smem<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_q_wgmma_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kRows - 1) / kRows, B * H);
  flash_bwd_q_wgmma_kernel<DP><<<grid, 128, smem, stream>>>(
      m.q, m.k, m.v, m.dout, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), H, KV, L,
      scale, scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_fwd_wgmma(const CUtensorMap& mq, const CUtensorMap& mk,
                     const CUtensorMap& mv, const CUtensorMap& mo, void* lse,
                     int B, int H, int KV, int L, float scale, int causal,
                     cudaStream_t stream) {
  // The q tile, two stages of (K, V), two barriers, 1024-byte alignment.
  const size_t smem = 5 * tile_bytes<DP>() + 16 + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (L + kRows - 1) / kRows);
  flash_fwd_wgmma_kernel<DP><<<grid, 128, smem, stream>>>(
      mq, mk, mv, mo, static_cast<float*>(lse), H, KV, L, scale * kLog2e,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. q is (B, L, H, D) and k, v
// are (B, L, KV, D), read through the given element strides along B, L
// and H with D contiguous; dout has q's shape and its own strides. o, dq
// are contiguous (B, L, H, D), dk and dv contiguous (B, L, KV, D), lse
// and delta contiguous (B, H, L) f32. is_bf16 selects bf16 (1) or f32
// (0) for every tensor but lse and delta; D <= 128; vec says every input
// allows 16-byte loads. Each returns the CUDA error code of its launch
// (0 on success).
extern "C" int tdt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, long long qb, long long ql,
                             long long qh, long long kb, long long kl,
                             long long kh, long long vb, long long vl,
                             long long vh, int B, int H, int KV, int L, int D,
                             float scale, int causal, int is_bf16, int vec,
                             void* stream) {
  const Strides st{qb, ql, qh, kb, kl, kh, vb, vl, vh, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return D <= 64 ? launch_fwd<bf16, 64>(q, k, v, o, lse, st, B, H, KV, L,
                                          D, scale, causal, vec, s)
                   : launch_fwd<bf16, 128>(q, k, v, o, lse, st, B, H, KV, L,
                                           D, scale, causal, vec, s);
  }
  return D <= 64 ? launch_fwd<float, 64>(q, k, v, o, lse, st, B, H, KV, L, D,
                                         scale, causal, vec, s)
                 : launch_fwd<float, 128>(q, k, v, o, lse, st, B, H, KV, L,
                                          D, scale, causal, vec, s);
}

// The wgmma forward: the same arguments as tdt_flash_fwd, for bf16
// tensors with D in {64, 128} whose base pointers are 16-byte aligned and
// whose B, L and head strides are multiples of 8 elements; o is the
// contiguous (B, L, H, D) output. Returns the CUDA error code of its
// launch, or cudaErrorInvalidValue if a tensor map cannot be encoded.
extern "C" int tdt_flash_fwd_wgmma(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   long long qb, long long ql, long long qh,
                                   long long kb, long long kl, long long kh,
                                   long long vb, long long vl, long long vh,
                                   int B, int H, int KV, int L, int D,
                                   float scale, int causal, void* stream) {
  CUtensorMap mq, mk, mv, mo;
  const long long ol = static_cast<long long>(H) * D;
  if ((D != 64 && D != 128) ||
      !tensor_map(&mq, q, B, L, H, D, qb, ql, qh) ||
      !tensor_map(&mk, k, B, L, KV, D, kb, kl, kh) ||
      !tensor_map(&mv, v, B, L, KV, D, vb, vl, vh) ||
      !tensor_map(&mo, o, B, L, H, D, L * ol, ol, D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_fwd_wgmma<64>(mq, mk, mv, mo, lse, B, H, KV, L,
                                        scale, causal, s)
                 : launch_fwd_wgmma<128>(mq, mk, mv, mo, lse, B, H, KV, L,
                                         scale, causal, s);
}

extern "C" int tdt_flash_bwd_kv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, long long qb,
    long long ql, long long qh, long long kb, long long kl, long long kh,
    long long vb, long long vl, long long vh, long long db, long long dl,
    long long dh, int B, int H, int KV, int L, int D, float scale,
    int causal, int is_bf16, int vec, void* stream) {
  const Strides st{qb, ql, qh, kb, kl, kh, vb, vl, vh, db, dl, dh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return D <= 64
               ? launch_bwd_kv<bf16, 64>(q, k, v, dout, lse, delta, dk, dv,
                                         st, B, H, KV, L, D, scale, causal,
                                         vec, s)
               : launch_bwd_kv<bf16, 128>(q, k, v, dout, lse, delta, dk, dv,
                                          st, B, H, KV, L, D, scale, causal,
                                          vec, s);
  }
  return D <= 64
             ? launch_bwd_kv<float, 64>(q, k, v, dout, lse, delta, dk, dv,
                                        st, B, H, KV, L, D, scale, causal,
                                        vec, s)
             : launch_bwd_kv<float, 128>(q, k, v, dout, lse, delta, dk, dv,
                                         st, B, H, KV, L, D, scale, causal,
                                         vec, s);
}

extern "C" int tdt_flash_bwd_q(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, long long qb, long long ql,
    long long qh, long long kb, long long kl, long long kh, long long vb,
    long long vl, long long vh, long long db, long long dl, long long dh,
    int B, int H, int KV, int L, int D, float scale, int causal, int is_bf16,
    int vec, void* stream) {
  const Strides st{qb, ql, qh, kb, kl, kh, vb, vl, vh, db, dl, dh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return D <= 64 ? launch_bwd_q<bf16, 64>(q, k, v, dout, lse, delta, dq,
                                            st, B, H, KV, L, D, scale,
                                            causal, vec, s)
                   : launch_bwd_q<bf16, 128>(q, k, v, dout, lse, delta, dq,
                                             st, B, H, KV, L, D, scale,
                                             causal, vec, s);
  }
  return D <= 64 ? launch_bwd_q<float, 64>(q, k, v, dout, lse, delta, dq, st,
                                           B, H, KV, L, D, scale, causal, vec,
                                           s)
                 : launch_bwd_q<float, 128>(q, k, v, dout, lse, delta, dq,
                                            st, B, H, KV, L, D, scale,
                                            causal, vec, s);
}

// The wgmma sweeps: the same arguments as tdt_flash_bwd_kv and
// tdt_flash_bwd_q, for bf16 tensors with D in {64, 128} whose base
// pointers are 16-byte aligned and whose B, L and head strides are
// multiples of 8 elements (the TMA's terms). Each returns the CUDA error
// code of its launch, or cudaErrorInvalidValue if a tensor map cannot be
// encoded.
extern "C" int tdt_flash_bwd_kv_wgmma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, long long qb,
    long long ql, long long qh, long long kb, long long kl, long long kh,
    long long vb, long long vl, long long vh, long long db, long long dl,
    long long dh, int B, int H, int KV, int L, int D, float scale,
    int causal, void* stream) {
  const Strides st{qb, ql, qh, kb, kl, kh, vb, vl, vh, db, dl, dh};
  Maps m;
  if ((D != 64 && D != 128) ||
      !bwd_maps(&m, q, k, v, dout, st, B, H, KV, L, D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_bwd_kv_wgmma<64>(m, lse, delta, dk, dv, B, H, KV,
                                           L, scale, causal, s)
                 : launch_bwd_kv_wgmma<128>(m, lse, delta, dk, dv, B, H, KV,
                                            L, scale, causal, s);
}

extern "C" int tdt_flash_bwd_q_wgmma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, long long qb, long long ql,
    long long qh, long long kb, long long kl, long long kh, long long vb,
    long long vl, long long vh, long long db, long long dl, long long dh,
    int B, int H, int KV, int L, int D, float scale, int causal,
    void* stream) {
  const Strides st{qb, ql, qh, kb, kl, kh, vb, vl, vh, db, dl, dh};
  Maps m;
  if ((D != 64 && D != 128) ||
      !bwd_maps(&m, q, k, v, dout, st, B, H, KV, L, D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_bwd_q_wgmma<64>(m, lse, delta, dq, B, H, KV, L,
                                          scale, causal, s)
                 : launch_bwd_q_wgmma<128>(m, lse, delta, dq, B, H, KV, L,
                                           scale, causal, s);
}
