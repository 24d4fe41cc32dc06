// Flash attention for Hopper (sm_90a): the forward, the dk/dv sweep and
// the dq sweep of an exact softmax attention over (B, L, H, D) tensors,
// causal or not, with grouped-query K/V (KV heads shared by H / KV
// consecutive q heads).
//
// Replaces the three Pallas calls of tpu_ddp/ops/pallas/flash_attention.py:
//   tdt_flash_fwd    <- _fwd_kernel via _fwd_impl (call at :193)
//   tdt_flash_bwd_kv <- _bwd_kv_kernel           (call at :334)
//   tdt_flash_bwd_q  <- _bwd_q_kernel            (call at :357)
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
// tensor cores and not HBM become the limit. So the design keeps the
// (L, L) scores out of device memory and feeds the tensor cores:
//
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
//   - The dk/dv sweep runs one block per (batch x KV head, kv tile) and
//     loops over every q head of the group and every q tile, so a KV head's
//     gradient sums in registers over its whole group: no atomics, and
//     every run gives the same bits.
//   - Causal tile pairs entirely above the diagonal are skipped (half the
//     work); q tiles are issued heaviest first.
//   - L is masked inside the kernel (rows >= L are neither read as keys
//     nor stored), and a head dim D < 64 or 64 < D < 128 is zero-filled
//     inside the shared tiles up to 64 or 128 (the _pad_d rule) with
//     scale = 1/sqrt(true D). Inputs are read through their (B, L, H)
//     strides with D contiguous, so v may be a strided view of the fused
//     qkv product.
//
// Not yet: wgmma, TMA, ldmatrix, double-buffered tiles or warp
// specialisation; the B operands of p . v, ds^T . q, p^T . dO and ds . k
// are gathered with 16-bit shared-memory loads. A simple kernel that is
// right comes first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
