// Chunkwise mLSTM at any head width: the pieces that mlstm_fwd.cu and
// mlstm_bwd.cu share for widths above 16 (Hopper, sm_90a, fp32 on the CUDA
// cores).
//
// The narrow kernels of those files keep a row's whole head (DH <= 16) in
// registers and one thread per element of C* in one block. Neither holds at
// the ViL widths (DH 32 to 384 and more: a row of 160 floats per thread, a
// C* of 25,600 elements), so the wide path cuts every product into 32-wide
// tiles of the head dimension, each block a tile:
//  - wide_outer_kernel: a (DP x DP) sum of outer products over the chunk's
//    rows, one block per 32 x 32 output tile (the chunk's local state K_c,
//    and the backward's readout adjoint dC_read);
//  - wide_scores_kernel: the chunk's causal L x L attention
//    attn[t][j] = (q_t / sqrt(DH)) . k_j e^{s_j - M_t} (j <= t, else 0),
//    its row sums and the denominators, formed once per (head, chunk) into
//    a workspace and read by every column tile after it. Its row sums,
//    q.n* and denominators are the only ones the wide path forms, forward
//    and backward alike, so the backward differentiates the branch
//    (|rowsum| >= e^{-m} or not) that the forward took;
//  - wide_apply_kernel: a (L x 32) column tile of
//       sum_p M(t, p) X[p][c] + coef_t sum_i Y[t][i] Z(i, c)
//    with M an L x L matrix of the workspace (or its transpose) and Z a
//    (DP x DP) state (or its transpose): the readout h, and the backward's
//    dq, dk and dv.
// Column j of h, C* and K_c depends only on column j of v, so the value
// dimension splits into tiles with no sum across blocks. Every sum runs in
// one block in a fixed order (no atomics), so the results are
// deterministic. The carry scans, which are per element, live in the two
// .cu files.
//
// Widths: the wrapper zero-pads DH to DP, a multiple of 32 up to kWideMaxDh;
// zero columns of q, k, v (and g) are exact (q.k, n*, q.n* unchanged, the
// padded columns of h 0), and the scale 1/sqrt(DH) comes from the true DH.
//
// What bounds it: fp32 operations on the CUDA cores (no tensor cores, for
// the reason mlstm_fwd.cu gives), fed from shared memory, at 8-12x the
// operations bound at S 4096 (DH 96 and 128) and 16-110x at S 196-512 on an
// H100 80GB HBM3 at 700 W (PERF.md): every (head, chunk) block walks the
// whole 128 x 128 tile however short the chunk, the L x L work has one block
// per (head, chunk), and the launches serialise. Simple and right first;
// the shape of a faster version is in ROADMAP.md, queue B.
#pragma once

#include <cuda_runtime.h>

namespace mlstm_wide {

constexpr int kTile = 32;           // head-dimension tile
constexpr int kMaxChunk = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWideMaxDh = 512;
constexpr int kStage = kMaxChunk * (kMaxChunk + 1);  // an L x L matrix in shared memory

// Dynamic shared memory of the two L x L kernels: the staging matrix (which
// the q and k tiles alias while the scores are summed), then dp floats and
// three rows of kMaxChunk.
inline size_t scores_smem_bytes(int dp) {
  return sizeof(float) * (kStage + dp + 3 * kMaxChunk);
}

// Sum of one value per thread over the block; every thread gets the total,
// added in the same order. Holds two barriers.
__device__ inline float block_sum(float value, float* red) {
  for (int o = 16; o > 0; o >>= 1) value += __shfl_xor_sync(0xffffffffu, value, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = value;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < kWarps; ++w) total += red[w];
  __syncthreads();
  return total;
}

enum class Outer { kChunkState, kReadAdjoint };

// out[i][j] = sum_p (A[p][i] alpha_p) B[p][j], vec[i] = sum_p A[p][i] beta_p,
// over the chunk's rows p in order. Grid (bh * nchunks, dp / 32, dp / 32).
//  kChunkState:  A = k, B = v, alpha = beta = e^{s_p - cm_{L-1}}: the
//                chunk's local state K_c, n_c (mlstm_fwd.cu, phase 1);
//  kReadAdjoint: A = q / sqrt(DH), B = g / denom, alpha = e^{m* - M_t},
//                beta = alpha d rowsum_t: the readout's adjoints dC_read,
//                dn_read of the entry state (mlstm_bwd.cu).
template <Outer kMode>
__global__ void __launch_bounds__(kThreads)
wide_outer_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  const float* __restrict__ s, const float* __restrict__ cm,
                  const float* __restrict__ ment, const float* __restrict__ denom,
                  const float* __restrict__ drow, float* __restrict__ out,
                  float* __restrict__ vec, int chunk, int dp, float scale) {
  __shared__ float a_s[kMaxChunk][kTile + 1];
  __shared__ float b_s[kMaxChunk][kTile + 1];
  __shared__ float alpha_s[kMaxChunk];
  __shared__ float beta_s[kMaxChunk];

  const int tid = threadIdx.x;
  const size_t cidx = blockIdx.x;
  const size_t off = cidx * chunk * dp;
  const size_t goff = cidx * chunk;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.z * kTile;
  for (int e = tid; e < chunk * kTile; e += kThreads) {
    const int p = e / kTile, c = e % kTile;
    const size_t row = off + static_cast<size_t>(p) * dp;
    if (kMode == Outer::kChunkState) {
      a_s[p][c] = A[row + i0 + c];
      b_s[p][c] = B[row + j0 + c];
    } else {
      a_s[p][c] = A[row + i0 + c] * scale;
      b_s[p][c] = B[row + j0 + c] / denom[goff + p];
    }
  }
  for (int p = tid; p < chunk; p += kThreads) {
    if (kMode == Outer::kChunkState) {
      alpha_s[p] = expf(s[goff + p] - cm[goff + chunk - 1]);
      beta_s[p] = alpha_s[p];
    } else {
      const float m_in = ment[cidx];
      alpha_s[p] = expf(m_in - fmaxf(cm[goff + p], m_in));
      beta_s[p] = alpha_s[p] * drow[goff + p];
    }
  }
  __syncthreads();

  const int tx = tid % kTile, ty = tid / kTile;  // column j0 + tx, rows i0 + ty + 8r
  float acc[kTile / kWarps] = {};
  for (int p = 0; p < chunk; ++p) {
    const float b = b_s[p][tx];
#pragma unroll
    for (int r = 0; r < kTile / kWarps; ++r) {
      acc[r] = fmaf(a_s[p][ty + kWarps * r] * alpha_s[p], b, acc[r]);
    }
  }
  float* o = out + cidx * dp * dp;
#pragma unroll
  for (int r = 0; r < kTile / kWarps; ++r) {
    o[static_cast<size_t>(i0 + ty + kWarps * r) * dp + j0 + tx] = acc[r];
  }
  if (blockIdx.z == 0 && tid < kTile) {
    float v = 0.0f;
    for (int p = 0; p < chunk; ++p) v = fmaf(a_s[p][tid], beta_s[p], v);
    vec[cidx * dp + i0 + tid] = v;
  }
}

// The causal L x L products of two row sets over the head dimension,
// acc[r][c] = sum_d A_t[d] B_j[d] for t = ty + 16 r, j = tx + 16 c, summed
// over d in order, 32 columns at a time. A is divided by a_row[t] (or scaled
// by `scale` when a_row is null), B by nothing. Rows past the chunk read 0.
// Also, for the thread whose tid is a row t < chunk, the sum over d of
// A_t[d] vec[d] (vec in shared memory, null for none). Uses `tiles` (2 x
// kMaxChunk x 33 floats) and leaves it free.
struct Scores {
  float acc[8][8];
  float dot;
};

__device__ inline void chunk_scores(Scores& sc, const float* __restrict__ A,
                                    const float* __restrict__ B, const float* a_row,
                                    float scale, const float* vec, float* tiles,
                                    size_t off, int chunk, int dp) {
  float* a_s = tiles;                              // [kMaxChunk][kTile + 1]
  float* b_s = tiles + kMaxChunk * (kTile + 1);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int c = 0; c < 8; ++c) sc.acc[r][c] = 0.0f;
  }
  sc.dot = 0.0f;
  for (int d0 = 0; d0 < dp; d0 += kTile) {
    for (int e = tid; e < kMaxChunk * kTile; e += kThreads) {
      const int p = e / kTile, c = e % kTile;
      const size_t at = off + static_cast<size_t>(p) * dp + d0 + c;
      const bool live = p < chunk;
      a_s[p * (kTile + 1) + c] = !live ? 0.0f : a_row ? A[at] / a_row[p] : A[at] * scale;
      b_s[p * (kTile + 1) + c] = live ? B[at] : 0.0f;
    }
    __syncthreads();
    if (vec != nullptr && tid < chunk) {
      for (int c = 0; c < kTile; ++c) sc.dot = fmaf(a_s[tid * (kTile + 1) + c], vec[d0 + c], sc.dot);
    }
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float a[8], b[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) a[r] = a_s[(ty + 16 * r) * (kTile + 1) + c];
#pragma unroll
      for (int r = 0; r < 8; ++r) b[r] = b_s[(tx + 16 * r) * (kTile + 1) + c];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int q = 0; q < 8; ++q) sc.acc[r][q] = fmaf(a[r], b[q], sc.acc[r][q]);
      }
    }
    __syncthreads();
  }
}

// Grid (bh * nchunks), scores_smem_bytes(dp) of dynamic shared memory.
// Writes attn (bh * nchunks, L, L), 0 above the diagonal, and per row
// rowsum = sum_j attn[t][j] + e^{m* - M_t} q_t.n* / sqrt(DH), the
// denominator max(|rowsum|, e^{-max(a_t + M_t, -60)}) + eps and
// qn = q_t.n* / sqrt(DH) (bh * Sp each).
__global__ void __launch_bounds__(kThreads)
wide_scores_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ a, const float* __restrict__ s,
                   const float* __restrict__ cm, const float* __restrict__ nent,
                   const float* __restrict__ ment, float* __restrict__ attn,
                   float* __restrict__ rowsum_out, float* __restrict__ denom_out,
                   float* __restrict__ qn_out, int chunk, int dp, float scale, float eps) {
  extern __shared__ float smem[];
  float* stage = smem;                 // [kMaxChunk][kMaxChunk + 1], aliases the tiles
  float* n_s = smem + kStage;          // [dp]
  float* s_s = n_s + dp;               // [kMaxChunk]
  float* mrow_s = s_s + kMaxChunk;     // M_t = max(cm_t, m*)

  const int tid = threadIdx.x;
  const size_t cidx = blockIdx.x;
  const size_t off = cidx * chunk * dp;
  const size_t goff = cidx * chunk;
  const float m_in = ment[cidx];
  for (int e = tid; e < dp; e += kThreads) n_s[e] = nent[cidx * dp + e];
  for (int e = tid; e < chunk; e += kThreads) {
    s_s[e] = s[goff + e];
    mrow_s[e] = fmaxf(cm[goff + e], m_in);
  }
  __syncthreads();

  Scores sc;
  chunk_scores(sc, q, k, nullptr, scale, n_s, smem, off, chunk, dp);

  const int tx = tid % 16, ty = tid / 16;
  float* at = attn + cidx * chunk * chunk;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int t = ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = tx + 16 * c;
      if (t < chunk && j < chunk) {
        const float v = j <= t ? sc.acc[r][c] * expf(s_s[j] - mrow_s[t]) : 0.0f;
        stage[t * (kMaxChunk + 1) + j] = v;
        at[static_cast<size_t>(t) * chunk + j] = v;
      }
    }
  }
  __syncthreads();
  if (tid < chunk) {
    const int t = tid;
    float rowsum = 0.0f;
    for (int j = 0; j <= t; ++j) rowsum += stage[t * (kMaxChunk + 1) + j];
    const float m_row = mrow_s[t];
    rowsum = fmaf(expf(m_in - m_row), sc.dot, rowsum);
    const float e_neg = expf(-fmaxf(a[goff + t] + m_row, -60.0f));
    rowsum_out[goff + t] = rowsum;
    denom_out[goff + t] = fmaxf(fabsf(rowsum), e_neg) + eps;
    qn_out[goff + t] = sc.dot;
  }
}

enum class Apply { kReadout, kNumerator, kDq, kDk, kDv };

// One (L x 32) column tile j0 = 32 blockIdx.y of
//   acc1[t][c] = sum_p M(t, p) X[p][j0 + c]      (p over the chunk, in order)
//   acc2[t][c] = sum_i Y[t][i] Z(i, j0 + c)      (i over the head, in order)
// and the mode's epilogue. Grid (bh * nchunks, dp / 32).
//  kReadout:   M = attn, X = v, Y = q / sqrt(DH), Z = C*;
//              h = (acc1 + e^{m* - M_t} acc2) / denom_t (the readout);
//  kNumerator: the same without the division (the backward's numerator);
//  kDq:        M = dqk, X = k, Y = g / denom, Z(i, c) = C*[c][i];
//              dq = (acc1 + e^{m* - M_t} (acc2 + drow_t n*_c)) / sqrt(DH);
//  kDk:        M(t, p) = dqk[p][t], X = q / sqrt(DH), Y = v, Z(i, c) = dC[c][i];
//              dk = acc1 + e^{s_t - M'} (acc2 + dn_c), and the state
//              update's part of ds_t over this tile, sum_c k_t[c] (acc2 +
//              dn_c), to dsp (bh * Sp, dp / 32);
//  kDv:        M(t, p) = attn[p][t], X = g / denom, Y = k, Z = dC;
//              dv = acc1 + e^{s_t - M'} acc2.
// (dC, dn: the adjoint of the chunk's exit state, M' = max(m*, cm_{L-1}).)
template <Apply kMode>
__global__ void __launch_bounds__(kThreads)
wide_apply_kernel(const float* __restrict__ M, const float* __restrict__ X,
                  const float* __restrict__ Y, const float* __restrict__ Z,
                  const float* __restrict__ zvec, const float* __restrict__ kmat,
                  const float* __restrict__ s, const float* __restrict__ cm,
                  const float* __restrict__ ment, const float* __restrict__ denom,
                  const float* __restrict__ drow, float* __restrict__ out,
                  float* __restrict__ dsp, int chunk, int dp, float scale) {
  constexpr bool kTransM = kMode == Apply::kDk || kMode == Apply::kDv;
  constexpr bool kTransZ = kMode == Apply::kDq || kMode == Apply::kDk;
  constexpr int kRows = kMaxChunk / kWarps;  // rows per thread
  __shared__ float m_s[kMaxChunk][kTile + 1];  // M's tile, then Y's
  __shared__ float x_s[kTile][kTile + 1];      // X's tile, then Z's
  __shared__ float denom_s[kMaxChunk];          // denom_t, for the modes that divide by it

  const int tid = threadIdx.x;
  const size_t cidx = blockIdx.x;
  const size_t off = cidx * chunk * dp;
  const size_t goff = cidx * chunk;
  const int j0 = blockIdx.y * kTile;
  const int tx = tid % kTile, ty = tid / kTile;  // column j0 + tx, rows ty + 8r
  const float* mat = M + cidx * chunk * chunk;
  const float* state = Z + cidx * dp * dp;
  for (int p = tid; p < chunk; p += kThreads) {
    denom_s[p] = (kMode == Apply::kDq || kMode == Apply::kDv) ? denom[goff + p] : 1.0f;
  }

  float acc1[kRows] = {}, acc2[kRows] = {};
  for (int p0 = 0; p0 < chunk; p0 += kTile) {
    __syncthreads();
    for (int e = tid; e < kMaxChunk * kTile; e += kThreads) {
      // transposed: consecutive threads read consecutive t of one row p
      const int t = kTransM ? e % kMaxChunk : e / kTile;
      const int pp = kTransM ? e / kMaxChunk : e % kTile;
      const int p = p0 + pp;
      float v = 0.0f;
      if (t < chunk && p < chunk) {
        v = kTransM ? mat[static_cast<size_t>(p) * chunk + t] : mat[static_cast<size_t>(t) * chunk + p];
      }
      m_s[t][pp] = v;
    }
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int pp = e / kTile, c = e % kTile;
      const int p = p0 + pp;
      float v = 0.0f;
      if (p < chunk) {
        v = X[off + static_cast<size_t>(p) * dp + j0 + c];
        if (kMode == Apply::kDk) v *= scale;
        if (kMode == Apply::kDv) v /= denom_s[p];
      }
      x_s[pp][c] = v;
    }
    __syncthreads();
    for (int pp = 0; pp < kTile; ++pp) {
      const float x = x_s[pp][tx];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc1[r] = fmaf(m_s[ty + kWarps * r][pp], x, acc1[r]);
    }
  }
  for (int i0 = 0; i0 < dp; i0 += kTile) {
    __syncthreads();
    for (int e = tid; e < kMaxChunk * kTile; e += kThreads) {
      const int t = e / kTile, ii = e % kTile;
      float v = 0.0f;
      if (t < chunk) {
        v = Y[off + static_cast<size_t>(t) * dp + i0 + ii];
        if (kMode == Apply::kReadout || kMode == Apply::kNumerator) v *= scale;
        if (kMode == Apply::kDq) v /= denom_s[t];
      }
      m_s[t][ii] = v;
    }
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      // transposed: consecutive threads read consecutive i of one row c
      const int ii = kTransZ ? e % kTile : e / kTile;
      const int c = kTransZ ? e / kTile : e % kTile;
      x_s[ii][c] = kTransZ ? state[static_cast<size_t>(j0 + c) * dp + i0 + ii]
                           : state[static_cast<size_t>(i0 + ii) * dp + j0 + c];
    }
    __syncthreads();
    for (int ii = 0; ii < kTile; ++ii) {
      const float z = x_s[ii][tx];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc2[r] = fmaf(m_s[ty + kWarps * r][ii], z, acc2[r]);
    }
  }

  const float m_in = ment[cidx];
  const float m_new = fmaxf(m_in, cm[goff + chunk - 1]);  // M'
  const int col = j0 + tx;
  const float zc = (kMode == Apply::kDq || kMode == Apply::kDk) ? zvec[cidx * dp + col] : 0.0f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = ty + kWarps * r;
    if (t >= chunk) continue;  // uniform across the warp: t depends on ty and r only
    const size_t at = off + static_cast<size_t>(t) * dp + col;
    if (kMode == Apply::kReadout || kMode == Apply::kNumerator || kMode == Apply::kDq) {
      const float inter = expf(m_in - fmaxf(cm[goff + t], m_in));
      if (kMode == Apply::kReadout) {
        out[at] = fmaf(inter, acc2[r], acc1[r]) / denom[goff + t];
      } else if (kMode == Apply::kNumerator) {
        out[at] = fmaf(inter, acc2[r], acc1[r]);
      } else {
        out[at] = scale * (acc1[r] + inter * fmaf(drow[goff + t], zc, acc2[r]));
      }
    } else {
      const float w = expf(s[goff + t] - m_new);
      if (kMode == Apply::kDk) {
        const float upd = acc2[r] + zc;
        out[at] = fmaf(w, upd, acc1[r]);
        float part = kmat[at] * upd;
        for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        if (tx == 0) dsp[(goff + t) * (dp / kTile) + blockIdx.y] = part;
      } else {
        out[at] = fmaf(w, acc2[r], acc1[r]);
      }
    }
  }
}

}  // namespace mlstm_wide
