// Chunkwise mLSTM forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels xlstm_hved_tpu/ops/mlstm_pallas.py::
// _mlstm_kernel and _mlstm_states_kernel (both driven by _pallas_forward).
// One call, mlstm_fwd_launch, computes the readout h and stores each chunk's
// entry state (C*, n*, m*): mlstm_fwd keeps the entry states in a workspace,
// mlstm_fwd_states hands them to the backward (mlstm_bwd.cu), so the two
// give bitwise the same h. The exact fp32 gate transforms (pad, a = per-chunk
// cumsum of logsigmoid(f), s = i - a, cm = chunk-local cummax of s) stay
// torch ops in ops/mlstm_cuda.py, as they stayed XLA ops around the Pallas
// call. The Pallas kernel walks the chunks of a head in order, carrying the
// state in VMEM; here only that carry is sequential, in three launches:
//  1. chunk states, one block per (head, chunk): the chunk's local state
//     relative to its largest s, cm_{L-1} (every exponent <= 0):
//       K_c = sum_p e^{s_p - cm_{L-1}} k_p v_p^T,  n_c = sum_p e^{..} k_p;
//  2. carry scan, one block per head, one thread per element of C*: for each
//     chunk, store the entry state, then with M' = max(m*, cm_{L-1})
//       C*' = e^{m* - M'} C* + e^{cm_{L-1} - M'} K_c,  n*' likewise,
//       m*' = a_{L-1} + M',
//     from m* = -1e30; m* is then bitwise the JAX _m_entry_chain (the same
//     fp32 operations);
//  3. readout, one block per (head, chunk), from the chunk's entry state:
//       M_t    = max(m*, cm_t)
//       num_t  = sum_{j<=t} e^{s_j - M_t} (q_t.k_j / sqrt(DH)) v_j + e^{m* - M_t} (q_t / sqrt(DH)) C*
//       rowsum = the same with 1 in place of v_j and n* in place of C*
//       h_t    = num_t / (max(|rowsum_t|, e^{-max(a_t + M_t, -60)}) + eps)
//     The causal mask is the loop bound j <= t, so masked entries are never
//     formed (the log-space mask of the reference, exactly). Two threads
//     share each row (they split the keys by parity and combine with one
//     shuffle); mlstm_bwd.cu repeats these operations in this order to form
//     the same denominators and branches.
// Padded keys (igate -1e30, zero k and v) add exact zeros.
//
// Precision: every product is an IEEE fp32 FMA on the CUDA cores, and expf
// is the full-precision libm call (no fast math). No TF32: its products
// (10-bit mantissa) gave O(1) output error through the max(|rowsum|,
// e^{-m}) normaliser, which amplifies truncated products; split-precision
// 3xTF32 on the wide path broke the absolute bound at DH 512
// (mlstm_wide.cuh).
//
// What bounds the narrow path: the work is small (about 0.09 GFLOP and 4.4 MB for the
// flagship's 4 heads at S = 4096, about 1.4 us at the card's fp32 rate), so
// latency bounds each phase, not a peak rate. Phases 1 and 3 run B*NH x
// S/L blocks (128 at S = 4096), one wave on the 132 SMs; the readout's
// longest row (t = L-1, 64 keys per thread) sets its time. The scan is a
// chain of nchunks steps of one FMA pair and two expf each; it loads its
// inputs kScanAhead chunks ahead so that the chain does not wait on memory.
// Tiles are read with coalesced 4-byte loads (a 128 x 16 tile is 8 loads a
// thread); static shared memory stays under 48 KB.
//
// Head widths. The kernels above are built for DH 8 and 16 (the flagship's
// and the ViL decoder's widths): narrower heads are zero-padded to one of
// them by the wrapper. Wider heads (the UxLSTM and Vision-LSTM ViLs, DH 32
// to 512) take the wide path of mlstm_wide.cuh, DH zero-padded to a
// multiple of 32, in three launches as well: the chunk states as 64 x 128
// tiles (wide_outer_kernel), the carry scan split
// across blocks (each block recomputes the same m* chain, so m* stays
// bitwise), and the fused readout (wide_readout_kernel): one block per
// (head, chunk, row tile of 64 or 32 rows, group of value columns) forms
// its causal scores, row sums and denominators in shared memory and reads
// h out of them and the entry state, with no L x L workspace in device
// memory. What bounds the wide path is in mlstm_wide.cuh. In both paths the
// scale 1/sqrt(DH) is taken from the true DH.

#include <cuda_runtime.h>

#include "mlstm_wide.cuh"

namespace {

constexpr int kMaxChunk = 128;
constexpr int kThreads = 256;   // two threads per readout row
constexpr int kScanAhead = 8;   // chunks whose inputs the scan loads at once
constexpr int kMaxGridY = 65535;

// Phase 1. Grid (bh, nchunks); writes kc (bh, nchunks, DH, DH), nc (bh, nchunks, DH).
template <int DH>
__global__ void __launch_bounds__(kThreads)
mlstm_chunk_state_kernel(const float* __restrict__ k, const float* __restrict__ v,
                         const float* __restrict__ s, const float* __restrict__ cm,
                         float* __restrict__ kc, float* __restrict__ nc, int chunk) {
  __shared__ float k_s[kMaxChunk][DH];
  __shared__ float v_s[kMaxChunk][DH];
  __shared__ float w_s[kMaxChunk];

  const int tid = threadIdx.x;
  const size_t cidx = static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y;
  const size_t off = cidx * chunk * DH;  // Sp = nchunks * chunk
  const size_t goff = cidx * chunk;
  const float top = cm[goff + chunk - 1];  // the chunk's largest s
  for (int e = tid; e < chunk * DH; e += kThreads) {
    k_s[e / DH][e % DH] = k[off + e];
    v_s[e / DH][e % DH] = v[off + e];
  }
  for (int e = tid; e < chunk; e += kThreads) w_s[e] = expf(s[goff + e] - top);
  __syncthreads();

  for (int e = tid; e < DH * DH; e += kThreads) {
    const int i = e / DH, j = e % DH;
    float acc = 0.0f;
    for (int p = 0; p < chunk; ++p) acc = fmaf(k_s[p][i] * w_s[p], v_s[p][j], acc);
    kc[cidx * DH * DH + e] = acc;
  }
  for (int e = tid; e < DH; e += kThreads) {
    float acc = 0.0f;
    for (int p = 0; p < chunk; ++p) acc = fmaf(k_s[p][e], w_s[p], acc);
    nc[cidx * DH + e] = acc;
  }
}

// Phase 2. Grid (bh), DH * DH threads; writes the entry states
// cent (bh, nchunks, DH, DH), nent (bh, nchunks, DH), ment (bh, nchunks).
template <int DH>
__global__ void __launch_bounds__(DH * DH)
mlstm_fwd_scan_kernel(const float* __restrict__ a, const float* __restrict__ cm,
                      const float* __restrict__ kc, const float* __restrict__ nc,
                      float* __restrict__ cent, float* __restrict__ nent,
                      float* __restrict__ ment, int nchunks, int chunk) {
  const int tid = threadIdx.x;  // element (tid / DH, tid % DH) of C*
  const bool has_n = tid < DH;
  const size_t base = static_cast<size_t>(blockIdx.x) * nchunks;
  float c_state = 0.0f, n_state = 0.0f;
  float m_state = -1e30f;  // every thread carries the same m*
  for (int c0 = 0; c0 < nchunks; c0 += kScanAhead) {
    float k_in[kScanAhead], n_in[kScanAhead], top[kScanAhead], a_last[kScanAhead];
#pragma unroll
    for (int u = 0; u < kScanAhead; ++u) {  // loads that do not wait on the carry
      const size_t cidx = base + min(c0 + u, nchunks - 1);
      k_in[u] = kc[cidx * DH * DH + tid];
      n_in[u] = has_n ? nc[cidx * DH + tid] : 0.0f;
      top[u] = cm[(cidx + 1) * chunk - 1];
      a_last[u] = a[(cidx + 1) * chunk - 1];
    }
    // No early exit: a branch here would sink each step's loads below it,
    // and the chain would wait on memory at every step. Past the last chunk
    // the steps run on repeated inputs and store nothing.
#pragma unroll
    for (int u = 0; u < kScanAhead; ++u) {
      if (c0 + u < nchunks) {
        const size_t cidx = base + c0 + u;
        cent[cidx * DH * DH + tid] = c_state;
        if (has_n) nent[cidx * DH + tid] = n_state;
        if (tid == 0) ment[cidx] = m_state;
      }
      const float m_new = fmaxf(m_state, top[u]);  // M' = max(m*, max s)
      const float decay_old = expf(m_state - m_new);
      const float decay_new = expf(top[u] - m_new);
      c_state = fmaf(decay_old, c_state, decay_new * k_in[u]);
      n_state = fmaf(decay_old, n_state, decay_new * n_in[u]);
      m_state = a_last[u] + m_new;
    }
  }
}

// Phase 3. Grid (bh, nchunks); reads the entry states, writes out (bh, Sp, DH).
template <int DH>
__global__ void __launch_bounds__(kThreads)
mlstm_readout_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ a,
                     const float* __restrict__ s, const float* __restrict__ cm,
                     const float* __restrict__ cent, const float* __restrict__ nent,
                     const float* __restrict__ ment, float* __restrict__ out, int chunk,
                     float scale, float eps) {
  __shared__ float q_s[kMaxChunk][DH + 1];  // +1: rows are read per thread
  __shared__ float k_s[kMaxChunk][DH];
  __shared__ float v_s[kMaxChunk][DH];
  __shared__ float s_s[kMaxChunk];
  __shared__ float c_s[DH][DH];
  __shared__ float n_s[DH];

  const int tid = threadIdx.x;
  const int row = tid >> 1;   // readout row of this thread
  const int half = tid & 1;   // which parity of keys it sums
  const size_t cidx = static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y;
  const size_t off = cidx * chunk * DH;
  const size_t goff = cidx * chunk;

  for (int e = tid; e < chunk * DH; e += kThreads) {
    const int r = e / DH, d = e % DH;
    q_s[r][d] = q[off + e];
    k_s[r][d] = k[off + e];
    v_s[r][d] = v[off + e];
  }
  for (int e = tid; e < chunk; e += kThreads) s_s[e] = s[goff + e];
  for (int e = tid; e < DH * DH; e += kThreads) c_s[e / DH][e % DH] = cent[cidx * DH * DH + e];
  for (int e = tid; e < DH; e += kThreads) n_s[e] = nent[cidx * DH + e];
  const float m_state = ment[cidx];
  __syncthreads();

  // Every thread runs the row code so that the pair shuffle sees a full
  // warp; rows past the chunk sum nothing and store nothing.
  const bool live = row < chunk;
  const int t = live ? row : 0;
  float qs[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) qs[d] = q_s[t][d] * scale;
  const float m_row = fmaxf(cm[goff + t], m_state);  // M_t

  float num[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) num[d] = 0.0f;
  float rowsum = 0.0f;
  const int last = live ? t : -1;
  for (int j = half; j <= last; j += 2) {
    const float dec = expf(s_s[j] - m_row);
    float qk0 = 0.0f, qk1 = 0.0f;
#pragma unroll
    for (int d = 0; d < DH; d += 2) {
      qk0 = fmaf(qs[d], k_s[j][d], qk0);
      qk1 = fmaf(qs[d + 1], k_s[j][d + 1], qk1);
    }
    const float att = (qk0 + qk1) * dec;
    rowsum += att;
#pragma unroll
    for (int d = 0; d < DH; ++d) num[d] = fmaf(att, v_s[j][d], num[d]);
  }
  rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 1);
#pragma unroll
  for (int d = 0; d < DH; ++d) num[d] += __shfl_xor_sync(0xffffffffu, num[d], 1);

  if (live) {
    const float inter = expf(m_state - m_row);
    float qn = 0.0f;
#pragma unroll
    for (int i = 0; i < DH; ++i) qn = fmaf(qs[i], n_s[i], qn);
    rowsum = fmaf(inter, qn, rowsum);
    const float denom = fmaxf(fabsf(rowsum), expf(-fmaxf(a[goff + t] + m_row, -60.0f))) + eps;
    float* o = out + off + static_cast<size_t>(t) * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      if ((d >= DH / 2) != (half == 1)) continue;  // each thread stores half
      float qc = 0.0f;
#pragma unroll
      for (int i = 0; i < DH; ++i) qc = fmaf(qs[i], c_s[i][d], qc);
      o[d] = fmaf(inter, qc, num[d]) / denom;
    }
  }
}

// The wide path's carry scan. Grid (bh, ceil((dp * dp + dp) / 256)): one
// thread per element of C* and of n*, the elements of a head spread over
// blocks; each element's recurrence is independent given the m* chain, which
// every thread forms with the same fp32 operations as the narrow scan (block
// 0's thread 0 stores it).
__global__ void __launch_bounds__(kThreads)
wide_fwd_scan_kernel(const float* __restrict__ a, const float* __restrict__ cm,
                     const float* __restrict__ kc, const float* __restrict__ nc,
                     float* __restrict__ cent, float* __restrict__ nent,
                     float* __restrict__ ment, int nchunks, int chunk, int dp) {
  const size_t n_c = static_cast<size_t>(dp) * dp;
  const size_t e = static_cast<size_t>(blockIdx.y) * kThreads + threadIdx.x;
  const bool is_c = e < n_c, is_n = !is_c && e < n_c + dp;
  const bool stores_m = blockIdx.y == 0 && threadIdx.x == 0;
  if (!(is_c || is_n || stores_m)) return;
  const size_t base = static_cast<size_t>(blockIdx.x) * nchunks;
  float state = 0.0f;
  float m_state = -1e30f;
  for (int c0 = 0; c0 < nchunks; c0 += kScanAhead) {
    float in[kScanAhead], top[kScanAhead], a_last[kScanAhead];
#pragma unroll
    for (int u = 0; u < kScanAhead; ++u) {  // loads that do not wait on the carry
      const size_t cidx = base + min(c0 + u, nchunks - 1);
      in[u] = is_c ? kc[cidx * n_c + e] : is_n ? nc[cidx * dp + e - n_c] : 0.0f;
      top[u] = cm[(cidx + 1) * chunk - 1];
      a_last[u] = a[(cidx + 1) * chunk - 1];
    }
#pragma unroll
    for (int u = 0; u < kScanAhead; ++u) {  // no early exit, as in the narrow scan
      if (c0 + u < nchunks) {
        const size_t cidx = base + c0 + u;
        if (is_c) cent[cidx * n_c + e] = state;
        if (is_n) nent[cidx * dp + e - n_c] = state;
        if (stores_m) ment[cidx] = m_state;
      }
      const float m_new = fmaxf(m_state, top[u]);
      const float decay_old = expf(m_state - m_new);
      const float decay_new = expf(top[u] - m_new);
      state = fmaf(decay_old, state, decay_new * in[u]);
      m_state = a_last[u] + m_new;
    }
  }
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v, const float* a,
                   const float* s, const float* cm, float* out, float* kc, float* nc,
                   float* cent, float* nent, float* ment, int bh, int nchunks, int chunk,
                   float scale, float eps, cudaStream_t st) {
  const dim3 grid(bh, nchunks);
  mlstm_chunk_state_kernel<DH><<<grid, kThreads, 0, st>>>(k, v, s, cm, kc, nc, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_fwd_scan_kernel<DH><<<bh, DH * DH, 0, st>>>(a, cm, kc, nc, cent, nent, ment,
                                                    nchunks, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_readout_kernel<DH><<<grid, kThreads, 0, st>>>(q, k, v, a, s, cm, cent, nent, ment,
                                                      out, chunk, scale, eps);
  return cudaGetLastError();
}

// The wide path's readout. Grid (bh * nchunks * ceil(chunk / TM), column
// groups), RowSmem<TM>::kBytes of dynamic shared memory. One block: rows t0
// .. t0 + TM - 1 of one chunk and one group of value columns. It forms the
// row tile's causal scores and denominators (row_scores), then per 128
// columns of h
//   acc = e^{m* - M_t} (q_t / sqrt(DH)) C*  + sum_{j <= t} attn[t][j] v_j
// (the inter-chunk term over the head, then the intra-chunk term over the
// keys, both products of register tiles), and h = acc / denom_t; rows past
// the true sequence length get 0. No workspace: attn stays in shared memory.
template <int TM>
__global__ void __launch_bounds__(mlstm_wide::kThreads, 2)
wide_readout_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ a,
                    const float* __restrict__ s, const float* __restrict__ cm,
                    const float* __restrict__ cent, const float* __restrict__ nent,
                    const float* __restrict__ ment, float* __restrict__ out, int nchunks,
                    int chunk, int rows_last, int dp, float scale, float eps) {
  using namespace mlstm_wide;
  extern __shared__ __align__(16) float smem[];
  const RowSmem<TM> sm(smem);
  const TileCoords tc = tile_coords<TM>(nchunks, chunk, rows_last);
  const ColumnGroup cols = column_group(dp);
  if (cols.begin >= cols.end) return;
  float* o = out + (tc.cidx * chunk + tc.t0) * dp;
  if (tc.live == 0) {  // padding only
    const int w = cols.end - cols.begin;
    for (int e = threadIdx.x; e < tc.tm * w; e += kThreads) {
      o[(e / w) * dp + cols.begin + e % w] = 0.0f;
    }
    return;
  }
  row_scores<TM>(sm, tc, q, k, a, s, cm, nent, ment, chunk, dp, scale, eps);

  const size_t goff = tc.cidx * chunk;
  const int nk = min(tc.t0 + TM, tc.rows);
  const float* qrow = q + (goff + tc.t0) * dp;
  const float* state = cent + tc.cidx * dp * dp;
  for (int n0 = cols.begin; n0 < cols.end; n0 += kBN) {
    const int ncols = min(kBN, cols.end - n0);
    Acc<TM> acc;
    const bool idle = acc.row0 >= tc.live || acc.col0 >= ncols;
    const int last = tc.t0 + min(acc.row0 + 31, tc.live - 1);  // the warp's last key
    pipeline(
        dp / kTile, sm.ring, RowSmem<TM>::kStage,
        [&](int i, float* buf) {
          stage(buf, kLdK, qrow + i * kTile, dp, TM, kTile, tc.live, kTile);
          stage(buf + TM * kLdK, kLdN, state + static_cast<size_t>(i) * kTile * dp + n0, dp, kTile,
                kBN, kTile, ncols);
        },
        [&](int, float* buf) {
          if (!idle) {
            warp_product<Major::kRow, Major::kRow>(acc, buf, kLdK, 0, buf + TM * kLdK, kLdN, 0, 4);
          }
        });
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < Acc<TM>::kNT; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = acc.row(mi, r);
          if (row < tc.live) acc.c[mi][ni][r] *= sm.inter[row] * scale;
        }
    pipeline(
        (nk + kTile - 1) / kTile, sm.ring, RowSmem<TM>::kStage,
        [&](int i, float* buf) {
          stage(buf, kLdN, v + (goff + static_cast<size_t>(i) * kTile) * dp + n0, dp, kTile, kBN,
                nk - i * kTile, ncols);
        },
        [&](int i, float* buf) {
          const int steps = causal_steps(i * kTile, last);
          if (!idle && steps > 0) {
            warp_product<Major::kRow, Major::kRow>(acc, sm.p, kLdS, i * kTile, buf, kLdN, 0, steps);
          }
        });
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < Acc<TM>::kNT; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = acc.row(mi, r), col = acc.col(ni, r);
          if (row < tc.tm && col < ncols) {
            o[static_cast<size_t>(row) * dp + n0 + col] =
                row < tc.live ? acc.c[mi][ni][r] / sm.denom[row] : 0.0f;
          }
        }
  }
}

template <int TM>
cudaError_t launch_readout(const float* q, const float* k, const float* v, const float* a,
                           const float* s, const float* cm, const float* cent,
                           const float* nent, const float* ment, float* out, int bh,
                           int nchunks, int chunk, int rows_last, int dp, int col_groups,
                           float scale, float eps, int device, cudaStream_t st) {
  using mlstm_wide::RowSmem;
  static bool smem_set[mlstm_wide::kMaxDevices] = {};
  cudaError_t err = mlstm_wide::allow_smem(wide_readout_kernel<TM>, RowSmem<TM>::kBytes, device,
                                           smem_set);
  if (err != cudaSuccess) return err;
  const unsigned tiles = static_cast<unsigned>(bh) * nchunks * ((chunk + TM - 1) / TM);
  wide_readout_kernel<TM><<<dim3(tiles, col_groups), mlstm_wide::kThreads, RowSmem<TM>::kBytes,
                            st>>>(q, k, v, a, s, cm, cent, nent, ment, out, nchunks, chunk,
                                  rows_last, dp, scale, eps);
  return cudaGetLastError();
}

// The wide path (dp a multiple of 32): chunk states, carry scan, readout.
cudaError_t launch_wide(const float* q, const float* k, const float* v, const float* a,
                        const float* s, const float* cm, float* out, float* kc, float* nc,
                        float* cent, float* nent, float* ment, int bh, int nchunks, int chunk,
                        int rows_last, int dp, int row_tile, int col_groups, float scale,
                        float eps, int device, cudaStream_t st) {
  using namespace mlstm_wide;
  const unsigned state_blocks = (dp * dp + dp + kThreads - 1) / kThreads;
  cudaError_t err = launch_outer<Outer::kChunkState>(k, v, s, cm, nullptr, nullptr, nullptr, kc,
                                                     nc, bh, nchunks, chunk, rows_last, dp, 1.0f,
                                                     device, st);
  if (err != cudaSuccess) return err;
  wide_fwd_scan_kernel<<<dim3(bh, state_blocks), kThreads, 0, st>>>(a, cm, kc, nc, cent, nent,
                                                                    ment, nchunks, chunk, dp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return row_tile == 64
             ? launch_readout<64>(q, k, v, a, s, cm, cent, nent, ment, out, bh, nchunks, chunk,
                                  rows_last, dp, col_groups, scale, eps, device, st)
             : launch_readout<32>(q, k, v, a, s, cm, cent, nent, ment, out, bh, nchunks, chunk,
                                  rows_last, dp, col_groups, scale, eps, device, st);
}

}  // namespace

// q, k, v, out: (bh, seq_len, dp) fp32, dh <= dp the true head width (the
// columns past it zero); a, s, cm: (bh, seq_len) fp32, seq_len a multiple of
// chunk; the workspace kc (bh, seq_len / chunk, dp, dp) and nc (bh,
// seq_len / chunk, dp); the entry states cent (bh, seq_len / chunk, dp, dp),
// nent (bh, seq_len / chunk, dp) and ment (bh, seq_len / chunk), written
// here. All fp32, contiguous, 16-byte aligned, on `device`. The wide path
// (dp a multiple of 32, up to 512) also takes rows_last, the true rows of
// each head's last chunk (1 .. chunk; the rows past it are padding, written
// as 0), and its plan: row_tile (64 or 32) and col_groups (the value columns
// split over that many blocks per row tile); the narrow one (dp 8 or 16)
// ignores them. Enqueues the launches on `stream` and returns the first
// cudaError_t of a launch (0 on success).
extern "C" int mlstm_fwd_launch(const float* q, const float* k, const float* v,
                                const float* a, const float* s, const float* cm,
                                float* out, float* kc, float* nc, float* cent,
                                float* nent, float* ment, int bh, int seq_len, int chunk,
                                int dp, int dh, int rows_last, int row_tile, int col_groups,
                                float eps, int device, void* stream) {
  const bool wide = dp % mlstm_wide::kTile == 0 && dp <= mlstm_wide::kWideMaxDh;
  if (bh <= 0 || chunk <= 0 || chunk > kMaxChunk || seq_len % chunk != 0 ||
      seq_len / chunk > kMaxGridY || dh <= 0 || dh > dp ||
      !(dp == 8 || dp == 16 || wide)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (wide && (rows_last < 1 || rows_last > chunk || (row_tile != 64 && row_tile != 32) ||
               col_groups < 1 || col_groups > dp / mlstm_wide::kTile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nchunks = seq_len / chunk;
  const float scale = 1.0f / sqrtf(static_cast<float>(dh));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dp == 8) {
    return static_cast<int>(launch<8>(q, k, v, a, s, cm, out, kc, nc, cent, nent, ment, bh,
                                      nchunks, chunk, scale, eps, st));
  }
  if (dp == 16) {
    return static_cast<int>(launch<16>(q, k, v, a, s, cm, out, kc, nc, cent, nent, ment, bh,
                                       nchunks, chunk, scale, eps, st));
  }
  return static_cast<int>(launch_wide(q, k, v, a, s, cm, out, kc, nc, cent, nent, ment, bh,
                                      nchunks, chunk, rows_last, dp, row_tile, col_groups,
                                      scale, eps, device, st));
}

extern "C" const char* mlstm_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
