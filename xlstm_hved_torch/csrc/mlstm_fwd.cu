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
//     relative to its largest s, cm_{L-1} (every exponent <= 0), as 2 x 2
//     register tiles summed over groups of rows (mlstm_narrow::outer_sum):
//       K_c = sum_p e^{s_p - cm_{L-1}} k_p v_p^T,  n_c = sum_p e^{..} k_p;
//  2. carry scan, one warp per 32 elements of (C*, n*) of a head: per
//     segment of 256 chunks, first the scalar chain (M' = max(m*, cm_{L-1}),
//     m*' = a_{L-1} + M', from m* = -1e30, the same fp32 operations as the
//     JAX _m_entry_chain, so m* is bitwise its), then the decays e^{m* - M'}
//     and e^{cm_{L-1} - M'} of all the segment's chunks at once, then per
//     chunk: store the entry state and
//       C*' = fmaf(e^{m* - M'}, C*, e^{cm_{L-1} - M'} K_c),  n*' likewise;
//  3. readout, one block per (head, chunk), from the chunk's entry state:
//       M_t    = max(m*, cm_t)
//       num_t  = sum_{j<=t} e^{s_j - M_t} (q_t.k_j / sqrt(DH)) v_j + e^{m* - M_t} (q_t / sqrt(DH)) C*
//       rowsum = the same with 1 in place of v_j and n* in place of C*
//       h_t    = num_t / (max(|rowsum_t|, e^{-max(a_t + M_t, -60)}) + eps)
//     The causal mask is the loop bound j <= t, so masked entries are never
//     formed (the log-space mask of the reference, exactly). The rows are
//     walked as mlstm_narrow.cuh sets out: eight lanes share a group of four
//     rows (two long, two short), each lane reads every eighth key once for
//     two adjacent rows, and no lane takes more than 2 ceil((L + 2) / 8)
//     (row, key) pairs (34 at L = 128); mlstm_bwd.cu forms every score
//     with the same operations on the same lanes to get the same
//     denominators and branches.
// Padded keys (igate -1e30, zero k and v) add exact zeros. The scan and
// the readout are programmatic dependents of the launch before them: they
// load what the call's inputs give them while it runs.
//
// Precision: every product is an IEEE fp32 FMA on the CUDA cores, and expf
// is the full-precision libm call (no fast math). No TF32: its products
// (10-bit mantissa) gave O(1) output error through the max(|rowsum|,
// e^{-m}) normaliser, which amplifies truncated products; split-precision
// 3xTF32 on the wide path broke the absolute bound at DH 512
// (mlstm_wide.cuh).
//
// What bounds the narrow path (an H100 80GB HBM3 at 700 W, PERF.md): not a
// peak rate. At the flagship's S = 4096 (4 heads, 128 blocks, one wave of
// the 132 SMs) the forward's 0.09 GFLOP would take 1.4 us at the fp32 rate;
// each launch is a few microseconds of latency (the copies in, the chain,
// the block's barriers and sums over its lanes). At S 32768-49152 (DH 8,
// 1024-1536 blocks) the readout is bound by its instructions per causal
// pair (two DH-long FMA chains and a full-precision expf) and by shared
// memory, which the two-row walk reads once for two rows; the scan by one
// dependent fmaf a chunk. Tiles come in as 16-byte cp.async copies; static
// shared memory stays under 48 KB.
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

#include "mlstm_narrow.cuh"
#include "mlstm_wide.cuh"

namespace {

constexpr int kMaxChunk = 128;
constexpr int kThreads = 256;   // the wide scan's blocks
constexpr int kScanAhead = 8;   // chunks whose inputs the wide scan loads at once
constexpr int kMaxGridY = 65535;

using mlstm_narrow::Slot;
using mlstm_narrow::Width;

// Phase 1. Grid (bh, nchunks), mlstm_narrow::kThreads; writes kc (bh, nchunks, DH, DH),
// nc (bh, nchunks, DH): K_c = sum_p (k_p e^{s_p - cm_{L-1}}) v_p^T and n_c =
// sum_p k_p e^{..}, as 2 x 2 register tiles (mlstm_narrow::outer_sum).
template <int DH>
__global__ void __launch_bounds__(mlstm_narrow::kThreads)
mlstm_chunk_state_kernel(const float* __restrict__ k, const float* __restrict__ v,
                         const float* __restrict__ s, const float* __restrict__ cm,
                         float* __restrict__ kc, float* __restrict__ nc, int chunk) {
  using namespace mlstm_narrow;
  constexpr int kLd = Width<DH>::kLd;
  __shared__ __align__(16) float k_s[kMaxChunk * kLd];
  __shared__ __align__(16) float v_s[kMaxChunk * kLd];
  __shared__ float w_s[kMaxChunk];
  __shared__ float red_s[Outer<DH>::kRedFloats];

  griddep_launch_dependents();  // the scan's gate work needs nothing of this kernel
  const size_t cidx = static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y;
  const size_t off = cidx * chunk * DH;  // Sp = nchunks * chunk
  const size_t goff = cidx * chunk;
  stage_rows<DH>(k_s, k + off, chunk);
  stage_rows<DH>(v_s, v + off, chunk);
  mlstm_wide::cp_async_commit();
  const float top = cm[goff + chunk - 1];  // the chunk's largest s
  for (int e = threadIdx.x; e < chunk; e += mlstm_narrow::kThreads) {
    w_s[e] = expf(s[goff + e] - top);
  }
  cp_async_wait<0>();
  __syncthreads();
  outer_sum<DH, false>(k_s, w_s, v_s, nullptr, chunk, red_s, kc + cidx * DH * DH, nc + cidx * DH);
}

// Phase 2. Grid (bh, ScanGroups<DH>::kGroups), one warp: 32 elements of C*
// (or the DH of n*) of one head; writes their entry states cent (bh,
// nchunks, DH, DH), nent (bh, nchunks, DH) and (group 0) ment (bh,
// nchunks). Per segment of kScanSeg chunks: the m* chain, the same fp32
// operations as JAX's _m_entry_chain (M' = max(m*, cm_{L-1}), m*' = a_{L-1}
// + M', from m* = -1e30), every lane alike; the decays e^{m* - M'} and
// e^{cm_{L-1} - M'} of all the segment's chunks at once, over the lanes;
// then C*' = fmaf(e^{m* - M'}, C*, e^{cm_{L-1} - M'} K_c) (n* likewise), the
// segment's K_c requested at its start (mlstm_narrow::segment_issue).
template <int DH>
__global__ void __launch_bounds__(32)
mlstm_fwd_scan_kernel(const float* __restrict__ a, const float* __restrict__ cm,
                      const float* __restrict__ kc, const float* __restrict__ nc,
                      float* __restrict__ cent, float* __restrict__ nent,
                      float* __restrict__ ment, int nchunks, int chunk) {
  using namespace mlstm_narrow;
  __shared__ __align__(16) float seg_s[kScanSeg * 32];
  __shared__ float top_s[kScanSeg], last_s[kScanSeg], old_s[kScanSeg], new_s[kScanSeg];
  griddep_launch_dependents();
  const int lane = threadIdx.x;
  float state = 0.0f;
  float m_state = -1e30f;  // every lane carries the same m*
  for (int seg0 = 0; seg0 < nchunks; seg0 += kScanSeg) {
    const int n = min(kScanSeg, nchunks - seg0);
    const size_t base = static_cast<size_t>(blockIdx.x) * nchunks + seg0;
    GroupRows gr;
    const float* in0 = group_rows<DH>(kc, nc, base, gr);
    float* out0 = group_rows<DH>(cent, nent, base, gr);
    {  // every load of the segment's gates in flight at once
      float top[kScanSeg / 32], last[kScanSeg / 32];
#pragma unroll
      for (int u = 0; u < kScanSeg / 32; ++u) {
        const size_t at = (base + min(lane + 32 * u, n - 1) + 1) * chunk - 1;
        top[u] = cm[at];
        last[u] = a[at];
      }
#pragma unroll
      for (int u = 0; u < kScanSeg / 32; ++u) {
        if (lane + 32 * u < n) {
          top_s[lane + 32 * u] = top[u];
          last_s[lane + 32 * u] = last[u];
        }
      }
    }
    __syncwarp();
    // the m* chain, eight chunks of straight-line code at a time
    int c0 = 0;
    for (; c0 + 8 <= n; c0 += 8) {
      float top[8], last[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        top[u] = top_s[c0 + u];
        last[u] = last_s[c0 + u];
      }
      float entry[8];  // stored after the block: the chain waits on no store
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        entry[u] = m_state;
        const float m_new = fmaxf(m_state, top[u]);  // M' = max(m*, max s)
        m_state = last[u] + m_new;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) old_s[c0 + u] = entry[u];  // the entry m*, for now
    }
    for (; c0 < n; ++c0) {
      old_s[c0] = m_state;
      const float m_new = fmaxf(m_state, top_s[c0]);
      m_state = last_s[c0] + m_new;
    }
    __syncwarp();
#pragma unroll 8
    for (int c = lane; c < n; c += 32) {
      const float m_in = old_s[c];
      const float m_new = fmaxf(m_in, top_s[c]);
      if (blockIdx.y == 0) ment[base + c] = m_in;
      old_s[c] = expf(m_in - m_new);
      new_s[c] = expf(top_s[c] - m_new);
    }
    griddep_wait();  // K_c and n_c come from the chunk-state launch
    segment_issue<false>(seg_s, n, in0, gr);
    __syncwarp();
    state = segment_chain<false, true>(seg_s, n, out0, gr, old_s, new_s, state);
  }
}

// Phase 3. Grid (bh, nchunks), mlstm_narrow::kThreads: each group of
// kSplit lanes walks its four rows, two at a time (mlstm_narrow::slot,
// readout_slot); reads the entry states, writes out (bh, Sp, DH). Per row t:
// its scores and row_denominator (the backward's rows kernel forms the same
// bits), then lane u's DH/kSplit columns of
//   h_t = (num_t + e^{m* - M_t} (q_t / sqrt(DH)) C*) / denom_t.
template <int DH>
__global__ void __launch_bounds__(mlstm_narrow::kThreads)
mlstm_readout_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ a,
                     const float* __restrict__ s, const float* __restrict__ cm,
                     const float* __restrict__ cent, const float* __restrict__ nent,
                     const float* __restrict__ ment, float* __restrict__ out, int chunk,
                     float scale, float eps) {
  using namespace mlstm_narrow;
  constexpr int kLd = Width<DH>::kLd, kCols = Width<DH>::kCols;
  __shared__ __align__(16) float q_s[kMaxChunk * kLd];  // q / sqrt(DH)
  __shared__ __align__(16) float k_s[kMaxChunk * kLd];
  __shared__ __align__(16) float v_s[kMaxChunk * kLd];
  __shared__ __align__(16) float c_s[DH * kLd];
  __shared__ float s_s[kMaxChunk];
  __shared__ float mrow_s[kMaxChunk];  // M_t = max(m*, cm_t)
  __shared__ float a_s[kMaxChunk];
  __shared__ float n_s[DH];

  const int tid = threadIdx.x;
  const size_t cidx = static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y;
  const size_t off = cidx * chunk * DH;
  const size_t goff = cidx * chunk;
  static_assert(mlstm_narrow::kThreads >= kMaxChunk, "one thread per row of the chunk");
  stage_rows<DH>(q_s, q + off, chunk);  // the call's inputs, while the scan runs
  stage_rows<DH>(k_s, k + off, chunk);
  stage_rows<DH>(v_s, v + off, chunk);
  mlstm_wide::cp_async_commit();
  const bool row = tid < chunk;
  const float cm_t = row ? cm[goff + tid] : 0.0f;
  if (row) {
    s_s[tid] = s[goff + tid];
    a_s[tid] = a[goff + tid];
  }
  griddep_wait();  // the entry states come from the scan
  stage_rows<DH>(c_s, cent + cidx * DH * DH, DH);
  mlstm_wide::cp_async_commit();
  const float m_state = ment[cidx];
  if (row) mrow_s[tid] = fmaxf(cm_t, m_state);
  if (tid < DH) n_s[tid] = nent[cidx * DH + tid];
  cp_async_wait<0>();
  __syncthreads();
  scale_rows<DH>(q_s, chunk, scale);
  __syncthreads();

  const int col0 = first_col<DH>();
  const auto finish = [&](int t, const float (&qs)[DH], const float (&num)[kCols], float keys) {
    const RowScalars r = row_denominator<DH>(qs, n_s, m_state, mrow_s[t], a_s[t], keys, eps);
    float h[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float qc = 0.0f;
#pragma unroll
      for (int i = 0; i < DH; ++i) qc = fmaf(qs[i], c_s[i * kLd + col0 + c], qc);
      h[c] = __fdiv_rn(fmaf(r.inter, qc, num[c]), r.denom);
    }
    store_cols<DH>(out + off + static_cast<size_t>(t) * DH + col0, h);
  };
  for (int s = 0; s < 2; ++s) {
    const Slot w = slot(chunk, s);
    float qs_hi[DH], qs_lo[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      qs_hi[d] = q_s[w.hi * kLd + d];
      qs_lo[d] = q_s[w.lo * kLd + d];
    }
    float num_hi[kCols], num_lo[kCols], keys_hi, keys_lo;
    readout_slot<DH>(w, qs_hi, qs_lo, mrow_s[w.hi], mrow_s[w.lo], k_s, v_s, s_s, num_hi, num_lo,
                     keys_hi, keys_lo);
    if (w.live_hi) finish(w.hi, qs_hi, num_hi, keys_hi);
    if (w.live_lo) finish(w.lo, qs_lo, num_lo, keys_lo);
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
    for (int u = 0; u < kScanAhead; ++u) {  // no early exit: a branch would sink the loads below it
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
  using mlstm_narrow::launch_dependent;
  const dim3 grid(bh, nchunks), block(mlstm_narrow::kThreads);
  mlstm_chunk_state_kernel<DH><<<grid, block, 0, st>>>(k, v, s, cm, kc, nc, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_dependent(mlstm_fwd_scan_kernel<DH>,
                         dim3(bh, mlstm_narrow::ScanGroups<DH>::kGroups), dim3(32), st, a, cm,
                         kc, nc, cent, nent, ment, nchunks, chunk);
  if (err != cudaSuccess) return err;
  return launch_dependent(mlstm_readout_kernel<DH>, grid, block, st, q, k, v, a, s, cm, cent,
                          nent, ment, out, chunk, scale, eps);
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
