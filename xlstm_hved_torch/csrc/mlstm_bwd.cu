// Chunkwise mLSTM backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel xlstm_hved_tpu/ops/mlstm_pallas.py::
// _mlstm_bwd_kernel (driven by _pallas_backward). Inputs are the prepared
// q, k, v, the cotangent g of h, the gate transforms a, s, cm (see
// mlstm_fwd.cu) and the entry state (C*, n*, m*) of every chunk from
// mlstm_fwd_states. Outputs are dq, dk, dv, ds (the gradient of s) and dax
// (the direct gradient of a); the dA -> d-fgate epilogue stays tensor ops in
// ops/mlstm_cuda.py, as it stayed XLA ops on the TPU.
//
// Every max-based stabiliser is held constant (flash-attention style): they
// cancel exactly in h, so real gradients flow only through the decays
// e^{s_p - M_t} and e^{s_p - M'}, the offsets e^{m* - M_t} and e^{m* - M'},
// and the denominator's e^{-(a_t + M_t)} branch (module docstring of the JAX
// file). The Pallas kernel walks the chunks of a head in reverse, carrying
// the adjoints (dC, dn, dm) of the entry state. Only the dC, dn carry is
// sequential, so this runs in three launches:
//  1. rows, one block per (head, chunk), on the forward readout's walk
//     (mlstm_narrow.cuh: eight lanes to a group of four rows, every eighth
//     key to a lane), one row at a time: recompute each score with the
//     forward's operations on the forward's lanes, so rowsum_t and the
//     denominator are the forward's bits (the loop bound j <= t, the -60
//     clamp, the act = |rowsum| >= e^{-m} branch); on the same pass over
//     the keys, g.num's key part and dq's two key sums, sum_j (g_t.v_j)
//     e^{s_j - M_t} k_j and sum_j e^{s_j - M_t} k_j, so that once d rowsum
//     is known dq_t is (the first) / denom_t + d rowsum_t (the second) plus
//     the entry state's term. Each row's denominator and d rowsum go to a
//     (bh, Sp) workspace, and the chunk's readout adjoints of its entry
//     state, dC_read, dn_read (2 x 2 register tiles, outer_sum), dm_read,
//     to a per-chunk one;
//  2. reverse scan, one warp per 32 elements of (dC, dn) of a head: per
//     segment of 256 chunks from the last, the decays e_dec = e^{m* - M'}
//     of all its chunks at once, then from a zero carry at the last chunk
//     store each chunk's incoming carry (the adjoint of its exit state) and
//     dC = fmaf(e_dec, dC, dC_read) (dn likewise);
//  3. columns, one block per (head, chunk), the readout's walk mirrored
//     (each lane reads every eighth row once for two adjacent keys):
//     recompute attn[t, p] and dattn[t, p] = (g_t / denom_t).v_p + drow_t
//     from the stored row scalars, sum dk_p, dv_p and ds_p, and add the
//     state update's adjoint of key p under the chunk's incoming carry.
//     Then one warp adds the carried dm of the chunk's entry m*, e_dec (sum
//     dC * C* + sum dn * n*) + dm_read, to dax at the previous chunk's last
//     row (m*' = a_{L-1} + M'): a chunk-parallel grid, one writer per
//     element, after launch 1's.
// No L x L buffer: the column phase recomputes attn and dattn. No atomics
// and no sum across blocks: each sum stays in one block, in a fixed order,
// so the gradients are deterministic. The scan and the columns are
// programmatic dependents of the launch before them.
//
// Precision (narrow kernels): IEEE fp32 FMAs and full-precision expf, no
// fast math and no tensor cores, for the reason given in mlstm_fwd.cu. What
// bounds the narrow path (PERF.md): at the flagship's S = 4096 the work is
// about 0.26 GFLOP and 7.8 MB (3.9 us at the card's fp32 rate), and latency
// bounds each launch (one wave of 128 blocks); at S 32768-49152 (DH 8) the
// rows and columns are bound by their instructions per causal pair (four
// DH-long FMA chains and an expf) and their lanes' sums, the scan by one
// dependent fmaf a chunk. Splitting the row and column phases into
// separate kernels keeps each under the register file's 255 a thread at
// DH 16.
//
// Head widths, as in mlstm_fwd.cu: these kernels for DH 8 and 16 (narrower
// heads zero-padded to them), the wide path (mlstm_wide.cuh) for DH
// zero-padded to a multiple of 32, in seven launches: rows in two, one
// block per (head, chunk, row tile, group of columns), the first
// recomputing the forward's scores and denominators with its own
// row_scores (the same bits, the same branches) for the groups' parts of
// g.num, the second the row adjoints, dqk in shared memory and dq; the
// readout's adjoints of the entry states as 64 x 128 tiles; the reverse
// scan split across blocks; columns, one block per (head, chunk, key tile,
// group of columns), walking only the rows at and below its keys for dk,
// dv and ds's parts; per chunk ds and the parts of the carried dm over
// blocks of its entries; and last the carried dm. No L x L
// buffer in device memory; each sum runs in one block in a fixed order (ds's
// state term over the column groups in the final launch), no atomics. The
// precision and what bounds the wide path are in mlstm_wide.cuh.

#include <cuda_runtime.h>

#include "mlstm_narrow.cuh"
#include "mlstm_wide.cuh"

namespace {

constexpr int kMaxChunk = 128;
constexpr int kThreads = 256;  // the wide path's blocks
constexpr int kWarps = kThreads / 32;
constexpr int kScanAhead = 8;  // chunks whose inputs the wide scan loads at once
constexpr int kMaxGridY = 65535;

using mlstm_narrow::load_row;
using mlstm_narrow::Slot;
using mlstm_narrow::Width;
using mlstm_wide::block_sum;

// Phase 1. Grid (bh, nchunks), mlstm_narrow::kThreads, each group of kSplit
// lanes walking its four rows one at a time, on the forward readout's keys.
// Writes dq (bh, Sp, DH); dax, denom and drow
// (bh, Sp); dcr (bh, nchunks, DH, DH), dnr (bh, nchunks, DH), dmr (bh,
// nchunks).
template <int DH>
__global__ void __launch_bounds__(mlstm_narrow::kThreads)
mlstm_bwd_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ g,
                      const float* __restrict__ a, const float* __restrict__ s,
                      const float* __restrict__ cm, const float* __restrict__ cent,
                      const float* __restrict__ nent, const float* __restrict__ ment,
                      float* __restrict__ dq, float* __restrict__ dax,
                      float* __restrict__ denom_out, float* __restrict__ drow_out,
                      float* __restrict__ dcr, float* __restrict__ dnr,
                      float* __restrict__ dmr, int chunk, float scale, float eps) {
  using namespace mlstm_narrow;
  constexpr int kLd = Width<DH>::kLd, kCols = Width<DH>::kCols;
  static_assert(Outer<DH>::kRedFloats <= kMaxChunk * kLd, "outer_sum's parts fit in v_s");
  __shared__ __align__(16) float q_s[kMaxChunk * kLd];  // q / sqrt(DH)
  __shared__ __align__(16) float k_s[kMaxChunk * kLd];
  __shared__ __align__(16) float v_s[kMaxChunk * kLd];  // then outer_sum's parts
  __shared__ __align__(16) float g_s[kMaxChunk * kLd];  // g, then g / denom
  __shared__ __align__(16) float c_s[DH * kLd];         // entry C* of the chunk
  __shared__ float s_s[kMaxChunk];
  __shared__ float inter_s[kMaxChunk];                  // e^{m* - M_t}
  __shared__ float drow_s[kMaxChunk];                   // d rowsum_t
  __shared__ float dm_s[kMaxChunk];                     // the rows' parts of dm_read
  __shared__ float mrow_s[kMaxChunk];                   // M_t = max(m*, cm_t)
  __shared__ float a_s[kMaxChunk];
  __shared__ float n_s[DH];

  griddep_launch_dependents();  // the scan's decays need nothing of this kernel
  const int tid = threadIdx.x;
  const size_t cidx = static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y;
  const size_t off = cidx * chunk * DH;
  const size_t goff = cidx * chunk;
  stage_rows<DH>(q_s, q + off, chunk);
  stage_rows<DH>(k_s, k + off, chunk);
  stage_rows<DH>(v_s, v + off, chunk);
  stage_rows<DH>(g_s, g + off, chunk);
  stage_rows<DH>(c_s, cent + cidx * DH * DH, DH);
  mlstm_wide::cp_async_commit();
  const float m_in = ment[cidx];
  for (int e = tid; e < chunk; e += mlstm_narrow::kThreads) {
    s_s[e] = s[goff + e];
    mrow_s[e] = fmaxf(cm[goff + e], m_in);
    a_s[e] = a[goff + e];
  }
  if (tid < DH) n_s[tid] = nent[cidx * DH + tid];
  cp_async_wait<0>();
  __syncthreads();
  scale_rows<DH>(q_s, chunk, scale);
  __syncthreads();

  const int col0 = first_col<DH>();
  float go_own[4][kCols];  // g_t / denom_t of this lane's columns, each of its rows
#pragma unroll
  for (int q4 = 0; q4 < 4; ++q4) {  // slot 0's rows hi, lo, then slot 1's
    const Slot w = slot(chunk, q4 / 2);
    const bool live = q4 % 2 == 0 ? w.live_hi : w.live_lo;
    const int t = q4 % 2 == 0 ? w.hi : w.lo;
    float qs[DH], gt[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      qs[d] = q_s[t * kLd + d];
      gt[d] = g_s[t * kLd + d];
    }
    const float m_row = mrow_s[t];
    float keys, g_num, a[DH], b[DH];  // the lanes' parts of g.num's key sum and of dq's
    row_grad_pass<DH>(qs, gt, m_row, w.first, live ? t : -1, k_s, v_s, s_s, keys, g_num, a, b);
    const RowScalars r = row_denominator<DH>(qs, n_s, m_in, m_row, a_s[t], keys, eps);
    const bool act = fabsf(r.rowsum) >= r.e_neg;

    // g.num_t = e^{m* - M_t} g.(q_t C* / sqrt(DH)) + g.(keys' num_t), and d inter,
    // over this lane's columns, then the lanes' sums
    float g_qc = 0.0f, dinter = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float qc = 0.0f;
#pragma unroll
      for (int i = 0; i < DH; ++i) qc = fmaf(qs[i], c_s[i * kLd + col0 + c], qc);
      g_qc = fmaf(g_s[t * kLd + col0 + c], qc, g_qc);
      go_own[q4][c] = __fdiv_rn(g_s[t * kLd + col0 + c], r.denom);
      dinter = fmaf(qc, go_own[q4][c], dinter);
    }
    const float gnum = fmaf(r.inter, group_sum(g_qc), group_sum(g_num));
    dinter = group_sum(dinter);
    const float ddenom = -gnum / __fmul_rn(r.denom, r.denom);
    // sign(rowsum) * ddenom on the live branch, sign(0) = 0 as in jnp.sign
    const float drow = !act ? 0.0f : r.rowsum > 0.0f ? ddenom : r.rowsum < 0.0f ? -ddenom : 0.0f;
    const float dax_t = act ? 0.0f : -r.e_neg * ddenom;  // the carried dm comes in phase 3
    dinter = fmaf(drow, r.qn, dinter);

    // dq_t = (sum_j ((g_t / denom_t).v_j + drow) e^{s_j - M_t} k_j + e^{m* - M_t}
    // ((g_t / denom_t) C*^T + drow n*)) / sqrt(DH), the key sum as a / denom +
    // drow b, summed over the lanes
    const float inv = __fdiv_rn(1.0f, r.denom);
#pragma unroll
    for (int d = 0; d < DH; ++d) a[d] = fmaf(drow, b[d], __fmul_rn(a[d], inv));
    float dq_keys[kCols];
    group_scatter<DH>(a, dq_keys);
    if (!live) continue;
    float dq_own[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float gc = 0.0f;  // g_t C*^T, column col0 + c, then over the denominator
#pragma unroll
      for (int j = 0; j < DH; ++j) gc = fmaf(gt[j], c_s[(col0 + c) * kLd + j], gc);
      gc = __fdiv_rn(gc, r.denom);
      dq_own[c] = __fmul_rn(scale, fmaf(r.inter, fmaf(drow, n_s[col0 + c], gc), dq_keys[c]));
    }
    store_cols<DH>(dq + off + static_cast<size_t>(t) * DH + col0, dq_own);
    if (col0 == 0) {
      inter_s[t] = r.inter;
      drow_s[t] = drow;
      dm_s[t] = __fmul_rn(r.inter, dinter);
      dax[goff + t] = dax_t;
      denom_out[goff + t] = r.denom;
      drow_out[goff + t] = drow;
    }
  }
  __syncthreads();  // every lane has read g_s, k_s and v_s
#pragma unroll
  for (int q4 = 0; q4 < 4; ++q4) {
    const Slot w = slot(chunk, q4 / 2);
    if (!(q4 % 2 == 0 ? w.live_hi : w.live_lo)) continue;
    const int t = q4 % 2 == 0 ? w.hi : w.lo;
#pragma unroll
    for (int c = 0; c < kCols; ++c) g_s[t * kLd + col0 + c] = go_own[q4][c];
  }
  __syncthreads();

  // The readout's adjoints of the chunk's entry state: dC_read = sum_t
  // (q_t / sqrt(DH) e^{m* - M_t}) (g_t / denom_t)^T, dn_read = sum_t (q_t /
  // sqrt(DH) e^{m* - M_t}) d rowsum_t, dm_read = sum_t e^{m* - M_t} d inter_t.
  outer_sum<DH, true>(q_s, inter_s, g_s, drow_s, chunk, v_s, dcr + cidx * DH * DH,
                      dnr + cidx * DH);
  if (tid < 32) {
    float part = 0.0f;
    for (int t = tid; t < chunk; t += 32) part = __fadd_rn(part, dm_s[t]);
    for (int o = 16; o > 0; o >>= 1) part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
    if (tid == 0) dmr[cidx] = part;
  }
}

// Phase 2. Grid (bh, ScanGroups<DH>::kGroups), one warp: 32 elements of dC
// (or the DH of dn) of one head, from a zero carry at the last chunk. Per
// segment of kScanSeg chunks, from the last: the decays e_dec = e^{m* - M'}
// of all its chunks at once over the lanes, then, chunk by chunk in
// reverse, store the incoming carry (the adjoint of the chunk's exit state)
// to dcc (bh, nchunks, DH, DH) / dnc (bh, nchunks, DH) and carry =
// fmaf(e_dec, carry, dC_read), the segment's readout adjoints requested at
// its start (mlstm_narrow::segment_issue).
template <int DH>
__global__ void __launch_bounds__(32)
mlstm_bwd_scan_kernel(const float* __restrict__ cm, const float* __restrict__ ment,
                      const float* __restrict__ dcr, const float* __restrict__ dnr,
                      float* __restrict__ dcc, float* __restrict__ dnc, int nchunks, int chunk) {
  using namespace mlstm_narrow;
  __shared__ __align__(16) float seg_s[kScanSeg * 32];
  __shared__ float dec_s[kScanSeg];
  griddep_launch_dependents();
  const int lane = threadIdx.x;
  float carry = 0.0f;
  for (int seg_end = nchunks; seg_end > 0; seg_end -= kScanSeg) {
    const int seg0 = max(0, seg_end - kScanSeg), n = seg_end - seg0;
    const size_t base = static_cast<size_t>(blockIdx.x) * nchunks + seg0;
    GroupRows gr;
    const float* in0 = group_rows<DH>(dcr, dnr, base, gr);
    float* out0 = group_rows<DH>(dcc, dnc, base, gr);
    {  // every load of the segment's offsets in flight at once
      float m_in[kScanSeg / 32], top[kScanSeg / 32];
#pragma unroll
      for (int u = 0; u < kScanSeg / 32; ++u) {
        const int c = min(lane + 32 * u, n - 1);
        m_in[u] = ment[base + c];
        top[u] = cm[(base + c + 1) * chunk - 1];
      }
#pragma unroll
      for (int u = 0; u < kScanSeg / 32; ++u) {
        if (lane + 32 * u < n) dec_s[lane + 32 * u] = expf(m_in[u] - fmaxf(m_in[u], top[u]));
      }
    }
    griddep_wait();  // the readout adjoints come from the rows launch
    segment_issue<true>(seg_s, n, in0, gr);
    __syncwarp();
    carry = segment_chain<true, false>(seg_s, n, out0, gr, dec_s, nullptr, carry);
  }
}

// One key p of the columns kernel: its k, v and s in registers and its sums
// over the rows this lane walks, dk_p = sum_t dqk[t][p] q_t / sqrt(DH), dv_p
// = sum_t attn[t][p] g_t / denom_t and ds_p's attention part sum_t
// dattn[t][p] attn[t][p], with attn and dattn recomputed from the stored
// row scalars (M_t, d rowsum_t; q_s holds q / sqrt(DH), g_s g / denom).
template <int DH>
struct ColKey {
  float kp[DH], vp[DH], dkp[DH], dvp[DH], sp, dsp;

  __device__ __forceinline__ void load(const float* k_s, const float* v_s, const float* s_s,
                                       int p) {
    mlstm_narrow::load_row<DH>(k_s, p, kp);
    mlstm_narrow::load_row<DH>(v_s, p, vp);
    sp = s_s[p];
    dsp = 0.0f;
#pragma unroll
    for (int d = 0; d < DH; ++d) dkp[d] = dvp[d] = 0.0f;
  }
  __device__ __forceinline__ void step_rows(const float (&qt)[DH], const float (&gt)[DH],
                                            float m_row, float drow) {
    const float dec = expf(sp - m_row);
    float qk0 = 0.0f, qk1 = 0.0f, gv = 0.0f;
#pragma unroll
    for (int d = 0; d < DH; d += 2) {
      qk0 = fmaf(qt[d], kp[d], qk0);
      qk1 = fmaf(qt[d + 1], kp[d + 1], qk1);
    }
#pragma unroll
    for (int d = 0; d < DH; ++d) gv = fmaf(gt[d], vp[d], gv);
    const float att = __fmul_rn(__fadd_rn(qk0, qk1), dec);
    const float dattn = __fadd_rn(gv, drow);
    const float dqk = __fmul_rn(dattn, dec);
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      dkp[d] = fmaf(dqk, qt[d], dkp[d]);
      dvp[d] = fmaf(att, gt[d], dvp[d]);
    }
    dsp = fmaf(dattn, att, dsp);
  }
  __device__ __forceinline__ void step(const float* q_s, const float* g_s, float m_row, float drow,
                                       int t) {
    float qt[DH], gt[DH];
    mlstm_narrow::load_row<DH>(q_s, t, qt);
    mlstm_narrow::load_row<DH>(g_s, t, gt);
    step_rows(qt, gt, m_row, drow);
  }
  // The lanes' sums; then for a live key, this lane's columns of dk_p =
  // w (v_p dC^T + dn) + .., dv_p = w k_p dC + .. and ds_p = w sum_i k_p[i]
  // (v_p dC^T + dn)_i + .., w = e^{s_p - M'}. Every lane calls it.
  __device__ __forceinline__ void finish(const float* k_s, const float* dc_s, const float* dn_s,
                                         float m_new, int col0, bool live, float* dk, float* dv,
                                         float* ds, int p) {
    using namespace mlstm_narrow;
    constexpr int kLd = Width<DH>::kLd, kCols = Width<DH>::kCols;
    const float ds_attn = group_sum(dsp);
    float dk_sum[kCols], dv_sum[kCols];
    group_scatter<DH>(dkp, dk_sum);
    group_scatter<DH>(dvp, dv_sum);
    const float wk = expf(sp - m_new);
    float dk_own[kCols], dv_own[kCols], ds_state = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = col0 + c;
      float vdc = 0.0f, kdc = 0.0f;  // (v_p dC^T)_d and (k_p^T dC)_d
#pragma unroll
      for (int j = 0; j < DH; ++j) {
        vdc = fmaf(vp[j], dc_s[d * kLd + j], vdc);
        kdc = fmaf(kp[j], dc_s[j * kLd + d], kdc);
      }
      const float vdn = __fadd_rn(vdc, dn_s[d]);
      ds_state = fmaf(k_s[p * kLd + d], vdn, ds_state);
      dk_own[c] = fmaf(wk, vdn, dk_sum[c]);
      dv_own[c] = fmaf(wk, kdc, dv_sum[c]);
    }
    ds_state = group_sum(ds_state);
    if (!live) return;
    store_cols<DH>(dk + static_cast<size_t>(p) * DH + col0, dk_own);
    store_cols<DH>(dv + static_cast<size_t>(p) * DH + col0, dv_own);
    if (col0 == 0) ds[p] = fmaf(wk, ds_state, ds_attn);
  }
};

// Phase 3. Grid (bh, nchunks), mlstm_narrow::kThreads: each group of kSplit
// lanes walks its four keys, two at a time over the rows at and below them
// (the readout's slots mirrored; each row read once for both keys).
// Writes dk, dv (bh, Sp, DH) and ds (bh, Sp); then one warp adds the
// carried dm of the chunk's entry m*, e_dec (sum dC * C* + sum dn * n*) +
// dm_read, to dax at the previous chunk's last row (m*' = a_{L-1} + M'), for
// every chunk but a head's first: one writer per element, after phase 1's.
template <int DH>
__global__ void __launch_bounds__(mlstm_narrow::kThreads)
mlstm_bwd_cols_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ g,
                      const float* __restrict__ s, const float* __restrict__ cm,
                      const float* __restrict__ cent, const float* __restrict__ nent,
                      const float* __restrict__ ment, const float* __restrict__ denom_in,
                      const float* __restrict__ drow_in, const float* __restrict__ dcc,
                      const float* __restrict__ dnc, const float* __restrict__ dmr,
                      float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ ds,
                      float* __restrict__ dax, int chunk, float scale) {
  using namespace mlstm_narrow;
  constexpr int kLd = Width<DH>::kLd;
  __shared__ __align__(16) float q_s[kMaxChunk * kLd];  // q / sqrt(DH)
  __shared__ __align__(16) float k_s[kMaxChunk * kLd];
  __shared__ __align__(16) float v_s[kMaxChunk * kLd];
  __shared__ __align__(16) float g_s[kMaxChunk * kLd];  // g / denom
  __shared__ __align__(16) float dc_s[DH * kLd];        // adjoint of the chunk's exit C*
  __shared__ float s_s[kMaxChunk];
  __shared__ float mcol_s[kMaxChunk];                   // M_t = max(m*, cm_t)
  __shared__ float drow_s[kMaxChunk];                   // d rowsum_t
  __shared__ float den_s[kMaxChunk];                    // denom_t
  __shared__ float dn_s[DH];

  const int tid = threadIdx.x;
  const size_t cidx = static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y;
  const size_t off = cidx * chunk * DH;
  const size_t goff = cidx * chunk;
  const float m_in = ment[cidx];
  stage_rows<DH>(q_s, q + off, chunk);  // the call's inputs, while the scan runs
  stage_rows<DH>(k_s, k + off, chunk);
  stage_rows<DH>(v_s, v + off, chunk);
  stage_rows<DH>(g_s, g + off, chunk);
  mlstm_wide::cp_async_commit();
  for (int e = tid; e < chunk; e += mlstm_narrow::kThreads) {
    s_s[e] = s[goff + e];
    mcol_s[e] = fmaxf(cm[goff + e], m_in);
  }
  const float m_new = fmaxf(m_in, cm[goff + chunk - 1]);  // M' = max(m*, max s)
  griddep_wait();  // the carries come from the scan, the row scalars from the rows launch
  stage_rows<DH>(dc_s, dcc + cidx * DH * DH, DH);
  mlstm_wide::cp_async_commit();
  for (int e = tid; e < chunk; e += mlstm_narrow::kThreads) {
    drow_s[e] = drow_in[goff + e];
    den_s[e] = denom_in[goff + e];
  }
  if (tid < DH) dn_s[tid] = dnc[cidx * DH + tid];
  cp_async_wait<0>();
  __syncthreads();
  scale_rows<DH>(q_s, chunk, scale);
  divide_rows<DH>(g_s, chunk, den_s);  // as the rows phase forms g / denom
  __syncthreads();

  const int col0 = first_col<DH>();
  for (int s = 0; s < 2; ++s) {
    // the mirror of the readout's slot: keys A = L-1-hi (rows A .. L-1) and
    // B = A + 1, walking rows t = A + first, + kSplit, ... (t >= B for B)
    const Slot w = slot(chunk, s);
    const int key_a = w.live_hi ? chunk - 1 - w.hi : 0;
    const int key_b = w.live_lo ? chunk - 1 - w.lo : 0;
    ColKey<DH> ka, kb;
    ka.load(k_s, v_s, s_s, key_a);
    kb.load(k_s, v_s, s_s, key_b);
    int t = (w.live_hi ? key_a : key_b - 1) + w.first;
    if (t == key_b - 1) {  // key A's own row, which key B does not see
      if (w.live_hi) ka.step(q_s, g_s, mcol_s[t], drow_s[t], t);
      t += kSplit;
    }
    if (w.live_hi && w.live_lo) {
#pragma unroll 1
      for (; t < chunk; t += kSplit) {  // the rows both keys see, read once
        float qt[DH], gt[DH];
        load_row<DH>(q_s, t, qt);
        load_row<DH>(g_s, t, gt);
        ka.step_rows(qt, gt, mcol_s[t], drow_s[t]);
        kb.step_rows(qt, gt, mcol_s[t], drow_s[t]);
      }
    } else if (w.live_hi) {
      for (; t < chunk; t += kSplit) ka.step(q_s, g_s, mcol_s[t], drow_s[t], t);
    } else if (w.live_lo) {
      for (; t < chunk; t += kSplit) kb.step(q_s, g_s, mcol_s[t], drow_s[t], t);
    }
    // the lanes' sums, then the state update's adjoint of each key (C*' gets
    // e^{s_p - M'} k_p v_p^T) under the adjoint dC, dn of the chunk's exit
    // state, this lane's columns
    ka.finish(k_s, dc_s, dn_s, m_new, col0, w.live_hi, dk + off, dv + off, ds + goff, key_a);
    kb.finish(k_s, dc_s, dn_s, m_new, col0, w.live_lo, dk + off, dv + off, ds + goff, key_b);
  }

  // The adjoint of this chunk's entry m* is the carried dm of the chunk
  // before it: lanes over the elements in order, then the warp's sum.
  const int first_chunk = static_cast<int>(blockIdx.y) == 0;
  if (tid >= mlstm_narrow::kThreads - 32 && !first_chunk) {
    const int lane = tid & 31;
    float part = 0.0f;
    for (int e = lane; e < DH * DH; e += 32) {
      part = fmaf(dc_s[(e / DH) * kLd + e % DH], cent[cidx * DH * DH + e], part);
    }
    if (lane < DH) part = fmaf(dn_s[lane], nent[cidx * DH + lane], part);
    for (int o = 16; o > 0; o >>= 1) part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
    if (lane == 0) {
      dax[goff - 1] = __fadd_rn(dax[goff - 1], fmaf(expf(m_in - m_new), part, dmr[cidx]));
    }
  }
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v, const float* g,
                   const float* a, const float* s, const float* cm, const float* cent,
                   const float* nent, const float* ment, float* dq, float* dk, float* dv,
                   float* ds, float* dax, float* denom, float* drow, float* dcr, float* dnr,
                   float* dmr, float* dcc, float* dnc, int bh, int nchunks, int chunk,
                   float scale, float eps, cudaStream_t st) {
  using mlstm_narrow::launch_dependent;
  const dim3 grid(bh, nchunks), block(mlstm_narrow::kThreads);
  mlstm_bwd_rows_kernel<DH><<<grid, block, 0, st>>>(q, k, v, g, a, s, cm, cent, nent, ment, dq,
                                                    dax, denom, drow, dcr, dnr, dmr, chunk, scale,
                                                    eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_dependent(mlstm_bwd_scan_kernel<DH>,
                         dim3(bh, mlstm_narrow::ScanGroups<DH>::kGroups), dim3(32), st, cm, ment,
                         dcr, dnr, dcc, dnc, nchunks, chunk);
  if (err != cudaSuccess) return err;
  return launch_dependent(mlstm_bwd_cols_kernel<DH>, grid, block, st, q, k, v, g, s, cm, cent,
                          nent, ment, denom, drow, dcc, dnc, dmr, dk, dv, ds, dax, chunk, scale);
}

// e_dec = e^{m* - M'} of chunk cidx, M' = max(m*, max s).
__device__ __forceinline__ float entry_decay(const float* cm, const float* ment,
                                             size_t cidx, int chunk) {
  const float m_in = ment[cidx];
  return expf(m_in - fmaxf(m_in, cm[(cidx + 1) * chunk - 1]));
}

// ---- the wide path (dp a multiple of 32)

// The rows, first launch. Grid (bh * nchunks * ceil(chunk / TM), column
// groups), RowSmem<TM>::kBytes of dynamic shared memory; one block per
// (head, chunk, row tile, group of columns). It recomputes the row tile's
// scores and denominators with the forward's row_scores (the same tiling,
// so the same bits and branches), then for each true row t and the group's
// columns the two parts of g_t . num_t: g_t . (q_t C* / sqrt(DH)) and
// g_t . sum_j attn[t][j] v_j, per 128 columns, to gparts (bh * Sp, groups,
// 2); group 0 also writes rowsum_t and q_t.n* / sqrt(DH) (bh * Sp).
template <int TM>
__global__ void __launch_bounds__(mlstm_wide::kThreads, 2)
wide_bwd_gnum_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ g,
                     const float* __restrict__ a, const float* __restrict__ s,
                     const float* __restrict__ cm, const float* __restrict__ cent,
                     const float* __restrict__ nent, const float* __restrict__ ment,
                     float* __restrict__ gparts, float* __restrict__ rowsum_out,
                     float* __restrict__ qn_out, int nchunks, int chunk, int rows_last, int dp,
                     float scale, float eps) {
  using namespace mlstm_wide;
  constexpr int kStage = RowSmem<TM>::kStage;
  extern __shared__ __align__(16) float smem[];
  const RowSmem<TM> sm(smem);
  const int tid = threadIdx.x;
  const TileCoords tc = tile_coords<TM>(nchunks, chunk, rows_last);
  const ColumnGroup cols = column_group(dp);
  if (tc.live == 0) return;  // padding only: nothing reads its rows
  row_scores<TM>(sm, tc, q, k, a, s, cm, nent, ment, chunk, dp, scale, eps);

  const size_t goff = tc.cidx * chunk;
  const size_t first = goff + tc.t0;  // the tile's first row in (bh * Sp)
  const int nk = min(tc.t0 + TM, tc.rows);
  const float* qrow = q + first * dp;
  const float* grow = g + first * dp;
  const float* state = cent + tc.cidx * dp * dp;
  const Acc<TM> lay;  // the fragment layout, for the row sums
  float gqc[2][2] = {}, gpv[2][2] = {};
  for (int n0 = cols.begin; n0 < cols.end; n0 += kBN) {
    const int ncols = min(kBN, cols.end - n0);
    Acc<TM> acc;
    const bool idle = acc.row0 >= tc.live || acc.col0 >= ncols;
    const int last = tc.t0 + min(acc.row0 + 31, tc.live - 1);
    pipeline(
        dp / kTile, sm.ring, kStage,
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
          const int row = acc.row(mi, r), col = acc.col(ni, r);
          if (row < tc.live && col < ncols) {
            gqc[mi][r >> 1] = fmaf(grow[static_cast<size_t>(row) * dp + n0 + col],
                                   acc.c[mi][ni][r] * scale, gqc[mi][r >> 1]);
          }
          acc.c[mi][ni][r] = 0.0f;
        }
    pipeline(
        (nk + kTile - 1) / kTile, sm.ring, kStage,
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
          if (row < tc.live && col < ncols) {
            gpv[mi][r >> 1] = fmaf(grow[static_cast<size_t>(row) * dp + n0 + col], acc.c[mi][ni][r],
                                   gpv[mi][r >> 1]);
          }
        }
  }
  const float g_qc = row_reduce(lay, gqc, sm.red);
  const float g_pv = row_reduce(lay, gpv, sm.red);
  if (tid < tc.live) {
    const size_t t = first + tid;
    gparts[(t * gridDim.y + blockIdx.y) * 2] = g_qc;
    gparts[(t * gridDim.y + blockIdx.y) * 2 + 1] = g_pv;
    if (blockIdx.y == 0) {
      rowsum_out[t] = sm.rowsum[tid];
      qn_out[t] = sm.qn[tid];
    }
  }
}

// The rows, second launch. Grid and shared memory as the first; one block
// per (head, chunk, row tile, group of columns). For each true row t, from
// the first launch's rowsum, q.n* and the groups' parts of g . num (summed
// in group order): d denom, d rowsum (on the live branch of the
// denominator), the direct dax_t and the row's part of the readout's dm of
// the entry state, e^{m* - M_t} (g_t.q_t C* / (sqrt(DH) denom_t) +
// d rowsum_t q_t.n*) (group 0 writes them, with denom and d rowsum for the
// later launches); then, over the head, dqk[t][j] = ((g_t . v_j) /
// denom_t + d rowsum_t) e^{s_j - M_t} for j <= t into the shared slab, and
// for the group's columns dq_t = (sum_j dqk[t][j] k_j + e^{m* - M_t} (g_t
// C*^T / denom_t + d rowsum_t n*)) / sqrt(DH). Rows past the true sequence
// length get 0.
template <int TM>
__global__ void __launch_bounds__(mlstm_wide::kThreads, 2)
wide_bwd_rows_kernel(const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ g, const float* __restrict__ a,
                     const float* __restrict__ s, const float* __restrict__ cm,
                     const float* __restrict__ cent, const float* __restrict__ nent,
                     const float* __restrict__ ment, const float* __restrict__ gparts,
                     const float* __restrict__ rowsum_in, const float* __restrict__ qn_in,
                     float* __restrict__ dq, float* __restrict__ dax,
                     float* __restrict__ denom_out, float* __restrict__ drow_out,
                     float* __restrict__ rowterm, int nchunks, int chunk, int rows_last, int dp,
                     float scale, float eps) {
  using namespace mlstm_wide;
  constexpr int kStage = RowSmem<TM>::kStage;
  extern __shared__ __align__(16) float smem[];
  const RowSmem<TM> sm(smem);
  const int tid = threadIdx.x;
  const TileCoords tc = tile_coords<TM>(nchunks, chunk, rows_last);
  const ColumnGroup cols = column_group(dp);
  const size_t goff = tc.cidx * chunk;
  const size_t first = goff + tc.t0;  // the tile's first row in (bh * Sp)
  float* dq_tile = dq + first * dp;
  if (tc.live == 0) {  // padding only
    const int w = cols.end - cols.begin;
    for (int e = tid; e < tc.tm * w; e += kThreads) {
      dq_tile[(e / w) * dp + cols.begin + e % w] = 0.0f;
    }
    for (int e = tid; e < tc.tm && blockIdx.y == 0; e += kThreads) {
      dax[first + e] = denom_out[first + e] = drow_out[first + e] = rowterm[first + e] = 0.0f;
    }
    return;
  }
  const float m_in = ment[tc.cidx];
  const int nk = min(tc.t0 + TM, tc.rows);
  for (int i = tid; i < dp; i += kThreads) sm.vec[i] = nent[tc.cidx * dp + i];
  for (int i = tid; i < nk; i += kThreads) sm.skey[i] = s[goff + i];
  if (tid < tc.tm) {
    const size_t t = first + tid;
    if (tid < tc.live) {
      // the row scalars as row_scores formed them
      const float m_row = fmaxf(cm[t], m_in);
      const float inter = expf(m_in - m_row);
      const float rowsum = rowsum_in[t];
      const float e_neg = expf(-fmaxf(__fadd_rn(a[t], m_row), -60.0f));
      const float denom = __fadd_rn(fmaxf(fabsf(rowsum), e_neg), eps);
      float g_qc = 0.0f, g_pv = 0.0f;
      for (int i = 0; i < static_cast<int>(gridDim.y); ++i) {
        g_qc += gparts[(t * gridDim.y + i) * 2];
        g_pv += gparts[(t * gridDim.y + i) * 2 + 1];
      }
      const float gnum = fmaf(inter, g_qc, g_pv);
      const float ddenom = -gnum / (denom * denom);
      const bool act = fabsf(rowsum) >= e_neg;
      // sign(rowsum) * ddenom on the live branch, sign(0) = 0 as in jnp.sign
      const float drow = !act ? 0.0f : rowsum > 0.0f ? ddenom : rowsum < 0.0f ? -ddenom : 0.0f;
      if (blockIdx.y == 0) {
        dax[t] = act ? 0.0f : -e_neg * ddenom;  // the carried dm comes in the last launch
        denom_out[t] = denom;
        drow_out[t] = drow;
        rowterm[t] = inter * fmaf(drow, qn_in[t], g_qc / denom);
      }
      sm.mrow[tid] = m_row;
      sm.inter[tid] = inter;
      sm.denom[tid] = denom;
      sm.drow[tid] = drow;
    } else if (blockIdx.y == 0) {
      dax[t] = denom_out[t] = drow_out[t] = rowterm[t] = 0.0f;
    }
  }

  // dqk over the keys and the whole head, into the slab
  const int krows = (nk + kTile - 1) / kTile * kTile;
  const float* grow = g + first * dp;
  const float* state = cent + tc.cidx * dp * dp;
  {
    Acc<TM> acc;
    const bool idle = scores_idle(acc, tc, nk);
    pipeline(
        dp / kTile, sm.ring, kStage,
        [&](int i, float* buf) {
          stage(buf, kLdK, grow + i * kTile, dp, TM, kTile, tc.live, kTile);
          stage(buf + TM * kLdK, kLdK, v + goff * dp + i * kTile, dp, krows, kTile, nk, kTile);
        },
        [&](int, float* buf) {
          if (!idle) {
            warp_product<Major::kRow, Major::kCol>(acc, buf, kLdK, 0, buf + TM * kLdK, kLdK, 0, 4);
          }
        });
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < Acc<TM>::kNT; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = acc.row(mi, r), col = acc.col(ni, r);
          float val = 0.0f;
          if (row < tc.live && col <= tc.t0 + row) {
            const float dattn = __fadd_rn(__fdiv_rn(acc.c[mi][ni][r], sm.denom[row]), sm.drow[row]);
            val = __fmul_rn(dattn, expf(sm.skey[col] - sm.mrow[row]));
          }
          sm.p[row * kLdS + col] = val;
        }
  }
  __syncthreads();

  // dq per 128 columns of the group: the entry state's term over the head,
  // then dqk k
  const float* krow = k + goff * dp;
  for (int n0 = cols.begin; n0 < cols.end; n0 += kBN) {
    const int ncols = min(kBN, cols.end - n0);
    Acc<TM> acc;
    const bool idle = acc.row0 >= tc.live || acc.col0 >= ncols;
    const int last = tc.t0 + min(acc.row0 + 31, tc.live - 1);
    pipeline(
        dp / kTile, sm.ring, kStage,
        [&](int i, float* buf) {
          stage(buf, kLdK, grow + i * kTile, dp, TM, kTile, tc.live, kTile);
          stage(buf + TM * kLdK, kLdK, state + static_cast<size_t>(n0) * dp + i * kTile, dp, kBN,
                kTile, ncols, kTile);
        },
        [&](int, float* buf) {
          if (!idle) {
            warp_product<Major::kRow, Major::kCol>(acc, buf, kLdK, 0, buf + TM * kLdK, kLdK, 0, 4);
          }
        });
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < Acc<TM>::kNT; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = acc.row(mi, r), col = acc.col(ni, r);
          float val = 0.0f;
          if (row < tc.live && col < ncols) {
            val = sm.inter[row] *
                  fmaf(sm.drow[row], sm.vec[n0 + col], acc.c[mi][ni][r] / sm.denom[row]);
          }
          acc.c[mi][ni][r] = val;
        }
    pipeline(
        (nk + kTile - 1) / kTile, sm.ring, kStage,
        [&](int i, float* buf) {
          stage(buf, kLdN, krow + static_cast<size_t>(i) * kTile * dp + n0, dp, kTile, kBN,
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
            dq_tile[static_cast<size_t>(row) * dp + n0 + col] =
                row < tc.live ? acc.c[mi][ni][r] * scale : 0.0f;
          }
        }
  }
}

// The columns kernel's key tile: 32 keys, so that its shared memory (two
// 32-key slabs) lets two blocks share an SM.
constexpr int kKeyTile = 32;

// Dynamic shared memory of the columns kernel (TK keys).
template <int TK>
struct ColSmem {
  static constexpr int kStage = (TK + mlstm_wide::kMaxChunk) * mlstm_wide::kLdK;
  static constexpr int kFloats = 2 * kStage + 2 * TK * mlstm_wide::kLdS + 2 * TK +
                                 3 * mlstm_wide::kMaxChunk +
                                 mlstm_wide::Tiling<TK>::kWarpsN * TK;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
  float* ring;   // 2 x kStage
  float* pt;     // [TK][kLdS]: attn^T[p][t - p0], then attn^T / denom_t
  float* dqt;    // [TK][kLdS]: dqk^T[p][t - p0] / sqrt(DH)
  float* skey;   // [TK]: s_p
  float* wkey;   // [TK]: e^{s_p - M'}
  float* mrow;   // [kMaxChunk]: M_t of the rows t >= p0
  float* den;    // [kMaxChunk]: denom_t
  float* drw;    // [kMaxChunk]: d rowsum_t
  float* red;    // [kWarpsN][TK]

  __device__ __forceinline__ explicit ColSmem(float* base) {
    ring = base;
    pt = ring + 2 * kStage;
    dqt = pt + TK * mlstm_wide::kLdS;
    skey = dqt + TK * mlstm_wide::kLdS;
    wkey = skey + TK;
    mrow = wkey + TK;
    den = mrow + mlstm_wide::kMaxChunk;
    drw = den + mlstm_wide::kMaxChunk;
    red = drw + mlstm_wide::kMaxChunk;
  }
};

// The columns. Grid (bh * nchunks * ceil(chunk / TK), column groups),
// ColSmem<TK>::kBytes of dynamic shared memory; one block per (head, chunk,
// key tile p0 .. p0 + TK - 1, group of columns). It walks the true rows t >=
// p0 only (the rows above a key see it masked):
//  - attn^T and dattn^T = (g_t . v_p) / denom_t + d rowsum_t over the head,
//    dqk = dattn e^{s_p - M_t}, and ds's attention part sum_t dattn attn,
//    all in shared memory;
//  - per 128 columns of its group, dk_p = (v_p dC^T + dn) e^{s_p - M'} +
//    sum_t dqk[t][p] q_t / sqrt(DH) and dv_p = k_p dC e^{s_p - M'} +
//    sum_t attn[t][p] g_t / denom_t (dC, dn: the adjoint of the chunk's exit
//    state), and the group's part of ds's state term, sum_i k_p[i] (v_p
//    dC^T + dn)_i, to dsp (bh * Sp, groups).
// Keys past the true sequence length get 0.
template <int TK>
__global__ void __launch_bounds__(mlstm_wide::kThreads, 2)
wide_bwd_cols_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ g,
                     const float* __restrict__ s, const float* __restrict__ cm,
                     const float* __restrict__ ment, const float* __restrict__ denom,
                     const float* __restrict__ drow, const float* __restrict__ dcc,
                     const float* __restrict__ dnc, float* __restrict__ dk,
                     float* __restrict__ dv, float* __restrict__ ds_attn,
                     float* __restrict__ dsp, int nchunks, int chunk, int rows_last, int dp,
                     float scale) {
  using namespace mlstm_wide;
  constexpr int kStage = ColSmem<TK>::kStage;
  extern __shared__ __align__(16) float smem[];
  const ColSmem<TK> sm(smem);
  const int tid = threadIdx.x;
  const TileCoords tc = tile_coords<TK>(nchunks, chunk, rows_last);  // t0: the first key
  const ColumnGroup cols = column_group(dp);
  const size_t goff = tc.cidx * chunk;
  const size_t first = goff + tc.t0;
  if (tc.live == 0 || cols.begin >= cols.end) {  // padding only, or no columns
    const int w = cols.end - cols.begin;
    for (int e = tid; e < tc.tm * w; e += kThreads) {
      const size_t at = (first + e / w) * dp + cols.begin + e % w;
      dk[at] = dv[at] = 0.0f;
    }
    for (int e = tid; e < tc.tm; e += kThreads) {
      if (blockIdx.y == 0) ds_attn[first + e] = 0.0f;
      dsp[(first + e) * gridDim.y + blockIdx.y] = 0.0f;
    }
    return;
  }
  const float m_in = ment[tc.cidx];
  const float m_new = fmaxf(m_in, cm[goff + chunk - 1]);  // M'
  const int nt = tc.rows - tc.t0;                         // the true rows t >= p0
  const int trows = (nt + kTile - 1) / kTile * kTile;
  for (int p = tid; p < tc.live; p += kThreads) {
    sm.skey[p] = s[first + p];
    sm.wkey[p] = expf(sm.skey[p] - m_new);
  }
  for (int t = tid; t < nt; t += kThreads) {
    sm.mrow[t] = fmaxf(cm[first + t], m_in);
    sm.den[t] = denom[first + t];
    sm.drw[t] = drow[first + t];
  }
  const float* qrow = q + first * dp;
  const float* krow = k + first * dp;
  const float* vrow = v + first * dp;
  const float* grow = g + first * dp;

  // attn^T, then dattn^T: keys x rows over the head
  Acc<TK> acc;
  const bool idle = acc.row0 >= tc.live || acc.col0 >= nt || acc.col0 + Acc<TK>::kWN <= acc.row0;
  const auto keys_by_rows = [&](const float* keys, const float* rows) {
    pipeline(
        dp / kTile, sm.ring, kStage,
        [&](int i, float* buf) {
          stage(buf, kLdK, keys + i * kTile, dp, TK, kTile, tc.live, kTile);
          stage(buf + TK * kLdK, kLdK, rows + i * kTile, dp, trows, kTile, nt, kTile);
        },
        [&](int, float* buf) {
          if (!idle) {
            warp_product<Major::kRow, Major::kCol>(acc, buf, kLdK, 0, buf + TK * kLdK, kLdK, 0, 4);
          }
        });
  };
  keys_by_rows(krow, qrow);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < Acc<TK>::kNT; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = acc.row(mi, r), t = acc.col(ni, r);  // key p0 + p, row p0 + t
        float val = 0.0f;
        if (p < tc.live && t < nt && t >= p) {
          val = __fmul_rn(__fmul_rn(acc.c[mi][ni][r], scale), expf(sm.skey[p] - sm.mrow[t]));
        }
        sm.pt[p * kLdS + t] = val;
        acc.c[mi][ni][r] = 0.0f;
      }
  keys_by_rows(vrow, grow);
  float part[2][2] = {};
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < Acc<TK>::kNT; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = acc.row(mi, r), t = acc.col(ni, r);
        float dqk = 0.0f;
        if (p < tc.live && t < nt && t >= p) {
          const float attn = sm.pt[p * kLdS + t];
          const float dattn = __fadd_rn(__fdiv_rn(acc.c[mi][ni][r], sm.den[t]), sm.drw[t]);
          dqk = __fmul_rn(__fmul_rn(dattn, expf(sm.skey[p] - sm.mrow[t])), scale);
          part[mi][r >> 1] = fmaf(dattn, attn, part[mi][r >> 1]);
          sm.pt[p * kLdS + t] = attn / sm.den[t];
        }
        sm.dqt[p * kLdS + t] = dqk;
      }
  const float attn_part = row_reduce(acc, part, sm.red);
  if (blockIdx.y == 0 && tid < tc.tm) ds_attn[first + tid] = tid < tc.live ? attn_part : 0.0f;

  // per 128 columns of the group: dk, then dv
  const float* state = dcc + tc.cidx * dp * dp;
  const float* dn = dnc + tc.cidx * dp;
  float dss[2][2] = {};
  for (int n0 = cols.begin; n0 < cols.end; n0 += kBN) {
    const int ncols = min(kBN, cols.end - n0);
    for (int pass = 0; pass < 2; ++pass) {  // 0: dk, 1: dv
      Acc<TK> out;
      const bool busy = out.row0 < tc.live && out.col0 < ncols;
      pipeline(
          dp / kTile, sm.ring, kStage,
          [&](int i, float* buf) {
            if (pass == 0) {  // v_p dC^T: B(j, i) = dC[i][j]
              stage(buf, kLdK, vrow + i * kTile, dp, TK, kTile, tc.live, kTile);
              stage(buf + TK * kLdK, kLdK, state + static_cast<size_t>(n0) * dp + i * kTile, dp,
                    kBN, kTile, ncols, kTile);
            } else {          // k_p dC
              stage(buf, kLdK, krow + i * kTile, dp, TK, kTile, tc.live, kTile);
              stage(buf + TK * kLdK, kLdN, state + static_cast<size_t>(i) * kTile * dp + n0, dp,
                    kTile, kBN, kTile, ncols);
            }
          },
          [&](int, float* buf) {
            if (!busy) return;
            if (pass == 0) {
              warp_product<Major::kRow, Major::kCol>(out, buf, kLdK, 0, buf + TK * kLdK, kLdK, 0,
                                                     4);
            } else {
              warp_product<Major::kRow, Major::kRow>(out, buf, kLdK, 0, buf + TK * kLdK, kLdN, 0,
                                                     4);
            }
          });
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < Acc<TK>::kNT; ++ni)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int p = out.row(mi, r), c = out.col(ni, r);
            float val = 0.0f;
            if (p < tc.live && c < ncols) {
              float u = out.c[mi][ni][r];
              if (pass == 0) {
                u += dn[n0 + c];
                dss[mi][r >> 1] =
                    fmaf(krow[static_cast<size_t>(p) * dp + n0 + c], u, dss[mi][r >> 1]);
              }
              val = sm.wkey[p] * u;
            }
            out.c[mi][ni][r] = val;
          }
      const float* slab = pass == 0 ? sm.dqt : sm.pt;
      const float* rows = pass == 0 ? qrow : grow;
      pipeline(
          trows / kTile, sm.ring, kStage,
          [&](int i, float* buf) {
            stage(buf, kLdN, rows + static_cast<size_t>(i) * kTile * dp + n0, dp, kTile, kBN,
                  nt - i * kTile, ncols);
          },
          [&](int i, float* buf) {
            if (busy && (i + 1) * kTile > out.row0) {
              warp_product<Major::kRow, Major::kRow>(out, slab, kLdS, i * kTile, buf, kLdN, 0, 4);
            }
          });
      float* dst = pass == 0 ? dk : dv;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < Acc<TK>::kNT; ++ni)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int p = out.row(mi, r), c = out.col(ni, r);
            if (p < tc.tm && c < ncols) {
              dst[(first + p) * dp + n0 + c] = p < tc.live ? out.c[mi][ni][r] : 0.0f;
            }
          }
    }
  }
  const float state_part = row_reduce(acc, dss, sm.red);
  if (tid < tc.tm) dsp[(first + tid) * gridDim.y + blockIdx.y] = tid < tc.live ? state_part : 0.0f;
}

// The wide path's reverse scan. Grid (bh, ceil((dp * dp + dp) / 256)), one
// thread per element of dC and of dn, spread over blocks as the forward's.
__global__ void __launch_bounds__(kThreads)
wide_bwd_scan_kernel(const float* __restrict__ cm, const float* __restrict__ ment,
                     const float* __restrict__ dcr, const float* __restrict__ dnr,
                     float* __restrict__ dcc, float* __restrict__ dnc, int nchunks, int chunk,
                     int dp) {
  const size_t n_c = static_cast<size_t>(dp) * dp;
  const size_t e = static_cast<size_t>(blockIdx.y) * kThreads + threadIdx.x;
  const bool is_c = e < n_c;
  if (!is_c && e >= n_c + dp) return;
  const size_t base = static_cast<size_t>(blockIdx.x) * nchunks;
  float carry = 0.0f;
  for (int c0 = nchunks - 1; c0 >= 0; c0 -= kScanAhead) {
    float r[kScanAhead], e_dec[kScanAhead];
#pragma unroll
    for (int u = 0; u < kScanAhead; ++u) {  // loads that do not wait on the carry
      const size_t cidx = base + max(c0 - u, 0);
      r[u] = is_c ? dcr[cidx * n_c + e] : dnr[cidx * dp + e - n_c];
      e_dec[u] = entry_decay(cm, ment, cidx, chunk);
    }
#pragma unroll
    for (int u = 0; u < kScanAhead; ++u) {  // no early exit: a branch would sink the loads below it
      if (c0 - u >= 0) {
        const size_t cidx = base + c0 - u;
        if (is_c) {
          dcc[cidx * n_c + e] = carry;
        } else {
          dnc[cidx * dp + e - n_c] = carry;
        }
      }
      carry = fmaf(e_dec[u], carry, r[u]);
    }
  }
}

constexpr int kFinalSpan = 16 * kThreads;  // elements of dC * C* a block of the final launch sums

// The last sums. Grid (bh * nchunks, spans), spans = ceil(dp * dp / kFinalSpan).
// Block y of chunk c: its span's part of sum dC * C* (dC the adjoint of the
// chunk's exit state, C* its entry state; span 0 adds sum dn * n*) to dmp
// (bh * nchunks, spans), each thread's elements in order, then the block's
// threads in order. Span 0 also forms ds = the attention part + e^{s_p - M'}
// (the state part, summed over the column groups in order).
__global__ void __launch_bounds__(kThreads)
wide_bwd_final_kernel(const float* __restrict__ s, const float* __restrict__ cm,
                      const float* __restrict__ cent, const float* __restrict__ nent,
                      const float* __restrict__ ment, const float* __restrict__ dcc,
                      const float* __restrict__ dnc, const float* __restrict__ ds_attn,
                      const float* __restrict__ dsp, float* __restrict__ dmp,
                      float* __restrict__ ds, int nchunks, int chunk, int rows_last, int dp,
                      int groups) {
  __shared__ float red_s[kWarps];
  const int tid = threadIdx.x;
  const size_t cidx = blockIdx.x;
  const size_t goff = cidx * chunk;
  if (blockIdx.y == 0) {
    const int rows = static_cast<int>(cidx % nchunks) == nchunks - 1 ? rows_last : chunk;
    const float m_in = ment[cidx];
    const float m_new = fmaxf(m_in, cm[goff + chunk - 1]);  // M'
    for (int p = tid; p < chunk; p += kThreads) {
      float value = 0.0f;
      if (p < rows) {
        float state = 0.0f;
        for (int i = 0; i < groups; ++i) state += dsp[(goff + p) * groups + i];
        value = fmaf(expf(s[goff + p] - m_new), state, ds_attn[goff + p]);
      }
      ds[goff + p] = value;
    }
  }
  if (cidx % nchunks == 0) return;  // a head's first chunk: m* = -1e30 is a constant
  const size_t n_c = static_cast<size_t>(dp) * dp;
  const size_t begin = static_cast<size_t>(blockIdx.y) * kFinalSpan;
  const size_t end = begin + kFinalSpan < n_c ? begin + kFinalSpan : n_c;
  float part = 0.0f;
  for (size_t e = begin + tid; e < end; e += kThreads) {
    part = fmaf(dcc[cidx * n_c + e], cent[cidx * n_c + e], part);
  }
  if (blockIdx.y == 0) {
    for (int e = tid; e < dp; e += kThreads) {
      part = fmaf(dnc[cidx * dp + e], nent[cidx * dp + e], part);
    }
  }
  part = block_sum(part, red_s);
  if (tid == 0) dmp[cidx * gridDim.y + blockIdx.y] = part;
}

// The carried dm, one warp per (head, chunk) but a head's first: e_dec
// (the spans' parts of wide_bwd_final_kernel) + the readout's dm (the rows'
// parts), each summed per lane in order and then over the lanes in a fixed
// order, added to dax at the previous chunk's last row (m*' = a_{L-1} + M').
__global__ void __launch_bounds__(kThreads)
wide_bwd_carry_kernel(const float* __restrict__ cm, const float* __restrict__ ment,
                      const float* __restrict__ dmp, const float* __restrict__ rowterm,
                      float* __restrict__ dax, int chunks, int nchunks, int chunk, int rows_last,
                      int spans) {
  const int lane = threadIdx.x & 31;
  const size_t cidx = static_cast<size_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (cidx >= static_cast<size_t>(chunks) || cidx % nchunks == 0) return;  // whole warps
  const size_t goff = cidx * chunk;
  const int rows = static_cast<int>(cidx % nchunks) == nchunks - 1 ? rows_last : chunk;
  float carried = 0.0f, read = 0.0f;
  for (int i = lane; i < spans; i += 32) carried += dmp[cidx * spans + i];
  for (int t = lane; t < rows; t += 32) read += rowterm[goff + t];
  for (int o = 16; o > 0; o >>= 1) {
    carried += __shfl_xor_sync(0xffffffffu, carried, o);
    read += __shfl_xor_sync(0xffffffffu, read, o);
  }
  if (lane == 0) dax[goff - 1] += fmaf(entry_decay(cm, ment, cidx, chunk), carried, read);
}

template <int TM>
cudaError_t launch_bwd_rows(const float* q, const float* k, const float* v, const float* g,
                            const float* a, const float* s, const float* cm, const float* cent,
                            const float* nent, const float* ment, float* dq, float* dax,
                            float* denom, float* drow, float* rowterm, float* gparts,
                            float* rowsum, float* qn, int bh, int nchunks, int chunk,
                            int rows_last, int dp, int groups, float scale, float eps,
                            int device, cudaStream_t st) {
  using mlstm_wide::RowSmem;
  static bool gnum_set[mlstm_wide::kMaxDevices] = {}, rows_set[mlstm_wide::kMaxDevices] = {};
  cudaError_t err = mlstm_wide::allow_smem(wide_bwd_gnum_kernel<TM>, RowSmem<TM>::kBytes, device,
                                           gnum_set);
  if (err != cudaSuccess) return err;
  err = mlstm_wide::allow_smem(wide_bwd_rows_kernel<TM>, RowSmem<TM>::kBytes, device, rows_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(bh) * nchunks * ((chunk + TM - 1) / TM), groups);
  wide_bwd_gnum_kernel<TM><<<grid, kThreads, RowSmem<TM>::kBytes, st>>>(
      q, k, v, g, a, s, cm, cent, nent, ment, gparts, rowsum, qn, nchunks, chunk, rows_last, dp,
      scale, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wide_bwd_rows_kernel<TM><<<grid, kThreads, RowSmem<TM>::kBytes, st>>>(
      k, v, g, a, s, cm, cent, nent, ment, gparts, rowsum, qn, dq, dax, denom, drow, rowterm,
      nchunks, chunk, rows_last, dp, scale, eps);
  return cudaGetLastError();
}

template <int TK>
cudaError_t launch_bwd_cols(const float* q, const float* k, const float* v, const float* g,
                            const float* s, const float* cm, const float* ment,
                            const float* denom, const float* drow, const float* dcc,
                            const float* dnc, float* dk, float* dv, float* ds_attn, float* dsp,
                            int bh, int nchunks, int chunk, int rows_last, int dp, int groups,
                            float scale, int device, cudaStream_t st) {
  static bool smem_set[mlstm_wide::kMaxDevices] = {};
  cudaError_t err = mlstm_wide::allow_smem(wide_bwd_cols_kernel<TK>, ColSmem<TK>::kBytes, device,
                                           smem_set);
  if (err != cudaSuccess) return err;
  const unsigned tiles = static_cast<unsigned>(bh) * nchunks * ((chunk + TK - 1) / TK);
  wide_bwd_cols_kernel<TK><<<dim3(tiles, groups), kThreads, ColSmem<TK>::kBytes, st>>>(
      q, k, v, g, s, cm, ment, denom, drow, dcc, dnc, dk, dv, ds_attn, dsp, nchunks, chunk,
      rows_last, dp, scale);
  return cudaGetLastError();
}

// The wide path: rows in two launches, the readout's adjoints of the entry
// states, the reverse scan, columns, ds with the parts of the carried dm,
// and the carried dm: seven launches.
cudaError_t launch_wide(const float* q, const float* k, const float* v, const float* g,
                        const float* a, const float* s, const float* cm, const float* cent,
                        const float* nent, const float* ment, float* dq, float* dk, float* dv,
                        float* ds, float* dax, float* denom, float* drow, float* dcr,
                        float* dnr, float* dcc, float* dnc, float* rowterm, float* ds_attn,
                        float* dsp, float* dmp, float* gparts, float* rowsum, float* qn, int bh,
                        int nchunks, int chunk, int rows_last, int dp,
                        int row_tile, int col_groups, float scale, float eps, int device,
                        cudaStream_t st) {
  using namespace mlstm_wide;
  const unsigned blocks = static_cast<unsigned>(bh) * nchunks;
  const unsigned state_blocks = (dp * dp + dp + kThreads - 1) / kThreads;
  cudaError_t err =
      row_tile == 64
          ? launch_bwd_rows<64>(q, k, v, g, a, s, cm, cent, nent, ment, dq, dax, denom, drow,
                                rowterm, gparts, rowsum, qn, bh, nchunks, chunk, rows_last, dp,
                                col_groups, scale, eps, device, st)
          : launch_bwd_rows<32>(q, k, v, g, a, s, cm, cent, nent, ment, dq, dax, denom, drow,
                                rowterm, gparts, rowsum, qn, bh, nchunks, chunk, rows_last, dp,
                                col_groups, scale, eps, device, st);
  if (err != cudaSuccess) return err;
  err = launch_outer<Outer::kReadAdjoint>(q, g, s, cm, ment, denom, drow, dcr, dnr, bh, nchunks,
                                          chunk, rows_last, dp, scale, device, st);
  if (err != cudaSuccess) return err;
  wide_bwd_scan_kernel<<<dim3(bh, state_blocks), kThreads, 0, st>>>(cm, ment, dcr, dnr, dcc,
                                                                    dnc, nchunks, chunk, dp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = launch_bwd_cols<kKeyTile>(q, k, v, g, s, cm, ment, denom, drow, dcc, dnc, dk, dv,
                                  ds_attn, dsp, bh, nchunks, chunk, rows_last, dp, col_groups,
                                  scale, device, st);
  if (err != cudaSuccess) return err;
  const int spans = (dp * dp + kFinalSpan - 1) / kFinalSpan;
  wide_bwd_final_kernel<<<dim3(blocks, spans), kThreads, 0, st>>>(
      s, cm, cent, nent, ment, dcc, dnc, ds_attn, dsp, dmp, ds, nchunks, chunk, rows_last, dp,
      col_groups);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wide_bwd_carry_kernel<<<(blocks + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      cm, ment, dmp, rowterm, dax, blocks, nchunks, chunk, rows_last, spans);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, g, dq, dk, dv: (bh, seq_len, dp), dh <= dp the true head width
// (the columns past it zero); a, s, cm, ds, dax: (bh, seq_len); cent
// (bh, seq_len / chunk, dp, dp), nent (bh, seq_len / chunk, dp) and ment
// (bh, seq_len / chunk) from mlstm_fwd_launch; the workspace: denom and drow
// (bh, seq_len), dcr and dcc (bh, seq_len / chunk, dp, dp), dnr and dnc
// (bh, seq_len / chunk, dp), dmr (bh, seq_len / chunk, the narrow path's),
// and for the wide path (dp a multiple of 32, up to 512) rowterm and
// ds_attn (bh, seq_len), dsp (bh, seq_len, col_groups), dmp (bh,
// seq_len / chunk, ceil(dp * dp / 4096)), gparts (bh, seq_len, col_groups,
// 2), rowsum and qn (bh, seq_len). All fp32,
// contiguous, 16-byte aligned, on `device`, seq_len a multiple of chunk.
// The wide path also takes rows_last, the true rows of each head's last
// chunk (1 .. chunk; the rows past it are padding, their cotangent 0, their
// gradients written as 0), and its plan: row_tile (64 or 32, the forward's;
// the key tiles of the columns launch have as many keys) and col_groups
// (the columns of dk, dv split over that many blocks per key tile); the
// narrow one ignores them. Enqueues the
// launches on `stream` and returns the first cudaError_t of a launch (0 on
// success).
extern "C" int mlstm_bwd_launch(const float* q, const float* k, const float* v,
                                const float* g, const float* a, const float* s,
                                const float* cm, const float* cent, const float* nent,
                                const float* ment, float* dq, float* dk, float* dv,
                                float* ds, float* dax, float* denom, float* drow, float* dcr,
                                float* dnr, float* dmr, float* dcc, float* dnc, float* rowterm,
                                float* ds_attn, float* dsp, float* dmp, float* gparts,
                                float* rowsum, float* qn, int bh, int seq_len, int chunk,
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
    return static_cast<int>(launch<8>(q, k, v, g, a, s, cm, cent, nent, ment, dq, dk, dv, ds,
                                      dax, denom, drow, dcr, dnr, dmr, dcc, dnc, bh, nchunks,
                                      chunk, scale, eps, st));
  }
  if (dp == 16) {
    return static_cast<int>(launch<16>(q, k, v, g, a, s, cm, cent, nent, ment, dq, dk, dv, ds,
                                       dax, denom, drow, dcr, dnr, dmr, dcc, dnc, bh, nchunks,
                                       chunk, scale, eps, st));
  }
  return static_cast<int>(launch_wide(q, k, v, g, a, s, cm, cent, nent, ment, dq, dk, dv, ds,
                                      dax, denom, drow, dcr, dnr, dcc, dnc, rowterm, ds_attn, dsp,
                                      dmp, gparts, rowsum, qn, bh, nchunks, chunk, rows_last, dp,
                                      row_tile, col_groups, scale, eps, device, st));
}

extern "C" const char* mlstm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
