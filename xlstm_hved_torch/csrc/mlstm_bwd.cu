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
//  1. rows, one block per (head, chunk), two threads per readout row t (keys
//     split by parity, as in mlstm_fwd.cu): recompute num_t, rowsum_t and the
//     denominator with the forward kernel's operations, in its order (the
//     loop bound j <= t, the -60 clamp, the act = |rowsum| >= e^{-m}
//     branch); then g/denom, d rowsum, dax_t and, in a second pass over the
//     keys, dq_t, which is complete here. Each row's denominator and
//     d rowsum go to a (bh, Sp) workspace, and the chunk's readout adjoints
//     of its entry state, dC_read, dn_read, dm_read, to a per-chunk one;
//  2. reverse scan, one block per head, one thread per element of dC: from
//     a zero carry at the last chunk, store each chunk's incoming carry (the
//     adjoint of its exit state), then dC = e_dec dC + dC_read (dn likewise),
//     with e_dec = e^{m* - M'}. Then, one warp per chunk c >= 1, the carried
//     dm = e_dec (sum dC * C* + sum dn * n*) + dm_read of chunk c lands on
//     dax[c-1, L-1] (m*' = a_{L-1} + M');
//  3. columns, one block per (head, chunk), two threads per key p (rows
//     t >= p split by parity): recompute attn[t, p] and dattn[t, p] =
//     (g_t / denom_t).v_p + drow_t from the stored row scalars, sum dk_p,
//     dv_p and ds_p, and add the state update's adjoint of key p under the
//     chunk's incoming carry.
// No L x L buffer: the column phase recomputes attn and dattn. No atomics
// and no sum across blocks: each sum stays in one block, in a fixed order,
// so the gradients are deterministic.
//
// Precision (narrow kernels): IEEE fp32 FMAs and full-precision expf, no
// fast math and no tensor cores, for the reason given in mlstm_fwd.cu. What
// bounds the narrow path: at the flagship's S = 4096 the work is about
// 0.26 GFLOP and 7.8 MB (3.9 us at the card's fp32 rate); latency bounds
// each phase. Phases 1 and 3 run B*NH x S/L blocks, one wave on the 132
// SMs, and the rows with the most keys (or the keys with the most rows) set
// their time; the scan is a chain of nchunks FMAs, its inputs loaded
// kScanAhead chunks ahead. Splitting the row and column phases into
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

#include "mlstm_wide.cuh"

namespace {

constexpr int kMaxChunk = 128;
constexpr int kThreads = 256;  // two threads per row (rows) or key (columns)
constexpr int kWarps = kThreads / 32;
constexpr int kScanAhead = 8;  // chunks whose inputs the scan loads at once
constexpr int kMaxGridY = 65535;

using mlstm_wide::block_sum;

// Phase 1. Grid (bh, nchunks). Writes dq (bh, Sp, DH); dax, denom and drow
// (bh, Sp); dcr (bh, nchunks, DH, DH), dnr (bh, nchunks, DH), dmr (bh, nchunks).
template <int DH>
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ g,
                      const float* __restrict__ a, const float* __restrict__ s,
                      const float* __restrict__ cm, const float* __restrict__ cent,
                      const float* __restrict__ nent, const float* __restrict__ ment,
                      float* __restrict__ dq, float* __restrict__ dax,
                      float* __restrict__ denom_out, float* __restrict__ drow_out,
                      float* __restrict__ dcr, float* __restrict__ dnr,
                      float* __restrict__ dmr, int chunk, float scale, float eps) {
  static_assert(DH * DH <= kThreads, "one thread per element of dC_read");
  __shared__ float q_s[kMaxChunk][DH + 1];  // q / sqrt(DH)
  __shared__ float k_s[kMaxChunk][DH + 1];
  __shared__ float v_s[kMaxChunk][DH + 1];
  __shared__ float g_s[kMaxChunk][DH + 1];  // g, then g / denom after the rows
  __shared__ float s_s[kMaxChunk];
  __shared__ float inter_s[kMaxChunk];      // e^{m* - M_t}
  __shared__ float drow_s[kMaxChunk];       // d rowsum_t
  __shared__ float c_s[DH][DH + 1];         // entry C* of the chunk
  __shared__ float n_s[DH];
  __shared__ float red_s[kWarps];

  const int tid = threadIdx.x;
  const int lane_row = tid >> 1;
  const int half = tid & 1;
  const size_t cidx = static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y;
  const size_t off = cidx * chunk * DH;
  const size_t goff = cidx * chunk;

  for (int e = tid; e < chunk * DH; e += kThreads) {
    const int r = e / DH, d = e % DH;
    q_s[r][d] = q[off + e] * scale;
    k_s[r][d] = k[off + e];
    v_s[r][d] = v[off + e];
    g_s[r][d] = g[off + e];
  }
  for (int e = tid; e < chunk; e += kThreads) s_s[e] = s[goff + e];
  for (int e = tid; e < DH * DH; e += kThreads) c_s[e / DH][e % DH] = cent[cidx * DH * DH + e];
  for (int e = tid; e < DH; e += kThreads) n_s[e] = nent[cidx * DH + e];
  const float m_in = ment[cidx];
  __syncthreads();

  // Every thread runs the row code so that the pair shuffles see a full
  // warp; rows past the chunk sum nothing and store nothing.
  float dm_read_part = 0.0f;
  {
    const bool live = lane_row < chunk;
    const int t = live ? lane_row : 0;
    float qs[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) qs[d] = q_s[t][d];
    const float m_row = fmaxf(cm[goff + t], m_in);
    float num[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) num[d] = 0.0f;
    float rowsum = 0.0f;
    const int last = live ? t : -1;
    for (int j = half; j <= last; j += 2) {  // as mlstm_fwd.cu
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

    const float inter = expf(m_in - m_row);
    float qn = 0.0f;
#pragma unroll
    for (int i = 0; i < DH; ++i) qn = fmaf(qs[i], n_s[i], qn);
    rowsum = fmaf(inter, qn, rowsum);
    const float e_neg = expf(-fmaxf(a[goff + t] + m_row, -60.0f));
    const float denom = fmaxf(fabsf(rowsum), e_neg) + eps;
    const bool act = fabsf(rowsum) >= e_neg;

    float go[DH];
    float gnum = 0.0f, dinter = 0.0f;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      float qc = 0.0f;
#pragma unroll
      for (int i = 0; i < DH; ++i) qc = fmaf(qs[i], c_s[i][d], qc);
      go[d] = g_s[t][d];
      gnum = fmaf(go[d], fmaf(inter, qc, num[d]), gnum);
      go[d] = go[d] / denom;
      dinter = fmaf(qc, go[d], dinter);
    }
    const float ddenom = -gnum / (denom * denom);
    // sign(rowsum) * ddenom on the live branch, sign(0) = 0 as in jnp.sign
    const float drow = !act ? 0.0f : rowsum > 0.0f ? ddenom : rowsum < 0.0f ? -ddenom : 0.0f;
    const float dax_t = act ? 0.0f : -e_neg * ddenom;  // the carried dm comes in phase 2
    dinter = fmaf(drow, qn, dinter);

    // dq_t: the keys again, now with dattn = go.v_j + drow
    float dqs[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) dqs[d] = 0.0f;
    for (int j = half; j <= last; j += 2) {
      const float dec = expf(s_s[j] - m_row);
      float gv = 0.0f;
#pragma unroll
      for (int d = 0; d < DH; ++d) gv = fmaf(go[d], v_s[j][d], gv);
      const float dqk = (gv + drow) * dec;
#pragma unroll
      for (int d = 0; d < DH; ++d) dqs[d] = fmaf(dqk, k_s[j][d], dqs[d]);
    }
#pragma unroll
    for (int d = 0; d < DH; ++d) dqs[d] += __shfl_xor_sync(0xffffffffu, dqs[d], 1);

    __syncwarp();  // both threads of the pair have read g_s[t]
    if (live) {
      float* dq_row = dq + off + static_cast<size_t>(t) * DH;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        if ((d >= DH / 2) != (half == 1)) continue;  // each thread stores half
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < DH; ++j) acc = fmaf(go[j], c_s[d][j], acc);
        dq_row[d] = scale * (dqs[d] + inter * fmaf(drow, n_s[d], acc));
        g_s[t][d] = go[d];
      }
      if (half == 0) {
        inter_s[t] = inter;
        drow_s[t] = drow;
        dax[goff + t] = dax_t;
        denom_out[goff + t] = denom;
        drow_out[goff + t] = drow;
        dm_read_part = inter * dinter;
      }
    }
  }
  __syncthreads();

  // The readout's adjoints of the chunk's entry state.
  if (tid < DH * DH) {
    const int i = tid / DH, j = tid % DH;
    float acc = 0.0f;
    for (int t = 0; t < chunk; ++t) acc = fmaf(q_s[t][i] * inter_s[t], g_s[t][j], acc);
    dcr[cidx * DH * DH + tid] = acc;
  }
  if (tid < DH) {
    float acc = 0.0f;
    for (int t = 0; t < chunk; ++t) acc = fmaf(inter_s[t] * drow_s[t], q_s[t][tid], acc);
    dnr[cidx * DH + tid] = acc;
  }
  const float dm_read = block_sum(dm_read_part, red_s);
  if (tid == 0) dmr[cidx] = dm_read;
}

// e_dec = e^{m* - M'} of chunk cidx, M' = max(m*, max s).
__device__ __forceinline__ float entry_decay(const float* cm, const float* ment,
                                             size_t cidx, int chunk) {
  const float m_in = ment[cidx];
  return expf(m_in - fmaxf(m_in, cm[(cidx + 1) * chunk - 1]));
}

// Phase 2. Grid (bh), DH * DH threads. Writes the incoming carries
// dcc (bh, nchunks, DH, DH) and dnc (bh, nchunks, DH); adds the carried dm
// to dax at the last row of every chunk but the last.
template <int DH>
__global__ void __launch_bounds__(DH * DH)
mlstm_bwd_scan_kernel(const float* __restrict__ cm, const float* __restrict__ cent,
                      const float* __restrict__ nent, const float* __restrict__ ment,
                      const float* __restrict__ dcr, const float* __restrict__ dnr,
                      const float* __restrict__ dmr, float* __restrict__ dcc,
                      float* __restrict__ dnc, float* __restrict__ dax, int nchunks,
                      int chunk) {
  constexpr int kScanWarps = DH * DH / 32;
  const int tid = threadIdx.x;  // element (tid / DH, tid % DH) of dC
  const bool has_n = tid < DH;
  const size_t base = static_cast<size_t>(blockIdx.x) * nchunks;
  float dc = 0.0f, dn = 0.0f;
  for (int c0 = nchunks - 1; c0 >= 0; c0 -= kScanAhead) {
    float r_c[kScanAhead], r_n[kScanAhead], e_dec[kScanAhead];
#pragma unroll
    for (int u = 0; u < kScanAhead; ++u) {  // loads that do not wait on the carry
      const size_t cidx = base + max(c0 - u, 0);
      r_c[u] = dcr[cidx * DH * DH + tid];
      r_n[u] = has_n ? dnr[cidx * DH + tid] : 0.0f;
      e_dec[u] = entry_decay(cm, ment, cidx, chunk);
    }
    // No early exit, as in mlstm_fwd.cu's scan: past the first chunk the
    // steps run on repeated inputs and store nothing.
#pragma unroll
    for (int u = 0; u < kScanAhead; ++u) {
      if (c0 - u >= 0) {
        const size_t cidx = base + c0 - u;
        dcc[cidx * DH * DH + tid] = dc;
        if (has_n) dnc[cidx * DH + tid] = dn;
      }
      dc = fmaf(e_dec[u], dc, r_c[u]);
      dn = fmaf(e_dec[u], dn, r_n[u]);
    }
  }
  __syncthreads();  // every carry stored above is visible to the block

  // The adjoint of chunk c's entry m* is the carried dm of chunk c - 1.
  const int warp = tid >> 5, lane = tid & 31;
  for (int c = 1 + warp; c < nchunks; c += kScanWarps) {
    const size_t cidx = base + c;
    float part = 0.0f;
    for (int e = lane; e < DH * DH; e += 32) {
      part = fmaf(dcc[cidx * DH * DH + e], cent[cidx * DH * DH + e], part);
    }
    if (lane < DH) part = fmaf(dnc[cidx * DH + lane], nent[cidx * DH + lane], part);
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) {
      dax[cidx * chunk - 1] += fmaf(entry_decay(cm, ment, cidx, chunk), part, dmr[cidx]);
    }
  }
}

// Phase 3. Grid (bh, nchunks). Writes dk, dv (bh, Sp, DH) and ds (bh, Sp).
template <int DH>
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_cols_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ g,
                      const float* __restrict__ s, const float* __restrict__ cm,
                      const float* __restrict__ ment, const float* __restrict__ denom_in,
                      const float* __restrict__ drow_in, const float* __restrict__ dcc,
                      const float* __restrict__ dnc, float* __restrict__ dk,
                      float* __restrict__ dv, float* __restrict__ ds, int chunk,
                      float scale) {
  __shared__ float q_s[kMaxChunk][DH + 1];  // q / sqrt(DH)
  __shared__ float k_s[kMaxChunk][DH + 1];
  __shared__ float v_s[kMaxChunk][DH + 1];
  __shared__ float g_s[kMaxChunk][DH + 1];  // g / denom
  __shared__ float mcol_s[kMaxChunk];       // M_t = max(m*, cm_t)
  __shared__ float drow_s[kMaxChunk];       // d rowsum_t
  __shared__ float dc_s[DH][DH + 1];        // adjoint of the chunk's exit C*
  __shared__ float dn_s[DH];

  const int tid = threadIdx.x;
  const int half = tid & 1;
  const size_t cidx = static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y;
  const size_t off = cidx * chunk * DH;
  const size_t goff = cidx * chunk;
  const float m_in = ment[cidx];

  for (int e = tid; e < chunk * DH; e += kThreads) {
    const int r = e / DH, d = e % DH;
    q_s[r][d] = q[off + e] * scale;
    k_s[r][d] = k[off + e];
    v_s[r][d] = v[off + e];
    g_s[r][d] = g[off + e] / denom_in[goff + r];  // as the rows phase forms it
  }
  for (int e = tid; e < chunk; e += kThreads) {
    mcol_s[e] = fmaxf(cm[goff + e], m_in);
    drow_s[e] = drow_in[goff + e];
  }
  for (int e = tid; e < DH * DH; e += kThreads) dc_s[e / DH][e % DH] = dcc[cidx * DH * DH + e];
  for (int e = tid; e < DH; e += kThreads) dn_s[e] = dnc[cidx * DH + e];
  const float m_new = fmaxf(m_in, cm[goff + chunk - 1]);  // M' = max(m*, max s)
  __syncthreads();

  const bool live = (tid >> 1) < chunk;
  const int p = live ? tid >> 1 : 0;
  float kp[DH], vp[DH], dkp[DH], dvp[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    kp[d] = k_s[p][d];
    vp[d] = v_s[p][d];
    dkp[d] = 0.0f;
    dvp[d] = 0.0f;
  }
  const float sp = s[goff + p];
  float dsp = 0.0f;
  for (int t = p + half; live && t < chunk; t += 2) {
    const float dec = expf(sp - mcol_s[t]);
    float qk0 = 0.0f, qk1 = 0.0f, gv = 0.0f;
#pragma unroll
    for (int d = 0; d < DH; d += 2) {
      qk0 = fmaf(q_s[t][d], kp[d], qk0);
      qk1 = fmaf(q_s[t][d + 1], kp[d + 1], qk1);
    }
#pragma unroll
    for (int d = 0; d < DH; ++d) gv = fmaf(g_s[t][d], vp[d], gv);
    const float att = (qk0 + qk1) * dec;
    const float dattn = gv + drow_s[t];
    const float dqk = dattn * dec;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      dkp[d] = fmaf(dqk, q_s[t][d], dkp[d]);
      dvp[d] = fmaf(att, g_s[t][d], dvp[d]);
    }
    dsp = fmaf(dattn, att, dsp);
  }
  dsp += __shfl_xor_sync(0xffffffffu, dsp, 1);
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    dkp[d] += __shfl_xor_sync(0xffffffffu, dkp[d], 1);
    dvp[d] += __shfl_xor_sync(0xffffffffu, dvp[d], 1);
  }
  // The state update's adjoint of key p (C*' gets e^{s_p - M'} k_p v_p^T):
  // each thread of the pair forms its half of the columns d, and each value
  // is used where it is formed, so that no DH-wide array of them stays live.
  const float w = expf(sp - m_new);
  float* dk_row = dk + off + static_cast<size_t>(p) * DH;
  float* dv_row = dv + off + static_cast<size_t>(p) * DH;
  float ds_state = 0.0f;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    if ((d >= DH / 2) != (half == 1)) continue;
    float vdc = 0.0f, kdc = 0.0f;  // (v_p dC^T)_d and (k_p^T dC)_d
#pragma unroll
    for (int j = 0; j < DH; ++j) {
      vdc = fmaf(vp[j], dc_s[d][j], vdc);
      kdc = fmaf(kp[j], dc_s[j][d], kdc);
    }
    ds_state = fmaf(kp[d], vdc + dn_s[d], ds_state);
    if (live) {
      dk_row[d] = fmaf(w, vdc + dn_s[d], dkp[d]);
      dv_row[d] = fmaf(w, kdc, dvp[d]);
    }
  }
  ds_state += __shfl_xor_sync(0xffffffffu, ds_state, 1);
  if (live && half == 0) ds[goff + p] = fmaf(w, ds_state, dsp);
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v, const float* g,
                   const float* a, const float* s, const float* cm, const float* cent,
                   const float* nent, const float* ment, float* dq, float* dk, float* dv,
                   float* ds, float* dax, float* denom, float* drow, float* dcr, float* dnr,
                   float* dmr, float* dcc, float* dnc, int bh, int nchunks, int chunk,
                   float scale, float eps, cudaStream_t st) {
  const dim3 grid(bh, nchunks);
  mlstm_bwd_rows_kernel<DH><<<grid, kThreads, 0, st>>>(
      q, k, v, g, a, s, cm, cent, nent, ment, dq, dax, denom, drow, dcr, dnr, dmr, chunk, scale,
      eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_bwd_scan_kernel<DH><<<bh, DH * DH, 0, st>>>(cm, cent, nent, ment, dcr, dnr, dmr, dcc,
                                                    dnc, dax, nchunks, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_bwd_cols_kernel<DH><<<grid, kThreads, 0, st>>>(q, k, v, g, s, cm, ment, denom, drow,
                                                       dcc, dnc, dk, dv, ds, chunk, scale);
  return cudaGetLastError();
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
    for (int u = 0; u < kScanAhead; ++u) {  // no early exit, as in the narrow scan
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
