// Chunkwise mLSTM backward for Hopper (sm_90a), fp32 on the CUDA cores.
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
// Precision: IEEE fp32 FMAs and full-precision expf, no fast math and no
// tensor cores, for the reason given in mlstm_fwd.cu. What bounds it: at the
// flagship's S = 4096 the work is about 0.26 GFLOP and 7.8 MB (3.9 us at
// the card's fp32 rate); latency bounds each phase. Phases 1 and 3 run
// B*NH x S/L blocks, one wave on the 132 SMs, and the rows with the most
// keys (or the keys with the most rows) set their time; the scan is a chain
// of nchunks FMAs, its inputs loaded kScanAhead chunks ahead. Splitting the
// row and column phases into separate kernels keeps each under the register
// file's 255 a thread at DH 16.
//
// Head widths, as in mlstm_fwd.cu: these kernels for DH 8 and 16 (narrower
// heads zero-padded to them), the wide path for DH zero-padded to a
// multiple of 32. The wide path forms the attention and denominators with
// the forward's wide kernel (so it takes the forward's branches), then per
// (head, chunk) the numerator, the row adjoints (d rowsum, the direct dax),
// the L x L dqk = (g/denom . v_j + d rowsum_t) e^{s_j - M_t} with ds's
// attention part, the readout's adjoints of the entry state as 32 x 32
// tiles, the reverse scan split across blocks, dq, dk, dv per 32-column tile
// (dk with its tile's part of ds's state term), and last one block per
// chunk for ds and the carried dm: ten launches, each sum in one block in a
// fixed order, no atomics.

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

// The row adjoints. Grid (bh * nchunks), a warp per row: g_t . num_t (num
// the readout's numerator, before the division), then as the narrow rows
// kernel d denom, d rowsum (on the live branch of the forward's
// denominator), the direct dax_t, and e^{m* - M_t} d rowsum_t q_t.n*, the
// row's part of the readout's dm of the entry state.
__global__ void __launch_bounds__(kThreads)
wide_bwd_rows_kernel(const float* __restrict__ g, const float* __restrict__ num,
                     const float* __restrict__ a, const float* __restrict__ cm,
                     const float* __restrict__ ment, const float* __restrict__ rowsum_in,
                     const float* __restrict__ denom_in, const float* __restrict__ qn_in,
                     float* __restrict__ drow_out, float* __restrict__ dax,
                     float* __restrict__ rowterm, int chunk, int dp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t cidx = blockIdx.x;
  const size_t goff = cidx * chunk;
  const float m_in = ment[cidx];
  for (int t = warp; t < chunk; t += kWarps) {
    const size_t row = (goff + t) * dp;
    float gnum = 0.0f;
    for (int d = lane; d < dp; d += 32) gnum = fmaf(g[row + d], num[row + d], gnum);
    for (int o = 16; o > 0; o >>= 1) gnum += __shfl_xor_sync(0xffffffffu, gnum, o);
    if (lane == 0) {
      const float denom = denom_in[goff + t], rowsum = rowsum_in[goff + t];
      const float m_row = fmaxf(cm[goff + t], m_in);
      const float e_neg = expf(-fmaxf(a[goff + t] + m_row, -60.0f));
      const bool act = fabsf(rowsum) >= e_neg;
      const float ddenom = -gnum / (denom * denom);
      const float drow = !act ? 0.0f : rowsum > 0.0f ? ddenom : rowsum < 0.0f ? -ddenom : 0.0f;
      drow_out[goff + t] = drow;
      dax[goff + t] = act ? 0.0f : -e_neg * ddenom;
      rowterm[goff + t] = expf(m_in - m_row) * (drow * qn_in[goff + t]);
    }
  }
}

// The L x L adjoint of the attention. Grid (bh * nchunks),
// scores_smem_bytes(0) of dynamic shared memory. dattn[t][j] = g_t/denom_t
// . v_j + d rowsum_t; writes dqk = dattn e^{s_j - M_t} (0 above the
// diagonal) and ds's attention part sum_{t >= j} dattn[t][j] attn[t][j].
__global__ void __launch_bounds__(kThreads)
wide_dscores_kernel(const float* __restrict__ g, const float* __restrict__ v,
                    const float* __restrict__ s, const float* __restrict__ cm,
                    const float* __restrict__ ment, const float* __restrict__ denom,
                    const float* __restrict__ drow, const float* __restrict__ attn,
                    float* __restrict__ dqk, float* __restrict__ ds_attn, int chunk, int dp) {
  using mlstm_wide::kStage;
  extern __shared__ float smem[];
  float* stage = smem;                // [kMaxChunk][kMaxChunk + 1], aliases the tiles
  float* s_s = smem + kStage;
  float* mrow_s = s_s + kMaxChunk;
  float* drow_s = mrow_s + kMaxChunk;

  const int tid = threadIdx.x;
  const size_t cidx = blockIdx.x;
  const size_t off = cidx * chunk * dp;
  const size_t goff = cidx * chunk;
  const float m_in = ment[cidx];
  for (int e = tid; e < chunk; e += kThreads) {
    s_s[e] = s[goff + e];
    mrow_s[e] = fmaxf(cm[goff + e], m_in);
    drow_s[e] = drow[goff + e];
  }
  __syncthreads();

  mlstm_wide::Scores sc;
  mlstm_wide::chunk_scores(sc, g, v, denom + goff, 1.0f, nullptr, smem, off, chunk, dp);

  const int tx = tid % 16, ty = tid / 16;
  const float* at = attn + cidx * chunk * chunk;
  float* dq = dqk + cidx * chunk * chunk;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int t = ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = tx + 16 * c;
      if (t < chunk && j < chunk) {
        float d = 0.0f, prod = 0.0f;
        if (j <= t) {
          const float dattn = sc.acc[r][c] + drow_s[t];
          d = dattn * expf(s_s[j] - mrow_s[t]);
          prod = dattn * at[static_cast<size_t>(t) * chunk + j];
        }
        stage[t * (kMaxChunk + 1) + j] = prod;
        dq[static_cast<size_t>(t) * chunk + j] = d;
      }
    }
  }
  __syncthreads();
  if (tid < chunk) {
    float sum = 0.0f;
    for (int t = tid; t < chunk; ++t) sum += stage[t * (kMaxChunk + 1) + tid];
    ds_attn[goff + tid] = sum;
  }
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

// The last step, one block per (head, chunk): ds = the attention part + e^{s_p
// - M'} (the state part, summed over the column tiles in order); and for
// every chunk but a head's first, the carried dm = e_dec (sum dC * C* + sum
// dn * n*) + the readout's dm (sum dC_read * C* + the rows' parts), added to
// dax at the previous chunk's last row (m*' = a_{L-1} + M').
__global__ void __launch_bounds__(kThreads)
wide_bwd_final_kernel(const float* __restrict__ s, const float* __restrict__ cm,
                      const float* __restrict__ cent, const float* __restrict__ nent,
                      const float* __restrict__ ment, const float* __restrict__ dcr,
                      const float* __restrict__ dcc, const float* __restrict__ dnc,
                      const float* __restrict__ rowterm, const float* __restrict__ ds_attn,
                      const float* __restrict__ dsp, float* __restrict__ dax,
                      float* __restrict__ ds, int nchunks, int chunk, int dp) {
  __shared__ float red_s[kWarps];
  const int tid = threadIdx.x;
  const size_t cidx = blockIdx.x;
  const size_t goff = cidx * chunk;
  const int tiles = dp / mlstm_wide::kTile;
  const float m_in = ment[cidx];
  const float m_new = fmaxf(m_in, cm[goff + chunk - 1]);  // M'
  for (int p = tid; p < chunk; p += kThreads) {
    float state = 0.0f;
    for (int i = 0; i < tiles; ++i) state += dsp[(goff + p) * tiles + i];
    ds[goff + p] = fmaf(expf(s[goff + p] - m_new), state, ds_attn[goff + p]);
  }
  if (cidx % nchunks == 0) return;  // a head's first chunk: m* = -1e30 is a constant
  const size_t n_c = static_cast<size_t>(dp) * dp;
  const float* c_in = cent + cidx * n_c;
  float carried = 0.0f, read = 0.0f;
  for (size_t e = tid; e < n_c; e += kThreads) {
    carried = fmaf(dcc[cidx * n_c + e], c_in[e], carried);
    read = fmaf(dcr[cidx * n_c + e], c_in[e], read);
  }
  for (int e = tid; e < dp; e += kThreads) {
    carried = fmaf(dnc[cidx * dp + e], nent[cidx * dp + e], carried);
  }
  for (int e = tid; e < chunk; e += kThreads) read += rowterm[goff + e];
  carried = block_sum(carried, red_s);
  read = block_sum(read, red_s);
  if (tid == 0) dax[goff - 1] += fmaf(entry_decay(cm, ment, cidx, chunk), carried, read);
}

cudaError_t launch_wide(const float* q, const float* k, const float* v, const float* g,
                        const float* a, const float* s, const float* cm, const float* cent,
                        const float* nent, const float* ment, float* dq, float* dk, float* dv,
                        float* ds, float* dax, float* denom, float* drow, float* dcr,
                        float* dnr, float* dcc, float* dnc, float* attn, float* dqk,
                        float* num, float* rowsum, float* qn, float* rowterm, float* ds_attn,
                        float* dsp, int bh, int nchunks, int chunk, int dp, float scale,
                        float eps, cudaStream_t st) {
  using namespace mlstm_wide;
  const unsigned blocks = static_cast<unsigned>(bh) * nchunks;
  const unsigned tiles = dp / kTile;
  const unsigned state_blocks = (dp * dp + dp + kThreads - 1) / kThreads;
  const dim3 col_grid(blocks, tiles);
  cudaError_t err = cudaFuncSetAttribute(
      wide_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(scores_smem_bytes(dp)));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wide_dscores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(scores_smem_bytes(0)));
  if (err != cudaSuccess) return err;
  // the forward's attention and denominators, then its numerator
  wide_scores_kernel<<<blocks, kThreads, scores_smem_bytes(dp), st>>>(
      q, k, a, s, cm, nent, ment, attn, rowsum, denom, qn, chunk, dp, scale, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wide_apply_kernel<Apply::kNumerator><<<col_grid, kThreads, 0, st>>>(
      attn, v, q, cent, nullptr, nullptr, s, cm, ment, denom, nullptr, num, nullptr, chunk, dp,
      scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wide_bwd_rows_kernel<<<blocks, kThreads, 0, st>>>(g, num, a, cm, ment, rowsum, denom, qn,
                                                    drow, dax, rowterm, chunk, dp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wide_dscores_kernel<<<blocks, kThreads, scores_smem_bytes(0), st>>>(
      g, v, s, cm, ment, denom, drow, attn, dqk, ds_attn, chunk, dp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wide_outer_kernel<Outer::kReadAdjoint><<<dim3(blocks, tiles, tiles), kThreads, 0, st>>>(
      q, g, s, cm, ment, denom, drow, dcr, dnr, chunk, dp, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wide_bwd_scan_kernel<<<dim3(bh, state_blocks), kThreads, 0, st>>>(cm, ment, dcr, dnr, dcc,
                                                                    dnc, nchunks, chunk, dp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wide_apply_kernel<Apply::kDq><<<col_grid, kThreads, 0, st>>>(
      dqk, k, g, cent, nent, nullptr, s, cm, ment, denom, drow, dq, nullptr, chunk, dp, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wide_apply_kernel<Apply::kDk><<<col_grid, kThreads, 0, st>>>(
      dqk, q, v, dcc, dnc, k, s, cm, ment, denom, drow, dk, dsp, chunk, dp, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wide_apply_kernel<Apply::kDv><<<col_grid, kThreads, 0, st>>>(
      attn, g, k, dcc, nullptr, nullptr, s, cm, ment, denom, drow, dv, nullptr, chunk, dp,
      scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wide_bwd_final_kernel<<<blocks, kThreads, 0, st>>>(s, cm, cent, nent, ment, dcr, dcc, dnc,
                                                     rowterm, ds_attn, dsp, dax, ds, nchunks,
                                                     chunk, dp);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, g, dq, dk, dv: (bh, seq_len, dp), dh <= dp the true head width
// (the columns past it zero); a, s, cm, ds, dax: (bh, seq_len); cent
// (bh, seq_len / chunk, dp, dp), nent (bh, seq_len / chunk, dp) and ment
// (bh, seq_len / chunk) from mlstm_fwd_launch; the workspace: denom and drow
// (bh, seq_len), dcr and dcc (bh, seq_len / chunk, dp, dp), dnr and dnc
// (bh, seq_len / chunk, dp), dmr (bh, seq_len / chunk, the narrow path's),
// and for the wide path (dp a multiple of 32, up to 512) attn and dqk
// (bh * seq_len / chunk, chunk, chunk), num (bh, seq_len, dp), rowsum, qn,
// rowterm and ds_attn (bh, seq_len) and dsp (bh, seq_len, dp / 32). All
// fp32, contiguous, on `device`, seq_len a multiple of chunk. Enqueues the
// launches on `stream` and returns the first cudaError_t of a launch (0 on
// success).
extern "C" int mlstm_bwd_launch(const float* q, const float* k, const float* v,
                                const float* g, const float* a, const float* s,
                                const float* cm, const float* cent, const float* nent,
                                const float* ment, float* dq, float* dk, float* dv,
                                float* ds, float* dax, float* denom, float* drow, float* dcr,
                                float* dnr, float* dmr, float* dcc, float* dnc, float* attn,
                                float* dqk, float* num, float* rowsum, float* qn,
                                float* rowterm, float* ds_attn, float* dsp, int bh,
                                int seq_len, int chunk, int dp, int dh, float eps, int device,
                                void* stream) {
  const bool wide = dp % mlstm_wide::kTile == 0 && dp <= mlstm_wide::kWideMaxDh;
  if (bh <= 0 || chunk <= 0 || chunk > kMaxChunk || seq_len % chunk != 0 ||
      seq_len / chunk > kMaxGridY || dh <= 0 || dh > dp ||
      !(dp == 8 || dp == 16 || wide)) {
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
                                      dax, denom, drow, dcr, dnr, dcc, dnc, attn, dqk, num,
                                      rowsum, qn, rowterm, ds_attn, dsp, bh, nchunks, chunk, dp,
                                      scale, eps, st));
}

extern "C" const char* mlstm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
