// Reverse-chunk mLSTM backward for Hopper (sm_90a), fp32 on the CUDA cores.
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
// file). For each (batch, head) one block walks the chunks from last to
// first, carrying the adjoints (dC DH x DH, dn DH) in shared memory and dm
// in a register; all three start at zero. Per chunk:
//  1. row phase, two threads per readout row t (keys split by parity, as in
//     mlstm_fwd.cu): recompute num_t, rowsum_t and the denominator with the
//     forward kernel's operations, in its order (the loop bound j <= t, the
//     -60 clamp, the act = |rowsum| >= e^{-m} branch), then g/denom,
//     d rowsum, dax_t and, in a second pass over the keys, dq_t;
//  2. column phase, two threads per key p (rows t >= p split by parity):
//     recompute attn[t, p] and dattn[t, p] = (g_t / denom_t).v_p + drow_t
//     and sum the column terms dk_p, dv_p and ds_p; add the state-update
//     adjoint terms of key p (they read the carried dC, dn);
//  3. the readout's state adjoints dC_read, dn_read, dm_read, then the carry
//     update dC = e^{m* - M'} dC + dC_read (likewise dn), dm = dm_dec + dm_read.
// No L x L buffer: the column phase recomputes attn and dattn, so the tiles
// (q, k, v, g at 128 x 17 floats each) and the row scalars fit in 40 KB of
// static shared memory.
//
// Precision: IEEE fp32 FMAs and full-precision expf, no fast math, for the
// reason given in mlstm_fwd.cu. What bounds it: at the flagship's S = 4096
// the work is about 0.27 GFLOP and 8 MB of traffic, a few microseconds at the
// card's peak rates; like the forward, this simple design is bound by
// latency, with one block per (batch, head) walking its chunks in order.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxChunk = 128;
constexpr int kThreads = 256;  // two threads per row (row phase) or key (column phase)
constexpr int kWarps = kThreads / 32;

// Sum of one value per thread over the block; every thread gets the total,
// added in the same order. Holds two barriers.
__device__ float block_sum(float value, float* red) {
  for (int o = 16; o > 0; o >>= 1) value += __shfl_xor_sync(0xffffffffu, value, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = value;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < kWarps; ++w) total += red[w];
  __syncthreads();  // red is free again
  return total;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ g,
                 const float* __restrict__ a, const float* __restrict__ s,
                 const float* __restrict__ cm, const float* __restrict__ cent,
                 const float* __restrict__ nent, const float* __restrict__ ment,
                 float* __restrict__ dq, float* __restrict__ dk,
                 float* __restrict__ dv, float* __restrict__ ds,
                 float* __restrict__ dax, int seq_len, int chunk, float eps) {
  static_assert(DH * DH <= kThreads, "one thread per element of dC");
  __shared__ float q_s[kMaxChunk][DH + 1];  // q / sqrt(DH)
  __shared__ float k_s[kMaxChunk][DH + 1];
  __shared__ float v_s[kMaxChunk][DH + 1];
  __shared__ float g_s[kMaxChunk][DH + 1];  // g, then g / denom after the row phase
  __shared__ float s_s[kMaxChunk];
  __shared__ float mcol_s[kMaxChunk];       // M_t = max(m*, cm_t)
  __shared__ float inter_s[kMaxChunk];      // e^{m* - M_t}
  __shared__ float drow_s[kMaxChunk];       // d rowsum_t
  __shared__ float c_s[DH][DH + 1];         // entry C* of the chunk
  __shared__ float n_s[DH];
  __shared__ float dc_s[DH][DH + 1];        // carried adjoint of C*
  __shared__ float dn_s[DH];
  __shared__ float red_s[kWarps];

  const int tid = threadIdx.x;
  const int lane_row = tid >> 1;  // row (row phase) or key (column phase)
  const int half = tid & 1;
  const size_t qkv_base = static_cast<size_t>(blockIdx.x) * seq_len * DH;
  const size_t gate_base = static_cast<size_t>(blockIdx.x) * seq_len;
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  const int nchunks = seq_len / chunk;

  for (int e = tid; e < DH * DH; e += kThreads) dc_s[e / DH][e % DH] = 0.0f;
  for (int e = tid; e < DH; e += kThreads) dn_s[e] = 0.0f;
  float dm = 0.0f;  // every thread carries the same dm

  for (int c = nchunks - 1; c >= 0; --c) {
    const size_t off = qkv_base + static_cast<size_t>(c) * chunk * DH;
    const size_t goff = gate_base + static_cast<size_t>(c) * chunk;
    const size_t sidx = static_cast<size_t>(blockIdx.x) * nchunks + c;
    for (int e = tid; e < chunk * DH; e += kThreads) {
      const int r = e / DH, d = e % DH;
      q_s[r][d] = q[off + e] * scale;
      k_s[r][d] = k[off + e];
      v_s[r][d] = v[off + e];
      g_s[r][d] = g[off + e];
    }
    for (int e = tid; e < chunk; e += kThreads) s_s[e] = s[goff + e];
    for (int e = tid; e < DH * DH; e += kThreads) c_s[e / DH][e % DH] = cent[sidx * DH * DH + e];
    for (int e = tid; e < DH; e += kThreads) n_s[e] = nent[sidx * DH + e];
    const float m_in = ment[sidx];
    const float m_new = fmaxf(m_in, cm[goff + chunk - 1]);  // M' = max(m*, max s)
    const float e_dec = expf(m_in - m_new);
    __syncthreads();

    // ---- 1. row phase. Every thread runs it so that the pair shuffles see
    // a full warp; rows past the chunk sum nothing and store nothing.
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

      float go[DH], qc[DH];
      float gnum = 0.0f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < DH; ++i) acc = fmaf(qs[i], c_s[i][d], acc);
        qc[d] = acc;
        go[d] = g_s[t][d];
        gnum = fmaf(go[d], fmaf(inter, acc, num[d]), gnum);
      }
      const float ddenom = -gnum / (denom * denom);
      // sign(rowsum) * ddenom on the live branch, sign(0) = 0 as in jnp.sign
      const float drow = !act ? 0.0f : rowsum > 0.0f ? ddenom : rowsum < 0.0f ? -ddenom : 0.0f;
      float dax_t = act ? 0.0f : -e_neg * ddenom;
      if (t == chunk - 1) dax_t += dm;  // m*' = a_{L-1} + M'
      float dinter = 0.0f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        go[d] = go[d] / denom;
        dinter = fmaf(qc[d], go[d], dinter);
      }
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
          mcol_s[t] = m_row;
          inter_s[t] = inter;
          drow_s[t] = drow;
          dax[goff + t] = dax_t;
          dm_read_part = inter * dinter;
        }
      }
    }
    __syncthreads();

    // ---- 2. column phase: thread pair per key p
    {
      const bool live = lane_row < chunk;
      const int p = live ? lane_row : 0;
      float kp[DH], vp[DH], dkp[DH], dvp[DH];
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        kp[d] = k_s[p][d];
        vp[d] = v_s[p][d];
        dkp[d] = 0.0f;
        dvp[d] = 0.0f;
      }
      const float sp = s_s[p];
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
      if (live) {
        // state-update adjoint of key p: C*' gets e^{s_p - M'} k_p v_p^T
        const float w = expf(sp - m_new);
        float vdc[DH];
        float ds_state = 0.0f;
#pragma unroll
        for (int i = 0; i < DH; ++i) {
          float acc = 0.0f;
#pragma unroll
          for (int j = 0; j < DH; ++j) acc = fmaf(vp[j], dc_s[i][j], acc);
          vdc[i] = acc;
          ds_state = fmaf(kp[i], acc + dn_s[i], ds_state);
        }
        float* dk_row = dk + off + static_cast<size_t>(p) * DH;
        float* dv_row = dv + off + static_cast<size_t>(p) * DH;
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          if ((d >= DH / 2) != (half == 1)) continue;
          float kdc = 0.0f;
#pragma unroll
          for (int i = 0; i < DH; ++i) kdc = fmaf(kp[i], dc_s[i][d], kdc);
          dk_row[d] = fmaf(w, vdc[d] + dn_s[d], dkp[d]);
          dv_row[d] = fmaf(w, kdc, dvp[d]);
        }
        if (half == 0) ds[goff + p] = fmaf(w, ds_state, dsp);
      }
    }

    // ---- 3. the readout's state adjoints and the carry update
    float dc_read = 0.0f, dn_read = 0.0f, dm_dec_part = 0.0f;
    if (tid < DH * DH) {
      const int i = tid / DH, j = tid % DH;
      for (int t = 0; t < chunk; ++t) dc_read = fmaf(q_s[t][i] * inter_s[t], g_s[t][j], dc_read);
      dm_dec_part = dc_s[i][j] * c_s[i][j];
    }
    if (tid < DH) {
      for (int t = 0; t < chunk; ++t) dn_read = fmaf(inter_s[t] * drow_s[t], q_s[t][tid], dn_read);
      dm_dec_part = fmaf(dn_s[tid], n_s[tid], dm_dec_part);
    }
    // the barriers in block_sum also order every read of dc_s / dn_s above
    // before the update below
    const float dm_read = block_sum(dm_read_part, red_s);
    const float dm_dec = e_dec * block_sum(dm_dec_part, red_s);
    if (tid < DH * DH) {
      const int i = tid / DH, j = tid % DH;
      dc_s[i][j] = fmaf(e_dec, dc_s[i][j], dc_read);
    }
    if (tid < DH) dn_s[tid] = fmaf(e_dec, dn_s[tid], dn_read);
    dm = dm_dec + dm_read;
    __syncthreads();  // the carry and the tiles are ready for the next chunk
  }
}

}  // namespace

// q, k, v, g, dq, dk, dv: (bh, seq_len, dh) fp32; a, s, cm, ds, dax:
// (bh, seq_len) fp32; cent (bh, seq_len / chunk, dh, dh), nent
// (bh, seq_len / chunk, dh), ment (bh, seq_len / chunk) fp32 from
// mlstm_fwd_states_launch; all contiguous, seq_len a multiple of chunk.
// Launches on `stream` of `device` and returns the cudaError_t of the
// launch (0 on success).
extern "C" int mlstm_bwd_launch(const float* q, const float* k, const float* v,
                                const float* g, const float* a, const float* s,
                                const float* cm, const float* cent, const float* nent,
                                const float* ment, float* dq, float* dk, float* dv,
                                float* ds, float* dax, int bh, int seq_len, int chunk,
                                int dh, float eps, int device, void* stream) {
  if (bh <= 0 || chunk <= 0 || chunk > kMaxChunk || seq_len % chunk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 8:
      mlstm_bwd_kernel<8><<<bh, kThreads, 0, st>>>(q, k, v, g, a, s, cm, cent, nent,
                                                   ment, dq, dk, dv, ds, dax, seq_len,
                                                   chunk, eps);
      break;
    case 16:
      mlstm_bwd_kernel<16><<<bh, kThreads, 0, st>>>(q, k, v, g, a, s, cm, cent, nent,
                                                    ment, dq, dk, dv, ds, dax, seq_len,
                                                    chunk, eps);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mlstm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
