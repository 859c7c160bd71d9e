// Chunkwise mLSTM forward for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces the Pallas TPU kernels xlstm_hved_tpu/ops/mlstm_pallas.py::
// _mlstm_kernel and _mlstm_states_kernel (both driven by _pallas_forward).
// mlstm_fwd computes the readout h; mlstm_fwd_states (the same body with
// kSave) also stores each chunk's entry state (C*, n*, m*) for the backward
// kernel (mlstm_bwd.cu), before the chunk updates it. m* is stored as the
// kernel carries it, a_{L-1} + max(m*, max s): the same fp32 operations as
// the JAX _m_entry_chain, so the backward needs no separate chain. The
// exact fp32 gate transforms (pad, a = per-chunk cumsum of
// logsigmoid(f), s = i - a, cm = chunk-local cummax of s) stay as torch ops
// in ops/mlstm_cuda.py, as they stayed XLA ops around the Pallas call.
//
// For each (batch, head) the kernel walks the S/L chunks in order, carrying
// the state (C* DH x DH, n* DH, m* scalar) in shared memory and registers.
// Per chunk, row t of the readout is
//   M_t    = max(m*, cm_t)
//   num_t  = sum_{j<=t} e^{s_j - M_t} (q_t.k_j / sqrt(DH)) v_j + e^{m* - M_t} (q_t / sqrt(DH)) C*
//   rowsum = the same with 1 in place of v_j and n* in place of C*
//   h_t    = num_t / (max(|rowsum_t|, e^{-max(a_t + M_t, -60)}) + eps)
// and the state then moves to the end of the chunk with M' = max(m*, max s):
//   C*' = e^{m* - M'} C* + sum_p e^{s_p - M'} k_p v_p^T,  n*' likewise,
//   m*' = a_{L-1} + M'.
// The causal mask is the loop bound j <= t, so masked entries are never
// formed (the log-space mask of the reference, exactly). m* starts at -1e30.
//
// Precision: every product is an IEEE fp32 FMA on the CUDA cores (no TF32,
// no tensor cores), and expf is the full-precision libm call (no fast math):
// the max(|rowsum|, e^{-m}) normaliser amplifies truncated products and
// approximate exponentials into O(1) output error.
//
// What bounds it: the work is small (about 0.1 GFLOP and 4.4 MB of device
// memory traffic for the flagship's 4 heads at S = 4096, a few microseconds
// at the card's peak rates), so this simple design is bound by latency, not
// by the card: one thread block per (batch, head), so the flagship's
// B * NH = 4 heads occupy 4 of the 132 SMs, and each block walks its chunks
// one after another. Two threads share each readout row (they split the
// keys j by parity and combine with one shuffle) to halve the longest
// dependent chain; 256 threads update the 16 x 16 C*. Spreading the chunks
// over SMs (per-chunk states in parallel, then a short pass over chunks)
// is the known next step.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxChunk = 128;
constexpr int kThreads = 256;  // two threads per readout row

template <int DH, bool kSave>
__global__ void __launch_bounds__(kThreads)
mlstm_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ a,
                 const float* __restrict__ s, const float* __restrict__ cm,
                 float* __restrict__ out, float* __restrict__ cent,
                 float* __restrict__ nent, float* __restrict__ ment,
                 int seq_len, int chunk, float eps) {
  __shared__ float q_s[kMaxChunk][DH + 1];  // +1: rows are read per thread
  __shared__ float k_s[kMaxChunk][DH];
  __shared__ float v_s[kMaxChunk][DH];
  __shared__ float a_s[kMaxChunk];
  __shared__ float s_s[kMaxChunk];
  __shared__ float cm_s[kMaxChunk];
  __shared__ float w_s[kMaxChunk];
  __shared__ float c_s[DH][DH];
  __shared__ float n_s[DH];

  const int tid = threadIdx.x;
  const int row = tid >> 1;   // readout row of this thread
  const int half = tid & 1;   // which parity of keys it sums
  const size_t qkv_base = static_cast<size_t>(blockIdx.x) * seq_len * DH;
  const size_t gate_base = static_cast<size_t>(blockIdx.x) * seq_len;
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));

  for (int e = tid; e < DH * DH; e += kThreads) c_s[e / DH][e % DH] = 0.0f;
  for (int e = tid; e < DH; e += kThreads) n_s[e] = 0.0f;
  float m_state = -1e30f;  // every thread carries the same m*

  const int nchunks = seq_len / chunk;
  for (int c = 0; c < nchunks; ++c) {
    const size_t off = qkv_base + static_cast<size_t>(c) * chunk * DH;
    const size_t goff = gate_base + static_cast<size_t>(c) * chunk;
    for (int e = tid; e < chunk * DH; e += kThreads) {
      const int r = e / DH, d = e % DH;
      q_s[r][d] = q[off + e];
      k_s[r][d] = k[off + e];
      v_s[r][d] = v[off + e];
    }
    for (int e = tid; e < chunk; e += kThreads) {
      a_s[e] = a[goff + e];
      s_s[e] = s[goff + e];
      cm_s[e] = cm[goff + e];
    }
    __syncthreads();
    if (kSave) {  // the state this chunk starts from (read-only until the update)
      const size_t sidx = static_cast<size_t>(blockIdx.x) * nchunks + c;
      for (int e = tid; e < DH * DH; e += kThreads) cent[sidx * DH * DH + e] = c_s[e / DH][e % DH];
      for (int e = tid; e < DH; e += kThreads) nent[sidx * DH + e] = n_s[e];
      if (tid == 0) ment[sidx] = m_state;
    }

    // ---- readout: every thread runs this code so that the pair shuffle
    // below sees a full warp; rows past the chunk sum nothing and store
    // nothing.
    const bool live = row < chunk;
    const int t = live ? row : 0;
    float qs[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) qs[d] = q_s[t][d] * scale;
    const float m_row = fmaxf(cm_s[t], m_state);  // M_t

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
      const float denom =
          fmaxf(fabsf(rowsum), expf(-fmaxf(a_s[t] + m_row, -60.0f))) + eps;
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
    __syncthreads();  // every row has read C* and n*

    // ---- state update to the end of the chunk
    const float m_new = fmaxf(m_state, cm_s[chunk - 1]);  // max(m*, max s)
    const float decay_old = expf(m_state - m_new);
    for (int e = tid; e < chunk; e += kThreads) w_s[e] = expf(s_s[e] - m_new);
    __syncthreads();
    for (int e = tid; e < DH * DH; e += kThreads) {
      const int i = e / DH, j = e % DH;
      float acc = 0.0f;
      for (int p = 0; p < chunk; ++p) acc = fmaf(k_s[p][i] * w_s[p], v_s[p][j], acc);
      c_s[i][j] = fmaf(decay_old, c_s[i][j], acc);
    }
    for (int e = tid; e < DH; e += kThreads) {
      float acc = 0.0f;
      for (int p = 0; p < chunk; ++p) acc = fmaf(k_s[p][e], w_s[p], acc);
      n_s[e] = fmaf(decay_old, n_s[e], acc);
    }
    m_state = a_s[chunk - 1] + m_new;
    __syncthreads();  // the state and the tiles are free for the next chunk
  }
}

}  // namespace

template <bool kSave>
static int launch(const float* q, const float* k, const float* v, const float* a,
                  const float* s, const float* cm, float* out, float* cent,
                  float* nent, float* ment, int bh, int seq_len, int chunk, int dh,
                  float eps, int device, void* stream) {
  if (bh <= 0 || chunk <= 0 || chunk > kMaxChunk || seq_len % chunk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 8:
      mlstm_fwd_kernel<8, kSave><<<bh, kThreads, 0, st>>>(
          q, k, v, a, s, cm, out, cent, nent, ment, seq_len, chunk, eps);
      break;
    case 16:
      mlstm_fwd_kernel<16, kSave><<<bh, kThreads, 0, st>>>(
          q, k, v, a, s, cm, out, cent, nent, ment, seq_len, chunk, eps);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// q, k, v, out: (bh, seq_len, dh) fp32, contiguous; a, s, cm: (bh, seq_len)
// fp32, contiguous, seq_len a multiple of chunk. Launches on `stream` of
// `device` and returns the cudaError_t of the launch (0 on success).
extern "C" int mlstm_fwd_launch(const float* q, const float* k, const float* v,
                                const float* a, const float* s, const float* cm,
                                float* out, int bh, int seq_len, int chunk,
                                int dh, float eps, int device, void* stream) {
  return launch<false>(q, k, v, a, s, cm, out, nullptr, nullptr, nullptr, bh,
                       seq_len, chunk, dh, eps, device, stream);
}

// As mlstm_fwd_launch, and also the entry state of every chunk:
// cent (bh, seq_len / chunk, dh, dh), nent (bh, seq_len / chunk, dh) and
// ment (bh, seq_len / chunk), fp32, contiguous.
extern "C" int mlstm_fwd_states_launch(const float* q, const float* k, const float* v,
                                       const float* a, const float* s, const float* cm,
                                       float* out, float* cent, float* nent, float* ment,
                                       int bh, int seq_len, int chunk, int dh, float eps,
                                       int device, void* stream) {
  return launch<true>(q, k, v, a, s, cm, out, cent, nent, ment, bh, seq_len, chunk,
                      dh, eps, device, stream);
}

extern "C" const char* mlstm_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
