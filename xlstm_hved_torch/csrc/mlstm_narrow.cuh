// Chunkwise mLSTM at head widths 8 and 16 (DH <= 16 zero-padded to them):
// the pieces that mlstm_fwd.cu and mlstm_bwd.cu share (Hopper, sm_90a).
//
// A row's whole head fits in a thread's registers, so the chunk's L x L work
// is walked row by row (in the backward's columns, key by key) rather than
// tiled. This header holds:
//  - the balanced causal walk (slot). A block of 256 threads serves one
//    (head, chunk); eight lanes share a group of four rows, the long rows
//    L-1-2p, L-2-2p and the short rows 2p+1, 2p, as two slots of two
//    adjacent rows. A lane takes every eighth key of a slot (the positions
//    running on from the long slot into the short one), the same keys for
//    both rows of the slot, so the forward reads each key once for two rows
//    and no lane takes more than 2 ceil((L + 2) / 8) (row, key) pairs;
//    ops/mlstm_cuda.py::narrow_plan spells out the same assignment. The
//    backward's columns walk the same slots mirrored (keys L-1-hi and L-hi
//    over the rows at and below them);
//  - score, readout_slot, row_grad_pass and row_denominator: every causal
//    score of the forward readout and of the backward's rows kernel goes
//    through `score` on the same lanes in the same order, so the backward
//    forms bit for bit the row sums the forward formed and differentiates
//    the branch (|rowsum| >= e^{-m} or not) the forward took. Every add and
//    product outside an explicit fmaf is a __fadd_rn / __fmul_rn, which the
//    compiler cannot contract into an FMA differently in the two kernels;
//  - the lanes' sums in a fixed order: group_sum (every lane gets the total)
//    and group_scatter (lane u gets the total of its DH / 8 columns);
//  - outer_sum, a DH x DH sum of outer products over the chunk's rows as
//    2 x 2 register tiles, the rows split over groups of threads and the
//    groups' parts summed in group order (the chunk's local state, the
//    backward's readout adjoint);
//  - stage_rows: a chunk's rows of q, k, v or g as 16-byte cp.async copies
//    into shared memory, rows padded to DH + 4 floats;
//  - the carry scan over the chunks of a head: one warp per 32 elements of
//    the state; per segment of kScanSeg chunks, all of the segment's inputs
//    requested at once as cp.async copies and the per-chunk factors formed
//    in shared memory while they land, so that the chain over the chunks is
//    one fmaf a chunk, its stores kept off the chain;
//  - programmatic dependent launch (launch_dependent, griddep_wait).
// No atomics: every sum runs in one block in a fixed order.
#pragma once

#include <cuda_runtime.h>

#include "mlstm_wide.cuh"

namespace mlstm_narrow {

constexpr int kMaxChunk = 128;
constexpr int kSplit = 8;         // lanes sharing a group of four rows
constexpr int kThreads = kMaxChunk / 4 * kSplit;
constexpr int kScanSeg = 256;     // chunks a scan block holds at once (inputs and factors)
constexpr int kScanGroups = 4;    // cp.async groups a segment's inputs arrive in

template <int DH>
struct Width {
  static_assert(DH == 8 || DH == 16, "the narrow kernels take DH 8 and 16");
  static constexpr int kLd = DH + 4;         // padded row stride in shared memory
  static constexpr int kCols = DH / kSplit;  // columns a lane of the group owns
};

// Programmatic dependent launch: a kernel launched with launch_dependent
// may start while the kernel before it on the stream still runs; it does
// what needs nothing of that kernel (loads of the call's inputs), then
// waits in griddep_wait until that kernel has finished and its writes are
// visible. griddep_launch_dependents lets the next such kernel start early.
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Launch kernel<<<grid, block, 0, st>>>(args...) as a programmatic
// dependent of the kernel before it on st (see griddep_wait).
template <class... Params, class... Args>
inline cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block,
                                    cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows x DH floats from src (contiguous rows, 16-byte aligned) into dst (row
// stride DH + 4), as 16-byte cp.async copies; the caller commits and waits.
template <int DH>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int rows) {
  constexpr int kPer = DH / 4;
  for (int e = threadIdx.x; e < rows * kPer; e += kThreads) {
    const int r = e / kPer, c = (e - r * kPer) * 4;
    mlstm_wide::cp_async16(dst + r * Width<DH>::kLd + c, src + r * DH + c, true);
  }
}

// x[r][d] = x[r][d] op y (op: multiply by y, or divide by y_r) for the
// chunk's rows, in place; between two barriers of the caller.
template <int DH>
__device__ __forceinline__ void scale_rows(float* x, int rows, float y) {
  for (int e = threadIdx.x; e < rows * DH; e += kThreads) {
    float& at = x[(e / DH) * Width<DH>::kLd + e % DH];
    at = __fmul_rn(at, y);
  }
}
template <int DH>
__device__ __forceinline__ void divide_rows(float* x, int rows, const float* by) {
  for (int e = threadIdx.x; e < rows * DH; e += kThreads) {
    float& at = x[(e / DH) * Width<DH>::kLd + e % DH];
    at = __fdiv_rn(at, by[e / DH]);
  }
}

// ---- the balanced causal walk

// Slot s of lane u in row group p (p = threadIdx.x / kSplit) of a chunk of
// L rows, H = L / 2: two adjacent rows hi = lo + 1, the long ones L-1-2p,
// L-2-2p (slot 0, live where >= H) or the short ones 2p+1, 2p (slot 1, live
// where < H), and the first of the lane's keys: a row r takes keys j =
// first, first + kSplit, ... <= r, both rows of a slot the same ones, so
// that the forward reads each key once for both. The positions run on from
// slot 0's L - 2p keys into slot 1's, so every lane of a group gets about
// (L + 2) / kSplit of them. Dead rows read row 0 and walk nothing.
struct Slot {
  int hi, lo, first;
  bool live_hi, live_lo;
};

__device__ __forceinline__ Slot slot(int L, int s) {
  const int p = threadIdx.x / kSplit, u = threadIdx.x % kSplit, H = L / 2;
  Slot w;
  if (s == 0) {
    w.hi = L - 1 - 2 * p;
    w.live_hi = w.hi >= H;
    w.live_lo = w.hi - 1 >= H;
    w.first = u;
  } else {
    w.hi = 2 * p + 1;
    w.live_hi = w.hi < H;
    w.live_lo = w.hi - 1 < H;
    w.first = (u - (L - 2 * p)) & (kSplit - 1);
  }
  w.lo = w.live_lo ? w.hi - 1 : 0;
  if (!w.live_hi) w.hi = 0;
  return w;
}

// x summed over the row group's lanes (xor 1, then 2, ...): every lane gets
// the same bits. All 32 lanes of the warp call it.
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int m = 1; m < kSplit; m <<= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}

// The group's lanes' sum of an N-vector, lane u keeping the u-th block of
// N / kSplit columns: each round (lane masks kSplit / 2, ..., 1) keeps the
// half that the lane's bit selects and adds the partner's; every column is
// summed in one fixed order. All 32 lanes of the warp call it.
template <int N, int M, int F>
__device__ __forceinline__ void scatter_round(const float (&x)[N], float (&out)[F]) {
  const bool hi = threadIdx.x & M;
  float half[N / 2];
#pragma unroll
  for (int c = 0; c < N / 2; ++c) {
    const float keep = hi ? x[N / 2 + c] : x[c];
    const float send = hi ? x[c] : x[N / 2 + c];
    half[c] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, M));
  }
  if constexpr (M == 1) {
#pragma unroll
    for (int c = 0; c < F; ++c) out[c] = half[c];
  } else {
    scatter_round<N / 2, M / 2, F>(half, out);
  }
}

template <int DH>
__device__ __forceinline__ void group_scatter(const float (&x)[DH], float (&out)[DH / kSplit]) {
  scatter_round<DH, kSplit / 2, DH / kSplit>(x, out);
}

// ---- one causal row

// Key j's row of k, v, q or g from shared memory (row stride DH + 4).
template <int DH>
__device__ __forceinline__ void load_row(const float* x_s, int j, float (&x)[DH]) {
#pragma unroll
  for (int d4 = 0; d4 < DH / 4; ++d4) {
    const float4 y = reinterpret_cast<const float4*>(x_s + j * Width<DH>::kLd)[d4];
    x[4 * d4] = y.x, x[4 * d4 + 1] = y.y, x[4 * d4 + 2] = y.z, x[4 * d4 + 3] = y.w;
  }
}

// One causal score of row t: returns att = (q_t.k_j / sqrt(DH)) e^{s_j -
// M_t} (qs: q_t / sqrt(DH)), adds it to the row's sum and sets dec = e^{s_j
// - M_t}. The forward readout and the backward's rows kernel form every
// score here, on the same keys in the same order, so their row sums (and
// denominators, and branches) are the same bits.
template <int DH>
__device__ __forceinline__ float score(const float (&qs)[DH], float m_row, float s_j,
                                       const float (&kj)[DH], float& sum, float& dec) {
  dec = expf(s_j - m_row);
  float qk0 = 0.0f, qk1 = 0.0f;
#pragma unroll
  for (int d = 0; d < DH; d += 2) {
    qk0 = fmaf(qs[d], kj[d], qk0);
    qk1 = fmaf(qs[d + 1], kj[d + 1], qk1);
  }
  const float att = __fmul_rn(__fadd_rn(qk0, qk1), dec);
  sum = __fadd_rn(sum, att);
  return att;
}

// The readout's step: the score, and att v_j added to the numerator.
template <int DH>
__device__ __forceinline__ void score_step(const float (&qs)[DH], float m_row, float s_j,
                                           const float (&kj)[DH], const float (&vj)[DH],
                                           float (&acc)[DH], float& sum) {
  float dec;
  const float att = score<DH>(qs, m_row, s_j, kj, sum, dec);
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = fmaf(att, vj[d], acc[d]);
}

// The backward's pass over row t's keys j = first, + kSplit, ... <= last
// (last = -1 for a dead row): every score as the readout forms it, then
// the lanes' rowsum (the readout's bits); and this lane's parts, not yet
// summed over the lanes, of g_t.num_t's key sum, sum_j att_j (g_t.v_j), and
// of dq's key sums a = sum_j (g_t.v_j) e^{s_j - M_t} k_j and b = sum_j
// e^{s_j - M_t} k_j (g_t the cotangent, not yet over the denominator).
template <int DH>
__device__ __forceinline__ void row_grad_pass(const float (&qs)[DH], const float (&g)[DH],
                                              float m_row, int first, int last, const float* k_s,
                                              const float* v_s, const float* s_s,
                                              float& rowsum, float& g_num, float (&a)[DH],
                                              float (&b)[DH]) {
#pragma unroll
  for (int d = 0; d < DH; ++d) a[d] = b[d] = 0.0f;
  float sum = 0.0f;
  g_num = 0.0f;
#pragma unroll 1
  for (int j = first; j <= last; j += kSplit) {
    float kj[DH], vj[DH], dec;
    load_row<DH>(k_s, j, kj);
    load_row<DH>(v_s, j, vj);
    const float att = score<DH>(qs, m_row, s_s[j], kj, sum, dec);
    float gv = 0.0f;
#pragma unroll
    for (int d = 0; d < DH; ++d) gv = fmaf(g[d], vj[d], gv);
    g_num = fmaf(att, gv, g_num);
    const float ga = __fmul_rn(gv, dec);
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      a[d] = fmaf(ga, kj[d], a[d]);
      b[d] = fmaf(dec, kj[d], b[d]);
    }
  }
  rowsum = group_sum(sum);
}

// Both rows of a slot in one pass over their keys (each key read once for
// the two rows): per row the same scores in the same order as
// row_grad_pass, then the lanes' totals of each: rowsum (every lane) and
// num (lane u its DH/kSplit columns).
template <int DH>
__device__ __forceinline__ void readout_slot(const Slot& w, const float (&qs_hi)[DH],
                                             const float (&qs_lo)[DH], float m_hi, float m_lo,
                                             const float* k_s, const float* v_s,
                                             const float* s_s, float (&num_hi)[DH / kSplit],
                                             float (&num_lo)[DH / kSplit], float& rowsum_hi,
                                             float& rowsum_lo) {
  float acc_hi[DH], acc_lo[DH], kj[DH], vj[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc_hi[d] = acc_lo[d] = 0.0f;
  float sum_hi = 0.0f, sum_lo = 0.0f;
  int j = w.first;
  if (w.live_hi && w.live_lo) {
#pragma unroll 1
    for (; j <= w.lo; j += kSplit) {
      load_row<DH>(k_s, j, kj);
      load_row<DH>(v_s, j, vj);
      score_step<DH>(qs_hi, m_hi, s_s[j], kj, vj, acc_hi, sum_hi);
      score_step<DH>(qs_lo, m_lo, s_s[j], kj, vj, acc_lo, sum_lo);
    }
  }
  if (w.live_hi) {
    for (; j <= w.hi; j += kSplit) {  // past the dual keys, at most one key
      load_row<DH>(k_s, j, kj);
      load_row<DH>(v_s, j, vj);
      score_step<DH>(qs_hi, m_hi, s_s[j], kj, vj, acc_hi, sum_hi);
    }
  } else if (w.live_lo) {
    for (; j <= w.lo; j += kSplit) {
      load_row<DH>(k_s, j, kj);
      load_row<DH>(v_s, j, vj);
      score_step<DH>(qs_lo, m_lo, s_s[j], kj, vj, acc_lo, sum_lo);
    }
  }
  rowsum_hi = group_sum(sum_hi);
  rowsum_lo = group_sum(sum_lo);
  group_scatter<DH>(acc_hi, num_hi);
  group_scatter<DH>(acc_lo, num_lo);
}

// Row t's scalars from its keys' row sum and the chunk's entry state (n*,
// m*): inter = e^{m* - M_t}, qn = q_t.n* / sqrt(DH), rowsum = keys + inter
// qn, e_neg = e^{-max(a_t + M_t, -60)}, denom = max(|rowsum|, e_neg) + eps.
struct RowScalars {
  float inter, qn, rowsum, e_neg, denom;
};

template <int DH>
__device__ __forceinline__ RowScalars row_denominator(const float (&qs)[DH], const float* n_s,
                                                      float m_in, float m_row, float a_t,
                                                      float keys, float eps) {
  RowScalars r;
  r.inter = expf(m_in - m_row);
  float qn = 0.0f;
#pragma unroll
  for (int i = 0; i < DH; ++i) qn = fmaf(qs[i], n_s[i], qn);
  r.qn = qn;
  r.rowsum = fmaf(r.inter, qn, keys);
  r.e_neg = expf(-fmaxf(__fadd_rn(a_t, m_row), -60.0f));
  r.denom = __fadd_rn(fmaxf(fabsf(r.rowsum), r.e_neg), eps);
  return r;
}

// Lane u's first column of a row: its DH/kSplit columns start here.
template <int DH>
__device__ __forceinline__ int first_col() {
  return (threadIdx.x % kSplit) * Width<DH>::kCols;
}

// DH / kSplit consecutive floats from registers to dst (aligned to their size).
template <int DH>
__device__ __forceinline__ void store_cols(float* dst, const float (&x)[DH / kSplit]) {
  if constexpr (DH / kSplit == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (DH / kSplit == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(x[0], x[1]);
  } else {
    dst[0] = x[0];
  }
}

// ---- DH x DH sums of outer products over a chunk's rows

// out[i][j] = sum_p (A[p][i] alpha_p) B[p][j] and vec[i] = sum_p (A[p][i]
// alpha_p) gamma_p (gamma_p = 1 without kGamma), over rows p < rows of A, B
// (row stride DH + 4). Each thread holds a 2 x 2 tile of out over the rows
// p = group, group + groups, ...; the groups' parts go through red
// (kRedFloats) and are summed in group order. Every thread calls it; it
// holds two barriers and writes out and vec to device memory.
template <int DH>
struct Outer {
  static constexpr int kTiles = (DH / 2) * (DH / 2);
  static constexpr int kGroups = kThreads / kTiles < 16 ? kThreads / kTiles : 16;
  static constexpr int kRedFloats = kGroups * (DH * DH + DH);
};

template <int DH, bool kGamma>
__device__ __forceinline__ void outer_sum(const float* A, const float* alpha, const float* B,
                                          const float* gamma, int rows, float* red,
                                          float* __restrict__ out, float* __restrict__ vec) {
  constexpr int kLd = Width<DH>::kLd, kTiles = Outer<DH>::kTiles, kGroups = Outer<DH>::kGroups;
  const int tid = threadIdx.x, tile = tid % kTiles, grp = tid / kTiles;
  const int i0 = 2 * (tile / (DH / 2)), j0 = 2 * (tile % (DH / 2));
  float c00 = 0.0f, c01 = 0.0f, c10 = 0.0f, c11 = 0.0f, v0 = 0.0f, v1 = 0.0f;
  const int last = grp < kGroups ? rows : 0;  // threads past the groups sum nothing
#pragma unroll 4
  for (int p = grp; p < last; p += kGroups) {
    const float al = alpha[p];
    const float2 av = *reinterpret_cast<const float2*>(A + p * kLd + i0);
    const float2 bv = *reinterpret_cast<const float2*>(B + p * kLd + j0);
    const float a0 = __fmul_rn(av.x, al), a1 = __fmul_rn(av.y, al);
    c00 = fmaf(a0, bv.x, c00);
    c01 = fmaf(a0, bv.y, c01);
    c10 = fmaf(a1, bv.x, c10);
    c11 = fmaf(a1, bv.y, c11);
    if constexpr (kGamma) {
      v0 = fmaf(a0, gamma[p], v0);
      v1 = fmaf(a1, gamma[p], v1);
    } else {
      v0 = __fadd_rn(v0, a0);
      v1 = __fadd_rn(v1, a1);
    }
  }
  float* part = red + grp * (DH * DH + DH);
  if (grp < kGroups) {
    part[i0 * DH + j0] = c00;
    part[i0 * DH + j0 + 1] = c01;
    part[(i0 + 1) * DH + j0] = c10;
    part[(i0 + 1) * DH + j0 + 1] = c11;
    if (j0 == 0) {
      part[DH * DH + i0] = v0;
      part[DH * DH + i0 + 1] = v1;
    }
  }
  __syncthreads();
  for (int e = tid; e < DH * DH + DH; e += kThreads) {
    float total = 0.0f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) total = __fadd_rn(total, red[g * (DH * DH + DH) + e]);
    if (e < DH * DH) {
      out[e] = total;
    } else {
      vec[e - DH * DH] = total;
    }
  }
  __syncthreads();
}

// ---- the carry scan

// A scan block is one warp for 32 elements of a head's state: group g <
// DH * DH / 32 holds elements 32 g .. 32 g + 31 of C (the chunk's DH x DH
// block in device memory), the last group the DH elements of n.
template <int DH>
struct ScanGroups {
  static constexpr int kC = DH * DH / 32;
  static constexpr int kGroups = kC + 1;
};

// This warp's elements in chunk `first` of (C rows, n rows): the address of
// the first; `stride` the floats from one chunk's to the next's, `width`
// how many (32, or DH in the n group).
struct GroupRows {
  size_t stride;
  int width;
};
template <int DH, class T>
__device__ __forceinline__ T* group_rows(T* c_rows, T* n_rows, size_t first, GroupRows& gr) {
  const int g = blockIdx.y;
  if (g < ScanGroups<DH>::kC) {
    gr = {static_cast<size_t>(DH) * DH, 32};
    return c_rows + first * DH * DH + 32 * g;
  }
  gr = {static_cast<size_t>(DH), DH};
  return n_rows + first * DH;
}

// The segment's inputs: walk position i of its n chunks (chunk i, or n - 1 -
// i in reverse) lands in seg[i][0..31], this warp's 32 (or DH) elements of
// the chunk as 16-byte cp.async copies, zero past them. They go out all at
// once, at the segment's start, as kScanGroups groups in walk order, so
// that the device's latency is paid once a segment and the chain can start
// on the first group. in0: this warp's elements of the segment's first
// chunk.
template <bool kReverse>
__device__ __forceinline__ void segment_issue(float* seg, int n, const float* in0,
                                              const GroupRows& gr) {
  constexpr int kPer = kScanSeg / kScanGroups;
  for (int grp = 0; grp < kScanGroups; ++grp) {
    const int end = min(n, (grp + 1) * kPer);
    for (int e = grp * kPer * 8 + threadIdx.x; e < end * 8; e += 32) {
      const int i = e / 8, piece = (e % 8) * 4;
      const bool ok = piece < gr.width;
      const int c = kReverse ? n - 1 - i : i;
      mlstm_wide::cp_async16(seg + i * 32 + piece,
                             ok ? in0 + static_cast<size_t>(c) * gr.stride + piece : in0, ok);
    }
    mlstm_wide::cp_async_commit();
  }
}

// Wait until at most `left` of the segment's copy groups are in flight.
__device__ __forceinline__ void wait_groups(int left) {
  switch (left) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
  static_assert(kScanGroups == 4, "one case per group");
}

// The chain over the n chunks of a segment in walk order: at chunk c, store
// state (the chunk's entry, or its incoming carry in reverse) to out0 + c
// stride, then state = fmaf(mul[c], state, scale[c] x_c) (x_c without
// kScaled), x_c this lane's element of the chunk's input. Sixteen chunks
// at a time run as straight-line code, inputs, chain and stores apart, so
// that the chain waits on nothing but its own fmaf. The segment's copies
// (segment_issue) are in flight when it is called; none is after.
template <bool kReverse, bool kScaled>
__device__ __forceinline__ float segment_chain(const float* seg, int n, float* out0,
                                               const GroupRows& gr, const float* mul,
                                               const float* scale, float state) {
  constexpr int kPer = kScanSeg / kScanGroups, kBlock = 16;
  const int lane = threadIdx.x;
  const bool stores = lane < gr.width;
  const auto at = [&](int i) {  // this lane's output of walk position i
    return out0 + static_cast<size_t>(kReverse ? n - 1 - i : i) * gr.stride + lane;
  };
  for (int grp = 0; grp * kPer < n; ++grp) {
    wait_groups(kScanGroups - 1 - grp);
    __syncwarp();  // every lane's copies of the group have landed
    const int end = min(n, (grp + 1) * kPer);
    int i0 = grp * kPer;
    for (; i0 + kBlock <= end; i0 += kBlock) {
      // the block's inputs first, then its chain into registers, then its
      // stores: no fmaf waits for a store to read its operand
      float x[kBlock], m[kBlock], st[kBlock];
#pragma unroll
      for (int k = 0; k < kBlock; ++k) {
        const int c = kReverse ? n - 1 - (i0 + k) : i0 + k;
        x[k] = seg[(i0 + k) * 32 + lane];
        if (kScaled) x[k] = __fmul_rn(scale[c], x[k]);
        m[k] = mul[c];
      }
#pragma unroll
      for (int k = 0; k < kBlock; ++k) {
        st[k] = state;
        state = fmaf(m[k], state, x[k]);
      }
      if (stores) {
#pragma unroll
        for (int k = 0; k < kBlock; ++k) *at(i0 + k) = st[k];
      }
    }
    for (; i0 < end; ++i0) {
      const int c = kReverse ? n - 1 - i0 : i0;
      const float x = seg[i0 * 32 + lane];
      if (stores) *at(i0) = state;
      state = fmaf(mul[c], state, kScaled ? __fmul_rn(scale[c], x) : x);
    }
  }
  cp_async_wait<0>();
  __syncwarp();  // the segment's buffers are free again
  return state;
}

}  // namespace mlstm_narrow
