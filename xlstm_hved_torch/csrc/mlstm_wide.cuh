// Chunkwise mLSTM at head widths 17 to 512 (DP, a multiple of 32): the
// pieces that mlstm_fwd.cu and mlstm_bwd.cu share (Hopper, sm_90a).
//
// The narrow kernels keep a row's whole head (DH <= 16) in a thread; at the
// ViL widths (DH 32 to 512) a row is too wide for that, and the chunk's
// L x L work (q.k^T, attn.v and the backward's transposes) and its DP x DP
// work (q.C*, k^T v and the state adjoints) are products of tiles. This
// header holds:
//  - the block product: 256 threads, a block tile of BM (64 or 32) rows x
//    128 columns cut into eight warp tiles of 32 x 32 (BM 64) or 32 x 16
//    (BM 32); each thread holds a register tile of 4 x 8 or 4 x 4
//    accumulators (the m16n8 fragment layout) and feeds it from shared
//    memory with 16-byte loads along k where k is contiguous;
//  - the copies: every operand tile comes in as 16-byte cp.async copies
//    into a two-stage ring, the next k-chunk's copy overlapping the current
//    chunk's products; rows past the chunk's true length and columns past
//    DP are zero-filled, never read;
//  - row_scores, the causal scores of one row tile with their decays, row
//    sums and denominators. The forward readout and the backward's first
//    row launch both call it on the same row tiling (the wrapper plans one
//    row tile for both), so the backward recomputes bit for bit the row sums
//    the forward formed and differentiates the branch
//    (|rowsum| >= e^{-m} or not) that the forward took. Each row's sum runs
//    in one fixed order (per thread, then the quad's shuffles, then the
//    warps in order): no atomics, deterministic;
//  - wide_outer_kernel, a DP x DP sum of outer products over the chunk's
//    rows as 64 x 128 tiles (the chunk's local state, the backward's
//    readout adjoint).
//
// Grids are row-tiled, causal and bounded by true lengths: a row-tile block
// loads keys 0 .. t0 + TM - 1 only and skips every warp tile above the
// diagonal; a key-tile block walks the rows at and below its keys only; the
// last chunk's rows past the true sequence length (padding) are written as
// zeros and take part in no product. Where the (head, chunk, row tile)
// blocks do not fill the card, the wrapper splits each tile's value columns
// over blocks (ops/mlstm_cuda.py::wide_plan); each split recomputes its
// tile's scores.
//
// Products: IEEE fp32 FMAs. The same tiles as split-precision TF32
// tensor-core MMAs (3xTF32: a = a_big + a_small with a_big = tf32(a),
// a_small = tf32(a - a_big), b likewise, summed as a_small b_big + a_big
// b_small + a_big b_big with fp32 accumulation) broke chip_smoke.py's
// absolute bound on h at DH 512 (max|d| 5.131e-4 against 5e-4; PERF.md).
//
// What bounds it (an H100 80GB HBM3 at 700 W, PERF.md): not the fp32 rate.
// At S 4096 (DH 96, 128) the forward runs at 3.7-5x its fp32 operations
// bound and the backward at 4.8-7x: the blocks hold 8-16 warps an SM (the
// accumulators and two 256-thread blocks' shared memory fill the register
// file and most of the 227 KB), so each k-chunk's copy, barrier and
// shared-memory loads are exposed latency; the backward recomputes the
// scores twice and g.v^T twice (no atomics: dq and dk, dv come from
// separate row-tile and key-tile launches). At S 196-512 the launches are
// few and short: seven backward and three forward launches of a few
// microseconds each, and grids of one or two waves. Zero columns of q, k, v
// (DH zero-padded to DP) are exact, and the scale 1/sqrt(DH) is the true
// DH's.
#pragma once

#include <cuda_runtime.h>

namespace mlstm_wide {

constexpr int kTile = 32;              // DP granularity, the depth of one staged k-chunk
constexpr int kMaxChunk = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWideMaxDh = 512;
constexpr int kBN = 128;               // columns of a block tile
constexpr int kLdK = kTile + 4;        // [rows][32] stage, k contiguous
constexpr int kLdN = kBN + 8;          // [32][128] stage, n contiguous
constexpr int kLdS = kMaxChunk + 4;    // [rows][128] slab of scores (row-major A)
constexpr int kMaxDevices = 64;

// ---- copies

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// rows x cols floats (cols a multiple of 4) from src (row stride sld floats,
// 16-byte aligned) into dst (row stride ld); rows at or past valid_rows and
// columns at or past valid_cols are zero-filled without a read.
__device__ __forceinline__ void stage(float* dst, int ld, const float* src, size_t sld, int rows,
                                      int cols, int valid_rows, int valid_cols) {
  const int per_row = cols >> 2;
  for (int e = threadIdx.x; e < rows * per_row; e += kThreads) {
    const int r = e / per_row, c = (e - r * per_row) << 2;
    const bool ok = r < valid_rows && c < valid_cols;
    cp_async16(dst + r * ld + c, ok ? src + r * sld + c : src, ok);
  }
}

// n k-chunks through a two-stage ring of stage_floats each: load(i, buf)
// issues chunk i's copies, compute(i, buf) uses them; chunk i + 1 is in
// flight while chunk i is computed. n is the same for the whole block.
template <class Load, class Compute>
__device__ __forceinline__ void pipeline(int n, float* ring, int stage_floats, Load&& load,
                                         Compute&& compute) {
  if (n <= 0) return;
  load(0, ring);
  cp_async_commit();
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) load(i + 1, ring + ((i + 1) & 1) * stage_floats);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    compute(i, ring + (i & 1) * stage_floats);
    __syncthreads();
  }
}

// ---- the block product

template <int BM>
struct Tiling;
template <>
struct Tiling<64> {
  static constexpr int kWarpsN = 4, kNT = 4;
};
template <>
struct Tiling<32> {
  static constexpr int kWarpsN = 8, kNT = 2;
};

// One thread's accumulators of a BM x 128 block tile: warp tile 32 x (8 kNT),
// element (mi, ni, r) at row row0 + 16 mi + g + 8 (r >> 1), column
// col0 + 8 ni + 2 tig + (r & 1) (g = lane / 4, tig = lane % 4: the m16n8
// accumulator layout, so that a quad of lanes shares its rows).
template <int BM>
struct Acc {
  static constexpr int kMT = 2, kNT = Tiling<BM>::kNT, kWarpsN = Tiling<BM>::kWarpsN;
  static constexpr int kWN = 8 * kNT;
  float c[kMT][kNT][4];
  int row0, col0, g, tig;

  __device__ __forceinline__ Acc() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    row0 = (warp / kWarpsN) * 32;
    col0 = (warp % kWarpsN) * kWN;
    g = lane >> 2;
    tig = lane & 3;
    zero();
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) c[mi][ni][r] = 0.0f;
  }
  __device__ __forceinline__ int row(int mi, int r) const {
    return row0 + 16 * mi + g + 8 * (r >> 1);
  }
  __device__ __forceinline__ int col(int ni, int r) const {
    return col0 + 8 * ni + 2 * tig + (r & 1);
  }
};

enum class Major { kRow, kCol };

// Element (i, j) of a matrix in shared memory stored with its first index
// major (kRow: p[i * ld + j]) or its second (kCol: p[j * ld + i]).
template <Major M>
__device__ __forceinline__ float at(const float* p, int ld, int i, int j) {
  return M == Major::kRow ? p[i * ld + j] : p[j * ld + i];
}

// acc += A B over `ksteps` steps of 8 in k, for this warp's tile: A(m, k) =
// at<MA>(a, lda, acc.row0 + m, ka + k), B(k, n) = at<MB>(b, ldb, kb + k,
// acc.col0 + n), k ascending, so every product is deterministic. Four k at
// a time: 16-byte loads along k where k is contiguous (a row-major A, a
// [n][k] B), 8-byte pairs of columns of a [k][n] B.
template <Major MA, Major MB, int BM>
__device__ __forceinline__ void warp_product(Acc<BM>& acc, const float* a, int lda, int ka,
                                             const float* b, int ldb, int kb, int ksteps) {
  constexpr int kMT = Acc<BM>::kMT, kNT = Acc<BM>::kNT;
  const int g = acc.g, tig = acc.tig, m0 = acc.row0, n0 = acc.col0;
  for (int ks = 0; ks < ksteps; ++ks) {
#pragma unroll
    for (int k4 = 8 * ks; k4 < 8 * ks + 8; k4 += 4) {
      float av[kMT][2][4], bv[kNT][2][4];
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + 16 * mi + g + 8 * h, k = ka + k4;
          if constexpr (MA == Major::kRow) {
            const float4 x = *reinterpret_cast<const float4*>(a + m * lda + k);
            av[mi][h][0] = x.x, av[mi][h][1] = x.y, av[mi][h][2] = x.z, av[mi][h][3] = x.w;
          } else {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) av[mi][h][kk] = a[(k + kk) * lda + m];
          }
        }
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) {
        const int n = n0 + 8 * ni + 2 * tig, k = kb + k4;
        if constexpr (MB == Major::kCol) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 x = *reinterpret_cast<const float4*>(b + (n + h) * ldb + k);
            bv[ni][h][0] = x.x, bv[ni][h][1] = x.y, bv[ni][h][2] = x.z, bv[ni][h][3] = x.w;
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float2 x = *reinterpret_cast<const float2*>(b + (k + kk) * ldb + n);
            bv[ni][0][kk] = x.x, bv[ni][1][kk] = x.y;
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
          for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              acc.c[mi][ni][r] = fmaf(av[mi][r >> 1][kk], bv[ni][r & 1][kk], acc.c[mi][ni][r]);
    }
  }
}

// Steps of 8 in the k-chunk [k0, k0 + 32) that reach keys at or below
// `last` (a causal row's last key): 0 to 4.
__device__ __forceinline__ int causal_steps(int k0, int last) {
  return max(0, min(4, (last - k0 + 8) >> 3));
}

// The sum over each block-tile row of the threads' partials part[mi][h]
// (rows acc.row(mi, 2h)): per thread, then the quad's two shuffles, then the
// warps along the row in order through red (kWarpsN x BM floats). Thread
// tid < BM gets row tid's sum. Every thread must call it; two barriers.
template <int BM>
__device__ __forceinline__ float row_reduce(const Acc<BM>& acc, float (&part)[2][2], float* red) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x = part[mi][h];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if (acc.tig == 0) red[(acc.col0 / Acc<BM>::kWN) * BM + acc.row(mi, 2 * h)] = x;
    }
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x < BM) {
    for (int w = 0; w < Acc<BM>::kWarpsN; ++w) total += red[w * BM + threadIdx.x];
  }
  __syncthreads();
  return total;
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

// ---- the row-tile kernels' shared memory and block coordinates

// A block of a row-tiled grid: blockIdx.x = (head * nchunks + chunk) *
// tiles + tile, tiles = ceil(chunk / TM). cidx indexes (head, chunk); rows
// t0 .. t0 + tm - 1 of the chunk, of which the first `live` are true rows
// (the last chunk ends at the true sequence length: rows_last rows).
struct TileCoords {
  size_t cidx;
  int t0, tm, live, rows;
};

template <int TM>
__device__ __forceinline__ TileCoords tile_coords(int nchunks, int chunk, int rows_last) {
  const int tiles = (chunk + TM - 1) / TM;
  TileCoords c;
  c.cidx = blockIdx.x / tiles;
  c.t0 = (blockIdx.x % tiles) * TM;
  c.rows = static_cast<int>(c.cidx % nchunks) == nchunks - 1 ? rows_last : chunk;
  c.tm = min(TM, chunk - c.t0);
  c.live = max(0, min(TM, c.rows - c.t0));
  return c;
}

// Columns [begin, end) of value-column group blockIdx.y of gridDim.y: the
// DP / 32 column units shared out ceil(units / groups) to a group.
struct ColumnGroup {
  int begin, end;
};
__device__ __forceinline__ ColumnGroup column_group(int dp) {
  const int units = dp / kTile;
  const int per = (units + gridDim.y - 1) / gridDim.y;
  const int begin = min(dp, static_cast<int>(blockIdx.y) * per * kTile);
  return {begin, min(dp, begin + per * kTile)};
}

// Dynamic shared memory of a row-tile kernel (readout, backward rows).
template <int TM>
struct RowSmem {
  static constexpr int kStage = (TM + kMaxChunk) * kLdK;  // the largest k-chunk of any product
  static constexpr int kFloats = 2 * kStage + TM * kLdS + kWideMaxDh + kMaxChunk + 8 * TM +
                                 Tiling<TM>::kWarpsN * TM;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
  float* ring;    // 2 x kStage
  float* p;       // [TM][kLdS]: attn, then (backward) dqk
  float* vec;     // [kWideMaxDh]: n*
  float* skey;    // [kMaxChunk]: s of the keys
  float* mrow;    // [TM]: M_t = max(cm_t, m*)
  float* inter;   // [TM]: e^{m* - M_t}
  float* rowsum;  // [TM]
  float* denom;   // [TM]
  float* qn;      // [TM]: q_t.n* / sqrt(DH)
  float* eneg;    // [TM]: e^{-max(a_t + M_t, -60)}
  float* drow;    // [TM]: (backward) d rowsum_t
  float* spare;   // [TM]
  float* red;     // [kWarpsN][TM]

  __device__ __forceinline__ explicit RowSmem(float* base) {
    ring = base;
    p = ring + 2 * kStage;
    vec = p + TM * kLdS;
    skey = vec + kWideMaxDh;
    mrow = skey + kMaxChunk;
    inter = mrow + TM;
    rowsum = inter + TM;
    denom = rowsum + TM;
    qn = denom + TM;
    eneg = qn + TM;
    drow = eneg + TM;
    spare = drow + TM;
    red = spare + TM;
  }
};

// Is this warp's tile of a row tile's causal scores (rows t0 + row0 .. +31,
// keys col0 .. col0 + kWN - 1) empty: past the true rows, past the keys, or
// wholly above the diagonal?
template <int TM>
__device__ __forceinline__ bool scores_idle(const Acc<TM>& acc, const TileCoords& tc, int nk) {
  const int last = tc.t0 + min(acc.row0 + 31, tc.live - 1);
  return acc.row0 >= tc.live || acc.col0 >= nk || acc.col0 > last;
}

// The causal scores of rows t0 .. t0 + TM - 1 of chunk cidx over keys
// 0 .. nk - 1 (nk = min(t0 + TM, rows)), into sm.p:
//   attn[t][j] = (q_t.k_j / sqrt(DH)) e^{s_j - M_t} for j <= t < rows, else 0,
// and per true row t, into sm: M_t, inter = e^{m* - M_t}, qn = q_t.n* /
// sqrt(DH), rowsum = sum_j attn[t][j] + inter qn, e^{-max(a_t + M_t, -60)}
// and the denominator max(|rowsum|, e^{-..}) + eps. The forward readout and
// the backward's rows kernel call this with the same TM: the same products
// in the same order, the same row sums, the same branch.
template <int TM>
__device__ void row_scores(const RowSmem<TM>& sm, const TileCoords& tc, const float* __restrict__ q,
                           const float* __restrict__ k, const float* __restrict__ a,
                           const float* __restrict__ s, const float* __restrict__ cm,
                           const float* __restrict__ nent, const float* __restrict__ ment,
                           int chunk, int dp, float scale, float eps) {
  constexpr int kStage = RowSmem<TM>::kStage;
  const int tid = threadIdx.x;
  const size_t goff = tc.cidx * chunk;
  const float m_in = ment[tc.cidx];
  const int nk = min(tc.t0 + TM, tc.rows);
  for (int i = tid; i < dp; i += kThreads) sm.vec[i] = nent[tc.cidx * dp + i];
  for (int i = tid; i < nk; i += kThreads) sm.skey[i] = s[goff + i];
  for (int i = tid; i < tc.live; i += kThreads) sm.mrow[i] = fmaxf(cm[goff + tc.t0 + i], m_in);

  Acc<TM> acc;
  const bool idle = scores_idle(acc, tc, nk);
  const float* qrow = q + (goff + tc.t0) * dp;
  const float* krow = k + goff * dp;
  const int krows = (nk + kTile - 1) / kTile * kTile;
  float qn = 0.0f;
  pipeline(
      dp / kTile, sm.ring, kStage,
      [&](int i, float* buf) {
        stage(buf, kLdK, qrow + i * kTile, dp, TM, kTile, tc.live, kTile);
        stage(buf + TM * kLdK, kLdK, krow + i * kTile, dp, krows, kTile, nk, kTile);
      },
      [&](int i, float* buf) {
        if (!idle) {
          warp_product<Major::kRow, Major::kCol>(acc, buf, kLdK, 0, buf + TM * kLdK, kLdK, 0, 4);
        }
        if (tid < tc.live) {
          for (int d = 0; d < kTile; ++d) qn = fmaf(buf[tid * kLdK + d], sm.vec[i * kTile + d], qn);
        }
      });

  float part[2][2] = {};
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < Acc<TM>::kNT; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = acc.row(mi, r), col = acc.col(ni, r);
        float val = 0.0f;
        if (row < tc.live && col <= tc.t0 + row) {
          val = __fmul_rn(__fmul_rn(acc.c[mi][ni][r], scale), expf(sm.skey[col] - sm.mrow[row]));
        }
        sm.p[row * kLdS + col] = val;
        part[mi][r >> 1] = __fadd_rn(part[mi][r >> 1], val);
      }
  const float sum = row_reduce(acc, part, sm.red);
  if (tid < tc.live) {
    const float m_row = sm.mrow[tid];
    const float inter = expf(m_in - m_row);
    const float qn_s = __fmul_rn(qn, scale);
    const float rowsum = fmaf(inter, qn_s, sum);
    const float e_neg = expf(-fmaxf(__fadd_rn(a[goff + tc.t0 + tid], m_row), -60.0f));
    sm.inter[tid] = inter;
    sm.qn[tid] = qn_s;
    sm.rowsum[tid] = rowsum;
    sm.eneg[tid] = e_neg;
    sm.denom[tid] = __fadd_rn(fmaxf(fabsf(rowsum), e_neg), eps);
  }
  __syncthreads();
}

// ---- DP x DP sums of outer products over a chunk's rows

enum class Outer { kChunkState, kReadAdjoint };

// out[i][j] = sum_p (A[p][i] alpha_p) (B[p][j] / beta_p) and vec[i] =
// sum_p A[p][i] alpha_p gamma_p, over the chunk's true rows p in order, as
// 64 x 128 tiles: grid (bh * nchunks, ceil(dp / 64), ceil(dp / 128)),
// OuterSmem::kBytes of dynamic shared memory.
//  kChunkState:  A = k, B = v, alpha = e^{s_p - cm_{L-1}}, beta = gamma = 1:
//                the chunk's local state K_c, n_c (mlstm_fwd.cu, launch 1);
//  kReadAdjoint: A = q, B = g, alpha = e^{m* - M_t} / sqrt(DH), beta =
//                denom_t, gamma = d rowsum_t: the readout's adjoints
//                dC_read, dn_read of the entry state (mlstm_bwd.cu).
struct OuterSmem {
  static constexpr int kRows = 64;               // rows i of a tile
  static constexpr int kLdA = kRows + 8;         // [32 p][64 i] stage, read as a column-major A
  static constexpr int kStage = kTile * kLdA + kTile * kLdN;
  static constexpr size_t kBytes = sizeof(float) * (2 * kStage + 3 * kMaxChunk);
};

template <Outer kMode>
__global__ void __launch_bounds__(kThreads, 2)
wide_outer_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  const float* __restrict__ s, const float* __restrict__ cm,
                  const float* __restrict__ ment, const float* __restrict__ denom,
                  const float* __restrict__ drow, float* __restrict__ out,
                  float* __restrict__ vec, int nchunks, int chunk, int rows_last, int dp,
                  float scale) {
  constexpr int kLdA = OuterSmem::kLdA, kStage = OuterSmem::kStage;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* alpha_s = smem + 2 * kStage;
  float* beta_s = alpha_s + kMaxChunk;
  float* gamma_s = beta_s + kMaxChunk;

  const int tid = threadIdx.x;
  const size_t cidx = blockIdx.x;
  const size_t goff = cidx * chunk;
  const int rows = static_cast<int>(cidx % nchunks) == nchunks - 1 ? rows_last : chunk;
  const int i0 = blockIdx.y * OuterSmem::kRows, j0 = blockIdx.z * kBN;
  const int nrows = min(OuterSmem::kRows, dp - i0), ncols = min(kBN, dp - j0);
  for (int p = tid; p < rows; p += kThreads) {
    if (kMode == Outer::kChunkState) {
      alpha_s[p] = expf(s[goff + p] - cm[goff + chunk - 1]);
      beta_s[p] = 1.0f;
      gamma_s[p] = 1.0f;
    } else {
      const float m_in = ment[cidx];
      alpha_s[p] = scale * expf(m_in - fmaxf(cm[goff + p], m_in));
      beta_s[p] = denom[goff + p];
      gamma_s[p] = drow[goff + p];
    }
  }

  Acc<64> acc;
  const bool idle = acc.row0 >= nrows || acc.col0 >= ncols;
  float v = 0.0f;
  pipeline(
      (rows + kTile - 1) / kTile, ring, kStage,
      [&](int i, float* buf) {
        const size_t row = goff + static_cast<size_t>(i) * kTile;
        stage(buf, kLdA, A + row * dp + i0, dp, kTile, OuterSmem::kRows, rows - i * kTile, nrows);
        stage(buf + kTile * kLdA, kLdN, B + row * dp + j0, dp, kTile, kBN, rows - i * kTile,
              ncols);
      },
      [&](int i, float* buf) {
        float* b_s = buf + kTile * kLdA;
        const int live = min(kTile, rows - i * kTile);
        for (int e = tid; e < live * OuterSmem::kRows; e += kThreads) {
          const int p = e / OuterSmem::kRows;
          buf[p * kLdA + e % OuterSmem::kRows] *= alpha_s[i * kTile + p];
        }
        if (kMode == Outer::kReadAdjoint) {
          for (int e = tid; e < live * kBN; e += kThreads) {
            const int p = e / kBN;
            b_s[p * kLdN + e % kBN] /= beta_s[i * kTile + p];
          }
        }
        __syncthreads();
        if (blockIdx.z == 0 && tid < nrows) {
          for (int p = 0; p < live; ++p) v = fmaf(buf[p * kLdA + tid], gamma_s[i * kTile + p], v);
        }
        if (!idle) warp_product<Major::kCol, Major::kRow>(acc, buf, kLdA, 0, b_s, kLdN, 0, 4);
      });

  float* o = out + cidx * dp * dp;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < Acc<64>::kNT; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = acc.row(mi, r), col = acc.col(ni, r);
        if (row < nrows && col < ncols) {
          o[static_cast<size_t>(i0 + row) * dp + j0 + col] = acc.c[mi][ni][r];
        }
      }
  if (blockIdx.z == 0 && tid < nrows) vec[cidx * dp + i0 + tid] = v;
}

// Raise a kernel's dynamic shared memory limit once per device: the
// attribute sticks to the function, so later calls skip it.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, int device, bool (&done)[kMaxDevices]) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
  if (err == cudaSuccess) done[device] = true;
  return err;
}

// Launch wide_outer_kernel<kMode> over bh * nchunks chunks.
template <Outer kMode>
cudaError_t launch_outer(const float* A, const float* B, const float* s, const float* cm,
                         const float* ment, const float* denom, const float* drow, float* out,
                         float* vec, int bh, int nchunks, int chunk, int rows_last, int dp,
                         float scale, int device, cudaStream_t st) {
  static bool smem_set[kMaxDevices] = {};
  cudaError_t err = allow_smem(wide_outer_kernel<kMode>, OuterSmem::kBytes, device, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(bh) * nchunks,
                  (dp + OuterSmem::kRows - 1) / OuterSmem::kRows, (dp + kBN - 1) / kBN);
  wide_outer_kernel<kMode><<<grid, kThreads, OuterSmem::kBytes, st>>>(
      A, B, s, cm, ment, denom, drow, out, vec, nchunks, chunk, rows_last, dp, scale);
  return cudaGetLastError();
}

}  // namespace mlstm_wide
