// The UxLSTM residual blocks' affine instance norm, fused with the residual
// add and LeakyReLU, forward and backward, for Hopper (sm_90a):
//
//   y = act((x - mean_bc) * rstd_bc * weight_c + bias_c [+ r])
//
// over x of shape (B, C, *spatial), channels first and contiguous, so each
// (b, c) instance is one contiguous run of n = prod(spatial) values. mean
// and rstd are fp32 statistics of the instance (the centred variance, eps
// added under the root); act is LeakyReLU(0.01), the residual blocks' only
// activation; r is an optional residual of x's shape and type; the
// arithmetic is fp32 and y is stored in x's type (bf16 or fp32). weight and
// bias are fp32.
//
// Replaces no Pallas kernel: the JAX package leaves this norm to XLA
// (xlstm_hved_tpu/models/uxlstm.py). It was added because the composed
// PyTorch expression (ten elementwise and reduction kernels, fp32
// intermediates, their autograd backward) took about 185 of the 293 ms of
// device time of a deep-supervised training step of UXlstmEnc 3-D at 128^3,
// batch 2, on an H100.
//
// The bound. Normalisation does a handful of operations a value, far below
// the card's 295 operations a byte: the kernel is bound by bytes. The
// forward reads x twice (statistics, then the apply pass), r once, and
// writes y; the backward reads dy, y and x twice (the per-instance sums,
// then the apply pass) and writes dx (and dr). Statistics and partial sums
// are B C floats a chunk, a small share.
//
// The design. A block of 32 to 256 threads (enough for the instance, at most
// 256) owns a chunk of 16 values a thread: a thread reads them with 16-byte
// loads where the instance's length and the pointers allow it (neighbouring
// threads on neighbouring 16 bytes), else value by value.
// - forward, pass 1 (`stats_kernel`): per chunk, its mean and its sum of
//   squared deviations from that mean, both from registers (two-pass within
//   the chunk), into a table of partials.
// - forward, pass 2 (`apply_kernel`): each block merges its instance's
//   partials with Chan's formula in a fixed order (numerically the two-pass
//   variance of the whole instance), then streams four chunks of x (and r)
//   and writes y; the first block of an instance writes its mean and rstd
//   for the backward.
// - backward, pass 1 (`bwd_reduce_kernel`): per chunk, the sums of dpre and
//   of dpre * xhat, with dpre the gradient before the activation (LeakyReLU's
//   derivative read from the sign of y: y > 0 exactly where its argument is,
//   the slope being positive) and xhat recomputed from x, mean and rstd.
// - backward, pass 2 (`bwd_apply_kernel`): each block sums its instance's
//   partials (A = sum dpre, Bv = sum dpre xhat), then writes
//   dx = weight rstd (dpre - A / n - xhat Bv / n) and dr = dpre; the blocks
//   that own channel c's first chunk in batch item 0 also write
//   dweight_c = sum_b Bv_bc and dbias_c = sum_b A_bc, b in order.
// At 128^3 a block's chunk is 4096 values, 512 chunks an instance; from 16^3
// down one block (from 8^3 down one warp) holds a whole instance.
//
// Determinism. Every sum runs in one fixed order: a thread's values in
// order, a warp's by shuffles down to lane 0, the warps' in order; the
// partials likewise, a thread's chunks in order. No atomics, so runs repeat bit for bit,
// and every block of an instance computes the same statistics.
//
// Each entry point allocates nothing (the caller gives the table of
// partials, `instance_norm_partials` values long) and enqueues its two
// launches on the given stream, without synchronising; it returns the
// first failing launch's cudaError_t, or 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <initializer_list>

namespace {

constexpr int kPer = 16;            // values a thread holds of a chunk
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kApplyChunks = 4;     // chunks an apply block streams
constexpr float kSlope = 0.01f;     // LeakyReLU's negative slope
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float from_float(float v, float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 from_float(float v, __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}

// A thread's values of one chunk: kLoads loads of kN values each; load j
// of thread t starts at base + (j * blockDim.x + t) * kN.
template <typename T, bool kVec>
struct Tile {
  static constexpr int kN = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
  static constexpr int kLoads = kPer / kN;

  __device__ static long long offset(long long base, int j) {
    return base + (static_cast<long long>(j) * blockDim.x + threadIdx.x) * kN;
  }

  // v[i] = p[slot i] in fp32, 0 past n. With kVec, n is a multiple of kN,
  // so a load lies wholly inside or wholly past the instance.
  __device__ static void load(const T* __restrict__ p, long long base, long long n,
                              float (&v)[kPer]) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const long long off = offset(base, j);
      if (off < n) {
        if constexpr (kVec) {
          const uint4 raw = *reinterpret_cast<const uint4*>(p + off);
          const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int k = 0; k < kN; ++k) v[j * kN + k] = to_float(e[k]);
        } else {
          v[j] = to_float(p[off]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kN; ++k) v[j * kN + k] = 0.0f;
      }
    }
  }

  __device__ static void store(T* __restrict__ p, long long base, long long n,
                               const float (&v)[kPer]) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const long long off = offset(base, j);
      if (off < n) {
        if constexpr (kVec) {
          uint4 raw;
          T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
          for (int k = 0; k < kN; ++k) e[k] = from_float(v[j * kN + k], e);
          *reinterpret_cast<uint4*>(p + off) = raw;
        } else {
          p[off] = from_float(v[j], p);
        }
      }
    }
  }

  __device__ static bool valid(long long base, long long n, int i) {
    return offset(base, i / kN) < n;
  }
};

// The sum of v over the block, in a fixed order, in every thread. `red`
// holds kMaxWarps values of shared memory, free again when it returns to
// every thread's next call.
__device__ __forceinline__ float2 block_sum(float2 v, float2* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_down_sync(kFull, v.x, o);
    v.y += __shfl_down_sync(kFull, v.y, o);
  }
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float2 s = make_float2(0.0f, 0.0f);
  const int warps = blockDim.x >> 5;
  for (int w = 0; w < warps; ++w) {
    s.x += red[w].x;
    s.y += red[w].y;
  }
  return s;
}

// Running statistics of a run of values: count, mean, sum of squared
// deviations from the mean.
struct Moments {
  int n;
  float mean, m2;
};

// Chan's merge of b into a (a's values first).
__device__ __forceinline__ void merge(Moments& a, const Moments& b) {
  if (b.n == 0) return;
  const int n = a.n + b.n;
  const float d = b.mean - a.mean;
  const float f = static_cast<float>(b.n) / static_cast<float>(n);
  a.mean += d * f;
  a.m2 += b.m2 + d * d * static_cast<float>(a.n) * f;
  a.n = n;
}

__device__ __forceinline__ int chunk_count(long long n, long long chunk, int k) {
  return static_cast<int>(min(chunk, n - static_cast<long long>(k) * chunk));
}

// The moments of instance `inst` from its `chunks` partials, merged in a
// fixed order: a thread merges chunks t, t + blockDim, ... in order, a warp
// its lanes down to lane 0, then the warps in order. Every thread gets the
// same value. `red` holds kMaxWarps Moments of shared memory.
__device__ Moments merge_partials(const float2* __restrict__ part, int inst, int chunks,
                                  long long n, Moments* red) {
  const long long chunk = static_cast<long long>(blockDim.x) * kPer;
  Moments m{0, 0.0f, 0.0f};
  for (int k = threadIdx.x; k < chunks; k += blockDim.x) {
    const float2 p = part[static_cast<long long>(inst) * chunks + k];
    merge(m, Moments{chunk_count(n, chunk, k), p.x, p.y});
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Moments b;
    b.n = __shfl_down_sync(kFull, m.n, o);
    b.mean = __shfl_down_sync(kFull, m.mean, o);
    b.m2 = __shfl_down_sync(kFull, m.m2, o);
    if ((threadIdx.x & 31) + o < 32) merge(m, b);
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  Moments s{0, 0.0f, 0.0f};
  const int warps = blockDim.x >> 5;
  for (int w = 0; w < warps; ++w) merge(s, red[w]);
  return s;
}

// The (A, Bv) sums of instance `inst` from its partials, in a fixed order
// (as merge_partials).
__device__ float2 sum_partials(const float2* __restrict__ part, int inst, int chunks,
                               float2* red) {
  float2 s = make_float2(0.0f, 0.0f);
  for (int k = threadIdx.x; k < chunks; k += blockDim.x) {
    const float2 p = part[static_cast<long long>(inst) * chunks + k];
    s.x += p.x;
    s.y += p.y;
  }
  return block_sum(s, red);
}

__device__ __forceinline__ float leaky(float t) { return t > 0.0f ? t : t * kSlope; }

// The gradient before LeakyReLU from the one after it and its output y
// (y > 0 exactly where its argument is).
__device__ __forceinline__ float leaky_grad(float dy, float y) {
  return y > 0.0f ? dy : dy * kSlope;
}

// Grid: one block per (instance, chunk), instance-major. part[block] =
// (the chunk's mean, its sum of squared deviations).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
stats_kernel(const T* __restrict__ x, float2* __restrict__ part, long long n, int chunks) {
  __shared__ float2 red[kMaxWarps];
  using Tl = Tile<T, kVec>;
  const int inst = blockIdx.x / chunks;
  const int k = blockIdx.x % chunks;
  const long long chunk = static_cast<long long>(blockDim.x) * kPer;
  const long long base = static_cast<long long>(k) * chunk;
  float v[kPer];
  Tl::load(x + static_cast<long long>(inst) * n, base, n, v);
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) s += v[i];   // zeros past n add nothing
  const float mean = block_sum(make_float2(s, 0.0f), red).x /
                     static_cast<float>(chunk_count(n, chunk, k));
  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const float d = v[i] - mean;
    if (Tl::valid(base, n, i)) q = fmaf(d, d, q);
  }
  const float m2 = block_sum(make_float2(q, 0.0f), red).x;
  if (threadIdx.x == 0) part[blockIdx.x] = make_float2(mean, m2);
}

// Grid: one block per (instance, group of kApplyChunks chunks),
// instance-major.
template <typename T, bool kVec, bool kRes>
__global__ void __launch_bounds__(kMaxThreads)
apply_kernel(const T* __restrict__ x, const T* __restrict__ res,
             const float* __restrict__ weight, const float* __restrict__ bias,
             const float2* __restrict__ part, T* __restrict__ y, float* __restrict__ mean_out,
             float* __restrict__ rstd_out, long long n, int channels, int chunks, int groups,
             float eps) {
  __shared__ Moments red[kMaxWarps];
  using Tl = Tile<T, kVec>;
  const int inst = blockIdx.x / groups;
  const int g = blockIdx.x % groups;
  const Moments m = merge_partials(part, inst, chunks, n, red);
  const float mean = m.mean;
  const float rstd = rsqrtf(m.m2 / static_cast<float>(n) + eps);
  if (g == 0 && threadIdx.x == 0) {
    mean_out[inst] = mean;
    rstd_out[inst] = rstd;
  }
  const int c = inst % channels;
  const float w = weight[c], b = bias[c];
  const long long at = static_cast<long long>(inst) * n;
  const long long chunk = static_cast<long long>(blockDim.x) * kPer;
  for (int a = 0; a < kApplyChunks; ++a) {
    const long long base = (static_cast<long long>(g) * kApplyChunks + a) * chunk;
    if (base >= n) break;
    float v[kPer], r[kPer];
    Tl::load(x + at, base, n, v);
    if constexpr (kRes) Tl::load(res + at, base, n, r);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      float t = fmaf((v[i] - mean) * rstd, w, b);
      if constexpr (kRes) t += r[i];
      v[i] = leaky(t);
    }
    Tl::store(y + at, base, n, v);
  }
}

// Grid: as stats_kernel. part[block] = (sum of dpre, sum of dpre xhat) over
// the chunk.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
bwd_reduce_kernel(const T* __restrict__ dy, const T* __restrict__ y, const T* __restrict__ x,
                  const float* __restrict__ mean, const float* __restrict__ rstd,
                  float2* __restrict__ part, long long n, int chunks) {
  __shared__ float2 red[kMaxWarps];
  using Tl = Tile<T, kVec>;
  const int inst = blockIdx.x / chunks;
  const int k = blockIdx.x % chunks;
  const long long at = static_cast<long long>(inst) * n;
  const long long base = static_cast<long long>(k) * blockDim.x * kPer;
  const float mu = mean[inst], rs = rstd[inst];
  float g[kPer], v[kPer], yv[kPer];
  Tl::load(dy + at, base, n, g);
  Tl::load(x + at, base, n, v);
  Tl::load(y + at, base, n, yv);
  float2 s = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    // past n, dy reads 0: dpre and its products are 0
    const float dp = leaky_grad(g[i], yv[i]);
    s.x += dp;
    s.y = fmaf(dp, (v[i] - mu) * rs, s.y);
  }
  s = block_sum(s, red);
  if (threadIdx.x == 0) part[blockIdx.x] = s;
}

// Grid: as apply_kernel.
template <typename T, bool kVec, bool kRes>
__global__ void __launch_bounds__(kMaxThreads)
bwd_apply_kernel(const T* __restrict__ dy, const T* __restrict__ y, const T* __restrict__ x,
                 const float* __restrict__ weight, const float* __restrict__ mean,
                 const float* __restrict__ rstd, const float2* __restrict__ part,
                 T* __restrict__ dx, T* __restrict__ dres, float* __restrict__ dweight,
                 float* __restrict__ dbias, long long n, int batch, int channels, int chunks,
                 int groups) {
  __shared__ float2 red[kMaxWarps];
  using Tl = Tile<T, kVec>;
  const int inst = blockIdx.x / groups;
  const int g = blockIdx.x % groups;
  const int c = inst % channels;
  const float2 sums = sum_partials(part, inst, chunks, red);
  if (g == 0 && inst < channels) {   // batch item 0: this channel's weight and bias
    float2 total = sums;
    for (int b = 1; b < batch; ++b) {
      const float2 s = sum_partials(part, b * channels + c, chunks, red);
      total.x += s.x;
      total.y += s.y;
    }
    if (threadIdx.x == 0) {
      dbias[c] = total.x;
      dweight[c] = total.y;
    }
  }
  const float mu = mean[inst], rs = rstd[inst];
  const float scale = weight[c] * rs;
  const float a = sums.x / static_cast<float>(n);
  const float bv = sums.y / static_cast<float>(n);
  const long long at = static_cast<long long>(inst) * n;
  const long long chunk = static_cast<long long>(blockDim.x) * kPer;
  for (int j = 0; j < kApplyChunks; ++j) {
    const long long base = (static_cast<long long>(g) * kApplyChunks + j) * chunk;
    if (base >= n) break;
    float gv[kPer], v[kPer], yv[kPer];
    Tl::load(dy + at, base, n, gv);
    Tl::load(x + at, base, n, v);
    Tl::load(y + at, base, n, yv);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float dp = leaky_grad(gv[i], yv[i]);
      gv[i] = dp;
      v[i] = scale * (dp - fmaf((v[i] - mu) * rs, bv, a));
    }
    Tl::store(dx + at, base, n, v);
    if constexpr (kRes) Tl::store(dres + at, base, n, gv);
  }
}

// The launch geometry of an instance of n values.
struct Geometry {
  int threads, chunks, groups;
};

Geometry geometry(long long n) {
  const long long warps = (n + 32LL * kPer - 1) / (32LL * kPer);
  const int threads = static_cast<int>(std::min(warps, static_cast<long long>(kMaxWarps))) * 32;
  const long long chunk = static_cast<long long>(threads) * kPer;
  const int chunks = static_cast<int>((n + chunk - 1) / chunk);
  return {threads, chunks, (chunks + kApplyChunks - 1) / kApplyChunks};
}

bool aligned(const void* p) { return p == nullptr || reinterpret_cast<size_t>(p) % 16 == 0; }

// n values an instance (counted in int), every grid under 2^31 blocks
bool shape_ok(long long n, int batch, int channels) {
  if (n < 1 || n >= (1LL << 31) || batch < 1 || channels < 1) return false;
  return static_cast<long long>(batch) * channels * geometry(n).chunks < (1LL << 31);
}

template <typename T, bool kVec>
cudaError_t forward_as(const void* x, const void* res, const void* weight, const void* bias,
                       void* part, void* y, void* mean, void* rstd, long long n, int instances,
                       int channels, float eps, cudaStream_t st) {
  const Geometry geo = geometry(n);
  stats_kernel<T, kVec><<<instances * geo.chunks, geo.threads, 0, st>>>(
      static_cast<const T*>(x), static_cast<float2*>(part), n, geo.chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kernel = res ? &apply_kernel<T, kVec, true> : &apply_kernel<T, kVec, false>;
  kernel<<<instances * geo.groups, geo.threads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const float*>(weight),
      static_cast<const float*>(bias), static_cast<const float2*>(part), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), n, channels, geo.chunks,
      geo.groups, eps);
  return cudaGetLastError();
}

template <typename T, bool kVec>
cudaError_t backward_as(const void* dy, const void* y, const void* x, const void* weight,
                        const void* mean, const void* rstd, void* part, void* dx, void* dres,
                        void* dweight, void* dbias, long long n, int batch, int channels,
                        cudaStream_t st) {
  const Geometry geo = geometry(n);
  const int instances = batch * channels;
  bwd_reduce_kernel<T, kVec><<<instances * geo.chunks, geo.threads, 0, st>>>(
      static_cast<const T*>(dy), static_cast<const T*>(y), static_cast<const T*>(x),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<float2*>(part), n, geo.chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto apply = dres ? &bwd_apply_kernel<T, kVec, true> : &bwd_apply_kernel<T, kVec, false>;
  apply<<<instances * geo.groups, geo.threads, 0, st>>>(
      static_cast<const T*>(dy), static_cast<const T*>(y), static_cast<const T*>(x),
      static_cast<const float*>(weight), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const float2*>(part), static_cast<T*>(dx),
      static_cast<T*>(dres), static_cast<float*>(dweight), static_cast<float*>(dbias), n,
      batch, channels, geo.chunks, geo.groups);
  return cudaGetLastError();
}

// 16-byte loads: every instance starts 16-byte aligned and holds whole
// loads, and every pointer is 16-byte aligned
template <typename T>
bool vector_ok(long long n, std::initializer_list<const void*> ptrs) {
  if ((n * static_cast<long long>(sizeof(T))) % 16 != 0) return false;
  for (const void* p : ptrs)
    if (!aligned(p)) return false;
  return true;
}

}  // namespace

// The length of the table of partials a call takes, in float2 (pairs of
// floats): B C times the chunks of an instance of n values.
extern "C" long long instance_norm_partials(long long n, int batch, int channels) {
  if (!shape_ok(n, batch, channels)) return -1;
  return static_cast<long long>(batch) * channels * geometry(n).chunks;
}

// x, res (or null), y: (batch, channels, n) of one type, dtype 0 bf16, 1
// fp32; weight, bias: (channels,) fp32; mean, rstd: (batch, channels) fp32,
// written; part: instance_norm_partials(...) float2 of scratch; all
// contiguous on `device`.
extern "C" int instance_norm_forward(const void* x, const void* res, const void* weight,
                                     const void* bias, void* part, void* y, void* mean,
                                     void* rstd, long long n, int batch, int channels,
                                     float eps, int dtype, int device, void* stream) {
  if (!shape_ok(n, batch, channels) || dtype < 0 || dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int instances = batch * channels;
  if (dtype == 0) {
    const auto run = vector_ok<__nv_bfloat16>(n, {x, res, y})
                         ? &forward_as<__nv_bfloat16, true>
                         : &forward_as<__nv_bfloat16, false>;
    return static_cast<int>(run(x, res, weight, bias, part, y, mean, rstd, n, instances,
                                channels, eps, st));
  }
  const auto run = vector_ok<float>(n, {x, res, y}) ? &forward_as<float, true>
                                                    : &forward_as<float, false>;
  return static_cast<int>(run(x, res, weight, bias, part, y, mean, rstd, n, instances,
                              channels, eps, st));
}

// dy, y, x, dx, dres (or null): (batch, channels, n) of one type (dtype as
// above); weight: (channels,) fp32; mean, rstd: as the forward wrote them;
// dweight, dbias: (channels,) fp32, written; part: scratch as the forward's.
extern "C" int instance_norm_backward(const void* dy, const void* y, const void* x,
                                      const void* weight, const void* mean, const void* rstd,
                                      void* part, void* dx, void* dres, void* dweight,
                                      void* dbias, long long n, int batch, int channels,
                                      int dtype, int device, void* stream) {
  if (!shape_ok(n, batch, channels) || dtype < 0 || dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const auto run = vector_ok<__nv_bfloat16>(n, {dy, y, x, dx, dres})
                         ? &backward_as<__nv_bfloat16, true>
                         : &backward_as<__nv_bfloat16, false>;
    return static_cast<int>(run(dy, y, x, weight, mean, rstd, part, dx, dres, dweight, dbias,
                                n, batch, channels, st));
  }
  const auto run = vector_ok<float>(n, {dy, y, x, dx, dres}) ? &backward_as<float, true>
                                                             : &backward_as<float, false>;
  return static_cast<int>(run(dy, y, x, weight, mean, rstd, part, dx, dres, dweight, dbias, n,
                              batch, channels, st));
}

extern "C" const char* instance_norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
