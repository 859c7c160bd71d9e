// The RSM gates' thin 7^3 conv for Hopper (sm_90a): NCDHW in and out,
// "same" padding 3, a bias per output channel, 1 to 16 input channels and 1
// to 4 output channels, any spatial size.
//
// Replaces no Pallas kernel: the JAX package runs this conv through XLA
// (xlstm_hved_tpu/nn/blocks.py, conv3d_slab). It was added because the
// library call on this card, F.conv3d with 2 or 4 input channels and one
// output channel, falls to cuDNN's legacy fp32 NCHW path (with layout
// conversions around it) and ran at about 1 % of the card's fp32 rate: the
// AttenModule2 gates of nn/blocks.py::_composed_pool_gate took two thirds of
// a 15-subset sweep's device time.
//
// The bound. At 128x192x128 the 4 -> 1 gate reads 4 bf16 channels and
// writes one (31.5 MB, 9.4 us at 3.35 TB/s) and does 4 * 343 fused
// multiply-adds a voxel (8.6 GFLOP, 129 us at the 67 TFLOP/s of the CUDA
// cores): the kernel is bound by arithmetic, so its design keeps the FMA
// pipes fed and spends few shared-memory loads per FMA.
//
// The design. One block of 128 threads computes a tile of 8 (z) x 8 (y) x
// 32 (x) outputs for every output channel. Per input channel it stages the
// halo'd input tile, 14 x 14 x 38 values converted once to the accumulation
// type (fp32 for bf16 and fp32 operands, fp64 for fp64), zero outside the
// volume, and that channel's weights (each 7-tap x row padded to 8) in
// shared memory. A thread owns 8 consecutive x outputs in each of 2 rows
// (y) of one plane (z), for every output channel. For each (kz, ky) it
// reads one 16-value input row with four 16-byte loads, keeps the rows of
// the previous ky in registers (a rolling window of 2 rows), reads the 7
// taps of each output channel once (a broadcast), and does 7 x 8 FMAs per
// row and output channel: 8 rows and 7 weight rows a (channel, kz), against
// 784 FMAs per output channel, so the FMA pipe and not shared memory is the
// limit. Lanes 4 apart sit in neighbouring planes, whose pitch is 4 mod 8
// words, so each quarter warp's 16-byte loads touch 32 distinct banks.
// Tiles of 8 x 8 x 32 give 1536 blocks at 128x192x128, six to an SM (33 KB
// of shared memory each): about two full waves over 132 SMs.
//
// Determinism and precision. Every output is one thread's sum in one fixed
// order, input channel, then kz, ky, kx, each term an fma into an fp32
// (fp64) accumulator from zero, then the bias added and the sum rounded
// once to the output type. The halo's zeros make edge outputs follow the
// same sequence, so an output does not depend on where its tile lies, the
// grid or the batch; no atomics, no sums across blocks, so runs repeat bit
// for bit. A product of two bf16 values is exact in fp32: the bf16 path
// computes at the precision of the configuration (bf16 operands, fp32
// sums). No TF32 anywhere.
//
// gate_conv_launch allocates nothing and enqueues one launch on the given
// stream, without synchronising; it returns the launch's cudaError_t.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 7;              // the kernel's size along each axis
constexpr int kHalo = kTaps - 1;
constexpr int kRun = 8;               // consecutive x outputs of a thread
constexpr int kLanesX = 4;            // threads along x in a tile row
constexpr int kTileX = kRun * kLanesX;  // 32
constexpr int kTileZ = 8;             // planes of a tile: lane / kLanesX
constexpr int kRowsY = 2;             // rows (y) of a thread
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileY = kRowsY * kWarps;  // 8
constexpr int kPlanes = kTileZ + kHalo;  // 14 staged planes
constexpr int kRows = kTileY + kHalo;    // 14 staged rows a plane
constexpr int kCols = kTileX + kHalo;    // 38 staged columns a row
constexpr int kPitch = 40;               // a row's pitch: 16-byte aligned rows
// a plane's pitch, 4 mod 8 words: lanes 4 apart (neighbouring planes) fall
// on other banks than their own plane's lanes
constexpr int kPlanePitch = kRows * kPitch + 4;
constexpr int kTileValues = kPlanes * kPlanePitch;
constexpr int kTapPad = 8;               // a weight row's 7 taps and a zero
constexpr int kBatch = 16;               // staging loads in flight a thread
constexpr int kStageSteps =              // staged values a thread, whole batches
    (kPlanes * kRows * kCols + kThreads * kBatch - 1) / (kThreads * kBatch) * kBatch;
constexpr int kMaxIn = 16;
constexpr int kMaxOut = 4;

static_assert(kPitch >= kCols + 2 && kPitch % 4 == 0, "a thread reads 16 values a row");
static_assert(kPlanePitch % 8 == 4, "neighbouring planes on other banks");
static_assert(kThreads / kCols + 1 < kRows, "one step moves at most one plane");

__device__ __forceinline__ float load_acc(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_acc(const float* p) { return *p; }
__device__ __forceinline__ double load_acc(const double* p) { return *p; }

__device__ __forceinline__ __nv_bfloat16 from_acc(float v, __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float from_acc(float v, float*) { return v; }
__device__ __forceinline__ double from_acc(double v, double*) { return v; }

__device__ __forceinline__ float fma_acc(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_acc(double a, double b, double c) { return fma(a, b, c); }

// 16 consecutive values of shared memory at a 16-byte aligned address
template <typename Acc>
__device__ __forceinline__ void load_row(const Acc* p, Acc (&v)[16]) {
  constexpr int kPer = 16 / sizeof(Acc);
  struct alignas(16) Chunk { Acc e[kPer]; };
#pragma unroll
  for (int i = 0; i < 16 / kPer; ++i) {
    const Chunk c = reinterpret_cast<const Chunk*>(p)[i];
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[i * kPer + j] = c.e[j];
  }
}

template <typename Acc>
__device__ __forceinline__ void load_taps(const Acc* p, Acc (&v)[kTapPad]) {
  constexpr int kPer = 16 / sizeof(Acc);
  struct alignas(16) Chunk { Acc e[kPer]; };
#pragma unroll
  for (int i = 0; i < kTapPad / kPer; ++i) {
    const Chunk c = reinterpret_cast<const Chunk*>(p)[i];
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[i * kPer + j] = c.e[j];
  }
}

// Grid: (x tiles * y tiles, z tiles, batch). x: (n, cin, d, h, w); weight:
// (cout, cin, 7, 7, 7); bias: (cout,); out: (n, cout, d, h, w); all
// contiguous. Dynamic shared memory: the input tile and one channel's
// weights, in Acc.
template <typename T, typename Acc, int kOut>
__global__ void __launch_bounds__(kThreads)
gate_conv_kernel(const T* __restrict__ x, const T* __restrict__ weight,
                 const T* __restrict__ bias, T* __restrict__ out, int cin, int d, int h,
                 int w, int tiles_x, bool vector_store) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* tile = reinterpret_cast<Acc*>(smem_raw);
  Acc* taps = tile + kTileValues;   // (kOut, kz, ky, kTapPad) of one channel

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tx = lane % kLanesX;
  const int tz = lane / kLanesX;
  const int ty = (tid >> 5) * kRowsY;
  const int x0 = (blockIdx.x % tiles_x) * kTileX;
  const int y0 = (blockIdx.x / tiles_x) * kTileY;
  const int z0 = blockIdx.y * kTileZ;
  const int n = blockIdx.z;
  const long long plane = static_cast<long long>(h) * w;
  const long long volume = plane * d;

  Acc acc[kOut][kRowsY][kRun];
#pragma unroll
  for (int o = 0; o < kOut; ++o)
#pragma unroll
    for (int r = 0; r < kRowsY; ++r)
#pragma unroll
      for (int i = 0; i < kRun; ++i) acc[o][r][i] = Acc(0);

  // the thread's first value of each staged row it reads
  const int base = tz * kPlanePitch + ty * kPitch + tx * kRun;

  for (int c = 0; c < cin; ++c) {
    __syncthreads();   // the previous channel's reads are done
    const T* xc = x + (static_cast<long long>(n) * cin + c) * volume;
    // stage the halo'd tile, value e = tid + k kThreads of the kPlanes x
    // kRows x kCols values for k = 0, 1, ...: kBatch loads in flight before
    // their stores, the position stepped on without divisions
    int px = tid % kCols, py = tid / kCols % kRows, pz = tid / (kCols * kRows);
#pragma unroll 1
    for (int k = 0; k < kStageSteps; k += kBatch) {
      Acc v[kBatch];
      int at[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int gz = z0 - kHalo / 2 + pz, gy = y0 - kHalo / 2 + py, gx = x0 - kHalo / 2 + px;
        const bool live = pz < kPlanes && static_cast<unsigned>(gz) < static_cast<unsigned>(d) &&
                          static_cast<unsigned>(gy) < static_cast<unsigned>(h) &&
                          static_cast<unsigned>(gx) < static_cast<unsigned>(w);
        v[j] = live ? load_acc(xc + (gz * h + gy) * w + gx) : Acc(0);
        at[j] = pz < kPlanes ? pz * kPlanePitch + py * kPitch + px : -1;
        px += kThreads % kCols;
        py += kThreads / kCols;
        if (px >= kCols) { px -= kCols; ++py; }
        if (py >= kRows) { py -= kRows; ++pz; }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (at[j] >= 0) tile[at[j]] = v[j];
    }
    for (int i = tid; i < kOut * kTaps * kTaps * kTapPad; i += kThreads) {
      const int kx = i % kTapPad, row = i / kTapPad;   // row: (o, kz, ky)
      const int o = row / (kTaps * kTaps), zy = row % (kTaps * kTaps);
      taps[i] = kx < kTaps
                    ? load_acc(weight + ((static_cast<long long>(o) * cin + c) * kTaps * kTaps +
                                         zy) * kTaps + kx)
                    : Acc(0);
    }
    __syncthreads();

#pragma unroll 1
    for (int kz = 0; kz < kTaps; ++kz) {
      const Acc* src = tile + base + kz * kPlanePitch;
      const Acc* wz = taps + kz * kTaps * kTapPad;
      Acc rows[kRowsY][16];
#pragma unroll
      for (int r = 0; r < kRowsY - 1; ++r) load_row(src + r * kPitch, rows[r]);
#pragma unroll
      for (int ky = 0; ky < kTaps; ++ky) {
        // the rolling window: rows ky .. ky + kRowsY - 1, the last one new
        load_row(src + (ky + kRowsY - 1) * kPitch, rows[(ky + kRowsY - 1) % kRowsY]);
#pragma unroll
        for (int o = 0; o < kOut; ++o) {
          Acc wt[kTapPad];
          load_taps(wz + (o * kTaps * kTaps + ky) * kTapPad, wt);
#pragma unroll
          for (int r = 0; r < kRowsY; ++r) {
            const Acc(&in)[16] = rows[(ky + r) % kRowsY];
#pragma unroll
            for (int kx = 0; kx < kTaps; ++kx)
#pragma unroll
              for (int i = 0; i < kRun; ++i)
                acc[o][r][i] = fma_acc(wt[kx], in[i + kx], acc[o][r][i]);
          }
        }
      }
    }
  }

  const int gz = z0 + tz;
  if (gz >= d) return;
  const int gx = x0 + tx * kRun;
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    const Acc b = load_acc(bias + o);
    T* dst_o = out + (static_cast<long long>(n) * kOut + o) * volume + gz * plane;
#pragma unroll
    for (int r = 0; r < kRowsY; ++r) {
      const int gy = y0 + ty + r;
      if (gy >= h) continue;
      T* dst = dst_o + static_cast<long long>(gy) * w + gx;
      if (vector_store && gx + kRun <= w) {
        constexpr int kPer = 16 / sizeof(T);
        struct alignas(16) Chunk { T e[kPer]; };
#pragma unroll
        for (int i = 0; i < kRun / kPer; ++i) {
          Chunk v;
#pragma unroll
          for (int j = 0; j < kPer; ++j)
            v.e[j] = from_acc(acc[o][r][i * kPer + j] + b, static_cast<T*>(nullptr));
          reinterpret_cast<Chunk*>(dst)[i] = v;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kRun; ++i)
          if (gx + i < w) dst[i] = from_acc(acc[o][r][i] + b, static_cast<T*>(nullptr));
      }
    }
  }
}

template <typename T, typename Acc, int kOut>
cudaError_t launch(const void* x, const void* weight, const void* bias, void* out, int n,
                   int cin, int d, int h, int w, cudaStream_t stream) {
  const int tiles_x = (w + kTileX - 1) / kTileX;
  const int tiles_y = (h + kTileY - 1) / kTileY;
  const int tiles_z = (d + kTileZ - 1) / kTileZ;
  const size_t smem = sizeof(Acc) * (kTileValues + kOut * kTaps * kTaps * kTapPad);
  auto kernel = gate_conv_kernel<T, Acc, kOut>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // 16-byte stores of a thread's run: rows of whole runs, an aligned output
  const bool vector_store = w % kRun == 0 && reinterpret_cast<size_t>(out) % 16 == 0;
  const dim3 grid(tiles_x * tiles_y, tiles_z, n);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(weight), static_cast<const T*>(bias),
      static_cast<T*>(out), cin, d, h, w, tiles_x, vector_store);
  return cudaGetLastError();
}

template <typename T, typename Acc>
cudaError_t launch_out(const void* x, const void* weight, const void* bias, void* out, int n,
                       int cin, int cout, int d, int h, int w, cudaStream_t stream) {
  switch (cout) {
    case 1: return launch<T, Acc, 1>(x, weight, bias, out, n, cin, d, h, w, stream);
    case 2: return launch<T, Acc, 2>(x, weight, bias, out, n, cin, d, h, w, stream);
    case 3: return launch<T, Acc, 3>(x, weight, bias, out, n, cin, d, h, w, stream);
    default: return launch<T, Acc, 4>(x, weight, bias, out, n, cin, d, h, w, stream);
  }
}

}  // namespace

// x: (n, cin, d, h, w); weight: (cout, cin, k, k, k); bias: (cout,); out:
// (n, cout, d, h, w); contiguous, of one dtype: 0 bf16 (fp32 sums), 1 fp32,
// 2 fp64 (fp64 sums), on `device`. Takes k 7, cin 1..16, cout 1..4, any
// positive n, d, h, w with d * h * w and n * cin < 2^31, n, d / 8 up to
// 65535. Enqueues one launch on `stream` and returns its cudaError_t (0 on
// success).
extern "C" int gate_conv_launch(const void* x, const void* weight, const void* bias,
                                void* out, int n, int cin, int cout, int d, int h, int w,
                                int k, int dtype, int device, void* stream) {
  if (k != kTaps || cin < 1 || cin > kMaxIn || cout < 1 || cout > kMaxOut || n < 1 ||
      n > 65535 || d < 1 || h < 1 || w < 1 || (d + kTileZ - 1) / kTileZ > 65535 ||
      static_cast<long long>(d) * h * w >= (1LL << 31) ||
      static_cast<long long>((w + kTileX - 1) / kTileX) * ((h + kTileY - 1) / kTileY) >=
          (1LL << 31) ||
      dtype < 0 || dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(
        launch_out<__nv_bfloat16, float>(x, weight, bias, out, n, cin, cout, d, h, w, st));
  }
  if (dtype == 1) {
    return static_cast<int>(launch_out<float, float>(x, weight, bias, out, n, cin, cout, d, h,
                                                      w, st));
  }
  return static_cast<int>(
      launch_out<double, double>(x, weight, bias, out, n, cin, cout, d, h, w, st));
}

extern "C" const char* gate_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
