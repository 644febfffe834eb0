// Sliding complex correlation against a short pattern, for Hopper (sm_90a):
// out[r, n] = sum_k x[r, n + k] * conj(p[k]), n < N - w + 1, w = 64 (the
// 802.11a/n LTS) or 11 (the 802.11b Barker).
//
// It replaces no TPU kernel: the JAX package computes this
// (sora_tpu/dsp/filters.py::correlate_stream) as jnp code that XLA fuses
// into one pass.  The port's plain PyTorch version
// (sora_tpu_torch/dsp/filters.py::correlate_stream_reference) is a loop of
// a zero fill and w strided multiplies and adds, 2w + 1 kernels that each
// read and write the whole (rows, nwin) complex64 tensor; this kernel takes
// its place for every CUDA tensor.  The wrapper is
// sora_tpu_torch/ops/correlate_cuda.py.
//
// Exactness.  Each output is the loop's own arithmetic: the sum starts
// from 0 and adds the products for k = 0 .. w-1 in order, and each product
// is rounded as PyTorch's CUDA multiply of a complex64 tensor by a complex
// scalar rounds it, so the kernel equals the loop run on the card bit for
// bit.  The intrinsics (__fmul_rn, __fadd_rn, __fmaf_rn) fix every
// rounding, so nvcc cannot contract or reorder them.
//
// What bounds it.  At the 11a fixed-rate shape (2048 rows of 5040 samples,
// 4977 outputs a row) it reads 82.6 MB and writes 81.5 MB: 0.049 ms at
// 3.35 TB/s.  Each output takes w complex multiply-adds, 8 fp32 flops as
// 4 FMAs: 5.2 GFLOP at 67 TFLOP/s = 0.078 ms, so fp32 throughput bounds it, not
// bytes.  Rounded as the loop rounds, a complex multiply-add is 6
// instructions (2 multiplies, 2 FMAs, 2 adds): 3.9 G at 128 fp32 lanes x
// 132 SMs x 1.98 GHz = 0.117 ms.  On an H100 80GB HBM3 at 700 W it takes
// about 0.2 ms there, against about 11.6 ms for the loop; launches: one a
// call.  PERF.md's kernel table has the times at every caller's shape.
//
// Design.  A 2-D grid: blockIdx.x a row, blockIdx.y a tile of outputs.  The
// block loads its tile's samples plus the w - 1 sample halo into shared
// memory once, as 16-byte loads where the row allows it (8-byte ones
// otherwise), then each thread keeps kOut consecutive outputs and a window
// of kOut samples in registers: per tap it reads one new sample from shared
// memory and reuses the kOut - 1 others, so shared traffic is one 8-byte
// read per kOut complex products.  Shared memory holds one pad slot after
// every kOut samples, which makes a warp's reads at stride kOut + 1 free of
// bank conflicts.  The outputs go back through shared memory and leave as
// coalesced stores.  The taps (conjugated, at most 64 float2) travel by
// value in the kernel's parameters, in the constant bank: no copy to the
// device per call.  The tile width follows the row: the fewest tiles of at
// most kMaxThreads x kOut outputs, each thread count rounded up to a warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOut = 8;             // consecutive outputs a thread
constexpr int kMaxThreads = 256;
constexpr int kMaxTaps = 64;

struct Taps {
  float2 c[kMaxTaps];
};

// shared index of sample i: one pad slot after every kOut samples
__device__ __forceinline__ int padded(int i) { return i + i / kOut; }

// x * c rounded as PyTorch's CUDA multiply of a complex64 tensor by a
// complex scalar rounds it (c10::complex operator*, re = a c - b d and
// im = a d + b c, as nvcc contracted them there): re = fma(a, c, -(b d)),
// im = fma(b, c, a d).  Of the five ways to contract the two, only this
// one matched torch's product on the card in every bit (4.2 M products
// at each of the 77 LTS and Barker taps)
__device__ __forceinline__ float2 cmul(float2 x, float2 c) {
  return make_float2(__fmaf_rn(x.x, c.x, -__fmul_rn(x.y, c.y)),
                     __fmaf_rn(x.y, c.x, __fmul_rn(x.x, c.y)));
}

template <int W>
__global__ void __launch_bounds__(kMaxThreads)
correlate_kernel(const float2* __restrict__ x, float2* __restrict__ out,
                 long long row_stride, int n, int nwin, int vec, Taps taps) {
  extern __shared__ float2 s[];
  const int cap = blockDim.x * kOut;           // outputs of this tile
  const int have = cap + W - 1;                // samples the tile reads
  const long long row = blockIdx.x;
  const int t0 = blockIdx.y * cap;
  const float2* xr = x + row * row_stride + t0;
  const int nload = min(have, n - t0);

  if (vec) {                    // row start and t0 even, x 16-byte aligned
    const int pairs = nload / 2;
    for (int i = threadIdx.x; i < pairs; i += blockDim.x) {
      const float4 v = reinterpret_cast<const float4*>(xr)[i];
      s[padded(2 * i)] = make_float2(v.x, v.y);
      s[padded(2 * i + 1)] = make_float2(v.z, v.w);
    }
    for (int i = 2 * pairs + threadIdx.x; i < nload; i += blockDim.x)
      s[padded(i)] = xr[i];
  } else {
    for (int i = threadIdx.x; i < nload; i += blockDim.x) s[padded(i)] = xr[i];
  }
  for (int i = nload + threadIdx.x; i < have; i += blockDim.x)
    s[padded(i)] = make_float2(0.f, 0.f);
  __syncthreads();

  const int j0 = threadIdx.x * kOut;
  float2 acc[kOut], win[kOut];
#pragma unroll
  for (int r = 0; r < kOut; ++r) {
    acc[r] = make_float2(0.f, 0.f);
    win[r] = s[padded(j0 + r)];
  }
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const float2 c = taps.c[k];
#pragma unroll
    for (int r = 0; r < kOut; ++r) {
      const float2 p = cmul(win[r], c);
      acc[r].x = __fadd_rn(acc[r].x, p.x);
      acc[r].y = __fadd_rn(acc[r].y, p.y);
    }
    if (k + 1 < W) {
#pragma unroll
      for (int r = 0; r + 1 < kOut; ++r) win[r] = win[r + 1];
      win[kOut - 1] = s[padded(j0 + k + kOut)];
    }
  }
  __syncthreads();                             // the samples are read
#pragma unroll
  for (int r = 0; r < kOut; ++r) s[padded(j0 + r)] = acc[r];
  __syncthreads();

  float2* orow = out + row * nwin + t0;
  const int nstore = min(cap, nwin - t0);
  for (int i = threadIdx.x; i < nstore; i += blockDim.x)
    orow[i] = s[padded(i)];
}

template <int W>
cudaError_t launch(const float2* x, float2* out, int rows,
                   long long row_stride, int n, const Taps& taps,
                   cudaStream_t stream) {
  const int nwin = n - W + 1;
  const int most = kMaxThreads * kOut;
  const int tiles0 = (nwin + most - 1) / most;
  const int per = (nwin + tiles0 - 1) / tiles0;
  const int threads = ((per + kOut - 1) / kOut + 31) / 32 * 32;
  const int cap = threads * kOut;
  const int tiles = (nwin + cap - 1) / cap;
  const int have = cap + W - 1;
  const size_t smem = (size_t)(have + have / kOut + 1) * sizeof(float2);
  // 16-byte loads: every tile starts at an even sample (cap is even) of a
  // row that starts 16-byte aligned
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (row_stride % 2 == 0);
  correlate_kernel<W><<<dim3((unsigned)rows, (unsigned)tiles), threads, smem,
                        stream>>>(x, out, row_stride, n, nwin, vec, taps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: rows of n complex64 samples, row r at x + r * row_stride (in
// complex64 elements), 8-byte aligned; out: (rows, n - w + 1) complex64
// contiguous; taps: the w conjugated pattern values as 2w floats (re, im).
// Launches on `stream` and returns cudaGetLastError() (0 on success), or an
// error for what the kernel does not take: w other than 64 or 11, n < w, or
// a misaligned x.
int sora_correlate(const float* x, float* out, int rows, long long row_stride,
                   int n, int w, const float* taps, void* stream) {
  if ((w != 64 && w != 11) || n < w || rows < 0 || row_stride < n)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) & 7)
    return (int)cudaErrorMisalignedAddress;
  if (rows == 0) return 0;
  Taps t{};
  for (int k = 0; k < w; ++k) t.c[k] = make_float2(taps[2 * k], taps[2 * k + 1]);
  const float2* xs = reinterpret_cast<const float2*>(x);
  float2* os = reinterpret_cast<float2*>(out);
  const cudaStream_t st = (cudaStream_t)stream;
  if (w == 64) return (int)launch<64>(xs, os, rows, row_stride, n, t, st);
  return (int)launch<11>(xs, os, rows, row_stride, n, t, st);
}

const char* sora_correlate_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
