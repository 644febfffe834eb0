// Block-parallel radix-4 K=7 (133,171) Viterbi decoder for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sora_tpu/ops/viterbi_pallas.py::decode_blocks
// (pl.pallas_call of _kernel) and reproduces its output bit for bit:
// round(8x) soft quantization clamped to +-7, overlapping windows that keep
// their middle `block` bits, the soft PM_CLAMP start pin of a stream's first
// window, the state-0 end pin of a terminated stream's last window, four
// trellis steps per add-compare-select iteration with the predecessor index j
// packed into the low 4 bits of the candidate (lowest j wins ties), renorm by
// the minimum and a clamp at PM_CLAMP once per radix-4 step, the lowest-index
// best end state, and the traceback through 4-bit decisions.  The wrapper and
// the plain PyTorch version are in sora_tpu_torch/ops/viterbi_cuda.py.
//
// What bounds it: operations.  At the 54 Mbps bench shape (128 streams of
// T = 12096 steps, block 1024, overlap 64) there are 1536 windows of 288
// radix-4 steps, each step 1024 candidates (64 states x 16 predecessors) of
// about 3 integer operations: ~1.4 G int32 operations, against ~14 MB moved
// (fp32 soft in, uint8 bits out).  The walk is sequential in time, so the
// parallelism is across windows and states.
//
// Design (simple first): one warp per window, two target states per lane
// (t = lane and lane + 32, which share their 16 predecessors).  Per radix-4
// step the warp builds a 256-entry branch-metric table (one entry per 8-bit
// coded pattern) in shared memory, each lane forms its 32 packed candidates
// from the shared path metrics and the table, takes the minima, and one warp
// reduction gives the renorm.  The quantized window (2 B per step), the
// packed decisions (32 B per radix-4 step) and the metrics live in shared
// memory: 12.8 KB per window at the bench shape, so four windows per block
// and several blocks per SM.  Lane 0 traces back and writes the middle bits.
// No tensor cores yet: a later version can cast the ACS as the TPU kernel's
// int8 matmul or use dp4a.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPmClamp = 120;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kG0 = 0133;
constexpr int kG1 = 0171;
// shared bytes per window: 64 int32 metrics + 256 int32 branch metrics,
// then 2 int8 soft values per step and 8 decision bytes per 4 steps
constexpr int kFixedBytes = (64 + 256) * 4;

__host__ __device__ inline size_t window_bytes(int win) {
  return kFixedBytes + 10 * (size_t)win;
}

// The 8 coded bits (A, B of input times 4m..4m+3 in bits 2i, 2i+1) of the
// 4-step path into target state t from predecessor s = 16*(t&3) + j.
__device__ __forceinline__ int path_code(int t, int j) {
  int st = 16 * (t & 3) + j;
  int c = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = (t >> (2 + i)) & 1;
    const int reg = (b << 6) | st;
    c |= (__popc(reg & kG0) & 1) << (2 * i);
    c |= (__popc(reg & kG1) & 1) << (2 * i + 1);
    st = (b << 5) | (st >> 1);
  }
  return c;
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
viterbi_r4_kernel(const float* __restrict__ soft, uint8_t* __restrict__ out,
                  int T, int block, int overlap, int nblk, int terminated,
                  int wpb, long long nwin) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long w = (long long)blockIdx.x * wpb + warp;
  if (w >= nwin) return;                       // the whole warp leaves
  const int win = block + 2 * overlap;
  const int nstep = win >> 2;
  const long long b = w / nblk;
  const int k = (int)(w - b * nblk);

  unsigned char* base = smem + (size_t)warp * window_bytes(win);
  int* pm = reinterpret_cast<int*>(base);
  int* bm = pm + 64;
  int8_t* sq = reinterpret_cast<int8_t*>(base + kFixedBytes);
  uint8_t* dec = reinterpret_cast<uint8_t*>(base + kFixedBytes + 2 * win);

  // Quantized window: window time i is stream time k*block - overlap + i;
  // outside the stream the soft value is a zero erasure.
  const float* srow = soft + (size_t)b * T * 2;
  const long long e0 = 2LL * ((long long)k * block - overlap);
  for (int e = lane; e < 2 * win; e += 32) {
    const long long g = e0 + e;
    const float v = (g >= 0 && g < 2LL * T) ? srow[g] : 0.f;
    sq[e] = (int8_t)fminf(fmaxf(rintf(v * 8.f), -7.f), 7.f);
  }
  const bool first = (k == 0);
  pm[lane] = (first && lane != 0) ? kPmClamp : 0;
  pm[lane + 32] = first ? kPmClamp : 0;

  int code0[16], code1[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    code0[j] = path_code(lane, j);
    code1[j] = path_code(lane + 32, j);
  }
  const int pbase = 16 * (lane & 3);
  __syncwarp();

  for (int m = 0; m < nstep; ++m) {
    // branch metrics bm[c] = sum_i (2 c_i - 1) s_i for this lane's 8
    // entries c = 8*lane + e: bits 3..7 come from the lane, 0..2 from e
    const int8_t* s = sq + 8 * m;
    int sv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) sv[i] = s[i];
    int hi = 0;
#pragma unroll
    for (int i = 3; i < 8; ++i) hi += ((lane >> (i - 3)) & 1) ? sv[i] : -sv[i];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int lo = ((e & 1) ? sv[0] : -sv[0]) + ((e & 2) ? sv[1] : -sv[1]) +
                     ((e & 4) ? sv[2] : -sv[2]);
      bm[8 * lane + e] = hi + lo;
    }
    __syncwarp();

    int best0 = 0x7fffffff, best1 = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int p = pm[pbase + j];
      best0 = min(best0, 16 * (p - bm[code0[j]]) + j);
      best1 = min(best1, 16 * (p - bm[code1[j]]) + j);
    }
    const int p0 = best0 >> 4;                 // arithmetic: floor division
    const int p1 = best1 >> 4;
    const int mn = __reduce_min_sync(kFull, min(p0, p1));
    __syncwarp();                              // all reads of pm/bm are done
    pm[lane] = min(p0 - mn, kPmClamp);
    pm[lane + 32] = min(p1 - mn, kPmClamp);
    dec[32 * m + lane] = (uint8_t)((best0 & 15) | ((best1 & 15) << 4));
    __syncwarp();
  }

  int state = 0;
  if (!(terminated && k == nblk - 1)) {
    const int key = min(pm[lane] * 64 + lane, pm[lane + 32] * 64 + lane + 32);
    state = __reduce_min_sync(kFull, key) & 63;
  }
  if (lane != 0) return;
  uint8_t* orow = out + (size_t)b * T;
  const long long g0 = (long long)k * block - overlap;
  for (int m = nstep - 1; m >= overlap / 4; --m) {
    if (4 * m < overlap + block) {
      const long long g = g0 + 4 * m;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (g + q < T) orow[g + q] = (uint8_t)((state >> (2 + q)) & 1);
    }
    const uint8_t d2 = dec[32 * m + (state & 31)];
    const int d = (state & 32) ? (d2 >> 4) : (d2 & 15);
    state = 16 * (state & 3) + d;
  }
}

int max_shared_bytes(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return v;
}

}  // namespace

extern "C" {

// soft: (B, T, 2) fp32 contiguous on the device; out: (B, T) uint8.
// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a geometry the kernel does not take (block or
// overlap not a multiple of 8, or a window too long for shared memory).
int sora_viterbi_decode(const float* soft, uint8_t* out, int B, int T,
                        int block, int overlap, int terminated, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (block <= 0 || block % 8 || overlap < 0 || overlap % 8)
    return (int)cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  const int win = block + 2 * overlap;
  const size_t per_window = window_bytes(win);
  const size_t smem_max = (size_t)max_shared_bytes(device);
  if (per_window > smem_max) return (int)cudaErrorInvalidValue;
  int wpb = kWarpsPerBlock;
  while (wpb > 1 && wpb * per_window > smem_max) --wpb;
  const size_t smem = wpb * per_window;
  err = cudaFuncSetAttribute(viterbi_r4_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nblk = (T + block - 1) / block;
  const long long nwin = (long long)B * nblk;
  const long long grid = (nwin + wpb - 1) / wpb;
  viterbi_r4_kernel<<<(unsigned)grid, 32 * wpb, smem, (cudaStream_t)stream>>>(
      soft, out, T, block, overlap, nblk, terminated, wpb, nwin);
  return (int)cudaGetLastError();
}

const char* sora_viterbi_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
