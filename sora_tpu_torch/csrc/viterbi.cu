// Block-parallel K=7 (133,171) Viterbi decoder for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sora_tpu/ops/viterbi_pallas.py::decode_blocks
// (pl.pallas_call of _kernel) and reproduces its output bit for bit:
// round(8x) soft quantization clamped to +-7, overlapping windows that keep
// their middle `block` bits, the soft PM_CLAMP start pin of a stream's first
// window, the state-0 end pin of a terminated stream's last window, radix-4
// steps whose 16 predecessors j are packed into the low 4 bits of the
// candidate (lowest j wins ties), renorm by the minimum and a clamp at
// PM_CLAMP once per radix-4 step, the lowest-index best end state, and the
// traceback through 4-bit decisions.  The wrapper and the plain PyTorch
// version are in sora_tpu_torch/ops/viterbi_cuda.py.
//
// What bounds it: int32 operations.  Any exact decoder does one radix-2
// add-compare-select per state and trellis step (2 adds, 1 min): 192 ops
// per window step.  At the 54 Mbps bench shape (128 streams of T = 12096,
// block 1024, overlap 64: 1536 windows of 1152 steps) that is 0.34 G ops;
// an H100 SM issues 64 int32 lanes a clock, so 132 SMs at 1.98 GHz take
// 0.020 ms, against 0.004 ms for the ~14 MB moved (fp32 soft in, uint8 out).
// In practice the walk's dependent chain sets the time: the walk is
// sequential in time, 1536 windows give one warp to each window and fewer
// than four warps to each SM scheduler, so each window's chain of shuffles,
// adds and mins is the critical path (sora_tpu_torch/tools/viterbi_probe.py
// measures it), and the design keeps that chain short and shares the
// serial parts among the lanes.
//
// The radix-4 step as four radix-2 sub-steps.  Keep the TPU's packed key
// (metric, j) and at sub-step k (0..3) give each state n the min over its
// two predecessors 2(n&31)+x of key - bm(n, x) + (x at bit k of j); renorm
// and clamp once after sub-step 3.  The dropped bit x of sub-step k is bit
// k of j, so the final key is (pm[s] - bm over 4 steps, j), and a nested min
// of sums is the min over all 16 paths: the same value, and on a tie the
// lowest j, as the radix-4 min.  Only 512 candidates per radix-4 step.
//
// The key is metric << 22 | j << 18 | three 6-bit state marks.  Two
// candidates for one state always differ in j, so the marks never decide a
// min; they ride along with the survivor.  At the end of radix-4 step
// mark_f each state writes its own index into field f, so the end state's
// key names the states its survivor passes at the three marks, and three
// lanes trace the kept block back in three independent walks of a third
// each instead of lane 0 walking it all.
//
// Design: one warp per window.  Lane u holds the keys of states u and
// u + 32 (the butterfly of predecessors 2u, 2u + 1) in two registers, a and
// b, swapped on odd lanes.  Before each sub-step two shuffles bring the
// predecessors' keys: register a from lane (2u + h) & 31 and register b from
// lane (2u + 1 - h) & 31, h = u >> 4.  Both generators tap the newest and
// the oldest bit, so flipping the input bit or x negates both code signs:
// the butterfly's four branch metrics are +-beta, beta = eA*sA + eB*sB, and
// each lane reads one signed value per step, +-sA +- sB, from a table of
// four int16 variants per step (one broadcast shared load).  A sub-step is
// two shuffles and, for each key, one add and one add-min on addends formed
// before the shuffles land: no table lookup and no barrier on the chain.
// Per radix-4 step one warp min renorms, and each lane stores one decision
// byte (two 4-bit nibbles).  The window's soft values arrive in chunks of
// 128 steps, each fetched into registers while the walk runs the chunk
// before it.  The walks trace back into shared memory and the warp stores
// the block's bits, 16 B a lane.  Shared memory: 8 B of metrics and 8 B of
// decisions per step, 18 KB per window at the bench shape, four windows per
// block.  Tensor cores do not fit: in the TPU's fused matrix the metric
// block is a permutation, so an mma would spend 73 x 1024 multiply-adds on
// 512 adds, and every step would move the metrics from the accumulator
// layout back into operands.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kPmClamp = 120;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kG0 = 0133;
constexpr int kG1 = 0171;
constexpr int kMaxDevices = 64;
// the packed key: metric << kValShift | j << kJShift | marks
constexpr int kValShift = 22;
constexpr int kJShift = 18;
constexpr int kValMask = ~((1 << kValShift) - 1);
constexpr int kMarkMask = (1 << kJShift) - 1;
constexpr int kKeyClamp = kPmClamp << kValShift;
constexpr int kChunk = 128;                  // window steps a fetch, 4 a lane

// shared bytes per window: 4 int16 metrics per step, then 32 decision
// bytes per radix-4 step; the block's bits are staged over the metrics
__host__ __device__ inline size_t window_bytes(int win) {
  return 16 * (size_t)win;
}

__device__ __forceinline__ int quantize(float v) {
  return (int)fminf(fmaxf(rintf(v * 8.f), -7.f), 7.f);
}

// Step metrics sA + sB, sA - sB, sB - sA, -sA - sB as four int16.
__device__ __forceinline__ uint2 step_metrics(float2 v) {
  const int qa = quantize(v.x), qb = quantize(v.y);
  const int s = qa + qb, d = qa - qb;
  uint2 p;
  p.x = (uint32_t)(s & 0xffff) | ((uint32_t)d << 16);
  p.y = (uint32_t)(-d & 0xffff) | ((uint32_t)(-s) << 16);
  return p;
}

// Field f of both keys := the lane's state indices.
__device__ __forceinline__ void mark(int f, int state_a, int state_b, int& ra,
                                     int& rb) {
  const int sh = 6 * f;
  ra = (ra & ~(63 << sh)) | (state_a << sh);
  rb = (rb & ~(63 << sh)) | (state_b << sh);
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
viterbi_r4_kernel(const float2* __restrict__ soft, uint8_t* __restrict__ out,
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
  int16_t* metric = reinterpret_cast<int16_t*>(base);      // [win][4]
  uint8_t* dec = base + 8 * (size_t)win;                    // [nstep][32]

  // Window time i is stream time k*block - overlap + i; outside the stream
  // the soft pair is a zero erasure.  Chunk c is window steps 128c ..
  // 128c + 127: fetch loads it into v, stash writes its metrics.
  const float2* srow = soft + (size_t)b * T;
  const long long t0 = (long long)k * block - overlap;
  float2 v[kChunk / 32];
  auto fetch = [&](int c) {
#pragma unroll
    for (int q = 0; q < kChunk / 32; ++q) {
      const int i = kChunk * c + 32 * q + lane;
      const long long t = t0 + i;
      v[q] = (i < win && t >= 0 && t < T) ? srow[t] : make_float2(0.f, 0.f);
    }
  };
  auto stash = [&](int c) {
#pragma unroll
    for (int q = 0; q < kChunk / 32; ++q) {
      const int i = kChunk * c + 32 * q + lane;
      if (i < win) reinterpret_cast<uint2*>(metric)[i] = step_metrics(v[q]);
    }
  };

  // Lane constants.  beta's signs (eA, eB) are the code bits of the
  // transition 2u -> u; sigma folds in which register holds which target
  // (odd lanes swap a and b) and which shuffle brings x = 1 (h).
  const int h = lane >> 4;
  const int odd = lane & 1;
  const int sigma = (2 * h - 1) * (1 - 2 * odd);
  const int e_a = 2 * (__popc((2 * lane) & kG0) & 1) - 1;
  const int e_b = 2 * (__popc((2 * lane) & kG1) & 1) - 1;
  const int16_t* lm = metric + 2 * (sigma * e_a < 0) + (sigma * e_b < 0);
  const int src1 = (2 * lane + h) & 31;
  const int src2 = (2 * lane + 1 - h) & 31;
  const int state_a = odd ? lane + 32 : lane;
  const int state_b = odd ? lane : lane + 32;     // never state 0
  const bool first = (k == 0);
  int ra = (first && state_a != 0) ? kKeyClamp : 0;
  int rb = first ? kKeyClamp : 0;
  // the kept block is radix-4 steps m_lo..m_hi; marks split it in thirds
  const int m_lo = overlap >> 2;
  const int m_hi = ((overlap + block) >> 2) - 1;
  const int third = (m_hi - m_lo + 3) / 3;
  const int mark2 = m_hi, mark1 = m_hi - third, mark0 = m_hi - 2 * third;

  fetch(0);
  stash(0);
  fetch(1);
  __syncwarp();

  // The inner loop runs radix-4 steps up to the next event, which the
  // outer loop handles at the top of step m: chunk m/32 arrives, or the
  // marks of steps mark_f = m - 1 are taken.  So the steps' dependent
  // chain carries no per-step test.
  constexpr int kChunkSteps = kChunk / 4;
  int m = 0;
  while (m < nstep) {
    if (m == mark0 + 1) mark(0, state_a, state_b, ra, rb);
    if (m == mark1 + 1) mark(1, state_a, state_b, ra, rb);
    if (m == mark2 + 1) mark(2, state_a, state_b, ra, rb);
    if (m && m % kChunkSteps == 0) {
      stash(m / kChunkSteps);
      fetch(m / kChunkSteps + 1);
      __syncwarp();
    }
    int stop = min((m / kChunkSteps + 1) * kChunkSteps, nstep);
    if (mark0 >= m) stop = min(stop, mark0 + 1);
    if (mark1 >= m) stop = min(stop, mark1 + 1);
    if (mark2 >= m) stop = min(stop, mark2 + 1);
    for (; m < stop; ++m) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int d = lm[4 * (4 * m + kk)] * (1 << kValShift);
        const int qk = h << (kJShift + kk);        // + (x << kk) on x = 1:
        const int rk = (1 << (kJShift + kk)) - qk; // shuffle 1 if h, else 2
        // the addends are formed before the shuffles land, so each key
        // is one add and one add-min after its shuffle
        const int a1 = qk + d, a2 = rk - d, b1 = qk - d, b2 = rk + d;
        const int r1 = __shfl_sync(kFull, ra, src1);
        const int r2 = __shfl_sync(kFull, rb, src2);
        ra = min(r1 + a1, r2 + a2);
        rb = min(r1 + b1, r2 + b2);
      }
      const int lo = odd ? rb : ra;                // state lane
      const int hi = odd ? ra : rb;                // state lane + 32
      dec[32 * m + lane] = (uint8_t)(((lo >> kJShift) & 15) |
                                     (((hi >> kJShift) & 15) << 4));
      const int fa = ra & kValMask, fb = rb & kValMask;
      const int mn = __reduce_min_sync(kFull, min(fa, fb));
      ra = min(fa - mn, kKeyClamp) | (ra & kMarkMask);
      rb = min(fb - mn, kKeyClamp) | (rb & kMarkMask);
    }
  }
  if (mark2 == nstep - 1) mark(2, state_a, state_b, ra, rb);

  // the end state: the lowest index of the least metric, or state 0; its
  // key names its survivor's states at the three marks
  int end = 0;
  if (!(terminated && k == nblk - 1)) {
    const int key = min(((ra >> 16) & ~63) | state_a,
                        ((rb >> 16) & ~63) | state_b);
    end = __reduce_min_sync(kFull, key) & 63;
  }
  const int end_key =
      __shfl_sync(kFull, state_a == end ? ra : rb, end & 31);
  __syncwarp();                                  // metrics are read: reuse
  uint32_t* stage = reinterpret_cast<uint32_t*>(base);
  if (lane < 3) {
    // lane f walks from its mark down to the mark below (exclusive)
    int state = (end_key >> (6 * lane)) & 63;
    const int top = lane == 2 ? mark2 : lane == 1 ? mark1 : mark0;
    const int bottom = lane == 2 ? mark1 + 1 : lane == 1 ? mark0 + 1 : m_lo;
    for (int i = top; i >= bottom; --i) {
      // bits (state >> 2 + q) & 1 of times 4i + q, one byte each
      stage[i - m_lo] = (((uint32_t)state >> 2) * 0x204081u) & 0x01010101u;
      const int d2 = dec[32 * i + (state & 31)];
      state = 16 * (state & 3) + ((d2 >> ((state >> 3) & 4)) & 15);
    }
  }
  __syncwarp();
  uint8_t* dst = out + (size_t)b * T + (size_t)k * block;
  const int n = (int)min((long long)block, (long long)T - (long long)k * block);
  const uint8_t* st = reinterpret_cast<const uint8_t*>(stage);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int nv = n >> 4;
    for (int i = lane; i < nv; i += 32)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(st)[i];
    done = nv << 4;
  }
  for (int i = done + lane; i < n; i += 32) dst[i] = st[i];
}

// Per device: the opt-in shared-memory limit, once the kernel's dynamic
// shared-memory attribute has been raised to it (0 until then).  Setting
// up twice from two threads is harmless: both do the same.
std::atomic<int> g_smem_max[kMaxDevices];

cudaError_t device_smem_max(int device, int* smem_max) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int v = g_smem_max[device].load(std::memory_order_acquire);
  if (v == 0) {
    cudaError_t err = cudaDeviceGetAttribute(
        &v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(viterbi_r4_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, v);
    if (err != cudaSuccess) return err;
    g_smem_max[device].store(v, std::memory_order_release);
  }
  *smem_max = v;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// soft: (B, T, 2) fp32 contiguous on the device, 8-byte aligned; out:
// (B, T) uint8.  Launches on `stream` and returns cudaGetLastError() (0 on
// success), or an error for what the kernel does not take: block or
// overlap not a multiple of 8, a window too long for shared memory, or a
// misaligned soft pointer.
int sora_viterbi_decode(const float* soft, uint8_t* out, int B, int T,
                        int block, int overlap, int terminated, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (block <= 0 || block % 8 || overlap < 0 || overlap % 8)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(soft) & 7)
    return (int)cudaErrorMisalignedAddress;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  int smem_max = 0;
  err = device_smem_max(device, &smem_max);
  if (err != cudaSuccess) return (int)err;
  const int win = block + 2 * overlap;
  const size_t per_window = window_bytes(win);
  if (per_window > (size_t)smem_max) return (int)cudaErrorInvalidValue;
  int wpb = kWarpsPerBlock;
  while (wpb > 1 && wpb * per_window > (size_t)smem_max) --wpb;
  const int nblk = (T + block - 1) / block;
  const long long nwin = (long long)B * nblk;
  const long long grid = (nwin + wpb - 1) / wpb;
  viterbi_r4_kernel<<<(unsigned)grid, 32 * wpb, wpb * per_window,
                      (cudaStream_t)stream>>>(
      reinterpret_cast<const float2*>(soft), out, T, block, overlap, nblk,
      terminated, wpb, nwin);
  return (int)cudaGetLastError();
}

const char* sora_viterbi_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
