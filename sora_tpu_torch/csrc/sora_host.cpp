// sora_host — native host runtime of the software PHY (the port's own
// copy of sora_tpu/native/sora_host.cpp; same C interface).
//
// Replacement for the reference's user-mode runtime layer
// (kernel/core/src: RX manager's DMA ring + scan pointer semantics of
// _rx_stream.h, the VStream multi-reader bitmask of _rx_manager.h, and
// the TSC timing of soratime.h).  Where the reference feeds SSE chains
// from a PCIe ring, this library feeds torch device batches from a
// lock-free ring filled by a producer thread (file replay or synthetic
// radio), exposed to Python via a flat C ABI (ctypes).
//
// Build: runtime/native.py compiles it with g++ -O3 -shared at first use
// into _build/libsora_host_torch.so.

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>

extern "C" {

// ---------------------------------------------------------------------------
// Dump-file loading (LoadSoraDumpFile semantics, brickutil.h:20-58)
// ---------------------------------------------------------------------------

// Parse a Sora dump byte image: strip the 16-byte descriptor from every
// 128-byte block, sign-extend 14-bit components, write interleaved float32
// I/Q.  Returns the number of complex samples produced.
long sora_parse_dump(const uint8_t* data, long nbytes, int sign_extend_14,
                     float* out_iq) {
  const long nblocks = nbytes / 128;
  long n = 0;
  for (long b = 0; b < nblocks; ++b) {
    const uint8_t* payload = data + b * 128 + 16;
    for (int s = 0; s < 28; ++s) {
      int16_t i16, q16;
      memcpy(&i16, payload + 4 * s, 2);
      memcpy(&q16, payload + 4 * s + 2, 2);
      int32_t i = i16, q = q16;
      if (sign_extend_14) {
        i = ((i & 0x3FFF) ^ 0x2000) - 0x2000;
        q = ((q & 0x3FFF) ^ 0x2000) - 0x2000;
      }
      out_iq[2 * n] = (float)i;
      out_iq[2 * n + 1] = (float)q;
      ++n;
    }
  }
  return n;
}

// ---------------------------------------------------------------------------
// RX sample ring (SPSC per reader, multi-reader broadcast via vstream mask)
// ---------------------------------------------------------------------------
//
// Layout mirrors the reference ring semantics: a circular buffer of
// complex float32 samples; the producer advances a write cursor; each of
// up to 16 readers ("vstreams", _rx_manager.h:14-28) tracks its own read
// cursor.  A reader that falls a full ring behind loses the oldest
// samples (counted as drops) — the same overrun behavior as the DMA ring.

struct RxRing {
  float* buf;            // interleaved I/Q, 2*capacity floats
  long capacity;         // in complex samples (power of two)
  std::atomic<long> wr;  // total samples written (monotonic)
  std::atomic<long> rd[16];
  std::atomic<long> drops[16];
  uint32_t reader_mask;
  std::atomic<int> stop;
  // producer thread state (file replay)
  std::thread* producer;
  float* src;
  long src_len;
  double rate_sps;       // replay pacing; 0 = as fast as possible
  int loop;
};

RxRing* sora_ring_create(long capacity) {
  // round capacity up to a power of two so wrap is a mask
  long cap = 1;
  while (cap < capacity) cap <<= 1;
  RxRing* r = new RxRing();
  r->buf = (float*)aligned_alloc(64, sizeof(float) * 2 * cap);
  r->capacity = cap;
  r->wr.store(0);
  for (int i = 0; i < 16; ++i) {
    r->rd[i].store(0);
    r->drops[i].store(0);
  }
  r->reader_mask = 0;
  r->stop.store(0);
  r->producer = nullptr;
  r->src = nullptr;
  r->src_len = 0;
  r->rate_sps = 0;
  r->loop = 0;
  return r;
}

int sora_ring_alloc_vstream(RxRing* r) {
  for (int i = 0; i < 16; ++i) {
    if (!(r->reader_mask & (1u << i))) {
      r->reader_mask |= (1u << i);
      r->rd[i].store(r->wr.load(std::memory_order_acquire));
      r->drops[i].store(0);
      return i;
    }
  }
  return -1;
}

// Producer side: append n samples (interleaved I/Q floats).
void sora_ring_write(RxRing* r, const float* iq, long n) {
  const long cap = r->capacity;
  long w = r->wr.load(std::memory_order_relaxed);
  for (long k = 0; k < n; ++k) {
    long idx = (w + k) & (cap - 1);
    r->buf[2 * idx] = iq[2 * k];
    r->buf[2 * idx + 1] = iq[2 * k + 1];
  }
  r->wr.store(w + n, std::memory_order_release);
}

// Reader side: copy up to n available samples into out; returns count.
// Non-blocking — the scan-pointer poll of SoraRadioReadRxStream
// (_rx_stream.h:102-161) without the spin (the host loop batches).
long sora_ring_read(RxRing* r, int vs, float* out, long n) {
  const long cap = r->capacity;
  long w = r->wr.load(std::memory_order_acquire);
  long rd = r->rd[vs].load(std::memory_order_relaxed);
  if (w - rd > cap) {  // overrun: drop to the oldest retained sample
    r->drops[vs].fetch_add(w - cap - rd);
    rd = w - cap;
  }
  long avail = w - rd;
  if (avail > n) avail = n;
  for (long k = 0; k < avail; ++k) {
    long idx = (rd + k) & (cap - 1);
    out[2 * k] = r->buf[2 * idx];
    out[2 * k + 1] = r->buf[2 * idx + 1];
  }
  r->rd[vs].store(rd + avail, std::memory_order_release);
  return avail;
}

// Assemble `batch` overlapping windows (stride `hop`) straight from the
// ring into quantized interleaved I/Q — the node's whole host-side feed
// path (window slicing + AGC scaling + ADC saturation) in ONE pass with
// no intermediate float buffers.  The overlap region stays in the ring
// (the reader advances by hop*batch but windows extend window samples),
// so the Python-side carry buffer disappears.  Returns the absolute
// sample position of window 0, or -1 if fewer than
// window + hop*(batch-1) samples are available, or -2 if that span
// exceeds the ring capacity (caller must fall back).
static long read_windows_common(RxRing* r, int vs, long window, long hop,
                                long batch, long* rd_out) {
  const long cap = r->capacity;
  long w = r->wr.load(std::memory_order_acquire);
  long rd = r->rd[vs].load(std::memory_order_relaxed);
  if (w - rd > cap) {  // overrun: drop to the oldest retained sample
    r->drops[vs].fetch_add(w - cap - rd);
    rd = w - cap;
    r->rd[vs].store(rd, std::memory_order_release);
  }
  const long total = window + hop * (batch - 1);
  if (total > cap) return -2;
  if (w - rd < total) return -1;
  *rd_out = rd;
  return rd;
}

long sora_ring_read_windows_i16(RxRing* r, int vs, long window, long hop,
                                long batch, float scale, int16_t* out) {
  long rd;
  long rc = read_windows_common(r, vs, window, hop, batch, &rd);
  if (rc < 0) return rc;
  const long cap = r->capacity;
  for (long b = 0; b < batch; ++b) {
    const long base = rd + b * hop;
    int16_t* dst = out + 2 * b * window;
    for (long k = 0; k < window; ++k) {
      const long idx = (base + k) & (cap - 1);
      float re = r->buf[2 * idx] * scale;
      float im = r->buf[2 * idx + 1] * scale;
      re = re > 32767.f ? 32767.f : (re < -32767.f ? -32767.f : re);
      im = im > 32767.f ? 32767.f : (im < -32767.f ? -32767.f : im);
      dst[2 * k] = (int16_t)re;
      dst[2 * k + 1] = (int16_t)im;
    }
  }
  r->rd[vs].store(rd + hop * batch, std::memory_order_release);
  return rd;
}

long sora_ring_read_windows_i8(RxRing* r, int vs, long window, long hop,
                               long batch, float scale, int8_t* out) {
  long rd;
  long rc = read_windows_common(r, vs, window, hop, batch, &rd);
  if (rc < 0) return rc;
  const long cap = r->capacity;
  for (long b = 0; b < batch; ++b) {
    const long base = rd + b * hop;
    int8_t* dst = out + 2 * b * window;
    for (long k = 0; k < window; ++k) {
      const long idx = (base + k) & (cap - 1);
      float re = r->buf[2 * idx] * scale;
      float im = r->buf[2 * idx + 1] * scale;
      re = re > 127.f ? 127.f : (re < -127.f ? -127.f : re);
      im = im > 127.f ? 127.f : (im < -127.f ? -127.f : im);
      dst[2 * k] = (int8_t)re;
      dst[2 * k + 1] = (int8_t)im;
    }
  }
  r->rd[vs].store(rd + hop * batch, std::memory_order_release);
  return rd;
}

long sora_ring_available(RxRing* r, int vs) {
  long w = r->wr.load(std::memory_order_acquire);
  long rd = r->rd[vs].load(std::memory_order_relaxed);
  long avail = w - rd;
  return avail > r->capacity ? r->capacity : avail;
}

long sora_ring_drops(RxRing* r, int vs) { return r->drops[vs].load(); }

// ---------------------------------------------------------------------------
// Replay producer: stream a sample buffer into the ring at a target rate
// (the radio-replacement source; TMemSamples + radio pacing in one).
// ---------------------------------------------------------------------------

static void producer_main(RxRing* r) {
  using clk = std::chrono::steady_clock;
  const long chunk = 4096;
  auto t0 = clk::now();
  long sent = 0;
  long pos = 0;
  while (!r->stop.load(std::memory_order_relaxed)) {
    if (r->rate_sps > 0) {
      double elapsed = std::chrono::duration<double>(clk::now() - t0).count();
      long target = (long)(elapsed * r->rate_sps);
      if (sent >= target) {
        std::this_thread::sleep_for(std::chrono::microseconds(50));
        continue;
      }
    }
    long n = chunk;
    if (pos + n > r->src_len) n = r->src_len - pos;
    sora_ring_write(r, r->src + 2 * pos, n);
    pos += n;
    sent += n;
    if (pos >= r->src_len) {
      if (!r->loop) break;
      pos = 0;
    }
  }
}

// Start replaying `iq` (n samples) into the ring at rate_sps (0 = flat
// out).  The source buffer is copied (caller may free theirs).
void sora_ring_start_replay(RxRing* r, const float* iq, long n,
                            double rate_sps, int loop) {
  r->src = (float*)malloc(sizeof(float) * 2 * n);
  memcpy(r->src, iq, sizeof(float) * 2 * n);
  r->src_len = n;
  r->rate_sps = rate_sps;
  r->loop = loop;
  r->stop.store(0);
  r->producer = new std::thread(producer_main, r);
}

void sora_ring_stop(RxRing* r) {
  r->stop.store(1);
  if (r->producer) {
    r->producer->join();
    delete r->producer;
    r->producer = nullptr;
  }
}

void sora_ring_destroy(RxRing* r) {
  sora_ring_stop(r);
  free(r->buf);
  free(r->src);
  delete r;
}

// ---------------------------------------------------------------------------
// Timing (soratime.h analogue)
// ---------------------------------------------------------------------------

double sora_monotonic_ns() {
  return (double)std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

}  // extern "C"
