// mmtf_scan: the per-lane move-to-front scan of MMTF 128/256, encode or
// decode, over independent blocks.
//
// Replaces the XLA scan of hypersonic_rle_kit_tpu/ops/mmtf_device.py
// (_mtf_scan and mmtf_device, one lax.scan step of _mtf_step per unit).
// A block x[b] of n bytes is n / lanes units of `lanes` bytes; byte l of
// every unit belongs to lane l, which keeps its own 256-entry history,
// initialised 0..255.  Per unit and lane:
//
//   encode: d = position of v in the history; out = d
//   decode: v = history[d];                   out = v
//   then history[1..d] = history[0..d-1], history[0] = v.
//
// The final history of each (block, lane) is written too: the caller looks
// the trailing partial unit up in it without an update (mmtf.c:161-175).
//
// Bound: latency.  The scan is serial per lane: a step's search depends on
// the previous step's table.  The parallelism is blocks x lanes, so a single
// block of 16 lanes runs 16 threads.  Design: one thread per (block, lane),
// its history in shared memory (entry e of thread t at [e][t], so a warp
// touching one entry reads consecutive bytes); search and shift are one pass
// (carry the displaced entry until v is found); the input bytes of eight
// units are loaded ahead into registers so a step waits on no global load.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kAhead = 8;

__global__ void mmtf_scan_kernel(const uint8_t* __restrict__ x,
                                 uint8_t* __restrict__ out,
                                 int32_t* __restrict__ table, int64_t pairs,
                                 int64_t n, int lanes, int encode) {
  __shared__ uint8_t hist[256 * kThreads];
  const int64_t t = blockIdx.x * int64_t(kThreads) + threadIdx.x;
  if (t >= pairs) return;  // no barrier below
  uint8_t* h = hist + threadIdx.x;
  for (int e = 0; e < 256; ++e) h[e * kThreads] = static_cast<uint8_t>(e);
  const int64_t b = t / lanes;
  const int64_t l = t - b * lanes;
  const uint8_t* src = x + b * n + l;
  uint8_t* dst = out + b * n + l;
  const int64_t units = n / lanes;
  for (int64_t u0 = 0; u0 < units; u0 += kAhead) {
    uint8_t in[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      in[k] = u0 + k < units ? src[(u0 + k) * lanes] : 0;
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (u0 + k >= units) break;
      const uint8_t v = encode ? in[k] : h[in[k] * kThreads];
      // one pass: write v at 0, shift entries right until v's old slot
      uint8_t carry = v;
      int e = 0;
      for (;;) {
        const uint8_t cur = h[e * kThreads];
        h[e * kThreads] = carry;
        if (cur == v) break;
        carry = cur;
        ++e;
      }
      dst[(u0 + k) * lanes] = encode ? static_cast<uint8_t>(e) : v;
    }
  }
  int32_t* tb = table + t * 256;
  for (int e = 0; e < 256; ++e) tb[e] = h[e * kThreads];
}

}  // namespace

extern "C" {

// Launch on `stream`.  x, out u8 [nb, n] with n % lanes == 0; table i32
// [nb, lanes, 256]; all contiguous.  encode != 0 encodes, else decodes.
// Returns cudaGetLastError() after the launch.
int mmtf_scan(const void* x, void* out, void* table, int64_t nb, int64_t n,
              int32_t lanes, int32_t encode, void* stream) {
  const int64_t pairs = nb * lanes;
  if (pairs > 0) {
    const unsigned grid =
        static_cast<unsigned>((pairs + kThreads - 1) / kThreads);
    mmtf_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out),
        static_cast<int32_t*>(table), pairs, n, lanes, encode);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
