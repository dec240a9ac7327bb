// hrt1_decode: planar HRT1 command columns -> decoded bytes, as int32 words.
//
// Replaces the Pallas decode kernel hypersonic_rle_kit_tpu/ops/decode_sup.py
// (_decode_body, launched from _decode_jit).  That kernel exists in its shape
// (stripe-bucketed event routing, one-hot MXU paint, triangular-matmul scans,
// SWAR word assembly) because the TPU has no fast gather or scatter.  Hopper
// has both, so this kernel computes the same bytes directly:
//
//   per block, for each command c in order: lit_len[c] literal bytes, then
//   count[c] copies of sym[c]; zero past block_len.
//
// Bound: memory.  Bytes in are O(compressed) (the columns and the trimmed
// literal section), bytes out are O(uncompressed); the arithmetic is a scan
// and a binary search.  Design, one CTA per block:
//
//   1. Block-wide exclusive scans of (lit_len + count) and lit_len, tiled
//      over the command axis with a running carry, give every command's
//      output start and literal start.  They go to a global scratch row of
//      the block (2 x C int32, L2-resident while the block runs).
//   2. Threads own 16-byte output chunks, interleaved so a warp stores 512
//      contiguous bytes.  A chunk binary-searches the starts for its first
//      command, then walks commands byte by byte (zero-length commands in
//      mid-stream are skipped by the walk) and stores four whole words.
//
// Hostile input cannot drive an access out of bounds: negative fields count
// as 0, every prefix saturates at B, literal reads stay inside the literal
// row, and only commands < min(n_cmds, C) are read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;                  // commands per thread per tile
constexpr int kTile = kThreads * kItems;
constexpr int kChunk = 16;                 // output bytes per thread step

struct Pair {
  int a;  // output bytes (lit_len + count)
  int b;  // literal bytes
};

__device__ __forceinline__ int sat(int x, int cap) { return x < cap ? x : cap; }

__device__ __forceinline__ int clamp_field(int v, int cap) {
  return v < 0 ? 0 : (v > cap ? cap : v);
}

// Block-wide exclusive scan of two sums that saturate at `cap` (the
// saturating add is associative for non-negative inputs).  Returns this
// thread's exclusive prefix and writes the block total to *total.
__device__ Pair block_exclusive_scan(Pair v, int cap, Pair* warp_sums,
                                     Pair* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Pair inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int a = __shfl_up_sync(0xffffffffu, inc.a, d);
    int b = __shfl_up_sync(0xffffffffu, inc.b, d);
    if (lane >= d) {
      inc.a = sat(inc.a + a, cap);
      inc.b = sat(inc.b + b, cap);
    }
  }
  Pair exc;
  exc.a = __shfl_up_sync(0xffffffffu, inc.a, 1);
  exc.b = __shfl_up_sync(0xffffffffu, inc.b, 1);
  if (lane == 0) exc = Pair{0, 0};
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Pair w = lane < kWarps ? warp_sums[lane] : Pair{0, 0};
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int a = __shfl_up_sync(0xffffffffu, w.a, d);
      int b = __shfl_up_sync(0xffffffffu, w.b, d);
      if (lane >= d) {
        w.a = sat(w.a + a, cap);
        w.b = sat(w.b + b, cap);
      }
    }
    if (lane < kWarps) warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  if (warp > 0) {
    Pair base = warp_sums[warp - 1];
    exc.a = sat(base.a + exc.a, cap);
    exc.b = sat(base.b + exc.b, cap);
  }
  *total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums is reused by the next tile
  return exc;
}

__global__ void __launch_bounds__(kThreads)
hrt1_decode_kernel(const uint8_t* __restrict__ sym,
                   const int32_t* __restrict__ count,
                   const int32_t* __restrict__ lit_len,
                   const uint8_t* __restrict__ lits,
                   const int32_t* __restrict__ n_cmds,
                   const int32_t* __restrict__ block_len,
                   int32_t* __restrict__ scratch,
                   int32_t* __restrict__ out,
                   int C, int lit_bytes, int B, int W) {
  __shared__ Pair warp_sums[kWarps];
  const int64_t blk = blockIdx.x;
  const int nc = clamp_field(n_cmds[blk], C);
  const int blen = clamp_field(block_len[blk], B);
  const uint8_t* sy = sym + blk * C;
  const int32_t* cn = count + blk * C;
  const int32_t* ll = lit_len + blk * C;
  const uint8_t* lt = lits + blk * lit_bytes;
  int32_t* starts = scratch + blk * 2 * C;   // output start of command c
  int32_t* lstarts = starts + C;              // literal start of command c
  int32_t* o = out + blk * W;

  // ---- 1. command starts: tiled saturating exclusive scans ----
  Pair carry{0, 0};
  for (int t0 = 0; t0 < nc; t0 += kTile) {
    int sp[kItems], ln[kItems];
    Pair mine{0, 0};
    const int c0 = t0 + threadIdx.x * kItems;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int c = c0 + i;
      sp[i] = ln[i] = 0;
      if (c < nc) {
        ln[i] = clamp_field(ll[c], B);
        sp[i] = sat(ln[i] + clamp_field(cn[c], B), B);
      }
      mine.a = sat(mine.a + sp[i], B);
      mine.b = sat(mine.b + ln[i], B);
    }
    Pair total;
    Pair exc = block_exclusive_scan(mine, B, warp_sums, &total);
    Pair run{sat(carry.a + exc.a, B), sat(carry.b + exc.b, B)};
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int c = c0 + i;
      if (c < nc) {
        starts[c] = run.a;
        lstarts[c] = run.b;
      }
      run.a = sat(run.a + sp[i], B);
      run.b = sat(run.b + ln[i], B);
    }
    carry.a = sat(carry.a + total.a, B);
    carry.b = sat(carry.b + total.b, B);
  }
  __syncthreads();  // the block's scratch writes are visible to all threads

  // ---- 2. fill: 16-byte chunks, whole little-endian words ----
  const int out_bytes = W * 4;
  const bool vec_ok = (W & 3) == 0;
  for (int p0 = threadIdx.x * kChunk; p0 < out_bytes;
       p0 += kThreads * kChunk) {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (p0 < blen && nc > 0) {
      // last command whose start <= p0 (starts[0] == 0 <= p0)
      int lo = 0, hi = nc - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (starts[mid] <= p0) lo = mid; else hi = mid - 1;
      }
      int c = lo;
      int s = starts[c];
      int ls = lstarts[c];
      int l = clamp_field(ll[c], B);
      uint32_t sv = sy[c];
      int nxt = c + 1 < nc ? starts[c + 1] : 0x7fffffff;
      const int pend = min(p0 + kChunk, blen);
      for (int p = p0; p < pend; ++p) {
        while (p >= nxt) {  // starts saturate at B > p: stays below nc
          ++c;
          s = nxt;
          ls = lstarts[c];
          l = clamp_field(ll[c], B);
          sv = sy[c];
          nxt = c + 1 < nc ? starts[c + 1] : 0x7fffffff;
        }
        const int within = p - s;
        uint32_t v = sv;
        if (within < l) {
          const int li = ls + within;
          v = li < lit_bytes ? lt[li] : 0u;
        }
        w[(p - p0) >> 2] |= v << (8 * ((p - p0) & 3));
      }
    }
    const int q0 = p0 >> 2;
    if (vec_ok && q0 + 4 <= W) {
      *reinterpret_cast<uint4*>(o + q0) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (q0 + k < W) o[q0 + k] = static_cast<int32_t>(w[k]);
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`: nb CTAs of kThreads.  Shapes (row-major, contiguous):
// sym u8 [nb, C]; count, lit_len i32 [nb, C]; lits u8 [nb, lit_bytes];
// n_cmds, block_len i32 [nb]; scratch i32 [nb, 2, C]; out i32 [nb, W] with
// 4 * W >= B.  Returns cudaGetLastError() after the launch.
int hrt1_decode(const void* sym, const void* count, const void* lit_len,
                const void* lits, const void* n_cmds, const void* block_len,
                void* scratch, void* out, int64_t nb, int32_t C,
                int32_t lit_bytes, int32_t B, int32_t W, void* stream) {
  if (nb > 0) {
    hrt1_decode_kernel<<<static_cast<unsigned>(nb), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(sym), static_cast<const int32_t*>(count),
        static_cast<const int32_t*>(lit_len),
        static_cast<const uint8_t*>(lits),
        static_cast<const int32_t*>(n_cmds),
        static_cast<const int32_t*>(block_len),
        static_cast<int32_t*>(scratch), static_cast<int32_t*>(out), C,
        lit_bytes, B, W);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* hrt1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
