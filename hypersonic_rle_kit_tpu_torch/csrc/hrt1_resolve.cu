// hrt1_resolve_deep: the deep-layout column resolver.
//
// Replaces the Pallas kernel hypersonic_rle_kit_tpu/ops/unpack_device.py
// (_resolve_body, launched from _resolve_deep).  Per block and command idx
// (is_run = idx < n_cmds - 1, is_cmd = idx < n_cmds):
//
//   count   = is_run ? (cnt == cesc ? cnt_ovf[rank among count escapes]
//                                   : cnt) + min_count : 0
//   lit_len = is_cmd ? (ll == lesc ? ll_ovf[rank among lit_len escapes]
//                                  : ll) : 0
//   sym     = lut in 1..7 ? dict7[lut - 1]
//           : (is_run && lut == 0 ? miss[rank among misses] : 0)
//
// where an escape is counted only on is_run (count) or is_cmd (lit_len)
// positions, and cesc / lesc < 0 disable that column's escapes.  The TPU
// kernel distributes the overflow lists with log-step staircase pulls over
// 8-block groups because it has no gather; here the ranks come from warp
// __ballot_sync/__popc plus a block scan over the warps, tiled over the
// command axis with a running carry, and the lists are read by index.
//
// Bound: memory.  Six int32 planes in and three planes out per command, one
// pass, no reuse.  One CTA per block.  Every overflow-list and miss read is
// clamped to the row (cap entries), so a container whose stored counts
// disagree with its escape population cannot fault; the per-block `bad`
// flags computed beside the launch catch it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
hrt1_resolve_kernel(const int32_t* __restrict__ cnt,
                    const int32_t* __restrict__ cnt_ovf,
                    const int32_t* __restrict__ ll,
                    const int32_t* __restrict__ ll_ovf,
                    const int32_t* __restrict__ lut,
                    const uint8_t* __restrict__ miss,
                    const uint8_t* __restrict__ dict7,
                    const int32_t* __restrict__ n_cmds,
                    int32_t* __restrict__ count_out,
                    int32_t* __restrict__ litlen_out,
                    uint8_t* __restrict__ sym_out,
                    int cap, int cesc, int lesc, int min_count) {
  __shared__ int warp_cnt[3][kWarps];
  __shared__ uint8_t dict[8];
  const int64_t row = static_cast<int64_t>(blockIdx.x) * cap;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  const int nc = n_cmds[blockIdx.x];
  if (threadIdx.x < 7) dict[threadIdx.x] = dict7[blockIdx.x * 7 + threadIdx.x];
  __syncthreads();

  int carry_c = 0, carry_l = 0, carry_m = 0;
  for (int t0 = 0; t0 < cap; t0 += kThreads) {
    const int i = t0 + threadIdx.x;
    const bool in = i < cap;
    const int cv = in ? cnt[row + i] : 0;
    const int lv = in ? ll[row + i] : 0;
    const int lu = in ? lut[row + i] : 0;
    const bool run = in && i < nc - 1;
    const bool cmd = in && i < nc;
    const bool ce = run && cesc >= 0 && cv == cesc;
    const bool le = cmd && lesc >= 0 && lv == lesc;
    const bool me = run && lu == 0;
    const unsigned bc = __ballot_sync(0xffffffffu, ce);
    const unsigned bl = __ballot_sync(0xffffffffu, le);
    const unsigned bm = __ballot_sync(0xffffffffu, me);
    if (lane == 0) {
      warp_cnt[0][warp] = __popc(bc);
      warp_cnt[1][warp] = __popc(bl);
      warp_cnt[2][warp] = __popc(bm);
    }
    __syncthreads();
    int oc = 0, ol = 0, om = 0, tc = 0, tl = 0, tm = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int a = warp_cnt[0][w], b = warp_cnt[1][w], m = warp_cnt[2][w];
      if (w < warp) {
        oc += a;
        ol += b;
        om += m;
      }
      tc += a;
      tl += b;
      tm += m;
    }
    __syncthreads();  // warp_cnt is rewritten by the next tile
    if (in) {
      int c = cv;
      if (ce) c = cnt_ovf[row + min(carry_c + oc + __popc(bc & lt_mask), cap - 1)];
      count_out[row + i] = run ? c + min_count : 0;
      int l = lv;
      if (le) l = ll_ovf[row + min(carry_l + ol + __popc(bl & lt_mask), cap - 1)];
      litlen_out[row + i] = cmd ? l : 0;
      uint8_t s = 0;
      if (lu >= 1 && lu <= 7) {
        s = dict[lu - 1];
      } else if (me) {
        s = miss[row + min(carry_m + om + __popc(bm & lt_mask), cap - 1)];
      }
      sym_out[row + i] = s;
    }
    carry_c += tc;
    carry_l += tl;
    carry_m += tm;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`: nb CTAs of kThreads.  Shapes (row-major, contiguous):
// cnt, cnt_ovf, ll, ll_ovf, lut i32 [nb, cap]; miss u8 [nb, cap];
// dict7 u8 [nb, 7]; n_cmds i32 [nb]; outputs count, lit_len i32 and
// sym u8 [nb, cap].  Returns cudaGetLastError() after the launch.
int hrt1_resolve_deep(const void* cnt, const void* cnt_ovf, const void* ll,
                      const void* ll_ovf, const void* lut, const void* miss,
                      const void* dict7, const void* n_cmds, void* count_out,
                      void* litlen_out, void* sym_out, int64_t nb,
                      int32_t cap, int32_t cesc, int32_t lesc,
                      int32_t min_count, void* stream) {
  if (nb > 0 && cap > 0) {
    hrt1_resolve_kernel<<<static_cast<unsigned>(nb), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(cnt), static_cast<const int32_t*>(cnt_ovf),
        static_cast<const int32_t*>(ll), static_cast<const int32_t*>(ll_ovf),
        static_cast<const int32_t*>(lut), static_cast<const uint8_t*>(miss),
        static_cast<const uint8_t*>(dict7),
        static_cast<const int32_t*>(n_cmds),
        static_cast<int32_t*>(count_out), static_cast<int32_t*>(litlen_out),
        static_cast<uint8_t*>(sym_out), cap, cesc, lesc, min_count);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
