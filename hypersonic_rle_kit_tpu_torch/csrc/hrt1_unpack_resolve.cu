// hrt1_unpack_resolve: the HRT1 column-prep stage in one launch.
//
// Replaces the Pallas resolver of hypersonic_rle_kit_tpu/ops/unpack_device.py
// (_resolve_body, launched from _resolve_deep at :208) together with what the
// JAX package's decode jits fuse around it: the _unpack_wide bit-unpack of
// every section and the `bad` flag sums (decode_deep_device, :240-267), and
// the flat layout's unpack (decode_payload_device, :77-84).  Per block and
// command idx (is_run = idx < n_cmds - 1, is_cmd = idx < n_cmds), with value
// i of a w-bit section at bit i * w, little-endian:
//
//   count   = is_run ? (cnt escape ? cnt_ovf[rank among count escapes]
//                                  : cnt) + min_count : 0
//   lit_len = is_cmd ? (ll escape ? ll_ovf[rank among lit_len escapes]
//                                 : ll) : 0
//   sym     = lut in 1..7 ? dict7[lut - 1]
//           : (is_run && lut == 0 ? miss[rank among misses] : 0)
//   bad     = any stored population (n_cnt_ovf, n_ll_ovf, n_miss, where
//             given) != the escapes counted
//
// A count escape is cnt == 2^cnt_bits - 1 on an is_run position and a
// lit_len escape ll == 2^lit_bits - 1 on an is_cmd position; an escape is
// replaced only when its overflow width is non-zero, but counted for `bad`
// whenever its base width is.  The flat layout has no escapes, no sym and
// no bad.
//
// Bound: memory.  The packed sections are read once (~5 B an entry on the
// DCT corpus) and count, lit_len and sym written once (9 B an entry); the
// TPU kernel's staircase pulls over unpacked int32 planes become a scan and
// reads at ranks.  Design: one CTA of 512 threads per block, 8 consecutive
// entries a thread, so one sweep covers 4096 entries (a loop with a
// running carry covers larger capacities).  The 8 values of w bits of a
// thread are w whole bytes, so the sweep's bytes of each base section are
// staged into shared memory with 16-byte cp.async copies and a value is a
// funnel shift of two 32-bit words: no thread depends on another to
// unpack.  The sweep's escapes take ranks from the running carries on, so
// the overflow values and misses they can reach are windows of their rows
// that start at the carries; those copies land while the base columns are
// unpacked.  The three escape populations are per-thread 8-bit masks,
// counted in 21-bit fields of one 64-bit word, scanned with shuffles in
// each warp and across the warps through shared memory behind one barrier;
// the same totals give `bad`.  Every entry is stored before that barrier
// as if it had no escape -- count and lit_len as two 16-byte stores a
// thread, sym as one 8-byte store -- so the stores drain while the scan
// runs; after it only the escapes and misses are rewritten, from the
// windows.  A rank never passes its entry's index (and is clamped to
// cap - 1 besides), so a container whose stored counts disagree with its
// escape population reads nothing out of bounds.  256 blocks are one wave
// at two CTAs an SM, so the load, unpack and store phases of the CTAs
// coincide rather than overlap: this, not the bytes, bounds the kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                    // entries a thread
constexpr int kSweep = kThreads * kPer;    // entries a sweep
constexpr int kMaxWidth = 25;
constexpr int kLutWidth = 3;
constexpr int kField = 21;                 // bits of each packed count
constexpr unsigned long long kFieldMask = (1ull << kField) - 1;

// Staged bytes of a w-bit base column for one sweep: its kThreads * w bytes
// plus one 16-byte chunk, so the last value's two-word window stays inside.
__host__ __device__ constexpr int stage_bytes(int w) {
  return w ? kThreads * w + 16 : 0;
}

// Staged bytes of a w-bit overflow list for one sweep: the values at the
// sweep's kSweep ranks from a 16-byte aligned start (one chunk more).
__host__ __device__ constexpr int ovf_stage_bytes(int w) {
  return w ? kThreads * w + 32 : 0;
}

constexpr int kMissStage = kSweep + 16;   // the miss bytes of a sweep

// Dynamic shared memory of a launch: the staged sections of one sweep, and
// 16 bytes past them, so a width-0 column's (masked) reads stay inside.
__host__ __device__ constexpr int smem_bytes(bool deep, int cnt_bits,
                                             int lit_bits, int cov_bits,
                                             int lov_bits) {
  return 16 + stage_bytes(cnt_bits) + stage_bytes(lit_bits) +
         (deep ? stage_bytes(kLutWidth) + ovf_stage_bytes(cov_bits) +
                     ovf_stage_bytes(lov_bits) + kMissStage
               : 0);
}

struct Params {
  const uint8_t* cnts;
  const uint8_t* lls;
  const uint8_t* cnt_ovf;
  const uint8_t* ll_ovf;
  const uint8_t* lut;
  const uint8_t* miss;
  const uint8_t* dict7;
  const int32_t* n_cmds;
  const int32_t* n_cnt_ovf;   // these three may be null
  const int32_t* n_ll_ovf;
  const int32_t* n_miss;
  int32_t* count;
  int32_t* lit_len;
  uint8_t* sym;
  int32_t* bad;
  int cap;
  int s_cnt, s_ll, s_cov, s_lov, s_lut;   // row bytes of the sections
  int cnt_bits, lit_bits, cov_bits, lov_bits;
  int min_count;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// Bytes [lo, lo + want) of a row of `row_bytes` bytes into dst, zero past
// the row: 16-byte cp.async copies where the source is aligned, byte loads
// for the rest.
__device__ void stage(uint32_t* dst, const uint8_t* row, int64_t lo,
                      int row_bytes, int want) {
  const int64_t avail = row_bytes - lo;
  const int have = avail <= 0 ? 0 : (avail < want ? static_cast<int>(avail)
                                                  : want);
  uint8_t* db = reinterpret_cast<uint8_t*>(dst);
  const uint8_t* src = row + (have ? lo : 0);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    done = have & ~15;
    for (int q = 16 * threadIdx.x; q < done; q += 16 * kThreads)
      cp_async16(db + q, src + q);
  }
  for (int q = done + threadIdx.x; q < want; q += kThreads)
    db[q] = q < have ? __ldg(src + q) : 0;
}

// The w bits (w <= 25) from bit p of staged words.
__device__ __forceinline__ uint32_t bits_at(const uint32_t* st, int p, int w) {
  return __funnelshift_r(st[p >> 5], st[(p >> 5) + 1], p & 31) &
         ((1u << w) - 1u);
}

template <bool kDeep>
__global__ void __launch_bounds__(kThreads, 2)
unpack_resolve_kernel(const Params a) {
  // the sweep's stages, laid out as smem_bytes() counts them
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* const st_cnt = smem;
  uint32_t* const st_ll = st_cnt + stage_bytes(a.cnt_bits) / 4;
  uint32_t* const st_lut = st_ll + stage_bytes(a.lit_bits) / 4;
  uint32_t* const st_cov = st_lut + stage_bytes(kLutWidth) / 4;
  uint32_t* const st_lov = st_cov + ovf_stage_bytes(a.cov_bits) / 4;
  uint32_t* const st_miss = st_lov + ovf_stage_bytes(a.lov_bits) / 4;
  __shared__ unsigned long long warp_sum[kWarps];
  __shared__ uint8_t dict[8];
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cap = a.cap;
  const int nc = a.n_cmds[b];
  // n_cmds - 1 as int32 arithmetic gives it (wrapping), like the plain
  // version's tensors
  const int runs = static_cast<int>(static_cast<unsigned>(nc) - 1u);
  const uint32_t cmax = (1u << a.cnt_bits) - 1u;
  const uint32_t lmax = (1u << a.lit_bits) - 1u;
  const int64_t out_row = b * cap;
  if (kDeep && threadIdx.x < 7) dict[threadIdx.x] = a.dict7[b * 7 + threadIdx.x];

  int carry_c = 0, carry_l = 0, carry_m = 0;
  for (int s0 = 0; s0 < cap; s0 += kSweep) {
    if (s0) __syncthreads();   // the last sweep is done with the stages
    const int64_t e0 = s0 / 8;   // bytes per bit of width before the sweep
    stage(st_cnt, a.cnts + b * a.s_cnt, e0 * a.cnt_bits, a.s_cnt,
          stage_bytes(a.cnt_bits));
    stage(st_ll, a.lls + b * a.s_ll, e0 * a.lit_bits, a.s_ll,
          stage_bytes(a.lit_bits));
    if (kDeep)
      stage(st_lut, a.lut + b * a.s_lut, e0 * kLutWidth, a.s_lut,
            stage_bytes(kLutWidth));
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    // the sweep's escapes and misses take ranks from the carries on, so
    // their values lie in windows from each carry's byte (16-byte aligned);
    // these copies land while the base columns are unpacked and stored
    int64_t cov0 = 0, lov0 = 0, miss0 = 0;
    if (kDeep) {
      cov0 = static_cast<int64_t>(carry_c) * a.cov_bits >> 3 & ~15;
      lov0 = static_cast<int64_t>(carry_l) * a.lov_bits >> 3 & ~15;
      miss0 = carry_m & ~15;
      stage(st_cov, a.cnt_ovf + b * a.s_cov, cov0, a.s_cov,
            ovf_stage_bytes(a.cov_bits));
      stage(st_lov, a.ll_ovf + b * a.s_lov, lov0, a.s_lov,
            ovf_stage_bytes(a.lov_bits));
      stage(st_miss, a.miss + b * cap, miss0, cap, kMissStage);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();

    const int k0 = kPer * threadIdx.x;   // first entry in the sweep
    const int i0 = s0 + k0;              // first entry in the row
    const bool mine = i0 < cap;          // cap % 8 == 0: all 8 or none
    unsigned cm = 0, lm = 0, mm = 0;     // escape masks of the 8 entries
    if (mine) {
      // every entry as if it had no escape; escapes and misses are
      // rewritten below once their ranks are known
      int32_t cv[kPer], lv[kPer];
      uint32_t sv[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int i = i0 + j;
        const bool run = i < runs, cmd = i < nc;
        const uint32_t c = bits_at(st_cnt, (k0 + j) * a.cnt_bits, a.cnt_bits);
        const uint32_t l = bits_at(st_ll, (k0 + j) * a.lit_bits, a.lit_bits);
        cv[j] = run ? static_cast<int32_t>(c + a.min_count) : 0;
        lv[j] = cmd ? static_cast<int32_t>(l) : 0;
        if (kDeep) {
          const uint32_t u = bits_at(st_lut, (k0 + j) * kLutWidth, kLutWidth);
          if (run && a.cnt_bits && c == cmax) cm |= 1u << j;
          if (cmd && a.lit_bits && l == lmax) lm |= 1u << j;
          if (run && u == 0) mm |= 1u << j;
          sv[j >> 2] |= (u ? dict[u - 1] : 0u) << (8 * (j & 3));
        }
      }
      int4* co = reinterpret_cast<int4*>(a.count + out_row + i0);
      int4* lo = reinterpret_cast<int4*>(a.lit_len + out_row + i0);
      co[0] = make_int4(cv[0], cv[1], cv[2], cv[3]);
      co[1] = make_int4(cv[4], cv[5], cv[6], cv[7]);
      lo[0] = make_int4(lv[0], lv[1], lv[2], lv[3]);
      lo[1] = make_int4(lv[4], lv[5], lv[6], lv[7]);
      if (kDeep)
        *reinterpret_cast<uint2*>(a.sym + out_row + i0) =
            make_uint2(sv[0], sv[1]);
    }
    if (kDeep) {
      // the three populations in 21-bit fields: a warp scan, then the
      // warps' totals through shared memory
      const unsigned long long own =
          __popc(cm) | static_cast<unsigned long long>(__popc(lm)) << kField |
          static_cast<unsigned long long>(__popc(mm)) << (2 * kField);
      unsigned long long v = own;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned long long t = __shfl_up_sync(0xffffffffu, v, d);
        if (lane >= d) v += t;
      }
      if (lane == 31) warp_sum[warp] = v;
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();   // the warp sums and the overflow windows
      unsigned long long before = v - own, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const unsigned long long s = warp_sum[w];
        if (w < warp) before += s;
        total += s;
      }
      const int rc = carry_c + static_cast<int>(before & kFieldMask);
      const int rl = carry_l + static_cast<int>(before >> kField & kFieldMask);
      const int rm = carry_m + static_cast<int>(before >> (2 * kField));
      carry_c += static_cast<int>(total & kFieldMask);
      carry_l += static_cast<int>(total >> kField & kFieldMask);
      carry_m += static_cast<int>(total >> (2 * kField));
      // escape j of a mask takes the value at rank base + (set bits below
      // j), from the staged window (a rank never passes its index, so the
      // clamp to cap - 1 keeps it there too)
      if (a.cov_bits) {
        for (unsigned m = cm; m; m &= m - 1) {
          const int j = __ffs(m) - 1;
          const int r = min(rc + __popc(cm & ((1u << j) - 1u)), cap - 1);
          a.count[out_row + i0 + j] = static_cast<int32_t>(
              bits_at(st_cov, static_cast<int>(
                                  static_cast<int64_t>(r) * a.cov_bits -
                                  8 * cov0),
                      a.cov_bits) +
              a.min_count);
        }
      }
      if (a.lov_bits) {
        for (unsigned m = lm; m; m &= m - 1) {
          const int j = __ffs(m) - 1;
          const int r = min(rl + __popc(lm & ((1u << j) - 1u)), cap - 1);
          a.lit_len[out_row + i0 + j] = static_cast<int32_t>(
              bits_at(st_lov, static_cast<int>(
                                  static_cast<int64_t>(r) * a.lov_bits -
                                  8 * lov0),
                      a.lov_bits));
        }
      }
      for (unsigned m = mm; m; m &= m - 1) {
        const int j = __ffs(m) - 1;
        const int r = min(rm + __popc(mm & ((1u << j) - 1u)), cap - 1);
        a.sym[out_row + i0 + j] =
            reinterpret_cast<const uint8_t*>(st_miss)[r - miss0];
      }
    }
  }
  if (kDeep && threadIdx.x == 0) {
    int f = 0;
    if (a.n_cnt_ovf && a.cnt_bits) f |= carry_c != a.n_cnt_ovf[b];
    if (a.n_ll_ovf && a.lit_bits) f |= carry_l != a.n_ll_ovf[b];
    if (a.n_miss) f |= carry_m != a.n_miss[b];
    a.bad[b] = f;
  }
}

// Launches the kernel of one layout with its dynamic shared memory (above
// 48 KB only for wide sections, after raising the kernel's limit on the
// current device).
template <bool kDeep>
cudaError_t launch(const Params& a, int64_t nb, cudaStream_t s) {
  const int smem = smem_bytes(kDeep, a.cnt_bits, a.lit_bits, a.cov_bits,
                              a.lov_bits);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        unpack_resolve_kernel<kDeep>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  unpack_resolve_kernel<kDeep>
      <<<static_cast<unsigned>(nb), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`: nb CTAs of kThreads.  Sections are row-major u8
// [nb, s_*] (row bytes s_*), values of *_bits bits each (0..25); miss u8
// [nb, cap]; dict7 u8 [nb, 7]; n_cmds, n_cnt_ovf, n_ll_ovf, n_miss i32 [nb]
// (the last three may be null); outputs count, lit_len i32 and sym u8
// [nb, cap] (16- and 8-byte aligned rows), bad i32 [nb].  `lut` null is
// the flat layout: cnt_ovf, ll_ovf, miss, dict7, sym and bad are then not
// read or written.  Each section must hold the 4-byte window of its last
// value (cap values).  cap % 8 == 0.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments out of range.
int hrt1_unpack_resolve(const void* cnts, const void* lls, const void* cnt_ovf,
                        const void* ll_ovf, const void* lut, const void* miss,
                        const void* dict7, const void* n_cmds,
                        const void* n_cnt_ovf, const void* n_ll_ovf,
                        const void* n_miss, void* count, void* lit_len,
                        void* sym, void* bad, int64_t nb, int32_t cap,
                        int32_t s_cnt, int32_t s_ll, int32_t s_cov,
                        int32_t s_lov, int32_t s_lut, int32_t cnt_bits,
                        int32_t lit_bits, int32_t cov_bits, int32_t lov_bits,
                        int32_t min_count, void* stream) {
  const int32_t widths[4] = {cnt_bits, lit_bits, cov_bits, lov_bits};
  for (int32_t w : widths)
    if (w < 0 || w > kMaxWidth) return static_cast<int>(cudaErrorInvalidValue);
  if (cap < 0 || cap % kPer || nb < 0 || nb > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  Params a{};
  a.cnts = static_cast<const uint8_t*>(cnts);
  a.lls = static_cast<const uint8_t*>(lls);
  a.cnt_ovf = static_cast<const uint8_t*>(cnt_ovf);
  a.ll_ovf = static_cast<const uint8_t*>(ll_ovf);
  a.lut = static_cast<const uint8_t*>(lut);
  a.miss = static_cast<const uint8_t*>(miss);
  a.dict7 = static_cast<const uint8_t*>(dict7);
  a.n_cmds = static_cast<const int32_t*>(n_cmds);
  a.n_cnt_ovf = static_cast<const int32_t*>(n_cnt_ovf);
  a.n_ll_ovf = static_cast<const int32_t*>(n_ll_ovf);
  a.n_miss = static_cast<const int32_t*>(n_miss);
  a.count = static_cast<int32_t*>(count);
  a.lit_len = static_cast<int32_t*>(lit_len);
  a.sym = static_cast<uint8_t*>(sym);
  a.bad = static_cast<int32_t*>(bad);
  a.cap = cap;
  a.s_cnt = s_cnt;
  a.s_ll = s_ll;
  a.s_cov = s_cov;
  a.s_lov = s_lov;
  a.s_lut = s_lut;
  a.cnt_bits = cnt_bits;
  a.lit_bits = lit_bits;
  a.cov_bits = cov_bits;
  a.lov_bits = lov_bits;
  a.min_count = min_count;
  if (nb == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(a.lut ? launch<true>(a, nb, s)
                                : launch<false>(a, nb, s));
}

}  // extern "C"
