// hrt1_encode: bytes -> planar HRT1 command columns + compacted literals.
//
// Replaces the Pallas encode kernel hypersonic_rle_kit_tpu/ops/encode_sup.py
// (_encode_body, launched from encode_blocks_kernel).  That kernel is a
// network of rolls, window morphology and triangular MXU matmuls because the
// TPU has no scatter and no fast scan.  Hopper has both, so this kernel
// computes the same columns directly.  Per block of n = block_len bytes:
//
//   runs are the maximal stretches of equal bytes inside [0, n) (bytes past
//   n never join a run); a run is emitted iff its length >= min_count and,
//   under Single (only_sym >= 0), its byte == only_sym.  Command k is the
//   k-th emitted run: sym, count = its length, lit_len = its start minus the
//   previous emitted run's end.  Command n_runs is the tail: count 0,
//   lit_len = n minus the last emitted end.  n_cmds = n_runs + 1.  Literals
//   are the bytes outside emitted runs, in order.  Columns are zero past
//   n_cmds and literals zero past n_lits.
//
// Bound: memory.  Each input byte is read once and each output byte (the
// literal row and the columns, padding included) written once; the
// arithmetic is bit-parallel run detection and a scan per tile.  Design:
//
//   * Work units are (16 KiB tile, block) pairs, handed out tile-major by an
//     atomic ticket to persistent CTAs: a block's tiles run on many SMs, a
//     tile's predecessors were handed out before it and are running or
//     done even if not every CTA is resident, and with many blocks a
//     tile's predecessor was handed out a whole round of tickets earlier,
//     so its prefix is usually published by the time it is needed (block-
//     major order made tiles wait on neighbours started moments before
//     them: 0.22 against 0.19 ms on the 64 MiB DCT blocks).  A CTA
//     stages its next tile (and the 16 bytes after it) in shared memory
//     with a TMA bulk copy (cp.async.bulk + mbarrier, two buffers) while it
//     works on the current one, so x is read from HBM exactly once.
//   * Threads own 32 contiguous bytes.  A run ends at q when q == n - 1 or
//     x[q] != x[q + 1] (byte compares four at a time into a 32-bit mask);
//     its start is the previous run end, and it is emitted iff no end lies
//     in the min_count - 1 bytes before its last (mask shifts) and, under
//     Single, its byte matches.  A run's emission needs its start, which for
//     the tile's first run lies
//     in an earlier tile.  Tiles of one block therefore chain a single-pass
//     decoupled look-back: each tile publishes its summary with the first
//     run unresolved (first end and byte, last end, emitted runs after the
//     first), then its inclusive prefix once it knows it; a successor
//     composes summaries backwards, 32 tiles a round trip, until it meets a
//     prefix.  Inside a tile the same summaries are composed over threads
//     and warps (warp shuffles, one warp for the tile), so a tile costs four
//     barriers.
//   * Commands are written at their index; the tile's literals are
//     compacted in shared memory (a literal's offset is its position minus
//     the bytes covered before it) and leave with 16-byte stores.  Whether
//     the run open at the tile's end is emitted is read off the next few
//     bytes of x (up to min_count of them, staged after the tile).
//   * Padding is split so every tile writes its own share: tile t also
//     zeroes (its row bytes - its literals) literal bytes and (its command
//     budget - its commands) column slots, both counted back from the row
//     end, which partitions [n_lits, B) and [n_cmds, cap) exactly.  The
//     budget of a tile is ceil(len / min_count) (1 + (cnt - 1) * min_count
//     <= len bounds its commands), the tail tile's the rest of cap.  A block
//     whose budgets exceed cap (a capacity below ~B/min_count + tiles) has
//     its column padding written by its tail tile instead.
//
// A block with more than cap commands writes only the first cap; n_cmds
// still holds the true count, and the wrapper raises.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 32;                  // bytes per thread per tile
constexpr int kTile = kThreads * kItems;    // 16 KiB
constexpr int kRec = 16;                    // ints per tile record
constexpr int kHalo = 16;                   // bytes staged after a tile
constexpr int kBuf = kTile + kHalo;         // a tile and the bytes after it
constexpr int kSmem = 2 * kBuf + kTile + 32;  // two input buffers + literals
constexpr unsigned kFull = 0xffffffffu;

struct Emit {
  int cnt;  // emitted runs
  int cov;  // bytes they cover
  int end;  // exclusive end of the last one (0 if none)
};

__device__ __forceinline__ Emit add(Emit a, Emit b) {
  return Emit{a.cnt + b.cnt, a.cov + b.cov, a.end > b.end ? a.end : b.end};
}

// Summary of consecutive tiles whose first run's start is not known yet.
struct Sum {
  int has;    // a run ends in them
  int f_end;  // end of the first run ending in them, and its byte
  int f_sym;
  int l_end;  // end of the last run ending in them
  Emit rest;  // emitted runs after the first
};

// Summary of the tiles from the block's start: every run is resolved.
struct Pre {
  int has;    // a run ends in them
  int l_end;  // end of the last one
  Emit e;     // emitted runs
};

__device__ __forceinline__ bool emitted(int len, int sym, int mc, int osym) {
  return len >= mc && (osym < 0 || sym == osym);
}

// a, then b
__device__ Sum compose(const Sum& a, const Sum& b, int mc, int osym) {
  if (!a.has) return b;
  if (!b.has) return a;
  const int len = b.f_end - a.l_end;
  const Emit mid = emitted(len, b.f_sym, mc, osym) ? Emit{1, len, b.f_end}
                                                   : Emit{0, 0, 0};
  return Sum{1, a.f_end, a.f_sym, b.l_end, add(add(a.rest, mid), b.rest)};
}

// p, then a
__device__ Pre resolve(const Pre& p, const Sum& a, int mc, int osym) {
  if (!a.has) return p;
  const int len = a.f_end - (p.has ? p.l_end : 0);
  const Emit first = emitted(len, a.f_sym, mc, osym) ? Emit{1, len, a.f_end}
                                                     : Emit{0, 0, 0};
  return Pre{1, a.l_end, add(add(p.e, first), a.rest)};
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// record: [0] flag (1 summary, 2 prefix), [1..7] Sum, [8..12] Pre
__device__ void publish_sum(int* rec, const Sum& s) {
  volatile int* r = rec;
  r[1] = s.has; r[2] = s.f_end; r[3] = s.f_sym; r[4] = s.l_end;
  r[5] = s.rest.cnt; r[6] = s.rest.cov; r[7] = s.rest.end;
  st_release(rec, 1);
}

__device__ void publish_pre(int* rec, const Pre& p) {
  volatile int* r = rec;
  r[8] = p.has; r[9] = p.l_end; r[10] = p.e.cnt; r[11] = p.e.cov;
  r[12] = p.e.end;
  st_release(rec, 2);
}

__device__ __forceinline__ Sum shfl_up_sum(const Sum& v, int d) {
  return Sum{__shfl_up_sync(kFull, v.has, d), __shfl_up_sync(kFull, v.f_end, d),
             __shfl_up_sync(kFull, v.f_sym, d),
             __shfl_up_sync(kFull, v.l_end, d),
             Emit{__shfl_up_sync(kFull, v.rest.cnt, d),
                  __shfl_up_sync(kFull, v.rest.cov, d),
                  __shfl_up_sync(kFull, v.rest.end, d)}};
}

__device__ __forceinline__ Sum shfl_sum(const Sum& v, int src) {
  return Sum{__shfl_sync(kFull, v.has, src), __shfl_sync(kFull, v.f_end, src),
             __shfl_sync(kFull, v.f_sym, src), __shfl_sync(kFull, v.l_end, src),
             Emit{__shfl_sync(kFull, v.rest.cnt, src),
                  __shfl_sync(kFull, v.rest.cov, src),
                  __shfl_sync(kFull, v.rest.end, src)}};
}

// Exclusive prefix of tile t from the records of tiles 0..t-1, by one warp:
// lane i reads tile top - i, so 32 predecessors cost one round trip; the
// nearest published prefix ends the walk (tile 0 publishes its prefix at
// once, so the walk ends there at the latest).  The result is in lane 0.
__device__ Pre look_back(int* recs, int t, int mc, int osym) {
  const int lane = threadIdx.x & 31;
  Sum acc{0, 0, 0, 0, Emit{0, 0, 0}};   // tiles after the window, composed
  for (int top = t - 1;; top -= 32) {
    const int j = top - lane;
    int f = 0;
    Sum a{0, 0, 0, 0, Emit{0, 0, 0}};
    Pre p{0, 0, Emit{0, 0, 0}};
    if (j >= 0) {
      int* rec = recs + static_cast<int64_t>(j) * kRec;
      for (long long spins = 0; (f = ld_acquire(rec)) == 0; ++spins) {
        if (spins > (1ll << 26)) __trap();  // a predecessor never published
        __nanosleep(32);
      }
      volatile int* r = rec;
      if (f == 2) p = Pre{r[8], r[9], Emit{r[10], r[11], r[12]}};
      else a = Sum{r[1], r[2], r[3], r[4], Emit{r[5], r[6], r[7]}};
    }
    const unsigned pre = __ballot_sync(kFull, f == 2);
    // lanes before the nearest prefix (or all 32) hold summaries; compose
    // them in tile order: the highest such lane is the earliest tile
    const int k = pre ? __ffs(pre) - 1 : 32;
    Sum win{0, 0, 0, 0, Emit{0, 0, 0}};
    for (int i = k - 1; i >= 0; --i)
      win = compose(win, shfl_sum(a, i), mc, osym);
    acc = compose(win, acc, mc, osym);
    if (pre) {
      const Pre pk{__shfl_sync(kFull, p.has, k), __shfl_sync(kFull, p.l_end, k),
                   Emit{__shfl_sync(kFull, p.e.cnt, k),
                        __shfl_sync(kFull, p.e.cov, k),
                        __shfl_sync(kFull, p.e.end, k)}};
      return resolve(pk, acc, mc, osym);
    }
  }
}

// Inclusive and exclusive scans of Sums across a warp (lane order is
// tile order).
__device__ void warp_scan(const Sum& v, int mc, int osym, Sum* inc,
                          Sum* exc) {
  const int lane = threadIdx.x & 31;
  Sum x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Sum o = shfl_up_sum(x, d);
    if (lane >= d) x = compose(o, x, mc, osym);
  }
  *inc = x;
  *exc = shfl_up_sum(x, 1);
  if (lane == 0) *exc = Sum{0, 0, 0, 0, Emit{0, 0, 0}};
}

// Bits 0-3 set where bytes 0-3 of a __vcmp*4 result are 0xff.
__device__ __forceinline__ unsigned nib(uint32_t m) {
  return (((m & 0x01010101u) * 0x204081u) >> 21) & 0xfu;
}

// Start of the run ending at bit i of a thread's bytes (q0 + i is its last
// byte).  `ends` holds the thread's run ends in bits 32-63 and the end of
// the previous run, when it lies within 32 bytes before q0, in bits 0-31;
// without an earlier end in the window the start is `far`.
__device__ __forceinline__ int start_of(uint64_t ends, int i, int q0,
                                        int far) {
  const uint64_t below = ends & ((1ull << (i + 32)) - 1ull);
  return below ? q0 - 32 + (64 - __clzll(below)) : far;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// into shared memory, completing on `bar`.  One thread issues it.
__device__ void bulk_load(void* dst, const void* src, unsigned bytes,
                          uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ void wait_parity(uint64_t* bar, unsigned parity) {
  unsigned ok = 0;
  while (!ok) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(ok) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// dst[lo, hi) = src[0, hi - lo) (src in shared memory, 16 bytes of slack
// past its end), or zeros when src is null: byte stores up to the first
// 16-byte boundary of dst, 16-byte stores, byte stores after the last.
__device__ void store_range(uint8_t* dst, int64_t lo, int64_t hi,
                            const uint8_t* src) {
  if (hi <= lo) return;
  uint8_t* d = dst + lo;
  const int64_t n = hi - lo;
  const int64_t mis = (16 - (reinterpret_cast<uintptr_t>(d) & 15)) & 15;
  const int64_t head = mis < n ? mis : n;
  const int64_t body = (n - head) >> 4;
  const int64_t tail0 = head + (body << 4);
  for (int64_t i = threadIdx.x; i < head; i += kThreads)
    d[i] = src ? src[i] : 0;
  for (int64_t i = tail0 + threadIdx.x; i < n; i += kThreads)
    d[i] = src ? src[i] : 0;
  uint4* dv = reinterpret_cast<uint4*>(d + head);
  if (src == nullptr) {
    for (int64_t v = threadIdx.x; v < body; v += kThreads)
      dv[v] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(
      reinterpret_cast<uintptr_t>(src + head) & ~uintptr_t(3));
  const unsigned sh = 8u * ((reinterpret_cast<uintptr_t>(src) + head) & 3);
  for (int64_t v = threadIdx.x; v < body; v += kThreads) {
    const uint32_t* s = sw + 4 * v;
    dv[v] = make_uint4(__funnelshift_r(s[0], s[1], sh),
                       __funnelshift_r(s[1], s[2], sh),
                       __funnelshift_r(s[2], s[3], sh),
                       __funnelshift_r(s[3], s[4], sh));
  }
}

__global__ void __launch_bounds__(kThreads, 2)
hrt1_encode_kernel(const uint8_t* __restrict__ x,
                   const int32_t* __restrict__ block_len,
                   const int32_t* __restrict__ only_sym,
                   uint8_t* __restrict__ sym, int32_t* __restrict__ count,
                   int32_t* __restrict__ lit_len, uint8_t* __restrict__ lits,
                   int32_t* __restrict__ n_cmds, int32_t* __restrict__ n_lits,
                   int32_t* __restrict__ state, int64_t nb, int B, int cap,
                   int mc, int vec) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* const lbuf = smem + 2 * kBuf;
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ long long s_unit[2];
  __shared__ int s_len[2], s_osym[2];     // the units' block_len, only_sym
  __shared__ Sum s_wsum[kWarps];          // each warp's summary
  __shared__ Pre s_wpre[kWarps];          // the prefix before each warp
  __shared__ int s_wnext[kWarps];         // fate of the run open at its end
  __shared__ int s_lo, s_hi, s_zlo, s_zhi;

  const int nt = (B + kTile - 1) / kTile;
  const long long units = nb * nt;
  unsigned long long* ticket = reinterpret_cast<unsigned long long*>(state);
  int* recs_all = state + 4;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // Claims unit u for the slot `slot` of the two-deep pipeline: its block's
  // length and Single byte, and the TMA copy of its tile.
  auto claim = [&](long long u, int slot) {
    s_unit[slot] = u;
    if (u >= units) return;
    const int64_t b = u % nb;
    s_len[slot] = block_len[b];
    s_osym[slot] = only_sym != nullptr ? only_sym[b] : -1;
    if (vec) {
      const int t0 = static_cast<int>(u / nb) * kTile;
      bulk_load(smem + slot * kBuf, x + b * B + t0, min(kBuf, B - t0),
                &bar[slot]);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(&bar[i])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    claim(static_cast<long long>(atomicAdd(ticket, 1ull)), 0);
  }
  __syncthreads();

  for (int it = 0;; ++it) {
    const int cur = it & 1;
    const long long u = s_unit[cur];
    if (u >= units) break;
    // the next unit's ticket; its latency hides behind this tile's scans
    unsigned long long next = 0;
    if (tid == 32) next = atomicAdd(ticket, 1ull);
    const int64_t b = u % nb;
    const int t = static_cast<int>(u / nb);
    const int t0 = t * kTile;
    const int tl = min(kTile, B - t0);           // the tile's row bytes
    const int bl = s_len[cur];
    const int n = bl < 0 ? 0 : (bl > B ? B : bl);
    const int osym = s_osym[cur];
    const int tv0 = min(t0, n);
    const int v1 = max(0, min(n - t0, tl));       // valid bytes in the tile
    const int t1 = tv0 + v1;
    const uint8_t* xr = x + b * B;
    uint8_t* buf = smem + cur * kBuf;    // x[t0, t0 + kBuf), as far as B
    int* recs = recs_all + b * nt * kRec;
    if (vec) {
      wait_parity(&bar[cur], (it >> 1) & 1);
    } else {
      for (int i = tid; i < min(v1 + kHalo, n - t0); i += kThreads)
        buf[i] = xr[t0 + i];
      __syncthreads();
    }

    // ---- run ends of my 32 bytes, bit-parallel ----
    const int o = tid * kItems;
    const int q0 = t0 + o;
    uint32_t w[8];
    {
      const uint4 a = *reinterpret_cast<const uint4*>(buf + o);
      const uint4 c = *reinterpret_cast<const uint4*>(buf + o + 16);
      w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
      w[4] = c.x; w[5] = c.y; w[6] = c.z; w[7] = c.w;
    }
    const uint32_t after = q0 + kItems < n ? buf[o + kItems] : 0u;
    const int nv = max(0, min(n - q0, kItems));  // my valid bytes
    const unsigned vm = nv >= 32 ? kFull : (1u << nv) - 1u;
    unsigned ends = 0, symm = osym < 0 ? kFull : 0u;
    const uint32_t rep = 0x01010101u * static_cast<uint32_t>(osym & 0xff);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t nx = (w[k] >> 8) | ((k < 7 ? w[k + 1] : after) << 24);
      ends |= nib(__vcmpne4(w[k], nx)) << (4 * k);
      if (osym >= 0 && osym < 256)
        symm |= nib(__vcmpeq4(w[k], rep)) << (4 * k);
    }
    ends &= vm;
    if (n - 1 >= q0 && n - 1 < q0 + kItems) ends |= 1u << (n - 1 - q0);

    // emitted runs ending at bits of `e64` (bits 32-63: my ends; bits 0-31:
    // the previous run's last byte, when within 32 bytes): length >= mc,
    // no end in the mc - 1 bytes before their last byte
    auto emitted_ends = [&](uint64_t e64, int far) -> unsigned {
      unsigned longm = 0;
      if (mc <= 32) {
        uint64_t near = 0;
        for (int d = 1; d < mc; ++d) near |= e64 << d;
        longm = static_cast<unsigned>((e64 & ~near) >> 32);
      } else {
        for (unsigned m = ends; m; m &= m - 1) {
          const int i = __ffs(m) - 1;
          if (q0 + i + 1 - start_of(e64, i, q0, far) >= mc) longm |= 1u << i;
        }
      }
      return longm & symm & ends;
    };

    // ---- my summary: the runs after my first have their start here ----
    Sum me{0, 0, 0, 0, Emit{0, 0, 0}};
    if (ends) {
      const uint64_t e_loc = static_cast<uint64_t>(ends) << 32;
      const unsigned rest_m = emitted_ends(e_loc, 0) & (ends & (ends - 1));
      me = Sum{1, q0 + __ffs(ends), buf[o + __ffs(ends) - 1],
               q0 + 32 - __clz(ends), Emit{__popc(rest_m), 0, 0}};
      for (unsigned m = rest_m; m; m &= m - 1) {
        const int i = __ffs(m) - 1;
        me.rest.cov += q0 + i + 1 - start_of(e_loc, i, q0, 0);
        me.rest.end = q0 + i + 1;
      }
    }
    Sum w_inc, w_exc;                    // over the lanes of my warp
    warp_scan(me, mc, osym, &w_inc, &w_exc);
    if (lane == 31) s_wsum[warp] = w_inc;
    __syncthreads();
    if (tid == 32) claim(static_cast<long long>(next), cur ^ 1);  // as warp 0
                                                                 // looks back

    // ---- warp 0: the tile's summary, its prefix (decoupled look-back over
    // the block's tiles) and the prefix before each warp ----
    if (warp == 0) {
      const Sum mine = lane < kWarps ? s_wsum[lane]
                                     : Sum{0, 0, 0, 0, Emit{0, 0, 0}};
      Sum t_inc, t_exc;
      warp_scan(mine, mc, osym, &t_inc, &t_exc);
      const Sum tile = shfl_sum(t_inc, kWarps - 1);
      int* rec = recs + static_cast<int64_t>(t) * kRec;
      Pre p{0, 0, Emit{0, 0, 0}};
      if (t > 0) {
        if (lane == 0) publish_sum(rec, tile);
        p = look_back(recs, t, mc, osym);
      }
      const int sin = p.has ? p.l_end : 0;
      const Pre inc = resolve(p, tile, mc, osym);
      // is the run open at the tile's end emitted?  it continues into the
      // staged bytes after the tile (then into x) while they equal its byte
      const int s_tr = tile.has ? tile.l_end : sin;
      int trail = 0;
      if (lane == 0 && t1 < n && s_tr != t1) {
        const uint8_t c = buf[v1 - 1];
        const int need = mc - (t1 - s_tr);
        int k = 0;
        while (k < need && k < kHalo && t1 + k < n && buf[v1 + k] == c) ++k;
        if (k == kHalo)
          while (k < need && t1 + k < n && xr[t1 + k] == c) ++k;
        trail = k >= need && (osym < 0 || c == osym);
      }
      trail = __shfl_sync(kFull, trail, 0);
      // per warp: its prefix, the fate of its first run, and of the first
      // run ending after it
      const Pre wp = resolve(p, t_exc, mc, osym);
      const bool w_first = mine.has && emitted(
          mine.f_end - (wp.has ? wp.l_end : 0), mine.f_sym, mc, osym);
      const unsigned has_w = __ballot_sync(kFull, mine.has != 0);
      const unsigned em_w = __ballot_sync(kFull, w_first);
      const unsigned higher = has_w & ~((2u << lane) - 1u);
      if (lane < kWarps) {
        s_wpre[lane] = wp;
        s_wnext[lane] = higher ? (em_w >> (__ffs(higher) - 1)) & 1 : trail;
      }
      if (lane == 0) {
        publish_pre(rec, inc);
        const bool open_em = tile.has
            ? emitted(tile.f_end - sin, tile.f_sym, mc, osym) : trail != 0;
        s_lo = tv0 - (p.e.cov + (open_em ? tv0 - sin : 0));
        s_hi = t1 - (inc.e.cov + (trail ? t1 - s_tr : 0));
        const int tt = n > 0 ? (n - 1) / kTile : 0;
        const int nc = inc.e.cnt + 1;
        if (t == tt) {                   // the tail command and the counts
          n_cmds[b] = nc;
          n_lits[b] = n - inc.e.cov;
          if (inc.e.cnt < cap) {
            sym[b * cap + inc.e.cnt] = 0;
            count[b * cap + inc.e.cnt] = 0;
            lit_len[b * cap + inc.e.cnt] = n - inc.e.end;
          }
        }
        // column slots this tile zeroes, counted back from cap
        const int per = (kTile + mc - 1) / mc;
        const int rem = n % kTile;
        const bool split =
            (n / kTile) * per + (rem ? (rem + mc - 1) / mc : 0) + 1 <= cap;
        int zlo = cap, zhi = cap;
        if (split && t <= tt) {
          const int bx = t * per;                      // budgets before
          const int bt = t < tt ? per : cap - bx;      // this tile's budget
          const int ct = inc.e.cnt - p.e.cnt + (t == tt);
          zlo = cap - (bx + bt - p.e.cnt - ct);
          zhi = cap - (bx - p.e.cnt);
        } else if (!split && t == tt && nc < cap) {
          zlo = nc;
        }
        s_zlo = zlo;
        s_zhi = zhi;
      }
    }
    __syncthreads();

    // ---- my commands, and my literals into shared memory ----
    const Pre mp = resolve(s_wpre[warp], w_exc, mc, osym);
    const int sp = mp.has ? mp.l_end : 0;     // start of the run at q0
    uint64_t e64 = static_cast<uint64_t>(ends) << 32;
    if (sp > q0 - 32) e64 |= 1ull << (sp - q0 + 31);
    const unsigned emits = ends ? emitted_ends(e64, sp) : 0u;
    unsigned covm = 0;                        // bytes inside emitted runs
    {
      Emit run = mp.e;
      for (unsigned m = emits; m; m &= m - 1) {
        const int i = __ffs(m) - 1;
        const int e = q0 + i + 1;
        const int st = start_of(e64, i, q0, sp);
        const int64_t k = run.cnt;
        if (k < cap) {
          sym[b * cap + k] = buf[o + i];
          count[b * cap + k] = e - st;
          lit_len[b * cap + k] = st - run.end;
        }
        run = add(run, Emit{1, e - st, e});
        const int lo_bit = st > q0 ? st - q0 : 0;
        covm |= ((2u << i) - 1u) & ~((1u << lo_bit) - 1u);
      }
    }
    // fate of the run open at my end: the first run ending after my bytes
    const bool my_first = (emits & ends & (0u - ends)) != 0;
    bool nxt_em;
    {
      const unsigned has_m = __ballot_sync(kFull, ends != 0);
      const unsigned em_m = __ballot_sync(kFull, my_first);
      const unsigned higher = has_m & ~((2u << lane) - 1u);
      nxt_em = higher ? (em_m >> (__ffs(higher) - 1)) & 1
                      : s_wnext[warp] != 0;
    }
    if (nxt_em) covm |= ends ? ~((2u << (31 - __clz(ends))) - 1u) : kFull;
    // literal p goes to p - (bytes covered before p) - lo
    {
      const bool q0_em = ends ? my_first : nxt_em;
      const int idx0 = q0 - (mp.e.cov + (q0_em ? q0 - sp : 0)) - s_lo;
      const unsigned lm = ~covm & vm;
      if (lm == kFull && (idx0 & 3) == 0) {
        uint32_t* d = reinterpret_cast<uint32_t*>(lbuf + idx0);
#pragma unroll
        for (int k = 0; k < 8; ++k) d[k] = w[k];
      } else {
        int idx = idx0;
        for (unsigned m = lm; m; m &= m - 1)
          lbuf[idx++] = buf[o + __ffs(m) - 1];
      }
    }
    __syncthreads();

    // ---- literals and this tile's share of the padding, 16-byte stores ----
    uint8_t* lrow = lits + b * B;
    const int lo = s_lo, hi = s_hi;
    store_range(lrow, lo, hi, lbuf);
    store_range(lrow, B - (t0 + tl - hi), B - (t0 - lo), nullptr);
    const int zlo = s_zlo, zhi = s_zhi;
    store_range(sym + b * cap, zlo, zhi, nullptr);
    store_range(reinterpret_cast<uint8_t*>(count + b * cap), 4ll * zlo,
                4ll * zhi, nullptr);
    store_range(reinterpret_cast<uint8_t*>(lit_len + b * cap), 4ll * zlo,
                4ll * zhi, nullptr);
    __syncthreads();  // buffers, lbuf and the broadcast slots are reused
  }
}

// Persistent CTAs the current device holds at once.  The shared-memory
// attribute applies to one device only, so it is set, and the grid sized,
// per device before that device's first launch; host threads launching for
// the first time at once take the lock in turn.
cudaError_t grid_cap(int64_t* out) {
  constexpr int kMaxDevices = 64;
  static std::mutex mu;
  static int64_t ctas[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (ctas[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaFuncSetAttribute(hrt1_encode_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, hrt1_encode_kernel, kThreads, kSmem);
    if (e != cudaSuccess) return e;
    ctas[dev] = int64_t(per_sm < 1 ? 1 : per_sm) * sms;
  }
  *out = ctas[dev];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Ints of the zeroed `state` an (nb, B) launch needs: the work ticket and
// one look-back record per (block, tile).
int64_t hrt1_encode_state_ints(int64_t nb, int32_t B) {
  return 4 + nb * ((B + kTile - 1) / kTile) * kRec;
}

// Launch on `stream`: persistent CTAs of kThreads over the (block, tile)
// pairs.  Shapes (row-major, contiguous): x u8 [nb, B]; block_len i32 [nb];
// only_sym i32 [nb] or null (no Single filter); outputs sym u8, count,
// lit_len i32 [nb, cap], lits u8 [nb, B], n_cmds, n_lits i32 [nb]; state
// i32 [hrt1_encode_state_ints(nb, B)], zeroed.  `vec` != 0 stages tiles
// with TMA (x 16-byte aligned, B % 16 == 0); else threads copy them.
// Returns cudaGetLastError() after the launch.
int hrt1_encode(const void* x, const void* block_len, const void* only_sym,
                void* sym, void* count, void* lit_len, void* lits,
                void* n_cmds, void* n_lits, void* state, int64_t nb,
                int32_t B, int32_t cap, int32_t min_count, int32_t vec,
                void* stream) {
  int64_t cap_ctas = 0;
  const cudaError_t e = grid_cap(&cap_ctas);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t units = nb * ((B + kTile - 1) / kTile);
  if (units > 0) {
    const int64_t grid = units < cap_ctas ? units : cap_ctas;
    hrt1_encode_kernel<<<static_cast<unsigned>(grid), kThreads, kSmem,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<const int32_t*>(block_len),
        static_cast<const int32_t*>(only_sym), static_cast<uint8_t*>(sym),
        static_cast<int32_t*>(count), static_cast<int32_t*>(lit_len),
        static_cast<uint8_t*>(lits), static_cast<int32_t*>(n_cmds),
        static_cast<int32_t*>(n_lits), static_cast<int32_t*>(state), nb, B,
        cap, min_count, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
