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
// and a copy per command.  Design, two grids on one stream:
//
//   1. Starts: exclusive scans of (lit_len + count) and lit_len give every
//      command's output start and literal start (a global scratch row,
//      2 x C int32).  Chunks of 4096 commands are scanned by persistent
//      CTAs (coalesced loads transposed through shared memory) and chained
//      by a decoupled look-back, so a block of many commands (a one-block
//      Low Entropy stream) spreads over the card.  The same pass records,
//      for every 16 KiB output tile, the command that holds the tile's
//      first byte and the literal offset there: the merge-path split of
//      the output over the commands and the literals.
//   2. Fill (persistent CTAs over all (block, tile) pairs, so a long block
//      spreads over the card): a tile's commands [c_lo, c_hi] and its
//      contiguous literal span come from that table, read one tile ahead,
//      and the span is staged in shared memory with word loads while each
//      thread loads its command.  Each thread takes one command (coalesced
//      column reads, no search) and writes its literals and its run, clipped
//      to the tile, into a shared-memory copy of the tile: runs as word
//      splats, literals as funnel-shifted word copies, bytes only at the
//      edges.  Pieces of kLong bytes or more are queued and written by the
//      whole CTA, so one long run or literal stretch does not hold a thread
//      back.  The tile then leaves in 16-byte stores, zero past block_len.
//
// Hostile input cannot drive an access out of bounds: negative fields count
// as 0, every prefix saturates at B, literal reads stay inside the literal
// row, and only commands < min(n_cmds, C) are read.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 512;              // starts pass
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                  // commands per thread per tile
constexpr int kTile = kThreads * kItems;
constexpr int kFillThreads = 256;          // fill pass
constexpr int kOut = 16384;                // output bytes per fill tile
constexpr int kLong = 256;                 // pieces the whole CTA writes
constexpr int kNone = 0x7fffffff;

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

__device__ __forceinline__ uint64_t ld_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.gpu.global.b64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int ld_acquire32(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(uint64_t* p, uint64_t v) {
  asm volatile("st.release.gpu.global.b64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// A chunk's record: flag (1 sums of the chunk, 2 sums from the block's
// start) in bits 62-63, output bytes in bits 31-61, literal bytes in 0-30.
__device__ __forceinline__ uint64_t pack(int flag, Pair v) {
  return (uint64_t(flag) << 62) | (uint64_t(v.a) << 31) | uint64_t(v.b);
}

// Exclusive prefix of chunk ch from the records of chunks 0..ch-1, by one
// warp (lane i reads chunk top - i); chunk 0 publishes its prefix at once.
__device__ Pair look_back(const uint64_t* recs, int ch, int cap) {
  const int lane = threadIdx.x & 31;
  Pair acc{0, 0};
  for (int top = ch - 1;; top -= 32) {
    const int j = top - lane;
    uint64_t r = 0;
    if (j >= 0) {
      for (long long spins = 0; (r = ld_acquire(recs + j)) == 0; ++spins) {
        if (spins > (1ll << 26)) __trap();  // a predecessor never published
        __nanosleep(32);
      }
    }
    const int flag = static_cast<int>(r >> 62);
    const unsigned pre = __ballot_sync(0xffffffffu, flag == 2);
    const int k = pre ? __ffs(pre) - 1 : 32;   // nearest prefix, or none
    Pair v{static_cast<int>((r >> 31) & 0x7fffffffu),
           static_cast<int>(r & 0x7fffffffu)};
    if (lane > k) v = Pair{0, 0};
    for (int d = 16; d > 0; d >>= 1) {       // the saturating sums commute
      v.a = sat(v.a + __shfl_xor_sync(0xffffffffu, v.a, d), cap);
      v.b = sat(v.b + __shfl_xor_sync(0xffffffffu, v.b, d), cap);
    }
    acc = Pair{sat(acc.a + v.a, cap), sat(acc.b + v.b, cap)};
    if (pre) return acc;
  }
}

// Padded shared index: 8 consecutive items per thread without bank
// conflicts on the transposed reads.
__host__ __device__ constexpr int pad(int j) { return j + (j >> 5); }

// Ints of a block's scratch row: command starts, literal starts, and per
// output tile (and one past the last) the command holding its first byte
// and the literal offset there.
__host__ __device__ inline int64_t row_ints(int C, int n_tiles) {
  return 2 * int64_t(C) + 2 * (int64_t(n_tiles) + 1);
}

// ---- 1. command starts and the tile table ----
// Persistent CTAs take the (chunk of kTile commands, block) pairs in
// chunk-major order by an atomic ticket, so a chunk's predecessors were
// handed out before it and are running or done; chunks of one block chain
// a decoupled look-back, so a long block's scan spreads over the card too.
// Thread 0 skips chunks past their block's n_cmds without a barrier, and
// once every block's chunk 0 has reported its chunk count, stops at the
// first chunk past the longest block's.
__global__ void __launch_bounds__(kThreads)
hrt1_starts_kernel(const int32_t* __restrict__ count,
                   const int32_t* __restrict__ lit_len,
                   const int32_t* __restrict__ n_cmds,
                   int32_t* __restrict__ scratch,
                   int32_t* __restrict__ state, int64_t nb, int C, int B,
                   int n_tiles) {
  __shared__ int s_a[pad(kTile)], s_b[pad(kTile)];
  __shared__ Pair warp_sums[kWarps];
  __shared__ Pair s_base;
  __shared__ long long s_unit;
  const int tid = threadIdx.x;
  const int nch = (C + kTile - 1) / kTile;
  const long long units = nb * nch;
  unsigned long long* ticket = reinterpret_cast<unsigned long long*>(state);
  int* reported = state + 2;    // blocks whose chunk 0 was handed out
  int* max_ch = state + 3;      // chunks of the longest block
  uint64_t* recs_all = reinterpret_cast<uint64_t*>(state + 4);

  for (;;) {
    if (tid == 0) {
      long long v;
      for (;;) {
        v = static_cast<long long>(atomicAdd(ticket, 1ull));
        if (v >= units) break;
        const int ch = static_cast<int>(v / nb);
        const int nc = clamp_field(n_cmds[v % nb], C);
        if (ch == 0) {          // report the block's chunk count
          atomicMax(max_ch, (nc + kTile - 1) / kTile);
          __threadfence();
          atomicAdd(reported, 1);
        } else {
          // once every block has reported, chunks past the longest
          // block's are nobody's: stop taking tickets
          for (long long spins = 0; ld_acquire32(reported) < nb; ++spins) {
            if (spins > (1ll << 26)) __trap();
            __nanosleep(32);
          }
          if (ch >= ld_acquire32(max_ch)) {
            v = units;
            break;
          }
        }
        if (ch * kTile < nc) break;
      }
      s_unit = v;
    }
    __syncthreads();
    const long long u = s_unit;
    if (u >= units) break;
    const int64_t blk = u % nb;
    const int ch = static_cast<int>(u / nb);
    const int nc = clamp_field(n_cmds[blk], C);
    const int t0 = ch * kTile;
    const int32_t* cn = count + blk * C;
    const int32_t* ll = lit_len + blk * C;
    int32_t* starts = scratch + blk * row_ints(C, n_tiles);
    int32_t* lstarts = starts + C;
    int32_t* tiles = lstarts + C;               // [n_tiles + 1][2]
    uint64_t* recs = recs_all + blk * nch;

    // coalesced loads, transposed through shared memory
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int j = i * kThreads + tid;
      const int c = t0 + j;
      int l = 0, sp = 0;
      if (c < nc) {
        l = clamp_field(ll[c], B);
        sp = sat(l + clamp_field(cn[c], B), B);
      }
      s_a[pad(j)] = sp;
      s_b[pad(j)] = l;
    }
    __syncthreads();
    int sp[kItems], ln[kItems];
    Pair mine{0, 0};
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int j = tid * kItems + i;
      sp[i] = s_a[pad(j)];
      ln[i] = s_b[pad(j)];
      mine.a = sat(mine.a + sp[i], B);
      mine.b = sat(mine.b + ln[i], B);
    }
    Pair total;
    const Pair exc = block_exclusive_scan(mine, B, warp_sums, &total);
    if (tid < 32) {
      Pair p{0, 0};
      if (ch > 0) {
        if (tid == 0) st_release(recs + ch, pack(1, total));
        p = look_back(recs, ch, B);
      }
      if (tid == 0) {
        st_release(recs + ch, pack(2, Pair{sat(p.a + total.a, B),
                                           sat(p.b + total.b, B)}));
        s_base = p;
      }
    }
    __syncthreads();
    Pair run{sat(s_base.a + exc.a, B), sat(s_base.b + exc.b, B)};
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int j = tid * kItems + i;
      const int c = t0 + j;
      const int nxt = sat(run.a + sp[i], B);
      if (c < nc) {
        s_a[pad(j)] = run.a;
        s_b[pad(j)] = run.b;
        // tiles whose first byte falls in [start, next start) get this
        // command and the literal offset at that byte; the last command
        // takes every later tile
        const int64_t hi = c + 1 < nc ? nxt : int64_t(n_tiles) * kOut + 1;
        for (int64_t t = (run.a + kOut - 1) / kOut;
             t <= n_tiles && t * kOut < hi; ++t) {
          tiles[2 * t] = c;
          tiles[2 * t + 1] = run.b + static_cast<int>(
              min(t * kOut - run.a, static_cast<int64_t>(ln[i])));
        }
      }
      run.a = nxt;
      run.b = sat(run.b + ln[i], B);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int j = i * kThreads + tid;
      if (t0 + j < nc) {
        starts[t0 + j] = s_a[pad(j)];
        lstarts[t0 + j] = s_b[pad(j)];
      }
    }
    __syncthreads();          // shared memory is reused by the next chunk
  }
}

// ---- 2. fill ----
// One piece of a tile that a thread leaves to the whole CTA: kLong or more
// bytes of one run (src < 0, byte sym) or of one literal stretch (staged
// literal offset src).
struct Piece {
  int off, len, src, sym;
};

__device__ __forceinline__ uint32_t lit_word(const uint8_t* s_lit, int so) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(s_lit);
  return __funnelshift_r(w[so >> 2], w[(so >> 2) + 1], 8 * (so & 3));
}

// out[off, off + len) = the run byte, or the staged literals from src on;
// threads `first` + k * `step` share the work.
__device__ void put(uint8_t* out, int off, int len, int src, uint32_t sym,
                    const uint8_t* s_lit, int first, int step) {
  const int head = min(len, (4 - (off & 3)) & 3);
  const int words = (len - head) >> 2;
  const int tail0 = head + 4 * words;
  uint32_t* ow = reinterpret_cast<uint32_t*>(out + off + head);
  for (int i = first; i < head; i += step)
    out[off + i] = src < 0 ? uint8_t(sym) : s_lit[src + i];
  for (int i = tail0 + first; i < len; i += step)
    out[off + i] = src < 0 ? uint8_t(sym) : s_lit[src + i];
  if (src < 0) {
    const uint32_t v = sym * 0x01010101u;
    for (int i = first; i < words; i += step) ow[i] = v;
  } else {
    for (int i = first; i < words; i += step)
      ow[i] = lit_word(s_lit, src + head + 4 * i);
  }
}

__global__ void __launch_bounds__(kFillThreads)
hrt1_fill_kernel(const uint8_t* __restrict__ sym,
                 const int32_t* __restrict__ lit_len,
                 const uint8_t* __restrict__ lits,
                 const int32_t* __restrict__ n_cmds,
                 const int32_t* __restrict__ block_len,
                 const int32_t* __restrict__ scratch,
                 int32_t* __restrict__ out, int64_t nb, int C,
                 int lit_bytes, int B, int W, int n_tiles) {
  __shared__ __align__(16) uint8_t s_out[kOut];
  __shared__ __align__(16) uint8_t s_lit[kOut + 16];
  __shared__ Piece s_pieces[kOut / kLong];
  __shared__ int s_n_pieces;
  const int tid = threadIdx.x;
  const int64_t units = nb * n_tiles;
  const bool lit_words =
      (lit_bytes & 3) == 0 && (reinterpret_cast<uintptr_t>(lits) & 3) == 0;

  // a unit's counts and its table entries (command, literal offset at the
  // tile's first byte and at the next tile's); loaded one unit ahead
  struct Meta {
    int nc, blen, c_lo, lit_lo, c_hi, lit_hi;
  };
  auto meta = [&](int64_t u) {
    const int64_t blk = u / n_tiles;
    const int j = static_cast<int>(u % n_tiles);
    const int32_t* t = scratch + blk * row_ints(C, n_tiles) + 2 * C + 2 * j;
    return Meta{clamp_field(n_cmds[blk], C), clamp_field(block_len[blk], B),
                t[0], t[1], t[2], t[3]};
  };
  Meta next{};
  if (blockIdx.x < units) next = meta(blockIdx.x);

  for (int64_t u = blockIdx.x; u < units; u += gridDim.x) {
    const Meta m = next;
    if (u + gridDim.x < units) next = meta(u + gridDim.x);
    const int64_t blk = u / n_tiles;
    const int j = static_cast<int>(u % n_tiles);
    const int nc = m.nc;
    const int blen = m.blen;
    const int p0 = j * kOut;
    const int p1 = min(p0 + kOut, 4 * W);
    const int pe = min(p1, blen);               // bytes past blen are zero
    const uint8_t* sy = sym + blk * C;
    const int32_t* ll = lit_len + blk * C;
    const uint8_t* lt = lits + blk * lit_bytes;
    const int32_t* starts = scratch + blk * row_ints(C, n_tiles);
    const int32_t* lstarts = starts + C;
    const bool live = nc > 0 && p0 < pe;

    if (live) {
      // the tile's commands [c_lo, c_hi] and its literal span
      const int c_lo = m.c_lo, c_hi = m.c_hi, lit_lo = m.lit_lo;
      const int n_lit = max(0, min(min(m.lit_hi, lit_bytes) - lit_lo, kOut));
      // my first command's fields, loaded while the literals are staged
      int c = c_lo + tid;
      int s = 0, e = 0, l = 0, ls = 0, sv = 0;
      auto fetch = [&]() {
        s = starts[c];
        e = c + 1 < nc ? starts[c + 1] : kNone;
        l = clamp_field(ll[c], B);
        ls = lstarts[c];
        sv = sy[c];
      };
      if (c <= c_hi) fetch();
      int skew = 0;
      if (tid == 0) s_n_pieces = 0;
      if (n_lit == 0) {
      } else if (lit_words) {
        const int w0 = lit_lo >> 2;
        const int w1 = (lit_lo + n_lit + 3) >> 2;
        skew = lit_lo & 3;
        const uint32_t* src = reinterpret_cast<const uint32_t*>(lt);
        uint32_t* dst = reinterpret_cast<uint32_t*>(s_lit);
        for (int i = tid; i < w1 - w0; i += kFillThreads) dst[i] = src[w0 + i];
      } else {
        for (int i = tid; i < n_lit; i += kFillThreads)
          s_lit[i] = lt[lit_lo + i];
      }
      __syncthreads();

      // one command per thread: its literals, then its run, clipped to the
      // tile; pieces of kLong bytes or more go to the whole CTA
      for (; c <= c_hi; c += kFillThreads) {
        if (c != c_lo + tid) fetch();
        const int le = min(s + l, e);
        int a = max(s, p0), z = min(le, pe);
        if (a < z) {
          const int rel = ls + (a - s) - lit_lo;
          if (rel >= 0 && rel + (z - a) <= n_lit) {
            if (z - a >= kLong) {
              const int k = atomicAdd(&s_n_pieces, 1);
              s_pieces[k] = Piece{a - p0, z - a, skew + rel, 0};
            } else {
              put(s_out, a - p0, z - a, skew + rel, 0u, s_lit, 0, 1);
            }
          } else {   // outside the staged span: hostile fields only
            for (int q = a; q < z; ++q) {
              const int li = ls + (q - s);
              s_out[q - p0] = li < lit_bytes ? lt[li] : uint8_t(0);
            }
          }
        }
        a = max(le, p0);
        z = min(e, pe);
        if (a < z) {
          if (z - a >= kLong) {
            const int k = atomicAdd(&s_n_pieces, 1);
            s_pieces[k] = Piece{a - p0, z - a, -1, sv};
          } else {
            put(s_out, a - p0, z - a, -1, sv, s_lit, 0, 1);
          }
        }
      }
      __syncthreads();
      for (int k = 0; k < s_n_pieces; ++k) {
        const Piece pc = s_pieces[k];
        put(s_out, pc.off, pc.len, pc.src, pc.sym, s_lit, tid, kFillThreads);
      }
      __syncthreads();
    }

    // the tile, 16 bytes a thread, zero past blen
    int32_t* o = out + blk * W;
    for (int q = p0 + 16 * tid; q < p1; q += 16 * kFillThreads) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (live && q < pe) {
        v = *reinterpret_cast<const uint4*>(s_out + (q - p0));
        if (q + 16 > pe) {
          uint32_t* vw = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int keep = pe - (q + 4 * i);    // bytes of word i kept
            vw[i] = keep >= 4 ? vw[i]
                  : keep <= 0 ? 0u : vw[i] & ((1u << (8 * keep)) - 1u);
          }
        }
      }
      const int w0 = q >> 2;
      if ((W & 3) == 0 && w0 + 4 <= W) {
        *reinterpret_cast<uint4*>(o + w0) = v;
      } else {
        const uint32_t* vw = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (w0 + i < W) o[w0 + i] = static_cast<int32_t>(vw[i]);
      }
    }
    __syncthreads();  // shared memory is reused by the next tile
  }
}

int n_tiles_for(int32_t W) { return (4 * W + kOut - 1) / kOut; }

int64_t chunks_for(int32_t C) { return (C + kTile - 1) / kTile; }

// Persistent CTAs of `kernel` that device `dev` holds at once.
template <typename K>
cudaError_t resident(K kernel, int threads, int dev, int64_t* out) {
  int sms = 0, per_sm = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, 0);
  *out = int64_t(per_sm < 1 ? 1 : per_sm) * sms;
  return e;
}

struct GridCaps {
  int64_t starts, fill;
};

// The starts and fill grids' caps on the current device, computed before
// that device's first launch; host threads launching for the first time at
// once take the lock in turn.
cudaError_t grid_caps(GridCaps* out) {
  constexpr int kMaxDevices = 64;
  static std::mutex mu;
  static GridCaps caps[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  GridCaps& c = caps[dev];
  if (c.fill == 0) {
    GridCaps n{};
    e = resident(hrt1_starts_kernel, kThreads, dev, &n.starts);
    if (e == cudaSuccess)
      e = resident(hrt1_fill_kernel, kFillThreads, dev, &n.fill);
    if (e != cudaSuccess) return e;
    c = n;
  }
  *out = c;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Ints of the `scratch` an (nb, C, W) launch needs: per block the command
// starts, the literal starts and the tile table.
int64_t hrt1_decode_scratch_ints(int64_t nb, int32_t C, int32_t W) {
  return nb * row_ints(C, n_tiles_for(W));
}

// Ints of the zeroed `state` an (nb, C) launch needs: the starts pass's
// work ticket, its chunk-count report and its 64-bit look-back record per
// (block, chunk).
int64_t hrt1_decode_state_ints(int64_t nb, int32_t C) {
  return 4 + 2 * nb * chunks_for(C);
}

// Launch on `stream`: the starts grid, then the fill grid, both persistent
// CTAs.  Shapes (row-major, contiguous): sym u8 [nb, C]; count, lit_len i32
// [nb, C]; lits u8 [nb, lit_bytes]; n_cmds, block_len i32 [nb]; scratch i32
// [hrt1_decode_scratch_ints(nb, C, W)]; state i32
// [hrt1_decode_state_ints(nb, C)], zeroed; out i32 [nb, W] with 4 * W >= B.
// Returns cudaGetLastError() after the launches.
int hrt1_decode(const void* sym, const void* count, const void* lit_len,
                const void* lits, const void* n_cmds, const void* block_len,
                void* scratch, void* state, void* out, int64_t nb, int32_t C,
                int32_t lit_bytes, int32_t B, int32_t W, void* stream) {
  GridCaps caps{};
  const cudaError_t ce = grid_caps(&caps);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  if (nb > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int n_tiles = n_tiles_for(W);
    const int64_t chunks = nb * chunks_for(C);
    hrt1_starts_kernel<<<static_cast<unsigned>(
        chunks < caps.starts ? chunks : caps.starts), kThreads, 0,
        s>>>(static_cast<const int32_t*>(count),
             static_cast<const int32_t*>(lit_len),
             static_cast<const int32_t*>(n_cmds),
             static_cast<int32_t*>(scratch), static_cast<int32_t*>(state), nb,
             C, B, n_tiles);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const int64_t units = nb * n_tiles;
    hrt1_fill_kernel<<<static_cast<unsigned>(
        units < caps.fill ? units : caps.fill), kFillThreads, 0, s>>>(
        static_cast<const uint8_t*>(sym),
        static_cast<const int32_t*>(lit_len),
        static_cast<const uint8_t*>(lits),
        static_cast<const int32_t*>(n_cmds),
        static_cast<const int32_t*>(block_len),
        static_cast<const int32_t*>(scratch), static_cast<int32_t*>(out), nb,
        C, lit_bytes, B, W, n_tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* hrt1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
