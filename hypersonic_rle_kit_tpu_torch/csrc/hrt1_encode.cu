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
// Bound: memory.  One pass over the input, O(n_cmds) command writes and one
// literal write per byte; the arithmetic is two scans per tile.  Design, one
// CTA per block, looping over 8 KiB tiles with a running carry:
//
//   1. Run ends.  Threads own 16 contiguous bytes (one 16-byte load).  A run
//      ends at q when q == n - 1 or x[q] != x[q + 1]; its start is the
//      previous run end, from a block max-scan of end positions.  So a run
//      that spans tiles needs no halo: the carry holds its start.  The run's
//      byte is x[q] itself.
//   2. Emission.  A block scan of (emitted runs, covered bytes, last emitted
//      end) over the tile gives each emitted run its command index, its
//      lit_len and the offset of the literal gap before it.  The gap's source
//      start and output offset go to a per-block scratch row (2 x cap int32).
//   3. Literals.  After a barrier, threads own 16-byte chunks of the literal
//      row, binary-search the gap offsets for their first gap and copy byte
//      by byte (the segmented copy of hrt1_decode's fill, reversed).
//
// A block with more than cap commands writes only the first cap and skips
// step 3; n_cmds still holds the true count, and the wrapper raises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                 // bytes per thread per tile
constexpr int kTile = kThreads * kItems;
constexpr unsigned kFull = 0xffffffffu;

struct Emit {
  int cnt;  // emitted runs
  int cov;  // bytes they cover
  int end;  // exclusive end of the last one (0 if none)
};

struct MaxOp {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};

struct EmitOp {
  __device__ Emit operator()(Emit a, Emit b) const {
    return Emit{a.cnt + b.cnt, a.cov + b.cov, a.end > b.end ? a.end : b.end};
  }
};

__device__ __forceinline__ int shfl_up(int v, int d) {
  return __shfl_up_sync(kFull, v, d);
}

__device__ __forceinline__ Emit shfl_up(Emit v, int d) {
  return Emit{shfl_up(v.cnt, d), shfl_up(v.cov, d), shfl_up(v.end, d)};
}

// Block-wide exclusive scan under an associative `op` with identity `id`.
// Returns this thread's exclusive prefix; writes the block total to *total.
template <typename T, typename Op>
__device__ T block_exclusive_scan(T v, T id, Op op, T* warp_sums, T* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    T o = shfl_up(inc, d);
    if (lane >= d) inc = op(o, inc);
  }
  T exc = shfl_up(inc, 1);
  if (lane == 0) exc = id;
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T w = lane < kWarps ? warp_sums[lane] : id;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      T o = shfl_up(w, d);
      if (lane >= d) w = op(o, w);
    }
    if (lane < kWarps) warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  if (warp > 0) exc = op(warp_sums[warp - 1], exc);
  *total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums is reused by the next scan
  return exc;
}

__device__ __forceinline__ uint32_t byte_of(const uint32_t (&w)[4], int i) {
  return (w[i >> 2] >> (8 * (i & 3))) & 0xffu;
}

__global__ void __launch_bounds__(kThreads)
hrt1_encode_kernel(const uint8_t* __restrict__ x,
                   const int32_t* __restrict__ block_len,
                   const int32_t* __restrict__ only_sym,
                   uint8_t* __restrict__ sym, int32_t* __restrict__ count,
                   int32_t* __restrict__ lit_len, uint8_t* __restrict__ lits,
                   int32_t* __restrict__ n_cmds, int32_t* __restrict__ n_lits,
                   int32_t* __restrict__ scratch, int B, int cap,
                   int min_count, int vec) {
  __shared__ int max_sums[kWarps];
  __shared__ Emit emit_sums[kWarps];
  const int64_t blk = blockIdx.x;
  const int bl = block_len[blk];
  const int n = bl < 0 ? 0 : (bl > B ? B : bl);
  const int osym = only_sym != nullptr ? only_sym[blk] : -1;
  const uint8_t* xr = x + blk * B;
  uint8_t* sy = sym + blk * cap;
  int32_t* cn = count + blk * cap;
  int32_t* ll = lit_len + blk * cap;
  uint8_t* lt = lits + blk * B;
  int32_t* gap_src = scratch + blk * 2 * cap;  // input start of gap k
  int32_t* gap_off = gap_src + cap;            // literal offset of gap k

  // ---- 1-2. run ends and emission, tile by tile ----
  int run_start = 0;       // start of the run open at the tile's start
  Emit carry{0, 0, 0};     // emitted runs of earlier tiles
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int q0 = t0 + threadIdx.x * kItems;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (vec && q0 + kItems <= B) {
      const uint4 v = *reinterpret_cast<const uint4*>(xr + q0);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < kItems; ++i)
        if (q0 + i < n) w[i >> 2] |= uint32_t(xr[q0 + i]) << (8 * (i & 3));
    }
    const uint32_t after = q0 + kItems < n ? xr[q0 + kItems] : 0u;
    unsigned ends = 0;   // bit i: a run ends at q0 + i
    int last = -1;       // exclusive end of my last run end
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int q = q0 + i;
      const uint32_t nxt = i + 1 < kItems ? byte_of(w, i + 1) : after;
      if (q < n && (q == n - 1 || byte_of(w, i) != nxt)) {
        ends |= 1u << i;
        last = q + 1;
      }
    }
    int tile_max;
    const int before = block_exclusive_scan(last, -1, MaxOp(), max_sums,
                                            &tile_max);
    const int s0 = before > run_start ? before : run_start;
    run_start = tile_max > run_start ? tile_max : run_start;

    // my emitted runs: count, covered bytes, last end
    Emit mine{0, 0, 0};
    unsigned emits = 0;
    int s = s0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (ends & (1u << i)) {
        const int e = q0 + i + 1;
        const int b = static_cast<int>(byte_of(w, i));
        if (e - s >= min_count && (osym < 0 || b == osym)) {
          emits |= 1u << i;
          mine.cnt += 1;
          mine.cov += e - s;
          mine.end = e;
        }
        s = e;
      }
    }
    Emit tile_sum;
    const Emit base = EmitOp()(carry, block_exclusive_scan(
        mine, Emit{0, 0, 0}, EmitOp(), emit_sums, &tile_sum));
    carry = EmitOp()(carry, tile_sum);

    int k = base.cnt;
    int cov = base.cov;
    int prev_end = base.end;
    s = s0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (ends & (1u << i)) {
        const int e = q0 + i + 1;
        if (emits & (1u << i)) {
          if (k < cap) {
            sy[k] = static_cast<uint8_t>(byte_of(w, i));
            cn[k] = e - s;
            ll[k] = s - prev_end;
            gap_src[k] = prev_end;
            gap_off[k] = prev_end - cov;
          }
          ++k;
          cov += e - s;
          prev_end = e;
        }
        s = e;
      }
    }
  }

  // ---- tail command, zero padding, counts ----
  const int nc = carry.cnt + 1;
  const int nl = n - carry.cov;
  if (threadIdx.x == 0) {
    if (carry.cnt < cap) {
      sy[carry.cnt] = 0;
      cn[carry.cnt] = 0;
      ll[carry.cnt] = n - carry.end;
      gap_src[carry.cnt] = carry.end;
      gap_off[carry.cnt] = carry.end - carry.cov;
    }
    n_cmds[blk] = nc;
    n_lits[blk] = nl;
  }
  for (int k = nc + threadIdx.x; k < cap; k += kThreads) {
    sy[k] = 0;
    cn[k] = 0;
    ll[k] = 0;
  }
  if (nc > cap) return;  // uniform across the CTA: the wrapper raises
  __syncthreads();       // the gap rows are visible to every thread

  // ---- 3. literals: 16-byte chunks of the literal row ----
  for (int q0 = threadIdx.x * kItems; q0 < B; q0 += kTile) {
    uint32_t o[4] = {0u, 0u, 0u, 0u};
    if (q0 < nl) {
      // last gap whose offset <= q0 (gap_off[0] == 0 <= q0)
      int lo = 0, hi = nc - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (gap_off[mid] <= q0) lo = mid; else hi = mid - 1;
      }
      int g = lo;
      int off = gap_off[g];
      int src = gap_src[g];
      int nxt = g + 1 < nc ? gap_off[g + 1] : 0x7fffffff;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int q = q0 + i;
        if (q < nl) {
          while (q >= nxt) {  // gaps partition [0, nl): stays below nc
            ++g;
            off = nxt;
            src = gap_src[g];
            nxt = g + 1 < nc ? gap_off[g + 1] : 0x7fffffff;
          }
          o[i >> 2] |= uint32_t(xr[src + q - off]) << (8 * (i & 3));
        }
      }
    }
    if (vec && q0 + kItems <= B) {
      *reinterpret_cast<uint4*>(lt + q0) = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int i = 0; i < kItems; ++i)
        if (q0 + i < B) lt[q0 + i] = static_cast<uint8_t>(byte_of(o, i));
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`: nb CTAs of kThreads.  Shapes (row-major, contiguous):
// x u8 [nb, B]; block_len i32 [nb]; only_sym i32 [nb] or null (no Single
// filter); outputs sym u8, count, lit_len i32 [nb, cap], lits u8 [nb, B],
// n_cmds, n_lits i32 [nb]; scratch i32 [nb, 2, cap].  `vec` != 0 allows
// 16-byte loads and stores (x and lits 16-byte aligned, B % 16 == 0).
// Returns cudaGetLastError() after the launch.
int hrt1_encode(const void* x, const void* block_len, const void* only_sym,
                void* sym, void* count, void* lit_len, void* lits,
                void* n_cmds, void* n_lits, void* scratch, int64_t nb,
                int32_t B, int32_t cap, int32_t min_count, int32_t vec,
                void* stream) {
  if (nb > 0) {
    hrt1_encode_kernel<<<static_cast<unsigned>(nb), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<const int32_t*>(block_len),
        static_cast<const int32_t*>(only_sym), static_cast<uint8_t*>(sym),
        static_cast<int32_t*>(count), static_cast<int32_t*>(lit_len),
        static_cast<uint8_t*>(lits), static_cast<int32_t*>(n_cmds),
        static_cast<int32_t*>(n_lits), static_cast<int32_t*>(scratch), B, cap,
        min_count, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
