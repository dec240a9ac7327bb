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
// Bound: the bytes (each read and written once) take 0.0006 ms per MiB at
// 3.35 TB/s, but a step depends on the history the step before left, so a
// (block, lane) chain of U units is U dependent steps.  Design: split each
// chain into chunks of C units and run three grids, none of whose serial
// work waits on another chunk:
//
//   1. Chunk pass (a CTA per (block, chunk), a warp per lane): every chunk
//      runs from the identity history.  A decode step's moves depend only
//      on d, so its outputs are slots of the chunk's true start history and
//      its final history is the slot permutation P_k.  An encode step's
//      rank of a repeated symbol counts the distinct symbols since its last
//      use inside the chunk, whatever the start, so repeats come out right;
//      the pass also records the chunk's first occurrences (symbol, unit)
//      in order, the set of its symbols, and its recency list L_k (the
//      final history's first nd entries).  The chunk's C x lanes input
//      bytes are one contiguous range, staged in shared memory with 16-byte
//      loads; the outputs overwrite them there and leave the same way.
//   2. Carry (a warp per (block, lane)) walks the chunks in order with
//      256-wide warp operations: decode H_{k+1}[e] = H_k[P_k[e]], encode
//      H_{k+1} = L_k ++ (H_k without L_k's symbols).  The next 8 chunks'
//      effects stream into a shared-memory ring with cp.async.  It stores
//      every chunk's start history H_k and writes H_K as the table.
//   3. Fix-up (a CTA per (block, chunk)): decode out = H_k[slot], a gather;
//      encode rewrites the first occurrences only: the j-th (from 0), of
//      symbol v at position p_j of H_k, has rank j + p_j - #{earlier first
//      occurrences ahead of v in H_k}, counted 32 at a time with a 256-bit
//      mask of the earlier blocks' positions and shuffles within the block.
//
// The serial step keeps a 256-entry history in one warp's registers, 8
// entries a thread (two 32-bit words).  A step is a fixed run of warp
// instructions whatever the rank: encode finds v with a byte compare and
// __ballot_sync, decode reads entry d with one __shfl_sync, and the shift
// of entries [0, d] is a funnel shift per thread with the carry from
// __shfl_up_sync.
// With C = 512 (the ops wrapper's CHUNK, from a sweep on an H100) a 1 MiB
// 16-lane block fills the card with one CTA of 16 warps per SM, and the
// chunk pass is bound by instruction issue, not by the chain's latency:
// it is ~70% of the time, the carry's U / C steps ~20%.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 32;        // lanes per CTA, a warp each
constexpr int kMaxChunk = 1024;   // kMaxChunk * kGroup bytes of shared memory
constexpr unsigned kFull = 0xffffffffu;

// Per chunk-lane q = (b * lanes + l) * K + k, in one scratch allocation.
struct Scratch {
  uint8_t* start;   // [Q, 256] the true start history H_k
  uint8_t* fin;     // [Q, 256] final history of the identity pass
  uint8_t* fsym;    // [Q, 256] encode: first occurrences, in order
  uint16_t* fidx;   // [Q, 256] encode: their unit within the chunk
  uint8_t* seen;    // [Q, 32]  encode: the chunk's symbols, a bit each
  int32_t* nd;      // [Q]      encode: how many
};

constexpr int64_t kBytesDecode = 512;
constexpr int64_t kBytesEncode = 512 + 256 + 512 + 32 + 4;

Scratch carve(void* base, int64_t Q) {
  uint8_t* p = static_cast<uint8_t*>(base);
  Scratch s;
  s.start = p;
  s.fin = p + 256 * Q;
  s.fsym = p + 512 * Q;
  s.fidx = reinterpret_cast<uint16_t*>(p + 768 * Q);
  s.seen = p + 1280 * Q;
  s.nd = reinterpret_cast<int32_t*>(p + 1312 * Q);
  return s;
}

__device__ __forceinline__ uint64_t identity8(int t) {
  uint64_t h = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) h |= uint64_t(8 * t + j) << (8 * j);
  return h;
}

// A thread's 8 entries of a warp's history: entry 8t + j is byte j of
// (lo, hi), bytes 0-3 in lo.
struct Hist {
  uint32_t lo, hi;
};

// Flags the lowest zero byte of z exactly (a borrow flags only bytes above).
__device__ __forceinline__ uint32_t zero_bytes(uint32_t z) {
  return (z - 0x01010101u) & ~z & 0x80808080u;
}

// Position of v in the warp's history; exactly one entry holds it.
__device__ __forceinline__ int mtf_find(Hist h, int t, uint32_t v) {
  const uint32_t rep = 0x01010101u * v;
  const uint32_t lo = zero_bytes(h.lo ^ rep), hi = zero_bytes(h.hi ^ rep);
  const unsigned who = __ballot_sync(kFull, (lo | hi) != 0);
  const int byte = lo ? (__ffs(lo) - 1) >> 3 : 4 + ((__ffs(hi) - 1) >> 3);
  return __shfl_sync(kFull, 8 * t + byte, __ffs(who) - 1);
}

// Entry d of the warp's history.
__device__ __forceinline__ uint32_t mtf_read(Hist h, uint32_t d) {
  return (__shfl_sync(kFull, (d & 4) ? h.hi : h.lo, d >> 3) >> (8 * (d & 3))) &
         0xffu;
}

// Move entry d (holding v) to the front: entries [0, d) shift up by one.
__device__ __forceinline__ Hist mtf_shift(Hist h, int t, int d, uint32_t v) {
  const uint32_t up = __shfl_up_sync(kFull, h.hi, 1) >> 24;
  const uint32_t lo = (h.lo << 8) | (t == 0 ? v : up);
  const uint32_t hi = __funnelshift_l(h.lo, h.hi, 8);
  const int m = d - 8 * t + 1;  // this thread's entries that move
  // low-byte masks of the moving entries (a shift of 32 gives all ones)
  const uint32_t mlo = __funnelshift_lc(~0u, 0u, 8 * min(max(m, 0), 4));
  const uint32_t mhi = __funnelshift_lc(~0u, 0u, 8 * min(max(m - 4, 0), 4));
  return Hist{(lo & mlo) | (h.lo & ~mlo), (hi & mhi) | (h.hi & ~mhi)};
}

// Copy `rows` units of the group's G lanes between x (row stride `lanes`)
// and shared memory (row stride G), 16 bytes at a time when the range is
// contiguous and aligned.
template <bool kToShared>
__device__ void copy_rows(uint8_t* g, uint8_t* s, int rows, int G,
                          int lanes) {
  const int total = rows * G;
  int done = 0;
  if (G == lanes && (reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    done = total & ~15;
    for (int i = threadIdx.x; i < total / 16; i += blockDim.x) {
      if (kToShared)
        reinterpret_cast<uint4*>(s)[i] = reinterpret_cast<const uint4*>(g)[i];
      else
        reinterpret_cast<uint4*>(g)[i] = reinterpret_cast<const uint4*>(s)[i];
    }
  }
  for (int i = done + threadIdx.x; i < total; i += blockDim.x) {
    uint8_t* gp = g + int64_t(i / G) * lanes + i % G;
    if (kToShared)
      s[i] = *gp;
    else
      *gp = s[i];
  }
}

// 1. Chunk pass.  grid (nb * K, lane groups), 32 x G threads, chunk x G
// bytes of dynamic shared memory.
template <bool kEncode>
__global__ void __launch_bounds__(1024)
    mmtf_chunk_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                      Scratch sc, int64_t n, int lanes, int64_t units,
                      int chunk, int64_t K) {
  extern __shared__ __align__(16) uint8_t s[];
  const int64_t b = blockIdx.x / K;
  const int64_t k = blockIdx.x - b * K;
  const int l0 = blockIdx.y * kGroup;
  const int G = min(kGroup, lanes - l0);
  const int64_t u0 = k * chunk;
  const int cu = static_cast<int>(min(int64_t(chunk), units - u0));
  const int64_t off = b * n + u0 * lanes + l0;
  copy_rows<true>(const_cast<uint8_t*>(x) + off, s, cu, G, lanes);
  __syncthreads();
  const int w = threadIdx.x >> 5, t = threadIdx.x & 31;
  if (w < G) {
    const int64_t q = (b * lanes + l0 + w) * K + k;
    const uint32_t base = 0x01010101u * uint32_t(8 * t);
    Hist h{base + 0x03020100u, base + 0x07060504u};
    int nd = 0;         // distinct symbols so far (encode)
    uint32_t seen = 0;  // this thread's byte of the symbol set
    for (int i0 = 0; i0 < cu; i0 += 32) {
      const int steps = min(32, cu - i0);
      uint32_t mine = 0;  // the output of step i0 + t
#pragma unroll 4
      for (int r = 0; r < steps; ++r) {
        const uint32_t in = s[(i0 + r) * G + w];
        uint32_t o;
        if (kEncode) {
          const int d = mtf_find(h, t, in);
          h = mtf_shift(h, t, d, in);
          if (d >= nd) {  // first occurrence: it sat past the seen symbols
            if (t == 0) {
              sc.fsym[q * 256 + nd] = static_cast<uint8_t>(in);
              sc.fidx[q * 256 + nd] = static_cast<uint16_t>(i0 + r);
            }
            if (t == int(in >> 3)) seen |= 1u << (in & 7);
            ++nd;
          }
          o = static_cast<uint32_t>(d);
        } else {
          o = mtf_read(h, in);
          h = mtf_shift(h, t, static_cast<int>(in), o);
        }
        if (t == r) mine = o;
      }
      __syncwarp();  // every read of these rows precedes their overwrite
      if (t < steps) s[(i0 + t) * G + w] = static_cast<uint8_t>(mine);
    }
    reinterpret_cast<uint2*>(sc.fin + q * 256)[t] = make_uint2(h.lo, h.hi);
    if (kEncode) {
      sc.seen[q * 32 + t] = static_cast<uint8_t>(seen);
      if (t == 0) sc.nd[q] = nd;
    }
  }
  __syncthreads();
  copy_rows<false>(out + off, s, cu, G, lanes);
}

// One chunk's effect as the carry stages it: the identity pass's final
// history, and (encode) its symbol set and their count.
struct Effect {
  uint64_t fin[32];
  uint32_t seen[8];
  int32_t nd;
  int32_t pad;
};

constexpr int kAhead = 8;  // chunk effects the carry keeps in flight

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// 2. Carry.  A warp (one CTA) per (block, lane) walks its K chunks; the
// effects of the next kAhead chunks are copied into a shared-memory ring
// with cp.async while it works, so a step waits on no global load.
template <bool kEncode>
__global__ void __launch_bounds__(32)
    mmtf_carry_kernel(Scratch sc, int32_t* __restrict__ table, int64_t K) {
  __shared__ __align__(8) uint8_t buf[2][256];
  __shared__ Effect ring[kAhead];
  const int64_t p = blockIdx.x;
  const int t = threadIdx.x;
  auto fetch = [&](int64_t k) {  // one commit group per call, empty or not
    if (k < K) {
      const int64_t q = p * K + k;
      Effect& e = ring[k % kAhead];
      cp_async8(&e.fin[t], sc.fin + q * 256 + 8 * t);
      if (kEncode && t < 8) cp_async4(&e.seen[t], sc.seen + q * 32 + 4 * t);
      if (kEncode && t == 8) cp_async4(&e.nd, sc.nd + q);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int k = 0; k < kAhead; ++k) fetch(k);
  uint64_t h = identity8(t);
  for (int64_t k = 0; k < K; ++k) {
    const int64_t q = p * K + k;
    reinterpret_cast<uint64_t*>(sc.start + q * 256)[t] = h;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1) : "memory");
    __syncwarp();  // chunk k's effect has landed for every thread
    const Effect& e = ring[k % kAhead];
    const uint64_t fk = e.fin[t];
    uint8_t* sm = buf[k & 1];
    if (kEncode) {
      // H_k's entries outside L_k keep their order after L_k's nd entries;
      // a kept entry's slot counts the kept entries of lower threads, one
      // ballot per byte (no dependent shuffles)
      const int ndk = e.nd;
      const unsigned lower = (1u << t) - 1;
      unsigned kept = 0;
      int pos = ndk;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t v = static_cast<uint32_t>(h >> (8 * j)) & 0xffu;
        const unsigned k1 = ((e.seen[v >> 5] >> (v & 31)) & 1u) ^ 1u;
        kept |= k1 << j;
        pos += __popc(__ballot_sync(kFull, k1) & lower);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if ((kept >> j) & 1u) sm[pos++] = static_cast<uint8_t>(h >> (8 * j));
        if (8 * t + j < ndk) sm[8 * t + j] = static_cast<uint8_t>(fk >> (8 * j));
      }
      __syncwarp();
      h = reinterpret_cast<const uint64_t*>(sm)[t];
    } else {
      reinterpret_cast<uint64_t*>(sm)[t] = h;
      __syncwarp();
      uint64_t g = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        g |= uint64_t(sm[(fk >> (8 * j)) & 0xffu]) << (8 * j);
      h = g;
    }
    __syncwarp();  // every thread has read ring slot k before it refills
    fetch(k + kAhead);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < 8; ++j)
    table[p * 256 + 8 * t + j] = static_cast<int32_t>((h >> (8 * j)) & 0xffu);
}

// 3. Fix-up.  grid (nb * K, lane groups), 32 x G threads.
template <bool kEncode>
__global__ void __launch_bounds__(1024)
    mmtf_fixup_kernel(uint8_t* __restrict__ out, Scratch sc, int64_t n,
                      int lanes, int64_t units, int chunk, int64_t K) {
  // decode: each lane's H_k; encode: each lane's symbol -> position in H_k
  __shared__ __align__(16) uint8_t sm[kGroup * 256];
  const int64_t b = blockIdx.x / K;
  const int64_t k = blockIdx.x - b * K;
  const int l0 = blockIdx.y * kGroup;
  const int G = min(kGroup, lanes - l0);
  const int64_t u0 = k * chunk;
  const int w = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int64_t q = (b * lanes + l0 + w) * K + k;
  if (!kEncode) {
    if (w < G)
      reinterpret_cast<uint64_t*>(sm + w * 256)[t] =
          reinterpret_cast<const uint64_t*>(sc.start + q * 256)[t];
    __syncthreads();
    const int cu = static_cast<int>(min(int64_t(chunk), units - u0));
    uint8_t* g = out + b * n + u0 * lanes + l0;
    const int total = cu * G;
    int done = 0;
    if (G == lanes && (reinterpret_cast<uintptr_t>(g) & 15) == 0) {
      done = total & ~15;
      for (int i = threadIdx.x; i < total / 16; i += blockDim.x) {
        uint4 v = reinterpret_cast<const uint4*>(g)[i];
        uint8_t* e = reinterpret_cast<uint8_t*>(&v);
#pragma unroll
        for (int j = 0; j < 16; ++j) e[j] = sm[((16 * i + j) % G) * 256 + e[j]];
        reinterpret_cast<uint4*>(g)[i] = v;
      }
    }
    for (int i = done + threadIdx.x; i < total; i += blockDim.x) {
      uint8_t* gp = g + int64_t(i / G) * lanes + i % G;
      *gp = sm[(i % G) * 256 + *gp];
    }
    return;
  }
  if (w >= G) return;  // no barrier below
  uint8_t* inv = sm + w * 256;
  const uint64_t hk = reinterpret_cast<const uint64_t*>(sc.start + q * 256)[t];
#pragma unroll
  for (int j = 0; j < 8; ++j) inv[(hk >> (8 * j)) & 0xffu] = 8 * t + j;
  __syncwarp();
  const int nd = sc.nd[q];
  // rank_j = j + p_j - #{i < j : p_i < p_j}, 32 first occurrences at a
  // time (lane t takes j = j0 + t): earlier blocks of them through a
  // 256-bit mask of their positions, the block itself through shuffles
  uint8_t* g = out + b * n + u0 * lanes + l0 + w;
  uint32_t taken[8] = {};  // positions of the earlier blocks' firsts
  for (int j0 = 0; j0 < nd; j0 += 32) {
    const int j = j0 + t;
    const bool valid = j < nd;
    const int pj = valid ? inv[sc.fsym[q * 256 + j]] : 0;  // p_j
    int below = 0;
#pragma unroll
    for (int k8 = 0; k8 < 8; ++k8) {
      const uint32_t under = k8 < (pj >> 5)    ? ~0u
                             : k8 == (pj >> 5) ? (1u << (pj & 31)) - 1
                                               : 0u;
      below += __popc(taken[k8] & under);
    }
    for (int i = 0; i < 31; ++i) {
      const int pi = __shfl_sync(kFull, pj, i);
      below += (i < t) & (pi < pj);
    }
    if (valid)
      g[int64_t(sc.fidx[q * 256 + j]) * lanes] =
          static_cast<uint8_t>(j + pj - below);
#pragma unroll
    for (int k8 = 0; k8 < 8; ++k8)
      taken[k8] |= __reduce_or_sync(
          kFull, valid && (pj >> 5) == k8 ? 1u << (pj & 31) : 0u);
  }
}

int64_t chunks_of(int64_t n, int32_t lanes, int32_t chunk) {
  const int64_t units = n / lanes;
  return (units + chunk - 1) / chunk;
}

template <bool kEncode>
cudaError_t run(const uint8_t* x, uint8_t* out, int32_t* table, void* scratch,
                int64_t nb, int64_t n, int lanes, int chunk,
                cudaStream_t stream) {
  const int64_t K = chunks_of(n, lanes, chunk);
  const int64_t units = n / lanes;
  const Scratch sc = carve(scratch, nb * lanes * K);
  const int G = lanes < kGroup ? lanes : kGroup;
  const dim3 grid(static_cast<unsigned>(nb * K),
                  static_cast<unsigned>((lanes + kGroup - 1) / kGroup));
  if (nb * K > 0) {
    mmtf_chunk_kernel<kEncode><<<grid, 32 * G, chunk * G, stream>>>(
        x, out, sc, n, lanes, units, chunk, K);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  mmtf_carry_kernel<kEncode>
      <<<static_cast<unsigned>(nb * lanes), 32, 0, stream>>>(sc, table, K);
  if (nb * K > 0) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    mmtf_fixup_kernel<kEncode><<<grid, 32 * G, 0, stream>>>(
        out, sc, n, lanes, units, chunk, K);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Ints of the `scratch` an (nb, n, lanes, encode, chunk) launch needs.
int64_t mmtf_scan_scratch_ints(int64_t nb, int64_t n, int32_t lanes,
                               int32_t encode, int32_t chunk) {
  if (lanes < 1 || chunk < 1) return 0;
  const int64_t Q = nb * lanes * chunks_of(n, lanes, chunk);
  return (Q * (encode ? kBytesEncode : kBytesDecode) + 3) / 4;
}

// Launch on `stream`.  x, out u8 [nb, n] with n % lanes == 0; table i32
// [nb, lanes, 256]; scratch i32 [mmtf_scan_scratch_ints(...)]; all
// contiguous.  encode != 0 encodes, else decodes; 1 <= chunk <= 1024 units.
// Returns the first launch error (cudaGetLastError()).
int mmtf_scan(const void* x, void* out, void* table, void* scratch,
              int64_t nb, int64_t n, int32_t lanes, int32_t encode,
              int32_t chunk, void* stream) {
  if (lanes < 1 || chunk < 1 || chunk > kMaxChunk || nb < 0 || n < 0 ||
      n % lanes != 0 || nb * chunks_of(n, lanes, chunk) > 0x7fffffff ||
      nb * lanes > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0) return static_cast<int>(cudaGetLastError());
  const auto* xp = static_cast<const uint8_t*>(x);
  auto* op = static_cast<uint8_t*>(out);
  auto* tp = static_cast<int32_t*>(table);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      encode ? run<true>(xp, op, tp, scratch, nb, n, lanes, chunk, s)
             : run<false>(xp, op, tp, scratch, nb, n, lanes, chunk, s));
}

}  // extern "C"
