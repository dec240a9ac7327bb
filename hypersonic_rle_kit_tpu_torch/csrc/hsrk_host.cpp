// hypersonic-rle-kit-tpu native host runtime.
//
// Clean-room C++ implementations of the host-side hot paths, exposed with a
// C ABI for ctypes (no pybind11 in this environment):
//  - planar_from_bytes: run detection + planar command build (the host
//    encoder for the HRT1 container);
//  - hsrk_mmtf / hsrk_le_decode / hsrk_sh_decode: fast host decoders for
//    the MMTF / Low Entropy / SH families (Python goldens pin parity);
//  - unpack_container_batch: HRT1 payload -> planar columns (decode prep);
//  - decode_planar_batch: threaded host block decoder;
//  - rle8 reference-format compress/decompress (byte grammar per
//    formats/rle8.py; format spec derived from rle8_extreme_cpu.{c,h}).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libhsrk_host.so hsrk_host.cpp

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

// Blocks are independent (the whole point of the HRT1 container), so every
// batch entry point fans out over a small thread pool.  The reference is
// single-threaded by design (README.md:19); the TPU framework's host runtime
// is free to exceed that (SURVEY.md section 2.4).  HSRK_THREADS overrides.
int n_threads() {
  if (const char *e = std::getenv("HSRK_THREADS")) {
    const int n = std::atoi(e);
    if (n >= 1) return n > 64 ? 64 : n;
  }
  const unsigned hc = std::thread::hardware_concurrency();
  return hc ? (int)hc : 1;
}

template <class F>
int parallel_blocks(int64_t nb, F &&fn) {  // fn(b) -> 0 | error code
  const int nt = std::min<int64_t>(n_threads(), nb);
  if (nt <= 1) {
    for (int64_t b = 0; b < nb; b++)
      if (const int rc = fn(b)) return rc;
    return 0;
  }
  std::atomic<int64_t> next{0};
  std::atomic<int> rc{0};
  std::vector<std::thread> ts;
  ts.reserve(nt);
  for (int t = 0; t < nt; t++)
    ts.emplace_back([&] {
      for (;;) {
        const int64_t b = next.fetch_add(1, std::memory_order_relaxed);
        if (b >= nb || rc.load(std::memory_order_relaxed)) return;
        if (const int r = fn(b)) rc.store(r, std::memory_order_relaxed);
      }
    });
  for (auto &th : ts) th.join();
  return rc.load();
}

// first j >= i with d[j] != v
inline int64_t run_end(const uint8_t *d, int64_t i, int64_t n, uint8_t v) {
#if defined(__AVX2__)
  const __m256i bv = _mm256_set1_epi8((char)v);
  while (i + 32 <= n) {
    const __m256i x = _mm256_loadu_si256((const __m256i *)(d + i));
    const uint32_t neq = ~(uint32_t)_mm256_movemask_epi8(
        _mm256_cmpeq_epi8(x, bv));
    if (neq) return i + __builtin_ctz(neq);
    i += 32;
  }
#endif
  while (i < n && d[i] == v) i++;
  return i;
}

// first i in [i, n) where min_count equal bytes start; n if none.
// min_count equal bytes == (min_count-1) consecutive adjacent-equal pairs.
inline int64_t next_run_start(const uint8_t *d, int64_t i, int64_t n,
                              int32_t min_count) {
  const int32_t need = min_count - 1;
#if defined(__AVX2__)
  if (need >= 1 && need <= 27) {
    while (i + 33 <= n) {
      const __m256i a = _mm256_loadu_si256((const __m256i *)(d + i));
      const __m256i b = _mm256_loadu_si256((const __m256i *)(d + i + 1));
      uint32_t m = (uint32_t)_mm256_movemask_epi8(_mm256_cmpeq_epi8(a, b));
      uint32_t r = m;
      for (int32_t t = 1; t < need && r; t++) r &= m >> t;
      // a window of (32 - need) candidate start bits is fully decided here
      r &= (32 - need) >= 32 ? ~0u : ((1u << (32 - need)) - 1);
      if (r) return i + __builtin_ctz(r);
      i += 32 - need;
    }
  }
#endif
  while (i + min_count <= n) {
    const uint8_t v = d[i];
    int32_t k = 1;
    while (k < min_count && d[i + k] == v) k++;
    if (k == min_count) return i;
    i += k;  // d[i+k-1] != d[i+k-...]: no run of v starts before i+k? safe: advance by 1
  }
  return n;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// bytes -> planar commands (HRT1 host encoder; emission rule count >= min)
// ---------------------------------------------------------------------------

int planar_from_bytes(
    const uint8_t *data, int64_t n, int64_t cap, int64_t B, int32_t min_count,
    uint8_t *sym, int32_t *count, int32_t *lit_len, uint8_t *lits,
    int32_t *n_cmds, int32_t *n_lits, int32_t only_sym) {
  // single block of `n` bytes (n <= B); caller loops blocks.  only_sym < 0
  // emits every qualifying run, else only runs of that byte (Single
  // family, rle8_extreme_cpu.c:53-153).
  int64_t c = 0, nl = 0, last_end = 0;
  int64_t i = 0;
  while (i < n) {
    i = next_run_start(data, i, n, min_count);   // SIMD literal skip
    if (i >= n) break;
    const uint8_t v = data[i];
    const int64_t j = run_end(data, i + min_count, n, v);
    if (only_sym >= 0 && v != (uint8_t)only_sym) {  // stays in the literals
      i = j;
      continue;
    }
    if (c >= cap - 1) return -2;
    sym[c] = v;
    count[c] = (int32_t)(j - i);
    lit_len[c] = (int32_t)(i - last_end);
    memcpy(lits + nl, data + last_end, i - last_end);
    nl += i - last_end;
    last_end = j;
    c++;
    i = j;
  }
  // tail command
  sym[c] = 0;
  count[c] = 0;
  lit_len[c] = (int32_t)(n - last_end);
  memcpy(lits + nl, data + last_end, n - last_end);
  nl += n - last_end;
  c++;
  *n_cmds = (int32_t)c;
  *n_lits = (int32_t)nl;
  return 0;
}

// batch form: all blocks in one call (ctypes call overhead is ~us/block)
int planar_from_bytes_batch(
    const uint8_t *data, const int32_t *lens, int64_t nb, int64_t cap,
    int64_t B, int32_t min_count,
    uint8_t *sym, int32_t *count, int32_t *lit_len, uint8_t *lits,
    int32_t *n_cmds, int32_t *n_lits, const int32_t *only_sym) {
  return parallel_blocks(nb, [&](int64_t b) -> int {
    return planar_from_bytes(
        data + b * B, lens[b], cap, B, min_count, sym + b * cap,
        count + b * cap, lit_len + b * cap, lits + b * B, n_cmds + b,
        n_lits + b, only_sym ? only_sym[b] : -1);
  });
}

// ---------------------------------------------------------------------------
// planar commands -> bytes (host block decoder: memcpy literals + memset
// runs per command — the same loop shape as the reference's decode hot loop,
// rle8_extreme_cpu.h:1825-1913, threaded over independent blocks).  Output
// is [nb, B]; bytes past block_len[b] are zeroed (device decode semantics).
// ---------------------------------------------------------------------------

int decode_planar_batch(
    const uint8_t *sym, const int32_t *count, const int32_t *lit_len,
    const uint8_t *lits, const int32_t *n_cmds, const int32_t *block_len,
    int64_t nb, int64_t cap, int64_t B, uint8_t *out) {
  return parallel_blocks(nb, [&](int64_t b) -> int {
    const uint8_t *sy = sym + b * cap;
    const int32_t *ct = count + b * cap;
    const int32_t *ll = lit_len + b * cap;
    const uint8_t *li = lits + b * B;
    uint8_t *o = out + b * B;
    int64_t pos = 0, lp = 0;
    const int32_t nc = n_cmds[b];
    if (nc > cap) return -2;
    for (int32_t c = 0; c < nc; c++) {
      const int64_t l = ll[c];
      if (l < 0 || pos + l > B || lp + l > B) return -3;
      memcpy(o + pos, li + lp, l);
      lp += l;
      pos += l;
      const int64_t n = ct[c];
      if (!n) continue;
      if (n < 0 || pos + n > B) return -3;
      memset(o + pos, sy[c], n);
      pos += n;
    }
    if (pos != block_len[b]) return -4;
    if (pos < B) memset(o + pos, 0, B - pos);
    return 0;
  });
}

// ---------------------------------------------------------------------------
// reference-format rle8 (plain multi), byte-exact with formats/rle8.py
// ---------------------------------------------------------------------------

static const int MULTI_MIN = 6;

uint32_t hsrk_rle8_compress(const uint8_t *in, uint32_t n, uint8_t *out,
                            uint32_t cap) {
  if (!in || !n || !out || n > (1u << 30)) return 0;
  uint32_t idx = 9;
  out[8] = 0;  // mode multi
  uint32_t last_rle = 0;
  uint32_t i = 0;
  bool final_rle = false;
  while (i < n) {
    const uint8_t v = in[i];
    uint32_t j = i + 1;
    while (j < n && in[j] == v) j++;
    const uint32_t run = j - i;
    if (run >= MULTI_MIN) {
      const uint32_t stored = run - MULTI_MIN + 1;
      const uint32_t rng = i - last_rle + 1;
      out[idx++] = v;
      if (stored <= 255) {
        out[idx++] = (uint8_t)stored;
      } else {
        out[idx++] = 0;
        memcpy(out + idx, &stored, 4);
        idx += 4;
      }
      if (rng > 255) {
        out[idx++] = 0;
        memcpy(out + idx, &rng, 4);
        idx += 4;
      } else {
        out[idx++] = (uint8_t)rng;
      }
      memcpy(out + idx, in + last_rle, i - last_rle);
      idx += i - last_rle;
      last_rle = j;
      if (j == n) final_rle = true;
    }
    i = j;
  }
  if (final_rle) {
    memset(out + idx, 0, 2);
    idx += 2;
    memset(out + idx, 0, 4);
    idx += 4;
    out[idx++] = 0;
    memset(out + idx, 0, 4);
    idx += 4;
  } else {
    const uint32_t copy = n - last_rle;
    memset(out + idx, 0, 2);
    idx += 2;
    memset(out + idx, 0, 4);
    idx += 4;
    out[idx++] = 0;
    const uint32_t r1 = copy + 1;
    memcpy(out + idx, &r1, 4);
    idx += 4;
    memcpy(out + idx, in + last_rle, copy);
    idx += copy;
  }
  memcpy(out, &n, 4);
  memcpy(out + 4, &idx, 4);
  return idx;
}

uint32_t hsrk_rle8_decompress(const uint8_t *in, uint32_t in_size,
                              uint8_t *out, uint32_t cap) {
  if (!in || !out || in_size < 9) return 0;
  uint32_t usize, csize;
  memcpy(&usize, in, 4);
  memcpy(&csize, in + 4, 4);
  if (in[8] != 0 || usize > cap) return 0;
  const uint8_t *p = in + 9;
  uint8_t *o = out;
  for (;;) {
    const uint8_t s = *p++;
    uint32_t stored = *p++;
    if (!stored) {
      memcpy(&stored, p, 4);
      p += 4;
    }
    uint32_t rng = *p++;
    if (!rng) {
      memcpy(&rng, p, 4);
      p += 4;
      if (!rng) break;
    }
    rng--;
    memcpy(o, p, rng);
    p += rng;
    o += rng;
    if (!stored) break;
    const uint32_t run = stored + MULTI_MIN - 1;
    memset(o, s, run);
    o += run;
  }
  return usize;
}

// ---------------------------------------------------------------------------
// HRT1 container payload -> padded planar columns (decode host prep).
// Layout per block (parallel/container.py): bitpacked (count - min_count)
// for n_runs commands | bitpacked lit_len for n_cmds commands | run symbols
// (n_runs bytes) | literal bytes (n_lits).  Threaded over blocks.
// ---------------------------------------------------------------------------

namespace {

// little-endian w-bit fields starting at src; caller guarantees the source
// region holds ceil(nfields*w/8) bytes and 8 bytes of readable slack are
// provided via src_end clamping.
inline void unpack_bits(const uint8_t *src, int64_t src_bytes, int64_t n,
                        int32_t w, int32_t *dst, int32_t add) {
  if (w == 0) {
    for (int64_t i = 0; i < n; i++) dst[i] = add;
    return;
  }
  const uint64_t mask = (w >= 64) ? ~0ull : ((1ull << w) - 1);
  uint64_t bit = 0;
  for (int64_t i = 0; i < n; i++, bit += (uint64_t)w) {
    const int64_t byte = (int64_t)(bit >> 3);
    uint64_t win = 0;
    const int64_t take = std::min<int64_t>(8, src_bytes - byte);
    if (take > 0) std::memcpy(&win, src + byte, (size_t)take);
    dst[i] = (int32_t)((win >> (bit & 7)) & mask) + add;
  }
}

}  // namespace

// Deep-layout variant (FLAG_DEEP, parallel/container.py): two-tier
// escape-coded count/lit_len columns + 3-bit symbol-dictionary references.
// Returns nonzero on any inconsistency (escape/overflow or miss-count
// mismatch); the Python caller then falls back to the validating reader.
int unpack_container_deep_batch(
    const uint8_t *payload, const int64_t *payload_off,
    const int32_t *n_cmds, const int32_t *n_lits,
    const int32_t *cnt_bits, const int32_t *lit_bits,
    const int32_t *cnt_ovf_bits, const int32_t *ll_ovf_bits,
    const int32_t *n_cnt_ovf, const int32_t *n_ll_ovf, const int32_t *n_miss,
    const uint8_t *dict7, int64_t hdr_size,
    const int32_t *lit_k, const int32_t *n_lmiss,  // litdict (0 = raw lits)
    int64_t nb, int64_t cap, int64_t B, int32_t min_count,
    uint8_t *sym, int32_t *count, int32_t *lit_len, uint8_t *lits) {
  return parallel_blocks(nb, [&](int64_t b) -> int {
    const int64_t nc = n_cmds[b], nl = n_lits[b];
    const int64_t n_runs = nc - 1;
    if (nc < 1 || nc > cap || nl < 0 || nl > B) return 1;
    const int32_t cb = cnt_bits[b], lb = lit_bits[b];
    const int32_t cob = cnt_ovf_bits[b], lob = ll_ovf_bits[b];
    if (cb < 0 || cb > 32 || lb < 0 || lb > 32 || cob < 0 || cob > 32 ||
        lob < 0 || lob > 32)
      return 2;
    const int64_t ncov = n_cnt_ovf[b], nlov = n_ll_ovf[b], nms = n_miss[b];
    if (ncov < 0 || ncov > n_runs || nlov < 0 || nlov > nc || nms < 0 ||
        nms > n_runs)
      return 3;
    const uint8_t *p = payload + payload_off[b] + hdr_size;
    const int64_t cb_bytes = (cb * n_runs + 7) / 8;
    const int64_t cov_bytes = (cob * ncov + 7) / 8;
    const int64_t lb_bytes = (lb * nc + 7) / 8;
    const int64_t lov_bytes = (lob * nlov + 7) / 8;
    const int64_t lut_bytes = (3 * n_runs + 7) / 8;

    int32_t *cnt_dst = count + b * cap;
    unpack_bits(p, cb_bytes, n_runs, cb, cnt_dst, 0);
    std::vector<int32_t> ovf((size_t)std::max<int64_t>(ncov, 1));
    unpack_bits(p + cb_bytes, cov_bytes, ncov, cob, ovf.data(), 0);
    const int32_t cesc = cb ? (int32_t)((1u << cb) - 1) : -1;
    int64_t r = 0;
    for (int64_t i = 0; i < n_runs; i++) {
      if (cnt_dst[i] == cesc) {
        if (r >= ncov) return 4;
        cnt_dst[i] = ovf[(size_t)r++];
      }
      cnt_dst[i] += min_count;
    }
    if (r != ncov) return 4;
    std::memset(cnt_dst + n_runs, 0, (size_t)(cap - n_runs) * sizeof(int32_t));

    int32_t *ll_dst = lit_len + b * cap;
    const uint8_t *pl = p + cb_bytes + cov_bytes;
    unpack_bits(pl, lb_bytes, nc, lb, ll_dst, 0);
    std::vector<int32_t> lovf((size_t)std::max<int64_t>(nlov, 1));
    unpack_bits(pl + lb_bytes, lov_bytes, nlov, lob, lovf.data(), 0);
    const int32_t lesc = lb ? (int32_t)((1u << lb) - 1) : -1;
    r = 0;
    for (int64_t i = 0; i < nc; i++) {
      if (ll_dst[i] == lesc) {
        if (r >= nlov) return 5;
        ll_dst[i] = lovf[(size_t)r++];
      }
    }
    if (r != nlov) return 5;
    std::memset(ll_dst + nc, 0, (size_t)(cap - nc) * sizeof(int32_t));

    const uint8_t *ps = pl + lb_bytes + lov_bytes;
    std::vector<int32_t> lut((size_t)std::max<int64_t>(n_runs, 1));
    unpack_bits(ps, lut_bytes, n_runs, 3, lut.data(), 0);
    const uint8_t *miss = ps + lut_bytes;
    const uint8_t *d7 = dict7 + b * 7;
    uint8_t *sym_dst = sym + b * cap;
    std::memset(sym_dst, 0, (size_t)cap);
    int64_t m = 0;
    for (int64_t i = 0; i < n_runs; i++) {
      const int32_t idx = lut[(size_t)i];
      if (idx == 0) {
        if (m >= nms) return 6;
        sym_dst[i] = miss[m++];
      } else {
        sym_dst[i] = d7[idx - 1];
      }
    }
    if (m != nms) return 6;

    std::memset(lits + b * B, 0, (size_t)B);
    const int32_t lk = lit_k ? lit_k[b] : 0;
    if (lk == 0) {
      std::memcpy(lits + b * B, miss + nms, (size_t)nl);
      return 0;
    }
    // litdict: per-block literal dictionary (2^k - 1 bytes) + k-bit codes
    // + raw miss stream (container.FLAG_LITDICT)
    if (lk < 2 || lk > 8) return 7;
    const int64_t nd = (1 << lk) - 1;
    const uint8_t *ldict = miss + nms;
    const uint8_t *lcodes = ldict + nd;
    const int64_t lc_bytes = (lk * nl + 7) / 8;
    const uint8_t *lmiss = lcodes + lc_bytes;
    const int64_t nlm = n_lmiss[b];
    if (nlm < 0 || nlm > nl) return 7;
    std::vector<int32_t> lidx((size_t)std::max<int64_t>(nl, 1));
    unpack_bits(lcodes, lc_bytes, nl, lk, lidx.data(), 0);
    uint8_t *dst = lits + b * B;
    int64_t lm = 0;
    for (int64_t i = 0; i < nl; i++) {
      const int32_t li = lidx[(size_t)i];
      if (li == 0) {
        if (lm >= nlm) return 7;
        dst[i] = lmiss[lm++];
      } else {
        dst[i] = ldict[li - 1];
      }
    }
    if (lm != nlm) return 7;
    return 0;
  });
}

// litdict-only resolution for the device-pack path: each block's k-bit
// literal-dictionary codes + miss stream -> raw literal bytes (the other
// sections ship to the accelerator still packed).  lit_off[b] points at
// the block's literal dictionary (container._deep_sections offs[6]).
int resolve_litdict_batch(
    const uint8_t *payload, const int64_t *lit_off, const int32_t *n_lits,
    const int32_t *lit_k, const int32_t *n_lmiss,
    int64_t nb, int64_t L, uint8_t *lits) {
  return parallel_blocks(nb, [&](int64_t b) -> int {
    const int64_t nl = n_lits[b];
    const int32_t lk = lit_k[b];
    if (nl < 0 || nl > L || lk < 2 || lk > 8) return 1;
    const int64_t nd = (1 << lk) - 1;
    const uint8_t *ldict = payload + lit_off[b];
    const uint8_t *lcodes = ldict + nd;
    const int64_t lc_bytes = (lk * nl + 7) / 8;
    const uint8_t *lmiss = lcodes + lc_bytes;
    const int64_t nlm = n_lmiss[b];
    if (nlm < 0 || nlm > nl) return 2;
    std::vector<int32_t> lidx((size_t)std::max<int64_t>(nl, 1));
    unpack_bits(lcodes, lc_bytes, nl, lk, lidx.data(), 0);
    uint8_t *dst = lits + b * L;
    std::memset(dst, 0, (size_t)L);
    int64_t lm = 0;
    for (int64_t i = 0; i < nl; i++) {
      const int32_t li = lidx[(size_t)i];
      if (li == 0) {
        if (lm >= nlm) return 2;
        dst[i] = lmiss[lm++];
      } else {
        dst[i] = ldict[li - 1];
      }
    }
    if (lm != nlm) return 2;
    return 0;
  });
}

int unpack_container_batch(
    const uint8_t *payload, const int64_t *payload_off,
    const int32_t *n_cmds, const int32_t *n_lits,
    const int32_t *cnt_bits, const int32_t *lit_bits,
    int64_t nb, int64_t cap, int64_t B, int32_t min_count,
    uint8_t *sym, int32_t *count, int32_t *lit_len, uint8_t *lits) {
  return parallel_blocks(nb, [&](int64_t b) -> int {
    const int64_t nc = n_cmds[b], nl = n_lits[b];
    const int64_t n_runs = nc - 1;
    if (nc < 1 || nc > cap || nl < 0 || nl > B) return 1;
    if (cnt_bits[b] < 0 || cnt_bits[b] > 32 || lit_bits[b] < 0 ||
        lit_bits[b] > 32)
      return 2;
    const uint8_t *p = payload + payload_off[b];
    const int64_t cnt_bytes = (cnt_bits[b] * n_runs + 7) / 8;
    const int64_t lit_bytes = (lit_bits[b] * nc + 7) / 8;
    unpack_bits(p, cnt_bytes, n_runs, cnt_bits[b],
                count + b * cap, min_count);
    std::memset(count + b * cap + n_runs, 0,
                (size_t)(cap - n_runs) * sizeof(int32_t));
    unpack_bits(p + cnt_bytes, lit_bytes, nc, lit_bits[b],
                lit_len + b * cap, 0);
    std::memset(lit_len + b * cap + nc, 0,
                (size_t)(cap - nc) * sizeof(int32_t));
    std::memset(sym + b * cap, 0, (size_t)cap);
    std::memcpy(sym + b * cap, p + cnt_bytes + lit_bytes, (size_t)n_runs);
    std::memset(lits + b * B, 0, (size_t)B);
    std::memcpy(lits + b * B, p + cnt_bytes + lit_bytes + n_runs,
                (size_t)nl);
    return 0;
  });
}

// ---------------------------------------------------------------------------
// MMTF 128/256 transform (formats/mmtf.py golden; format per mmtf.c:112-380):
// `lanes` independent MTF-of-256 byte streams, trailing partial block looked
// up without updating the history.  A position table makes the find O(1) and
// the move O(depth); lanes parallelize over the thread pool.
// ---------------------------------------------------------------------------

int hsrk_mmtf(const uint8_t *in, int64_t n, int64_t lanes, int encode,
              uint8_t *out) {
  if (n <= 0) return 0;
  const int64_t full = n / lanes * lanes;
  return parallel_blocks(lanes, [&](int64_t lane) -> int {
    uint8_t hist[256], pos[256];
    for (int i = 0; i < 256; i++) hist[i] = pos[i] = (uint8_t)i;
    for (int64_t i = lane; i < full; i += lanes) {
      if (encode) {
        const uint8_t v = in[i];
        const int d = pos[v];
        out[i] = (uint8_t)d;
        for (int k = d; k > 0; k--) {
          hist[k] = hist[k - 1];
          pos[hist[k]] = (uint8_t)k;
        }
        hist[0] = v;
        pos[v] = 0;
      } else {
        const int d = in[i];
        const uint8_t v = hist[d];
        out[i] = v;
        for (int k = d; k > 0; k--) {
          hist[k] = hist[k - 1];
          pos[hist[k]] = (uint8_t)k;
        }
        hist[0] = v;
        pos[v] = 0;
      }
    }
    const int64_t tail = full + lane;   // history lookup, no update
    if (tail < n) out[tail] = encode ? pos[in[tail]] : hist[in[tail]];
    return 0;
  });
}

// ---------------------------------------------------------------------------
// Low Entropy decode body (formats/low_entropy.py golden; format per
// rle8_low_entropy_cpu.c:610-928): every compressed byte is a literal, an
// RLE-enabled byte is followed by one count byte mapping through the
// symbolsByProb permutation.  `out` must have >= want + 255 bytes.
// Returns 0 and sets *p_end, or 1 on a truncated stream.
// ---------------------------------------------------------------------------

int hsrk_le_decode(const uint8_t *buf, int64_t buf_len, int64_t p0,
                   const uint8_t *rle, const int32_t *stc,
                   uint8_t *out, int64_t want, int64_t *p_end,
                   int64_t *o_end) {
  int64_t p = p0, o = 0;
  while (o < want) {
    if (p >= buf_len) return 1;
    const uint8_t b = buf[p++];
    out[o++] = b;
    if (rle[b]) {
      if (p >= buf_len) return 1;
      const int32_t c = stc[buf[p++]];
      if (c) {
        memset(out + o, b, (size_t)c);
        o += c;
      }
    }
  }
  *p_end = p;
  *o_end = o;     // may overshoot `want` by a trailing run (callers carry it)
  return 0;
}

// ---------------------------------------------------------------------------
// RLE8 SH decode (formats/sh.py golden; format per rle_sh.c:509-660):
// forward byte stream + backward bit header from the claimed compressed
// size; 3-symbol adaptive recency model.  `out` must have out_cap bytes;
// returns 0 (done), 1 (truncated/overflow).
// ---------------------------------------------------------------------------

namespace {
struct ShBits {
  const uint8_t *buf;
  int64_t csize, bpos;
  int bbit;
  bool ok;
  int read1() {
    if (bpos >= csize) { ok = false; return 0; }
    const int b = (buf[csize - 1 - bpos] >> bbit) & 1;
    if (++bbit == 8) { bbit = 0; bpos++; }
    return b;
  }
};
}  // namespace

// Greedy Short encoder fast tier (formats/short.py _ShortEmitter +
// _compress_shortx_greedy transliterated; byte-exact vs the Python
// golden, which is parity-pinned to rleX_Xsl_short.h:746-1054).
namespace {
struct ShortEmitter {
  int s, sc, min_short, min_long, lut_bits, cbp, rbp;
  int max_pr, max_pc, invalid, rb;
  int64_t max_tc, max_tr;
  bool unbound, single_;
  uint8_t last_symbols[7][8];
  std::vector<uint8_t> out;
  int64_t last_rle = 0;

  ShortEmitter(int width, int sc_, bool byte_aligned, bool single) {
    s = width / 8;
    sc = sc_;
    single_ = single;
    unbound = byte_aligned || width == 8;
    if (sc != 0 || single) {
      min_short = 2;
      min_long = single ? (3 + 4 + 4) : (3 + 4 + 4 + s);
    } else {
      min_short = 1 + s + 1;
      min_long = 3 + 4 + 4 + s + 1;
    }
    lut_bits = sc == 0 ? 0 : sc == 1 ? 1 : sc == 3 ? 2 : 3;
    cbp = sc == 0 ? 4 : sc == 7 ? 2 : 3;
    rbp = 8 - lut_bits - cbp;
    max_pr = (1 << rbp) - 1;
    max_pc = (1 << cbp) - 2;
    invalid = (1 << cbp) - 1;
    rb = sc != 7 ? 24 - lut_bits - cbp - 9 : 24 - lut_bits - rbp - 9;
    max_tc = (1 << 9) - 1;
    max_tr = ((int64_t)1 << rb) - 1;
    static const uint8_t base[7] = {0x00, 0x7F, 0xFF, 0x01, 0x7E, 0x80, 0xFE};
    for (int j = 0; j < 7; j++)
      for (int k = 0; k < 8; k++)
        last_symbols[j][k] = sc == 1 ? 0x00 : base[j];
    out.assign(8, 0);
  }

  void push_u16(uint32_t v) {
    out.push_back((uint8_t)v);
    out.push_back((uint8_t)(v >> 8));
  }
  void push_u32(uint32_t v) {
    push_u16(v & 0xFFFF);
    push_u16(v >> 16);
  }

  bool process_symbol(const uint8_t *mv, int64_t i, int64_t count,
                      const uint8_t *symbol) {
    int match = 0;
    if (sc > 1) {
      while (match < sc && std::memcmp(last_symbols[match], symbol, s) != 0)
        match++;
    } else if (sc == 1) {
      match = std::memcmp(symbol, last_symbols[0], s) != 0 ? 1 : 0;
    }

    const int64_t rng = i - last_rle - count + 2;      // RANGE_OFFSET
    const int64_t stored = unbound ? count - min_short + 2
                                   : count / s - min_short / s + 2;
    const int64_t count3 = stored - 2;
    const int64_t range3 = rng - 2;
    const bool pack = range3 >= 0 && range3 <= max_pr && count3 >= 0 &&
                      count3 <= max_pc;
    const bool is19 = stored <= max_tc && rng <= max_tr;

    int64_t penalty = (sc != 0 && match == sc) ? s : 0;
    if (!pack) {
      penalty += 2;
      if (!is19) {
        penalty += rng <= 0xFFFFF ? (rng <= max_tr ? 0 : 2) : 4;
        penalty += stored <= 0xFFFFF ? (stored <= max_tc ? 0 : 2) : 4;
      }
    }
    if (!(count >= min_long || count >= min_short + penalty)) return false;

    if (sc == 1) {
      if (match) std::memcpy(last_symbols[0], symbol, s);
    } else if (sc > 1 && match > 0) {
      uint8_t tmp[8];
      std::memcpy(tmp, symbol, s);   // symbol may alias last_symbols
      const int upto = std::min(match, sc - 1);
      for (int k = upto; k > 0; k--)
        std::memcpy(last_symbols[k], last_symbols[k - 1], s);
      std::memcpy(last_symbols[0], tmp, s);
    }

    if (pack) {
      uint32_t b0 = (uint32_t)((count3 << rbp) | range3);
      if (sc != 0) b0 |= (uint32_t)match << (cbp + rbp);
      out.push_back((uint8_t)b0);
    } else {
      const int64_t storedx =
          (stored >= 0 && stored <= max_tc) ? stored
                                            : (stored <= 0xFFFF ? 1 : 0);
      const int64_t rangex = rng <= max_tr ? rng : (rng <= 0xFFFF ? 1 : 0);
      uint32_t vp1 = (uint32_t)((invalid << rbp)
                                | (((uint64_t)storedx << (rb - 8)) >> 8));
      if (sc != 0) vp1 |= (uint32_t)match << (cbp + rbp);
      const uint8_t vp2 =
          (uint8_t)((((uint64_t)storedx << (rb - 8)) | ((uint64_t)rangex >> 8))
                    & 0xFF);
      out.push_back((uint8_t)vp1);
      out.push_back(vp2);
      out.push_back((uint8_t)(rangex & 0xFF));
      if (stored != storedx) {
        if (stored <= 0xFFFF)
          push_u16((uint32_t)stored);
        else
          push_u32((uint32_t)stored);
      }
      if (rng != rangex) {
        if (rng <= 0xFFFF)
          push_u16((uint32_t)rng);
        else
          push_u32((uint32_t)rng);
      }
    }
    if (!single_ && (sc == 0 || match == sc))
      out.insert(out.end(), symbol, symbol + s);
    out.insert(out.end(), mv + last_rle, mv + (i - count));
    last_rle = i;
    return true;
  }

  void flush(const uint8_t *mv, int64_t i, int64_t count,
             const uint8_t *symbol) {
    const uint8_t b1 = sc == 3 ? 0b100 : sc == 7 ? 0b10 : 0b1000;
    if (process_symbol(mv, i, count, symbol)) {
      out.push_back((uint8_t)(invalid << rbp));
      out.push_back(b1);
      out.push_back(1);
      push_u16(0);
      push_u16(0);
      if (sc == 0 && !single_) out.push_back(0);
    } else {
      const int64_t copy_size = i - last_rle;
      out.push_back((uint8_t)(invalid << rbp));
      out.push_back(b1);
      out.push_back(0);
      push_u16(0);
      push_u32((uint32_t)(copy_size + 2));
      if (sc == 0 && !single_)
        for (int k = 0; k < s; k++) out.push_back(0);
      out.insert(out.end(), mv + last_rle, mv + last_rle + copy_size);
    }
  }
};

int short_match_len(const uint8_t *a, const uint8_t *b, int s) {
  if (std::memcmp(a, b, s) == 0) return s;
  if (s == 2) return a[0] == b[0] ? 1 : 0;
  int t = 0;
  while (t < s && a[t] == b[t]) t++;
  return t;
}
}  // namespace

int64_t hsrk_short_greedy_encode(const uint8_t *in, int64_t n, int32_t width,
                                 int32_t sc, uint8_t *dst, int64_t cap) {
  if (n == 0 || n > ((int64_t)1 << 30)) return 0;
  const int s = width / 8;
  std::vector<uint8_t> pad((size_t)(n + 2 * s + 8), 0);
  std::memcpy(pad.data(), in, (size_t)n);
  const uint8_t *mv = pad.data();

  ShortEmitter em(width, sc, /*byte_aligned=*/true, /*single=*/false);
  uint8_t symbol[8];
  for (int k = 0; k < s; k++) symbol[k] = (uint8_t)~mv[k];
  int64_t count = 0, i = 0;
  const int min_short = em.min_short;

  while (i < n) {
    if (count) {
      if (i + s <= n) {
        if (std::memcmp(mv + i, symbol, s) == 0) {
          count += s;
          i += s;
          continue;
        }
        if (s == 2) {
          if (mv[i] == symbol[0]) {
            count += 1;
            i += 1;
          }
        } else {
          int t = 0;
          while (t < s && mv[i + t] == symbol[t]) t++;
          count += t;
          i += t;
        }
      }
    }
    for (;;) {                 // not_a_full_match_but_a_match
      if (count >= 2) em.process_symbol(mv, i, count, symbol);
      std::memcpy(symbol, mv + i, s);
      const bool fits = i + s <= n;
      if (fits && std::memcmp(mv + i + s, symbol, s) == 0) {
        count = 2 * s;
        i += 2 * s;
        break;
      }
      if (fits) {
        const uint8_t *nxt = symbol;
        int possible_count = 0, possible_idx = 0;
        if (sc == 1) {
          if (s == 2)
            possible_count =
                std::memcmp(em.last_symbols[0], nxt, 2) == 0 ? 2 : 0;
          else
            possible_count = short_match_len(em.last_symbols[0], nxt, s);
        } else {
          for (int j = 0; j < sc; j++) {
            if (s == 2) {
              if (std::memcmp(em.last_symbols[j], nxt, 2) == 0) {
                possible_count = 2;
                possible_idx = j;
                break;
              }
            } else {
              if (std::memcmp(nxt, em.last_symbols[j], s) == 0) {
                possible_idx = j;
                possible_count = s;
                break;
              }
              const int psc = short_match_len(nxt, em.last_symbols[j], s);
              if (psc > possible_count) {
                possible_idx = j;
                possible_count = psc;
              }
            }
          }
        }
        const bool take =
            s != 2 ? possible_count >= min_short : possible_count != 0;
        if (take) {
          count = possible_count;
          i += possible_count;
          std::memcpy(symbol,
                      em.last_symbols[sc == 1 ? 0 : possible_idx], s);
          if (s != 2 && count < s) continue;
          break;
        }
        count = 0;
        i += 1;
        break;
      }
      count = 0;
      i += 1;
      break;
    }
  }

  em.flush(mv, i, count, symbol);
  const int64_t total = (int64_t)em.out.size();
  if (total > cap) return -1;
  // finalize: u32 n, u32 total at the head
  em.out[0] = (uint8_t)n; em.out[1] = (uint8_t)(n >> 8);
  em.out[2] = (uint8_t)(n >> 16); em.out[3] = (uint8_t)(n >> 24);
  em.out[4] = (uint8_t)total; em.out[5] = (uint8_t)(total >> 8);
  em.out[6] = (uint8_t)(total >> 16); em.out[7] = (uint8_t)(total >> 24);
  std::memcpy(dst, em.out.data(), (size_t)total);
  return total;
}

// SH encoder fast tier (formats/sh.py transliterated; the Python
// implementation is the byte-exact golden pinned against the C
// reference by the oracle parity suite).  Returns total size or -1.
namespace {
struct ShBitWriter {
  std::vector<uint8_t> completed;
  uint32_t cur = 0;
  int nextbit = 0;
  void write(uint32_t bits, int count) {
    for (int i = 0; i < count; i++) {
      cur |= (bits & 1u) << nextbit;
      bits >>= 1;
      nextbit = (nextbit + 1) & 7;
      if (nextbit == 0) {
        completed.push_back((uint8_t)cur);
        cur = 0;
      }
    }
  }
};
struct ShModel {
  uint8_t last_rle = 0x7F, second = 0x80, third = 0x7E, last_occured = 0x80;
};
constexpr int SH_MIN_COPY = 7, SH_MIN_RLE = 14, SH_MIN_CHANGE = 10,
              SH_MIN_ENC_COPY = 161;

void sh_emit_symbols(const uint8_t *data, int64_t pos, int64_t count,
                     std::vector<uint8_t> &out, ShBitWriter &hdr, ShModel &m,
                     bool encoded_ctx) {
  const uint32_t third_bits = encoded_ctx ? 0b111u : 0b0111u;
  const int third_len = encoded_ctx ? 3 : 4;
  for (int64_t k = 0; k < count; k++) {
    const uint8_t sym = data[pos + k];
    if (sym == m.last_rle) {
      hdr.write(0b0, 1);
    } else if (sym == m.second) {
      hdr.write(0b011, 3);
      m.last_occured = sym;
    } else if (sym == m.third) {
      hdr.write(third_bits, third_len);
      m.last_occured = sym;
    } else {
      hdr.write(0b01, 2);
      if (sym == m.last_occured) {
        m.third = m.second;
        m.second = sym;
      }
      m.last_occured = sym;
      out.push_back(sym);
    }
  }
}

void sh_push_u32(std::vector<uint8_t> &out, uint32_t v) {
  out.push_back((uint8_t)v);
  out.push_back((uint8_t)(v >> 8));
  out.push_back((uint8_t)(v >> 16));
  out.push_back((uint8_t)(v >> 24));
}

void sh_encoded_copy(const uint8_t *data, int64_t pos, int64_t count,
                     std::vector<uint8_t> &out, ShBitWriter &hdr,
                     ShModel &m) {
  int64_t remaining = count;
  while (remaining) {
    if (remaining > SH_MIN_ENC_COPY) {
      hdr.write(0b1111111, 7);
      const int64_t stored =
          std::min<int64_t>(0xFF, remaining - SH_MIN_ENC_COPY);
      const int64_t consumed = stored + SH_MIN_ENC_COPY;
      out.push_back((uint8_t)stored);
      sh_emit_symbols(data, pos, consumed, out, hdr, m, true);
      remaining -= consumed;
      pos += consumed;
    } else {
      sh_emit_symbols(data, pos, remaining, out, hdr, m, false);
      return;
    }
  }
}

void sh_copy(const uint8_t *data, int64_t pos, int64_t count,
             std::vector<uint8_t> &out, ShBitWriter &hdr, ShModel &m) {
  if (count > 255 + SH_MIN_COPY) {
    hdr.write(0b0111111, 7);
    sh_push_u32(out, (uint32_t)(count - SH_MIN_COPY));
    out.insert(out.end(), data + pos, data + pos + count);
  } else if (count >= SH_MIN_COPY) {
    hdr.write(0b0011111, 7);
    out.push_back((uint8_t)(count - SH_MIN_COPY));
    out.insert(out.end(), data + pos, data + pos + count);
  } else {
    sh_emit_symbols(data, pos, count, out, hdr, m, false);
  }
}
}  // namespace

int64_t hsrk_sh_encode(const uint8_t *buf, int64_t n, uint8_t *dst,
                       int64_t cap) {
  if (n == 0) return 0;
  std::vector<uint8_t> out;
  out.reserve((size_t)n + 64);
  ShBitWriter hdr;
  ShModel m;

  uint8_t last_symbol = 0;
  int64_t copy_count = 0, rle_change_count = 0, rle_count = 0;
  int64_t rle_symbol_copy_count = 0;
  bool last_was_same = false, last_was_copy = false;
  int64_t block_start = 0;

  for (int64_t i = 0; i < n; i++) {
    const uint8_t symbol = buf[i];
    if (symbol == m.last_rle) {
      if (!last_was_same) {
        if (rle_change_count >= SH_MIN_CHANGE) {
          sh_copy(buf, block_start, copy_count - rle_change_count, out, hdr,
                  m);
          block_start += copy_count;
          copy_count = 0;
          m.last_rle = last_symbol;
          hdr.write(0b1011111, 7);
          sh_push_u32(out, (uint32_t)(rle_change_count - SH_MIN_RLE));
          out.push_back(last_symbol);
          copy_count = 1;
          rle_symbol_copy_count = 0;
          rle_count = 0;
          last_was_same = false;
          rle_change_count = 1;
        } else {
          rle_count = 1;
          rle_symbol_copy_count += 1;
          last_was_same = true;
          rle_change_count = 0;
        }
        last_symbol = symbol;
      } else {
        rle_count += 1;
        rle_symbol_copy_count += 1;
        if (rle_count > SH_MIN_RLE) {
          const int64_t real_rle_copy = rle_symbol_copy_count - rle_count;
          if (real_rle_copy * 7 > (copy_count - real_rle_copy) * 2) {
            sh_encoded_copy(buf, block_start, copy_count, out, hdr, m);
          } else {
            sh_copy(buf, block_start, copy_count, out, hdr, m);
          }
          block_start += copy_count;
          copy_count = 0;
          rle_symbol_copy_count = 0;
          last_was_same = true;
          last_was_copy = false;
          last_symbol = symbol;
        }
      }
    } else {
      if (last_was_same && last_was_copy) {
        last_was_same = false;
        copy_count += rle_count;
        rle_count = 0;
      }
      if (symbol == last_symbol) {
        rle_change_count += 1;
      } else {
        if (rle_change_count >= SH_MIN_CHANGE) {
          const int64_t cc_wo = copy_count - rle_change_count;
          if (rle_symbol_copy_count * 7 >
              (cc_wo - rle_symbol_copy_count) * 2) {
            sh_encoded_copy(buf, block_start, cc_wo, out, hdr, m);
          } else {
            sh_copy(buf, block_start, cc_wo, out, hdr, m);
          }
          block_start += copy_count;
          copy_count = 0;
          rle_symbol_copy_count = 0;
          m.last_rle = last_symbol;
          hdr.write(0b1011111, 7);
          sh_push_u32(out, (uint32_t)(rle_change_count - SH_MIN_RLE));
          out.push_back(last_symbol);
        }
        rle_change_count = 1;
        last_symbol = symbol;
      }
      if (!last_was_copy) {
        if (rle_count > 255 + SH_MIN_RLE) {
          hdr.write(0b1011111, 7);
          sh_push_u32(out, (uint32_t)(rle_count - SH_MIN_RLE));
          out.push_back(m.last_rle);
        } else if (rle_count >= SH_MIN_RLE) {
          hdr.write(0b01111, 5);
          out.push_back((uint8_t)(rle_count - SH_MIN_RLE));
        } else {
          for (int64_t k = 0; k < rle_count; k++) hdr.write(0b0, 1);
        }
        block_start = i;
        copy_count = 1;
        rle_count = 0;
        rle_symbol_copy_count = 0;
        last_was_same = false;
        last_was_copy = true;
      } else {
        copy_count += 1;
      }
    }
  }

  if (last_was_copy) {
    if (last_was_same) {
      copy_count += rle_count;
      rle_count = 0;
    }
    sh_copy(buf, block_start, copy_count, out, hdr, m);
  } else {
    if (rle_count > 255 + SH_MIN_RLE) {
      hdr.write(0b1011111, 7);
      sh_push_u32(out, (uint32_t)(rle_count - SH_MIN_RLE));
      out.push_back(m.last_rle);
    } else if (rle_count >= SH_MIN_RLE) {
      hdr.write(0b01111, 5);
      out.push_back((uint8_t)(rle_count - SH_MIN_RLE));
    } else {
      for (int64_t k = 0; k < rle_count; k++) hdr.write(0b0, 1);
    }
  }

  hdr.write(0b0111111, 7);  // copy-large terminator
  sh_push_u32(out, 0);

  const int64_t hdr_tail = hdr.nextbit != 0 ? 1 : 0;
  const int64_t total = 8 + (int64_t)out.size() + hdr_tail +
                        (int64_t)hdr.completed.size();
  if (total > cap) return -1;
  uint8_t *p = dst;
  // head: u32 uncompressed size, u32 total size (patched below)
  p[0] = (uint8_t)n; p[1] = (uint8_t)(n >> 8);
  p[2] = (uint8_t)(n >> 16); p[3] = (uint8_t)(n >> 24);
  p[4] = (uint8_t)total; p[5] = (uint8_t)(total >> 8);
  p[6] = (uint8_t)(total >> 16); p[7] = (uint8_t)(total >> 24);
  std::memcpy(p + 8, out.data(), out.size());
  uint8_t *h = p + 8 + out.size();
  if (hdr_tail) *h++ = (uint8_t)hdr.cur;
  for (size_t k = hdr.completed.size(); k-- > 0;) *h++ = hdr.completed[k];
  return total;
}

int hsrk_sh_decode(const uint8_t *buf, int64_t csize, int64_t usize,
                   uint8_t *out, int64_t out_cap) {
  const int MIN_COPY = 7, MIN_RLE = 14, MIN_ENC_COPY = 161;
  uint8_t last_rle = 0x7F, second = 0x80, third = 0x7E, last_occured = 0x80;
  ShBits bits{buf, csize, 0, 0, true};
  int64_t p = 8, o = 0;

  auto emit_sym = [&](int64_t &o) -> bool {   // the 4-way symbol code
    if (bits.read1() == 0) {
      out[o++] = last_rle;
    } else if (bits.read1() == 0) {
      if (p >= csize) return false;
      const uint8_t sym = buf[p++];
      if (sym == last_occured) { third = second; second = sym; }
      last_occured = sym;
      out[o++] = sym;
    } else if (bits.read1() == 0) {
      out[o++] = second;
      last_occured = second;
    } else {
      out[o++] = third;
      last_occured = third;
    }
    return bits.ok;
  };

  while (o < usize) {
    int ones = 0;
    while (ones < 5 && bits.read1() == 1) ones++;
    if (!bits.ok) return 1;
    if (ones < 4) {                       // single symbol via recency model
      if (o + 1 > out_cap) return 1;
      if (ones == 0) {
        out[o++] = last_rle;
      } else if (ones == 1) {
        if (p >= csize) return 1;
        const uint8_t sym = buf[p++];
        if (sym == last_occured) { third = second; second = sym; }
        last_occured = sym;
        out[o++] = sym;
      } else if (ones == 2) {
        out[o++] = second;
        last_occured = second;
      } else {
        out[o++] = third;
        last_occured = third;
      }
    } else if (ones == 4) {               // rle small
      if (p >= csize) return 1;
      const int64_t cnt = (int64_t)buf[p++] + MIN_RLE;
      if (o + cnt > out_cap) return 1;
      memset(out + o, last_rle, (size_t)cnt);
      o += cnt;
    } else {
      const int b5 = bits.read1(), b6 = bits.read1();
      if (!bits.ok) return 1;
      if (b6 == 0 && b5 == 0) {           // copy small
        if (p >= csize) return 1;
        const int64_t cnt = (int64_t)buf[p++] + MIN_COPY;
        if (p + cnt > csize || o + cnt > out_cap) return 1;
        memcpy(out + o, buf + p, (size_t)cnt);
        p += cnt; o += cnt;
      } else if (b6 == 0 && b5 == 1) {    // copy large / terminator
        if (p + 4 > csize) return 1;
        uint32_t v;
        memcpy(&v, buf + p, 4); p += 4;
        if (v == 0) break;
        const int64_t cnt = (int64_t)v + MIN_COPY;
        if (p + cnt > csize || o + cnt > out_cap) return 1;
        memcpy(out + o, buf + p, (size_t)cnt);
        p += cnt; o += cnt;
      } else if (b6 == 1 && b5 == 0) {    // rle large (uint32 wrap)
        if (p + 5 > csize) return 1;
        uint32_t v;
        memcpy(&v, buf + p, 4); p += 4;
        const uint8_t sym = buf[p++];
        last_rle = sym;
        const int64_t cnt = (int64_t)(uint32_t)(v + (uint32_t)MIN_RLE);
        if (o + cnt > out_cap) return 1;
        memset(out + o, sym, (size_t)cnt);
        o += cnt;
      } else {                            // encoded copy
        if (p >= csize) return 1;
        const int64_t cnt = (int64_t)buf[p++] + MIN_ENC_COPY;
        if (o + cnt > out_cap) return 1;
        for (int64_t k = 0; k < cnt; k++)
          if (!emit_sym(o)) return 1;
      }
    }
  }
  // terminator before usize bytes were produced: fall back to the Python
  // golden (which returns a short buffer) instead of reporting success
  // with uninitialized tail memory (ADVICE r3)
  if (o < usize) return 1;
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Reference-stream grammar walkers -> planar columns (ops/ref_device.py's
// Python iterators, ported; those are byte-exact with formats/* which pin
// parity against the C library).  One walk is O(compressed); the planar
// build splits commands at fixed block boundaries and phase-decomposes
// multi-byte symbols (width > 8) into per-phase byte streams, mirroring
// ref_device.parse_to_planar exactly.  Two passes share the walker: pass 1
// counts per-block commands/literals, pass 2 fills the arrays.
// ---------------------------------------------------------------------------

namespace refwalk {

struct Sink {
  int64_t B = 0;            // block bytes (per phase)
  int nbp = 0, s = 1;
  int cap = 0, lcap = 0;    // 0 => counting pass
  uint8_t *sym = nullptr; int32_t *cnt = nullptr; int32_t *ll = nullptr;
  uint8_t *lits = nullptr;
  int32_t *n_cmds = nullptr, *n_lits = nullptr;
  std::vector<int64_t> pos;
  std::vector<int32_t> pend;
  int64_t gpos = 0;
  bool fail = false;

  void init(int64_t B_, int nbp_, int s_, int cap_, int lcap_,
            uint8_t *sym_, int32_t *cnt_, int32_t *ll_, uint8_t *lits_,
            int32_t *ncmds_, int32_t *nlits_) {
    B = B_; nbp = nbp_; s = s_; cap = cap_; lcap = lcap_;
    sym = sym_; cnt = cnt_; ll = ll_; lits = lits_;
    n_cmds = ncmds_; n_lits = nlits_;
    pos.assign(s, 0); pend.assign(s, 0);
    std::fill(n_cmds, n_cmds + (int64_t)s * nbp, 0);
    std::fill(n_lits, n_lits + (int64_t)s * nbp, 0);
  }

  inline void commit(int r, int64_t k, uint8_t sb, int32_t c) {
    const int64_t blk = (int64_t)r * nbp + k;
    const int32_t idx = n_cmds[blk]++;
    if (cap) {
      if (idx >= cap) { fail = true; return; }
      sym[blk * cap + idx] = sb;
      cnt[blk * cap + idx] = c;
      ll[blk * cap + idx] = pend[r];
    }
    pend[r] = 0;
  }

  // literal bytes for phase r: src, stride, n bytes
  inline void add_lits(int r, const uint8_t *src, int64_t stride, int64_t n) {
    int64_t i = 0;
    while (i < n && !fail) {
      const int64_t k = pos[r] / B;
      if (k >= nbp) { fail = true; return; }
      const int64_t room = (k + 1) * B - pos[r];
      const int64_t c = std::min(n - i, room);
      const int64_t li = n_lits[(int64_t)r * nbp + k];
      if (lcap) {
        if (li + c > lcap) { fail = true; return; }
        uint8_t *dst = lits + ((int64_t)r * nbp + k) * lcap + li;
        if (stride == 1) memcpy(dst, src + i, (size_t)c);
        else for (int64_t j = 0; j < c; j++) dst[j] = src[(i + j) * stride];
      }
      n_lits[(int64_t)r * nbp + k] += (int32_t)c;
      pend[r] += (int32_t)c;
      pos[r] += c;
      i += c;
      if (c == room) commit(r, k, 0, 0);
    }
  }

  inline void add_run(int r, uint8_t sb, int64_t length) {
    while (length > 0 && !fail) {
      const int64_t k = pos[r] / B;
      if (k >= nbp) { fail = true; return; }
      const int64_t room = (k + 1) * B - pos[r];
      const int64_t c = std::min(length, room);
      commit(r, k, sb, (int32_t)c);
      pos[r] += c;
      length -= c;
    }
  }

  // one grammar command: literal span [p, p+rng) then a run of nbytes of
  // the s-byte pattern (aligned to the run start)
  inline void emit(const uint8_t *buf, int64_t p, int64_t rng,
                   const uint8_t *pattern, int64_t nbytes) {
    if (s == 1) {
      if (rng) add_lits(0, buf + p, 1, rng);
      if (nbytes) add_run(0, pattern[0], nbytes);
      gpos += rng + nbytes;
      return;
    }
    if (rng) {
      for (int r = 0; r < s; r++) {
        const int64_t off = ((r - gpos) % s + s) % s;
        if (off < rng)
          add_lits(r, buf + p + off, s, (rng - off + s - 1) / s);
      }
      gpos += rng;
    }
    if (nbytes) {
      for (int r = 0; r < s; r++) {
        const int64_t off = ((r - gpos) % s + s) % s;
        if (off < nbytes)
          add_run(r, pattern[off % s], (nbytes - off + s - 1) / s);
      }
      gpos += nbytes;
    }
  }

  void finish(int64_t total_per_phase) {
    for (int r = 0; r < s && !fail; r++) {
      // pad ragged tail phases with zero literals (ref_device.py)
      if (pos[r] < total_per_phase)
        add_lits(r, nullptr, 0, 0);  // placeholder; caller pads via zeros
      const int64_t blk = (int64_t)r * nbp + (nbp - 1);
      if (pend[r] || n_cmds[blk] == 0) commit(r, nbp - 1, 0, 0);
    }
  }
};

struct Rd {
  const uint8_t *buf; int64_t len; int64_t p; bool fail = false;
  inline bool need(int64_t n) {
    if (p + n > len) { fail = true; return false; }
    return true;
  }
  inline uint32_t u8() { if (!need(1)) return 0; return buf[p++]; }
  inline uint32_t u16() {
    if (!need(2)) return 0;
    uint16_t v; memcpy(&v, buf + p, 2); p += 2; return v;
  }
  inline uint32_t u32() {
    if (!need(4)) return 0;
    uint32_t v; memcpy(&v, buf + p, 4); p += 4; return v;
  }
  inline const uint8_t *bytes(int64_t n) {
    if (!need(n)) return nullptr;
    const uint8_t *q = buf + p; p += n; return q;
  }
};

// shared MTF list for LUT/Short families
struct Mtf {
  uint8_t cur[16];
  uint8_t others[7][16];
  int s = 1, n = 0;
  void init(int s_, int lutsz, bool zero_cur) {
    static const uint8_t base[7] = {0x00, 0x7F, 0xFF, 0x01, 0x7E, 0x80, 0xFE};
    s = s_; n = lutsz > 0 ? lutsz - 1 : 0;
    memset(cur, zero_cur ? 0 : base[0], 16);
    if (lutsz > 0) memset(cur, base[0], 16);
    for (int k = 0; k < n; k++) memset(others[k], base[k + 1], 16);
  }
  inline void hit(int idx) {            // idx in [1, n]: rotate to front
    uint8_t tmp[16]; memcpy(tmp, others[idx - 1], 16);
    for (int k = idx - 1; k > 0; k--) memcpy(others[k], others[k - 1], 16);
    memcpy(others[0], cur, 16);
    memcpy(cur, tmp, 16);
  }
  inline void miss(const uint8_t *nsym) {   // new symbol from the stream
    for (int k = n - 1; k > 0; k--) memcpy(others[k], others[k - 1], 16);
    if (n > 0) memcpy(others[0], cur, 16);
    memcpy(cur, nsym, (size_t)s);
  }
};

}  // namespace refwalk

extern "C" {

// family: 0=rle8, 1=rlex(16..64), 2=rle128, 3=lut, 4=short
// flags: 1=packed, 2=byte_aligned, 4=single
// pass 1: cap == 0 -> counts only.  Returns 0 on success.
int ref_parse_planar(const uint8_t *buf, int64_t buflen,
                     int family, int width, int flags, int lutsz,
                     int64_t usize, int64_t block_size,
                     uint8_t *sym, int32_t *cnt, int32_t *ll, uint8_t *lits,
                     int32_t *n_cmds, int32_t *n_lits,
                     int cap, int lcap) {
  using namespace refwalk;
  const bool packed = flags & 1, byte_al = flags & 2, single = flags & 4;
  const int s = family == 0 ? 1 : (family == 2 ? 16 : width / 8);
  const int64_t m = (usize + s - 1) / s;
  const int nbp = (int)std::max<int64_t>(1, (m + block_size - 1) / block_size);
  Sink sink;
  sink.init(block_size, nbp, s, cap, lcap, sym, cnt, ll, lits,
            n_cmds, n_lits);
  Rd rd{buf, buflen, family == 0 ? 9 : 8};

  if (family == 0) {                                   // ---- rle8 ----
    if (buflen < 9) return 1;
    const uint8_t mode = buf[8];
    rd.p = 9;
    if (mode == 1) {                                   // single
      const uint8_t symbol = (uint8_t)rd.u8();
      const int min_r = packed ? 2 : 4;                // *_SINGLE_MIN_RANGE
      for (;;) {
        uint32_t stored = rd.u8();
        if (stored == 0) stored = rd.u32();
        uint32_t rng = rd.u8();
        if (rng == 0) { rng = rd.u32(); if (rng == 0) break; }
        if (rd.fail) return 1;
        rng -= 1;
        const int64_t p0 = rd.p;
        if (!rd.need(rng)) return 1;
        if (stored == 0) { sink.emit(buf, p0, rng, nullptr, 0); break; }
        sink.emit(buf, p0, rng, &symbol, (int64_t)stored + min_r - 1);
        rd.p += rng;
        if (sink.fail) return 2;
      }
    } else if (mode == 0) {                            // multi
      uint8_t symbol = 0;
      for (;;) {
        uint32_t stored, rng;
        if (!packed) {
          symbol = (uint8_t)rd.u8();
          stored = rd.u8();
          if (stored == 0) stored = rd.u32();
          rng = rd.u8();
          if (rng == 0) { rng = rd.u32(); if (rng == 0) break; }
        } else {
          const uint32_t b0 = rd.u8();
          stored = b0 & 0x7F;
          if (stored == 0) stored = rd.u32();
          if (!(b0 & 0x80)) symbol = (uint8_t)rd.u8();
          if (!rd.need(1)) return 1;
          const uint8_t r0 = buf[rd.p];
          if (r0 & 1) { rng = rd.u32() >> 1; if (rng == 0) break; }
          else { rng = r0 >> 1; rd.p += 1; }
        }
        if (rd.fail) return 1;
        rng -= 1;
        const int64_t p0 = rd.p;
        if (!rd.need(rng)) return 1;
        const int min_r = packed ? 3 : 6;              // *_MIN_RANGE_SHORT
        if (stored == 0) { sink.emit(buf, p0, rng, nullptr, 0); break; }
        sink.emit(buf, p0, rng, &symbol, (int64_t)stored + min_r - 1);
        rd.p += rng;
        if (sink.fail) return 2;
      }
    } else return 1;
  } else if (family == 1 || family == 2) {             // ---- rleX/128 ----
    if (buflen < 8) return 1;
    const bool prefer = packed && byte_al;
    int64_t min_short, dummy;
    if (family == 2) {
      min_short = packed ? 3 : 16 + 1 + 1 + 2;
    } else {
      min_short = packed ? 3 : s + 1 + 1 + 2;
    }
    (void)dummy;
    uint8_t symbol[16]; memset(symbol, 0, 16);
    for (;;) {
      uint32_t stored, rng;
      if (!packed) {
        const uint8_t *q = rd.bytes(s);
        if (!q) return 1;
        memcpy(symbol, q, (size_t)s);
        stored = rd.u8();
        if (stored == 0) stored = rd.u32();
      } else {
        const uint32_t b0 = rd.u8();
        stored = b0 & 0x7F;
        if (stored == 0) stored = rd.u32();
        if (!(b0 & 0x80)) {
          const uint8_t *q = rd.bytes(s);
          if (!q) return 1;
          memcpy(symbol, q, (size_t)s);
        }
      }
      if (prefer) {
        if (!rd.need(1)) return 1;
        const uint8_t r0 = buf[rd.p];
        if (r0 & 1) { rng = rd.u32() >> 1; if (rng == 0) break; }
        else { rng = r0 >> 1; rd.p += 1; }
      } else {
        rng = rd.u8();
        if (rng == 0) { rng = rd.u32(); if (rng == 0) break; }
      }
      if (rd.fail) return 1;
      rng -= 1;
      const int64_t p0 = rd.p;
      if (!rd.need(rng)) return 1;
      if (stored == 0) { sink.emit(buf, p0, rng, symbol, 0); break; }
      int64_t nbytes;
      if (!byte_al) nbytes = ((int64_t)stored + min_short / s - 1) * s;
      else nbytes = (int64_t)stored + min_short - 1;
      sink.emit(buf, p0, rng, symbol, nbytes);
      rd.p += rng;
      if (sink.fail) return 2;
    }
  } else if (family == 3) {                            // ---- LUT ----
    if (buflen < 8) return 1;
    const int range_bits = lutsz == 3 ? 7 : 6;
    const uint32_t max_tc = 127, max_tr = (1u << range_bits) - 1;
    const int sym_shift = lutsz == 3 ? 14 : 13;
    const bool unbound = byte_al || width == 8;
    const int64_t MIN_SHORT = 3, COUNT_OFFSET = 2, RANGE_OFFSET = 2;
    Mtf mtf; mtf.init(s, lutsz, false);
    for (;;) {
      const uint32_t value = rd.u16();
      uint32_t rng = value & max_tr;
      uint32_t stored = (value >> range_bits) & max_tc;
      const uint32_t sym_idx = value >> sym_shift;
      if ((int)sym_idx == lutsz) {
        const uint8_t *q = rd.bytes(s);
        if (!q) return 1;
        mtf.miss(q);
      } else if (sym_idx > 0) {
        mtf.hit((int)sym_idx);
      }
      if (stored == 0) stored = rd.u32();
      else if (stored == 1) stored = rd.u16();
      if (rng == 0) rng = rd.u32();
      else if (rng == 1) { rng = rd.u16(); if (rng == 0) break; }
      if (rd.fail) return 1;
      rng -= RANGE_OFFSET;
      const int64_t p0 = rd.p;
      if (!rd.need(rng)) return 1;
      if (stored == 0) { sink.emit(buf, p0, rng, mtf.cur, 0); break; }
      int64_t nbytes;
      if (unbound) nbytes = (int64_t)stored + MIN_SHORT - COUNT_OFFSET;
      else nbytes = ((int64_t)stored + MIN_SHORT / s - COUNT_OFFSET) * s;
      sink.emit(buf, p0, rng, mtf.cur, nbytes);
      rd.p += rng;
      if (sink.fail) return 2;
    }
  } else if (family == 4) {                            // ---- Short ----
    if (buflen < 8) return 1;
    const int lut_bits = lutsz == 0 ? 0 : (lutsz == 1 ? 1 : (lutsz == 3 ? 2 : 3));
    const int cbp = lutsz == 0 ? 4 : (lutsz == 7 ? 2 : 3);
    const int rbp = 8 - lut_bits - cbp;
    const uint32_t max_pr = (1u << rbp) - 1;
    const uint32_t invalid = (1u << cbp) - 1;
    const int rb = lutsz != 7 ? (24 - lut_bits - cbp - 9)
                              : (24 - lut_bits - rbp - 9);
    const bool unbound = byte_al || width == 8;
    const int64_t COUNT_OFFSET = 2, RANGE_OFFSET = 2;
    int64_t min_short;
    if (lutsz != 0 || single) min_short = 2;
    else min_short = 1 + s + 1;
    Mtf mtf;
    uint8_t single_sym[16]; memset(single_sym, 0, 16);
    if (single) {
      const uint8_t *q = rd.bytes(s);
      if (!q) return 1;
      memcpy(single_sym, q, (size_t)s);
    } else {
      mtf.init(s, lutsz, lutsz == 0);
      if (lutsz == 0) memset(mtf.cur, 0, 16);
    }
    const uint8_t *cursym = single ? single_sym : mtf.cur;
    for (;;) {
      const uint32_t b0 = rd.u8();
      const uint32_t sym_idx = b0 >> (cbp + rbp);
      const uint32_t count3 = (b0 >> rbp) & invalid;
      uint32_t stored, rng;
      if (count3 == invalid) {
        const uint32_t b1 = rd.u8(), b2 = rd.u8();
        stored = (b1 >> (rb - 8)) | ((b0 & max_pr) << (8 - (rb - 8)));
        rng = b2 | ((b1 & ((1u << (rb - 8)) - 1)) << 8);
        if (stored == 0) stored = rd.u32();
        else if (stored == 1) stored = rd.u16();
        if (rng == 0) rng = rd.u32();
        else if (rng == 1) { rng = rd.u16(); if (rng == 0) break; }
      } else {
        stored = count3 + COUNT_OFFSET;
        rng = (b0 & max_pr) + RANGE_OFFSET;
      }
      if (!single) {
        if (lutsz == 0) {
          const uint8_t *q = rd.bytes(s);
          if (!q) return 1;
          memcpy(mtf.cur, q, (size_t)s);
        } else if (lutsz == 1) {
          if (sym_idx == 1) {
            const uint8_t *q = rd.bytes(s);
            if (!q) return 1;
            memcpy(mtf.cur, q, (size_t)s);
          }
        } else {
          if ((int)sym_idx == lutsz) {
            const uint8_t *q = rd.bytes(s);
            if (!q) return 1;
            mtf.miss(q);
          } else if (sym_idx > 0) {
            mtf.hit((int)sym_idx);
          }
        }
      }
      if (rd.fail) return 1;
      rng -= RANGE_OFFSET;
      const int64_t p0 = rd.p;
      if (!rd.need(rng)) return 1;
      if (stored == 0) { sink.emit(buf, p0, rng, cursym, 0); break; }
      int64_t nbytes;
      if (unbound) nbytes = (int64_t)stored + min_short - COUNT_OFFSET;
      else nbytes = ((int64_t)stored + min_short / s - COUNT_OFFSET) * s;
      sink.emit(buf, p0, rng, cursym, nbytes);
      rd.p += rng;
      if (sink.fail) return 2;
    }
  } else return 1;

  if (sink.fail || rd.fail) return 2;
  // pad ragged tail phases with zero literals, then flush pendings
  if (s > 1) {
    static const uint8_t zeros[16] = {0};
    for (int r = 0; r < s; r++) {
      const int64_t real = (usize - r + s - 1) / s;
      if (m > real && real >= 0) {
        int64_t padn = m - (real > 0 ? real : 0);
        while (padn > 0 && !sink.fail) {
          const int64_t c = std::min<int64_t>(padn, 16);
          sink.add_lits(r, zeros, 1, c);
          padn -= c;
        }
      }
    }
  }
  for (int r = 0; r < s; r++) {
    const int64_t blk = (int64_t)r * nbp + (nbp - 1);
    if (sink.pend[r] || sink.n_cmds[blk] == 0) sink.commit(r, nbp - 1, 0, 0);
  }
  return sink.fail ? 2 : 0;
}

}  // extern "C"
