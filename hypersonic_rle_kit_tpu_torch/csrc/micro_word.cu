// word_slice_sum, word_sampled_prefix: the two functions of the Pallas
// microbenchmark kernel of scripts/micro_word.py (mk(), the E3 bodies).
//
// Replaces the five Pallas bodies launched from mk() in
// scripts/micro_word.py.  They read a painted bf16 plane x[nb, R, 128] and
// write int32 [nb, R/4, 128]; with g = b * R/4 + r the row index of the
// output and x viewed as [nb * R, row]:
//
//   slice-sum       (body_slice_only, body_slice_i32)
//                   out[g, c] = sum_{j<4} x[4g + j, c]
//   sampled prefix  (body_smalls, body_fused4, body_big1), row == 128,
//                   j = c >> 5, k = c & 31, y = x[4g + j]:
//                   out[g, c] = 4 y[4k] + 3 y[4k+1] + 2 y[4k+2] + y[4k+3]
//
// The TPU built the sampled prefix as one-hot bf16 products on the MXU,
// because strided lane gathers are expensive there.  Here it is four
// multiply-adds on values a thread has loaded anyway.  Sums are taken in
// float32 and cast with round-toward-zero, as astype(int32) does.
//
// Bound: memory, 2 bytes read per input and 4 written per output (at
// nb=256, R=2048: 128 MiB in, 64 MiB out), no reuse.  Design: a grid-stride
// loop, each thread owns four consecutive outputs (one 16-byte store).
// Slice-sum reads 8 bytes from each of its four input rows; the sampled
// prefix reads the 32 contiguous bytes its outputs need (two 16-byte loads),
// so a warp reads 1 KiB in one contiguous run.  The wrappers admit only
// row % 4 == 0 and 16-byte-aligned x, which every such plane is.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 32;

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ float tap4(float a, float b, float c, float d) {
  return 4.0f * a + 3.0f * b + 2.0f * c + d;
}

// Thread item i holds outputs [4i, 4i + 4) of the flattened [G, row] output.
__global__ void slice_sum(const uint16_t* __restrict__ x,
                          int32_t* __restrict__ out, int64_t G, int row) {
  const int rq = row >> 2;
  const int64_t items = G * rq;
  for (int64_t i = blockIdx.x * int64_t(kThreads) + threadIdx.x; i < items;
       i += int64_t(gridDim.x) * kThreads) {
    const int64_t g = i / rq;
    const int c = static_cast<int>(i - g * rq) << 2;
    const uint16_t* src = x + 4 * g * row + c;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint2 u = *reinterpret_cast<const uint2*>(src + int64_t(j) * row);
      s0 += bf16_lo(u.x);
      s1 += bf16_hi(u.x);
      s2 += bf16_lo(u.y);
      s3 += bf16_hi(u.y);
    }
    *reinterpret_cast<int4*>(out + 4 * i) =
        make_int4(__float2int_rz(s0), __float2int_rz(s1), __float2int_rz(s2),
                  __float2int_rz(s3));
  }
}

// Row is 128.  Thread item i holds outputs c = 4q .. 4q + 3 of output row g
// (q = i % 32), which read the 16 inputs y[16 (q & 7) .. + 16) of input row
// 4g + (q >> 3).
__global__ void sampled_prefix(const uint16_t* __restrict__ x,
                               int32_t* __restrict__ out, int64_t G) {
  const int64_t items = G * 32;
  for (int64_t i = blockIdx.x * int64_t(kThreads) + threadIdx.x; i < items;
       i += int64_t(gridDim.x) * kThreads) {
    // input offset: (4g + (q >> 3)) * 128 + 16 (q & 7) == 16 i
    const uint4* src = reinterpret_cast<const uint4*>(x + 16 * i);
    const uint4 a = src[0];
    const uint4 b = src[1];
    *reinterpret_cast<int4*>(out + 4 * i) = make_int4(
        __float2int_rz(tap4(bf16_lo(a.x), bf16_hi(a.x), bf16_lo(a.y),
                            bf16_hi(a.y))),
        __float2int_rz(tap4(bf16_lo(a.z), bf16_hi(a.z), bf16_lo(a.w),
                            bf16_hi(a.w))),
        __float2int_rz(tap4(bf16_lo(b.x), bf16_hi(b.x), bf16_lo(b.y),
                            bf16_hi(b.y))),
        __float2int_rz(tap4(bf16_lo(b.z), bf16_hi(b.z), bf16_lo(b.w),
                            bf16_hi(b.w))));
  }
}

unsigned grid_for(int64_t items) {
  const int64_t b = (items + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

}  // namespace

extern "C" {

// Launch on `stream`.  x bf16 [G * 4, row] (as raw uint16), out i32
// [G, row], both contiguous and 16-byte aligned, row % 4 == 0.  Returns
// cudaGetLastError() after the launch.
int word_slice_sum(const void* x, void* out, int64_t G, int32_t row,
                   void* stream) {
  if (G > 0 && row > 0) {
    slice_sum<<<grid_for(G * (row / 4)), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(x), static_cast<int32_t*>(out), G, row);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch on `stream`.  x bf16 [G * 4, 128], out i32 [G, 128], contiguous
// and 16-byte aligned.  Returns cudaGetLastError() after the launch.
int word_sampled_prefix(const void* x, void* out, int64_t G, void* stream) {
  if (G > 0) {
    sampled_prefix<<<grid_for(G * 32), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(x), static_cast<int32_t*>(out), G);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* micro_word_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
