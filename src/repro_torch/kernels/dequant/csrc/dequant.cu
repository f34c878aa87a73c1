// Block-scale dequantization for Hopper: 1-byte codes times one f32 scale
// per 128-value block, widened to f32.
//
// Replaces the TPU kernel repro/kernels/dequant/dequant.py (dequant_kernel,
// body _dequant_kernel): codes bitcast to int8 or float8_e4m3fn, widened,
// multiplied by their block's scale.
//
// What bounds it on the H100: one multiply per value against 1 byte read and
// 4 bytes written, so it is bound by bytes.  What the design does about it:
// each thread reads 16 codes with one 16-byte load and writes 16 floats with
// four 16-byte stores, neighbouring threads on neighbouring addresses; eight
// threads cover one 128-value block and read its scale (one broadcast
// address).  No shared memory and no loop: a grid of nblocks * 8 threads,
// the ragged last CTA masked, so any nblocks >= 1 is taken.
//
// Numerics: an fp8 code widens through Hopper's conversion to half
// (__nv_cvt_fp8_to_halfraw, exact for every e4m3 value) and half to float
// (exact); an int8 code converts exactly.  One f32 multiply by the scale
// then rounds once, as the plain version and the reference's LUT decode do.
// Codes 0x7F and 0xFF are NaN (the encoder never emits them).
//
// Layout: codes (nblocks, 128) uint8, 16-byte aligned; scales (nblocks,)
// f32; out (nblocks, 128) f32; all contiguous.  codec 0 = int8, 1 = fp8
// (e4m3fn).

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_VALUES = 128;
constexpr int VEC = 16;                      // codes per thread: one uint4
constexpr int LANES = BLOCK_VALUES / VEC;    // threads per quant block
constexpr int THREADS = 256;

template <int CODEC>
__device__ __forceinline__ float widen(uint32_t code);

template <>
__device__ __forceinline__ float widen<0>(uint32_t code) {
  return static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(code)));
}

template <>
__device__ __forceinline__ float widen<1>(uint32_t code) {
  const __half_raw h = __nv_cvt_fp8_to_halfraw(
      static_cast<__nv_fp8_storage_t>(code), __NV_E4M3);
  return __half2float(__half(h));
}

template <int CODEC>
__global__ void __launch_bounds__(THREADS)
    dequant_kernel(const uint4* __restrict__ codes,
                   const float* __restrict__ scales,
                   float4* __restrict__ out, long long nblocks) {
  const long long t =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long row = t / LANES;
  if (row >= nblocks) return;
  const float scale = __ldg(scales + row);
  const uint4 packed = __ldg(codes + t);
  const uint32_t words[4] = {packed.x, packed.y, packed.z, packed.w};
  float4* dst = out + t * (VEC / 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t w = words[i];  // little endian: the lowest byte first
    dst[i] = make_float4(widen<CODEC>(w & 0xffu) * scale,
                         widen<CODEC>((w >> 8) & 0xffu) * scale,
                         widen<CODEC>((w >> 16) & 0xffu) * scale,
                         widen<CODEC>(w >> 24) * scale);
  }
}

}  // namespace

// C interface (ctypes).  Returns a cudaError_t: 0 after a launch that was
// accepted.
extern "C" int dequant_fwd(const void* codes, const void* scales, void* out,
                           long long nblocks, int codec, void* stream) {
  if (nblocks <= 0 || (codec != 0 && codec != 1))
    return (int)cudaErrorInvalidValue;
  const long long threads = nblocks * LANES;
  const unsigned grid = (unsigned)((threads + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* c = static_cast<const uint4*>(codes);
  const float* sc = static_cast<const float*>(scales);
  float4* o = static_cast<float4*>(out);
  if (codec == 0)
    dequant_kernel<0><<<grid, THREADS, 0, s>>>(c, sc, o, nblocks);
  else
    dequant_kernel<1><<<grid, THREADS, 0, s>>>(c, sc, o, nblocks);
  return (int)cudaGetLastError();
}
