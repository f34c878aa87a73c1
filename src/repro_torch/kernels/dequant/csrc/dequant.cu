// Block-scale dequantization for Hopper: 1-byte codes times one f32 scale
// per 128-value block, widened to f32, for a list of segments in one
// launch.
//
// Replaces the TPU kernel repro/kernels/dequant/dequant.py (dequant_kernel,
// body _dequant_kernel): codes bitcast to int8 or float8_e4m3fn, widened,
// multiplied by their block's scale.
//
// A segment is one payload: its codes (any number of values), its scales
// (one per 128-value block, the last block may be ragged) and its count of
// values.  A KV restore widens all its blocks as one list.
//
// What bounds it on the H100: one multiply per value against 1 byte read
// and 4 bytes written, plus 4 bytes of scale per block, so it is bound by
// bytes (1 + 4 per value + 4 per block).  One restored 2 MiB KV block is
// only ~5 MB of traffic, so a launch per block pays the launch, the ramp
// and the wave's tail each time.  What the design does about it:
//   * one launch per list (up to MAX_SEGMENTS segments): the segment table
//     travels by value as a __grid_constant__ kernel parameter (no device
//     pointer table, so no extra host-to-device copy), and one output
//     buffer takes every segment at its prefix offset;
//   * a grid sized to the card (CTAS_PER_SM CTAs per SM, the SM count read
//     once) walking the list's 16-code units with a grid stride, one
//     16-byte code load a thread an iteration; the card's 1,024 resident
//     threads an SM keep the bytes in flight (2 or 4 loads a thread
//     before any store measured no faster on the H100 at a restore's
//     shape and slower at one block's);
//   * every store of a warp is 512 contiguous bytes: the warp's 32 units
//     are 4 whole quant blocks, its code loads (16 bytes a lane) go through
//     shared memory, and lane l widens codes [4l, 4l + 4) of each block
//     into one 16-byte store (a lane storing its own unit's 64 bytes
//     instead, four 16-byte stores 64 bytes apart across the warp, took
//     1.8x as long on the H100 at a restore's shape);
//   * a thread finds its unit's segment by a binary search over the prefix
//     array in parameter space (uniform within a warp almost everywhere);
//   * a ragged last block is masked in the kernel: its final unit reads
//     its codes byte by byte and only its values are stored, so no code
//     byte beyond a segment is read and no padded copy is needed.
//
// Numerics: fp8 codes widen two at a time through Hopper's paired
// conversion (cvt.rn.f16x2.e4m3x2: exact for every e4m3 value, the low
// byte to the low half) and half2 to float2 (exact); an int8 code converts
// exactly.  One f32 multiply by the scale then rounds once, as the plain
// version and the reference's LUT decode do.  Codes 0x7F and 0xFF are NaN
// (the encoder never emits them).
//
// Layout: each segment's codes uint8, 16-byte aligned, its scales f32,
// 4-byte aligned, both contiguous; out f32, 16-byte aligned, segment i at
// float offset 128 * prefix[i] (prefix counts quant blocks).  codec 0 =
// int8, 1 = fp8 (e4m3fn).  Plain stores: st.global.cs streaming stores on
// the output measured no faster with the L2 cold.

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_VALUES = 128;
constexpr int VEC = 16;                      // codes per unit: one uint4
constexpr int UNITS_PER_BLOCK = BLOCK_VALUES / VEC;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CTAS_PER_SM = 4;
// segments per launch: the table stays ~2 KB, under the classic 4 KB
// kernel parameter limit
constexpr int MAX_SEGMENTS = 64;

struct Segments {
  const uint8_t* codes[MAX_SEGMENTS];
  const float* scales[MAX_SEGMENTS];
  long long values[MAX_SEGMENTS];
  long long prefix[MAX_SEGMENTS + 1];        // quant blocks before segment i
  int count;
};

// The segment holding quant block ``blk``: the last i with prefix[i] <= blk.
__device__ __forceinline__ int find_segment(const Segments& seg,
                                            long long blk) {
  int lo = 0, hi = seg.count;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (seg.prefix[mid] <= blk) lo = mid; else hi = mid;
  }
  return lo;
}

// Four codes (little endian: the lowest byte first) widened and scaled.
template <int CODEC>
__device__ __forceinline__ float4 widen4(uint32_t w, float scale);

template <>
__device__ __forceinline__ float4 widen4<0>(uint32_t w, float scale) {
  return make_float4(
      static_cast<float>(static_cast<int8_t>(w & 0xffu)) * scale,
      static_cast<float>(static_cast<int8_t>((w >> 8) & 0xffu)) * scale,
      static_cast<float>(static_cast<int8_t>((w >> 16) & 0xffu)) * scale,
      static_cast<float>(static_cast<int8_t>(w >> 24)) * scale);
}

template <>
__device__ __forceinline__ float4 widen4<1>(uint32_t w, float scale) {
  const float2 lo = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w & 0xffffu), __NV_E4M3)));
  const float2 hi = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w >> 16), __NV_E4M3)));
  return make_float4(lo.x * scale, lo.y * scale, hi.x * scale, hi.y * scale);
}

// The first ``n`` (1..4) values of ``v`` at ``dst``.
__device__ __forceinline__ void store(float* dst, float4 v, int n) {
  if (n >= 4) {
    *reinterpret_cast<float4*>(dst) = v;
    return;
  }
  dst[0] = v.x;
  if (n > 1) dst[1] = v.y;
  if (n > 2) dst[2] = v.z;
}

// Unit u covers values [16 * (u % 8), +16) of quant block u / 8 (blocks
// counted over the whole list); a warp's 32 units are 4 whole blocks,
// and out[128 * blk, +128) is block blk's.
template <int CODEC>
__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
    dequant_segments_kernel(const __grid_constant__ Segments seg,
                            float* __restrict__ out, long long units) {
  __shared__ __align__(16) uint32_t stage[WARPS][BLOCK_VALUES];
  uint32_t* mine = stage[threadIdx.x / 32];
  const int lane = threadIdx.x % 32;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long wbase = static_cast<long long>(blockIdx.x) * THREADS +
                         (threadIdx.x - lane);
       wbase < units; wbase += stride) {
    const long long u = wbase + lane;
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    float scale = 0.f;
    int left = 0;                            // values of the unit's block
    if (u < units) {
      const long long blk = u / UNITS_PER_BLOCK;
      const int s = find_segment(seg, blk);
      const long long local = blk - seg.prefix[s];
      const long long rest = seg.values[s] - local * BLOCK_VALUES;
      left = static_cast<int>(rest < BLOCK_VALUES ? rest : BLOCK_VALUES);
      const int first = static_cast<int>(u % UNITS_PER_BLOCK) * VEC;
      const int n = left - first;            // codes of the unit
      const uint8_t* src = seg.codes[s] + local * BLOCK_VALUES + first;
      scale = __ldg(seg.scales[s] + local);
      if (n >= VEC) {
        packed = __ldg(reinterpret_cast<const uint4*>(src));
      } else if (n > 0) {                    // the ragged tail: byte loads
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int b = 0; b < VEC; ++b)
          if (b < n)
            w[b / 4] |= static_cast<uint32_t>(__ldg(src + b)) << (8 * (b % 4));
        packed = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    // lane l's 16 codes to shared memory; lane l then widens codes
    // [4l, 4l + 4) of each of the warp's 4 blocks
    reinterpret_cast<uint4*>(mine)[lane] = packed;
    __syncwarp();
    const long long blk0 = wbase / UNITS_PER_BLOCK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float sc = __shfl_sync(0xffffffffu, scale, 8 * i);
      const int n = __shfl_sync(0xffffffffu, left, 8 * i) - 4 * lane;
      if (n > 0)
        store(out + (blk0 + i) * BLOCK_VALUES + 4 * lane,
              widen4<CODEC>(mine[32 * i + lane], sc), n);
    }
    __syncwarp();
  }
}

// The card's SM count, read once per device.
cudaError_t sm_count(int* sms) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    e = cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return e;
  }
  *sms = cached[dev];
  return cudaSuccess;
}

}  // namespace

// C interface (ctypes).  Widens ``n`` segments (1 <= n <= 64) in one
// launch: segment i's ``values[i]`` codes at ``codes[i]`` and its
// ceil(values[i] / 128) scales at ``scales[i]`` land in ``out`` from
// float offset 128 * (quant blocks of the segments before it).  Returns a
// cudaError_t: 0 after a launch that was accepted.
extern "C" int dequant_segments_fwd(const void* const* codes,
                                    const void* const* scales,
                                    const long long* values, int n,
                                    void* out, int codec, void* stream) {
  if (n < 1 || n > MAX_SEGMENTS || (codec != 0 && codec != 1))
    return (int)cudaErrorInvalidValue;
  Segments seg;
  seg.count = n;
  seg.prefix[0] = 0;
  for (int i = 0; i < n; ++i) {
    if (values[i] <= 0) return (int)cudaErrorInvalidValue;
    seg.codes[i] = static_cast<const uint8_t*>(codes[i]);
    seg.scales[i] = static_cast<const float*>(scales[i]);
    seg.values[i] = values[i];
    seg.prefix[i + 1] =
        seg.prefix[i] + (values[i] + BLOCK_VALUES - 1) / BLOCK_VALUES;
  }
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const long long units = seg.prefix[n] * UNITS_PER_BLOCK;
  const long long full = (long long)sms * CTAS_PER_SM;
  const long long need = (units + THREADS - 1) / THREADS;
  const unsigned grid = (unsigned)(need < full ? need : full);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (codec == 0)
    dequant_segments_kernel<0><<<grid, THREADS, 0, s>>>(seg, o, units);
  else
    dequant_segments_kernel<1><<<grid, THREADS, 0, s>>>(seg, o, units);
  return (int)cudaGetLastError();
}

// The one-segment case: (nblocks, 128) codes and (nblocks,) scales.
extern "C" int dequant_fwd(const void* codes, const void* scales, void* out,
                           long long nblocks, int codec, void* stream) {
  const long long values = nblocks * BLOCK_VALUES;
  return dequant_segments_fwd(&codes, &scales, &values, 1, out, codec,
                              stream);
}
