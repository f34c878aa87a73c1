// Flash attention forward (prefill) for Hopper, bf16 in and out, f32 math.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py
// (flash_attention_kernel, body _flash_kernel): causal and/or sliding-window
// GQA attention with an online softmax over KV tiles, tiles wholly above the
// diagonal or outside the window skipped, kv head = h * KV / H.
//
// What bounds it on the H100: a causal prefill of S tokens does about
// 4*(S*S/2)*D*H operations on 4*S*H*D*2 bytes (q, k, v, o), S/4 operations
// per byte, so below ~1200 tokens (the card's ~295 operations per byte)
// the bytes bound it and above that the operations.  This first version
// computes both products on the CUDA cores in f32 (no tensor cores), so in
// practice its own f32 and shared-memory rates bound it, far above either
// figure.  What the design does about it: each block keeps
// a 64-row query tile (pre-scaled, f32) in shared memory for the whole KV
// loop and stages each 64-row K/V tile once, so every K/V element read from
// device memory feeds 64 query rows; the (64 x 64) score tile never leaves
// shared memory.  mma.sync / wgmma and TMA are later work.
//
// Layout: q (B, Sq, H, D), k and v (B, Sk, KV, D), o (B, Sq, H, D), all
// contiguous.  Grid (ceil(Sq/64), H, B), 128 threads.  Any Sq and Sk: the
// ragged edge is masked in the kernel, never padded.  H % KV == 0 with any
// ratio.  Masks and constants follow _flash_kernel: NEG_INF = -1e30,
// denominator max(l, 1e-30).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per KV tile
constexpr int THREADS = 128;
constexpr int SP = BK + 1;    // padded score-row stride (floats)
constexpr float NEG_INF = -1e30f;

template <int D>
struct Smem {
  static constexpr int KP = D + 2;  // padded K row (bf16): odd 32-bit stride
  static constexpr size_t q_bytes = sizeof(float) * BQ * D;
  static constexpr size_t k_bytes = sizeof(__nv_bfloat16) * BK * KP;
  static constexpr size_t v_bytes = sizeof(__nv_bfloat16) * BK * D;
  static constexpr size_t p_bytes = sizeof(float) * BQ * SP;
  static constexpr size_t row_bytes = sizeof(float) * BQ;
  static constexpr size_t total = q_bytes + k_bytes + v_bytes + p_bytes
                                  + 3 * row_bytes;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o,
                 int sq, int sk, int h, int kv, int causal, int window,
                 float scale) {
  using S = Smem<D>;
  constexpr int KP = S::KP;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + S::q_bytes);
  __nv_bfloat16* v_s =
      reinterpret_cast<__nv_bfloat16*>(smem + S::q_bytes + S::k_bytes);
  float* p_s = reinterpret_cast<float*>(smem + S::q_bytes + S::k_bytes
                                        + S::v_bytes);
  float* m_s = p_s + BQ * SP;
  float* l_s = m_s + BQ;
  float* corr_s = l_s + BQ;

  const int t = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int g = hh * kv / h;  // kv head, as the TPU kernel's index map

  // query tile, pre-scaled in f32 (rows past Sq are zero and never stored)
  for (int i = t; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D, row = q0 + r;
    float val = 0.f;
    if (row < sq)
      val = __bfloat162float(q[((size_t)(b * sq + row) * h + hh) * D + d])
            * scale;
    q_s[i] = val;
  }
  if (t < BQ) {
    m_s[t] = NEG_INF;
    l_s[t] = 0.f;
  }

  // PV mapping: thread owns output column d for NR rows r = rg + RG*i
  constexpr int RG = THREADS / D;  // row groups
  constexpr int NR = BQ / RG;
  const int od = t % D, rg = t / D;
  float acc[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = 0.f;

  // score mapping: thread owns key column c for 32 rows r = sr + 2*i
  const int c = t % BK, sr = t / BK;

  const int nk = (sk + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    // tile-level skip (uniform over the block), as _flash_kernel's pl.when
    bool run = true;
    if (causal) run = k0 <= q0 + BQ - 1;
    if (window > 0) run = run && (k0 + BK - 1 > q0 - window);
    if (!run) continue;

    __syncthreads();  // previous tile's readers are done with k_s/v_s/p_s
    // stage K and V: 16-byte global loads, rows past Sk zero-filled
    for (int i = t; i < BK * (D / 8); i += THREADS) {
      const int j = i / (D / 8), d8 = (i % (D / 8)) * 8, row = k0 + j;
      uint4 kk = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (row < sk) {
        const size_t off = ((size_t)(b * sk + row) * kv + g) * D + d8;
        kk = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      uint32_t* kdst = reinterpret_cast<uint32_t*>(k_s + j * KP + d8);
      kdst[0] = kk.x; kdst[1] = kk.y; kdst[2] = kk.z; kdst[3] = kk.w;
      *reinterpret_cast<uint4*>(v_s + j * D + d8) = vv;
    }
    __syncthreads();

    // scores s[r][c] = q[r] . k[c], masked as _flash_kernel masks
    {
      float s[BQ / 2];
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) s[i] = 0.f;
      const __nv_bfloat162* krow =
          reinterpret_cast<const __nv_bfloat162*>(k_s + c * KP);
#pragma unroll 4
      for (int d2 = 0; d2 < D / 2; ++d2) {
        const float2 kf = __bfloat1622float2(krow[d2]);
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) {
          const float2 qf =
              *reinterpret_cast<const float2*>(q_s + (sr + 2 * i) * D + 2 * d2);
          s[i] = fmaf(qf.x, kf.x, s[i]);
          s[i] = fmaf(qf.y, kf.y, s[i]);
        }
      }
      const int kpos = k0 + c;
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int r = sr + 2 * i, qpos = q0 + r;
        bool ok = kpos < sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        p_s[r * SP + c] = ok ? s[i] : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: two threads per row, 32 keys each
    {
      const int r = t / 2, half = t % 2;
      float* row = p_s + r * SP + half * (BK / 2);
      const float m_prev = m_s[r], l_prev = l_s[r];
      float mx = NEG_INF;
      for (int j = 0; j < BK / 2; ++j) mx = fmaxf(mx, row[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = 0; j < BK / 2; ++j) {
        const float p = expf(row[j] - m_new);
        row[j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float corr = expf(m_prev - m_new);
      __syncwarp();
      if (half == 0) {
        m_s[r] = m_new;
        l_s[r] = l_prev * corr + sum;
        corr_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P @ V
#pragma unroll
    for (int i = 0; i < NR; ++i) acc[i] *= corr_s[rg + RG * i];
    for (int j = 0; j < BK; ++j) {
      const float vj = __bfloat162float(v_s[j * D + od]);
#pragma unroll
      for (int i = 0; i < NR; ++i)
        acc[i] = fmaf(p_s[(rg + RG * i) * SP + j], vj, acc[i]);
    }
  }

  __syncthreads();
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = rg + RG * i, row = q0 + r;
    if (row < sq)
      o[((size_t)(b * sq + row) * h + hh) * D + od] =
          __float2bfloat16(acc[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int sq, int sk, int h, int kv, int causal,
                   int window, float scale, cudaStream_t stream) {
  const size_t smem = Smem<D>::total;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      sq, sk, h, kv, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// C interface (ctypes).  window <= 0 means no window.  Returns a
// cudaError_t: 0 after a launch that was accepted.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int b, int sq,
                                   int sk, int h, int kv, int d, int causal,
                                   int window, float scale, void* stream) {
  if (sq == 0 || b == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<32>(q, k, v, o, b, sq, sk, h, kv, causal, window, scale, s);
    case 64: return launch<64>(q, k, v, o, b, sq, sk, h, kv, causal, window, scale, s);
    case 128: return launch<128>(q, k, v, o, b, sq, sk, h, kv, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
