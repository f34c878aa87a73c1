// Paged decode attention for Hopper: one new query token per sequence
// against that sequence's KV pages.  bf16 in and out, f32 math.
//
// Replaces the TPU kernel repro/kernels/paged_attention/paged_attention.py
// (paged_attention_kernel, body _paged_kernel): pages addressed through a
// block table, GQA computed as (KV, H/KV, D), an online softmax over pages,
// pages past ceil(len/page) skipped.
//
// What bounds it on the H100: each cached key and value is read once and
// used for H/KV query heads, about 4*(H/KV) operations per 4 bytes, so it is
// bound by bytes (the KV cache stream).  What the design does about it: one
// block per (sequence, KV head) reads that head's pages exactly once with
// 16-byte loads and serves all H/KV query heads from shared memory, and
// blocks of short sequences stop at their own length.  The block walks its
// pages in order, one page in flight at a time, so a long sequence is
// latency-bound; a split over pages with a final reduction is later work.
//
// Layout: q (B, H, D), k_pages and v_pages (P, page, KV, D), block_tables
// (B, pages_max) int32, lengths (B,) int32, out (B, H, D); all contiguous.
// Grid (KV, B), 128 threads.  Constants follow _paged_kernel: NEG_INF =
// -1e30, denominator max(l, 1e-30).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;

struct Layout {
  int rep, page, d;
  size_t q, kv, s, acc, rows;  // byte offsets
  size_t total;
  __host__ __device__ Layout(int rep_, int page_, int d_)
      : rep(rep_), page(page_), d(d_) {
    q = 0;                                                  // rep*d f32
    kv = q + sizeof(float) * rep * d;                       // 2 * page*d bf16
    s = kv + 2 * sizeof(__nv_bfloat16) * page * d;          // rep*page f32
    acc = s + sizeof(float) * ((rep * page + 3) / 4 * 4);   // rep*d f32
    rows = acc + sizeof(float) * rep * d;                   // 3*rep f32
    total = rows + sizeof(float) * 3 * rep;
  }
};

__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_pages,
                    const __nv_bfloat16* __restrict__ v_pages,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out,
                    int h, int kv, int d, int page, int pages_max,
                    float scale) {
  const int rep = h / kv;
  const Layout L(rep, page, d);
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + L.kv);
  __nv_bfloat16* v_s = k_s + page * d;
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* acc_s = reinterpret_cast<float*>(smem + L.acc);
  float* m_s = reinterpret_cast<float*>(smem + L.rows);
  float* l_s = m_s + rep;
  float* corr_s = l_s + rep;

  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int g = blockIdx.x, b = blockIdx.y;
  const int length = lengths[b];
  int n_pages = (length + page - 1) / page;
  if (n_pages > pages_max) n_pages = pages_max;

  // this KV head's query heads g*rep .. g*rep+rep-1, pre-scaled in f32
  const __nv_bfloat16* qb = q + ((size_t)b * h + (size_t)g * rep) * d;
  for (int i = t; i < rep * d; i += THREADS) {
    q_s[i] = __bfloat162float(qb[i]) * scale;
    acc_s[i] = 0.f;
  }
  for (int r = t; r < rep; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }

  const int chunks = d / 8;  // 16-byte chunks per row
  for (int j = 0; j < n_pages; ++j) {
    const int pid = block_tables[(size_t)b * pages_max + j];
    __syncthreads();  // previous page's readers are done
    for (int i = t; i < page * chunks; i += THREADS) {
      const int tok = i / chunks, c8 = (i % chunks) * 8;
      const size_t off = (((size_t)pid * page + tok) * kv + g) * d + c8;
      *reinterpret_cast<uint4*>(k_s + tok * d + c8) =
          *reinterpret_cast<const uint4*>(k_pages + off);
      *reinterpret_cast<uint4*>(v_s + tok * d + c8) =
          *reinterpret_cast<const uint4*>(v_pages + off);
    }
    __syncthreads();

    // scores: one warp per (query head, token) pair, lanes split D
    for (int pair = warp; pair < rep * page; pair += WARPS) {
      const int r = pair / page, tok = pair % page;
      const __nv_bfloat162* krow =
          reinterpret_cast<const __nv_bfloat162*>(k_s + tok * d);
      const float* qrow = q_s + r * d;
      float acc = 0.f;
      for (int d2 = lane; d2 < d / 2; d2 += 32) {
        const float2 kf = __bfloat1622float2(krow[d2]);
        acc = fmaf(qrow[2 * d2], kf.x, acc);
        acc = fmaf(qrow[2 * d2 + 1], kf.y, acc);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0)
        s_s[r * page + tok] = (j * page + tok < length) ? acc : NEG_INF;
    }
    __syncthreads();

    // online softmax: one thread per query head
    for (int r = t; r < rep; r += THREADS) {
      float* row = s_s + r * page;
      const float m_prev = m_s[r];
      float mx = NEG_INF;
      for (int tok = 0; tok < page; ++tok) mx = fmaxf(mx, row[tok]);
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int tok = 0; tok < page; ++tok) {
        const float p = expf(row[tok] - m_new);
        row[tok] = p;
        sum += p;
      }
      const float corr = expf(m_prev - m_new);
      m_s[r] = m_new;
      l_s[r] = l_s[r] * corr + sum;
      corr_s[r] = corr;
    }
    __syncthreads();

    // acc = acc * corr + P @ V
    for (int i = t; i < rep * d; i += THREADS) {
      const int r = i / d, dd = i % d;
      const float* prow = s_s + r * page;
      float a = acc_s[i] * corr_s[r];
      for (int tok = 0; tok < page; ++tok)
        a = fmaf(prow[tok], __bfloat162float(v_s[tok * d + dd]), a);
      acc_s[i] = a;
    }
  }

  __syncthreads();
  __nv_bfloat16* ob = out + ((size_t)b * h + (size_t)g * rep) * d;
  for (int i = t; i < rep * d; i += THREADS)
    ob[i] = __float2bfloat16(acc_s[i] / fmaxf(l_s[i / d], 1e-30f));
}

}  // namespace

// C interface (ctypes).  Returns a cudaError_t: 0 after a launch that was
// accepted.
extern "C" int paged_attention_fwd(const void* q, const void* k_pages,
                                   const void* v_pages,
                                   const void* block_tables,
                                   const void* lengths, void* out, int b,
                                   int h, int kv, int d, int page,
                                   int pages_max, float scale, void* stream) {
  if (b == 0) return 0;
  if (h % kv != 0 || d % 8 != 0) return (int)cudaErrorInvalidValue;
  const Layout L(h / kv, page, d);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(kv, b);
  paged_decode_kernel<<<grid, THREADS, L.total,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pages),
      static_cast<const __nv_bfloat16*>(v_pages),
      static_cast<const int*>(block_tables), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), h, kv, d, page, pages_max, scale);
  return (int)cudaGetLastError();
}
