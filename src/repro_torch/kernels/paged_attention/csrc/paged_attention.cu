// Paged decode attention for Hopper, split over pages (flash-decoding): one
// new query token per sequence against that sequence's KV pages.  bf16 in
// and out, f32 math.
//
// Replaces the TPU kernel repro/kernels/paged_attention/paged_attention.py
// (paged_attention_kernel, body _paged_kernel): pages addressed through a
// block table, GQA computed as (KV, H/KV, D) without repeating K/V, q
// pre-scaled in f32, positions at or past the length masked, pages past
// ceil(len/page) not read (n_pages clipped to pages_max), denominator
// max(l, 1e-30), so a length-0 row gives zeros.
//
// What bounds it on the H100: each cached key and value is read once and
// used for the H/KV query heads of its KV head, about 4*(H/KV) operations
// per 4 bytes read, far below the card's ~295 operations per byte: the
// bytes of the live pages bound it.  What the design does about that:
// - Split over pages.  Block (split, KV head x head group, sequence) takes
//   pages [split*pps, min((split+1)*pps, n_pages)) of its row.  pps (pages
//   per split) is the host's choice from the page pool's rows (P /
//   pages_max), KV, pages_max and page only (ops.split_plan; the lengths
//   stay on the device), so a long row's pages are read by many SMs side by
//   side instead of by one in turn.  pps never depends on B: a row's splits,
//   and so its merged bits, are the same whichever rows share its launch.
//   A block whose split starts at or past its row's n_pages returns at once.
// - Several pages in flight.  The split's block-table entries are read
//   into shared memory first; its pages then stream through a ring of
//   NSTAGE page stages (K and V) with 16-byte cp.async copies, NSTAGE - 1
//   pages ahead of the one being computed.
// - No single-thread phase.  Thread t owns the 16-byte chunk t % LPR of a
//   K/V row and belongs to row group t / LPR, LPR = D/8 lanes rounded up to
//   a power of two (D = 192: 24 chunks on 32 lanes, the last 8 idle, so a
//   row group is one warp and the shuffles stay power-of-two).  q of the block's query
//   heads sits in registers, pre-scaled in f32.  Row group rg takes tokens
//   rg, rg + NRG, ... of each page: a score is 8 products per lane summed
//   over the group's lanes by shuffles, and the group keeps its own online
//   softmax (m, l, acc) per query head in registers.  Every page load serves
//   all the block's query heads (up to HEADS_MAX; more go to further head
//   groups, which read the pages again).
// - Merge.  The row groups are merged in shared memory by log-sum-exp, one
//   thread per output element; a row whose pages fit one split writes its
//   output there.  Otherwise each split writes (m, l, acc) in f32 to the
//   workspace, and the last block of its (sequence, KV head, head group) to
//   finish (an atomic ticket taken after __threadfence()) merges the live
//   splits in split order, M = max m_i,
//     out = sum e^{m_i-M} acc_i / max(sum e^{m_i-M} l_i, 1e-30),
//   and leaves its counter at zero.  One launch per call.
// - Workspace and counters.  The wrapper takes the workspace from torch's
//   caching allocator on the current stream at every call.  The counters
//   (one int per sequence, KV head and head group) are a zeroed tensor the
//   wrapper keeps per (device, stream): every launch leaves them at zero, so
//   the calls of one stream share them in order and two streams never do.
// - Host: cudaFuncSetAttribute is called once per process, device,
//   instantiation and larger shared-memory size, and not at all below the
//   default 48 KB (olmo-1b's shapes need 32 KB).
//
// Layout: q (B, H, D), k_pages and v_pages (P, page, KV, D), block_tables
// (B, pages_max) int32, lengths (B,) int32, out (B, H, D); all contiguous,
// q and the pages 16-byte aligned, D in {32, 64, 128, 192, 256}.  Grid (splits,
// KV * groups, B), 128 threads.  Workspace (B, KV * groups, splits, hb,
// D + 2) f32 with hb = min(H/KV, HEADS_MAX): each slot holds acc (hb x D),
// then m (hb), then l (hb).  Workspace and counters are needed only when
// splits > 1.  Constants follow _paged_kernel: NEG_INF = -1e30,
// denominator max(l, 1e-30).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int THREADS = 128;
constexpr int NSTAGE = 4;         // pages in the shared-memory ring
constexpr int HEADS_MAX = 8;      // query heads one block serves
constexpr float NEG_INF = -1e30f;
constexpr size_t SMEM_DEFAULT = 47 * 1024;  // under the 48 KB default
constexpr size_t SMEM_MAX = 227 * 1024;
constexpr int MAX_DEVICES = 64;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* block_tables;
  const int* lengths;
  __nv_bfloat16* out;
  float* ws;        // per-split partials; null when splits == 1
  int* counters;    // tickets, zero at entry and exit; null when splits == 1
  int h, kv, rep, hb, groups, page, pages_max, pps, splits;
  float scale;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 8 bf16 (16 bytes) to f32: element 2i is word i's low half
__device__ __forceinline__ void unpack8(const uint4 raw, float (&f)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Lanes per K/V row: D/8 chunks of 8 elements, rounded up to a power of two
template <int D>
__host__ __device__ constexpr int lanes_per_row() {
  int n = 1;
  while (n < D / 8) n *= 2;
  return n;
}

// Page `pid`'s K and V rows of KV head g into one ring stage (K then V)
template <int D>
__device__ __forceinline__ void load_page(__nv_bfloat16* ks, const Params& p,
                                          int pid, int g) {
  constexpr int CH = D / 8;             // 16-byte chunks of a row
  __nv_bfloat16* vs = ks + p.page * D;
  const size_t base = ((size_t)pid * p.page * p.kv + g) * D;
  for (int c = threadIdx.x; c < p.page * CH; c += THREADS) {
    const int tok = c / CH, ch = c % CH;
    const size_t off = base + (size_t)tok * p.kv * D + ch * 8;
    cp_async16(ks + tok * D + ch * 8, p.k + off);
    cp_async16(vs + tok * D + ch * 8, p.v + off);
  }
}

template <int D, int R>
size_t smem_bytes(int page, int pps) {
  constexpr int NRG = THREADS / lanes_per_row<D>();
  const size_t ring = (size_t)NSTAGE * 2 * page * D * sizeof(__nv_bfloat16)
                      + sizeof(int) * pps;
  const size_t merge = sizeof(float) * (size_t)NRG * R * (D + 2);
  return ring > merge ? ring : merge;
}

// R: the query heads a block holds in registers (>= its heads, <= HEADS_MAX)
template <int D, int R>
__global__ void __launch_bounds__(THREADS)
paged_split_kernel(const Params p) {
  constexpr int LPR = lanes_per_row<D>();  // lanes per K/V row
  constexpr int NRG = THREADS / LPR;       // row groups
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  const int split = blockIdx.x, bg = blockIdx.y, b = blockIdx.z;
  const int g = bg / p.groups, h0 = (bg % p.groups) * HEADS_MAX;
  const int nh = min(HEADS_MAX, p.rep - h0);   // this block's query heads
  const int t = threadIdx.x, rg = t / LPR, cl = t % LPR;
  const bool lane_live = cl < D / 8;       // false only for D = 192's pad

  const int length = max(p.lengths[b], 0);
  const int n_pages =
      min(length / p.page + (length % p.page != 0), p.pages_max);
  const int live = (n_pages + p.pps - 1) / p.pps;   // splits with pages
  __nv_bfloat16* ob = p.out + ((size_t)b * p.h + (size_t)g * p.rep + h0) * D;
  if (split >= live) {
    if (split == 0)   // length 0: acc 0 / max(0, 1e-30), as the reference
      for (int i = t; i < nh * D; i += THREADS) ob[i] = __float2bfloat16(0.f);
    return;
  }
  const int j0 = split * p.pps;
  const int np = min(j0 + p.pps, n_pages) - j0;   // >= 1

  const int stage = 2 * p.page * D;               // K page, then V page
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  int* pid_s = reinterpret_cast<int*>(ring + (size_t)NSTAGE * stage);
  for (int i = t; i < np; i += THREADS)
    pid_s[i] = p.block_tables[(size_t)b * p.pages_max + j0 + i];

  float qr[R][8];
  const __nv_bfloat16* qb =
      p.q + ((size_t)b * p.h + (size_t)g * p.rep + h0) * D + cl * 8;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < nh && lane_live) {
      unpack8(*reinterpret_cast<const uint4*>(qb + (size_t)r * D), qr[r]);
#pragma unroll
      for (int j = 0; j < 8; ++j) qr[r][j] *= p.scale;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) qr[r][j] = 0.f;
    }
  }
  float m[R], l[R], acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
  }
  // the lanes of this thread's row group (shuffles stay inside it)
  const unsigned gmask =
      LPR == 32 ? 0xffffffffu
                : (((1u << (LPR & 31)) - 1u) << ((t & 31) & ~(LPR - 1)));
  __syncthreads();   // pid_s

#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) {
    if (i < np) load_page<D>(ring + i * stage, p, pid_s[i], g);
    cp_async_commit();
  }
  for (int i = 0; i < np; ++i) {
    const int ahead = i + NSTAGE - 1;
    if (ahead < np)
      load_page<D>(ring + (ahead % NSTAGE) * stage, p, pid_s[ahead], g);
    cp_async_commit();           // (an empty group near the end)
    cp_async_wait<NSTAGE - 1>(); // page i landed (this thread's copies)
    __syncthreads();             // ... and every thread's
    const __nv_bfloat16* ks = ring + (i % NSTAGE) * stage;
    const __nv_bfloat16* vs = ks + p.page * D;
    const int valid = min(p.page, length - (j0 + i) * p.page);
    for (int tok = rg; tok < valid; tok += NRG) {
      float kf[8] = {}, vf[8] = {};
      if (lane_live) {
        unpack8(*reinterpret_cast<const uint4*>(ks + tok * D + cl * 8), kf);
        unpack8(*reinterpret_cast<const uint4*>(vs + tok * D + cl * 8), vf);
      }
      float s[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) a = fmaf(qr[r][j], kf[j], a);
        s[r] = a;
      }
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1)
#pragma unroll
        for (int r = 0; r < R; ++r) s[r] += __shfl_xor_sync(gmask, s[r], o);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < nh) {
          const float mn = fmaxf(m[r], s[r]);
          const float corr = expf(m[r] - mn), pe = expf(s[r] - mn);
          l[r] = fmaf(l[r], corr, pe);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[r][j] = fmaf(acc[r][j], corr, pe * vf[j]);
          m[r] = mn;
        }
      }
    }
    __syncthreads();             // stage i % NSTAGE free for reuse
  }
  cp_async_wait<0>();

  // merge the row groups: scratch over the ring (every thread is past it)
  float* m_s = reinterpret_cast<float*>(smem);   // [rg][r]
  float* l_s = m_s + NRG * R;                    // [rg][r]
  float* a_s = l_s + NRG * R;                    // [rg][r][D]
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < nh) {
      if (cl == 0) {
        m_s[rg * R + r] = m[r];
        l_s[rg * R + r] = l[r];
      }
      if (lane_live) {
        float4* dst =
            reinterpret_cast<float4*>(a_s + (rg * R + r) * D + cl * 8);
        dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
      }
    }
  }
  __syncthreads();
  const size_t slot_floats = (size_t)p.hb * (D + 2);
  float* row_ws = live == 1 ? nullptr
      : p.ws + ((size_t)b * gridDim.y + bg) * p.splits * slot_floats;
  for (int e = t; e < nh * D; e += THREADS) {
    const int r = e / D, d = e % D;
    float M = NEG_INF;
    for (int i = 0; i < NRG; ++i) M = fmaxf(M, m_s[i * R + r]);
    float L = 0.f, A = 0.f;
    for (int i = 0; i < NRG; ++i) {   // groups that saw no token weigh 0
      const float w = expf(m_s[i * R + r] - M);
      L = fmaf(l_s[i * R + r], w, L);
      A = fmaf(a_s[(i * R + r) * D + d], w, A);
    }
    if (live == 1) {
      ob[e] = __float2bfloat16(A / fmaxf(L, 1e-30f));
    } else {
      float* slot = row_ws + split * slot_floats;
      slot[e] = A;
      if (d == 0) {
        slot[p.hb * D + r] = M;
        slot[p.hb * D + p.hb + r] = L;
      }
    }
  }
  if (live == 1) return;

  // the last split of this (sequence, KV head, head group) merges them all
  __threadfence();
  __syncthreads();
  int* counter = p.counters + (size_t)b * gridDim.y + bg;
  if (t == 0) is_last = atomicAdd(counter, 1) == live - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int e = t; e < nh * D; e += THREADS) {
    const int r = e / D;
    float M = NEG_INF;
    for (int i = 0; i < live; ++i)
      M = fmaxf(M, __ldcg(row_ws + i * slot_floats + p.hb * D + r));
    float L = 0.f, A = 0.f;
    for (int i = 0; i < live; ++i) {
      const float* slot = row_ws + i * slot_floats;
      const float w = expf(__ldcg(slot + p.hb * D + r) - M);
      L = fmaf(__ldcg(slot + p.hb * D + p.hb + r), w, L);
      A = fmaf(__ldcg(slot + e), w, A);
    }
    ob[e] = __float2bfloat16(A / fmaxf(L, 1e-30f));
  }
  if (t == 0) *counter = 0;   // every other split of the row has ticketed
}

// Raise the kernel's dynamic shared-memory limit once per process, device
// and larger size; nothing below the default.
template <int D, int R>
cudaError_t allow_smem(size_t bytes) {
  if (bytes <= SMEM_DEFAULT) return cudaSuccess;
  static std::mutex mu;
  static size_t allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(paged_split_kernel<D, R>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) allowed[dev] = bytes;
  return err;
}

template <int D, int R>
int launch(const Params& p, int b, cudaStream_t stream) {
  const size_t smem = smem_bytes<D, R>(p.page, p.pps);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem<D, R>(smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.splits, p.kv * p.groups, b);
  paged_split_kernel<D, R><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const Params& p, int b, cudaStream_t stream) {
  const int heads = p.hb;   // heads per block, at most HEADS_MAX
  if (heads <= 1) return launch<D, 1>(p, b, stream);
  if (heads <= 2) return launch<D, 2>(p, b, stream);
  if (heads <= 4) return launch<D, 4>(p, b, stream);
  return launch<D, 8>(p, b, stream);
}

}  // namespace

// C interface (ctypes).  pages_per_split >= 1 pages per split; ws and
// counters may be null when pages_per_split >= pages_max (one split), and
// otherwise hold B * KV * groups * splits * hb * (D + 2) floats and
// B * KV * groups zeroed ints (groups = ceil((H/KV) / 8), hb = min(H/KV,
// 8), splits = ceil(pages_max / pages_per_split)).  Returns a cudaError_t:
// 0 after a launch that was accepted.
extern "C" int paged_attention_fwd(const void* q, const void* k_pages,
                                   const void* v_pages,
                                   const void* block_tables,
                                   const void* lengths, void* out, void* ws,
                                   void* counters, int b, int h, int kv,
                                   int d, int page, int pages_max,
                                   int pages_per_split, float scale,
                                   void* stream) {
  if (b == 0) return 0;
  if (b < 0 || kv < 1 || h % kv != 0 || page < 1 || pages_max < 1 ||
      pages_per_split < 1 || b > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k_pages);
  p.v = static_cast<const __nv_bfloat16*>(v_pages);
  p.block_tables = static_cast<const int*>(block_tables);
  p.lengths = static_cast<const int*>(lengths);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.ws = static_cast<float*>(ws);
  p.counters = static_cast<int*>(counters);
  p.h = h;
  p.kv = kv;
  p.rep = h / kv;
  p.hb = p.rep < HEADS_MAX ? p.rep : HEADS_MAX;
  p.groups = (p.rep + HEADS_MAX - 1) / HEADS_MAX;
  p.page = page;
  p.pages_max = pages_max;
  p.pps = pages_per_split < pages_max ? pages_per_split : pages_max;
  p.splits = (pages_max + p.pps - 1) / p.pps;
  p.scale = scale;
  if ((long long)kv * p.groups > 65535) return (int)cudaErrorInvalidValue;
  if (p.splits > 1 && (ws == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_d<32>(p, b, s);
    case 64: return launch_d<64>(p, b, s);
    case 128: return launch_d<128>(p, b, s);
    case 192: return launch_d<192>(p, b, s);
    case 256: return launch_d<256>(p, b, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
