// Chunked mLSTM scan for Hopper: f32 state, f32 math, f32 or bf16 q/k/v/y.
//
// Replaces the TPU kernel repro/kernels/mlstm_scan/mlstm_scan.py
// (mlstm_scan_kernel, body _mlstm_kernel), and computes what the reference
// model's mlstm_chunked runs per chunk (repro/models/ssm.py, per_chunk):
// within a chunk of L timesteps the stabilised decay matrix
// D[t,s] = (F_t - F_s) + li_s (s <= t, F the cumulative log forget gate),
// the stabiliser m_t = max(max_s D[t,s], m + F_t), the output
//   y_t = (sum_s (q_t.k_s) e^{D[t,s]-m_t} v_s + e^{m+F_t-m_t} q_t C)
//         / max(|sum_s (q_t.k_s) e^{D[t,s]-m_t} + e^{m+F_t-m_t} q_t.n|,
//               e^{-m_t})
// and the state (C, n, m) carried to the next chunk.  Unlike the Pallas
// kernel it takes an initial state and writes the final one: the model
// path needs both (decode continues from the prefill's state).
//
// What bounds it on the H100: at full width (dk 512, dv 1024, L 256) a
// chunk of one head does about 2*L*dk*dv*2 + L*L*(dk+dv) operations
// (q.C, the state update, the scores and W.V) on L*(2*dk+2*dv)*4 bytes of
// q/k/v/y, about 300 operations per byte, far above the card's 20 f32
// operations per byte (67 TFLOP/s over 3.35 TB/s): the operations bound
// it.  This first version runs every product on the CUDA cores in f32, as
// the model path computes it (tensor cores, in TF32 or bf16, are later
// work and change the numerics).
//
// Design.  The state C (dk x dv f32, 2 MiB per head at full width) does
// not fit one block's shared memory, so the dv axis is split: each block
// of the output kernel owns a dk x 32 slice of C in shared memory for the
// whole sequence and walks the chunks in order (the Pallas kernel's
// sequential grid axis moved inside the block).  The terms that do not
// depend on dv are computed once rather than in every dv block, by two
// smaller kernels before it:
//   1. stats  (one block per (b, h), chunks in order): F, the carry of m
//      and n, w_carry, the state-update weights kv_w and q_t.n;
//   2. scores (one block per (64-row tile, chunk, b*h)): m_t, e^{m+F-m_t},
//      the weighted scores W[t,s] = (q_t.k_s) e^{D[t,s]-m_t} and the
//      denominators; a 256-step chunk's L x L tile is cut into 64-row
//      tiles, so no block holds it whole;
//   3. out    (one block per (32-column dv tile, h, b)): y from W, q and
//      the block's C slice, then the slice's update.
// A ragged last chunk is masked, not padded: its missing steps would add
// nothing (zero q/k/v, log_i -1e30, log_f 0 in the reference), so the
// final state is the same.
//
// Layout: q, k (B,S,H,dk), v and y (B,S,H,dv), log_i, log_f (B,S,H), all
// contiguous; C (B,H,dk,dv), n (B,H,dk), m (B,H).  dk <= 512.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;  // the reference's "minus infinity"
constexpr int TT = 64;    // timesteps (rows) per tile
constexpr int KT = 32;    // dk slice of the products with q and k
constexpr int ST = 64;    // key timesteps per score tile
constexpr int DVT = 32;   // dv columns owned by one output block
constexpr int SV = 32;    // timesteps per W.V slice
constexpr int SC = 16;    // timesteps per state-update slice
constexpr int PAD = 68;   // row stride (floats) of transposed tiles
constexpr int MAX_DK = 512;
constexpr int RPT = MAX_DK / 32;  // state rows per thread in the update

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float neg_inf() { return -INFINITY; }

// Max over the block; every thread gets it.
__device__ float block_max(float x, float* red) {
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < WARPS ? red[lane] : neg_inf();
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

struct Dims {
  int S, H, dk, dv, chunk, nc;
  __device__ int sp() const { return nc * chunk; }
  __device__ size_t row(int b, int t, int h) const {  // (b, t, h) in (B,S,H)
    return ((size_t)b * S + t) * H + h;
  }
};

// Workspace (f32), per (b, h): F, qn, kvw, interw, denom over the padded
// sequence; mprev, wcarry per chunk; W per chunk (L x L).
struct Work {
  float *F, *qn, *kvw, *interw, *denom, *mprev, *wcarry, *W;
};

// 1. stats: one block per (b, h), chunks in order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
mlstm_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const float* __restrict__ log_i,
                   const float* __restrict__ log_f,
                   const float* __restrict__ n0, const float* __restrict__ m0,
                   float* __restrict__ n_out, float* __restrict__ m_out,
                   Work w, Dims d) {
  extern __shared__ __align__(16) float sm[];
  float* n_s = sm;                // dk
  float* F_s = n_s + d.dk;        // chunk
  float* li_s = F_s + d.chunk;    // chunk
  float* w_s = li_s + d.chunk;    // chunk: state-update weights
  float* red = w_s + d.chunk;     // WARPS
  const int bh = blockIdx.x, b = bh / d.H, h = bh % d.H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t base = (size_t)bh * d.sp();
  for (int i = tid; i < d.dk; i += THREADS)
    n_s[i] = n0 ? n0[(size_t)bh * d.dk + i] : 0.f;
  float m = m0 ? m0[bh] : NEG_INF;
  for (int c = 0; c < d.nc; ++c) {
    const int t0 = c * d.chunk, len = min(d.chunk, d.S - t0);
    __syncthreads();
    for (int j = tid; j < len; j += THREADS) {
      li_s[j] = log_i[d.row(b, t0 + j, h)];
      F_s[j] = log_f[d.row(b, t0 + j, h)];
    }
    __syncthreads();
    if (tid == 0) {  // inclusive cumulative sum, in order
      float acc = 0.f;
      for (int j = 0; j < len; ++j) {
        acc += F_s[j];
        F_s[j] = acc;
      }
    }
    __syncthreads();
    const float F_tot = F_s[len - 1];
    float mx = neg_inf();
    for (int j = tid; j < len; j += THREADS)
      mx = fmaxf(mx, (F_tot - F_s[j]) + li_s[j]);
    mx = block_max(mx, red);
    const float m_new = fmaxf(m + F_tot, mx);
    const float w_carry = expf(m + F_tot - m_new);
    for (int j = tid; j < len; j += THREADS) {
      const float kw = expf((F_tot - F_s[j]) + li_s[j] - m_new);
      w_s[j] = kw;
      w.F[base + t0 + j] = F_s[j];
      w.kvw[base + t0 + j] = kw;
    }
    if (tid == 0) {
      w.mprev[bh * d.nc + c] = m;
      w.wcarry[bh * d.nc + c] = w_carry;
    }
    // q_t . n with n the state at the chunk's start: one warp a timestep
    for (int j = warp; j < len; j += WARPS) {
      const T* qr = q + d.row(b, t0 + j, h) * d.dk;
      float acc = 0.f;
      for (int i = lane; i < d.dk; i += 32) acc += ld(qr + i) * n_s[i];
      for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) w.qn[base + t0 + j] = acc;
    }
    __syncthreads();
    for (int i = tid; i < d.dk; i += THREADS) {
      float acc = 0.f;
      for (int j = 0; j < len; ++j)
        acc += ld(k + d.row(b, t0 + j, h) * d.dk + i) * w_s[j];
      n_s[i] = n_s[i] * w_carry + acc;
    }
    m = m_new;
  }
  __syncthreads();
  for (int i = tid; i < d.dk; i += THREADS) n_out[(size_t)bh * d.dk + i] = n_s[i];
  if (tid == 0) m_out[bh] = m;
}

// 2. scores: one block per (64-row tile, chunk, b*h).
template <typename T>
__global__ void __launch_bounds__(THREADS)
mlstm_scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const float* __restrict__ log_i, Work w, Dims d) {
  extern __shared__ __align__(16) float sm[];
  float* qT = sm;                 // KT x PAD: q slice, [kd][row]
  float* kT = qT + KT * PAD;      // KT x PAD: k slice, [kd][col]
  float* F_s = kT + KT * PAD;     // chunk
  float* li_s = F_s + d.chunk;    // chunk
  float* mt_s = li_s + d.chunk;   // TT
  const int c = blockIdx.y, bh = blockIdx.z, b = bh / d.H, h = bh % d.H;
  const int t0 = c * d.chunk, len = min(d.chunk, d.S - t0);
  const int r0 = blockIdx.x * TT;
  if (r0 >= len) return;
  const int r_end = min(r0 + TT, len);
  const int tid = threadIdx.x;
  const size_t base = (size_t)bh * d.sp();
  const float m_prev = w.mprev[bh * d.nc + c];
  float* W = w.W + ((size_t)bh * d.nc + c) * d.chunk * d.chunk;
  for (int j = tid; j < r_end; j += THREADS) {
    F_s[j] = w.F[base + t0 + j];
    li_s[j] = log_i[d.row(b, t0 + j, h)];
  }
  __syncthreads();
  {  // stabiliser, four threads a row
    const int r = tid / 4, part = tid % 4, t = r0 + r;
    float mx = neg_inf();
    if (t < r_end)
      for (int s = part; s <= t; s += 4)
        mx = fmaxf(mx, (F_s[t] - F_s[s]) + li_s[s]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    if (part == 0 && t < r_end) mt_s[r] = fmaxf(mx, m_prev + F_s[t]);
  }
  __syncthreads();
  const int tx = tid % 16, ty = tid / 16;  // rows ty*4+i, cols tx*4+j
  float rowsum[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s0 = 0; s0 < r_end; s0 += ST) {
    float acc[4][4] = {};
    for (int k0 = 0; k0 < d.dk; k0 += KT) {
      __syncthreads();
      for (int e = tid; e < TT * KT; e += THREADS) {
        const int rr = e / KT, kk = e % KT, kd = k0 + kk;
        const int t = r0 + rr, s = s0 + rr;
        qT[kk * PAD + rr] = (t < r_end && kd < d.dk)
            ? ld(q + d.row(b, t0 + t, h) * d.dk + kd) : 0.f;
        kT[kk * PAD + rr] = (s < r_end && kd < d.dk)
            ? ld(k + d.row(b, t0 + s, h) * d.dk + kd) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(qT + kk * PAD + ty * 4);
        const float4 bb = *reinterpret_cast<const float4*>(kT + kk * PAD + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = r0 + ty * 4 + i;
      if (t >= r_end) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s0 + tx * 4 + j;
        if (s >= r_end) continue;
        float val = 0.f;
        if (s <= t)
          val = acc[i][j] * expf((F_s[t] - F_s[s]) + li_s[s] - mt_s[t - r0]);
        W[(size_t)t * d.chunk + s] = val;
        rowsum[i] += val;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    for (int o = 1; o < 16; o <<= 1)
      rowsum[i] += __shfl_xor_sync(0xffffffffu, rowsum[i], o);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = r0 + ty * 4 + i;
      if (t >= r_end) continue;
      const float m_t = mt_s[t - r0];
      const float iw = expf((m_prev + F_s[t]) - m_t);
      const float qdotn = rowsum[i] + iw * w.qn[base + t0 + t];
      w.interw[base + t0 + t] = iw;
      w.denom[base + t0 + t] = fmaxf(fabsf(qdotn), expf(-m_t));
    }
  }
}

// 3. out: one block per (32-column dv tile, h, b); its C slice stays in
// shared memory for the whole sequence.
template <typename T>
__global__ void __launch_bounds__(THREADS)
mlstm_out_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ C0,
                 T* __restrict__ y, float* __restrict__ C_out, Work w,
                 Dims d) {
  extern __shared__ __align__(16) float sm[];
  float* C_s = sm;                      // dk x DVT
  float* buf = C_s + d.dk * DVT;
  float* qT = buf;                      // output phase: KT x PAD
  float* wT = qT + KT * PAD;            //               SV x PAD
  float* vA = wT + SV * PAD;            //               SV x DVT
  float* kB = buf;                      // update phase: SC x dk
  float* vB = kB + SC * d.dk;           //               SC x DVT
  const int j0 = blockIdx.x * DVT, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * d.H + h;
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;
  const size_t base = (size_t)bh * d.sp();
  for (int e = tid; e < d.dk * DVT; e += THREADS) {
    const int i = e / DVT, col = j0 + e % DVT;
    C_s[e] = (C0 && col < d.dv) ? C0[((size_t)bh * d.dk + i) * d.dv + col] : 0.f;
  }
  for (int c = 0; c < d.nc; ++c) {
    const int t0 = c * d.chunk, len = min(d.chunk, d.S - t0);
    const float* W = w.W + ((size_t)bh * d.nc + c) * d.chunk * d.chunk;
    // output: rows ty*2+i, columns tx*4+j of each 64-row tile
    for (int r0 = 0; r0 < len; r0 += TT) {
      const int r_end = min(r0 + TT, len);
      float inter[2][4] = {}, intra[2][4] = {};
      for (int k0 = 0; k0 < d.dk; k0 += KT) {  // (q e^{m+F-m_t}) . C
        __syncthreads();
        for (int e = tid; e < TT * KT; e += THREADS) {
          const int rr = e / KT, kk = e % KT, t = r0 + rr, kd = k0 + kk;
          qT[kk * PAD + rr] = (t < r_end && kd < d.dk)
              ? ld(q + d.row(b, t0 + t, h) * d.dk + kd) * w.interw[base + t0 + t]
              : 0.f;
        }
        __syncthreads();
        const int kn = min(KT, d.dk - k0);
        for (int kk = 0; kk < kn; ++kk) {
          const float2 a = *reinterpret_cast<const float2*>(qT + kk * PAD + ty * 2);
          const float4 cv = *reinterpret_cast<const float4*>(C_s + (k0 + kk) * DVT + tx * 4);
          const float av[2] = {a.x, a.y};
          const float cc[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) inter[i][j] = fmaf(av[i], cc[j], inter[i][j]);
        }
      }
      for (int s0 = 0; s0 < r_end; s0 += SV) {  // W . v
        __syncthreads();
        for (int e = tid; e < TT * SV; e += THREADS) {
          const int rr = e / SV, ss = e % SV, t = r0 + rr, s = s0 + ss;
          wT[ss * PAD + rr] = (t < r_end && s < r_end) ? W[(size_t)t * d.chunk + s] : 0.f;
        }
        for (int e = tid; e < SV * DVT; e += THREADS) {
          const int ss = e / DVT, col = j0 + e % DVT, s = s0 + ss;
          vA[e] = (s < r_end && col < d.dv)
              ? ld(v + d.row(b, t0 + s, h) * d.dv + col) : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int ss = 0; ss < SV; ++ss) {
          const float2 a = *reinterpret_cast<const float2*>(wT + ss * PAD + ty * 2);
          const float4 vv = *reinterpret_cast<const float4*>(vA + ss * DVT + tx * 4);
          const float av[2] = {a.x, a.y};
          const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) intra[i][j] = fmaf(av[i], vc[j], intra[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = r0 + ty * 2 + i;
        if (t >= r_end) continue;
        const float den = w.denom[base + t0 + t];
        T* yr = y + d.row(b, t0 + t, h) * d.dv;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = j0 + tx * 4 + j;
          if (col < d.dv) st(yr + col, (intra[i][j] + inter[i][j]) / den);
        }
      }
    }
    // state update of the slice: C = C w_carry + sum_s (k_s kv_w_s) v_s^T;
    // rows ty + 32 r, columns tx*4+j
    const float w_carry = w.wcarry[bh * d.nc + c];
    float acc[RPT][4] = {};
    for (int s0 = 0; s0 < len; s0 += SC) {
      __syncthreads();
      for (int e = tid; e < SC * d.dk; e += THREADS) {
        const int ss = e / d.dk, i = e % d.dk, s = s0 + ss;
        kB[e] = s < len ? ld(k + d.row(b, t0 + s, h) * d.dk + i) * w.kvw[base + t0 + s]
                        : 0.f;
      }
      for (int e = tid; e < SC * DVT; e += THREADS) {
        const int ss = e / DVT, col = j0 + e % DVT, s = s0 + ss;
        vB[e] = (s < len && col < d.dv) ? ld(v + d.row(b, t0 + s, h) * d.dv + col) : 0.f;
      }
      __syncthreads();
      for (int ss = 0; ss < SC; ++ss) {
        const float4 vv = *reinterpret_cast<const float4*>(vB + ss * DVT + tx * 4);
        const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int i = ty + 32 * r;
          if (i < d.dk) {
            const float kv = kB[ss * d.dk + i];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(kv, vc[j], acc[r][j]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int i = ty + 32 * r;
      if (i < d.dk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* cp = C_s + i * DVT + tx * 4 + j;
          *cp = *cp * w_carry + acc[r][j];
        }
    }
  }
  __syncthreads();
  for (int e = tid; e < d.dk * DVT; e += THREADS) {
    const int i = e / DVT, col = j0 + e % DVT;
    if (col < d.dv) C_out[((size_t)bh * d.dk + i) * d.dv + col] = C_s[e];
  }
}

// Carves the workspace ``ws`` into ``w`` (when ``w`` is given); returns
// its size in floats.
size_t carve(int B, int S, int H, int chunk, float* ws, Work* w) {
  const size_t nc = (S + chunk - 1) / chunk, sp = nc * chunk, bh = (size_t)B * H;
  const size_t sizes[8] = {bh * sp, bh * sp, bh * sp, bh * sp, bh * sp,
                           bh * nc, bh * nc, bh * nc * chunk * chunk};
  float** parts[8] = {nullptr};
  if (w) {
    float** p[8] = {&w->F, &w->qn, &w->kvw, &w->interw, &w->denom,
                    &w->mprev, &w->wcarry, &w->W};
    for (int i = 0; i < 8; ++i) parts[i] = p[i];
  }
  size_t off = 0;
  for (int i = 0; i < 8; ++i) {
    if (w) *parts[i] = ws + off;
    off += sizes[i];
  }
  return off;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* log_i,
           const float* log_f, const float* C0, const float* n0,
           const float* m0, void* y, float* C, float* n, float* m, float* ws,
           int B, int S, int H, int dk, int dv, int chunk,
           cudaStream_t stream) {
  Work w;
  carve(B, S, H, chunk, ws, &w);
  const int nc = (S + chunk - 1) / chunk;
  const Dims d{S, H, dk, dv, chunk, nc};
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);

  const size_t sm1 = sizeof(float) * (dk + 3 * chunk + WARPS);
  const size_t sm2 = sizeof(float) * (2 * KT * PAD + 2 * chunk + TT);
  const size_t buf3a = KT * PAD + SV * PAD + SV * DVT;
  const size_t buf3b = (size_t)SC * dk + SC * DVT;
  const size_t sm3 = sizeof(float) * (dk * DVT + (buf3a > buf3b ? buf3a : buf3b));
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(mlstm_stats_kernel<T>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm1)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(mlstm_scores_kernel<T>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm2)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(mlstm_out_kernel<T>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm3)) != cudaSuccess)
    return (int)err;

  mlstm_stats_kernel<T><<<B * H, THREADS, sm1, stream>>>(
      qt, kt, log_i, log_f, n0, m0, n, m, w, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 g2((chunk + TT - 1) / TT, nc, B * H);
  mlstm_scores_kernel<T><<<g2, THREADS, sm2, stream>>>(qt, kt, log_i, w, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 g3((dv + DVT - 1) / DVT, H, B);
  mlstm_out_kernel<T><<<g3, THREADS, sm3, stream>>>(
      qt, kt, vt, C0, static_cast<T*>(y), C, w, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of f32 workspace mlstm_scan_fwd needs.
size_t mlstm_scan_workspace_bytes(int B, int S, int H, int chunk) {
  return sizeof(float) * carve(B, S, H, chunk, nullptr, nullptr);
}

// q, k (B,S,H,dk) and v (B,S,H,dv) f32 (bf16 = 0) or bf16 (bf16 = 1);
// log_i, log_f (B,S,H) f32; C0/n0/m0 the initial state or null (empty
// state); y (B,S,H,dv) in q's type; C, n, m the final state; ws the
// workspace.  Returns a CUDA error code (0 on success).
int mlstm_scan_fwd(const void* q, const void* k, const void* v,
                   const float* log_i, const float* log_f, const float* C0,
                   const float* n0, const float* m0, void* y, float* C,
                   float* n, float* m, float* ws, int B, int S, int H, int dk,
                   int dv, int chunk, int bf16, cudaStream_t stream) {
  if (B < 1 || S < 1 || H < 1 || dk < 1 || dk > MAX_DK || dv < 1 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, log_i, log_f, C0, n0, m0, y, C, n,
                                 m, ws, B, S, H, dk, dv, chunk, stream);
  return launch<float>(q, k, v, log_i, log_f, C0, n0, m0, y, C, n, m, ws, B,
                       S, H, dk, dv, chunk, stream);
}

}  // extern "C"
