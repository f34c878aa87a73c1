// Chunked mLSTM scan for Hopper: f32 state, f32 gating, products in
// 3xTF32 on the tensor cores; f32 or bf16 q/k/v/y.
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
// and the state (C, n, m) carried to the next chunk:
//   C' = C w_carry + (k kv_w)^T v,  n' = n w_carry + sum_s k_s kv_w_s.
// Unlike the Pallas kernel it takes an initial state and writes the final
// one: the model path needs both (decode continues from the prefill's
// state).
//
// What bounds it on the H100: at xlstm-1.3b's width (dk 512, dv 1024, L
// 256) a chunk of one head does about 2 L dk dv (state update) + 2 L dk dv
// (q.C, not in the first chunk) + L^2 (dk + dv) (scores, W.V) operations
// on L (2 dk + 2 dv) 4 bytes of q/k/v/y, some 300 operations a byte, far
// above the card's 20 f32 operations a byte (49 in 3xTF32 on the tensor
// cores): the operations bound it.
//
// The chunk-serial form (one block per head walking the chunks, the
// Pallas grid's sequential axis) gives a one-request prefill 4 heads of
// work for 132 SMs.  Here every pass is parallel over chunks:
//   1. stats    (chunk, b*h): F by a block scan summed in f64 (exact for
//      these sums), the row maxima of D from a prefix argmax of
//      li_s - F_s (max_s D[t,s] = (F_t - F_s*) + li_s*), the chunk's
//      F_tot and g = max_s (F_tot - F_s) + li_s.  The carry of m over
//      chunks, m' = max(m + F_tot, g), is a few adds and maxes that each
//      later block redoes from these.  F stays in f64: every gate weight
//      e^{(F_t - F_s) + li_s - m_t} takes its argument from the f64 sums
//      and is rounded once, so it is exact to an f32 rounding.  (F rounded
//      to f32 first puts up to an ulp of |F|, some 30 eps32 at |F| ~ 70,
//      on each weight: more than the plain version's serial f32 sum puts
//      on neighbouring steps, and enough to push a cancelling row's error
//      past 2 eps32 kappa |y|, which a chip run showed.)
//   2. products, one launch of two kinds of block:
//      scores (64-row tile, 64-key tile at or below it, chunk, b*h): m_t,
//        e^{m+F_t-m_t}, the weighted scores W = (Q K^T) o e^{D-m_t} (zero
//        above the diagonal) and their row sums over the tile's keys; W
//        goes to the workspace (chunk x chunk per chunk and head, 256 KiB
//        at L 256, L2-resident) and is read once per dv tile: recomputing
//        it in each of the dv / 64 = 16 out blocks of a row would cost 16
//        times the scores' 2 P dk operations (P = L (L + 1) / 2 pairs),
//        0.54 GFLOP a chunk and head at L 256, more than the whole scan's
//        other work (a block a tile pair, so the longest walks dk once,
//        not once per key tile);
//      state (64-row dk tile, 64-column dv tile, chunk, b*h): the chunk's
//        own contribution dC = (k o kv_w)^T V, and dn = sum_s k_s kv_w_s
//        in the dv-tile-0 blocks, with w_carry and kv_w; with one chunk
//        it writes the final state C0 w_carry + dC directly.
//   3. combine (nc > 1; elementwise, chunks in order): C_{c+1} =
//      C_c w_carry_c + dC_c, in place: slot c of the state workspace ends
//      holding the state at chunk c's start (nc B H dk dv 4 bytes: 16 MiB
//      at B1 H4 dk512 dv1024 and two chunks), and n likewise.
//   4. out (64-row tile, 64-column dv tile, chunk, b*h): y = [W | q o
//      e^{m+F-m_t}] [V ; C_c] / den as one product over K = L + dk (the C
//      half skipped where C_c is zero: chunk 0 from the empty state), the
//      denominator from W's row sums (the key tiles' sums, in order) and
//      (q o e^{m+F-m_t}) . n_c, summed as the q tiles pass through shared
//      memory.
// One B1 prefill at full width (H 4, dk 512, dv 1024) of one full chunk
// launches 512 state and 256 out blocks.
//
// Products: Q K^T (scores), [W | q o e] [V ; C] (out) and (k o kv_w)^T V
// (state) all run on the tensor cores in 3xTF32 (mma.sync m16n8k8 tf32,
// f32 accumulate): each f32 operand x splits as hi = tf32(x), lo =
// tf32(x - hi) (rounded to nearest, ties away, as cvt.rna), and a product
// is hi hi + hi lo + lo hi.  The tensor cores round their sums toward
// zero, so hi hi is summed per K step of 32 from zero and added to the
// running sum on the CUDA cores, and the two small terms accumulate apart
// (Acc).  A CPU emulation of this arithmetic with that rounding
// (tests/test_torch_kernels.py, TestMlstmTensorCoreArithmetic) keeps the
// worst row of y within c = 0.56 of eps32 kappa |y| over seeds 0-15 at
// small shapes with each product on the tensor cores alone (scores 0.42,
// out 0.56, state 0.56; all three 0.37; f32 products 0.56), well inside
// the criterion's c = 2, so none stays on the CUDA cores; at K 512 it
// puts this accumulation at 0.41x the error of f32 fmas (one running sum
// of all three terms: 13x).  No product runs in 1xTF32 or bf16.  The
// gating (exponentials, row sums, q.n, the combine, the division) is f32
// on the CUDA cores, from f64 sums (stats).
//
// Tiles: 128 threads, 4 warps of 32 x 32 in a 64 x 64 block tile, K steps
// of 32 staged through shared memory by cp.async (16-byte copies, three
// stages, two in flight while one computes; zero-filled past the ragged
// edges).  Row-major tiles have a 36-float row stride and k-major ones 72,
// so every fragment load of a warp falls on 32 distinct banks.  The
// stages take 54 KB of dynamic shared memory, and the block's scales
// (chunk or dk floats) follow them, above the 48 KB default:
// cudaFuncSetAttribute raises the limit once per process, device, kernel
// and larger size.
//
// A ragged last chunk is masked, not padded: its missing steps would add
// nothing (zero q/k/v, log_i -1e30, log_f 0 in the reference), so the
// final state is the same.
//
// Layout: q, k (B,S,H,dk), v and y (B,S,H,dv), log_i, log_f (B,S,H), all
// contiguous, q/k/v and C0 16-byte aligned, dk and dv multiples of 4;
// C (B,H,dk,dv), n (B,H,dk), m (B,H).  bf16 q/k/v are widened to f32 in
// the workspace first.  Workspace: see carve().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int THREADS = 128;            // 4 warps, 2 x 2 warp tiles
constexpr int BM = 64;                  // block tile rows (and columns)
constexpr int BK = 32;                  // K step
constexpr int LDR = BK + 4;             // row stride of a row-major tile
constexpr int LDK = BM + 8;             // row stride of a k-major tile
constexpr int TILE = BM * LDR;          // floats per tile (== BK * LDK)
constexpr int NSTAGE = 3;               // cp.async stages in flight
constexpr int MAX_DEVICES = 64;
constexpr size_t SMEM_MAX = 200 * 1024;  // dynamic shared memory a block takes
constexpr int STATS_THREADS = 256;
constexpr int STATS_WARPS = STATS_THREADS / 32;
constexpr float NEG_INF = -1e30f;       // the reference's "minus infinity"
constexpr unsigned FULL = 0xffffffffu;

static_assert(TILE == BK * LDK, "row-major and k-major tiles share a size");

struct Dims {
  int B, S, H, dk, dv, chunk, nc, ldw;
  __host__ __device__ int bh() const { return B * H; }
  __host__ __device__ int sp() const { return nc * chunk; }
  __device__ int len(int c) const { return min(chunk, S - c * chunk); }
  // (b, t, h) in a (B,S,H) array
  __device__ size_t row(int b, int t, int h) const {
    return ((size_t)b * S + t) * H + h;
  }
};

struct Args {
  const float *q, *k, *v;               // f32 (bf16 inputs widened)
  const float *log_i, *log_f;
  const float *C0, *n0, *m0;            // initial state or null
  float *C, *n, *m;                     // final state
};

// Workspace (f32), see carve().
struct Work {
  double* F64;                             // (BH, sp): F in f64
  float *dmax, *mt, *interw, *rowsum, *qn, *denom;             // (BH, sp)
  float* rsp;                      // (BH, sp, rt): W's row sums by key tile
  float *Ftot, *g, *wcarry;                                    // (BH, nc)
  float *W;                                // (BH, nc, chunk, ldw)
  float *Cst;                              // (BH, nc, dk, dv)
  float *nst;                              // (BH, nc, dk)
  float *xq, *xk, *xv;                     // bf16 only: widened q, k, v
};

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src-size 0)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// x -> tf32(x), rounded to nearest with ties away from zero: what
// cvt.rna.tf32.f32 computes, in two integer operations on the bits (the
// conversion instruction runs on the card's slow conversion unit)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x -> hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d (16x8 f32) += a (16x8 tf32, row) * b (8x8 tf32, col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [r0, r0 + 64) x columns [k0, k0 + 32) of a row-major matrix (row
// stride ld floats) -> a 64 x LDR tile; rows at or past rlim and columns
// at or past klim (a multiple of 4) are zero-filled.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          size_t ld, int r0, int rlim,
                                          int k0, int klim) {
  for (int e = threadIdx.x; e < BM * (BK / 4); e += THREADS) {
    const int r = e >> 3, col = k0 + (e & 7) * 4;
    const bool ok = r0 + r < rlim && col < klim;
    cp_async16(dst + r * LDR + (e & 7) * 4,
               ok ? src + (size_t)(r0 + r) * ld + col : src, ok);
  }
}

// Rows [k0, k0 + 32) x columns [n0, n0 + 64) of a row-major matrix -> a
// BK x LDK (k-major) tile; rows at or past klim and columns at or past
// nlim (a multiple of 4) are zero-filled.
__device__ __forceinline__ void load_kmajor(float* dst, const float* src,
                                            size_t ld, int k0, int klim,
                                            int n0, int nlim) {
  for (int e = threadIdx.x; e < BK * (BM / 4); e += THREADS) {
    const int r = e >> 4, col = n0 + (e & 15) * 4;
    const bool ok = k0 + r < klim && col < nlim;
    cp_async16(dst + r * LDK + (e & 15) * 4,
               ok ? src + (size_t)(k0 + r) * ld + col : src, ok);
  }
}

// A thread's share of a 64 x 64 tile: warp (wm, wn) owns rows wm*32 +
// [0, 32) and columns wn*32 + [0, 32) as m16n8 fragments [mi][ni].  The
// tensor cores round their f32 sums toward zero: hi*hi is summed per K
// step of 32 in ``part``, from zero, and added to ``big`` on the CUDA
// cores (rounded to nearest); the two cross terms, 2^-11 smaller, run in
// ``small`` throughout (see the products note above).
struct Acc {
  float big[2][4][4];
  float part[2][4][4];
  float small[2][4][4];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) big[i][j][r] = small[i][j][r] = 0.f;
  }
  // the product's value at fragment (mi, ni, r)
  __device__ float at(int mi, int ni, int r) const {
    return big[mi][ni][r] + small[mi][ni][r];
  }
};

// Row and column (in the 64 x 64 tile) of fragment (mi, ni, r).
__device__ __forceinline__ int frag_row(int mi, int r) {
  return ((threadIdx.x >> 5) >> 1) * 32 + mi * 16 + ((threadIdx.x & 31) >> 2)
         + (r >> 1) * 8;
}
__device__ __forceinline__ int frag_col(int ni, int r) {
  return ((threadIdx.x >> 5) & 1) * 32 + ni * 8 + (threadIdx.x & 3) * 2
         + (r & 1);
}

// One staged K step of 32 in 3xTF32.  a(m, k) = As[m*LDR + k] (row-major)
// or As[k*LDK + m] (A_KMAJOR), times scale[m] (SCALE 1) or scale[k]
// (SCALE 2) in f32 before the split; b(k, n) = Bs[n*LDR + k] (n-major) or
// Bs[k*LDK + n] (B_KMAJOR).
template <bool A_KMAJOR, int SCALE, bool B_KMAJOR>
__device__ __forceinline__ void mma_stage(Acc& acc, const float* As,
                                          const float* Bs,
                                          const float* scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc.part[i][j][r] = 0.f;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 8) {
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = wm * 32 + mi * 16 + g + (r & 1) * 8;
        const int kx = kk + t + (r >> 1) * 4;
        float x = A_KMAJOR ? As[kx * LDK + m] : As[m * LDR + kx];
        if (SCALE == 1) x *= scale[m];
        if (SCALE == 2) x *= scale[kx];
        split(x, ah[mi][r], al[mi][r]);
      }
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = wn * 32 + ni * 8 + g;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kx = kk + t + r * 4;
        const float x = B_KMAJOR ? Bs[kx * LDK + n] : Bs[n * LDR + kx];
        split(x, bh[ni][r], bl[ni][r]);
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        mma_tf32(acc.small[mi][ni], al[mi], bh[ni][0], bh[ni][1]);
        mma_tf32(acc.small[mi][ni], ah[mi], bl[ni][0], bl[ni][1]);
        mma_tf32(acc.part[mi][ni], ah[mi], bh[ni][0], bh[ni][1]);
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        acc.big[i][j][r] = __fadd_rn(acc.big[i][j][r], acc.part[i][j][r]);
}

// One stage of a product block's shared memory: A and B tiles.  NSTAGE of
// them in dynamic shared memory, then the block's per-step scales (kv_w,
// or n's slice), filled once before the K loop: a plain global load
// inside the loop would hold its warp, and the next barrier the block,
// for a round trip to L2 every step.
struct Stage {
  float A[TILE];
  float B[TILE];
};
constexpr size_t STAGES_BYTES = NSTAGE * sizeof(Stage);

__host__ __device__ constexpr int up32(int n) { return (n + 31) & ~31; }

// The K loop over ntiles steps: load(i, stage) issues step i's copies into
// stage; compute(i, stage) consumes it.
// NSTAGE - 1 steps' copies fly while one computes; one barrier a step.
template <typename Load, typename Compute>
__device__ __forceinline__ void pipeline(int ntiles, Load load,
                                         Compute compute) {
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) {
    if (i < ntiles) load(i, i);
    cp_async_commit();
  }
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // step i landed; step i - 1's stage is free
    const int next = i + NSTAGE - 1;
    if (next < ntiles) load(next, next % NSTAGE);
    cp_async_commit();
    compute(i, i % NSTAGE);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// m at chunk c's start: the carry m' = max(m + F_tot, g) over the chunks
// before it, as the plain version computes it.
__device__ __forceinline__ float m_start(const Args& a, const Work& w,
                                         const Dims& d, int bh, int c) {
  float m = a.m0 ? a.m0[bh] : NEG_INF;
  for (int j = 0; j < c; ++j)
    m = fmaxf(m + w.Ftot[bh * d.nc + j], w.g[bh * d.nc + j]);
  return m;
}

// ------------------------------------------------------------- 0. widen

__global__ void widen_kernel(const __nv_bfloat16* __restrict__ src,
                             float* __restrict__ dst, size_t count) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x)
    dst[i] = __bfloat162float(src[i]);
}

// ------------------------------------------------------------- 1. stats

__global__ void __launch_bounds__(STATS_THREADS)
mlstm_stats_kernel(Args a, Work w, Dims d) {
  __shared__ double wsum[STATS_WARPS];
  __shared__ double wval[STATS_WARPS];
  __shared__ int widx[STATS_WARPS];
  __shared__ float wmax[STATS_WARPS];
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / d.H, h = bh % d.H;
  const int t0 = c * d.chunk, len = d.len(c);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t base = (size_t)bh * d.sp() + t0;
  double carry = 0.0;          // F before this segment
  double best = -INFINITY;     // prefix argmax of li_s - F_s before it
  int best_s = 0;
  for (int s0 = 0; s0 < len; s0 += STATS_THREADS) {
    const int t = s0 + tid;
    const bool in = t < len;
    const float lf = in ? a.log_f[d.row(b, t0 + t, h)] : 0.f;
    const float li = in ? a.log_i[d.row(b, t0 + t, h)] : 0.f;
    // inclusive scan of log_f in f64 (exact for these sums)
    double x = lf;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    double off = carry;
    for (int j = 0; j < warp; ++j) off += wsum[j];
    const double F = off + x;
    double seg = 0.0;
    for (int j = 0; j < STATS_WARPS; ++j) seg += wsum[j];
    // prefix argmax of li_s - F_s (larger value, then earlier s)
    double val = in ? (double)li - F : -INFINITY;
    int idx = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double ov = __shfl_up_sync(FULL, val, o);
      const int oi = __shfl_up_sync(FULL, idx, o);
      if (lane >= o && (ov > val || (ov == val && oi < idx))) {
        val = ov;
        idx = oi;
      }
    }
    if (lane == 31) {
      wval[warp] = val;
      widx[warp] = idx;
    }
    if (in) w.F64[base + t] = F;
    __syncthreads();
    double pv = best;
    int pi = best_s;
    for (int j = 0; j < warp; ++j)
      if (wval[j] > pv || (wval[j] == pv && widx[j] < pi)) {
        pv = wval[j];
        pi = widx[j];
      }
    if (pv > val || (pv == val && pi < idx)) {
      val = pv;
      idx = pi;
    }
    if (in)  // max_s D[t,s] = (F_t - F_s*) + li_s*
      w.dmax[base + t] = (float)((F - w.F64[base + idx])
                                 + (double)a.log_i[d.row(b, t0 + idx, h)]);
    for (int j = 0; j < STATS_WARPS; ++j)  // carry to the next segment
      if (wval[j] > best || (wval[j] == best && widx[j] < best_s)) {
        best = wval[j];
        best_s = widx[j];
      }
    carry += seg;
    __syncthreads();
  }
  const double F_tot = w.F64[base + len - 1];
  float mx = -INFINITY;
  for (int t = tid; t < len; t += STATS_THREADS)
    mx = fmaxf(mx, (float)((F_tot - w.F64[base + t])
                           + (double)a.log_i[d.row(b, t0 + t, h)]));
  for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
  if (lane == 0) wmax[warp] = mx;
  __syncthreads();
  if (tid == 0) {
    for (int j = 1; j < STATS_WARPS; ++j) mx = fmaxf(mx, wmax[j]);
    w.Ftot[bh * d.nc + c] = (float)F_tot;
    w.g[bh * d.nc + c] = mx;
  }
}

// ---------------------------------------------------------- 2. products

// scores: rows [r*64, r*64 + 64) x keys [ct*64, ct*64 + 64) of chunk c
// (ct <= r): W and its row sums over these keys.
__device__ __forceinline__ void scores_block(const Args& a, const Work& w,
                                             const Dims& d, Stage* st, int r,
                                             int ct, int c, int bh) {
  __shared__ double Fr[BM], Fc[BM];
  __shared__ float mtr[BM], lic[BM], rs[2][BM];
  const int b = bh / d.H, h = bh % d.H, tid = threadIdx.x;
  const int t0 = c * d.chunk, len = d.len(c), r0 = r * BM, s0 = ct * BM;
  if (r0 >= len) return;
  const size_t base = (size_t)bh * d.sp() + t0;
  const float m = m_start(a, w, d, bh, c);
  if (tid < BM) {
    const int t = r0 + tid;
    double F = 0.0;
    float mt = 0.f;
    if (t < len) {
      F = w.F64[base + t];
      const double inter = (double)m + F;         // log of the C term's scale
      mt = fmaxf(w.dmax[base + t], (float)inter);
      if (ct == 0) {
        w.mt[base + t] = mt;
        w.interw[base + t] = (float)exp(inter - (double)mt);
      }
    }
    Fr[tid] = F;
    mtr[tid] = mt;
    const int s = s0 + tid;
    Fc[tid] = s < len ? w.F64[base + s] : 0.0;
    lic[tid] = s < len ? a.log_i[d.row(b, t0 + s, h)] : 0.f;
  }
  const size_t ldq = (size_t)d.H * d.dk;
  const float* qb = a.q + ((size_t)b * d.S * d.H + h) * d.dk + t0 * ldq;
  const float* kb = a.k + ((size_t)b * d.S * d.H + h) * d.dk + t0 * ldq;
  float* W = w.W + ((size_t)bh * d.nc + c) * d.chunk * d.ldw;
  Acc acc;
  acc.zero();
  pipeline((d.dk + BK - 1) / BK,
      [&](int i, int sg) {
        load_rows(st[sg].A, qb, ldq, r0, len, i * BK, d.dk);
        load_rows(st[sg].B, kb, ldq, s0, len, i * BK, d.dk);
      },
      [&](int, int sg) {
        mma_stage<false, 0, false>(acc, st[sg].A, st[sg].B, nullptr);
      });
  float rsum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tr = frag_row(mi, e), sc = frag_col(ni, e);
        const int t = r0 + tr, s = s0 + sc;
        float val = 0.f;
        if (t < len && s <= t)
          val = acc.at(mi, ni, e)
                * (float)exp(((Fr[tr] - Fc[sc]) + (double)lic[sc])
                             - (double)mtr[tr]);
        rsum[mi][e >> 1] += val;
        if (t < len && s < d.ldw) W[(size_t)t * d.ldw + s] = val;
      }
  // row sums over the tile's keys: the four lanes of a row, then the two
  // warps of a row
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float x = rsum[mi][hf];
      x += __shfl_xor_sync(FULL, x, 1);
      x += __shfl_xor_sync(FULL, x, 2);
      if ((tid & 3) == 0) rs[(tid >> 5) & 1][frag_row(mi, hf * 2)] = x;
    }
  __syncthreads();
  const int rt = (d.chunk + BM - 1) / BM;
  if (tid < BM && r0 + tid < len)
    w.rsp[(base + r0 + tid) * rt + ct] = rs[0][tid] + rs[1][tid];
}

// state: the chunk's contribution dC = (k o kv_w)^T V to rows [i*64, +64)
// of dk and columns [j*64, +64) of dv, and dn in the j == 0 blocks.
__device__ __forceinline__ void state_block(const Args& a, const Work& w, const Dims& d,
                            Stage* st, int i, int j, int c, int bh) {
  __shared__ float dn_part[THREADS];
  const int b = bh / d.H, h = bh % d.H, tid = threadIdx.x;
  const int t0 = c * d.chunk, len = d.len(c);
  const size_t base = (size_t)bh * d.sp() + t0;
  const float m = m_start(a, w, d, bh, c);
  const float m_next = fmaxf(m + w.Ftot[bh * d.nc + c], w.g[bh * d.nc + c]);
  const double F_tot = w.F64[base + len - 1];
  const float wc = (float)exp(((double)m + F_tot) - (double)m_next);
  const bool first = i == 0 && j == 0;
  if (first && tid == 0) {
    w.wcarry[bh * d.nc + c] = wc;
    if (c == d.nc - 1) a.m[bh] = m_next;
  }
  const size_t ldk = (size_t)d.H * d.dk, ldv = (size_t)d.H * d.dv;
  const float* kb = a.k + ((size_t)b * d.S * d.H + h) * d.dk + t0 * ldk;
  const float* vb = a.v + ((size_t)b * d.S * d.H + h) * d.dv + t0 * ldv;
  const int row0 = i * BM, col0 = j * BM;
  float* kw = reinterpret_cast<float*>(st + NSTAGE);   // up32(chunk)
  for (int s = tid; s < up32(len); s += THREADS) {
    float x = 0.f;
    if (s < len) {
      x = (float)exp(((F_tot - w.F64[base + s])
                      + (double)a.log_i[d.row(b, t0 + s, h)])
                     - (double)m_next);
    }
    kw[s] = x;
  }
  float dn = 0.f;
  Acc acc;
  acc.zero();
  pipeline((len + BK - 1) / BK,
      [&](int it, int sg) {
        load_kmajor(st[sg].A, kb, ldk, it * BK, len, row0, d.dk);
        load_kmajor(st[sg].B, vb, ldv, it * BK, len, col0, d.dv);
      },
      [&](int it, int sg) {
        const float* scale = kw + it * BK;
        mma_stage<true, 2, true>(acc, st[sg].A, st[sg].B, scale);
        if (j == 0) {  // dn: column tid % 64 of the tile, half the steps
          const int col = tid & (BM - 1), k0 = (tid >> 6) * (BK / 2);
#pragma unroll
          for (int kx = k0; kx < k0 + BK / 2; ++kx)
            dn += st[sg].A[kx * LDK + col] * scale[kx];
        }
      });
  const size_t cst = ((size_t)bh * d.nc + c) * d.dk * d.dv;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + frag_row(mi, e), col = col0 + frag_col(ni, e);
        if (row >= d.dk || col >= d.dv) continue;
        const float dC = acc.at(mi, ni, e);
        const size_t at = (size_t)row * d.dv + col;
        if (d.nc == 1) {  // the final state: C0 w_carry + dC
          const size_t o = (size_t)bh * d.dk * d.dv + at;
          a.C[o] = a.C0 ? __fadd_rn(__fmul_rn(a.C0[o], wc), dC) : dC;
        } else {
          w.Cst[cst + at] = dC;
        }
      }
  if (j == 0) {
    dn_part[tid] = dn;
    __syncthreads();
    if (tid < BM && row0 + tid < d.dk) {
      const float x = dn_part[tid] + dn_part[tid + BM];
      const int row = row0 + tid;
      if (d.nc == 1) {
        const size_t o = (size_t)bh * d.dk + row;
        a.n[o] = a.n0 ? __fadd_rn(__fmul_rn(a.n0[o], wc), x) : x;
      } else {
        w.nst[((size_t)bh * d.nc + c) * d.dk + row] = x;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
mlstm_products_kernel(Args a, Work w, Dims d, int n_scores) {
  extern __shared__ __align__(16) unsigned char dyn[];
  Stage* st = reinterpret_cast<Stage*>(dyn);
  int bid = blockIdx.x;
  const int rt = (d.chunk + BM - 1) / BM, pairs = rt * (rt + 1) / 2;
  if (bid < n_scores) {  // (row tile, key tile <= it), chunk, b*h
    int p = bid % pairs, r = 0;
    while (p > r) p -= ++r;
    const int rest = bid / pairs;
    scores_block(a, w, d, st, r, p, rest % d.nc, rest / d.nc);
    return;
  }
  bid -= n_scores;
  const int ti = (d.dk + BM - 1) / BM, tj = (d.dv + BM - 1) / BM;
  const int i = bid % ti, j = (bid / ti) % tj, rest = bid / (ti * tj);
  state_block(a, w, d, st, i, j, rest % d.nc, rest / d.nc);
}

// ----------------------------------------------------------- 3. combine

// C_{c+1} = C_c w_carry_c + dC_c in chunk order, elementwise; slot c of
// Cst (dC_c on entry) ends holding C_c for c >= 1 (the out pass reads C0
// for chunk 0).  The last block of each head does n.
__global__ void __launch_bounds__(256)
mlstm_combine_kernel(Args a, Work w, Dims d) {
  const int bh = blockIdx.y;
  const float* wc = w.wcarry + bh * d.nc;
  if (blockIdx.x == gridDim.x - 1) {
    for (int i = threadIdx.x; i < d.dk; i += blockDim.x) {
      const size_t o = (size_t)bh * d.dk + i;
      float x = a.n0 ? a.n0[o] : 0.f;
      for (int c = 0; c < d.nc; ++c) {
        float* slot = w.nst + ((size_t)bh * d.nc + c) * d.dk + i;
        const float dn = *slot;
        if (c > 0) *slot = x;
        x = __fadd_rn(__fmul_rn(x, wc[c]), dn);
      }
      a.n[o] = x;
    }
    return;
  }
  const size_t plane = (size_t)d.dk * d.dv, quads = plane / 4;
  const size_t qd = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (qd >= quads) return;
  const size_t o = (size_t)bh * plane + qd * 4;
  float4 x = a.C0 ? *reinterpret_cast<const float4*>(a.C0 + o)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < d.nc; ++c) {
    float4* slot = reinterpret_cast<float4*>(
        w.Cst + ((size_t)bh * d.nc + c) * plane + qd * 4);
    const float4 dC = *slot;
    if (c > 0) *slot = x;
    const float k = wc[c];
    x.x = __fadd_rn(__fmul_rn(x.x, k), dC.x);
    x.y = __fadd_rn(__fmul_rn(x.y, k), dC.y);
    x.z = __fadd_rn(__fmul_rn(x.z, k), dC.z);
    x.w = __fadd_rn(__fmul_rn(x.w, k), dC.w);
  }
  *reinterpret_cast<float4*>(a.C + o) = x;
}

// --------------------------------------------------------------- 4. out

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mlstm_out_kernel(Args a, Work w, Dims d, T* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char dyn[];
  Stage* st = reinterpret_cast<Stage*>(dyn);
  __shared__ float iw_s[BM], den_s[BM];
  const int r = blockIdx.x, j = blockIdx.y;
  const int c = blockIdx.z % d.nc, bh = blockIdx.z / d.nc;
  const int b = bh / d.H, h = bh % d.H, tid = threadIdx.x;
  const int t0 = c * d.chunk, len = d.len(c), r0 = r * BM, col0 = j * BM;
  if (r0 >= len) return;
  const size_t base = (size_t)bh * d.sp() + t0;
  const bool has_C = c > 0 || a.C0 != nullptr;
  const float* Cs = !has_C ? nullptr
                  : c == 0 ? a.C0 + (size_t)bh * d.dk * d.dv
                           : w.Cst + ((size_t)bh * d.nc + c) * d.dk * d.dv;
  const float* ns = c > 0 ? w.nst + ((size_t)bh * d.nc + c) * d.dk
                          : (a.n0 ? a.n0 + (size_t)bh * d.dk : nullptr);
  if (tid < BM)
    iw_s[tid] = r0 + tid < len ? w.interw[base + r0 + tid] : 0.f;
  float* n_s = reinterpret_cast<float*>(st + NSTAGE);  // up32(dk)
  if (has_C)
    for (int k = tid; k < up32(d.dk); k += THREADS)
      n_s[k] = ns && k < d.dk ? ns[k] : 0.f;
  const size_t ldq = (size_t)d.H * d.dk, ldv = (size_t)d.H * d.dv;
  const float* qb = a.q + ((size_t)b * d.S * d.H + h) * d.dk + t0 * ldq;
  const float* vb = a.v + ((size_t)b * d.S * d.H + h) * d.dv + t0 * ldv;
  const float* W = w.W + ((size_t)bh * d.nc + c) * d.chunk * d.ldw;
  const int s_end = min(len, r0 + BM);              // causal: s < s_end
  const int wlim = min(d.ldw, r0 + BM);             // W written up to here
  const int nsv = (s_end + BK - 1) / BK;
  const int nkd = has_C ? (d.dk + BK - 1) / BK : 0;
  float qn = 0.f;  // (q o interw) . n over half the k of row tid / 2
  Acc acc;
  acc.zero();
  pipeline(nsv + nkd,
      [&](int i, int sg) {
        if (i < nsv) {
          load_rows(st[sg].A, W, d.ldw, r0, len, i * BK, wlim);
          load_kmajor(st[sg].B, vb, ldv, i * BK, len, col0, d.dv);
        } else {
          const int k0 = (i - nsv) * BK;
          load_rows(st[sg].A, qb, ldq, r0, len, k0, d.dk);
          load_kmajor(st[sg].B, Cs, d.dv, k0, d.dk, col0, d.dv);
        }
      },
      [&](int i, int sg) {
        if (i < nsv) {
          mma_stage<false, 0, true>(acc, st[sg].A, st[sg].B, nullptr);
        } else {
          mma_stage<false, 1, true>(acc, st[sg].A, st[sg].B, iw_s);
          const int row = tid >> 1, k0 = (tid & 1) * (BK / 2);
          const float iw = iw_s[row];
          const float* nk = n_s + (i - nsv) * BK;
#pragma unroll
          for (int kx = k0; kx < k0 + BK / 2; ++kx)
            qn += (st[sg].A[row * LDR + kx] * iw) * nk[kx];
        }
      });
  qn += __shfl_xor_sync(FULL, qn, 1);
  if ((tid & 1) == 0) {
    const int row = tid >> 1, t = r0 + row;
    if (t < len) {  // W's row sum: its key tiles' sums in order
      const int rt = (d.chunk + BM - 1) / BM;
      const float* part = w.rsp + (base + t) * rt;
      float rsum = part[0];
      for (int ct = 1; ct <= r; ++ct) rsum += part[ct];
      const float den = fmaxf(fabsf(rsum + qn), expf(-w.mt[base + t]));
      den_s[row] = den;
      if (j == 0) {
        w.rowsum[base + t] = rsum;
        w.qn[base + t] = qn;
        w.denom[base + t] = den;
      }
    }
  }
  __syncthreads();
  T* yb = y + ((size_t)b * d.S * d.H + h) * d.dv + t0 * ldv;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tr = frag_row(mi, e), col = col0 + frag_col(ni, e);
        if (r0 + tr < len && col < d.dv)
          store(yb + (size_t)(r0 + tr) * ldv + col,
                acc.at(mi, ni, e) / den_s[tr]);
      }
}

// ---------------------------------------------------------------- host

size_t up4(size_t n) { return (n + 3) & ~(size_t)3; }

// Carves the workspace ``ws`` into ``w`` (when ``w`` is given); returns
// its size in floats.  Every part starts 16-byte aligned.  Per b*H + h:
// over the padded sequence (nc * chunk) F in f64, dmax, mt, interw,
// rowsum, qn, denom, and rsp (W's row sums by key tile of 64); per chunk
// Ftot, g, wcarry; W per chunk (chunk x ldw, ldw = chunk rounded up to
// 4); the state slots Cst (nc x dk x dv) and nst (nc x dk); then, for
// bf16 inputs, q, k, v widened to f32.
size_t carve(int B, int S, int H, int dk, int dv, int chunk, int bf16,
             float* ws, Work* w) {
  const size_t nc = (S + chunk - 1) / chunk, sp = nc * chunk;
  const size_t bh = (size_t)B * H, ldw = up4(chunk), rows = (size_t)B * S * H;
  const size_t rt = (chunk + BM - 1) / BM;
  const size_t sizes[17] = {
      2 * bh * sp, bh * sp, bh * sp, bh * sp, bh * sp, bh * sp, bh * sp,
      bh * sp * rt, bh * nc, bh * nc, bh * nc, bh * nc * chunk * ldw,
      bh * nc * dk * dv, bh * nc * dk,
      bf16 ? rows * dk : 0, bf16 ? rows * dk : 0, bf16 ? rows * dv : 0};
  float* f64 = nullptr;
  float** parts[17] = {nullptr};
  if (w) {
    float** p[17] = {&f64, &w->dmax, &w->mt, &w->interw, &w->rowsum,
                     &w->qn, &w->denom, &w->rsp, &w->Ftot, &w->g,
                     &w->wcarry, &w->W, &w->Cst, &w->nst, &w->xq, &w->xk,
                     &w->xv};
    for (int i = 0; i < 17; ++i) parts[i] = p[i];
  }
  size_t off = 0;
  for (int i = 0; i < 17; ++i) {
    if (w) *parts[i] = sizes[i] ? ws + off : nullptr;
    off += up4(sizes[i]);
  }
  if (w) w->F64 = reinterpret_cast<double*>(f64);
  return off;
}

// Raise a product kernel's dynamic shared-memory limit (above the 48 KB
// default) once per process, device, kernel and larger size.
template <int ID, typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  static std::mutex mu;
  static size_t allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) allowed[dev] = bytes;
  return err;
}

template <typename T>
int launch(Args a, T* y, float* ws, const Dims& d, int bf16,
           cudaStream_t stream) {
  Work w;
  carve(d.B, d.S, d.H, d.dk, d.dv, d.chunk, bf16, ws, &w);
  cudaError_t err;
  const size_t smem_products = STAGES_BYTES + sizeof(float) * up32(d.chunk);
  const size_t smem_out = STAGES_BYTES + sizeof(float) * up32(d.dk);
  if (smem_products > SMEM_MAX || smem_out > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  if ((err = allow_smem<0>(mlstm_products_kernel, smem_products))
          != cudaSuccess ||
      (err = allow_smem<sizeof(T)>(mlstm_out_kernel<T>, smem_out))
          != cudaSuccess)
    return (int)err;
  const int bh = d.bh();
  const int rt = (d.chunk + BM - 1) / BM;
  const int n_scores = rt * (rt + 1) / 2 * d.nc * bh;
  const int n_state = ((d.dk + BM - 1) / BM) * ((d.dv + BM - 1) / BM)
                      * d.nc * bh;
  mlstm_stats_kernel<<<dim3(d.nc, bh), STATS_THREADS, 0, stream>>>(a, w, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  mlstm_products_kernel<<<n_scores + n_state, THREADS, smem_products,
                          stream>>>(
      a, w, d, n_scores);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (d.nc > 1) {
    const size_t quads = (size_t)d.dk * d.dv / 4;
    const dim3 g((unsigned)((quads + 255) / 256) + 1, bh);
    mlstm_combine_kernel<<<g, 256, 0, stream>>>(a, w, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const dim3 g4(rt, (d.dv + BM - 1) / BM, d.nc * bh);
  mlstm_out_kernel<T><<<g4, THREADS, smem_out, stream>>>(a, w, d, y);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of f32 workspace mlstm_scan_fwd needs.
size_t mlstm_scan_workspace_bytes(int B, int S, int H, int dk, int dv,
                                  int chunk, int bf16) {
  return sizeof(float) * carve(B, S, H, dk, dv, chunk, bf16, nullptr,
                               nullptr);
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
  if (B < 1 || S < 1 || H < 1 || dk < 1 || dv < 1 || chunk < 1 || dk % 4
      || dv % 4 || (C0 != nullptr) != (n0 != nullptr)
      || (C0 != nullptr) != (m0 != nullptr))
    return (int)cudaErrorInvalidValue;
  const int nc = (S + chunk - 1) / chunk;
  if ((long long)nc * B * H > 65535) return (int)cudaErrorInvalidValue;
  const Dims d{B, S, H, dk, dv, chunk, nc, (int)up4(chunk)};
  Args a{static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), log_i, log_f, C0, n0, m0, C, n, m};
  if (bf16) {
    Work w;
    carve(B, S, H, dk, dv, chunk, bf16, ws, &w);
    const size_t rows = (size_t)B * S * H;
    const struct { const void* src; float* dst; size_t count; } parts[3] = {
        {q, w.xq, rows * dk}, {k, w.xk, rows * dk}, {v, w.xv, rows * dv}};
    for (const auto& p : parts) {
      widen_kernel<<<(unsigned)((p.count + 255) / 256 < 4096
                                    ? (p.count + 255) / 256 : 4096),
                     256, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(p.src), p.dst, p.count);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    a.q = w.xq;
    a.k = w.xk;
    a.v = w.xv;
    return launch<__nv_bfloat16>(a, static_cast<__nv_bfloat16*>(y), ws, d,
                                 bf16, stream);
  }
  return launch<float>(a, static_cast<float*>(y), ws, d, bf16, stream);
}

}  // extern "C"
