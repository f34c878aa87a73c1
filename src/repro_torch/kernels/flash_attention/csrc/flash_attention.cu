// Flash attention forward (prefill) for Hopper on the tensor cores, bf16 in
// and out, f32 accumulation and softmax.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py
// (flash_attention_kernel, body _flash_kernel): causal and/or sliding-window
// GQA attention with an online softmax over KV tiles, tiles wholly above the
// diagonal or outside the window skipped, kv head = h * KV / H.
//
// What bounds it on the H100: a causal prefill of S tokens does about
// 4*(S*S/2)*D*H operations on 4*S*H*D*2 bytes (q, k, v, o), S/4 operations
// per byte, so below ~1200 tokens (the card's ~295 bf16 operations per
// byte) the bytes bound it and above that the operations.  What the design
// does about each:
// - bytes: every K/V element read from device memory feeds the 64 query
//   rows of a block, and the score tile, the softmax state and the output
//   accumulator stay in registers; only q, k, v and o cross device memory.
//   K/V tiles are double buffered with cp.async (tile j+1 in flight while
//   tile j is computed), and the causal q-tiles launch heaviest first
//   (q-tile is the slowest grid dimension, reversed) so the short tiles
//   near the diagonal fill the tail.
// - operations: both products run on the tensor cores as
//   mma.sync.m16n8k16 bf16 -> f32, from ldmatrix fragments out of shared
//   memory whose 16-byte chunks are XOR-swizzled (no bank conflicts).
//   S = Q.K^T takes the unscaled bf16 Q (held in registers for the whole KV
//   loop) and bf16 K: exact products summed in f32.  The scale is applied
//   to the f32 scores after the product, inside the exponent (exp2(s*c -
//   m*c), c = scale*log2 e), never to the bf16 Q.  P.V takes P as two bf16
//   terms, P_hi = bf16(P) and P_lo = bf16(P - P_hi), in two MMAs that share
//   V's fragments: P is carried to ~2^-17 relative instead of bf16's 2^-9,
//   at 1.5x the products of a one-term kernel.
// At the main path's prompts (16..512 tokens, at most 8 KV tiles per
// block) the time goes to the block of the heaviest causal q-tile, whose
// tiles of mma.sync run in turn on one SM while lighter blocks finish
// early.  mma.sync reaches only part of the card's bf16 rate; wgmma fed
// by TMA from a producer warp is the step after this one.
//
// Layout: q (B, Sq, H, D), k and v (B, Sk, KV, D), o (B, Sq, H, D), all
// contiguous and 16-byte aligned, D in {32, 64, 128, 192}.  Grid (H, B,
// ceil(Sq/64)), 128 threads: 4 warps of 16 query rows each; KV tiles of 64
// keys.  Any Sq and Sk: key rows past Sk are zero-filled by cp.async and
// masked, query rows past Sq are computed from zeros and never stored.
// H % KV == 0 with any ratio.  Masks and constants follow _flash_kernel:
// NEG_INF = -1e30, denominator max(l, 1e-30); the mask is applied only on
// tiles that cross the diagonal, the window edge or Sk.
//
// D = 192 (MLA's nope + rope head dim, V zero-padded to it): Q, K and V
// tiles take 5 x 64 x 192 x 2 = 122,880 bytes of shared memory (one block
// an SM) and the f32 accumulator 96 registers a thread.  So that the
// thread stays within its 255 registers without spilling, Q's fragments
// are read from shared memory at every KV tile instead of being held, and
// each 16-column V fragment is loaded just before its four MMAs.  The
// arithmetic and its order per accumulator are those of the smaller dims.
// The dynamic shared-memory limit is raised once per process, device and
// instantiation (nothing below the default 48 KB), as the paged kernel
// does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per KV tile
constexpr int WARPS = 4;      // 16 query rows each
constexpr int THREADS = 32 * WARPS;
constexpr float NEG_INF = -1e30f;
constexpr size_t SMEM_DEFAULT = 48 * 1024;
constexpr int MAX_DEVICES = 64;

// A 64-row bf16 tile of D columns in shared memory.  Row r's 16-byte chunk
// c sits at chunk c ^ f(r): the eight rows one ldmatrix reads (or eight
// threads of a cp.async write) fall on eight distinct 16-byte bank groups.
template <int D>
struct Tile {
  static constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  static constexpr int ELEMS = BQ * D;  // BQ == BK
  static constexpr size_t SMEM = 5 * sizeof(__nv_bfloat16) * ELEMS;  // Q, 2x(K, V)
  static __device__ __forceinline__ int off(int r, int c) {
    if constexpr (CHUNKS >= 8)
      return r * D + ((c ^ (r & 7)) << 3);
    else
      return r * D + ((c ^ ((r / (8 / CHUNKS)) & (CHUNKS - 1))) << 3);
  }
};

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) -> bf16x2 hi = bf16(x, y) and lo = bf16(x - hi, y - hi)
__device__ __forceinline__ void split_p(float x, float y, uint32_t& hi,
                                        uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// rows [row0, row0 + 64) of a (rows, stride) bf16 matrix -> a Tile, as
// 16-byte cp.async copies; rows at or past nrows are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int nrows, size_t stride, int t) {
  constexpr int C = Tile<D>::CHUNKS;
#pragma unroll
  for (int n = 0; n < BQ * C / THREADS; ++n) {
    const int i = t + n * THREADS, r = i / C, c = i % C, row = row0 + r;
    const bool ok = row < nrows;
    cp_async16(dst + Tile<D>::off(r, c),
               src + (ok ? (size_t)row * stride : 0) + c * 8, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o,
                 int sq, int sk, int h, int kv, int causal, int window,
                 float scale) {
  using T = Tile<D>;
  constexpr int KS = D / 16;   // k-steps of Q.K^T
  constexpr int DT = D / 8;    // 8-column tiles of O
  constexpr int NT = BK / 8;   // 8-key tiles of S
  constexpr bool WIDE = D > 128;  // Q from shared memory, V one fragment at a time
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* k_s = q_s + T::ELEMS;      // two stages
  __nv_bfloat16* v_s = k_s + 2 * T::ELEMS;  // two stages

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // mma row group, thread in group
  const int wr = warp * 16;                   // the warp's rows in the tile
  const int hh = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest tile first
  const int g = hh * kv / h;  // kv head, as the TPU kernel's index map
  const float c = scale * 1.4426950408889634f;  // scale * log2(e)

  // KV tiles this q-tile needs: [kt_begin, kt_end), _flash_kernel's skip
  const int nk = (sk + BK - 1) / BK;
  int kt_end = nk, kt_begin = 0;
  if (causal) kt_end = min(nk, (q0 + BQ - 1) / BK + 1);
  if (window > 0) {
    const int x = q0 - window - (BK - 2);  // tile runs iff kt*BK >= x
    if (x > 0) kt_begin = (x + BK - 1) / BK;
  }

  const size_t q_stride = (size_t)h * D, kv_stride = (size_t)kv * D;
  const __nv_bfloat16* qb = q + ((size_t)b * sq * h + hh) * D;
  const __nv_bfloat16* kb = k + ((size_t)b * sk * kv + g) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * sk * kv + g) * D;

  load_tile<D>(q_s, qb, q0, sq, q_stride, t);
  if (kt_begin < kt_end) {
    load_tile<D>(k_s, kb, kt_begin * BK, sk, kv_stride, t);
    load_tile<D>(v_s, vb, kt_begin * BK, sk, kv_stride, t);
  }
  cp_async_commit();

  uint32_t qf[WIDE ? 1 : KS][4];  // Q's A-fragments, loaded once (D <= 128)
  float acc[DT][4];    // O: rows gid (0, 1) and gid + 8 (2, 3)
#pragma unroll
  for (int i = 0; i < DT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {  // next tile into the other stage
      load_tile<D>(k_s + (st ^ 1) * T::ELEMS, kb, (kt + 1) * BK, sk,
                   kv_stride, t);
      load_tile<D>(v_s + (st ^ 1) * T::ELEMS, vb, (kt + 1) * BK, sk,
                   kv_stride, t);
    }
    cp_async_commit();  // (an empty group on the last tile)
    cp_async_wait<1>();  // this tile (and Q) landed
    __syncthreads();
    const __nv_bfloat16* ks = k_s + st * T::ELEMS;
    const __nv_bfloat16* vs = v_s + st * T::ELEMS;

    if constexpr (!WIDE) {
      if (kt == kt_begin) {
#pragma unroll
        for (int i = 0; i < KS; ++i)
          ldmatrix_x4(qf[i], q_s + T::off(wr + (lane & 15), 2 * i + (lane >> 4)));
      }
    }

    // S = Q.K^T, 16 x 64 per warp in f32
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    // WIDE: k-steps in turn, so Q's fragments are not all read ahead
#pragma unroll (WIDE ? 1 : KS)
    for (int i = 0; i < KS; ++i) {
      uint32_t qa[4];
      if constexpr (WIDE) {
        ldmatrix_x4(qa, q_s + T::off(wr + (lane & 15), 2 * i + (lane >> 4)));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[i][e];
      }
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t kf[4];  // keys 16jp.. : (b0, b1) of tile 2jp, then 2jp + 1
        ldmatrix_x4(kf, ks + T::off(16 * jp + (lane & 7) + ((lane >> 4) << 3),
                                    2 * i + ((lane >> 3) & 1)));
        mma_bf16(s[2 * jp], qa, kf[0], kf[1]);
        mma_bf16(s[2 * jp + 1], qa, kf[2], kf[3]);
      }
    }

    // mask only where the tile crosses the diagonal, the window edge or Sk
    const int k0 = kt * BK;
    const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > q0)
                      || (window > 0 && k0 <= q0 + BQ - 1 - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = q0 + wr + gid + (e >> 1) * 8;
          const int kpos = k0 + 8 * j + 2 * tig + (e & 1);
          bool ok = kpos < sk;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          if (!ok) s[j][e] = NEG_INF;
        }
    }

    // online softmax in registers: row gid holds s[.][0..1], row gid + 8
    // s[.][2..3]; a row's 64 scores lie across the 4 threads of a quad.  m
    // is kept unscaled (scale > 0); the scale is applied in f32 inside the
    // exponent, exp(scale*s - scale*m) = exp2(s*c - m*c) with c = scale*log2 e.
    // A row with no unmasked key yet takes m*c = 0, so its masked scores
    // give p = 0 (not exp2 of the rounding residue of -1e30*c - m*c)
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_run[r];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[r] = exp2f((m_run[r] - mx) * c);
      m_run[r] = mx;
      const float mc = mx == NEG_INF ? 0.f : mx * c;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][2 * r] = exp2f(fmaf(s[j][2 * r], c, -mc));
        s[j][2 * r + 1] = exp2f(fmaf(s[j][2 * r + 1], c, -mc));
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      l_run[r] = l_run[r] * corr[r] + sum;
    }
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        acc[i][0] *= corr[0];
        acc[i][1] *= corr[0];
        acc[i][2] *= corr[1];
        acc[i][3] *= corr[1];
      }
    }

    // O += P.V, P = P_hi + P_lo: S's C-fragments of key tiles 2kk and
    // 2kk + 1 are the A-fragment of keys 16kk..16kk + 15
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_p(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_p(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_p(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_p(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
      if constexpr (WIDE) {
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t vf[4];  // columns 16dp..: (b0, b1) of tile 2dp, 2dp + 1
          ldmatrix_x4_trans(vf, vs + T::off(16 * kk + (lane & 7)
                                            + ((lane >> 3) & 1) * 8,
                                            2 * dp + (lane >> 4)));
          mma_bf16(acc[2 * dp], ph, vf[0], vf[1]);
          mma_bf16(acc[2 * dp + 1], ph, vf[2], vf[3]);
          mma_bf16(acc[2 * dp], pl, vf[0], vf[1]);
          mma_bf16(acc[2 * dp + 1], pl, vf[2], vf[3]);
        }
      } else {
        uint32_t vf[D / 16][4];  // columns 16dp..: (b0, b1) of tile 2dp, 2dp + 1
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp)
          ldmatrix_x4_trans(vf[dp], vs + T::off(16 * kk + (lane & 7)
                                                + ((lane >> 3) & 1) * 8,
                                                2 * dp + (lane >> 4)));
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          mma_bf16(acc[2 * dp], ph, vf[dp][0], vf[dp][1]);
          mma_bf16(acc[2 * dp + 1], ph, vf[dp][2], vf[dp][3]);
        }
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          mma_bf16(acc[2 * dp], pl, vf[dp][0], vf[dp][1]);
          mma_bf16(acc[2 * dp + 1], pl, vf[dp][2], vf[dp][3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before refill
  }
  cp_async_wait<0>();  // Q's copies too, when no tile ran
  __syncthreads();

  // epilogue: divide by max(l, 1e-30), round to bf16 once, stage the warp's
  // 16 rows in its own rows of the Q buffer, store 16-byte row chunks
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    den[r] = fmaxf(l, 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<__nv_bfloat162*>(
          q_s + T::off(wr + gid + 8 * r, i) + 2 * tig) =
          __floats2bfloat162_rn(acc[i][2 * r] / den[r],
                                acc[i][2 * r + 1] / den[r]);
  __syncwarp();
#pragma unroll
  for (int n = 0; n < DT / 2; ++n) {  // 16 rows x DT chunks over 32 lanes
    const int i = lane + 32 * n, r = wr + i / DT, c = i % DT, row = q0 + r;
    if (row < sq)
      *reinterpret_cast<uint4*>(o + ((size_t)(b * sq + row) * h + hh) * D
                                + c * 8) =
          *reinterpret_cast<const uint4*>(q_s + T::off(r, c));
  }
}

// Raise the instantiation's dynamic shared-memory limit once per process
// and device; nothing below the default.
template <int D>
cudaError_t allow_smem() {
  constexpr size_t bytes = Tile<D>::SMEM;
  if (bytes <= SMEM_DEFAULT) return cudaSuccess;
  static std::mutex mu;
  static bool allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) allowed[dev] = true;
  return err;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int sq, int sk, int h, int kv, int causal,
                   int window, float scale, cudaStream_t stream) {
  const int nq = (sq + BQ - 1) / BQ;
  if (b > 65535 || nq > 65535) return cudaErrorInvalidValue;
  const size_t smem = Tile<D>::SMEM;
  cudaError_t err = allow_smem<D>();
  if (err != cudaSuccess) return err;
  dim3 grid(h, b, nq);
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
    case 192: return launch<192>(q, k, v, o, b, sq, sk, h, kv, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
