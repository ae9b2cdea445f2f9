// Flash attention with the DMS delayed-eviction mask for Hopper (sm_90a):
// the forward pass and the two backward passes (dq; dk, dv and d log_surv).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/dms_attention/
// dms_attention.py: `flash_fwd` (body `_fwd_kernel`), `flash_dq` (body
// `_dq_kernel`) and `flash_dkv` (body `_dkv_kernel`).
//
// Layout (the reference's folded, padded operands):
//   q, out, do, dq       (B*Hq,  Tp, Dh)   fp32 or bf16
//   k, v, dk, dv         (B*Hkv, Tp, Dh)   same dtype as q
//   ls, dls              (B*Hkv, Tp)       fp32, log(1 - alpha) per key
//   lse, delta           (B*Hq,  Tp)       fp32
//   hr                   (B*Hkv, nK_ref)   int32, "block holds a retained key";
//                                          read only with `skip`, else may be null
// Query head h reads kv row b*Hkv + (h % Hq) / G (`_kv_row`).
//
// Scores, in the order of `_mask_scores`: s = (q . k) * scale, then the
// softcap, then + ls[j] where i - j >= delay, then -1e30 (finite) where the
// key is after the query (causal), outside the local window, or padding
// (j >= t).  Every sum is fp32 whatever the operands' dtype.
//
// What bounds it: operations.  At the retrofit shape (B 2, T 1024, Hq 12,
// Hkv 2, Dh 128) a forward call does ~6.4 GFLOP over ~12 MB of operands,
// ~500 flop per byte, above the H100's ~295 flop/byte ridge for bf16; the
// backward passes are further above it.
//
// Two routes, picked by dtype alone:
//
// * bf16 operands (the retrofit path; `tc::` below) run every product on the
//   tensor cores: `wgmma.mma_async` m64n64k16, bf16 in, fp32 accumulate.
//   Q.K^T (fwd, dq), dO.V^T (dq) and K.Q^T, V.dO^T (dkv) read both operands
//   from shared memory in the 128-byte swizzle that TMA writes; P.V (fwd),
//   dS.K (dq) and P^T.dO, dS^T.Q (dkv) take P or dS from the score
//   accumulators, rounded to bf16 in registers, as the A operand, and the
//   other tile as a transposed (MN-major) B operand.  A producer warp
//   streams the tiles by TMA (`cp.async.bulk.tensor`) into a two-stage ring
//   guarded by mbarriers, so tile k+1 loads while tile k computes; TMA
//   zero-fills rows past Tp.  The kernels take Dh 64 or 128 (the wrapper
//   zero-pads a smaller Dh to 64 or 128).
//   - fwd and dq: one block per (q head, q tile), q tiles launched
//     longest-first (the last has the most key tiles under the causal
//     mask).  A block is one consumer warpgroup of 64 rows, two on an SM
//     (128-row blocks of two warpgroups measured slower at the retrofit
//     shape, PERF.md).  fwd keeps each row's online-softmax max and sum in
//     the 4 threads that share the row; dq loads its Q and dO tiles once,
//     reads each row's lse and delta once, and keeps dq in registers across
//     the key tiles, so each row is written once by its own block.
//   - dkv: one block per (kv head, 64-key tile, slice of the G query heads),
//     key tile 0 (the longest under causal) first.  The c blocks of one
//     (kv head, key tile) form a thread-block cluster, c the largest divisor
//     of G up to 4 (3 at G = 6, 4 at G = 4: the fastest measured), each
//     block summing G/c heads; at the end each writes its fp32 dk, dv and
//     dls partials to its shared memory, and after a cluster barrier each
//     sums a 1/c slice of the rows across the cluster's shared memory, in
//     rank order: no atomics, the same bits on every launch.
// * fp32 operands run the first design on the fp32 CUDA cores (67 TFLOP/s
//   peak), the check of the bf16 route: each thread owns a 4 x 4 block of a
//   64 x 64 score tile and a 4 x 8 block of the 64 x Dh accumulator, fed
//   from fp32 tiles in shared memory padded by one word per row.  fp32
//   products stay unrounded there (the tensor cores would round them to
//   bf16), and their sums run in one FMA chain in the plain version's order.
//   - fwd and dq: one thread block per (q head, 64-row q tile) loops over
//     the k tiles; the online-softmax state (fwd) or the dq sum (dq) stays
//     in registers across the loop;
//   - dkv: one thread block per (kv head, 64-key tile) loops over the G
//     query heads of its group and every q tile, so dk, dv and dls are each
//     written once, with no atomics.
//
// Both routes visit only live tiles: with `causal` a q tile's loop stops at
// the diagonal tile and dkv's loop starts there; a tile outside the local
// window, or (with `skip`) inside the eviction zone for every query of the
// tile with no retained key in the reference blocks it overlaps
// (`_block_live`), is neither loaded nor computed.  A skipped tile's scores
// are all -1e30 or carry log_surv = -1e30, so it adds exactly zero.
//
// Plain C interface, loaded with ctypes; each entry point launches on the
// caller's stream and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda.h>            // CUtensorMap; the encoder comes from the driver
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // q rows and keys per tile
constexpr int kThreads = 256;      // 16 x 16 threads, 4 x 4 scores each
constexpr int kMaxDh = 128;
constexpr int kAccCols = kMaxDh / 16;
constexpr int kPStride = kTile + 1;
constexpr float kNegInf = -1e30f;

struct Params {
  int tp, dh, hq, hkv, t;
  int nk_ref, block_k;     // the reference's k blocks, for `hr`
  int window;              // local window, or -1 for none
  int delay;               // eviction delay (0: no DMS mask)
  int causal, skip, has_cap;
  float cap, scale;
};

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows [0, rows) of a (rows, dh) slab into a (kTile, dh + 1) fp32 tile;
// rows beyond `rows` are zero
__device__ void load_tile(float* dst, const float* __restrict__ src, int rows,
                          int dh) {
  const int st = dh + 1;
  for (int e = threadIdx.x; e < kTile * dh; e += kThreads) {
    const int r = e / dh;
    const int c = e - r * dh;
    dst[r * st + c] = r < rows ? src[(size_t)r * dh + c] : 0.f;
  }
}

__device__ void load_vec(float* dst, const float* __restrict__ src, int n) {
  for (int e = threadIdx.x; e < kTile; e += kThreads)
    dst[e] = e < n ? src[e] : 0.f;
}

// `_block_live` for the tile of q rows [q0, q0 + bq) and keys [k0, k0 + bk)
__device__ bool tile_live(const Params& p, int q0, int k0, int bq, int bk,
                          const int32_t* __restrict__ hr_row) {
  const int q_end = min(q0 + bq, p.tp) - 1;
  const int k_end = min(k0 + bk, p.tp) - 1;
  if (p.causal && k0 > q_end) return false;
  if (p.window > 0 && k_end < q0 - p.window + 1) return false;
  if (p.skip && p.delay > 0 && q0 - k_end >= p.delay) {
    for (int kb = k0 / p.block_k; kb <= k_end / p.block_k && kb < p.nk_ref; ++kb)
      if (hr_row[kb] > 0) return true;
    return false;
  }
  return true;
}

// the bk-key tiles a bq-row q tile visits: from the window's first to the
// diagonal
__device__ void k_range(const Params& p, int q0, int bq, int bk, int& lo,
                        int& hi) {
  const int nkt = (p.tp + bk - 1) / bk;
  const int q_end = min(q0 + bq, p.tp) - 1;
  hi = p.causal ? min(nkt - 1, q_end / bk) : nkt - 1;
  lo = p.window > 0 ? max(0, q0 - p.window + 1) / bk : 0;
}

// the bq-row q tiles a bk-key tile is visited by: from the diagonal to the
// window's last
__device__ void q_range(const Params& p, int k0, int bq, int bk, int& lo,
                        int& hi) {
  const int nqt = (p.tp + bq - 1) / bq;
  const int k_end = min(k0 + bk, p.tp) - 1;
  lo = p.causal ? k0 / bq : 0;
  hi = p.window > 0 ? min(nqt - 1, (k_end + p.window - 1) / bq) : nqt - 1;
}

// One score of the tile: raw (already scaled) -> (masked score, capped score)
__device__ __forceinline__ float mask_score(const Params& p, float s, int i,
                                            int j, float ls_j, float* capped,
                                            bool* zone) {
  if (p.has_cap) s = p.cap * tanhf(s / p.cap);
  *capped = s;
  *zone = p.delay > 0 && i - j >= p.delay;
  if (*zone) s += ls_j;
  if (p.causal && j > i) s = kNegInf;
  if (p.window > 0 && i - j >= p.window) s = kNegInf;
  if (j >= p.t) s = kNegInf;
  return s;
}

size_t fwd_smem(int dh) {
  return ((size_t)3 * kTile * (dh + 1) + kTile * kPStride + kTile) * sizeof(float);
}
size_t dq_smem(int dh) {
  return ((size_t)4 * kTile * (dh + 1) + kTile * kPStride + 3 * kTile) *
         sizeof(float);
}
size_t dkv_smem(int dh) {
  return ((size_t)4 * kTile * (dh + 1) + 2 * kTile * kPStride + 3 * kTile) *
         sizeof(float);
}

// ---------------------------------------------------------------------------
// forward: out, lse
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(Params p, const float* __restrict__ q,
                 const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ ls,
                 const int32_t* __restrict__ hr, float* __restrict__ out,
                 float* __restrict__ lse) {
  extern __shared__ float smem[];
  const int dh = p.dh, st = dh + 1;
  float* q_s = smem;
  float* k_s = q_s + kTile * st;
  float* v_s = k_s + kTile * st;
  float* p_s = v_s + kTile * st;
  float* ls_s = p_s + kTile * kPStride;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int g = p.hq / p.hkv;
  const int row = (h / p.hq) * p.hkv + (h % p.hq) / g;
  const int rows_q = min(kTile, p.tp - q0);
  const int32_t* hr_row = p.skip ? hr + (size_t)row * p.nk_ref : nullptr;

  load_tile(q_s, q + ((size_t)h * p.tp + q0) * dh, rows_q, dh);
  float m[4], l[4], acc[4][kAccCols];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < kAccCols; ++c) acc[a][c] = 0.f;
  }

  int lo, hi;
  k_range(p, q0, kTile, kTile, lo, hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * kTile;
    // uniform over the block
    if (!tile_live(p, q0, k0, kTile, kTile, hr_row)) continue;
    const int rows_k = min(kTile, p.tp - k0);
    __syncthreads();                                  // last tile's readers
    load_tile(k_s, k + ((size_t)row * p.tp + k0) * dh, rows_k, dh);
    load_tile(v_s, v + ((size_t)row * p.tp + k0) * dh, rows_k, dh);
    load_vec(ls_s, ls + (size_t)row * p.tp + k0, rows_k);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = q_s[(ty * 4 + a) * st + d];
#pragma unroll
      for (int b = 0; b < 4; ++b) kb[b] = k_s[(tx + 16 * b) * st + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int il = ty * 4 + a, i = q0 + il;
      float mx = kNegInf;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int jl = tx + 16 * b;
        float capped;
        bool zone;
        s[a][b] = mask_score(p, s[a][b] * p.scale, i, k0 + jl, ls_s[jl],
                             &capped, &zone);
        mx = fmaxf(mx, s[a][b]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[a], mx);
      const float corr = expf(m[a] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float pv = expf(s[a][b] - m_new);
        p_s[il * kPStride + tx + 16 * b] = pv;
        sum += pv;
      }
      sum = half_warp_sum(sum);
      l[a] = corr * l[a] + sum;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < kAccCols; ++c) acc[a][c] *= corr;
    }
    __syncthreads();

    for (int j = 0; j < kTile; ++j) {
      float vj[kAccCols];
#pragma unroll
      for (int c = 0; c < kAccCols; ++c) {
        const int d = tx + 16 * c;
        vj[c] = d < dh ? v_s[j * st + d] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float pa = p_s[(ty * 4 + a) * kPStride + j];
#pragma unroll
        for (int c = 0; c < kAccCols; ++c) acc[a][c] = fmaf(pa, vj[c], acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int il = ty * 4 + a;
    if (il >= rows_q) continue;
    const float l_safe = l[a] <= 0.f ? 1.f : l[a];
    const size_t r = (size_t)h * p.tp + q0 + il;
#pragma unroll
    for (int c = 0; c < kAccCols; ++c) {
      const int d = tx + 16 * c;
      if (d < dh) out[r * dh + d] = acc[a][c] / l_safe;
    }
    if (tx == 0) lse[r] = m[a] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// backward: dq
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(Params p, const float* __restrict__ q,
                const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ ls,
                const float* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta,
                const int32_t* __restrict__ hr, float* __restrict__ dq) {
  extern __shared__ float smem[];
  const int dh = p.dh, st = dh + 1;
  float* q_s = smem;
  float* do_s = q_s + kTile * st;
  float* k_s = do_s + kTile * st;
  float* v_s = k_s + kTile * st;
  float* ds_s = v_s + kTile * st;
  float* ls_s = ds_s + kTile * kPStride;
  float* lse_s = ls_s + kTile;
  float* delta_s = lse_s + kTile;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int g = p.hq / p.hkv;
  const int row = (h / p.hq) * p.hkv + (h % p.hq) / g;
  const int rows_q = min(kTile, p.tp - q0);
  const int32_t* hr_row = p.skip ? hr + (size_t)row * p.nk_ref : nullptr;
  const size_t qbase = (size_t)h * p.tp + q0;

  load_tile(q_s, q + qbase * dh, rows_q, dh);
  load_tile(do_s, dout + qbase * dh, rows_q, dh);
  load_vec(lse_s, lse + qbase, rows_q);
  load_vec(delta_s, delta + qbase, rows_q);
  float acc[4][kAccCols];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kAccCols; ++c) acc[a][c] = 0.f;

  int lo, hi;
  k_range(p, q0, kTile, kTile, lo, hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * kTile;
    if (!tile_live(p, q0, k0, kTile, kTile, hr_row)) continue;
    const int rows_k = min(kTile, p.tp - k0);
    __syncthreads();
    load_tile(k_s, k + ((size_t)row * p.tp + k0) * dh, rows_k, dh);
    load_tile(v_s, v + ((size_t)row * p.tp + k0) * dh, rows_k, dh);
    load_vec(ls_s, ls + (size_t)row * p.tp + k0, rows_k);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        qa[a] = q_s[(ty * 4 + a) * st + d];
        oa[a] = do_s[(ty * 4 + a) * st + d];
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        kb[b] = k_s[(tx + 16 * b) * st + d];
        vb[b] = v_s[(tx + 16 * b) * st + d];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
          dp[a][b] = fmaf(oa[a], vb[b], dp[a][b]);
        }
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int il = ty * 4 + a, i = q0 + il;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int jl = tx + 16 * b;
        float capped;
        bool zone;
        const float sm = mask_score(p, s[a][b] * p.scale, i, k0 + jl,
                                    ls_s[jl], &capped, &zone);
        const float pv = i < p.t ? expf(sm - lse_s[il]) : 0.f;
        float ds = pv * (dp[a][b] - delta_s[il]);
        if (p.has_cap) {
          const float r = capped / p.cap;
          ds *= 1.f - r * r;
        }
        ds_s[il * kPStride + jl] = ds;
      }
    }
    __syncthreads();

    for (int j = 0; j < kTile; ++j) {
      float kj[kAccCols];
#pragma unroll
      for (int c = 0; c < kAccCols; ++c) {
        const int d = tx + 16 * c;
        kj[c] = d < dh ? k_s[j * st + d] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float da = ds_s[(ty * 4 + a) * kPStride + j];
#pragma unroll
        for (int c = 0; c < kAccCols; ++c) acc[a][c] = fmaf(da, kj[c], acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int il = ty * 4 + a;
    if (il >= rows_q) continue;
#pragma unroll
    for (int c = 0; c < kAccCols; ++c) {
      const int d = tx + 16 * c;
      if (d < dh) dq[(qbase + il) * dh + d] = acc[a][c] * p.scale;
    }
  }
}

// ---------------------------------------------------------------------------
// backward: dk, dv, d(log_surv)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(Params p, const float* __restrict__ q,
                 const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ ls,
                 const float* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const int32_t* __restrict__ hr, float* __restrict__ dk,
                 float* __restrict__ dv, float* __restrict__ dls) {
  extern __shared__ float smem[];
  const int dh = p.dh, st = dh + 1;
  float* k_s = smem;
  float* v_s = k_s + kTile * st;
  float* q_s = v_s + kTile * st;
  float* do_s = q_s + kTile * st;
  float* p_s = do_s + kTile * st;
  float* ds_s = p_s + kTile * kPStride;
  float* ls_s = ds_s + kTile * kPStride;
  float* lse_s = ls_s + kTile;
  float* delta_s = lse_s + kTile;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int row = blockIdx.y, k0 = blockIdx.x * kTile;
  const int g = p.hq / p.hkv;
  const int qhead0 = (row / p.hkv) * p.hq + (row % p.hkv) * g;
  const int rows_k = min(kTile, p.tp - k0);
  const int32_t* hr_row = p.skip ? hr + (size_t)row * p.nk_ref : nullptr;
  const size_t kbase = (size_t)row * p.tp + k0;

  load_tile(k_s, k + kbase * dh, rows_k, dh);
  load_tile(v_s, v + kbase * dh, rows_k, dh);
  load_vec(ls_s, ls + kbase, rows_k);
  // dk, dv: rows j = ty*4 + a of the tile, cols d = tx + 16c;
  // dls: this thread's partial sums for keys tx + 16b
  float dk_acc[4][kAccCols], dv_acc[4][kAccCols], dls_part[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    dls_part[a] = 0.f;
#pragma unroll
    for (int c = 0; c < kAccCols; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;
  }

  int lo, hi;
  q_range(p, k0, kTile, kTile, lo, hi);
  for (int gi = 0; gi < g; ++gi) {
    const int h = qhead0 + gi;
    for (int qt = lo; qt <= hi; ++qt) {
      const int q0 = qt * kTile;
      if (!tile_live(p, q0, k0, kTile, kTile, hr_row)) continue;
      const int rows_q = min(kTile, p.tp - q0);
      const size_t qbase = (size_t)h * p.tp + q0;
      __syncthreads();
      load_tile(q_s, q + qbase * dh, rows_q, dh);
      load_tile(do_s, dout + qbase * dh, rows_q, dh);
      load_vec(lse_s, lse + qbase, rows_q);
      load_vec(delta_s, delta + qbase, rows_q);
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.f;
      for (int d = 0; d < dh; ++d) {
        float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          qa[a] = q_s[(ty * 4 + a) * st + d];
          oa[a] = do_s[(ty * 4 + a) * st + d];
        }
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          kb[b] = k_s[(tx + 16 * b) * st + d];
          vb[b] = v_s[(tx + 16 * b) * st + d];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
            dp[a][b] = fmaf(oa[a], vb[b], dp[a][b]);
          }
      }

#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int il = ty * 4 + a, i = q0 + il;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int jl = tx + 16 * b;
          float capped;
          bool zone;
          const float sm = mask_score(p, s[a][b] * p.scale, i, k0 + jl,
                                      ls_s[jl], &capped, &zone);
          const float pv = i < p.t ? expf(sm - lse_s[il]) : 0.f;
          float ds = pv * (dp[a][b] - delta_s[il]);
          if (zone) dls_part[b] += ds;         // before the softcap derivative
          if (p.has_cap) {
            const float r = capped / p.cap;
            ds *= 1.f - r * r;
          }
          p_s[il * kPStride + jl] = pv;
          ds_s[il * kPStride + jl] = ds;
        }
      }
      __syncthreads();

      for (int i = 0; i < kTile; ++i) {
        float qi[kAccCols], oi[kAccCols];
#pragma unroll
        for (int c = 0; c < kAccCols; ++c) {
          const int d = tx + 16 * c;
          qi[c] = d < dh ? q_s[i * st + d] : 0.f;
          oi[c] = d < dh ? do_s[i * st + d] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float pa = p_s[i * kPStride + ty * 4 + a];
          const float da = ds_s[i * kPStride + ty * 4 + a];
#pragma unroll
          for (int c = 0; c < kAccCols; ++c) {
            dv_acc[a][c] = fmaf(pa, oi[c], dv_acc[a][c]);
            dk_acc[a][c] = fmaf(da, qi[c], dk_acc[a][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int jl = ty * 4 + a;
    if (jl >= rows_k) continue;
#pragma unroll
    for (int c = 0; c < kAccCols; ++c) {
      const int d = tx + 16 * c;
      if (d < dh) {
        dk[(kbase + jl) * dh + d] = dk_acc[a][c] * p.scale;
        dv[(kbase + jl) * dh + d] = dv_acc[a][c];
      }
    }
  }
  // dls: sum the 16 row groups' partials for each key of the tile
  __syncthreads();
  float* red = p_s;                                   // (16, kTile)
#pragma unroll
  for (int b = 0; b < 4; ++b) red[ty * kTile + tx + 16 * b] = dls_part[b];
  __syncthreads();
  if (tid < rows_k) {
    float sum = 0.f;
    for (int r = 0; r < kThreads / 16; ++r) sum += red[r * kTile + tid];
    dls[kbase + tid] = sum;
  }
}

bool bad_params(const Params& p, int rows) {
  return rows < 0 || p.tp < 1 || p.dh < 1 || p.dh > kMaxDh || p.hkv < 1 ||
         p.hq < p.hkv || p.hq % p.hkv != 0 || p.t < 1 || p.t > p.tp ||
         p.block_k < 1 || p.nk_ref < 1 || (p.has_cap && p.cap <= 0.f);
}

// what the bf16 tensor-core kernels do not take
bool bad_tc(const Params& p) {
  return (p.dh != 64 && p.dh != 128) || p.tp % 8 != 0;
}

// Raise a kernel's dynamic shared-memory limit once, to what the largest
// head_dim needs, so that a launch inside CUDA-graph capture sets nothing.
template <auto Kernel>
cudaError_t allow_smem(size_t bytes) {
  static size_t allowed = 48u * 1024u;
  if (bytes <= allowed) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

Params make_params(int tp, int dh, int hq, int hkv, int t, int nk_ref,
                   int block_k, int window, int delay, int causal, int skip,
                   int has_cap, float cap, float scale) {
  Params p;
  p.tp = tp; p.dh = dh; p.hq = hq; p.hkv = hkv; p.t = t;
  p.nk_ref = nk_ref; p.block_k = block_k; p.window = window; p.delay = delay;
  p.causal = causal; p.skip = skip; p.has_cap = has_cap; p.cap = cap;
  p.scale = scale;
  return p;
}

cudaError_t launch_fwd(const Params& p, int bhq, const void* q, const void* k,
                       const void* v, const void* ls, const void* hr, void* out,
                       void* lse, cudaStream_t stream) {
  const size_t smem = fwd_smem(p.dh);
  cudaError_t e = allow_smem<flash_fwd_kernel>(fwd_smem(kMaxDh));
  if (e != cudaSuccess) return e;
  dim3 grid((p.tp + kTile - 1) / kTile, bhq);
  flash_fwd_kernel<<<grid, kThreads, smem, stream>>>(
      p, (const float*)q, (const float*)k, (const float*)v, (const float*)ls,
      (const int32_t*)hr, (float*)out, (float*)lse);
  return cudaGetLastError();
}

cudaError_t launch_dq(const Params& p, int bhq, const void* q, const void* k,
                      const void* v, const void* ls, const void* dout,
                      const void* lse, const void* delta, const void* hr,
                      void* dq, cudaStream_t stream) {
  const size_t smem = dq_smem(p.dh);
  cudaError_t e = allow_smem<flash_dq_kernel>(dq_smem(kMaxDh));
  if (e != cudaSuccess) return e;
  dim3 grid((p.tp + kTile - 1) / kTile, bhq);
  flash_dq_kernel<<<grid, kThreads, smem, stream>>>(
      p, (const float*)q, (const float*)k, (const float*)v, (const float*)ls,
      (const float*)dout, (const float*)lse, (const float*)delta,
      (const int32_t*)hr, (float*)dq);
  return cudaGetLastError();
}

cudaError_t launch_dkv(const Params& p, int bhkv, const void* q, const void* k,
                       const void* v, const void* ls, const void* dout,
                       const void* lse, const void* delta, const void* hr,
                       void* dk, void* dv, void* dls, cudaStream_t stream) {
  const size_t smem = dkv_smem(p.dh);
  cudaError_t e = allow_smem<flash_dkv_kernel>(dkv_smem(kMaxDh));
  if (e != cudaSuccess) return e;
  dim3 grid((p.tp + kTile - 1) / kTile, bhkv);
  flash_dkv_kernel<<<grid, kThreads, smem, stream>>>(
      p, (const float*)q, (const float*)k, (const float*)v, (const float*)ls,
      (const float*)dout, (const float*)lse, (const float*)delta,
      (const int32_t*)hr, (float*)dk, (float*)dv, (float*)dls);
  return cudaGetLastError();
}

// ===========================================================================
// bf16 route: tensor cores (wgmma), TMA ring, longest-first grids
// ===========================================================================

namespace tc {

constexpr int kBK = 64;             // keys per tile
constexpr int kFwdRows = 64;        // q rows of a forward block
constexpr int kDkvRows = 64;        // q rows of one dkv step
constexpr int kStages = 2;          // depth of the TMA ring
constexpr int kPanel = 64;          // bf16 columns of one 128-byte swizzle panel
constexpr int kWG = 128;            // threads of a warpgroup
constexpr int kThreads = kWG + 32;  // one consumer warpgroup, a producer warp
// clusters of at most this many dkv blocks: the fastest at G 4 and 6
// (PERF.md); larger clusters leave SMs of a GPC idle
constexpr int kMaxCluster = 4;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* ptr) {
  const uint32_t a = smem_u32(ptr);
  return ptr + ((1024u - (a & 1023u)) & 1023u);
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// -- TMA ---------------------------------------------------------------------

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the `rows` x Dh bf16 tile at row r0 of head `head`: Dh / 64 panels of
// rows x 128 bytes, one after the other, each loaded by one TMA box
template <int DH>
__device__ __forceinline__ void load_tile_tma(uint8_t* dst, const CUtensorMap* map,
                                              uint64_t* bar, int rows, int r0,
                                              int head) {
#pragma unroll
  for (int pn = 0; pn < DH / kPanel; ++pn)
    tma_load_3d(dst + pn * rows * 128, map, bar, pn * kPanel, r0, head);
}

// -- wgmma -------------------------------------------------------------------

// Shared-memory matrix descriptor of a tile in the 128-byte swizzle: start
// address, leading byte offset 16 (unused: every operand here spans one
// 64-column panel in its contiguous dimension), stride byte offset 1024 (8
// rows of 128 bytes), layout 128B.  A K-major operand steps through k by
// adding 32 bytes (16 bf16) to the start; an MN-major one by 16 rows.
__device__ __forceinline__ uint64_t sw128_desc(const uint8_t* ptr) {
  return (uint64_t)((smem_u32(ptr) & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma issue and wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define TC_ACC8(i)                                                          \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define TC_ACC32 TC_ACC8(0), TC_ACC8(8), TC_ACC8(16), TC_ACC8(24)
#define TC_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (64 x 64) (+)= A (64 x 16, K-major in smem) . B (64 x 16, K-major in
// smem)^T; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TC_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : TC_ACC32
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64) += A (64 x 16, bf16 pairs in registers) . B (16 x 64, MN-major
// in smem: the 64 columns contiguous)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TC_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TC_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef TC_ACC8
#undef TC_ACC32
#undef TC_D32

// Accumulator register x of an m64n64 product, in thread `lane` of warp `w`
// of its warpgroup, holds row acc_row(w, lane, x) and column acc_col(lane, x)
__device__ __forceinline__ int acc_row(int w, int lane, int x) {
  return 16 * w + lane / 4 + 8 * ((x >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int lane, int x) {
  return 8 * (x >> 2) + 2 * (lane & 3) + (x & 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);     // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// a 64 x 64 accumulator, rounded to bf16, as the A operands of the four
// k16 steps of a product over its columns: step kk takes columns
// [16kk, 16kk + 16), which this thread holds in registers 8kk .. 8kk + 7
__device__ __forceinline__ void acc_to_a(const float (&d)[32],
                                         uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// -- forward -----------------------------------------------------------------

// Shared memory of a forward block, in bytes from a 1024-aligned base:
// the Q tile, kStages K and V tiles, kStages ls vectors, the barriers.
template <int DH>
struct FwdSmem {
  static constexpr int kQBytes = kFwdRows * DH * 2;
  static constexpr int kKVBytes = kBK * DH * 2;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kLs = kV + kStages * kKVBytes;
  static constexpr int kBar = kLs + kStages * kBK * 4;
  static constexpr int kBytes = kBar + (2 * kStages + 1) * 8 + 1024;
};

// one warpgroup a block: two blocks on an SM
template <int DH>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_tc(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const __grid_constant__ CUtensorMap tm_ls, Params p,
             const int32_t* __restrict__ hr, __nv_bfloat16* __restrict__ out,
             float* __restrict__ lse) {
  using L = FwdSmem<DH>;
  constexpr int kPanels = DH / kPanel;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int nqt = (p.tp + kFwdRows - 1) / kFwdRows;
  const int q0 = (nqt - 1 - (int)blockIdx.y) * kFwdRows;   // longest first
  const int g = p.hq / p.hkv;
  const int row = (h / p.hq) * p.hkv + (h % p.hq) / g;
  const int32_t* hr_row = p.skip ? hr + (size_t)row * p.nk_ref : nullptr;
  int lo, hi;
  k_range(p, q0, kFwdRows, kBK, lo, hi);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWG);
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kWG) {                                   // the producer warp
    if (tid == kWG) {
      mbar_expect_tx(q_full, L::kQBytes);
      load_tile_tma<DH>(smem, &tm_q, q_full, kFwdRows, q0, h);
      int n = 0;
      for (int kt = lo; kt <= hi; ++kt) {
        const int k0 = kt * kBK;
        if (!tile_live(p, q0, k0, kFwdRows, kBK, hr_row)) continue;
        const int s = n % kStages;
        if (n >= kStages) mbar_wait(&empty[s], (n / kStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * L::kKVBytes + kBK * 4);
        load_tile_tma<DH>(smem + L::kK + s * L::kKVBytes, &tm_k, &full[s], kBK,
                          k0, row);
        load_tile_tma<DH>(smem + L::kV + s * L::kKVBytes, &tm_v, &full[s], kBK,
                          k0, row);
        tma_load_2d(smem + L::kLs + s * kBK * 4, &tm_ls, &full[s], k0, row);
        ++n;
      }
    }
    return;
  }

  // the consumer warpgroup: this thread owns rows r_top and r_top + 8
  const int w = tid / 32, lane = tid % 32;
  const int r_top = acc_row(w, lane, 0);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kPanels][32];
#pragma unroll
  for (int pn = 0; pn < kPanels; ++pn)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[pn][x] = 0.f;
  mbar_wait(q_full, 0);

  int n = 0;
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * kBK;
    if (!tile_live(p, q0, k0, kFwdRows, kBK, hr_row)) continue;
    const int s = n % kStages;
    mbar_wait(&full[s], (n / kStages) & 1);
    const uint8_t* k_s = smem + L::kK + s * L::kKVBytes;
    const uint8_t* v_s = smem + L::kV + s * L::kKVBytes;
    const float* ls_s = reinterpret_cast<const float*>(smem + L::kLs + s * kBK * 4);

    float sc[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss(sc,
               sw128_desc(smem + (kk / 4) * kFwdRows * 128 + (kk % 4) * 32),
               sw128_desc(k_s + (kk / 4) * kBK * 128 + (kk % 4) * 32), kk > 0);
    wg_commit();
    wg_wait_all();
    reg_fence(sc);

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int hh = (x >> 1) & 1, jl = acc_col(lane, x);
      float capped;
      bool zone;
      sc[x] = mask_score(p, sc[x] * p.scale, q0 + r_top + 8 * hh, k0 + jl,
                         ls_s[jl], &capped, &zone);
      mx[hh] = fmaxf(mx[hh], sc[x]);
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = quad_max(mx[hh]);
      corr[hh] = __expf(m[hh] - mx[hh]);
      m[hh] = mx[hh];
    }
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int hh = (x >> 1) & 1;
      sc[x] = __expf(sc[x] - m[hh]);
      sum[hh] += sc[x];
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = corr[hh] * l[hh] + sum[hh];
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn)
#pragma unroll
      for (int x = 0; x < 32; ++x) acc[pn][x] *= corr[(x >> 1) & 1];

    uint32_t pa[4][4];
    acc_to_a(sc, pa);
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) reg_fence(acc[pn]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int pn = 0; pn < kPanels; ++pn)
        wgmma_rs(acc[pn], pa[kk],
                 sw128_desc(v_s + pn * kBK * 128 + kk * 16 * 128));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) reg_fence(acc[pn]);
    mbar_arrive(&empty[s]);
    ++n;
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float lt = quad_sum(l[hh]);
    const float l_safe = lt <= 0.f ? 1.f : lt;
    const int r = q0 + r_top + 8 * hh;
    if (r >= p.tp) continue;
    const size_t base = ((size_t)h * p.tp + r) * DH;
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn)
#pragma unroll
      for (int x = 2 * hh; x < 32; x += 4) {
        const int c = pn * kPanel + acc_col(lane, x);
        *reinterpret_cast<__nv_bfloat162*>(out + base + c) =
            __floats2bfloat162_rn(acc[pn][x] / l_safe, acc[pn][x + 1] / l_safe);
      }
    if ((lane & 3) == 0) lse[(size_t)h * p.tp + r] = m[hh] + logf(l_safe);
  }
}

// -- dq ----------------------------------------------------------------------

// Shared memory of a dq block, in bytes from a 1024-aligned base: the Q and
// dO tiles, kStages K and V tiles, kStages ls vectors, the barriers.
template <int DH>
struct DqSmem {
  static constexpr int kQBytes = kFwdRows * DH * 2;
  static constexpr int kKVBytes = kBK * DH * 2;
  static constexpr int kDo = kQBytes;
  static constexpr int kK = kDo + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kLs = kV + kStages * kKVBytes;
  static constexpr int kBar = kLs + kStages * kBK * 4;
  static constexpr int kBytes = kBar + (2 * kStages + 1) * 8 + 1024;
};

// one warpgroup a block, as fwd: two blocks on an SM
template <int DH>
__global__ void __launch_bounds__(kThreads, 2)
flash_dq_tc(const __grid_constant__ CUtensorMap tm_q,
            const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v,
            const __grid_constant__ CUtensorMap tm_ls,
            const __grid_constant__ CUtensorMap tm_do, Params p,
            const int32_t* __restrict__ hr, const float* __restrict__ lse,
            const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq) {
  using L = DqSmem<DH>;
  constexpr int kPanels = DH / kPanel;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int nqt = (p.tp + kFwdRows - 1) / kFwdRows;
  const int q0 = (nqt - 1 - (int)blockIdx.y) * kFwdRows;   // longest first
  const int g = p.hq / p.hkv;
  const int row = (h / p.hq) * p.hkv + (h % p.hq) / g;
  const int32_t* hr_row = p.skip ? hr + (size_t)row * p.nk_ref : nullptr;
  int lo, hi;
  k_range(p, q0, kFwdRows, kBK, lo, hi);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWG);
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kWG) {                                   // the producer warp
    if (tid == kWG) {
      mbar_expect_tx(q_full, 2 * L::kQBytes);
      load_tile_tma<DH>(smem, &tm_q, q_full, kFwdRows, q0, h);
      load_tile_tma<DH>(smem + L::kDo, &tm_do, q_full, kFwdRows, q0, h);
      int n = 0;
      for (int kt = lo; kt <= hi; ++kt) {
        const int k0 = kt * kBK;
        if (!tile_live(p, q0, k0, kFwdRows, kBK, hr_row)) continue;
        const int s = n % kStages;
        if (n >= kStages) mbar_wait(&empty[s], (n / kStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * L::kKVBytes + kBK * 4);
        load_tile_tma<DH>(smem + L::kK + s * L::kKVBytes, &tm_k, &full[s], kBK,
                          k0, row);
        load_tile_tma<DH>(smem + L::kV + s * L::kKVBytes, &tm_v, &full[s], kBK,
                          k0, row);
        tma_load_2d(smem + L::kLs + s * kBK * 4, &tm_ls, &full[s], k0, row);
        ++n;
      }
    }
    return;
  }

  // the consumer warpgroup: this thread owns rows r_top and r_top + 8
  const int w = tid / 32, lane = tid % 32;
  const int r_top = acc_row(w, lane, 0);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = q0 + r_top + 8 * hh;
    const bool in = r < p.tp;
    lse_r[hh] = in ? lse[(size_t)h * p.tp + r] : 0.f;
    delta_r[hh] = in ? delta[(size_t)h * p.tp + r] : 0.f;
  }
  float acc[kPanels][32];
#pragma unroll
  for (int pn = 0; pn < kPanels; ++pn)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[pn][x] = 0.f;
  const uint8_t* do_s = smem + L::kDo;
  mbar_wait(q_full, 0);

  int n = 0;
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * kBK;
    if (!tile_live(p, q0, k0, kFwdRows, kBK, hr_row)) continue;
    const int s = n % kStages;
    mbar_wait(&full[s], (n / kStages) & 1);
    const uint8_t* k_s = smem + L::kK + s * L::kKVBytes;
    const uint8_t* v_s = smem + L::kV + s * L::kKVBytes;
    const float* ls_s = reinterpret_cast<const float*>(smem + L::kLs + s * kBK * 4);

    // S = Q.K^T and dP = dO.V^T, both operands K-major
    float sc[32], dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int qo = (kk / 4) * kFwdRows * 128 + (kk % 4) * 32;
      const int ko = (kk / 4) * kBK * 128 + (kk % 4) * 32;
      wgmma_ss(sc, sw128_desc(smem + qo), sw128_desc(k_s + ko), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int qo = (kk / 4) * kFwdRows * 128 + (kk % 4) * 32;
      const int ko = (kk / 4) * kBK * 128 + (kk % 4) * 32;
      wgmma_ss(dp, sw128_desc(do_s + qo), sw128_desc(v_s + ko), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    reg_fence(sc);
    reg_fence(dp);

    // dS = P o (dP - delta), P = exp(S - lse) (0 on padded rows), times the
    // softcap's derivative
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int hh = (x >> 1) & 1, i = q0 + r_top + 8 * hh, jl = acc_col(lane, x);
      float capped;
      bool zone;
      const float sm = mask_score(p, sc[x] * p.scale, i, k0 + jl, ls_s[jl],
                                  &capped, &zone);
      const float pv = i < p.t ? __expf(sm - lse_r[hh]) : 0.f;
      float ds = pv * (dp[x] - delta_r[hh]);
      if (p.has_cap) {
        const float r = capped / p.cap;
        ds *= 1.f - r * r;
      }
      sc[x] = ds;
    }

    // dq += dS.K: dS rounded to bf16 as the A operand, K the MN-major B
    uint32_t da[4][4];
    acc_to_a(sc, da);
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) reg_fence(acc[pn]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int pn = 0; pn < kPanels; ++pn)
        wgmma_rs(acc[pn], da[kk],
                 sw128_desc(k_s + pn * kBK * 128 + kk * 16 * 128));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) reg_fence(acc[pn]);
    mbar_arrive(&empty[s]);
    ++n;
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = q0 + r_top + 8 * hh;
    if (r >= p.tp) continue;
    const size_t base = ((size_t)h * p.tp + r) * DH;
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn)
#pragma unroll
      for (int x = 2 * hh; x < 32; x += 4) {
        const int c = pn * kPanel + acc_col(lane, x);
        *reinterpret_cast<__nv_bfloat162*>(dq + base + c) = __floats2bfloat162_rn(
            acc[pn][x] * p.scale, acc[pn][x + 1] * p.scale);
      }
  }
}

// -- dk, dv, d(log_surv) -----------------------------------------------------

// Shared memory of a dkv block, in bytes from a 1024-aligned base: K, V,
// kStages Q and dO tiles, ls, kStages lse and delta vectors, the fp32
// partials the cluster sums (dk, dv: 64 rows of kRedStride floats; dls),
// the barriers.
template <int DH>
struct DkvSmem {
  static constexpr int kTile = kBK * DH * 2;
  static constexpr int kK = 0;
  static constexpr int kV = kTile;
  static constexpr int kQ = 2 * kTile;
  static constexpr int kDo = kQ + kStages * kTile;
  static constexpr int kLs = kDo + kStages * kTile;
  static constexpr int kLse = kLs + kBK * 4;
  static constexpr int kDelta = kLse + kStages * kDkvRows * 4;
  static constexpr int kRedStride = DH + 8;       // floats; staggers the banks
  static constexpr int kRedDk = kDelta + kStages * kDkvRows * 4;
  static constexpr int kRedDv = kRedDk + kBK * kRedStride * 4;
  static constexpr int kRedDls = kRedDv + kBK * kRedStride * 4;
  static constexpr int kBar = kRedDls + kBK * 4;
  static constexpr int kBytes = kBar + (2 * kStages + 1) * 8 + 1024;
};

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_tc(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const __grid_constant__ CUtensorMap tm_ls,
             const __grid_constant__ CUtensorMap tm_do,
             const __grid_constant__ CUtensorMap tm_lse,
             const __grid_constant__ CUtensorMap tm_delta, Params p,
             const int32_t* __restrict__ hr, __nv_bfloat16* __restrict__ dk,
             __nv_bfloat16* __restrict__ dv, float* __restrict__ dls) {
  namespace cg = cooperative_groups;
  using L = DkvSmem<DH>;
  constexpr int kPanels = DH / kPanel;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;
  float* red = reinterpret_cast<float*>(smem + L::kRedDk);   // dk, dv, dls

  cg::cluster_group cluster = cg::this_cluster();
  const int c = gridDim.x, rank = blockIdx.x;       // the cluster spans x
  const int tid = threadIdx.x;
  const int row = blockIdx.y, k0 = blockIdx.z * kBK;  // key tile 0 first
  const int g = p.hq / p.hkv, per = g / c;
  const int qhead0 = (row / p.hkv) * p.hq + (row % p.hkv) * g + rank * per;
  const int32_t* hr_row = p.skip ? hr + (size_t)row * p.nk_ref : nullptr;
  int lo, hi;
  q_range(p, k0, kDkvRows, kBK, lo, hi);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWG);
    }
    mbar_init(kv_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kWG) {                                   // the producer warp
    if (tid == kWG) {
      mbar_expect_tx(kv_full, 2 * L::kTile + kBK * 4);
      load_tile_tma<DH>(smem + L::kK, &tm_k, kv_full, kBK, k0, row);
      load_tile_tma<DH>(smem + L::kV, &tm_v, kv_full, kBK, k0, row);
      tma_load_2d(smem + L::kLs, &tm_ls, kv_full, k0, row);
      int n = 0;
      for (int gi = 0; gi < per; ++gi) {
        for (int qt = lo; qt <= hi; ++qt) {
          const int q0 = qt * kDkvRows;
          if (!tile_live(p, q0, k0, kDkvRows, kBK, hr_row)) continue;
          const int s = n % kStages;
          if (n >= kStages) mbar_wait(&empty[s], (n / kStages - 1) & 1);
          mbar_expect_tx(&full[s], 2 * L::kTile + 2 * kDkvRows * 4);
          load_tile_tma<DH>(smem + L::kQ + s * L::kTile, &tm_q, &full[s],
                            kDkvRows, q0, qhead0 + gi);
          load_tile_tma<DH>(smem + L::kDo + s * L::kTile, &tm_do, &full[s],
                            kDkvRows, q0, qhead0 + gi);
          tma_load_2d(smem + L::kLse + s * kDkvRows * 4, &tm_lse, &full[s], q0,
                      qhead0 + gi);
          tma_load_2d(smem + L::kDelta + s * kDkvRows * 4, &tm_delta, &full[s],
                      q0, qhead0 + gi);
          ++n;
        }
      }
    }
    __syncwarp();
  } else {
    // the consumer warpgroup: S^T and dP^T have the tile's 64 keys as rows
    // and the step's 64 q rows as columns; this thread keys j and j + 8
    const int w = tid / 32, lane = tid % 32;
    const int j_top = acc_row(w, lane, 0);
    float dk_acc[kPanels][32], dv_acc[kPanels][32], dls_part[2] = {0.f, 0.f};
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn)
#pragma unroll
      for (int x = 0; x < 32; ++x) dk_acc[pn][x] = dv_acc[pn][x] = 0.f;
    mbar_wait(kv_full, 0);
    const uint8_t* k_s = smem + L::kK;
    const uint8_t* v_s = smem + L::kV;
    const float* ls_s = reinterpret_cast<const float*>(smem + L::kLs);
    const float ls_j[2] = {ls_s[j_top], ls_s[j_top + 8]};

    int n = 0;
    for (int gi = 0; gi < per; ++gi) {
      for (int qt = lo; qt <= hi; ++qt) {
        const int q0 = qt * kDkvRows;
        if (!tile_live(p, q0, k0, kDkvRows, kBK, hr_row)) continue;
        const int s = n % kStages;
        mbar_wait(&full[s], (n / kStages) & 1);
        const uint8_t* q_s = smem + L::kQ + s * L::kTile;
        const uint8_t* do_s = smem + L::kDo + s * L::kTile;
        const float* lse_s =
            reinterpret_cast<const float*>(smem + L::kLse + s * kDkvRows * 4);
        const float* delta_s =
            reinterpret_cast<const float*>(smem + L::kDelta + s * kDkvRows * 4);

        float st[32], dpt[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          const int off = (kk / 4) * kBK * 128 + (kk % 4) * 32;
          wgmma_ss(st, sw128_desc(k_s + off), sw128_desc(q_s + off), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          const int off = (kk / 4) * kBK * 128 + (kk % 4) * 32;
          wgmma_ss(dpt, sw128_desc(v_s + off), sw128_desc(do_s + off), kk > 0);
        }
        wg_commit();
        wg_wait_all();
        reg_fence(st);
        reg_fence(dpt);

#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int hh = (x >> 1) & 1, il = acc_col(lane, x), i = q0 + il;
          float capped;
          bool zone;
          const float sm = mask_score(p, st[x] * p.scale, i, k0 + j_top + 8 * hh,
                                      ls_j[hh], &capped, &zone);
          const float pv = i < p.t ? __expf(sm - lse_s[il]) : 0.f;
          float ds = pv * (dpt[x] - delta_s[il]);
          if (zone) dls_part[hh] += ds;           // before the softcap derivative
          if (p.has_cap) {
            const float r = capped / p.cap;
            ds *= 1.f - r * r;
          }
          st[x] = pv;
          dpt[x] = ds;
        }
        uint32_t pa[4][4], da[4][4];
        acc_to_a(st, pa);
        acc_to_a(dpt, da);
#pragma unroll
        for (int pn = 0; pn < kPanels; ++pn) {
          reg_fence(dk_acc[pn]);
          reg_fence(dv_acc[pn]);
        }
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int pn = 0; pn < kPanels; ++pn) {
            const int off = pn * kDkvRows * 128 + kk * 16 * 128;
            wgmma_rs(dv_acc[pn], pa[kk], sw128_desc(do_s + off));
            wgmma_rs(dk_acc[pn], da[kk], sw128_desc(q_s + off));
          }
        wg_commit();
        wg_wait_all();
#pragma unroll
        for (int pn = 0; pn < kPanels; ++pn) {
          reg_fence(dk_acc[pn]);
          reg_fence(dv_acc[pn]);
        }
        mbar_arrive(&empty[s]);
        ++n;
      }
    }

    // this block's partials into its shared memory
    float* red_dk = red;
    float* red_dv = red + kBK * L::kRedStride;
    float* red_dls = red + 2 * kBK * L::kRedStride;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int j = j_top + 8 * hh;
      const float d = quad_sum(dls_part[hh]);
      if ((lane & 3) == 0) red_dls[j] = d;
#pragma unroll
      for (int pn = 0; pn < kPanels; ++pn)
#pragma unroll
        for (int x = 2 * hh; x < 32; x += 4) {
          const int o = j * L::kRedStride + pn * kPanel + acc_col(lane, x);
          *reinterpret_cast<float2*>(red_dk + o) =
              make_float2(dk_acc[pn][x], dk_acc[pn][x + 1]);
          *reinterpret_cast<float2*>(red_dv + o) =
              make_float2(dv_acc[pn][x], dv_acc[pn][x + 1]);
        }
    }
  }

  // every block's partials are written; block `rank` sums rows [r0, r1) of
  // the tile over the cluster, rank 0 first, and writes them
  cluster.sync();
  const int r0 = rank * kBK / c, r1 = (rank + 1) * kBK / c;
  const int rows_k = min(kBK, p.tp - k0);
  const size_t kbase = (size_t)row * p.tp + k0;
  constexpr int kQuads = DH / 4;
  for (int e = tid; e < (r1 - r0) * kQuads; e += kThreads) {
    const int j = r0 + e / kQuads, c4 = 4 * (e % kQuads);
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int rk = 0; rk < c; ++rk) {
      const float* src = cluster.map_shared_rank(red, rk);
      const float4 a = *reinterpret_cast<const float4*>(src + j * L::kRedStride + c4);
      const float4 b = *reinterpret_cast<const float4*>(
          src + (kBK + j) * L::kRedStride + c4);
      sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
      sv.x += b.x; sv.y += b.y; sv.z += b.z; sv.w += b.w;
    }
    if (j < rows_k) {
      __nv_bfloat162* pk = reinterpret_cast<__nv_bfloat162*>(dk + (kbase + j) * DH + c4);
      __nv_bfloat162* pv = reinterpret_cast<__nv_bfloat162*>(dv + (kbase + j) * DH + c4);
      pk[0] = __floats2bfloat162_rn(sk.x * p.scale, sk.y * p.scale);
      pk[1] = __floats2bfloat162_rn(sk.z * p.scale, sk.w * p.scale);
      pv[0] = __floats2bfloat162_rn(sv.x, sv.y);
      pv[1] = __floats2bfloat162_rn(sv.z, sv.w);
    }
  }
  for (int j = r0 + tid; j < r1; j += kThreads) {
    float sum = 0.f;
    for (int rk = 0; rk < c; ++rk)
      sum += cluster.map_shared_rank(red, rk)[2 * kBK * L::kRedStride + j];
    if (j < rows_k) dls[kbase + j] = sum;
  }
  cluster.sync();                 // no block leaves while others read it
}

// -- host side ---------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// (heads, tp, dh) bf16, read in boxes of 64 columns x `rows` rows of one
// head, 128-byte swizzle; rows past tp read as zeros
bool tile_map(CUtensorMap* map, const void* base, int heads, int tp, int dh,
              int rows) {
  const EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)dh, (cuuint64_t)tp, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)dh * 2, (cuuint64_t)tp * dh * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kPanel, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// (heads, tp) fp32, read in boxes of 64 entries of one head
bool vec_map(CUtensorMap* map, const void* base, int heads, int tp) {
  const EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)tp, (cuuint64_t)heads};
  const cuuint64_t strides[1] = {(cuuint64_t)tp * 4};
  const cuuint32_t box[2] = {64, 1};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
cudaError_t launch_fwd(const Params& p, int bhq, const void* q, const void* k,
                       const void* v, const void* ls, const void* hr, void* out,
                       void* lse, cudaStream_t stream) {
  const int bhkv = bhq / p.hq * p.hkv;
  CUtensorMap mq, mk, mv, mls;
  if (!tile_map(&mq, q, bhq, p.tp, DH, kFwdRows) ||
      !tile_map(&mk, k, bhkv, p.tp, DH, kBK) ||
      !tile_map(&mv, v, bhkv, p.tp, DH, kBK) || !vec_map(&mls, ls, bhkv, p.tp))
    return cudaErrorInvalidValue;
  constexpr size_t smem = FwdSmem<DH>::kBytes;
  cudaError_t e = allow_smem<flash_fwd_tc<DH>>(smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(bhq, (p.tp + kFwdRows - 1) / kFwdRows);
  flash_fwd_tc<DH><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, mls, p, (const int32_t*)hr, (__nv_bfloat16*)out, (float*)lse);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dq(const Params& p, int bhq, const void* q, const void* k,
                      const void* v, const void* ls, const void* dout,
                      const void* lse, const void* delta, const void* hr,
                      void* dq, cudaStream_t stream) {
  const int bhkv = bhq / p.hq * p.hkv;
  CUtensorMap mq, mk, mv, mls, mdo;
  if (!tile_map(&mq, q, bhq, p.tp, DH, kFwdRows) ||
      !tile_map(&mk, k, bhkv, p.tp, DH, kBK) ||
      !tile_map(&mv, v, bhkv, p.tp, DH, kBK) || !vec_map(&mls, ls, bhkv, p.tp) ||
      !tile_map(&mdo, dout, bhq, p.tp, DH, kFwdRows))
    return cudaErrorInvalidValue;
  constexpr size_t smem = DqSmem<DH>::kBytes;
  cudaError_t e = allow_smem<flash_dq_tc<DH>>(smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(bhq, (p.tp + kFwdRows - 1) / kFwdRows);
  flash_dq_tc<DH><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, mls, mdo, p, (const int32_t*)hr, (const float*)lse,
      (const float*)delta, (__nv_bfloat16*)dq);
  return cudaGetLastError();
}

// a cluster of c blocks per (kv head, key tile), c the largest divisor of G
// of at most kMaxCluster
template <int DH>
cudaError_t launch_dkv(const Params& p, int bhkv, const void* q, const void* k,
                       const void* v, const void* ls, const void* dout,
                       const void* lse, const void* delta, const void* hr,
                       void* dk, void* dv, void* dls, cudaStream_t stream) {
  const int g = p.hq / p.hkv, bhq = bhkv / p.hkv * p.hq;
  int c = 1;
  for (int d = kMaxCluster; d > 1 && c == 1; --d)
    if (g % d == 0) c = d;
  CUtensorMap mq, mk, mv, mls, mdo, mlse, mdelta;
  if (!tile_map(&mq, q, bhq, p.tp, DH, kDkvRows) ||
      !tile_map(&mk, k, bhkv, p.tp, DH, kBK) ||
      !tile_map(&mv, v, bhkv, p.tp, DH, kBK) || !vec_map(&mls, ls, bhkv, p.tp) ||
      !tile_map(&mdo, dout, bhq, p.tp, DH, kDkvRows) ||
      !vec_map(&mlse, lse, bhq, p.tp) || !vec_map(&mdelta, delta, bhq, p.tp))
    return cudaErrorInvalidValue;
  constexpr size_t smem = DkvSmem<DH>::kBytes;
  cudaError_t e = allow_smem<flash_dkv_tc<DH>>(smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c, bhkv, (p.tp + kBK - 1) / kBK);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, flash_dkv_tc<DH>, mq, mk, mv, mls, mdo, mlse,
                         mdelta, p, (const int32_t*)hr, (__nv_bfloat16*)dk,
                         (__nv_bfloat16*)dv, (float*)dls);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace tc

}  // namespace

// `bf16`: 1 for bfloat16 q/k/v (and do, out, dq, dk, dv), 0 for float32.
// `window` < 0 means no local window.  In bf16 every entry point takes dh 64
// or 128 and tp a multiple of 8.
extern "C" int dms_flash_fwd(const void* q, const void* k, const void* v,
                             const void* ls, const void* hr, void* out,
                             void* lse, int bf16, int bhq, int tp, int dh,
                             int hq, int hkv, int t, int nk_ref, int block_k,
                             int window, int delay, int causal, int skip,
                             int has_cap, float cap, float scale,
                             void* stream) {
  const Params p = make_params(tp, dh, hq, hkv, t, nk_ref, block_k, window,
                               delay, causal, skip, has_cap, cap, scale);
  if (bad_params(p, bhq) || bhq % hq != 0 || (skip && !hr) ||
      (bf16 && bad_tc(p)))
    return (int)cudaErrorInvalidValue;
  if (bhq == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (!bf16)
    return (int)launch_fwd(p, bhq, q, k, v, ls, hr, out, lse, s);
  return (int)(dh == 64 ? tc::launch_fwd<64>(p, bhq, q, k, v, ls, hr, out,
                                               lse, s)
                        : tc::launch_fwd<128>(p, bhq, q, k, v, ls, hr, out,
                                              lse, s));
}

extern "C" int dms_flash_dq(const void* q, const void* k, const void* v,
                            const void* ls, const void* dout, const void* lse,
                            const void* delta, const void* hr, void* dq,
                            int bf16, int bhq, int tp, int dh, int hq, int hkv,
                            int t, int nk_ref, int block_k, int window,
                            int delay, int causal, int skip, int has_cap,
                            float cap, float scale, void* stream) {
  const Params p = make_params(tp, dh, hq, hkv, t, nk_ref, block_k, window,
                               delay, causal, skip, has_cap, cap, scale);
  if (bad_params(p, bhq) || bhq % hq != 0 || (skip && !hr) ||
      (bf16 && bad_tc(p)))
    return (int)cudaErrorInvalidValue;
  if (bhq == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (!bf16)
    return (int)launch_dq(p, bhq, q, k, v, ls, dout, lse, delta, hr, dq, s);
  return (int)(dh == 64 ? tc::launch_dq<64>(p, bhq, q, k, v, ls, dout, lse,
                                              delta, hr, dq, s)
                        : tc::launch_dq<128>(p, bhq, q, k, v, ls, dout, lse,
                                             delta, hr, dq, s));
}

extern "C" int dms_flash_dkv(const void* q, const void* k, const void* v,
                             const void* ls, const void* dout, const void* lse,
                             const void* delta, const void* hr, void* dk,
                             void* dv, void* dls, int bf16, int bhkv, int tp,
                             int dh, int hq, int hkv, int t, int nk_ref,
                             int block_k, int window, int delay, int causal,
                             int skip, int has_cap, float cap, float scale,
                             void* stream) {
  const Params p = make_params(tp, dh, hq, hkv, t, nk_ref, block_k, window,
                               delay, causal, skip, has_cap, cap, scale);
  if (bad_params(p, bhkv) || bhkv % hkv != 0 || (skip && !hr) ||
      (bf16 && bad_tc(p)))
    return (int)cudaErrorInvalidValue;
  if (bhkv == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (!bf16)
    return (int)launch_dkv(p, bhkv, q, k, v, ls, dout, lse, delta, hr, dk, dv,
                           dls, s);
  return (int)(dh == 64
                   ? tc::launch_dkv<64>(p, bhkv, q, k, v, ls, dout, lse, delta,
                                        hr, dk, dv, dls, s)
                   : tc::launch_dkv<128>(p, bhkv, q, k, v, ls, dout, lse, delta,
                                         hr, dk, dv, dls, s));
}
