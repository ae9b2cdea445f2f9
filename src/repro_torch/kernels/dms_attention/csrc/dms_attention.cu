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
// ~500 flop per byte, above the H100's ~295 flop/byte ridge.  This first
// version runs those operations on the fp32 CUDA cores (67 TFLOP/s peak),
// not the tensor cores (989 TFLOP/s bf16): each thread owns a 4 x 4 block of
// a 64 x 64 score tile and a 4 x 8 block of the 64 x Dh accumulator, both
// fed from fp32 tiles in shared memory whose rows are padded by one word so
// that the threads of a warp hit distinct banks.  wgmma, TMA pipelines and a
// split of dkv's short grid are later work (PERF.md, ROADMAP E3).
//
// What the design does about the TPU's sequential grid:
//   * fwd and dq: one thread block per (q head, 64-row q tile) loops over
//     the k tiles; the online-softmax state (fwd) or the dq sum (dq) stays in
//     registers across the loop;
//   * dkv: one thread block per (kv head, 64-key tile) loops over the G query
//     heads of its group and every q tile, so dk, dv and dls are each
//     written once, with no atomics;
//   * the loops visit only live tiles: with `causal` a q tile's loop stops at
//     the diagonal tile and dkv's loop starts there; a tile outside the local
//     window, or (with `skip`) inside the eviction zone for every query of
//     the tile with no retained key in the reference blocks it overlaps
//     (`_block_live`), is neither loaded nor computed.  A skipped tile's
//     scores are all -1e30 or carry log_surv = -1e30, so it adds exactly zero.
//
// Plain C interface, loaded with ctypes; each entry point launches on the
// caller's stream and returns cudaGetLastError().

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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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
template <typename T>
__device__ void load_tile(float* dst, const T* __restrict__ src, int rows,
                          int dh) {
  const int st = dh + 1;
  for (int e = threadIdx.x; e < kTile * dh; e += kThreads) {
    const int r = e / dh;
    const int c = e - r * dh;
    dst[r * st + c] = r < rows ? to_f(src[(size_t)r * dh + c]) : 0.f;
  }
}

__device__ void load_vec(float* dst, const float* __restrict__ src, int n) {
  for (int e = threadIdx.x; e < kTile; e += kThreads)
    dst[e] = e < n ? src[e] : 0.f;
}

// `_block_live` for the tile of q rows [q0, q0 + 64) and keys [k0, k0 + 64)
__device__ bool tile_live(const Params& p, int q0, int k0,
                          const int32_t* __restrict__ hr_row) {
  const int q_end = min(q0 + kTile, p.tp) - 1;
  const int k_end = min(k0 + kTile, p.tp) - 1;
  if (p.causal && k0 > q_end) return false;
  if (p.window > 0 && k_end < q0 - p.window + 1) return false;
  if (p.skip && p.delay > 0 && q0 - k_end >= p.delay) {
    for (int kb = k0 / p.block_k; kb <= k_end / p.block_k && kb < p.nk_ref; ++kb)
      if (hr_row[kb] > 0) return true;
    return false;
  }
  return true;
}

// the k tiles a q tile visits: from the window's first to the diagonal
__device__ void k_range(const Params& p, int q0, int& lo, int& hi) {
  const int nkt = (p.tp + kTile - 1) / kTile;
  const int q_end = min(q0 + kTile, p.tp) - 1;
  hi = p.causal ? min(nkt - 1, q_end / kTile) : nkt - 1;
  lo = p.window > 0 ? max(0, q0 - p.window + 1) / kTile : 0;
}

// the q tiles a k tile is visited by: from the diagonal to the window's last
__device__ void q_range(const Params& p, int k0, int& lo, int& hi) {
  const int nqt = (p.tp + kTile - 1) / kTile;
  const int k_end = min(k0 + kTile, p.tp) - 1;
  lo = p.causal ? k0 / kTile : 0;
  hi = p.window > 0 ? min(nqt - 1, (k_end + p.window - 1) / kTile) : nqt - 1;
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(Params p, const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ ls,
                 const int32_t* __restrict__ hr, T* __restrict__ out,
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
  k_range(p, q0, lo, hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * kTile;
    if (!tile_live(p, q0, k0, hr_row)) continue;     // uniform over the block
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
      if (d < dh) out[r * dh + d] = from_f<T>(acc[a][c] / l_safe);
    }
    if (tx == 0) lse[r] = m[a] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// backward: dq
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(Params p, const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ ls,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta,
                const int32_t* __restrict__ hr, T* __restrict__ dq) {
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
  k_range(p, q0, lo, hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * kTile;
    if (!tile_live(p, q0, k0, hr_row)) continue;
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
      if (d < dh) dq[(qbase + il) * dh + d] = from_f<T>(acc[a][c] * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// backward: dk, dv, d(log_surv)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(Params p, const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ ls,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const int32_t* __restrict__ hr, T* __restrict__ dk,
                 T* __restrict__ dv, float* __restrict__ dls) {
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
  q_range(p, k0, lo, hi);
  for (int gi = 0; gi < g; ++gi) {
    const int h = qhead0 + gi;
    for (int qt = lo; qt <= hi; ++qt) {
      const int q0 = qt * kTile;
      if (!tile_live(p, q0, k0, hr_row)) continue;
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
        dk[(kbase + jl) * dh + d] = from_f<T>(dk_acc[a][c] * p.scale);
        dv[(kbase + jl) * dh + d] = from_f<T>(dv_acc[a][c]);
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

// Raise a kernel's dynamic shared-memory limit once, to what the largest
// head_dim needs, so that a launch inside CUDA-graph capture sets nothing.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  static size_t allowed = 48u * 1024u;
  if (bytes <= allowed) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
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

template <typename T>
cudaError_t launch_fwd(const Params& p, int bhq, const void* q, const void* k,
                       const void* v, const void* ls, const void* hr, void* out,
                       void* lse, cudaStream_t stream) {
  const size_t smem = fwd_smem(p.dh);
  cudaError_t e = allow_smem(flash_fwd_kernel<T>, fwd_smem(kMaxDh));
  if (e != cudaSuccess) return e;
  dim3 grid((p.tp + kTile - 1) / kTile, bhq);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      p, (const T*)q, (const T*)k, (const T*)v, (const float*)ls,
      (const int32_t*)hr, (T*)out, (float*)lse);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq(const Params& p, int bhq, const void* q, const void* k,
                      const void* v, const void* ls, const void* dout,
                      const void* lse, const void* delta, const void* hr,
                      void* dq, cudaStream_t stream) {
  const size_t smem = dq_smem(p.dh);
  cudaError_t e = allow_smem(flash_dq_kernel<T>, dq_smem(kMaxDh));
  if (e != cudaSuccess) return e;
  dim3 grid((p.tp + kTile - 1) / kTile, bhq);
  flash_dq_kernel<T><<<grid, kThreads, smem, stream>>>(
      p, (const T*)q, (const T*)k, (const T*)v, (const float*)ls,
      (const T*)dout, (const float*)lse, (const float*)delta,
      (const int32_t*)hr, (T*)dq);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const Params& p, int bhkv, const void* q, const void* k,
                       const void* v, const void* ls, const void* dout,
                       const void* lse, const void* delta, const void* hr,
                       void* dk, void* dv, void* dls, cudaStream_t stream) {
  const size_t smem = dkv_smem(p.dh);
  cudaError_t e = allow_smem(flash_dkv_kernel<T>, dkv_smem(kMaxDh));
  if (e != cudaSuccess) return e;
  dim3 grid((p.tp + kTile - 1) / kTile, bhkv);
  flash_dkv_kernel<T><<<grid, kThreads, smem, stream>>>(
      p, (const T*)q, (const T*)k, (const T*)v, (const float*)ls,
      (const T*)dout, (const float*)lse, (const float*)delta,
      (const int32_t*)hr, (T*)dk, (T*)dv, (float*)dls);
  return cudaGetLastError();
}

}  // namespace

// `bf16`: 1 for bfloat16 q/k/v (and do, out, dq, dk, dv), 0 for float32.
// `window` < 0 means no local window.

extern "C" int dms_flash_fwd(const void* q, const void* k, const void* v,
                             const void* ls, const void* hr, void* out,
                             void* lse, int bf16, int bhq, int tp, int dh,
                             int hq, int hkv, int t, int nk_ref, int block_k,
                             int window, int delay, int causal, int skip,
                             int has_cap, float cap, float scale, void* stream) {
  const Params p = make_params(tp, dh, hq, hkv, t, nk_ref, block_k, window,
                               delay, causal, skip, has_cap, cap, scale);
  if (bad_params(p, bhq) || bhq % hq != 0 || (skip && !hr))
    return (int)cudaErrorInvalidValue;
  if (bhq == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(bf16 ? launch_fwd<__nv_bfloat16>(p, bhq, q, k, v, ls, hr, out, lse, s)
                    : launch_fwd<float>(p, bhq, q, k, v, ls, hr, out, lse, s));
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
  if (bad_params(p, bhq) || bhq % hq != 0 || (skip && !hr))
    return (int)cudaErrorInvalidValue;
  if (bhq == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(bf16 ? launch_dq<__nv_bfloat16>(p, bhq, q, k, v, ls, dout, lse,
                                               delta, hr, dq, s)
                    : launch_dq<float>(p, bhq, q, k, v, ls, dout, lse, delta,
                                       hr, dq, s));
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
  if (bad_params(p, bhkv) || bhkv % hkv != 0 || (skip && !hr))
    return (int)cudaErrorInvalidValue;
  if (bhkv == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(bf16 ? launch_dkv<__nv_bfloat16>(p, bhkv, q, k, v, ls, dout, lse,
                                                delta, hr, dk, dv, dls, s)
                    : launch_dkv<float>(p, bhkv, q, k, v, ls, dout, lse, delta,
                                        hr, dk, dv, dls, s));
}
