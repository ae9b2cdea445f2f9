// Block-table flash-decode for Hopper (sm_90a): one decode token's GQA
// attention per (lane, kv head) over only the live blocks of a compacted
// DMS slot arena, in one of two layouts, optionally with its softmax weights.
//
// Replaces the Pallas TPU kernel `decode_fwd` in
// src/repro/kernels/dms_decode/dms_decode.py (body `_decode_kernel`) in its
// three modes; the first two are layouts, the third adds outputs to either:
//   * fixed-arena mode: K/V and `valid` are each row's own arena (BH, P, .),
//     and table entries are block ids into that arena;
//   * shared-pool mode (`shared_kv`, the TPU kernel's `DecodeConfig.
//     shared_kv=True`, its index maps at dms_decode.py:147-151): K/V are one
//     page arena (NPOOL * block_p, Dh) shared by every row of a paged cache,
//     table entries are page ids (the logical table translated through the
//     page map by the wrapper), and `valid` arrives gathered into table
//     order (BH, NB_tbl * block_p).  So K/V of entry i sit at
//     page * block_p, whatever the row, and its `valid` at
//     (row * NB_tbl + i) * block_p;
//   * weights-out mode (`weights_out`, the TPU kernel's `DecodeConfig.
//     weights_out=True`, dms_decode.py:53-55, :87-91, :98-100, :158-176), in
//     either layout: for each listed entry i < n[row] the kernel also writes
//     the block's probabilities relative to the running max, w_blk[row, i] =
//     exp(s - m_running) as (G, block_p) fp32 (0 on dead slots), and that
//     running max, m_blk[row, i] (G); after the loop the final statistics
//     m_out[row] and l_out[row] (G).  Entries i >= n are never written.  The
//     wrapper (ops.py) rescales each entry by exp(m_blk - m_out) / l_out,
//     sums the G heads and scatters to logical arena rows: the weights that
//     TOVA, H2O and Keyformer evict by.
//
// What bounds it: device-memory bytes.  A decode step does ~2*G*Dh flops per
// K/V slot it reads (G = 6 query heads per kv head on Qwen-R1), far below
// the ~295 flop/byte the H100 needs before its tensor cores are the limit.
// The bytes it must move are `ops.modeled_hbm_bytes`: sum(n) live blocks x
// block_p x Dh x (2 + 2) bytes of K/V, plus q, out, the table and `valid` —
// in shared-pool mode the same, plus the wrapper's gathered `valid` rows and
// translated table; in weights-out mode plus n x G x (block_p + 1) x 4 bytes
// of w_blk and m_blk and 2 x G x 4 bytes of m_out and l_out per row.
//
// What the design does about it (the same in both layouts; only the two
// addresses differ, so the same logical contents in the same table order
// give the same bits):
//   * the loop runs over `tbl[row, :n[row]]` only, so a block (or page)
//     that no listed entry names is never read: traffic scales with live
//     tokens, not with the arena's or the pool's capacity (the property the
//     TPU kernel got from its clamped index maps);
//   * the G query heads of a group share each K/V block: a block is staged
//     once in shared memory (16-byte vector loads) and read by all G rows;
//   * the next block's K/V is loaded into registers while the current one is
//     computed (when a block fits in two 16-byte vectors per thread, as on
//     the main path), so a block's load latency overlaps the previous
//     block's math;
//   * each score is one thread's dot product over Dh from shared memory (K
//     rows padded by 16 bytes, so the threads of a warp hit distinct banks);
//     scores, the online softmax and the PV accumulator stay on chip in
//     fp32, and only the bf16 output row goes back;
//   * weights-out mode stores the probabilities the block already holds in
//     shared memory for its PV product (coalesced fp32 rows), so it reads no
//     byte more than the plain mode.
// Not done here (first performance items, see PERF.md and ROADMAP E2): a
// split of the table across several thread blocks with an LSE combine
// (Qwen-R1 has Hkv = 2, so B*Hkv blocks cannot fill 132 SMs), cp.async/TMA
// pipelines, wgmma; in weights-out mode, the wrapper's rescale, group sum
// and scatter fused into the epilogue (ROADMAP E4).
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;
constexpr int kMaxDh = 256;
constexpr int kMaxBlockP = 128;
constexpr int kAccPerThread = kMaxG * kMaxDh / kThreads;
constexpr int kPrefetch = 2;    // 16-byte vectors of K (and of V) per thread
constexpr int kPad = 8;         // bf16 elements of padding per K row in smem
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float dot8(const float* q, uint4 raw) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float4 qa = *reinterpret_cast<const float4*>(q);
  const float4 qb = *reinterpret_cast<const float4*>(q + 4);
  const float2 k0 = __bfloat1622float2(h[0]);
  const float2 k1 = __bfloat1622float2(h[1]);
  const float2 k2 = __bfloat1622float2(h[2]);
  const float2 k3 = __bfloat1622float2(h[3]);
  return qa.x * k0.x + qa.y * k0.y + qa.z * k1.x + qa.w * k1.y +
         qb.x * k2.x + qb.y * k2.y + qb.z * k3.x + qb.w * k3.y;
}

size_t smem_bytes(int g, int dh, int block_p) {
  return (size_t)block_p * (dh + kPad) * sizeof(__nv_bfloat16)   // K block
         + (size_t)block_p * dh * sizeof(__nv_bfloat16)            // V block
         + (size_t)(g * dh + g * block_p + 3 * g) * sizeof(float)
         + (size_t)block_p;                                        // live flags
}

// Grid: one thread block per (lane, kv head) row.
__global__ void __launch_bounds__(kThreads)
dms_decode_kernel(const __nv_bfloat16* __restrict__ q,     // (BH, G, Dh)
                  const __nv_bfloat16* __restrict__ k,     // (BH, P, Dh)
                  const __nv_bfloat16* __restrict__ v,     // (BH, P, Dh)
                  const uint8_t* __restrict__ valid,       // (BH, P)
                  const int32_t* __restrict__ tbl,         // (BH, NB_tbl)
                  const int32_t* __restrict__ n,           // (BH,)
                  __nv_bfloat16* __restrict__ out,         // (BH, G, Dh)
                  float* __restrict__ w_blk,     // (BH, NB_tbl, G, bp) or null
                  float* __restrict__ m_blk,     // (BH, NB_tbl, G)
                  float* __restrict__ m_out,     // (BH, G)
                  float* __restrict__ l_out,     // (BH, G)
                  int g, int dh, int p, int nb_tbl, int block_p,
                  float scale, int has_cap, float cap, int shared_kv) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kstride = dh + kPad;
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_s = k_s + block_p * kstride;
  float* q_s = reinterpret_cast<float*>(v_s + block_p * dh);
  float* s_s = q_s + g * dh;          // scores, then probabilities (G, block_p)
  float* m_s = s_s + g * block_p;     // running max (G)
  float* l_s = m_s + g;               // running denominator (G)
  float* c_s = l_s + g;               // this block's rescale factor (G)
  uint8_t* live_s = reinterpret_cast<uint8_t*>(c_s + g);

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gd = g * dh;
  const int vpr = dh / 8;              // 16-byte vectors per K/V row
  const int vecs = block_p * vpr;      // ... per K (or V) block
  const bool in_regs = vecs <= kPrefetch * kThreads;

  const __nv_bfloat16* q_row = q + (size_t)row * gd;
  for (int e = tid; e < gd; e += kThreads) q_s[e] = __bfloat162float(q_row[e]);
  if (tid < g) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kAccPerThread];
#pragma unroll
  for (int j = 0; j < kAccPerThread; ++j) acc[j] = 0.f;

  const int nblk = p / block_p;        // blocks of a row's arena, or pages
  const int count = min(max(n[row], 0), nb_tbl);
  const int32_t* tbl_row = tbl + (size_t)row * nb_tbl;
  // first slot of table entry i: in K/V, and in `valid`
  auto kv_slot0 = [&](int i) {
    const size_t blk = (size_t)min(max(tbl_row[i], 0), nblk - 1);
    return shared_kv ? blk * block_p : (size_t)row * p + blk * block_p;
  };
  auto valid_slot0 = [&](int i) {
    return shared_kv ? ((size_t)row * nb_tbl + i) * block_p : kv_slot0(i);
  };

  // register staging for the next block (used when `in_regs`)
  uint4 kr[kPrefetch], vr[kPrefetch];
  uint8_t lr = 0;
  auto fetch = [&](int i) {
    const size_t slot0 = kv_slot0(i);
    const uint4* k_src = reinterpret_cast<const uint4*>(k + slot0 * dh);
    const uint4* v_src = reinterpret_cast<const uint4*>(v + slot0 * dh);
#pragma unroll
    for (int r = 0; r < kPrefetch; ++r) {
      const int e = tid + r * kThreads;
      if (e < vecs) {
        kr[r] = k_src[e];
        vr[r] = v_src[e];
      }
    }
    if (tid < block_p) lr = valid[valid_slot0(i) + tid] != 0;
  };
  auto stash = [&]() {
#pragma unroll
    for (int r = 0; r < kPrefetch; ++r) {
      const int e = tid + r * kThreads;
      if (e < vecs) {
        const int j = e / vpr;
        const int c = e - j * vpr;
        *reinterpret_cast<uint4*>(k_s + j * kstride + c * 8) = kr[r];
        reinterpret_cast<uint4*>(v_s)[e] = vr[r];
      }
    }
    if (tid < block_p) live_s[tid] = lr;
  };
  auto load_direct = [&](int i) {
    const size_t slot0 = kv_slot0(i);
    const uint4* k_src = reinterpret_cast<const uint4*>(k + slot0 * dh);
    const uint4* v_src = reinterpret_cast<const uint4*>(v + slot0 * dh);
    for (int e = tid; e < vecs; e += kThreads) {
      const int j = e / vpr;
      const int c = e - j * vpr;
      *reinterpret_cast<uint4*>(k_s + j * kstride + c * 8) = k_src[e];
      reinterpret_cast<uint4*>(v_s)[e] = v_src[e];
    }
    if (tid < block_p) live_s[tid] = valid[valid_slot0(i) + tid] != 0;
  };

  if (in_regs && count > 0) fetch(0);
  __syncthreads();

  for (int i = 0; i < count; ++i) {
    if (in_regs) {
      stash();
    } else {
      load_direct(i);
    }
    __syncthreads();
    if (in_regs && i + 1 < count) fetch(i + 1);   // in flight during the math

    // scores: one thread per (g, slot) pair
    for (int pair = tid; pair < g * block_p; pair += kThreads) {
      const int gi = pair / block_p;
      const int j = pair - gi * block_p;
      const float* qg = q_s + gi * dh;
      const __nv_bfloat16* kj = k_s + j * kstride;
      float s = 0.f;
      for (int d = 0; d < dh; d += 8)
        s += dot8(qg + d, *reinterpret_cast<const uint4*>(kj + d));
      s *= scale;
      if (has_cap) s = cap * tanhf(s / cap);
      s_s[pair] = live_s[j] ? s : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per query head of the group
    for (int gi = warp; gi < g; gi += kWarps) {
      float* sg = s_s + gi * block_p;
      float bmax = kNegInf;
      for (int j = lane; j < block_p; j += 32) bmax = fmaxf(bmax, sg[j]);
      bmax = warp_max(bmax);
      const float m_prev = m_s[gi];
      const float m_new = fmaxf(m_prev, bmax);
      float sum = 0.f;
      for (int j = lane; j < block_p; j += 32) {
        const float pj = live_s[j] ? expf(sg[j] - m_new) : 0.f;
        sg[j] = pj;
        sum += pj;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[gi] = corr * l_s[gi] + sum;
        m_s[gi] = m_new;
        c_s[gi] = corr;
      }
    }
    __syncthreads();

    if (w_blk != nullptr) {
      // weights-out: this entry's probabilities (dead slots already 0) and
      // the running max they are relative to
      const size_t entry = (size_t)row * nb_tbl + i;
      float* w_row = w_blk + entry * g * block_p;
      for (int e = tid; e < g * block_p; e += kThreads) w_row[e] = s_s[e];
      if (tid < g) m_blk[entry * g + tid] = m_s[tid];
    }

    // PV: each thread owns fixed (g, d) accumulator elements
#pragma unroll
    for (int jj = 0; jj < kAccPerThread; ++jj) {
      const int e = tid + jj * kThreads;
      if (e < gd) {
        const int gi = e / dh;
        const int d = e - gi * dh;
        const float* pg = s_s + gi * block_p;
        float a = acc[jj] * c_s[gi];
        for (int j = 0; j < block_p; ++j)
          a += pg[j] * __bfloat162float(v_s[j * dh + d]);
        acc[jj] = a;
      }
    }
    __syncthreads();
  }

  if (m_out != nullptr && tid < g) {
    m_out[(size_t)row * g + tid] = m_s[tid];
    l_out[(size_t)row * g + tid] = l_s[tid];
  }
  __nv_bfloat16* o_row = out + (size_t)row * gd;
#pragma unroll
  for (int jj = 0; jj < kAccPerThread; ++jj) {
    const int e = tid + jj * kThreads;
    if (e < gd) {
      const float l = l_s[e / dh];
      o_row[e] = __float2bfloat16(acc[jj] / (l > 0.f ? l : 1.f));
    }
  }
}

}  // namespace

extern "C" int dms_decode_fwd(const void* q, const void* k, const void* v,
                              const void* valid, const void* tbl,
                              const void* n, void* out, void* w_blk,
                              void* m_blk, void* m_out, void* l_out, int bh,
                              int g, int dh, int p, int nb_tbl, int block_p,
                              float scale, int has_cap, float cap,
                              int shared_kv, void* stream) {
  if (bh < 0 || g < 1 || g > kMaxG || dh < 8 || dh > kMaxDh || dh % 8 != 0 ||
      block_p < 1 || block_p > kMaxBlockP || p < block_p || p % block_p != 0 ||
      nb_tbl < 0)
    return (int)cudaErrorInvalidValue;
  // weights-out takes all four outputs or none
  const int nw = (w_blk != nullptr) + (m_blk != nullptr) + (m_out != nullptr) +
                 (l_out != nullptr);
  if (nw != 0 && nw != 4) return (int)cudaErrorInvalidValue;
  if (bh == 0) return (int)cudaSuccess;
  const size_t smem = smem_bytes(g, dh, block_p);
  if (smem > 48u * 1024u) {
    cudaError_t e = cudaFuncSetAttribute(
        dms_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dms_decode_kernel<<<bh, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const uint8_t*)valid, (const int32_t*)tbl, (const int32_t*)n,
      (__nv_bfloat16*)out, (float*)w_blk, (float*)m_blk, (float*)m_out,
      (float*)l_out, g, dh, p, nb_tbl, block_p, scale, has_cap, cap, shared_kv);
  return (int)cudaGetLastError();
}
