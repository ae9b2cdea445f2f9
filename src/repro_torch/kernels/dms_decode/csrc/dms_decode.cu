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
//     the block's probabilities relative to the running max in table order,
//     w_blk[row, i] = exp(s - m_running) as (G, block_p) fp32 (0 on dead
//     slots), and that running max, m_blk[row, i] (G); after the loop the
//     final statistics m_out[row] and l_out[row] (G).  Entries i >= n are
//     never written.  The wrapper (ops.py) rescales each entry by
//     exp(m_blk - m_out) / l_out, sums the G heads and scatters to logical
//     arena rows: the weights that TOVA, H2O and Keyformer evict by.
//
// What bounds it: device-memory bytes, in principle.  A decode step does
// ~2*G*Dh flops per K/V slot it reads (G = 6 query heads per kv head on
// Qwen-R1), far below the ~295 flop/byte the H100 needs before its tensor
// cores are the limit.  The bytes it must move are `ops.modeled_hbm_bytes`:
// sum(n) live blocks x block_p x Dh x (2 + 2) bytes of K/V, plus q, out, the
// table and `valid` (in weights-out mode plus n x G x (block_p + 1) x 4
// bytes of w_blk and m_blk and 2 x G x 4 bytes of m_out and l_out per row).
// At the serving shape that is ~1.5 MB, under half a microsecond of the
// card's bandwidth, so in practice the limit is latency: a row's table is
// a chain of dependent loads (n, then the table, then K/V), and B*Hkv rows
// (8 on the main path) cannot fill 132 SMs.
//
// What the design does about it:
//   * the table is split across SMs: a row's listed entries [0, n) are cut
//     into S contiguous ranges, [s*n/S, (s+1)*n/S) for split s, and the S
//     splits of a row form one thread-block cluster (grid B*Hkv*S).  S is
//     min(kCluster, NB_tbl), from the table's capacity on the host (never
//     from n, which lives on the device: the step stays free of host
//     syncs); the ranges follow n on the device, so the live entries are
//     spread evenly whatever the capacity.  A split whose range is empty
//     contributes m = -1e30, l = 0;
//   * the splits are combined inside the cluster, with no atomics, no
//     workspace and no second launch: each split leaves its running max m,
//     denominator l (G) and fp32 accumulator (G x Dh) in its shared memory;
//     after a cluster barrier every split reads all of them through
//     distributed shared memory in rank order (m = max m_s, l = sum l_s
//     e^(m_s - m), acc = sum acc_s e^(m_s - m)) and writes its 1/S slice of
//     the bf16 output row, so a launch gives the same bits every time;
//   * inside a split, K/V of up to kChunkSlots slots (four 16-slot blocks
//     on the main path) are staged at once by cp.async into a two-stage
//     shared-memory ring: chunk c+1 is in flight while chunk c is scored,
//     and the online softmax updates once per chunk, not once per block;
//   * only entries < n are read, so a block (or page) that no listed entry
//     names is never fetched, and the bytes fetched are
//     `ops.modeled_hbm_bytes`; the G query heads of a group share each
//     staged K/V block;
//   * each score is one thread's dot product over Dh from shared memory (K
//     rows padded by 16 bytes, so the threads of a warp hit distinct banks);
//     scores, the online softmax and the PV accumulator stay on chip in
//     fp32, and only the bf16 output row goes back;
//   * weights-out mode keeps the reference's raw contract exactly: a split
//     writes each entry's probabilities against its own running max m~_i,
//     from the scores it already holds in shared memory; after the combine
//     it knows M_<s, the largest split max of the ranks before it, and
//     rewrites the entries whose m~_i is below it: m_blk[i] = M_<s, w_blk[i]
//     *= exp(m~_i - M_<s).  m_out and l_out are the combined statistics.
// The two layouts differ only in two addresses (kv_slot0, valid_at):
// the split ranges depend on NB_tbl and n alone, and every sum runs in the
// same order, so the same logical contents in the same table order give
// the same bits in either layout.
//
// Not done here (see PERF.md and ROADMAP B1): in weights-out mode, the
// wrapper's rescale, group sum and scatter fused into the epilogue.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;
constexpr int kMaxDh = 256;
constexpr int kMaxBlockP = 128;
constexpr int kAccPerThread = kMaxG * kMaxDh / kThreads;
constexpr int kQVecs = kMaxG * kMaxDh / 8 / kThreads;   // of q, per thread
constexpr int kPad = 8;          // bf16 elements of padding per K row in smem
constexpr float kNegInf = -1e30f;
// splits of a row's table, one thread-block cluster per row: chosen by
// measurement (PERF.md); above 8 a cluster needs the non-portable size
constexpr int kCluster = 8;
// K/V slots a split stages per pipeline step (at least one whole block)
constexpr int kChunkSlots = 64;
constexpr size_t kMaxSmem = 227u * 1024u;

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

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most `pending` of this thread's cp.async groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending > 0)
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__host__ __device__ __forceinline__ size_t round16(size_t x) {
  return (x + 15) / 16 * 16;
}

// Shared-memory layout of one split, in bytes from the (16-aligned) base:
// `stages` ring stages of (K chunk, V chunk, live flags), then q (later the
// split's accumulator), the chunk's scores, the running statistics, the
// combine's factors and each stage's first K/V slots of its entries.
struct Layout {
  int cb, cs, stages;            // blocks and slots of a chunk; ring depth
  size_t k, v, live, stage;      // offsets within a stage; stage bytes
  size_t q, s, stats, comb, slot, bytes;

  __host__ __device__ Layout(int g, int dh, int block_p, int stages_) {
    cb = block_p >= kChunkSlots ? 1 : kChunkSlots / block_p;
    cs = cb * block_p;
    stages = stages_;
    k = 0;
    v = (size_t)cs * (dh + kPad) * 2;
    live = v + (size_t)cs * dh * 2;
    stage = round16(live + cs);
    q = stages * stage;
    s = q + (size_t)g * dh * 4;
    stats = s + (size_t)g * cs * 4;              // m, l, corr: 3G floats
    comb = stats + (size_t)3 * g * 4;            // fac (S x G), M, L, M_<s
    slot = round16(comb + (size_t)(kCluster + 3) * g * 4);
    bytes = slot + (size_t)stages * cb * 8;
  }
};

// Grid: B*Hkv*S blocks, a cluster of S per (lane, kv head) row.
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
                  float scale, int has_cap, float cap, int shared_kv,
                  int valid_vec, int stages, int nsplit) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(g, dh, block_p, stages);
  const int cb = L.cb, cs = L.cs;
  const int kstride = dh + kPad;
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* acc_s = q_s;                 // the split's accumulator, after the loop
  float* s_s = reinterpret_cast<float*>(smem + L.s);   // (G, cs) scores, probs
  float* m_s = reinterpret_cast<float*>(smem + L.stats);   // running max (G)
  float* l_s = m_s + g;               // running denominator (G)
  float* c_s = l_s + g;               // this chunk's rescale factor (G)
  float* fac_s = reinterpret_cast<float*>(smem + L.comb);  // (S, G)
  float* mg_s = fac_s + kCluster * g;  // the row's max (G)
  float* lg_s = mg_s + g;              // the row's denominator (G)
  float* mlt_s = lg_s + g;             // max of the splits before this one (G)
  size_t* slot_s = reinterpret_cast<size_t*>(smem + L.slot);  // (stages, cb)

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x % nsplit;   // the cluster spans x
  const int row = blockIdx.x / nsplit;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gd = g * dh;
  const int vpr = dh / 8;              // 16-byte vectors per K/V row

  const int nblk = p / block_p;        // blocks of a row's arena, or pages
  const int count = min(max(n[row], 0), nb_tbl);
  const int e0 = (int)((long long)rank * count / nsplit);
  const int e1 = (int)((long long)(rank + 1) * count / nsplit);
  const int nchunks = (e1 - e0 + cb - 1) / cb;
  const int32_t* tbl_row = tbl + (size_t)row * nb_tbl;
  // first K/V slot of a table entry naming block (or page) `blk`
  auto kv_slot0 = [&](int32_t blk) {
    const size_t b = (size_t)min(max(blk, 0), nblk - 1);
    return shared_kv ? b * block_p : (size_t)row * p + b * block_p;
  };

  // stage chunk c into ring stage c % stages, whose slot_s row holds the
  // chunk's entries' first slots.  Always commits a group (maybe empty), so
  // that the wait below counts groups the same way in every iteration.
  auto stage_chunk = [&](int c) {
    if (c < nchunks) {
      unsigned char* st = smem + (size_t)(c % stages) * L.stage;
      const size_t* slot0 = slot_s + (c % stages) * cb;
      __nv_bfloat16* k_st = reinterpret_cast<__nv_bfloat16*>(st + L.k);
      __nv_bfloat16* v_st = reinterpret_cast<__nv_bfloat16*>(st + L.v);
      uint8_t* live_st = st + L.live;
      const int i0 = e0 + c * cb;
      const int slots = min(cb, e1 - i0) * block_p;
      for (int e = tid; e < slots * vpr; e += kThreads) {
        const int j = e / vpr;
        const int c8 = (e - j * vpr) * 8;
        const int ei = j / block_p;
        const size_t src = (slot0[ei] + (j - ei * block_p)) * dh + c8;
        cp_async16(k_st + j * kstride + c8, k + src);
        cp_async16(v_st + j * dh + c8, v + src);
      }
      auto valid_at = [&](int j) {
        const int ei = j / block_p;
        const size_t s0 = shared_kv ? ((size_t)row * nb_tbl + i0 + ei) * block_p
                                    : slot0[ei];
        return valid + s0 + (j - ei * block_p);
      };
      if (valid_vec) {
        for (int j = 4 * tid; j < slots; j += 4 * kThreads)
          cp_async4(live_st + j, valid_at(j));
      } else {
        for (int j = tid; j < slots; j += kThreads) live_st[j] = *valid_at(j);
      }
    }
    cp_async_commit();
  };

  // q, in 16-byte vectors, is loaded while the table's chain of loads (n,
  // then the entries of the first chunks, then their K/V) is in flight
  const uint4* q_row = reinterpret_cast<const uint4*>(q + (size_t)row * gd);
  uint4 q_r[kQVecs];
#pragma unroll
  for (int r = 0; r < kQVecs; ++r) {
    const int e = tid + r * kThreads;
    if (e < gd / 8) q_r[r] = q_row[e];
  }
  if (tid < stages * cb && e0 + tid < e1)
    slot_s[tid] = kv_slot0(tbl_row[e0 + tid]);
  __syncthreads();
  for (int c = 0; c < stages; ++c) stage_chunk(c);
#pragma unroll
  for (int r = 0; r < kQVecs; ++r) {
    const int e = tid + r * kThreads;
    if (e < gd / 8) {
      const __nv_bfloat162* h =
          reinterpret_cast<const __nv_bfloat162*>(&q_r[r]);
      float2* dst = reinterpret_cast<float2*>(q_s + 8 * e);
#pragma unroll
      for (int i = 0; i < 4; ++i) dst[i] = __bfloat1622float2(h[i]);
    }
  }
  if (tid < g) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kAccPerThread];
#pragma unroll
  for (int j = 0; j < kAccPerThread; ++j) acc[j] = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    const int nc = c + stages;        // the chunk this iteration stages
    const int ni = e0 + nc * cb + tid;
    int32_t nxt = 0;                  // an entry of it (tid < cb)
    if (tid < cb && ni < e1) nxt = tbl_row[ni];     // in flight during the math
    cp_async_wait(stages - 1);
    __syncthreads();

    const unsigned char* st = smem + (size_t)(c % stages) * L.stage;
    const __nv_bfloat16* k_st = reinterpret_cast<const __nv_bfloat16*>(st + L.k);
    const __nv_bfloat16* v_st = reinterpret_cast<const __nv_bfloat16*>(st + L.v);
    const uint8_t* live_st = st + L.live;
    const int i0 = e0 + c * cb;
    const int ne = min(cb, e1 - i0);
    const int slots = ne * block_p;

    // scores: one thread per (g, slot) pair
    for (int pair = tid; pair < g * slots; pair += kThreads) {
      const int gi = pair / slots;
      const int j = pair - gi * slots;
      const float* qg = q_s + gi * dh;
      const __nv_bfloat16* kj = k_st + j * kstride;
      float s = 0.f;
      for (int d = 0; d < dh; d += 8)
        s += dot8(qg + d, *reinterpret_cast<const uint4*>(kj + d));
      s *= scale;
      if (has_cap) s = cap * tanhf(s / cap);
      s_s[gi * cs + j] = live_st[j] ? s : kNegInf;
    }
    __syncthreads();

    // online softmax, once per chunk: one warp per query head of the group
    for (int gi = warp; gi < g; gi += kWarps) {
      float* sg = s_s + gi * cs;
      const float m_prev = m_s[gi];
      float m_new = m_prev;
      if (w_blk != nullptr) {
        // weights-out: each entry's probabilities against the split's
        // running max after it (dead slots 0), and that max
        for (int ei = 0; ei < ne; ++ei) {
          const float* se = sg + ei * block_p;
          const uint8_t* le = live_st + ei * block_p;
          float bmax = kNegInf;
          for (int j = lane; j < block_p; j += 32) bmax = fmaxf(bmax, se[j]);
          m_new = fmaxf(m_new, warp_max(bmax));
          const size_t entry = (size_t)row * nb_tbl + i0 + ei;
          float* w_row = w_blk + (entry * g + gi) * block_p;
          for (int j = lane; j < block_p; j += 32)
            w_row[j] = le[j] ? expf(se[j] - m_new) : 0.f;
          if (lane == 0) m_blk[entry * g + gi] = m_new;
        }
      } else {
        float bmax = kNegInf;
        for (int j = lane; j < slots; j += 32) bmax = fmaxf(bmax, sg[j]);
        m_new = fmaxf(m_prev, warp_max(bmax));
      }
      float sum = 0.f;
      for (int j = lane; j < slots; j += 32) {
        const float pj = live_st[j] ? expf(sg[j] - m_new) : 0.f;
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

    // PV: each thread owns fixed (g, d) accumulator elements
#pragma unroll
    for (int jj = 0; jj < kAccPerThread; ++jj) {
      const int e = tid + jj * kThreads;
      if (e < gd) {
        const int gi = e / dh;
        const int d = e - gi * dh;
        const float* pg = s_s + gi * cs;
        float a = acc[jj] * c_s[gi];
        for (int j = 0; j < slots; ++j)
          a += pg[j] * __bfloat162float(v_st[j * dh + d]);
        acc[jj] = a;
      }
    }
    __syncthreads();                  // stage c % stages is free
    if (tid < cb && ni < e1) slot_s[(nc % stages) * cb + tid] = kv_slot0(nxt);
    __syncthreads();
    stage_chunk(nc);
  }

  // this split's accumulator beside its m and l, for the cluster to read;
  // it overwrites q_s, which other threads wrote (and, after a chunk, read)
  __syncthreads();
#pragma unroll
  for (int jj = 0; jj < kAccPerThread; ++jj) {
    const int e = tid + jj * kThreads;
    if (e < gd) acc_s[e] = acc[jj];
  }
  cluster.sync();

  // every split: the row's statistics from all splits' m and l, in rank
  // order (the remote reads started together, then summed)
  if (tid < g) {
    float mr[kCluster], lr[kCluster];
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      mr[r] = r < nsplit ? cluster.map_shared_rank(m_s, r)[tid] : kNegInf;
      lr[r] = r < nsplit ? cluster.map_shared_rank(l_s, r)[tid] : 0.f;
    }
    float mg = kNegInf, mlt = kNegInf;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      mg = fmaxf(mg, mr[r]);
      if (r < rank) mlt = fmaxf(mlt, mr[r]);
    }
    float lg = 0.f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      if (r < nsplit) {
        const float f = expf(mr[r] - mg);
        fac_s[r * g + tid] = f;
        lg += lr[r] * f;
      }
    }
    mg_s[tid] = mg;
    lg_s[tid] = lg;
    mlt_s[tid] = mlt;
    if (m_out != nullptr && rank == 0) {
      m_out[(size_t)row * g + tid] = mg;
      l_out[(size_t)row * g + tid] = lg;
    }
  }
  __syncthreads();

  // this split's slice of the output row
  const int o0 = (int)((long long)rank * gd / nsplit);
  const int o1 = (int)((long long)(rank + 1) * gd / nsplit);
  __nv_bfloat16* o_row = out + (size_t)row * gd;
  for (int e = o0 + tid; e < o1; e += kThreads) {
    const int gi = e / dh;
    float x[kCluster];
#pragma unroll
    for (int r = 0; r < kCluster; ++r)
      x[r] = r < nsplit ? cluster.map_shared_rank(acc_s, r)[e] : 0.f;
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r)
      if (r < nsplit) a += x[r] * fac_s[r * g + gi];
    const float l = lg_s[gi];
    o_row[e] = __float2bfloat16(a / (l > 0.f ? l : 1.f));
  }

  // weights-out: entries whose split-local running max is below the max of
  // the splits before them take the row's running max in table order
  if (w_blk != nullptr && rank > 0) {
    for (int x = tid; x < (e1 - e0) * g; x += kThreads) {
      const int gi = x % g;
      const size_t entry = (size_t)row * nb_tbl + e0 + x / g;
      const float mt = m_blk[entry * g + gi];
      const float mlt = mlt_s[gi];
      if (mt < mlt) {
        m_blk[entry * g + gi] = mlt;
        const float f = expf(mt - mlt);
        float* w_row = w_blk + (entry * g + gi) * block_p;
        for (int j = 0; j < block_p; ++j) w_row[j] *= f;
      }
    }
  }
  cluster.sync();                     // no block leaves while others read it
}

// Raise the kernel's limits once, to the most any shape needs, so that a
// launch inside CUDA-graph capture sets nothing.
cudaError_t allow() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      dms_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kMaxSmem);
  if (e == cudaSuccess && kCluster > 8)
    e = cudaFuncSetAttribute(
        dms_decode_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  done = e == cudaSuccess;
  return e;
}

}  // namespace

// The splits (thread blocks) of each row's table at table capacity nb_tbl.
extern "C" int dms_decode_splits(int nb_tbl) {
  return nb_tbl < 1 ? 1 : (nb_tbl < kCluster ? nb_tbl : kCluster);
}

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
  // two ring stages where they fit (all but 128-slot blocks at the largest Dh)
  int stages = 2;
  if (Layout(g, dh, block_p, 2).bytes > kMaxSmem) stages = 1;
  const size_t smem = Layout(g, dh, block_p, stages).bytes;
  cudaError_t e = allow();
  if (e != cudaSuccess) return (int)e;
  // `valid` by 4-byte copies when every entry's flags start 4-byte aligned
  const int valid_vec = (uintptr_t)valid % 4 == 0 && block_p % 4 == 0 &&
                        (shared_kv || p % 4 == 0);
  const int nsplit = dms_decode_splits(nb_tbl);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)bh * nsplit);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(
      &cfg, dms_decode_kernel, (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const uint8_t*)valid, (const int32_t*)tbl,
      (const int32_t*)n, (__nv_bfloat16*)out, (float*)w_blk, (float*)m_blk,
      (float*)m_out, (float*)l_out, g, dh, p, nb_tbl, block_p, scale, has_cap,
      cap, shared_kv, valid_vec, stages, nsplit);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
