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
//     arena rows: the weights that TOVA, H2O and Keyformer evict by;
//   * slot-shard mode (`shard`, a fixed arena whose slot axis is split
//     across ranks, as the reference's sharding rule splits it in a decode
//     cell whose batch and heads cannot take the mesh), with or without
//     weights-out: the row's arena is the shard [slot_lo, slot_lo + P) of
//     the whole row, P need not be a multiple of block_p, and the table
//     (replicated over the shards) names global block ids.  Each split
//     keeps the entries of its range whose block overlaps the shard, in
//     table order, so a block outside the shard is never read; a block
//     that straddles the shard's edge loads its rows inside the shard and
//     zero-fills the rest, which count as dead slots.  The shard's m and l
//     go to m_out and l_out beside the output, for the ranks to combine.
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
//     splits of a row form one thread-block cluster (grid B*Hkv*S).  The
//     wrapper picks S on the host from B*Hkv, the SM count and NB_tbl
//     (ops.splits: enough blocks to fill the SMs, 1 to 16, never from n,
//     which lives on the device: the step stays free of host syncs); the
//     ranges follow n on the device, so the live entries are spread evenly
//     whatever the capacity.  A split whose range is empty contributes
//     m = -1e30, l = 0;
//   * the splits are combined inside the cluster, with no atomics, no
//     workspace and no second launch: each split leaves its running max m,
//     denominator l (G) and fp32 accumulator (G x Dh) in its shared memory;
//     after a cluster barrier every split reads all of them through
//     distributed shared memory in rank order (m = max m_s, l = sum l_s
//     e^(m_s - m), acc = sum acc_s e^(m_s - m)) and writes its 1/S slice of
//     the bf16 output row, so a launch gives the same bits every time;
//   * inside a split, K/V of a chunk of 64 slots (at least one whole block)
//     are staged by cp.async into a shared-memory ring as deep as two
//     blocks on an SM allow (up to 4 stages; 2-4 up to Dh 128, one at Dh
//     256): later chunks are in flight while chunk c is scored, and the
//     online softmax updates once per chunk;
//   * a split reads its range of the table into shared memory once, before
//     its first chunk: no chunk then waits on a dependent load of its
//     entries (the chain n -> table -> K/V is paid once, not per chunk);
//   * only entries < n are read, so a block (or page) that no listed entry
//     names is never fetched, and the bytes fetched are
//     `ops.modeled_hbm_bytes`; the G query heads of a group share each
//     staged K/V block;
//   * both products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//     fp32 accumulate): the group's G query heads are the 16 rows of one M
//     tile (rows past G zero).  Predicates, not branches, guard the
//     warp-wide mma and ldmatrix, so the fragment loads of several steps
//     stay in flight together; the staging loop divides by multiplies.  Scores Q.K^T: each warp takes 8-slot
//     column tiles of the chunk, its fragments read from the padded K and
//     q rows in 8-byte loads.  They land in shared memory in fp32, where the
//     online softmax (one warp per query head) and the weights-out mode read
//     them.  P.V: each warp owns 8-column tiles of the G x Dh accumulator,
//     P rounded to bf16 as the A operand (as the flash kernels round it),
//     V's fragments by ldmatrix.trans.  The statistics, the accumulator and
//     the combine stay fp32; only the bf16 output row goes back;
//   * weights-out mode keeps the reference's raw contract exactly: a split
//     writes each entry's probabilities against its own running max m~_i,
//     from the fp32 scores it holds in shared memory; after the combine it
//     knows M_<s, the largest split max of the ranks before it, and
//     rewrites the entries whose m~_i is below it: m_blk[i] = M_<s, w_blk[i]
//     *= exp(m~_i - M_<s).  m_out and l_out are the combined statistics.
// The two layouts differ only in two addresses (kv_slot0, valid_at):
// the split ranges depend on NB_tbl and n alone, and every sum runs in the
// same order, so the same logical contents in the same table order give
// the same bits in either layout.
//
// Not done here (see PERF.md and ROADMAP B1): in weights-out mode, the
// wrapper's rescale, group sum and scatter fused into the epilogue.  A
// shard's splits still cut the whole row's entries, so a shard whose
// overlapping blocks sit together in the table leaves other splits idle.
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
constexpr int kMaxG = 16;        // one m16 tile of query heads
constexpr int kMaxDh = 256;
constexpr int kMaxBlockP = 128;
constexpr int kQVecs = kMaxG * kMaxDh / 8 / kThreads;   // of q, per thread
constexpr int kOutTiles = kMaxDh / 8 / kWarps;  // n8 tiles of O per warp
constexpr int kKPad = 16;   // bf16 per K and q row: 8-byte fragment loads
                            // of a half-warp hit 32 distinct banks
constexpr int kVPad = 8;    // bf16 per V row: ldmatrix's 8 rows, distinct banks
constexpr int kSPad = 8;    // floats per score row
constexpr float kNegInf = -1e30f;
// splits of a row's table (one thread-block cluster), chosen on the host;
// above 8 a cluster needs the non-portable size
constexpr int kMaxSplit = 16;
constexpr int kMaxStages = 4;
constexpr size_t kMaxSmem = 227u * 1024u;
// the most one block may take for two to share an SM (228 KB, 1 KB each
// reserved)
constexpr size_t kTwoBlocks = (228u * 1024u) / 2 - 1024u;

// K/V slots a split stages per pipeline step (at least one whole block).
// 64 at every Dh: at Dh 256, 32-slot chunks in a three-stage ring (two
// blocks on an SM) measured slower than 64-slot chunks in one stage, since
// each chunk pays a fixed latency in its softmax and its barriers (PERF.md)
constexpr int kChunkSlots = 64;

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
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
  }
}

// d (16 x 8 fp32) += a (16 x 16 bf16, row-major) . b (16 x 8 bf16, col),
// where `on` (the same in every lane of the warp: the instruction is
// warp-wide); a predicate, not a branch, so that the compiler keeps the
// fragment loads of several steps in flight together
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1,
                                         bool on = true) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "@p mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"((int)on));
}

// the B fragment of rows [r, r + 16) x columns [c, c + 8) of a row-major
// bf16 tile, transposed: lanes 0-15 name the 16 rows; where `on` (the same
// in every lane), else zeros
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1,
                                                  const void* row_ptr,
                                                  bool on = true) {
  b0 = b1 = 0u;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %3, 0;\n"
      "@p ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n}\n"
      : "+r"(b0), "+r"(b1) : "r"(smem_u32(row_ptr)), "r"((int)on));
}

// x / d for 0 <= x < 2^16 and 1 <= d < 256, by a multiply: m is
// ceil(2^32 / d) (0 for d = 1), from fast_div_m on the host
__device__ __forceinline__ int fast_div(int x, uint32_t m) {
  return m ? (int)__umulhi((uint32_t)x, m) : x;
}
uint32_t fast_div_m(int d) {
  return d > 1 ? (uint32_t)((0x100000000ull + d - 1) / d) : 0u;
}

__device__ __forceinline__ uint32_t pack_bf16(float2 x) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x.x, x.y);   // x.x in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__host__ __device__ __forceinline__ size_t round16(size_t x) {
  return (x + 15) / 16 * 16;
}

// The most table entries one split of a row takes: its range [s*n/S,
// (s+1)*n/S) holds at most ceil(NB_tbl / S).
__host__ __device__ __forceinline__ int split_entries(int nb_tbl, int nsplit) {
  return nb_tbl < 1 ? 1 : (nb_tbl + nsplit - 1) / nsplit;
}

// Shared-memory layout of one split, in bytes from the (16-aligned) base:
// `stages` ring stages of (K chunk, V chunk, live flags), each of cs16
// rows (the chunk's slots rounded up to the m16 tile), then q (bf16), the
// chunk's scores, the running statistics, the combine's factors and the
// split's `tcap` table entries; in slot-shard mode also the kept entries'
// indices in the table and a count per warp for keeping them.  After the
// loop the split's fp32 accumulator (G x Dh) takes the ring's first bytes.
struct Layout {
  int cb, cs, cs16, stages;      // blocks and slots of a chunk; ring depth
  int kst, vst, sst;             // row strides: K and q, V (bf16); scores
  size_t k, v, live, stage;      // offsets within a stage; stage bytes
  size_t q, s, stats, comb, tbl, idx, wcnt, bytes;

  __host__ __device__ Layout(int g, int dh, int block_p, int stages_,
                             int tcap, int shard) {
    cb = block_p >= kChunkSlots ? 1 : kChunkSlots / block_p;
    cs = cb * block_p;
    cs16 = (cs + 15) / 16 * 16;
    stages = stages_;
    kst = dh + kKPad;
    vst = dh + kVPad;
    sst = cs16 + kSPad;
    k = 0;
    v = (size_t)cs16 * kst * 2;
    live = v + (size_t)cs16 * vst * 2;
    stage = round16(live + cs16);
    q = stages * stage;
    s = q + (size_t)g * kst * 2;
    stats = s + (size_t)g * sst * 4;             // m, l, corr: 3G floats
    comb = stats + (size_t)3 * g * 4;            // fac (S x G), M, L, M_<s
    tbl = round16(comb + (size_t)(kMaxSplit + 3) * g * 4);
    idx = tbl + (size_t)tcap * 4;
    wcnt = idx + (shard ? (size_t)tcap * 4 : 0);
    bytes = wcnt + (shard ? (size_t)kWarps * 4 : 0);
  }
};

// Grid: B*Hkv*S blocks, a cluster of S per (lane, kv head) row.
__global__ void __launch_bounds__(kThreads, 2)
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
                  int shard, int slot_lo, int valid_vec, int stages,
                  int nsplit, uint32_t m_vpr, uint32_t m_bp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(g, dh, block_p, stages, split_entries(nb_tbl, nsplit),
                 shard);
  const int cb = L.cb, kst = L.kst, vst = L.vst, sst = L.sst;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + L.q);
  float* acc_s = reinterpret_cast<float*>(smem);    // after the loop
  float* s_s = reinterpret_cast<float*>(smem + L.s);   // (G, sst) scores, probs
  float* m_s = reinterpret_cast<float*>(smem + L.stats);   // running max (G)
  float* l_s = m_s + g;               // running denominator (G)
  float* c_s = l_s + g;               // this chunk's rescale factor (G)
  float* fac_s = reinterpret_cast<float*>(smem + L.comb);  // (S, G)
  float* mg_s = fac_s + kMaxSplit * g;  // the row's max (G)
  float* lg_s = mg_s + g;              // the row's denominator (G)
  float* mlt_s = lg_s + g;             // max of the splits before this one (G)
  int32_t* tbl_s = reinterpret_cast<int32_t*>(smem + L.tbl);  // [e0, e1)
  // slot-shard mode: the table index of each kept entry; counts per warp
  int32_t* idx_s = reinterpret_cast<int32_t*>(smem + L.idx);
  int32_t* wcnt_s = reinterpret_cast<int32_t*>(smem + L.wcnt);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x % nsplit;   // the cluster spans x
  const int row = blockIdx.x / nsplit;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;   // mma fragment coordinates
  const int gd = g * dh;
  const int vpr = dh / 8;              // 16-byte vectors per K/V row

  const int nblk = p / block_p;        // blocks of a row's arena, or pages
  const int count = min(max(n[row], 0), nb_tbl);
  const int e0 = (int)((long long)rank * count / nsplit);
  const int e1 = (int)((long long)(rank + 1) * count / nsplit);
  const int32_t* tbl_row = tbl + (size_t)row * nb_tbl;
  // first K/V slot of a table entry naming block (or page) `blk`
  auto kv_slot0 = [&](int32_t blk) {
    const size_t b = (size_t)min(max(blk, 0), nblk - 1);
    return shared_kv ? b * block_p : (size_t)row * p + b * block_p;
  };
  // slot-shard mode: the shard's slot of row j of block `blk`, in [0, p)
  // when the shard holds it
  auto shard_slot = [&](int32_t blk, int j) {
    return (long long)blk * block_p + j - slot_lo;
  };
  // the split's entries in tbl_s (all of [e0, e1), or on a slot shard
  // those that overlap it) and its chunks; set once the table is read
  int nkept = 0, nchunks = 0;

  // stage chunk c into ring stage c % stages, its entries' K/V from the
  // split's table in shared memory.  Always commits a group (maybe empty),
  // so that the wait below counts groups the same way in every iteration.
  // The V rows between the chunk's slots and the next multiple of 16 are
  // zeroed: the PV product reads whole 16-slot steps.
  auto stage_chunk = [&](int c) {
    if (c < nchunks) {
      unsigned char* st = smem + (size_t)(c % stages) * L.stage;
      const int32_t* ent = tbl_s + c * cb;
      __nv_bfloat16* k_st = reinterpret_cast<__nv_bfloat16*>(st + L.k);
      __nv_bfloat16* v_st = reinterpret_cast<__nv_bfloat16*>(st + L.v);
      uint8_t* live_st = st + L.live;
      const int i0 = c * cb;
      const int slots = min(cb, nkept - i0) * block_p;
      const int slots16 = (slots + 15) / 16 * 16;
      for (int e = tid; e < slots * vpr; e += kThreads) {
        const int j = fast_div(e, m_vpr);
        const int c8 = (e - j * vpr) * 8;
        const int ei = fast_div(j, m_bp);
        if (shard) {
          // a straddling block's rows outside the shard: zeros, never read
          const long long ls = shard_slot(ent[ei], j - ei * block_p);
          if (ls >= 0 && ls < p) {
            const size_t src = ((size_t)row * p + (size_t)ls) * dh + c8;
            cp_async16(k_st + j * kst + c8, k + src);
            cp_async16(v_st + j * vst + c8, v + src);
          } else {
            const uint4 z = make_uint4(0u, 0u, 0u, 0u);
            *reinterpret_cast<uint4*>(k_st + j * kst + c8) = z;
            *reinterpret_cast<uint4*>(v_st + j * vst + c8) = z;
          }
          continue;
        }
        const size_t src = (kv_slot0(ent[ei]) + (j - ei * block_p)) * dh + c8;
        cp_async16(k_st + j * kst + c8, k + src);
        cp_async16(v_st + j * vst + c8, v + src);
      }
      for (int e = tid; e < (slots16 - slots) * vpr; e += kThreads) {
        const int jj = fast_div(e, m_vpr);
        *reinterpret_cast<uint4*>(v_st + (slots + jj) * vst + (e - jj * vpr) * 8) =
            make_uint4(0u, 0u, 0u, 0u);
      }
      auto valid_at = [&](int j) {
        const int ei = fast_div(j, m_bp);
        const size_t s0 = shared_kv ? ((size_t)row * nb_tbl + e0 + i0 + ei) * block_p
                                    : kv_slot0(ent[ei]);
        return valid + s0 + (j - ei * block_p);
      };
      if (shard) {
        for (int j = tid; j < slots; j += kThreads) {
          const int ei = fast_div(j, m_bp);
          const long long ls = shard_slot(ent[ei], j - ei * block_p);
          live_st[j] = ls >= 0 && ls < p ? valid[(size_t)row * p + (size_t)ls] : 0;
        }
      } else if (valid_vec) {
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
  // the split's whole range of the table, read once: no chunk waits on a
  // load of its entries.  In slot-shard mode only the entries whose block
  // overlaps the shard are kept, in table order (a ballot per warp, then
  // the warps' counts in order), beside their index in the table.
  nkept = e1 - e0;
  if (!shard) {
    for (int i = tid; i < e1 - e0; i += kThreads) tbl_s[i] = tbl_row[e0 + i];
  } else {
    nkept = 0;
    for (int base = 0; base < e1 - e0; base += kThreads) {
      const int i = base + tid;
      int32_t blk = 0;
      bool keep = false;
      if (i < e1 - e0) {
        blk = tbl_row[e0 + i];
        keep = shard_slot(blk, block_p) > 0 && shard_slot(blk, 0) < p;
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) wcnt_s[warp] = __popc(ballot);
      __syncthreads();
      int at = nkept, total = nkept;
      for (int w = 0; w < kWarps; ++w) {
        if (w < warp) at += wcnt_s[w];
        total += wcnt_s[w];
      }
      if (keep) {
        at += __popc(ballot & ((1u << lane) - 1u));
        tbl_s[at] = blk;
        idx_s[at] = e0 + i;
      }
      nkept = total;
      __syncthreads();                // the counts are rewritten next round
    }
  }
  // the table index of the split's i-th kept entry
  auto entry_of = [&](int i) { return shard ? idx_s[i] : e0 + i; };
  nchunks = (nkept + cb - 1) / cb;
  __syncthreads();
  for (int c = 0; c < stages; ++c) stage_chunk(c);
#pragma unroll
  for (int r = 0; r < kQVecs; ++r) {
    const int e = tid + r * kThreads;
    if (e < gd / 8) {
      const int gi = fast_div(e, m_vpr);
      *reinterpret_cast<uint4*>(q_s + gi * kst + (e - gi * vpr) * 8) = q_r[r];
    }
  }
  if (tid < g) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  // this thread's O fragments: n8 tiles warp + kWarps * i of Dh, rows gid
  // and gid + 8 of the group
  float o_acc[kOutTiles][4];
#pragma unroll
  for (int i = 0; i < kOutTiles; ++i)
#pragma unroll
    for (int x = 0; x < 4; ++x) o_acc[i][x] = 0.f;
  const bool row_a = gid < g, row_b = gid + 8 < g;

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait(stages - 1);
    __syncthreads();

    const unsigned char* st = smem + (size_t)(c % stages) * L.stage;
    const __nv_bfloat16* k_st = reinterpret_cast<const __nv_bfloat16*>(st + L.k);
    const __nv_bfloat16* v_st = reinterpret_cast<const __nv_bfloat16*>(st + L.v);
    const uint8_t* live_st = st + L.live;
    const int i0 = c * cb;
    const int ne = min(cb, nkept - i0);
    const int slots = ne * block_p;
    const int slots16 = (slots + 15) / 16 * 16;

    // scores S = Q.K^T on the tensor cores: warp w takes the n8 tiles w,
    // w + kWarps, ... of the chunk's slots, over Dh in k16 steps on four
    // accumulator chains.  Within a k16 step, lane (gid, tig) feeds columns
    // 4 tig .. 4 tig + 3 as the fragment's k = 2 tig, 2 tig + 1, 2 tig + 8,
    // 2 tig + 9 (the same order for A and B, so the sum is the dot
    // product), one 8-byte load for each operand row.
    for (int t = warp; t * 8 < slots16; t += kWarps) {
      const __nv_bfloat16* kr = k_st + (t * 8 + gid) * kst + 4 * tig;
      const __nv_bfloat16* qa = q_s + gid * kst + 4 * tig;
      const __nv_bfloat16* qb = q_s + (gid + 8) * kst + 4 * tig;
      float d[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int x = 0; x < 4; ++x) d[i][x] = 0.f;
      // four k16 steps a pass: every fragment load first, then the four
      // products; columns past Dh load as zeros and add nothing
      for (int k0 = 0; k0 < dh; k0 += 64) {
        uint2 b[4], xa[4], xb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kk = k0 + 16 * i;
          const bool in = kk + 4 * tig < dh;
          const uint2 z = make_uint2(0u, 0u);
          b[i] = in ? *reinterpret_cast<const uint2*>(kr + kk) : z;
          xa[i] = in && row_a ? *reinterpret_cast<const uint2*>(qa + kk) : z;
          xb[i] = in && row_b ? *reinterpret_cast<const uint2*>(qb + kk) : z;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t a[4] = {xa[i].x, xb[i].x, xa[i].y, xb[i].y};
          mma16816(d[i], a, b[i].x, b[i].y, k0 + 16 * i < dh);
        }
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int gi = gid + 8 * (x >> 1);
        const int j = t * 8 + 2 * tig + (x & 1);
        if (gi < g) {
          float s = ((d[0][x] + d[1][x]) + (d[2][x] + d[3][x])) * scale;
          if (has_cap) s = cap * tanhf(s / cap);
          s_s[gi * sst + j] = j < slots && live_st[j] ? s : kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax, once per chunk: one warp per query head of the group
    for (int gi = warp; gi < g; gi += kWarps) {
      float* sg = s_s + gi * sst;
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
          const size_t entry = (size_t)row * nb_tbl + entry_of(i0 + ei);
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
      for (int j = lane; j < slots16; j += 32) {
        const float pj = j < slots && live_st[j] ? expf(sg[j] - m_new) : 0.f;
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

    // O = O * corr + P.V on the tensor cores, P rounded to bf16 as the A
    // operand (rows past G are zero), V's fragments by ldmatrix.trans
    {
      const float cr_a = row_a ? c_s[gid] : 0.f;
      const float cr_b = row_b ? c_s[gid + 8] : 0.f;
#pragma unroll
      for (int i = 0; i < kOutTiles; ++i) {
        o_acc[i][0] *= cr_a;
        o_acc[i][1] *= cr_a;
        o_acc[i][2] *= cr_b;
        o_acc[i][3] *= cr_b;
      }
      const float* pa = s_s + gid * sst + 2 * tig;
      const float* pb = s_s + (gid + 8) * sst + 2 * tig;
      const float2 z = make_float2(0.f, 0.f);
      for (int ks = 0; ks < slots16; ks += 16) {
        const uint32_t a[4] = {
            pack_bf16(row_a ? *reinterpret_cast<const float2*>(pa + ks) : z),
            pack_bf16(row_b ? *reinterpret_cast<const float2*>(pb + ks) : z),
            pack_bf16(row_a ? *reinterpret_cast<const float2*>(pa + ks + 8) : z),
            pack_bf16(row_b ? *reinterpret_cast<const float2*>(pb + ks + 8) : z)};
        const __nv_bfloat16* vr = v_st + (ks + (lane & 15)) * vst;
        uint32_t b[kOutTiles][2];
#pragma unroll
        for (int i = 0; i < kOutTiles; ++i) {
          const int nt = warp + kWarps * i;
          ldmatrix_x2_trans(b[i][0], b[i][1], vr + min(nt * 8, dh - 8),
                            nt * 8 < dh);
        }
#pragma unroll
        for (int i = 0; i < kOutTiles; ++i)
          mma16816(o_acc[i], a, b[i][0], b[i][1],
                   (warp + kWarps * i) * 8 < dh);
      }
    }
    __syncthreads();                  // stage c % stages is free
    stage_chunk(c + stages);
  }

  // this split's accumulator beside its m and l, for the cluster to read,
  // in the ring's first bytes: every chunk's copies have landed and every
  // thread is past its last read of the ring
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kOutTiles; ++i) {
    const int col = (warp + kWarps * i) * 8 + 2 * tig;
    if (col < dh) {
      if (row_a)
        *reinterpret_cast<float2*>(acc_s + gid * dh + col) =
            make_float2(o_acc[i][0], o_acc[i][1]);
      if (row_b)
        *reinterpret_cast<float2*>(acc_s + (gid + 8) * dh + col) =
            make_float2(o_acc[i][2], o_acc[i][3]);
    }
  }
  cluster.sync();

  // every split: the row's statistics from all splits' m and l, in rank
  // order (the remote reads started together, then summed)
  if (tid < g) {
    float mr[kMaxSplit], lr[kMaxSplit];
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      mr[r] = r < nsplit ? cluster.map_shared_rank(m_s, r)[tid] : kNegInf;
      lr[r] = r < nsplit ? cluster.map_shared_rank(l_s, r)[tid] : 0.f;
    }
    float mg = kNegInf, mlt = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      mg = fmaxf(mg, mr[r]);
      if (r < rank) mlt = fmaxf(mlt, mr[r]);
    }
    float lg = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
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
    float x[kMaxSplit];
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r)
      x[r] = r < nsplit ? cluster.map_shared_rank(acc_s, r)[e] : 0.f;
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r)
      if (r < nsplit) a += x[r] * fac_s[r * g + gi];
    const float l = lg_s[gi];
    o_row[e] = __float2bfloat16(a / (l > 0.f ? l : 1.f));
  }

  // weights-out: entries whose split-local running max is below the max of
  // the splits before them take the row's running max in table order
  if (w_blk != nullptr && rank > 0) {
    for (int x = tid; x < nkept * g; x += kThreads) {
      const int gi = x % g;
      const size_t entry = (size_t)row * nb_tbl + entry_of(x / g);
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
  if (e == cudaSuccess && kMaxSplit > 8)
    e = cudaFuncSetAttribute(
        dms_decode_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  done = e == cudaSuccess;
  return e;
}

}  // namespace

// The ring depth of a shape: the deepest (up to kMaxStages) that leaves two
// blocks on an SM, else one stage.
extern "C" int dms_decode_stages(int g, int dh, int block_p, int nb_tbl,
                                 int nsplit, int shard) {
  const int tcap = split_entries(nb_tbl, nsplit);
  for (int s = kMaxStages; s > 1; --s)
    if (Layout(g, dh, block_p, s, tcap, shard).bytes <= kTwoBlocks) return s;
  return 1;
}

// `nsplit`: the splits (thread blocks, one cluster) of each row's table,
// 1 to 16, chosen by the wrapper (ops.splits) from B*Hkv, the SM count and
// NB_tbl.  `shard`: the slot-shard mode, `p` the shard's slots a row and
// `slot_lo` its first slot in the whole row (fixed arenas only).
extern "C" int dms_decode_fwd(const void* q, const void* k, const void* v,
                              const void* valid, const void* tbl,
                              const void* n, void* out, void* w_blk,
                              void* m_blk, void* m_out, void* l_out, int bh,
                              int g, int dh, int p, int nb_tbl, int block_p,
                              float scale, int has_cap, float cap,
                              int shared_kv, int shard, int slot_lo,
                              int nsplit, void* stream) {
  if (bh < 0 || g < 1 || g > kMaxG || dh < 8 || dh > kMaxDh || dh % 8 != 0 ||
      block_p < 1 || block_p > kMaxBlockP || nb_tbl < 0 || nsplit < 1 ||
      nsplit > kMaxSplit)
    return (int)cudaErrorInvalidValue;
  if (shard ? (p < 1 || slot_lo < 0 || shared_kv)
            : (p < block_p || p % block_p != 0))
    return (int)cudaErrorInvalidValue;
  // weights-out takes w_blk and m_blk with the statistics m_out and l_out;
  // the statistics alone (a slot shard's) take m_out and l_out
  if ((w_blk != nullptr) != (m_blk != nullptr) ||
      (m_out != nullptr) != (l_out != nullptr) ||
      (w_blk != nullptr && m_out == nullptr))
    return (int)cudaErrorInvalidValue;
  if (bh == 0) return (int)cudaSuccess;
  const int stages = dms_decode_stages(g, dh, block_p, nb_tbl, nsplit, shard);
  const size_t smem =
      Layout(g, dh, block_p, stages, split_entries(nb_tbl, nsplit), shard)
          .bytes;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow();
  if (e != cudaSuccess) return (int)e;
  // `valid` by 4-byte copies when every entry's flags start 4-byte aligned
  const int valid_vec = !shard && (uintptr_t)valid % 4 == 0 &&
                        block_p % 4 == 0 && (shared_kv || p % 4 == 0);
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
      cap, shared_kv, shard, slot_lo, valid_vec, stages, nsplit,
      fast_div_m(dh / 8), fast_div_m(block_p));
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
