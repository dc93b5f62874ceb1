// Leaf histograms over row-block lists and row-block ranges, for Hopper
// (sm_90a), in three accumulator modes.
//
// Replaces the Pallas TPU kernels of lightgbm_tpu/ops/hist_pallas.py:
//   lgbt_hist_blocklist        leaf_histogram_blocklist (K3) and, called
//                              with the identity block list,
//                              leaf_histogram_masked (K1); with ranged != 0,
//                              leaf_histogram_ranged (K5a)
//   lgbt_hist_blocklist_fused  leaf_histogram_blocklist_fused (K4) and,
//                              with the identity list,
//                              leaf_histogram_masked_fused (K2); with
//                              ranged != 0, leaf_histogram_ranged_fused (K5b)
// and, through the `mode` argument of each, the hist_acc accumulator modes
// of all of them (K6: make_gh2_acc, dequant_hist, _operand_dtype /
// _acc_dtype and the i32 dequantisation of the fused scan).
//
// What they compute.  hist[f, b, :] = (sum grad, sum hess, count) over the
// rows r of the listed 8192-row blocks with leaf_eff[r] == target and
// bins[f, r] == b.  The list is block_list[0 .. n_active), or start +
// [0 .. n_active) when the entry point is called with ranged != 0.  The
// fused variants then run the best-threshold scan of
// ops/split.per_feature_split_rows on the child (hist) and on its sibling
// (parent - hist) and write one [8] row per feature for each.
//
// Modes (gh2's element type, the accumulator type):
//   0 f32   float gh2, float accumulators;
//   1 bf16  __nv_bfloat16 gh2, widened to float on load; from there on
//           the f32 path, instruction for instruction;
//   2 i32   int gh2 (fixed point, |q| <= 2^30 / N, so no sum of the
//           array's rows can overflow), int accumulators, exact and
//           order-free; the reduce dequantises g and h as
//           (float)isum * inv_scale and counts as (float)icnt, which is
//           hist.astype(f32) * [inv, inv, 1] of the JAX package.
//           inv_scale is read from device memory: it depends on the
//           tree's max |gh|, and a host value would need a sync.
//
// What bounds them.  Memory: each sweep reads F bytes of bins and 4 bytes
// of leaf_eff per listed row, 8 bytes (f32, i32) or 4 (bf16) of (grad,
// hess) per in-leaf row, and writes one partial histogram per (listed
// block, feature).  The TPU kernel turned the scatter into one-hot matrix
// products for the MXU (bin = hi*32 + lo); a GPU scatters into shared
// memory directly, so none of that is carried over.  On the card the
// sweeps are far from HBM-bound (the root at about 12x its byte bound):
// measured, a tile's fixed work (the staging's round trip to device
// memory, the barriers, the cluster merge) takes about a third of the
// root's sweep and grouping the lanes of a step by bin most of the rest;
// the shared-memory updates themselves are the smaller part.  The design
// below issues a tile's loads at once, groups lanes with one byte a bin
// and one word a shared bin, and spends one 8-byte load and store and one
// count update per group.
//
// Design.
//   * Grid (feature groups of FG = 8, list positions, 8 tiles), with the 8
//     tiles of a position as one thread-block cluster: CTA rank r sweeps
//     rows [r * 1024, (r + 1) * 1024) of the position's 8192-row block for
//     8 features, one warp each.  Each CTA reads n_active (and the range
//     start) from device memory and exits past n_active before any cluster
//     barrier (uniform over the cluster), so no host sync picks the grid
//     size (the JAX package's lax.switch ladder of grid sizes).
//   * n_active is clamped to [1, nblocks] and list entries to
//     [0, nblocks), as the JAX wrappers clamp them.  Ranged: start is
//     clamped to [0, nblocks); a position whose block start + pos lies past
//     the last block adds nothing (a zero tile; on the TPU such a position
//     reads past the array).
//   * bins may be a window of a wider matrix: row f starts at f * ldb.
//     bins, ldb, gh2 and leaf_eff must be 16-byte aligned (the wrappers
//     check); gh2 and leaf_eff are [2, N] and [N], contiguous.
//   * Staging a tile: every global load is issued up front, so that their
//     latencies overlap: leaf_eff and (grad, hess) of rows 4t .. 4t+3 in
//     one 16-byte load each (8 bytes for bf16 gh2) and two 16-byte bin
//     segments a thread.  The in-leaf rows are compacted in ascending
//     order (each 32-row chunk's flag mask assembled from its 8 lanes'
//     4-bit flags by warp shuffles, then an exclusive prefix over the 32
//     chunk counts): their offsets into idx and their (grad, hess) into
//     shared memory, straight from registers; the bin segments are
//     stored as they are and, unless every row is in, each warp then
//     compacts its feature's segment in place through idx.
//   * The step loop.  A warp owns one feature's records in the tile: per
//     bin an 8-byte (g, h) record (float2; int2 in i32) and an int count,
//     3 KB a warp, 43 KB of shared memory a CTA in every mode (5 CTAs an
//     SM).  It walks the compacted rows 128 at a time:
//     lane l reads the bins of rows 128 s + 4 l + j, j = 0..3, as one
//     32-bit word and their grad and hess as one 16-byte load each, and
//     runs sub-steps j = 0..3, lane l on row 128 s + 4 l + j.  Out-of-leaf
//     rows cost no step.
//   * Float modes: a warp groups the lanes of a sub-step by bin without a
//     shared-memory word per lane and bin: each lane writes its lane id
//     into its bin's owner byte (256 bytes a warp; the hardware keeps one
//     of the stores to a byte, and which one does not change the groups)
//     and reads it back.  Where every lane reads its own id the rows'
//     bins are distinct and each lane is its own group.  Otherwise each
//     lane ORs its bit into the word of the id it read (the group's
//     winner; 32 words a warp) and reads its group's mask back.  A group
//     sums its rows by a pairwise tree over its members in lane order
//     through shuffles (at level s the member of rank r, r a multiple of
//     2s, adds the partial of rank r + s; ceil(log2 size) levels, so a
//     step whose 32 rows share a bin costs 5 levels, not 31 serial
//     additions), and its first member adds the sum to the bin with one
//     float2 load and store, and the group's size to the int count with
//     one integer atomic.  No float atomics (sm_90 has no shared-memory
//     float add: the compiler emits a compare-and-swap loop).
//   * i32: integer sums are exact in any order, so no groups: each row
//     adds g, h and 1 to its bin with three shared-memory integer atomics
//     (a packed 64-bit (g, h) add would be one, but sm_90 runs the 64-bit
//     shared add as a compare-and-swap loop, slower than three).
//   * Merge: after a cluster barrier, rank r sums feature r's records over
//     the 8 ranks' shared memory (distributed shared memory), in rank
//     order, one bin a thread, and writes (g, h, count) to the position's
//     slot of a partials buffer [nblocks, F, 256, 3] (counts converted
//     exactly to float in the float modes); a second
//     barrier keeps every CTA's shared memory alive until all have read
//     it.  The reduce sums the first n_active slots in ascending list
//     position.
//   * Every run gives the same bits.  A bin's float sum runs: the pairwise
//     tree within a sub-step's group, sub-step order (s, then j) within a
//     tile, rank order within a block, list order across blocks.  The
//     order depends only on the rows (which are in the leaf, their bins),
//     so a block list that is ascending gives the full sweep's bits: an
//     unlisted block's tiles compact to no rows and add exact +0.0 (exact
//     0 in i32).  At most 5 + 31 + 7 + n_active - 1 roundings reach a
//     term (chip_smoke.py's per-bin bound).
//   * The fused epilogue is one thread block of 256 threads per feature:
//     (1) thread b reduces bin b's partials, dequantises, writes hist and
//     the two children's bins (small, parent - small); (2) six lanes, one
//     per (child, channel), run the serial suffix sums from the top bin
//     down (double accumulators rounded to float at each bin, as
//     torch.cumsum sums float32 on the CPU; right hess + 1e-15); (3)
//     thread t computes threshold t's gain and validity for both children
//     (bin 0 masked, counts rounded half-to-even by rintf); (4) a tree
//     argmax over (gain, t): the larger gain wins and the larger threshold
//     wins a tie, so B - 1 when no threshold is valid, which is the serial
//     walk's rule (strict > while walking down).
//
// Built with -fmad=false, so every float operation rounds as written.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC -o libhist.so hist.cu
// Both entry points launch on the caller's stream and return
// cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int ROW_BLOCK = 8192;  // rows per block; the JAX package's PALLAS_ROW_BLOCK
constexpr int NBIN = 256;        // bins per feature in the partials (max_bin <= 256)
constexpr int FG = 8;            // features per thread block, one warp each
constexpr int THREADS = FG * 32;
constexpr int TILE = 1024;       // rows per CTA: one tile of a block
constexpr int CLUSTER = ROW_BLOCK / TILE;  // CTAs per block, one cluster
static_assert(THREADS == NBIN, "the merge takes one bin a thread");
constexpr float K_EPSILON = 1e-15f;

enum { MODE_F32 = 0, MODE_BF16 = 1, MODE_I32 = 2 };

template <int MODE> struct ModeT;
template <> struct ModeT<MODE_F32> {
  using gh_t = float;
  using acc_t = float;
  using vec_t = float4;
  using rec_t = float2;
};
template <> struct ModeT<MODE_BF16> {
  using gh_t = __nv_bfloat16;
  using acc_t = float;
  using vec_t = float4;
  using rec_t = float2;
};
template <> struct ModeT<MODE_I32> {
  using gh_t = int;
  using acc_t = int;
  using vec_t = int4;
  using rec_t = int2;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ int widen(int v) { return v; }

// list positions that are swept: n_active clamped to [1, nblocks], as the
// JAX wrappers clamp it
__device__ __forceinline__ int active_count(const int* n_active_p,
                                            int nblocks) {
  return min(max(*n_active_p, 1), nblocks);
}

// the row block at list position pos, or -1 past the last block
template <bool RANGED>
__device__ __forceinline__ int block_at(const int* blocks, int pos,
                                        int nblocks) {
  if (RANGED) {
    const int blk = min(max(*blocks, 0), nblocks - 1) + pos;
    return blk < nblocks ? blk : -1;
  }
  return min(max(blocks[pos], 0), nblocks - 1);
}

// accumulator -> float: i32 g and h carry the scale, counts do not
template <int MODE>
__device__ __forceinline__ float dequant(typename ModeT<MODE>::acc_t v,
                                         int c, const float* inv_scale) {
  if constexpr (MODE == MODE_I32) {
    return c < 2 ? (float)v * *inv_scale : (float)v;
  } else {
    return v;
  }
}

constexpr unsigned FULL = 0xffffffffu;
constexpr int SEGS = FG * TILE / 16 / THREADS;  // bin segments a thread

// gh2 of rows r .. r+3 (r a multiple of 4), widened to the accumulator type
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ int4 load4(const int* p) {
  return *reinterpret_cast<const int4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  // a bf16 value is the top half of the float it widens to
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// the sweep's shared memory (dynamic: above the 48 KB of static shared
// memory): per warp (feature) and bin, one 8-byte (g, h) record (float2;
// int2 in i32) and an int count
template <int MODE> struct SweepSmem {
  using acc_t = typename ModeT<MODE>::acc_t;
  using rec_t = typename ModeT<MODE>::rec_t;
  rec_t gh[FG][NBIN];
  int cnt[FG][NBIN];
  uint8_t bins[FG][TILE];         // the tile's bins; compacted in place
  acc_t g[TILE];                  // (grad, hess) of the in-leaf rows
  acc_t h[TILE];
  union {
    uint16_t idx[TILE];           // staging: in-leaf row offsets, ascending
    struct {                      // step loop, per warp:
      uint8_t own[FG][NBIN];      //   a lane id per bin
      unsigned grp[FG][32];       //   a group's lanes per winning lane id
    };
  };
  int chunk_base[TILE / 32];
  int n_in;
};

// one sub-step of a float sweep: lane `lane` holds row (b, g, h) if `in`.
// The lanes that hold the same bin form a group: each lane writes its id
// into its bin's owner byte and one write lands, so the members of a
// group, and only they, read back the same id (their group's winner).
// Where some lane reads another id, each lane ORs its bit into the word
// of its winner and reads the group's mask back; the winner clears the
// word.  A group sums its (g, h) by a pairwise tree over its members in
// lane order (at level s the member of rank r, r a multiple of 2s, adds
// the partial of rank r + s), and its first member adds the sum to the
// bin with one 8-byte load and store and the group's size to the count;
// no other lane touches that bin in the sub-step.
__device__ __forceinline__ void add_row(float2* gh, int* cnt, uint8_t* own,
                                        unsigned* words, int b, bool in,
                                        float g, float h, int lane) {
  if (in) own[b] = (uint8_t)lane;
  __syncwarp();
  const int w = in ? own[b] : lane;  // the lane whose write landed
  unsigned grp = in ? 1u << lane : 0u;
  int top = 1;  // the largest group, uniform over the warp
  if (__ballot_sync(FULL, w != lane)) {  // some bin is held by several lanes
    if (in) atomicOr(&words[w], 1u << lane);
    __syncwarp();
    if (in) grp = words[w];
    __syncwarp();
    if (in && w == lane) words[w] = 0u;
    top = (int)__reduce_max_sync(FULL, (unsigned)__popc(grp));
  }
  const unsigned below = (1u << lane) - 1u;
  const int rank = __popc(grp & below);
  const int size = __popc(grp);
  if (top > 1) {
    unsigned after = grp & ~below & ~(1u << lane);  // members after this lane
    for (int s = 1;; s <<= 1) {
      const bool take = (rank & (2 * s - 1)) == 0 && rank + s < size;
      const int src = take ? __ffs(after) - 1 : lane;
      const float gv = __shfl_sync(FULL, g, src);
      const float hv = __shfl_sync(FULL, h, src);
      if (take) {
        g += gv;
        h += hv;
      }
      if (2 * s >= top) break;
#pragma unroll 1
      for (int c = 0; c < s; ++c) after &= after - 1u;  // now rank + 2s first
    }
  }
  if (size > 0 && rank == 0) {
    float2 o = gh[b];
    o.x += g;
    o.y += h;
    gh[b] = o;
    atomicAdd(&cnt[b], size);  // the only update of cnt[b] in the sub-step
  }
  __syncwarp();  // the next sub-step writes the owner bytes again
}

template <int MODE, bool RANGED>
__global__ void __cluster_dims__(1, 1, CLUSTER) __launch_bounds__(THREADS)
sweep_kernel(const uint8_t* __restrict__ bins, long long ldb,
             const typename ModeT<MODE>::gh_t* __restrict__ gh2,
             const int* __restrict__ leaf_eff, const int* __restrict__ target_p,
             const int* __restrict__ blocks,
             const int* __restrict__ n_active_p,
             typename ModeT<MODE>::acc_t* __restrict__ partial, int F,
             long long N, int nblocks) {
  using acc_t = typename ModeT<MODE>::acc_t;
  using vec_t = typename ModeT<MODE>::vec_t;
  using rec_t = typename ModeT<MODE>::rec_t;
  // uniform over the cluster (one list position), so it comes before
  // any cluster.sync()
  const int pos = blockIdx.y;
  if (pos >= active_count(n_active_p, nblocks)) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SweepSmem<MODE>& sm = *reinterpret_cast<SweepSmem<MODE>*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();  // the tile within the block
  const int blk = block_at<RANGED>(blocks, pos, nblocks);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int f0 = blockIdx.x * FG;
  const int f = f0 + warp;

  // zero the records and counts, 16 bytes a thread at a time
  constexpr int ZERO16 = offsetof(SweepSmem<MODE>, bins) / 16;
  for (int i = threadIdx.x; i < ZERO16; i += THREADS)
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0, 0, 0, 0);

  int n_in = 0;
  if (blk >= 0) {  // uniform over the cluster
    const long long row0 = (long long)blk * ROW_BLOCK + (long long)rank * TILE;
    const int target = *target_p;
    // every global load of the tile up front, so that their latencies
    // overlap: the flags and (grad, hess) of rows 4t .. 4t+3, and two
    // 16-byte bin segments
    const int4 e = reinterpret_cast<const int4*>(leaf_eff + row0)[threadIdx.x];
    const vec_t g4 = load4(gh2 + row0 + 4 * threadIdx.x);
    const vec_t h4 = load4(gh2 + N + row0 + 4 * threadIdx.x);
    uint4 seg[SEGS];
#pragma unroll
    for (int u = 0; u < SEGS; ++u) {
      const int i = threadIdx.x + u * THREADS;
      const int fl = i / (TILE / 16);
      seg[u] = f0 + fl < F
                   ? *reinterpret_cast<const uint4*>(
                         bins + (long long)(f0 + fl) * ldb + row0 +
                         (i % (TILE / 16)) * 16)
                   : make_uint4(0, 0, 0, 0);
    }
    const unsigned nib = (e.x == target) | (e.y == target) << 1 |
                         (e.z == target) << 2 | (e.w == target) << 3;
    // the warp's 128 rows are 4 chunks of 32, each held by 8 lanes: OR
    // the lanes' nibbles into each chunk's 32-bit mask
    unsigned mask = nib << (4 * (lane & 7));
    mask |= __shfl_xor_sync(FULL, mask, 1);
    mask |= __shfl_xor_sync(FULL, mask, 2);
    mask |= __shfl_xor_sync(FULL, mask, 4);
    const int chunk = warp * 4 + (lane >> 3);
    if ((lane & 7) == 0) sm.chunk_base[chunk] = __popc(mask);
    __syncthreads();
    if (warp == 0) {  // exclusive prefix over the 32 chunk counts
      const int c = sm.chunk_base[lane];
      int incl = c;
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += v;
      }
      sm.chunk_base[lane] = incl - c;
      if (lane == 31) sm.n_in = incl;
    }
    __syncthreads();
    n_in = sm.n_in;
    // the in-leaf rows' offsets and (grad, hess), compacted in ascending
    // row order
    const int base = sm.chunk_base[chunk];
    const int bit0 = 4 * (lane & 7);
    const acc_t gv[4] = {g4.x, g4.y, g4.z, g4.w};
    const acc_t hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (nib >> j & 1) {
        const int k = base + __popc(mask & ((1u << (bit0 + j)) - 1u));
        sm.idx[k] = (uint16_t)(4 * threadIdx.x + j);
        sm.g[k] = gv[j];
        sm.h[k] = hv[j];
      }
    }
#pragma unroll
    for (int u = 0; u < SEGS; ++u) {
      const int i = threadIdx.x + u * THREADS;
      *reinterpret_cast<uint4*>(&sm.bins[i / (TILE / 16)]
                                        [(i % (TILE / 16)) * 16]) = seg[u];
    }
    __syncthreads();  // idx and the bin segments are complete
    // each warp compacts its feature's bins to the in-leaf rows, in place
    // (idx[k] >= k, and a chunk is read before it is written)
    if (n_in < TILE && f < F) {
      uint8_t* fb = sm.bins[warp];
      for (int k0 = 0; k0 < n_in; k0 += 32) {
        const int k = k0 + lane;
        const uint8_t v = k < n_in ? fb[sm.idx[k]] : 0;
        __syncwarp();
        if (k < n_in) fb[k] = v;
        __syncwarp();
      }
    }
  }
  __syncthreads();  // the tile staged; the owner bytes may overwrite idx

  // the step loop: lane l takes compacted rows 128 s + 4 l + j in
  // sub-step (s, j), reading the bins of its 4 rows as one word and their
  // grad and hess as one 16-byte load each
  if (f < F) {
    rec_t* gh = sm.gh[warp];
    int* cnt = sm.cnt[warp];
    const uint8_t* fb = sm.bins[warp];
    sm.grp[warp][lane] = 0u;  // the step loop's group words start empty
    __syncwarp();
    for (int s0 = 0; s0 < n_in; s0 += 4 * 32) {
      const int k0 = s0 + 4 * lane;
      const unsigned bw = *reinterpret_cast<const unsigned*>(fb + k0);
      const vec_t g4 = *reinterpret_cast<const vec_t*>(sm.g + k0);
      const vec_t h4 = *reinterpret_cast<const vec_t*>(sm.h + k0);
      const acc_t gj[4] = {g4.x, g4.y, g4.z, g4.w};
      const acc_t hj[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = k0 + j < n_in;
        const int b = (bw >> (8 * j)) & 0xff;
        if constexpr (MODE == MODE_I32) {
          // integer adds are exact in any order: three shared-memory
          // atomics a row
          if (in) {
            atomicAdd(&gh[b].x, gj[j]);
            atomicAdd(&gh[b].y, hj[j]);
            atomicAdd(&cnt[b], 1);
          }
        } else {
          add_row(gh, cnt, sm.own[warp], sm.grp[warp], b, in, gj[j],
                  hj[j], lane);
        }
      }
    }
  }

  // merge the 8 tiles through distributed shared memory: rank r sums
  // feature f0 + r over ranks 0..7, in rank order, one bin a thread
  cluster.sync();
  const int fr = f0 + rank;
  if (fr < F) {
    const int b = threadIdx.x;  // THREADS == NBIN
    rec_t v[CLUSTER];
    int c[CLUSTER];
#pragma unroll
    for (int q = 0; q < CLUSTER; ++q) {
      SweepSmem<MODE>* rq = cluster.map_shared_rank(&sm, q);
      v[q] = rq->gh[rank][b];
      c[q] = rq->cnt[rank][b];
    }
    rec_t acc = v[0];
    int cacc = c[0];
#pragma unroll
    for (int q = 1; q < CLUSTER; ++q) {
      acc.x += v[q].x;
      acc.y += v[q].y;
      cacc += c[q];
    }
    acc_t* out = partial + (((long long)pos * F + fr) * NBIN + b) * 3;
    out[0] = acc.x;
    out[1] = acc.y;
    out[2] = (acc_t)cacc;
  }
  cluster.sync();  // no CTA leaves while another reads its records
}

// hist[f, b, c] = dequant(sum over list positions p < n_active of
// partial[p, f, b, c])
template <int MODE, bool RANGED>
__global__ void reduce_kernel(
    const typename ModeT<MODE>::acc_t* __restrict__ partial,
    const int* __restrict__ n_active_p, const float* __restrict__ inv_scale,
    float* __restrict__ hist, int F, int max_bin, int nblocks) {
  using acc_t = typename ModeT<MODE>::acc_t;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= F * max_bin * 3) return;
  const int f = idx / (max_bin * 3);
  const int rem = idx - f * max_bin * 3;  // b * 3 + c
  const int n_active = active_count(n_active_p, nblocks);
  const long long stride = (long long)F * NBIN * 3;
  const acc_t* p = partial + (long long)f * NBIN * 3 + rem;
  acc_t acc = 0;
  for (int k = 0; k < n_active; ++k) acc += p[k * stride];
  hist[idx] = dequant<MODE>(acc, rem % 3, inv_scale);
}

struct ScanParams {
  int min_data;
  float min_hess, l1, l2, min_gain;
};

__device__ float leaf_split_gain(float g, float h, const ScanParams& s) {
  const float a = fabsf(g);
  const float reg = fmaxf(a - s.l1, 0.f);
  return a > s.l1 ? reg * reg / (h + s.l2) : 0.f;
}

// one thread block of NBIN threads per feature, in four phases:
//   1. thread b reduces bin b's partials, dequantises, writes hist, and
//      fills bin b of the small child (h2[0]) and of parent - small
//      (h2[1]);
//   2. lanes 0..5 of warp 0, one per (child, channel), run the serial
//      suffix sums from bin B-1 down: double accumulators rounded to
//      float at each bin (torch.cumsum's float32 sums on the CPU), right
//      hess + K_EPSILON;
//   3. thread t computes threshold t's gain and validity for both
//      children: the serial scan's float operations, in its order;
//   4. a tree argmax over (gain, t) per child: the larger gain wins and
//      the larger t wins a tie, so B - 1 when every gain is -inf (the
//      serial walk's `t == B-1 || mg > best`); the winner writes the row
template <int MODE, bool RANGED>
__global__ void __launch_bounds__(NBIN)
fused_reduce_kernel(const typename ModeT<MODE>::acc_t* __restrict__ partial,
                    const int* __restrict__ n_active_p,
                    const float* __restrict__ inv_scale,
                    const float* __restrict__ parent,
                    const uint8_t* __restrict__ fmask,
                    const float* __restrict__ stats,  // sg_s, sh_s, sg_l, sh_l
                    const int* __restrict__ cnts,     // cnt_s, cnt_l
                    float* __restrict__ hist, float* __restrict__ pf_small,
                    float* __restrict__ pf_large, int F, int max_bin,
                    int nblocks, ScanParams s) {
  using acc_t = typename ModeT<MODE>::acc_t;
  const int f = blockIdx.x;
  const int b = threadIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __shared__ float h2[2][3][NBIN];  // small child, parent - small
  __shared__ float rs[2][3][NBIN];  // right sums per child, channel, bin
  __shared__ float wm[2][NBIN / 32];
  __shared__ int wi[2][NBIN / 32];
  __shared__ int win[2];
  if (b < max_bin) {
    const int n_active = active_count(n_active_p, nblocks);
    const long long stride = (long long)F * NBIN * 3;
    const acc_t* p = partial + ((long long)f * NBIN + b) * 3;
    acc_t ga = 0, ha = 0, ca = 0;
    for (int k = 0; k < n_active; ++k) {
      ga += p[k * stride];
      ha += p[k * stride + 1];
      ca += p[k * stride + 2];
    }
    const float g = dequant<MODE>(ga, 0, inv_scale);
    const float h = dequant<MODE>(ha, 1, inv_scale);
    const float c = dequant<MODE>(ca, 2, inv_scale);
    const long long o = ((long long)f * max_bin + b) * 3;
    hist[o] = g;
    hist[o + 1] = h;
    hist[o + 2] = c;
    h2[0][0][b] = g;
    h2[0][1][b] = h;
    h2[0][2][b] = c;
    h2[1][0][b] = parent[o] - g;
    h2[1][1][b] = parent[o + 1] - h;
    h2[1][2][b] = parent[o + 2] - c;
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    const int ch = threadIdx.x / 3;
    const int c = threadIdx.x % 3;
    const float* src = h2[ch][c];
    float* dst = rs[ch][c];
    double acc = 0.0;
    int t = max_bin - 1;
    // eight bins' loads ahead of their additions, which stay in order
    for (; t >= 7; t -= 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = src[t - u];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        acc += (double)v[u];
        dst[t - u] = c == 1 ? (float)acc + K_EPSILON : (float)acc;
      }
    }
    for (; t >= 0; --t) {
      acc += (double)src[t];
      dst[t] = c == 1 ? (float)acc + K_EPSILON : (float)acc;
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  const bool fm = fmask[f] != 0;
  float mg[2], lg[2], lh[2];
  int lcnt[2], rcnt[2], key[2];
  for (int ch = 0; ch < 2; ++ch) {
    mg[ch] = -INFINITY;
    key[ch] = -1;
    if (t < max_bin) {
      const float sum_g = stats[2 * ch];
      const float sum_h = stats[2 * ch + 1];
      const float min_gain_shift = leaf_split_gain(sum_g, sum_h, s) +
                                   s.min_gain;
      const float rg = rs[ch][0][t];
      const float rh = rs[ch][1][t];
      rcnt[ch] = (int)rintf(rs[ch][2][t]);
      lg[ch] = sum_g - rg;
      lh[ch] = sum_h - rh;
      lcnt[ch] = cnts[ch] - rcnt[ch];
      const float gain = leaf_split_gain(lg[ch], lh[ch], s) +
                         leaf_split_gain(rg, rh, s);
      const bool valid = t > 0 && fm && rcnt[ch] >= s.min_data &&
                         lcnt[ch] >= s.min_data && rh >= s.min_hess &&
                         lh[ch] >= s.min_hess && gain >= min_gain_shift;
      mg[ch] = valid ? gain : -INFINITY;
      key[ch] = t;
    }
    float m = mg[ch];
    int i = key[ch];
    for (int d = 16; d; d >>= 1) {
      const float m2 = __shfl_down_sync(0xffffffffu, m, d);
      const int i2 = __shfl_down_sync(0xffffffffu, i, d);
      if (m2 > m || (m2 == m && i2 > i)) {
        m = m2;
        i = i2;
      }
    }
    if (lane == 0) {
      wm[ch][warp] = m;
      wi[ch][warp] = i;
    }
  }
  __syncthreads();
  if (warp < 2) {  // warp ch reduces child ch's 8 warp winners
    const int ch = warp;
    float m = lane < NBIN / 32 ? wm[ch][lane] : -INFINITY;
    int i = lane < NBIN / 32 ? wi[ch][lane] : -1;
    for (int d = 16; d; d >>= 1) {
      const float m2 = __shfl_down_sync(0xffffffffu, m, d);
      const int i2 = __shfl_down_sync(0xffffffffu, i, d);
      if (m2 > m || (m2 == m && i2 > i)) {
        m = m2;
        i = i2;
      }
    }
    if (lane == 0) win[ch] = i;
  }
  __syncthreads();
  for (int ch = 0; ch < 2; ++ch) {
    if (t == win[ch]) {
      float* out = (ch ? pf_large : pf_small) + f * 8;
      out[0] = mg[ch];
      out[1] = (float)t;
      out[2] = lg[ch];
      out[3] = lh[ch];
      out[4] = (float)lcnt[ch];
      out[5] = (float)rcnt[ch];
      out[6] = 0.f;
      out[7] = 0.f;
    }
  }
}

struct SweepArgs {
  const void* bins;
  long long ldb;
  const void* gh2;
  const void* leaf_eff;
  const void* target;
  const void* blocks;  // block_list [nblocks], or the range start (1 int)
  const void* n_active;
  const void* inv_scale;  // f32 scalar (i32 mode), else unused
  void* partial;
  int F;
  long long N;
};

template <int MODE, bool RANGED>
cudaError_t launch_sweep(const SweepArgs& a, cudaStream_t st) {
  using M = ModeT<MODE>;
  const int nblocks = (int)(a.N / ROW_BLOCK);
  dim3 grid((a.F + FG - 1) / FG, nblocks, CLUSTER);
  const int smem = (int)sizeof(SweepSmem<MODE>);
  // once per instantiation (and never inside a stream capture after the
  // first call)
  static const cudaError_t attr = cudaFuncSetAttribute(
      sweep_kernel<MODE, RANGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return attr;
  sweep_kernel<MODE, RANGED><<<grid, THREADS, smem, st>>>(
      (const uint8_t*)a.bins, a.ldb, (const typename M::gh_t*)a.gh2,
      (const int*)a.leaf_eff, (const int*)a.target, (const int*)a.blocks,
      (const int*)a.n_active, (typename M::acc_t*)a.partial, a.F, a.N,
      nblocks);
  return cudaGetLastError();
}

template <int MODE, bool RANGED>
int run_hist(const SweepArgs& a, void* hist, int max_bin, cudaStream_t st) {
  using M = ModeT<MODE>;
  cudaError_t e = launch_sweep<MODE, RANGED>(a, st);
  if (e != cudaSuccess) return (int)e;
  const int total = a.F * max_bin * 3;
  reduce_kernel<MODE, RANGED><<<(total + 255) / 256, 256, 0, st>>>(
      (const typename M::acc_t*)a.partial, (const int*)a.n_active,
      (const float*)a.inv_scale, (float*)hist, a.F, max_bin,
      (int)(a.N / ROW_BLOCK));
  return (int)cudaGetLastError();
}

struct FusedArgs {
  const void* parent;
  const void* fmask;
  const void* stats;
  const void* cnts;
  void* hist;
  void* pf_small;
  void* pf_large;
  int max_bin;
  ScanParams s;
};

template <int MODE, bool RANGED>
int run_hist_fused(const SweepArgs& a, const FusedArgs& u, cudaStream_t st) {
  using M = ModeT<MODE>;
  cudaError_t e = launch_sweep<MODE, RANGED>(a, st);
  if (e != cudaSuccess) return (int)e;
  fused_reduce_kernel<MODE, RANGED><<<a.F, NBIN, 0, st>>>(
      (const typename M::acc_t*)a.partial, (const int*)a.n_active,
      (const float*)a.inv_scale, (const float*)u.parent,
      (const uint8_t*)u.fmask, (const float*)u.stats, (const int*)u.cnts,
      (float*)u.hist, (float*)u.pf_small, (float*)u.pf_large, a.F,
      u.max_bin, (int)(a.N / ROW_BLOCK), u.s);
  return (int)cudaGetLastError();
}

template <bool RANGED>
int dispatch(int mode, const SweepArgs& a, void* hist, int max_bin,
             cudaStream_t st) {
  switch (mode) {
    case MODE_F32: return run_hist<MODE_F32, RANGED>(a, hist, max_bin, st);
    case MODE_BF16: return run_hist<MODE_BF16, RANGED>(a, hist, max_bin, st);
    case MODE_I32: return run_hist<MODE_I32, RANGED>(a, hist, max_bin, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool RANGED>
int dispatch_fused(int mode, const SweepArgs& a, const FusedArgs& u,
                   cudaStream_t st) {
  switch (mode) {
    case MODE_F32: return run_hist_fused<MODE_F32, RANGED>(a, u, st);
    case MODE_BF16: return run_hist_fused<MODE_BF16, RANGED>(a, u, st);
    case MODE_I32: return run_hist_fused<MODE_I32, RANGED>(a, u, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// hist [F, max_bin, 3] f32 of the rows of target in the listed blocks;
// `blocks` is block_list [N / 8192] i32 (ranged == 0) or the range start,
// one i32 (ranged != 0); partial is [N / 8192, F, 256, 3] of the mode's
// accumulator type (f32, or i32 in mode 2)
extern "C" int lgbt_hist_blocklist(int ranged, int mode, const void* bins,
                                   long long ldb, const void* gh2,
                                   const void* leaf_eff, const void* target,
                                   const void* blocks, const void* n_active,
                                   const void* inv_scale, void* partial,
                                   int F, long long N, void* hist,
                                   int max_bin, void* stream) {
  SweepArgs a{bins, ldb, gh2, leaf_eff, target, blocks, n_active,
              inv_scale, partial, F, N};
  const cudaStream_t st = (cudaStream_t)stream;
  return ranged ? dispatch<true>(mode, a, hist, max_bin, st)
                : dispatch<false>(mode, a, hist, max_bin, st);
}

// the same sweep, then the split scans of the small child and its sibling
extern "C" int lgbt_hist_blocklist_fused(
    int ranged, int mode, const void* bins, long long ldb, const void* gh2,
    const void* leaf_eff, const void* target, const void* blocks,
    const void* n_active, const void* inv_scale, void* partial, int F,
    long long N, const void* parent, const void* fmask, const void* stats,
    const void* cnts, void* hist, void* pf_small, void* pf_large,
    int max_bin, int min_data, float min_hess, float l1, float l2,
    float min_gain, void* stream) {
  SweepArgs a{bins, ldb, gh2, leaf_eff, target, blocks, n_active,
              inv_scale, partial, F, N};
  FusedArgs u{parent, fmask, stats, cnts, hist, pf_small, pf_large, max_bin,
              ScanParams{min_data, min_hess, l1, l2, min_gain}};
  const cudaStream_t st = (cudaStream_t)stream;
  return ranged ? dispatch_fused<true>(mode, a, u, st)
                : dispatch_fused<false>(mode, a, u, st);
}
