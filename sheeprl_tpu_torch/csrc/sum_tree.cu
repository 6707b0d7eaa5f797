// The prioritized-replay sum-tree for Hopper (sm_90a), with a plain C interface
// bound through ctypes (sheeprl_tpu_torch/ops/per.py builds and loads it).
//
// Replaces the five Pallas kernels of sheeprl_tpu/ops/pallas_per.py:
//   _sample_kernel  (the pallas_call of sum_tree_sample)  -> sheeprl_sum_tree_sample
//   _write_kernel   (the pallas_call of sum_tree_write)   -> sheeprl_sum_tree_write
//   _update_kernel  (the pallas_call of sum_tree_update)  -> the same entry point
//                   with the running-max fold switched on
//   _descend_kernel (the pallas_call of sum_tree_descend) -> sheeprl_sum_tree_descend
//   _write_kernel   (the pallas_call of sum_tree_scatter) -> sheeprl_sum_tree_write
//                   with the shard's ids and rank
//
// The tree is a 1-based heap of 2P f32 (P = 2^depth leaves): the root, the
// total mass, at 1, leaf l at P + l, slot 0 unused.
//
// Sample: n proportional draws.  For draw i, with E excluded leaves excl[e]
// (active where eact[e]) of mass emass[e] = tree[P + excl[e]]:
//   total = tree[1] - sum_e emass[e];  u = r01[i] * total
//   d levels: left = tree[c] - corr(c) for the left child c = 2 node, where
//             corr(c) sums, from 0 and in exclusion-index order, the masses of
//             the active exclusions under c; go right when u >= left (then
//             u -= left)
//   w = (max(count, 1) * max(mass, tiny) / max(total, tiny))^-beta,  w /= max_i w
// The exclusions are corrections inside the descent: the stored tree is not
// written.  Without exclusions the arithmetic is op for op the lax descent's,
// so the leaves are identical to it.  Every product and difference is
// rounded on its own (__fmul_rn/__fsub_rn/__fadd_rn): a fused multiply-add of
// r01 * total - left would move a draw that lands within an ulp of a subtree
// boundary.
//
// Descend: the same corrected descent for u given (already placed in this
// tree's mass interval by the caller: one shard's sub-tree of the env-sharded
// prioritized replay), returning each draw's leaf and its stored mass; no
// total and no weights.  Sample and descend are one kernel, draw_kernel.
//
// What bounds the draws on an H100.  Not the bytes: each draw's path once
// is under a microsecond at 3.35 TB/s, less than one launch.  A draw is a
// walk of d = 18-20 dependent reads through a tree of 1-8 MB that sits in
// the 50 MB L2; with every lane of a warp on its own path below the top
// levels, each load instruction costs 32 L1 wavefronts and an L2 round trip.
// So the time is a few microseconds of fixed cost (the launch, each block's
// prologue, the weights' batch max) plus the walk, and the host's wrapper
// time, about three times the device time, weighs as much as both.
//
// What the design does about it.
// - The top S levels (S = depth up to kTopMax = 10, else depth less a
//   multiple of kRound, so that what is left below is whole rounds) are
//   slots [0, 2^(S+1)) of the heap, one contiguous 16-byte-aligned range:
//   thread 0 of each block copies them into shared memory with one bulk
//   asynchronous copy (cp.async.bulk, completing on an mbarrier), and a
//   draw decides its first S levels from shared memory.
// - Below level S, kRound = 2 levels a memory round trip: the left children
//   of node v's descendants j levels down lie in slots [2^j v, 2^j (v + 1)),
//   so a draw issues a float2 and a float4 load for the next two levels
//   before it uses either, then resolves both in registers with the same
//   comparisons: half the round trips for the same load instructions and L2
//   sectors.  (Rounds of 3 and 4 levels need 4 and 8 load instructions; on
//   the card they were no faster.)  The last round's loads hold the leaf,
//   whose stored mass is then read from registers.  At depth 20 a draw
//   makes 10 decisions from shared memory and 5 round trips to L2.
// - Corrections once a call, not once a draw and level.  With E > 0
//   exclusions a pre-pass kernel builds, in the caller's scratch, the
//   corrected top (one thread a top slot: every left child of the top S
//   levels less the masses of the exclusions under it, summed in index
//   order, and the root less all of them, the total; an untouched node keeps
//   tree[c], as tree[c] - 0 is) and the exclusions sorted stably by their
//   level-S node (their bucket), so that index order holds within a bucket
//   (one thread an exclusion, its stable rank).  The draws copy the
//   corrected top instead of the tree's, and below level S a draw scans only
//   its own bucket, found by binary search; at the paths' E (4, 63, 252) a
//   bucket holds 0-1 of them.  Each precomputed value is the number the
//   per-draw loop would produce: the same f32 operations in the same order.
//   Any E works; a call is two launches then.
// - The batch max of the weights needs no zeroed output and no second
//   launch: the sample is a cooperative launch of at most as many blocks as
//   the card holds at once (occupancy x SMs, at most kMaxBlocks), each a
//   grid-stride loop over the draws.  Each block writes its max to the
//   scratch's header, one grid barrier, and every block divides its own
//   weights by the max of those.  Nothing in the scratch has to hold a value
//   on entry, so a caller keeps one and never clears it.  The scratch's size
//   is the library's (sheeprl_sum_tree_draw_scratch_bytes), and a call with
//   a smaller one is refused.

// Write/update/scatter (#6, #7, #9: one entry point, sheeprl_sum_tree_write,
// JAX's _write_body semantics): set leaf[i] to values[i] for the lanes that
// are on (active, and for a shard's scatter owned by the shard:
// shard_ids[i] == rank), then rebuild the touched ancestors, and only those,
// bottom-up as __fadd_rn(tree[2v], tree[2v + 1]); a node that no lane
// touches keeps its bits, even where it is not the sum of its children.  A
// leaf given by several lanes takes the value of the LAST of them (the
// highest lane index), what XLA's scatter keeps on the CPU.  Off lanes write
// nothing.  An update also gives new_max = max(max_p, max_i where(on,
// values, 0)); a scatter the shard's candidate max, the same fold from -inf.
// The maxima do not depend on the order, so they are exact.
//
// What bounds a write on an H100.  Not the bytes (a flush of 256 lanes
// moves a few kilobytes; a TD update of 16,384 lanes on 2^20 leaves about
// 0.7 MB, 0.2 us), but latency: d + 1 dependent levels a lane, and the
// paths of lanes that meet.  The first port was depth + 2 launches (claim,
// leaves, one a level: 20-22 a call); its device time was launch gaps and
// one L2 round trip a level, its host time 20-22 enqueues.
//
// What the design does about it: one launch a call, its method chosen from
// n (kBlockLanes is the boundary).
// - n <= kBlockLanes (the flushes: 256 and 1,024 lanes): write_block_kernel,
//   one block.  The on lanes' (leaf, lane) keys are sorted in shared memory
//   (a bitonic sort over as few threads as hold them), so the last lane of a
//   leaf is the last of its run; each winner loads all d stored siblings of
//   its path in one round trip, and the warps walk up in lockstep: where two
//   paths meet, the touched nodes of a level are neighbours in the sorted
//   list, and the left one takes the right one's sum by a shuffle (or from
//   shared memory, from another warp); no block barrier a level.  The owner
//   scratch is not used.
// - More lanes (the TD updates: 16,384 and 65,536): write_grid_kernel, one
//   cooperative launch of at most one block for every two SMs, up to 1,024
//   threads a block.  The claim (an atomic max of the lane index into the
//   scratch `owner`), a grid barrier, the leaves (the winner clears its
//   claim), then one grid barrier a level up to the first level of at most
//   kTopNodes nodes; there block 0 finishes the top in shared memory from
//   marks the lanes leave in `owner`, and resets them.  (On the card a top
//   of 2^11 nodes did best at 16,384 lanes; larger tops gained a little at
//   65,536 and lost more at fewer lanes, smaller ones lost at both.)
// `owner` (P int32) is -1 on entry and on exit, so a caller keeps one a
// tree and never clears it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPrepassChunk = 1024;  // the pre-pass stages exclusions in shared memory this many at a time
constexpr int kMaxDepth = 30;
constexpr int kTopMax = 10;       // most levels decided from shared memory: 2^11 slots, 8 KB
constexpr int kRound = 2;         // levels below them a memory round trip (a float2 and a float4)
constexpr int kSmemSorted = 2048; // most sorted exclusions staged in shared memory (more are read from L2)
constexpr int kMaxBlocks = 1024;  // most blocks of a sample: the scratch's header holds one max each
// the draws' scratch: the blocks' maxima, then the pre-pass's corrected top
// and sorted exclusions
constexpr int kHeaderBytes = 4 * kMaxBlocks;
static_assert(kHeaderBytes % 16 == 0, "the corrected top after the header is copied in bulk");
// draw_kernel's most dynamic shared memory: the top and the staged exclusions
constexpr int kMaxSmem = 4 * (2 << kTopMax) + 8 * kSmemSorted;
static_assert(kMaxSmem <= 48 * 1024, "draw_kernel needs no opt-in to more shared memory");

inline __host__ __device__ int top_levels(int depth) {
  return depth <= kTopMax ? depth : depth - kRound * ((depth - kTopMax + kRound - 1) / kRound);
}

// max over f32 by integer atomics, exact for every pair of ordered floats:
// non-negative floats order like their int bits, negative ones inversely to
// their unsigned bits
__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  if (!signbit(v)) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

// ---------------------------------------------------------------- mbarrier / bulk copy
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned phase) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16) from 16-byte-aligned global src to shared dst
__device__ __forceinline__ void bulk_copy_g2s(unsigned dst, const void* src, unsigned bytes, unsigned bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// ---------------------------------------------------------------- exclusions
// Exclusion e as the draws use it: its heap node and mass, both 0 where
// inactive (node 0 is no node's ancestor, and a mass of 0 adds nothing).
__device__ __forceinline__ void load_exclusion(const float* __restrict__ tree, int p, const int* __restrict__ excl,
                                               const uint8_t* __restrict__ eact, int e, int& enode, float& emass) {
  const bool act = eact == nullptr || eact[e] != 0;
  const int en = excl[e] + p;
  enode = act ? en : 0;
  emass = act ? tree[en] : 0.0f;
}

// Stable rank of exclusion e by its level-S node (its bucket key): the
// exclusions before it in the sorted order, over m of them staged at base.
__device__ __forceinline__ int rank_part(const int* s_enode, int m, int base, int e, int key, int key_shift) {
  int r = 0;
  for (int j = 0; j < m; ++j) {
    const int kj = s_enode[j] >> key_shift;
    r += (kj < key) | ((kj == key) & (base + j < e));
  }
  return r;
}

// The pre-pass: items [0, 2^(S+1)) are the top's slots, written to top_out
// corrected; items above, one an exclusion, write the exclusions sorted
// stably by bucket.  Every thread of the block reaches every barrier (the
// chunk loop's trip count is the same for all).
__global__ void __launch_bounds__(kThreads) prepass_kernel(
    const float* __restrict__ tree, int depth, const int* __restrict__ excl, const uint8_t* __restrict__ eact,
    int n_excl, float* __restrict__ top_out, int* __restrict__ sorted_enode, float* __restrict__ sorted_emass) {
  __shared__ int s_enode[kPrepassChunk];
  __shared__ float s_emass[kPrepassChunk];
  const int p = 1 << depth;
  const int top = top_levels(depth);
  const int key_shift = depth - top;
  const int n_slots = 2 << top;
  const int item = blockIdx.x * blockDim.x + threadIdx.x;
  // a slot's correction: the root (the total) and every left child; a right
  // child is never a left value and is copied
  const bool slot = item < n_slots;
  const bool summed = slot && (item == 1 || (item > 1 && (item & 1) == 0));
  const int shift = summed ? depth - (31 - __clz(item)) : 0;
  const int e = item - n_slots;
  const bool ranked = !slot && depth > top && e < n_excl;
  int my_node = 0, my_key = 0;
  float my_mass = 0.0f;
  if (ranked) {
    load_exclusion(tree, p, excl, eact, e, my_node, my_mass);
    my_key = my_node >> key_shift;
  }
  float corr = 0.0f;
  int rank = 0;
  for (int base = 0; base < n_excl; base += kPrepassChunk) {
    const int m = min(kPrepassChunk, n_excl - base);
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += blockDim.x) load_exclusion(tree, p, excl, eact, base + j, s_enode[j], s_emass[j]);
    __syncthreads();
    if (summed) {
      for (int j = 0; j < m; ++j) {
        if ((s_enode[j] >> shift) == item) corr = __fadd_rn(corr, s_emass[j]);
      }
    } else if (ranked) {
      rank += rank_part(s_enode, m, base, e, my_key, key_shift);
    }
  }
  if (slot) {
    top_out[item] = item == 0 ? 0.0f : __fsub_rn(tree[item], corr);
  } else if (ranked) {
    sorted_enode[rank] = my_node;
    sorted_emass[rank] = my_mass;
  }
}

inline __host__ __device__ size_t draw_scratch_bytes(int depth, int n_excl) {
  return kHeaderBytes + (n_excl > 0 ? sizeof(float) * (2 << top_levels(depth)) + 8 * static_cast<size_t>(n_excl) : 0);
}

// left less the masses of the bucket's exclusions under child (from 0, in
// index order); left itself when the bucket is empty
__device__ __forceinline__ float bucket_corrected(float left, int child, int shift, int lo, int hi, const int* sn,
                                                  const float* sm) {
  if (lo >= hi) return left;
  float corr = 0.0f;
  for (int m = lo; m < hi; ++m) {
    if ((sn[m] >> shift) == child) corr = __fadd_rn(corr, sm[m]);
  }
  return __fsub_rn(left, corr);
}

// first index in [0, n) whose bucket key is >= key (strict: > key)
__device__ __forceinline__ int bucket_bound(const int* sn, int n, int key, int key_shift, bool strict) {
  int a = 0, b = n;
  while (a < b) {
    const int mid = (a + b) >> 1;
    const int k = sn[mid] >> key_shift;
    if (k < key || (strict && k == key)) {
      a = mid + 1;
    } else {
      b = mid;
    }
  }
  return a;
}

// q's element off (0-3)
__device__ __forceinline__ float pick4(float4 q, int off) {
  return (off & 2) ? ((off & 1) ? q.w : q.z) : ((off & 1) ? q.y : q.x);
}

// Sample (kSample) or descend, a grid-stride loop over the draws.  in: r01
// or u; out: w or the stored mass.  top_src: the tree, or the pre-pass's
// corrected top; sorted_*: the pre-pass's sorted exclusions.  Shared memory:
// the top (2^(S+1) f32), then the sorted exclusions staged (2 E words) when
// there are levels below the top and at most kSmemSorted of them.  bmax: a
// sample's blocks' maxima (a cooperative launch).
template <bool kSample>
__global__ void __launch_bounds__(kThreads, 2) draw_kernel(
    const float* __restrict__ tree, int depth, const float* __restrict__ in, int n, float beta, float count,
    int n_excl, const float* __restrict__ top_src, const int* __restrict__ sorted_enode,
    const float* __restrict__ sorted_emass, int* __restrict__ leaf_out, float* __restrict__ out, float* bmax) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) unsigned long long bar;
  __shared__ float s_red[kThreads / 32];
  const int p = 1 << depth;
  const int top = top_levels(depth);
  const int n_slots = 2 << top;
  float* s_top = reinterpret_cast<float*>(smem);
  const bool below = depth > top;
  const bool staged = below && n_excl <= kSmemSorted;
  int* s_sn = reinterpret_cast<int*>(s_top + n_slots);
  float* s_sm = reinterpret_cast<float*>(s_sn + n_excl);
  const int* sn = staged ? s_sn : sorted_enode;
  const float* sm = staged ? s_sm : sorted_emass;

  const unsigned bar_addr = smem_u32(&bar);
  if (threadIdx.x == 0) {
    mbar_init(bar_addr, 1);
    mbar_arrive_expect_tx(bar_addr, 4u * n_slots);
    bulk_copy_g2s(smem_u32(s_top), top_src, 4u * n_slots, bar_addr);
  }
  if (staged) {  // while the copy flies
    for (int e = threadIdx.x; e < n_excl; e += blockDim.x) {
      s_sn[e] = sorted_enode[e];
      s_sm[e] = sorted_emass[e];
    }
  }
  __syncthreads();  // the barrier is initialised and the exclusions staged
  mbar_wait(bar_addr, 0);

  const int key_shift = depth - top;
  const float total = s_top[1];
  const int stride = gridDim.x * kThreads;
  float m = 0.0f;  // this thread's largest weight (weights are positive)
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    float u = kSample ? __fmul_rn(in[i], total) : in[i];
    int node = 1;
    for (int lvl = 0; lvl < top; ++lvl) {
      const int child = 2 * node;
      const float left = s_top[child];
      const bool right = u >= left;
      if (right) u = __fsub_rn(u, left);
      node = child + (right ? 1 : 0);
    }
    float mass;
    if (below) {
      int lo = 0, hi = 0;
      // one decision: left child `child` of the node, its stored value
      // `stored`, corrected by the draw's bucket
      auto decide = [&](int child, float stored, int shift) {
        const float left = bucket_corrected(stored, child, shift, lo, hi, sn, sm);
        const bool right = u >= left;
        if (right) u = __fsub_rn(u, left);
        node = child + (right ? 1 : 0);
      };
      float4 b = {};
      for (int lvl = top; lvl < depth; lvl += kRound) {
        const int v = node;
        const size_t vs = static_cast<size_t>(v);
        // the next two levels under v, slots [2v, 2v + 2) and [4v, 4v + 4),
        // loaded before either is used
        const float2 a = __ldg(reinterpret_cast<const float2*>(tree + 2 * vs));
        b = __ldg(reinterpret_cast<const float4*>(tree + 4 * vs));
        if (lvl == top && n_excl > 0) {  // this draw's bucket, found while the loads fly
          lo = bucket_bound(sn, n_excl, v, key_shift, false);
          hi = bucket_bound(sn, n_excl, v, key_shift, true);
        }
        decide(2 * v, a.x, depth - 1 - lvl);
        decide(2 * node, (2 * node - 4 * v) ? b.z : b.x, depth - 2 - lvl);
      }
      mass = pick4(b, node & 3);  // the leaf is in the last round's float4: its stored mass
    } else {
      mass = __ldg(tree + node);  // the shared top's leaves may be corrected
    }
    leaf_out[i] = node - p;
    float val = mass;
    if (kSample) {
      const float probs = __fdiv_rn(fmaxf(mass, FLT_MIN), fmaxf(total, FLT_MIN));
      val = powf(__fmul_rn(fmaxf(count, 1.0f), probs), -beta);
      m = fmaxf(m, val);
    }
    out[i] = val;
  }
  if constexpr (kSample) {
    // the batch max: each block's, one grid barrier, then the max of those
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int k = 1; k < kThreads / 32; ++k) m = fmaxf(m, s_red[k]);
      bmax[blockIdx.x] = m;
    }
    cooperative_groups::this_grid().sync();
    if (threadIdx.x < 32) {
      float g = 0.0f;
      for (int k = threadIdx.x; k < gridDim.x; k += 32) g = fmaxf(g, __ldcg(bmax + k));
      for (int o = 16; o > 0; o >>= 1) g = fmaxf(g, __shfl_xor_sync(0xffffffffu, g, o));
      if (threadIdx.x == 0) s_red[0] = g;
    }
    __syncthreads();
    const float wmax = s_red[0];
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) out[i] = __fdiv_rn(out[i], wmax);
  }
}

// blocks of kThreads for n lanes
inline unsigned blocks_for(int n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

// The blocks of a sample that the current device holds at once (at the most
// shared memory a draw block takes), at most kMaxBlocks: once a device.
cudaError_t resident_blocks(int& blocks) {
  constexpr int kDevices = 64;
  static int cached[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && cached[dev] > 0) {
    blocks = cached[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, draw_kernel<true>, kThreads, kMaxSmem);
  }
  if (err != cudaSuccess) return err;
  blocks = sms * per_sm < kMaxBlocks ? sms * per_sm : kMaxBlocks;
  if (blocks < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (dev < kDevices) cached[dev] = blocks;
  return cudaSuccess;
}

// The draw's launches: the pre-pass when E > 0, then draw_kernel (for a
// sample, cooperative).  scratch: the header, then the pre-pass's corrected
// top and sorted exclusions.
template <bool kSample>
int launch_draw(const float* tree, int depth, const float* in, int n, float beta, float count, const int* excl,
                const uint8_t* eact, int n_excl, int* leaf, float* out, void* scratch, size_t scratch_bytes,
                cudaStream_t s) {
  if (depth < 1 || depth > kMaxDepth || n < 0 || n_excl < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(tree) % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  if (n == 0) return 0;
  const bool pre = n_excl > 0;
  if (kSample || pre) {
    if (scratch == nullptr || scratch_bytes < draw_scratch_bytes(depth, n_excl)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (reinterpret_cast<uintptr_t>(scratch) % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const int top = top_levels(depth);
  const int n_slots = 2 << top;
  unsigned char* base = static_cast<unsigned char*>(scratch);
  float* top_scratch = pre ? reinterpret_cast<float*>(base + kHeaderBytes) : nullptr;
  int* sorted_enode = pre ? reinterpret_cast<int*>(top_scratch + n_slots) : nullptr;
  float* sorted_emass = pre ? reinterpret_cast<float*>(sorted_enode + n_excl) : nullptr;
  if (pre) {
    const int items = n_slots + (depth > top ? n_excl : 0);
    prepass_kernel<<<blocks_for(items), kThreads, 0, s>>>(tree, depth, excl, eact, n_excl, top_scratch, sorted_enode,
                                                          sorted_emass);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool staged = depth > top && n_excl <= kSmemSorted;
  const size_t smem = sizeof(float) * n_slots + (staged ? 8 * static_cast<size_t>(n_excl) : 0);
  const float* top_src = pre ? top_scratch : tree;
  if (!kSample) {
    draw_kernel<false><<<blocks_for(n), kThreads, smem, s>>>(tree, depth, in, n, beta, count, n_excl, top_src,
                                                             sorted_enode, sorted_emass, leaf, out, nullptr);
    return static_cast<int>(cudaGetLastError());
  }
  int resident = 0;
  cudaError_t err = resident_blocks(resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = blocks_for(n) < static_cast<unsigned>(resident) ? blocks_for(n) : resident;
  cudaLaunchAttribute coop;
  coop.id = cudaLaunchAttributeCooperative;
  coop.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &coop;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, draw_kernel<true>, tree, depth, in, n, beta, count, n_excl, top_src,
                           static_cast<const int*>(sorted_enode), static_cast<const float*>(sorted_emass), leaf, out,
                           reinterpret_cast<float*>(base));
  return static_cast<int>(err);
}

// ---------------------------------------------------------------- writes
constexpr int kBlockLanes = 1024;   // most lanes of the one-block write: one a thread
constexpr int kTopLevels = 11;      // the grid write hands the levels of at most 2^11 nodes to one block
constexpr int kTopNodes = 1 << kTopLevels;
constexpr int kTopBytes = 5 * 2 * kTopNodes;  // the top block's slots (f32) and touched flags
constexpr int kWriteThreads = 1024; // most threads of a grid-write block (at least 256)
constexpr int kMark = -2;           // an owner slot marking a touched node for the top (no lane's index)

// a lane writes when it is active and, for a shard's scatter (shard_ids not
// null), owned by the shard
__device__ __forceinline__ bool lane_on(const uint8_t* __restrict__ active, const int* __restrict__ shard_ids,
                                        int rank, int i) {
  return active[i] != 0 && (shard_ids == nullptr || shard_ids[i] == rank);
}

// The largest v of the block (a multiple of 32 threads), in thread 0 (every
// thread calls it).
__device__ __forceinline__ float block_max(float v, float* s_red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < static_cast<int>(blockDim.x / 32); ++k) v = fmaxf(v, s_red[k]);
  }
  return v;
}

// A named barrier over the first `threads` threads of the block (a multiple
// of 32): the threads past them have left the kernel.
__device__ __forceinline__ void bar_first(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// How many of the block's threads before this one (of the first `threads`)
// have flag set, and in *total how many of them have: a ballot a warp, the
// warps' counts in s_warp, one barrier (bar_first(threads), or the whole
// block's when threads is blockDim.x).
__device__ __forceinline__ int count_before(bool flag, int threads, int* s_warp, int* total) {
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_warp[warp] = __popc(ballot);
  if (threads == static_cast<int>(blockDim.x)) {
    __syncthreads();
  } else {
    bar_first(threads);
  }
  int before = __popc(ballot & ((1u << lane) - 1)), all = 0;
  for (int w = 0; w < threads / 32; ++w) {
    const int c = s_warp[w];
    before += w < warp ? c : 0;
    all += c;
  }
  *total = all;
  return before;
}

// The write of at most kBlockLanes lanes, lane t on thread t: one block, no
// owner scratch.
// 1. The on lanes are compacted, and their keys (leaf << 32 | lane) sorted
//    by a bitonic sort over the first N = max(32, next power of two) threads
//    (shuffles within a warp, a named barrier a step across warps): the
//    last lane of a leaf is the last of its run, so it is the leaf's writer
//    (the winner).  The winners, compacted again, are the written leaves in
//    ascending order at positions [0, m), position q on thread q.
// 2. Each winner loads the stored sibling of every node on its leaf's path at
//    once (one round trip) and writes its leaf; then the warps walk up, each
//    in lockstep over its 32 positions, with no block barrier.  At level k
//    the touched nodes are the distinct (leaf + P) >> k, in order: runs of
//    positions, each carried by the thread of its first position, which
//    holds the node's new sum and the run's end.  A left child's run whose
//    right sibling is touched takes that sibling's sum and end from the run
//    that starts at its end: by a shuffle in its warp, else from shared
//    memory, where the right run publishes them at that level (a wait on
//    another warp, which never waits on this one: waits go rightward).  The
//    right run stops there; every other run adds its stored sibling.
//    Nothing but the paths' siblings is read from the tree, and each touched
//    node is written once.
__global__ void __launch_bounds__(kBlockLanes) write_block_kernel(
    float* __restrict__ tree, int depth, const int* __restrict__ leaf, const float* __restrict__ values,
    const uint8_t* __restrict__ active, const int* __restrict__ shard_ids, int rank, int n,
    const float* __restrict__ max_in, float max_in_value, float* __restrict__ max_out) {
  __shared__ unsigned long long s_key[2][kBlockLanes];
  __shared__ unsigned s_won[kBlockLanes];  // the written leaves, ascending
  __shared__ unsigned s_lane[kBlockLanes]; // their winning lanes
  // a run's hand-over at its first position: its sum's bits | its end << 32,
  // one 64-bit word, so a reader that sees the end sees the sum (kOpen: none yet)
  __shared__ unsigned long long s_pub[kBlockLanes];
  __shared__ int s_warp[2][kBlockLanes / 32];
  __shared__ float s_red[kBlockLanes / 32];
  extern __shared__ float s_sib[];  // the winners' stored siblings: depth x (m rounded up to 32)
  constexpr unsigned long long kIdle = ~0ull;
  constexpr unsigned long long kOpen = ~0ull;
  const int t = threadIdx.x;
  const unsigned p = 1u << depth;
  const bool on = t < n && lane_on(active, shard_ids, rank, t);
  if (max_out != nullptr) {
    const float m = block_max(t < n ? (on ? values[t] : 0.0f) : -INFINITY, s_red);
    if (t == 0) *max_out = fmaxf(max_in != nullptr ? *max_in : max_in_value, m);
  }
  int m_on = 0;
  const int slot = count_before(on, kBlockLanes, s_warp[0], &m_on);
  if (on) s_key[0][slot] = (static_cast<unsigned long long>(leaf[t]) << 32) | static_cast<unsigned>(t);
  __syncthreads();
  if (m_on == 0) return;
  unsigned long long x = t < m_on ? s_key[0][t] : kIdle;
  // lanes that come in leaf order (a flush's window does) need no sort
  const bool sorted = !__syncthreads_or(t + 1 < m_on && s_key[0][t + 1] < x);
  int threads = 32;
  while (threads < m_on) threads <<= 1;
  if (t >= threads) return;  // the rest synchronise by bar_first(threads)
  int buf = 1;
  for (int k = 2; k <= (sorted ? 1 : threads); k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      unsigned long long y;
      if (j >= 32) {
        s_key[buf][t] = x;
        bar_first(threads);
        y = s_key[buf][t ^ j];
        buf ^= 1;
      } else {
        y = __shfl_xor_sync(0xffffffffu, x, j);
      }
      const bool keep_min = ((t & j) == 0) == ((t & k) == 0);
      x = keep_min ? (x < y ? x : y) : (x < y ? y : x);
    }
  }
  s_key[buf][t] = x;
  bar_first(threads);
  const unsigned long long next = t + 1 < threads ? s_key[buf][t + 1] : kIdle;
  const bool win = x != kIdle && (next >> 32) != (x >> 32);
  int m = 0;
  const int pos = count_before(win, threads, s_warp[1], &m);
  if (win) {
    s_won[pos] = static_cast<unsigned>(x >> 32);
    s_lane[pos] = static_cast<unsigned>(x);
    s_pub[pos] = kOpen;
  }
  bar_first(threads);
  if (t >= ((m + 31) & ~31)) return;

  volatile unsigned long long* pub = s_pub;
  const bool mine = t < m;
  const unsigned node = (mine ? s_won[t] : 0u) + p;
  float cur = mine ? values[s_lane[t]] : 0.0f;
  bool alive = mine;
  int end = t + 1;
  const int lane = t & 31;
  const int warp0 = t - lane;
  const int width = (m + 31) & ~31;
  float* sib = s_sib + t;  // level k's stored sibling at sib[k * width]
  if (mine) {
    for (int k = 0; k < depth; ++k) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(sib + k * width)),
                   "l"(tree + ((node >> k) ^ 1u))
                   : "memory");
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    tree[node] = cur;
  }
  for (int k = 0; k < depth; ++k) {
    // every lane of the warp runs each step (the dead ones and those past m
    // too), so the shuffles find the warp converged
    const unsigned v = node >> k;
    const bool left = (v & 1u) == 0;
    const bool pair = alive && left && end < m && ((s_won[end < m ? end : 0] + p) >> k) == v + 1;
    const bool give = alive && !left && t > 0 && ((s_won[t > 0 ? t - 1 : 0] + p) >> k) == v - 1;
    if (give) pub[t] = (static_cast<unsigned long long>(end) << 32) | __float_as_uint(cur);
    const bool here = pair && end - warp0 < 32;
    const int src = here ? end - warp0 : lane;
    __syncwarp();
    const float their_cur = __shfl_sync(0xffffffffu, cur, src);
    const int their_end = __shfl_sync(0xffffffffu, end, src);
    float right = here ? their_cur : sib[k * width];
    int next_end = here ? their_end : end;
    if (pair && !here) {  // the right sibling's run is in a later warp
      unsigned long long w;
      do {
        w = pub[end];
      } while (w == kOpen);
      right = __uint_as_float(static_cast<unsigned>(w));
      next_end = static_cast<int>(w >> 32);
    }
    if (alive && !give) {
      cur = left ? __fadd_rn(cur, right) : __fadd_rn(right, cur);
      end = next_end;
      tree[v >> 1] = cur;
    }
    alive = alive && !give;
  }
}

// The write of more lanes: one cooperative grid-stride launch of at most one
// block for every two SMs.  The claim (each on lane's atomic max of its index
// into owner[leaf]), a grid barrier, the leaves (the claim's winner writes its
// value and clears the claim), then levels 1..S, each behind a grid barrier,
// every on lane rebuilding its node at the level (lanes that meet write the
// same sum).  Level S is the first of at most kTopNodes nodes; its lanes
// mark their nodes in owner[0, 2^(depth - S)) (-1 after the leaves), and
// after one more barrier block 0 finishes the top in shared memory: the
// top's stored slots and the marks in, each level's touched nodes (a node
// is touched when a child is) rebuilt from their children, the marks reset
// to -1.
__global__ void __launch_bounds__(kWriteThreads) write_grid_kernel(
    float* tree, int depth, const int* __restrict__ leaf, const float* __restrict__ values,
    const uint8_t* __restrict__ active, const int* __restrict__ shard_ids, int rank, int n, int* owner,
    const float* __restrict__ max_in, float max_in_value, float* max_out) {
  extern __shared__ __align__(16) unsigned char top_smem[];  // block 0's: kTopBytes
  __shared__ float s_red[kWriteThreads / 32];
  float* s_top = reinterpret_cast<float*>(top_smem);
  unsigned char* s_touched = top_smem + sizeof(float) * 2 * kTopNodes;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int p = 1 << depth;
  const int top = depth > kTopLevels ? depth - kTopLevels : 0;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  float mx = -INFINITY;
  for (int i = first; i < n; i += stride) {
    const bool on = lane_on(active, shard_ids, rank, i);
    if (on) atomicMax(owner + leaf[i], i);
    mx = fmaxf(mx, on ? values[i] : 0.0f);
  }
  if (max_out != nullptr) {
    mx = block_max(mx, s_red);
    if (blockIdx.x == 0 && threadIdx.x == 0) *max_out = max_in != nullptr ? *max_in : max_in_value;
  }
  grid.sync();
  if (max_out != nullptr && threadIdx.x == 0) atomic_max_f32(max_out, mx);
  for (int i = first; i < n; i += stride) {
    if (!lane_on(active, shard_ids, rank, i)) continue;
    const int l = leaf[i];
    if (__ldcg(owner + l) == i) {  // other lanes of leaf l read i, -1 or kMark here, never their own index
      tree[p + l] = values[i];
      owner[l] = top == 0 ? kMark : -1;
    }
  }
  for (int k = 1; k <= top; ++k) {
    grid.sync();
    for (int i = first; i < n; i += stride) {
      if (!lane_on(active, shard_ids, rank, i)) continue;
      const int v = (leaf[i] + p) >> k;
      tree[v] = __fadd_rn(__ldcg(tree + 2 * v), __ldcg(tree + 2 * v + 1));
      if (k == top) owner[v - (p >> top)] = kMark;
    }
  }
  grid.sync();
  if (blockIdx.x != 0) return;
  const int base = p >> top;  // level S's first node, and its node count
  for (int s = threadIdx.x + 1; s < 2 * base; s += blockDim.x) {
    s_top[s] = __ldcg(tree + s);
    s_touched[s] = s >= base && __ldcg(owner + (s - base)) == kMark;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < base; s += blockDim.x) owner[s] = -1;
  for (int half = base >> 1; half >= 1; half >>= 1) {  // the level of `half` nodes
    for (int v = half + threadIdx.x; v < 2 * half; v += blockDim.x) {
      const bool touched = s_touched[2 * v] | s_touched[2 * v + 1];
      s_touched[v] = touched;
      if (touched) {
        const float x = __fadd_rn(s_top[2 * v], s_top[2 * v + 1]);
        s_top[v] = x;
        tree[v] = x;
      }
    }
    __syncthreads();
  }
}

// Once a device: the one-block write's shared memory above 48 KB allowed,
// and the grid write's most blocks: half the SMs (a grid barrier's cost grows
// with the blocks it waits for: on the card, fewer blocks of more threads did
// better at 65,536 lanes), checked to be co-resident at the most threads a
// block.
constexpr int kBlockSibBytes = 4 * kMaxDepth * kBlockLanes;  // write_block_kernel's most dynamic shared memory
cudaError_t write_setup(int& blocks) {
  constexpr int kDevices = 64;
  static int cached[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && cached[dev] > 0) {
    blocks = cached[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(write_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBlockSibBytes);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, write_grid_kernel, kWriteThreads, kTopBytes);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1 || sms < 1) return cudaErrorCooperativeLaunchTooLarge;
  blocks = sms > 1 ? sms / 2 : 1;
  if (dev < kDevices) cached[dev] = blocks;
  return cudaSuccess;
}

// One launch for any n: write_block_kernel for n <= kBlockLanes, else
// write_grid_kernel (cooperative).  max_out: null, or the folded max
// max(*max_in (max_in_value when max_in is null), max_i where(on, values, 0)).
int launch_write(float* tree, int depth, const int* leaf, const float* values, const uint8_t* active,
                 const int* shard_ids, int rank, int n, int* owner, const float* max_in, float max_in_value,
                 float* max_out, cudaStream_t s) {
  if (depth < 1 || depth > kMaxDepth || n < 0 || owner == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  int blocks = 0;
  cudaError_t err = write_setup(blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= kBlockLanes) {
    const size_t sib_bytes = 4 * static_cast<size_t>(depth) * ((n + 31) & ~31);
    write_block_kernel<<<1, kBlockLanes, sib_bytes, s>>>(tree, depth, leaf, values, active, shard_ids, rank, n, max_in,
                                                         max_in_value, max_out);
    return static_cast<int>(cudaGetLastError());
  }
  // a lane a thread where the blocks allow, at least 256 threads a block
  int threads = (n + blocks - 1) / blocks;
  threads = threads < 256 ? 256 : threads > kWriteThreads ? kWriteThreads : (threads + 31) & ~31;
  const unsigned want = (static_cast<unsigned>(n) + threads - 1) / threads;
  cudaLaunchAttribute coop;
  coop.id = cudaLaunchAttributeCooperative;
  coop.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(want < static_cast<unsigned>(blocks) ? want : blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = kTopBytes;
  cfg.stream = s;
  cfg.attrs = &coop;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, write_grid_kernel, tree, depth, leaf, values, active, shard_ids, rank, n, owner,
                           max_in, max_in_value, max_out);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// The bytes of a draw scratch for a tree of depth and n_excl exclusions (0
// for a depth out of range).
size_t sheeprl_sum_tree_draw_scratch_bytes(int depth, int n_excl) {
  return depth < 1 || depth > kMaxDepth || n_excl < 0 ? 0 : draw_scratch_bytes(depth, n_excl);
}

// leaf/w are (n,) outputs.  scratch: scratch_bytes of room, at least
// sheeprl_sum_tree_draw_scratch_bytes(depth, n_excl), 16-byte aligned; no
// value in it is read before the call writes it.  eact may be null (all
// active).  Returns the CUDA error of the launches (0 on success).
int sheeprl_sum_tree_sample(const float* tree, int depth, const float* r01, int n, float beta, float count,
                            const int* excl, const uint8_t* eact, int n_excl, int* leaf, float* w, void* scratch,
                            size_t scratch_bytes, void* stream) {
  return launch_draw<true>(tree, depth, r01, n, beta, count, excl, eact, n_excl, leaf, w, scratch, scratch_bytes,
                           static_cast<cudaStream_t>(stream));
}

// leaf/mass are (n,) outputs: the leaf u[i] descends to and its stored mass.
// scratch as for the sample; null without exclusions.
int sheeprl_sum_tree_descend(const float* tree, int depth, const float* u, int n, const int* excl,
                             const uint8_t* eact, int n_excl, int* leaf, float* mass, void* scratch,
                             size_t scratch_bytes, void* stream) {
  return launch_draw<false>(tree, depth, u, n, 0.0f, 0.0f, excl, eact, n_excl, leaf, mass, scratch, scratch_bytes,
                            static_cast<cudaStream_t>(stream));
}

// In place on tree: leaf[i] set to values[i] for the lanes with active[i]
// (and, where shard_ids is not null, shard_ids[i] == rank: one shard's
// scatter on its sub-tree), the touched ancestors rebuilt.  owner is (P,)
// int32 holding -1 on entry and on exit.  max_out is null, or a device f32
// the kernel sets to max(*max_in, max_i where(lane written, values, 0)),
// with max_in_value standing for *max_in where max_in is null: the running
// max of an update (max_in the old max), a shard's candidate max (-inf).
// One launch.  Returns its CUDA error (0 on success).
int sheeprl_sum_tree_write(float* tree, int depth, const int* leaf, const float* values, const uint8_t* active,
                           const int* shard_ids, int rank, int n, int* owner, const float* max_in, float max_in_value,
                           float* max_out, void* stream) {
  return launch_write(tree, depth, leaf, values, active, shard_ids, rank, n, owner, max_in, max_in_value, max_out,
                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
