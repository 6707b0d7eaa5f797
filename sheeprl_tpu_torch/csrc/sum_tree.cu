// The prioritized-replay sum-tree for Hopper (sm_90a), with a plain C interface
// bound through ctypes (sheeprl_tpu_torch/ops/per.py builds and loads it).
//
// Replaces the five Pallas kernels of sheeprl_tpu/ops/pallas_per.py:
//   _sample_kernel  (the pallas_call of sum_tree_sample)  -> sheeprl_sum_tree_sample
//   _write_kernel   (the pallas_call of sum_tree_write)   -> sheeprl_sum_tree_write
//   _update_kernel  (the pallas_call of sum_tree_update)  -> the same entry point
//                   with the running-max fold switched on
//   _descend_kernel (the pallas_call of sum_tree_descend) -> sheeprl_sum_tree_descend
//   _write_kernel   (the pallas_call of sum_tree_scatter) -> sheeprl_sum_tree_scatter
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

// Write/update: set leaf[i] to values[i] where active[i], then rebuild every
// touched ancestor bottom-up as tree[2p] + tree[2p + 1].  A leaf given by
// several active lanes takes the value of the LAST of them (the lane with the
// highest index): what XLA's scatter keeps on the CPU, made deterministic here
// by an atomic max of the lane index into a scratch `owner` (P int32, -1 on
// entry); the writer clears its claim back to -1, so the scratch leaves a call
// as it came and a caller keeps one per tree.  Inactive lanes write nothing.  Update also folds
// new_max = max(max_p, max_i where(active, values, 0)) into *new_max, which
// holds max_p on entry.
//
// Scatter: the write of one shard's sub-tree, for the lanes that are active
// AND owned by the shard (shard_ids[i] == rank), with the shard's candidate
// max_i where(owned and active, values, 0) folded into *cand_max (-inf on
// entry) for the caller's max over shards.  The ownership test and the max
// ride in the claim pass: a shard's scatter is the write's launches and no
// other operation.
//
// The writes are latency-bound walks too: d + 1 nodes per lane.  The write
// is one launch to pick each leaf's writer (and fold the max), one to write
// the leaves, then one launch per level, depth + 2 launches in all: a launch
// boundary is the barrier between levels, so a block never waits on another.
// Lanes that meet at a common ancestor write the same sum there, a benign
// race.  Simple kernels: no persistent blocks and no level fusion yet; a
// sharded tree's scatter is depth + 2 launches per shard.

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

inline unsigned blocks_for(int n);  // blocks of kThreads for n lanes, defined with the writes below

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

// a lane writes when it is active and, for a shard's scatter (shard_ids not
// null), owned by the shard
__device__ __forceinline__ bool lane_on(const uint8_t* __restrict__ active, const int* __restrict__ shard_ids,
                                        int rank, int i) {
  return active[i] != 0 && (shard_ids == nullptr || shard_ids[i] == rank);
}

__global__ void __launch_bounds__(kThreads) claim_kernel(
    const int* __restrict__ leaf, const float* __restrict__ values, const uint8_t* __restrict__ active,
    const int* __restrict__ shard_ids, int rank, int n, int* __restrict__ owner, float* new_max) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool act = lane_on(active, shard_ids, rank, i);
  if (new_max != nullptr) atomic_max_f32(new_max, act ? values[i] : 0.0f);
  if (act) atomicMax(&owner[leaf[i]], i);
}

__global__ void __launch_bounds__(kThreads) write_leaves_kernel(
    float* __restrict__ tree, int p, const int* __restrict__ leaf, const float* __restrict__ values,
    const uint8_t* __restrict__ active, const int* __restrict__ shard_ids, int rank, int n, int* owner) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !lane_on(active, shard_ids, rank, i)) return;
  const int l = leaf[i];
  // other lanes of leaf l read i or -1 here, never their own index
  if (owner[l] == i) {
    tree[p + l] = values[i];
    owner[l] = -1;
  }
}

__global__ void __launch_bounds__(kThreads) rebuild_level_kernel(
    float* tree, int p, const int* __restrict__ leaf, const uint8_t* __restrict__ active,
    const int* __restrict__ shard_ids, int rank, int n, int shift) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !lane_on(active, shard_ids, rank, i)) return;
  const int node = (leaf[i] + p) >> shift;
  tree[node] = __fadd_rn(tree[2 * node], tree[2 * node + 1]);
}

inline unsigned blocks_for(int n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

int launch_write(float* tree, int depth, const int* leaf, const float* values, const uint8_t* active,
                 const int* shard_ids, int rank, int n, int* owner, float* max_out, cudaStream_t s) {
  if (depth < 1 || depth > kMaxDepth || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int p = 1 << depth;
  const unsigned blocks = blocks_for(n);
  claim_kernel<<<blocks, kThreads, 0, s>>>(leaf, values, active, shard_ids, rank, n, owner, max_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  write_leaves_kernel<<<blocks, kThreads, 0, s>>>(tree, p, leaf, values, active, shard_ids, rank, n, owner);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int shift = 1; shift <= depth; ++shift) {
    rebuild_level_kernel<<<blocks, kThreads, 0, s>>>(tree, p, leaf, active, shard_ids, rank, n, shift);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
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

// In place on tree.  owner is (P,) int32 holding -1 on entry and on exit; new_max is null
// for a plain write, else a device f32 holding max_p on entry.
int sheeprl_sum_tree_write(float* tree, int depth, const int* leaf, const float* values, const uint8_t* active,
                           int n, int* owner, float* new_max, void* stream) {
  return launch_write(tree, depth, leaf, values, active, nullptr, 0, n, owner, new_max,
                      static_cast<cudaStream_t>(stream));
}

// One shard's write, in place on its sub-tree: the lanes with active[i] and
// shard_ids[i] == rank.  owner as for the write; *cand_max is a device f32
// holding -inf on entry.
int sheeprl_sum_tree_scatter(float* tree, int depth, const int* leaf, const float* values, const uint8_t* active,
                             const int* shard_ids, int rank, int n, int* owner, float* cand_max, void* stream) {
  if (shard_ids == nullptr || cand_max == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_write(tree, depth, leaf, values, active, shard_ids, rank, n, owner, cand_max,
                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
