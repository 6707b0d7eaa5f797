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
//   d levels: left = tree[2 node] - sum_e [ancestor of excl[e] == 2 node] emass[e]
//             go right when u >= left (then u -= left)
//   w = (max(count, 1) * max(mass, tiny) / max(total, tiny))^-beta,  w /= max_i w
// The exclusions are corrections inside the descent: the stored tree is not
// copied or written.  Without exclusions the arithmetic is op for op the lax
// descent's, so the leaves are identical to it.  Every product and difference
// is rounded on its own (__fmul_rn/__fsub_rn): a fused multiply-add of
// r01 * total - left would move a draw that lands within an ulp of a subtree
// boundary.
//
// Descend: the same corrected descent for u given (already placed in this
// tree's mass interval by the caller: one shard's sub-tree of the env-sharded
// prioritized replay), returning each draw's leaf and its stored mass; no
// total and no weights.  Sample and descend share the descent function.
//
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
// What bounds them on an H100.  All are latency-bound walks over a tree of
// 1-8 MB (2^18-2^20 leaves) that sits in the 50 MB L2: a draw reads d + 1
// nodes one after another, a write d + 1 nodes per lane.  At the SAC
// dispatch (n = 16,384 draws, d = 20) the descent touches at most
// n (d + 1) 32-byte sectors, 11 MB, about 3.3 us at 3.35 TB/s; in practice
// the levels near the root are shared by every draw and stay in L1/L2.
//
// What the design does about it.  One thread per draw, the E exclusions
// (63 on the Dreamer path with one env, (L - 1) per env in general) staged
// in shared memory with their masses, kExclChunk at a time, the total summed
// once per block in index order; above kExclChunk the chunks are staged
// again at every level and the corrections still summed in index order, so
// a draw's arithmetic does not depend on the chunk size; the batch
// max of the weights by an atomic max on the bits of the f32 weights (exact),
// then a second launch divides.  The write is one launch to pick each leaf's
// writer (and fold the max), one to write the leaves, then one launch per
// level, depth + 2 launches in all: a launch boundary is the barrier between
// levels, so a block never waits on another.  Lanes that meet at a common
// ancestor write the same sum there, a benign race.  Simple kernels: no
// persistent blocks and no level fusion yet; a sharded tree's scatter is
// depth + 2 launches per shard.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kExclChunk = 1024;  // exclusions staged in shared memory at a time
constexpr int kMaxDepth = 30;

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

// Stage exclusions [base, base + m) in shared memory: their heap nodes and
// their masses (0 where inactive).
__device__ __forceinline__ void stage_exclusions(const float* __restrict__ tree, int p, const int* __restrict__ excl,
                                                 const uint8_t* __restrict__ eact, int base, int m, int* s_enode,
                                                 float* s_emass) {
  for (int e = threadIdx.x; e < m; e += blockDim.x) {
    const int en = excl[base + e] + p;
    s_enode[e] = en;
    s_emass[e] = eact[base + e] ? tree[en] : 0.0f;
  }
}

// The corrected root-to-leaf descent of u; returns the heap node of the leaf.
// Every thread of the block calls it (a thread past n with u = 0): above one
// chunk of exclusions it stages the chunks again at every level, behind
// barriers.  With one chunk, the caller has staged it.
__device__ __forceinline__ int corrected_descent(const float* __restrict__ tree, int p, int depth, float u,
                                                 const int* __restrict__ excl, const uint8_t* __restrict__ eact,
                                                 int n_excl, int* s_enode, float* s_emass) {
  const int n_chunks = (n_excl + kExclChunk - 1) / kExclChunk;
  int node = 1;
  for (int lvl = 0; lvl < depth; ++lvl) {
    const int child = 2 * node;
    float left = tree[child];
    if (n_excl > 0) {
      const int shift = depth - 1 - lvl;
      float corr = 0.0f;
      // the exclusions in index order, as the total: one chunk stays staged
      // from above; more are streamed through shared memory at every level
      for (int c = 0; c < n_chunks; ++c) {
        const int base = c * kExclChunk;
        const int m = min(kExclChunk, n_excl - base);
        if (n_chunks > 1) {
          __syncthreads();
          stage_exclusions(tree, p, excl, eact, base, m, s_enode, s_emass);
          __syncthreads();
        }
        for (int e = 0; e < m; ++e) {
          if ((s_enode[e] >> shift) == child) corr = __fadd_rn(corr, s_emass[e]);
        }
      }
      left = __fsub_rn(left, corr);
    }
    const bool right = u >= left;
    if (right) u = __fsub_rn(u, left);
    node = child + (right ? 1 : 0);
  }
  return node;
}

__global__ void __launch_bounds__(kThreads) sample_kernel(
    const float* __restrict__ tree, int depth, const float* __restrict__ r01, int n, float beta,
    float count, const int* __restrict__ excl, const uint8_t* __restrict__ eact, int n_excl,
    int* __restrict__ leaf_out, float* __restrict__ w_out, float* wmax) {
  __shared__ int s_enode[kExclChunk];
  __shared__ float s_emass[kExclChunk];
  __shared__ float s_total;
  const int p = 1 << depth;
  const int n_chunks = (n_excl + kExclChunk - 1) / kExclChunk;
  // every thread of the block reaches every barrier below: the loops' trip
  // counts (chunks, levels) are the same for all, and a thread past n
  // descends on u = 0 and writes nothing
  float esum = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    const int base = c * kExclChunk;
    const int m = min(kExclChunk, n_excl - base);
    __syncthreads();
    stage_exclusions(tree, p, excl, eact, base, m, s_enode, s_emass);
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int e = 0; e < m; ++e) esum = __fadd_rn(esum, s_emass[e]);
    }
  }
  if (threadIdx.x == 0) s_total = __fsub_rn(tree[1], esum);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const float total = s_total;
  const float u = live ? __fmul_rn(r01[i], total) : 0.0f;
  const int node = corrected_descent(tree, p, depth, u, excl, eact, n_excl, s_enode, s_emass);
  if (!live) return;
  const float mass = tree[node];
  const float probs = __fdiv_rn(fmaxf(mass, FLT_MIN), fmaxf(total, FLT_MIN));
  const float w = powf(__fmul_rn(fmaxf(count, 1.0f), probs), -beta);
  leaf_out[i] = node - p;
  w_out[i] = w;
  atomic_max_f32(wmax, w);
}

__global__ void __launch_bounds__(kThreads) descend_kernel(
    const float* __restrict__ tree, int depth, const float* __restrict__ u_in, int n,
    const int* __restrict__ excl, const uint8_t* __restrict__ eact, int n_excl, int* __restrict__ leaf_out,
    float* __restrict__ mass_out) {
  __shared__ int s_enode[kExclChunk];
  __shared__ float s_emass[kExclChunk];
  const int p = 1 << depth;
  if (n_excl > 0 && n_excl <= kExclChunk) {  // the one chunk, staged once (more are streamed per level)
    stage_exclusions(tree, p, excl, eact, 0, n_excl, s_enode, s_emass);
    __syncthreads();
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const float u = live ? u_in[i] : 0.0f;
  const int node = corrected_descent(tree, p, depth, u, excl, eact, n_excl, s_enode, s_emass);
  if (!live) return;
  leaf_out[i] = node - p;
  mass_out[i] = tree[node];
}

__global__ void __launch_bounds__(kThreads) normalize_kernel(float* __restrict__ w, const float* __restrict__ wmax, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) w[i] = __fdiv_rn(w[i], *wmax);
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

// leaf/w are (n,) outputs; *wmax is a device f32 holding 0 on entry.  Returns
// the CUDA error of the launches (0 on success).
int sheeprl_sum_tree_sample(const float* tree, int depth, const float* r01, int n, float beta, float count,
                            const int* excl, const uint8_t* eact, int n_excl, int* leaf, float* w, float* wmax,
                            void* stream) {
  if (depth < 1 || depth > kMaxDepth || n < 0 || n_excl < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sample_kernel<<<blocks_for(n), kThreads, 0, s>>>(tree, depth, r01, n, beta, count, excl, eact, n_excl, leaf, w, wmax);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  normalize_kernel<<<blocks_for(n), kThreads, 0, s>>>(w, wmax, n);
  return static_cast<int>(cudaGetLastError());
}

// leaf/mass are (n,) outputs: the leaf u[i] descends to and its stored mass.
int sheeprl_sum_tree_descend(const float* tree, int depth, const float* u, int n, const int* excl,
                             const uint8_t* eact, int n_excl, int* leaf, float* mass, void* stream) {
  if (depth < 1 || depth > kMaxDepth || n < 0 || n_excl < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  descend_kernel<<<blocks_for(n), kThreads, 0, s>>>(tree, depth, u, n, excl, eact, n_excl, leaf, mass);
  return static_cast<int>(cudaGetLastError());
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
