// The replay gathers for Hopper (sm_90a): the window gather and the
// flat-transition gather, one kernel body behind two plain C entries bound
// through ctypes (sheeprl_tpu_torch/ops/gather.py builds and loads it).
//
// sheeprl_gather_windows replaces sheeprl_tpu/ops/pallas_gather.py:
// _windows_kernel (the pallas_call of gather_windows_fused).  For rings
// buf_k (cap, n_envs, *feat) of any dtype and (flat,) int32 starts/envs,
// flat = n_samples * batch:
//
//   out_k[s, t, b] = buf_k[(starts[f] + t) % cap, envs[f]],  f = s * batch + b
//
// straight into the (n_samples, L, batch, *feat) layout that
// DeviceReplayCache._window_gather_out returns after its swapaxes.
//
// sheeprl_gather_transitions replaces pallas_gather.py:_transitions_kernel
// (the pallas_call of gather_transitions_fused).  For (flat,) int32
// rows/envs:
//
//   out_k[f]      = buf_k[rows[f], envs[f]]                 for every key k
//   out_next_k[f] = buf_k[(rows[f] + 1) % cap, envs[f]]     for the next keys
//
// Both copy bytes untouched: uint8 frames and flags stay uint8.
//
// What bounds them on an H100.  A copy: every output row is read once and
// written once.  One DV3-XL Crafter window draw (L = 64, batch = 16) is
// 1,024 rows of about 12.4 KB, 12.7 MB each way: 7.6 us at 3.35 TB/s.  The
// SAC dispatch's transition draw (G = 64 steps of B = 256, walker-walk rows
// of 96, 96, 24, 4, 1 and 1 bytes) is 16,384 x 222 B, 7.3 MB: 2.2 us.  Below
// a few microseconds of copy, the time of a call is its launch: the
// wrapper's host time and the kernel's ramp.
//
// What the design does about it.
// - The host builds a plan once for a set of rings (ops/gather.py): the
//   entries' ring pointers, row bytes, successor flags and chunk widths, and
//   the prefix of their chunk counts.  A call passes the plan, one block that
//   holds every output (one allocation; the host makes the outputs as views
//   of it) and the indices: one ctypes call, no per-call table building.
// - The work is cut by chunks of the whole output row, not by key.  A chunk
//   is 16 bytes of an entry whose row bytes and ring base are multiples of 16,
//   else 4 bytes where they are multiples of 4, else 1 byte (the host decides
//   per entry; every output starts on 16 bytes of the output block).  A
//   walker row with its successor keys is about 20 chunks, so every lane of
//   a warp copies one: no lane idles on a 1-byte flag while another copies
//   96 bytes; a Crafter window row is about 790, three a thread.
// - A block takes rows_per_block output rows (about kChunksPerBlock chunks).
//   Its first threads work out each row's ring cell (the window's row
//   (start + t) % cap, or the transition's row and its successor) once and
//   stage it (64-bit: rings may exceed 2^31 bytes) in shared memory; then
//   its items run entry by entry, so consecutive threads store consecutive
//   chunks of one output: stores coalesce into whole sectors.
// - Each thread issues kUnroll chunk loads before any of its stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxEntries = 32;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kChunksPerBlock = kThreads * kUnroll;
constexpr int kMaxRows = kChunksPerBlock;  // a row has at least one chunk

}  // namespace

extern "C" {

// The plan, built once per set of rings by the host (ops/gather.py:_PlanC
// mirrors this layout; sheeprl_gather_plan_bytes checks it).
struct GatherPlan {
  const unsigned char* src[kMaxEntries];  // the entry's ring
  long long row_bytes[kMaxEntries];
  int shift[kMaxEntries];                 // log2 of the entry's chunk bytes: 4, 2 or 0
  int next[kMaxEntries];                  // 1: the successor row
  int first[kMaxEntries + 1];             // chunks of a row before entry e; first[n]: a row's chunks
  int n;
  int cap;
  int n_envs;
};

}  // extern "C"

namespace {

struct Params {
  GatherPlan plan;
  unsigned char* dst[kMaxEntries];
  int rows_per_block;
};

__device__ __forceinline__ int4 load_chunk(const unsigned char* p, int shift) {
  int4 v = {0, 0, 0, 0};
  if (shift == 4) {
    v = __ldg(reinterpret_cast<const int4*>(p));
  } else if (shift == 2) {
    v.x = __ldg(reinterpret_cast<const int*>(p));
  } else {
    v.x = __ldg(p);
  }
  return v;
}

__device__ __forceinline__ void store_chunk(unsigned char* p, int shift, int4 v) {
  if (shift == 4) {
    *reinterpret_cast<int4*>(p) = v;
  } else if (shift == 2) {
    *reinterpret_cast<int*>(p) = v.x;
  } else {
    *p = static_cast<unsigned char>(v.x);
  }
}

// kWindows: output row o = (s L + t) batch + b reads ring row
// (idx[s batch + b] + t) % cap of env envs[s batch + b]; else output row o
// reads ring row idx[o] (its successor for a next entry) of env envs[o].
template <bool kWindows>
__global__ void __launch_bounds__(kThreads) gather_kernel(const __grid_constant__ Params prm,
                                                          const int* __restrict__ idx,
                                                          const int* __restrict__ envs, int n_rows, int seq_len,
                                                          int batch) {
  __shared__ long long s_cell[kMaxRows];
  __shared__ long long s_next[kMaxRows];
  __shared__ const unsigned char* s_src[kMaxEntries];
  __shared__ unsigned char* s_dst[kMaxEntries];
  __shared__ long long s_row_bytes[kMaxEntries];
  __shared__ int s_shift[kMaxEntries];
  __shared__ int s_next_flag[kMaxEntries];
  __shared__ int s_chunks[kMaxEntries];
  __shared__ int s_item0[kMaxEntries + 1];  // this block's items before entry e
  const GatherPlan& plan = prm.plan;
  const int n = plan.n;
  const long long f0 = static_cast<long long>(blockIdx.x) * prm.rows_per_block;
  const int nrows = static_cast<int>(min(static_cast<long long>(prm.rows_per_block), n_rows - f0));
  // 32-bit index arithmetic (n_rows < 2^31, non-negative int32 indices),
  // 64-bit cells
  for (int r = threadIdx.x; r < nrows; r += kThreads) {
    const int o = static_cast<int>(f0) + r;
    if (kWindows) {
      const int st = o / batch;
      const int t = st % seq_len;
      const int f = (st - t) / seq_len * batch + (o - st * batch);
      const unsigned cap = static_cast<unsigned>(plan.cap);
      const unsigned row = (static_cast<unsigned>(idx[f]) + static_cast<unsigned>(t)) % cap;
      s_cell[r] = static_cast<long long>(row) * plan.n_envs + envs[f];
    } else {
      const int row = idx[o];
      const int env = envs[o];
      s_cell[r] = static_cast<long long>(row) * plan.n_envs + env;
      const unsigned next = (static_cast<unsigned>(row) + 1u) % static_cast<unsigned>(plan.cap);
      s_next[r] = static_cast<long long>(next) * plan.n_envs + env;
    }
  }
  if (threadIdx.x <= n) {
    const int e = threadIdx.x;
    s_item0[e] = plan.first[e] * nrows;
    if (e < n) {
      s_src[e] = plan.src[e];
      s_dst[e] = prm.dst[e] + f0 * plan.row_bytes[e];
      s_row_bytes[e] = plan.row_bytes[e];
      s_shift[e] = plan.shift[e];
      s_next_flag[e] = plan.next[e];
      s_chunks[e] = plan.first[e + 1] - plan.first[e];
    }
  }
  __syncthreads();
  const int total = s_item0[n];
  for (int base = threadIdx.x; base < total; base += kThreads * kUnroll) {
    int4 v[kUnroll];
    unsigned char* dst[kUnroll];
    int shift[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int item = base + u * kThreads;
      dst[u] = nullptr;
      shift[u] = 0;
      if (item < total) {
        int lo = 0, hi = n - 1;  // the entry: the last e with s_item0[e] <= item
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (s_item0[mid] <= item) {
            lo = mid;
          } else {
            hi = mid - 1;
          }
        }
        const int e = lo;
        const int j = item - s_item0[e];
        const int chunks = s_chunks[e];
        const int r = j / chunks;
        const long long off = static_cast<long long>(j - r * chunks) << s_shift[e];
        const long long cell = s_next_flag[e] ? s_next[r] : s_cell[r];
        shift[u] = s_shift[e];
        v[u] = load_chunk(s_src[e] + cell * s_row_bytes[e] + off, shift[u]);
        dst[u] = s_dst[e] + r * s_row_bytes[e] + off;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (dst[u] != nullptr) store_chunk(dst[u], shift[u], v[u]);
    }
  }
}

// Params for a call: the plan, each entry's output in the block (entry e's
// n_rows x row_bytes[e] bytes, the entries before it each rounded up to 16
// bytes; ops/gather.py:_Layout makes the same views) and the rows a block.
// Returns 0 or the CUDA error that refuses the call.
int prepare(const GatherPlan* plan, void* out, int n_rows, Params* prm) {
  const int n = plan->n;
  if (n < 1 || n > kMaxEntries || n_rows < 0 || plan->first[n] < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  prm->plan = *plan;
  long long off = 0;
  for (int e = 0; e < n; ++e) {
    prm->dst[e] = static_cast<unsigned char*>(out) + off;
    off = (off + static_cast<long long>(n_rows) * plan->row_bytes[e] + 15) / 16 * 16;
    const uintptr_t chunk = (uintptr_t{1} << plan->shift[e]) - 1;
    if ((reinterpret_cast<uintptr_t>(plan->src[e]) | static_cast<uintptr_t>(plan->row_bytes[e])) & chunk) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
  }
  const int per_row = plan->first[n];
  prm->rows_per_block = per_row >= kChunksPerBlock ? 1 : kChunksPerBlock / per_row;
  return 0;
}

}  // namespace

extern "C" {

int sheeprl_gather_max_entries() { return kMaxEntries; }

size_t sheeprl_gather_plan_bytes() { return sizeof(GatherPlan); }

// plan: the host's plan (its pointers on the device of the indices).  out:
// one 16-byte-aligned block holding every output.  Returns the CUDA error
// of the launch (0 on success); launches nothing for an empty output.
int sheeprl_gather_transitions(const GatherPlan* plan, void* out, const int* rows, const int* envs, int flat,
                               void* stream) {
  Params prm;
  const int err = prepare(plan, out, flat, &prm);
  if (err != 0 || flat == 0) return err;
  const unsigned blocks = static_cast<unsigned>((flat + prm.rows_per_block - 1) / prm.rows_per_block);
  gather_kernel<false><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(prm, rows, envs, flat, 1, 1);
  return static_cast<int>(cudaGetLastError());
}

// The windows of n_samples * batch (starts, envs) pairs, seq_len rows each,
// in (n_samples, seq_len, batch) order; the plan has no next entries.
int sheeprl_gather_windows(const GatherPlan* plan, void* out, const int* starts, const int* envs, int n_samples,
                           int seq_len, int batch, void* stream) {
  const long long n_rows = static_cast<long long>(n_samples) * seq_len * batch;
  if (n_samples < 0 || seq_len < 1 || batch < 1 || n_rows > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int e = 0; e < plan->n && e < kMaxEntries; ++e) {
    if (plan->next[e]) return static_cast<int>(cudaErrorInvalidValue);
  }
  Params prm;
  const int err = prepare(plan, out, static_cast<int>(n_rows), &prm);
  if (err != 0 || n_rows == 0) return err;
  const unsigned blocks = static_cast<unsigned>((n_rows + prm.rows_per_block - 1) / prm.rows_per_block);
  gather_kernel<true><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      prm, starts, envs, static_cast<int>(n_rows), seq_len, batch);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
