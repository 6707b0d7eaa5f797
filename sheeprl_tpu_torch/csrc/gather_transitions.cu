// The flat-transition gather for Hopper (sm_90a), with a plain C interface
// bound through ctypes (sheeprl_tpu_torch/ops/gather.py builds and loads it).
//
// Replaces sheeprl_tpu/ops/pallas_gather.py:_transitions_kernel (the
// pallas_call of gather_transitions_fused).  For rings buf_k (cap, n_envs,
// *feat) of any dtype and (flat,) int32 rows/envs:
//
//   out_k[f]      = buf_k[rows[f], envs[f]]                 for every key k
//   out_next_k[f] = buf_k[(rows[f] + 1) % cap, envs[f]]     for the next keys
//
// one (flat, *feat) tensor per entry of the plan, bytes exact: uint8 flags
// stay uint8.
//
// What bounds it on an H100.  It is a copy: every output row is read once and
// written once.  The SAC dispatch (G = 64 steps of B = 256, walker-walk rows
// of 96, 96, 24, 4, 1 and 1 bytes) moves 16,384 x 222 B each way, about
// 7.3 MB: 2.2 us at 3.35 TB/s.  Below a few microseconds of copy, the time
// of a call is its launch: the wrapper's host time and the kernel's ramp.
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
//   per entry; every output starts on 16 bytes of the output block).
//   A walker row with its successor keys is about 20 chunks, so every lane of
//   a warp copies one: no lane idles on a 1-byte flag while another copies
//   96 bytes.
// - A block takes rows_per_block rows (about kChunksPerBlock chunks).  Its
//   first threads load each row's index pair once and stage the row's two
//   ring cells (64-bit) in shared memory; then its items run entry by entry,
//   so consecutive threads store consecutive chunks of one output: stores
//   coalesce into whole sectors.
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

// The plan, built once per set of rings by the host (ops/gather.py:_Plan
// mirrors this layout; sheeprl_gather_transitions_plan_bytes checks it).
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

__global__ void __launch_bounds__(kThreads) gather_transitions_kernel(const __grid_constant__ Params prm,
                                                                      const int* __restrict__ rows,
                                                                      const int* __restrict__ envs, int flat) {
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
  const int nrows = static_cast<int>(min(static_cast<long long>(prm.rows_per_block), flat - f0));
  for (int r = threadIdx.x; r < nrows; r += kThreads) {
    const long long row = rows[f0 + r];
    const long long env = envs[f0 + r];
    s_cell[r] = row * plan.n_envs + env;
    s_next[r] = ((row + 1) % plan.cap) * plan.n_envs + env;
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

}  // namespace

extern "C" {

int sheeprl_gather_transitions_max_entries() { return kMaxEntries; }

size_t sheeprl_gather_transitions_plan_bytes() { return sizeof(GatherPlan); }

// plan: the host's plan (its pointers on the device of rows/envs).  out: one
// 16-byte-aligned block holding every output, entry e's (flat, row_bytes[e])
// bytes at out_offset(e), the offsets of the entries before it each rounded
// up to 16 bytes (ops/gather.py:_Layout makes the same views of the block).
// Returns the CUDA error of the launch (0 on success); launches nothing for
// an empty output.
int sheeprl_gather_transitions(const GatherPlan* plan, void* out, const int* rows, const int* envs, int flat,
                               void* stream) {
  const int n = plan->n;
  if (n < 1 || n > kMaxEntries || flat < 0 || plan->first[n] < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  Params prm;
  prm.plan = *plan;
  long long off = 0;
  for (int e = 0; e < n; ++e) {
    prm.dst[e] = static_cast<unsigned char*>(out) + off;
    off = (off + static_cast<long long>(flat) * plan->row_bytes[e] + 15) / 16 * 16;
    const uintptr_t chunk = (uintptr_t{1} << plan->shift[e]) - 1;
    if ((reinterpret_cast<uintptr_t>(plan->src[e]) | static_cast<uintptr_t>(plan->row_bytes[e])) & chunk) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
  }
  if (flat == 0) return 0;
  const int per_row = plan->first[n];
  prm.rows_per_block = per_row >= kChunksPerBlock ? 1 : kChunksPerBlock / per_row;
  const unsigned blocks = static_cast<unsigned>((flat + prm.rows_per_block - 1) / prm.rows_per_block);
  gather_transitions_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(prm, rows, envs, flat);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
