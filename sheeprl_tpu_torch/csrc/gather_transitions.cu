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
// one (flat, *feat) tensor per entry of the table, bytes exact: uint8 flags
// stay uint8.
//
// What bounds it on an H100.  It is a copy: every output row is read once and
// written once.  The SAC dispatch (G = 64 steps of B = 256, walker-walk rows
// of 96, 96, 24, 4, 1 and 1 bytes) moves 16,384 x 222 B each way, about
// 7.3 MB: 2.2 us at 3.35 TB/s, so the launch itself is most of the time.
//
// What the design does about it.  The TPU kernel holds every ring in VMEM and
// gathers with jnp.take, one key after another.  Here every key goes in one
// launch: a table of (ring, output, row bytes, next-row flag) rides in the
// kernel's parameter space, and one warp copies one output row f of every
// key, 8 rows to a 256-thread block (the rows are far narrower than a block).
// A key's row is copied with 16-byte vectors when the row length and both row
// addresses allow, else 4-byte words, else bytes: 96-byte rows are six
// vectors, 1-byte flags one byte.  Offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxEntries = 32;
constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

struct Table {
  const unsigned char* src[kMaxEntries];
  unsigned char* dst[kMaxEntries];
  long long row_bytes[kMaxEntries];
  int next[kMaxEntries];
  int n;
};

__global__ void __launch_bounds__(kThreads) gather_transitions_kernel(
    const Table table, const int* __restrict__ rows, const int* __restrict__ envs, int flat, int cap, int n_envs) {
  const long long f = static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / 32;
  if (f >= flat) return;
  const int lane = threadIdx.x % 32;
  const long long row = rows[f];
  const long long env = envs[f];
  const long long cell = row * n_envs + env;
  const long long ncell = ((row + 1) % cap) * n_envs + env;
  for (int k = 0; k < table.n; ++k) {
    const long long n = table.row_bytes[k];
    const unsigned char* src = table.src[k] + (table.next[k] ? ncell : cell) * n;
    unsigned char* dst = table.dst[k] + f * n;
    const uintptr_t align = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst) |
                            static_cast<uintptr_t>(n);
    if ((align & 15) == 0) {
      const int4* s4 = reinterpret_cast<const int4*>(src);
      int4* d4 = reinterpret_cast<int4*>(dst);
      for (long long i = lane; i < n / 16; i += 32) d4[i] = s4[i];
    } else if ((align & 3) == 0) {
      const int* s1 = reinterpret_cast<const int*>(src);
      int* d1 = reinterpret_cast<int*>(dst);
      for (long long i = lane; i < n / 4; i += 32) d1[i] = s1[i];
    } else {
      for (long long i = lane; i < n; i += 32) dst[i] = src[i];
    }
  }
}

}  // namespace

extern "C" {

int sheeprl_gather_transitions_max_entries() { return kMaxEntries; }

// srcs/dsts/row_bytes/next are host arrays of n_entries entries (next != 0:
// the entry reads the successor row).  Returns the CUDA error of the launch
// (0 on success); launches nothing for an empty output.
int sheeprl_gather_transitions(const void* const* srcs, void* const* dsts, const long long* row_bytes,
                               const int* next, int n_entries, const int* rows, const int* envs, int flat,
                               int cap, int n_envs, void* stream) {
  if (n_entries < 1 || n_entries > kMaxEntries || flat < 0) return static_cast<int>(cudaErrorInvalidValue);
  Table table;
  for (int k = 0; k < n_entries; ++k) {
    table.src[k] = static_cast<const unsigned char*>(srcs[k]);
    table.dst[k] = static_cast<unsigned char*>(dsts[k]);
    table.row_bytes[k] = row_bytes[k];
    table.next[k] = next[k];
  }
  table.n = n_entries;
  if (flat == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((flat + kRowsPerBlock - 1) / kRowsPerBlock);
  gather_transitions_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(table, rows, envs, flat, cap,
                                                                                        n_envs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
