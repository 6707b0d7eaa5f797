// The replay-window gather for Hopper (sm_90a), with a plain C interface bound
// through ctypes (sheeprl_tpu_torch/ops/gather.py builds and loads it).
//
// Replaces sheeprl_tpu/ops/pallas_gather.py:_windows_kernel (the pallas_call of
// gather_windows_fused).  For every buffer key k, a ring buf_k
// (cap, n_envs, *feat) of any dtype, and (flat,) int32 starts/envs with
// flat = n_samples * batch:
//
//   out_k[s, t, b] = buf_k[(starts[f] + t) % cap, envs[f]],  f = s * batch + b
//
// written straight into the (n_samples, L, batch, *feat) layout that
// DeviceReplayCache._window_gather_out returns after its swapaxes.  Bytes are
// copied untouched: uint8 frames stay uint8.
//
// What bounds it on an H100.  It is a copy: every output row is read once
// and written once.  One DV3-XL Crafter draw (L = 64, batch = 16) is 1024
// rows of about 12.4 KB (12,288 B of rgb, 68 B of actions, 4 B for each of
// the other keys), about 12.7 MB each way: 7.6 us at 3.35 TB/s.
//
// What the design does about it.  The TPU kernel holds every ring in VMEM and
// gathers with jnp.take, one key after another.  Here all keys go in one
// launch: a small table of (ring pointer, output pointer, row bytes) rides in
// the kernel's parameter space (the constant bank), one block per output row
// (s, t, b).  Its 256 threads copy each key's row with 16-byte vectors when
// the row length and both row addresses allow, else 4-byte words, else
// bytes.  The rgb row is 768 vectors: three per thread, adjacent threads on
// adjacent addresses.  Offsets are 64-bit, so a ring may exceed 2^31 bytes
// (a 1M-row Crafter ring is 12 GB).  A simple kernel: no asynchronous copies
// and no persistent blocks yet.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxKeys = 32;
constexpr int kThreads = 256;

struct Table {
  const unsigned char* src[kMaxKeys];
  unsigned char* dst[kMaxKeys];
  long long row_bytes[kMaxKeys];
  int n_keys;
};

__global__ void __launch_bounds__(kThreads) gather_windows_kernel(
    const Table table, const int* __restrict__ starts, const int* __restrict__ envs,
    int seq_len, int batch, int cap, int n_envs) {
  // output row r = (s * L + t) * batch + b
  const long long r = blockIdx.x;
  const int b = static_cast<int>(r % batch);
  const long long st = r / batch;
  const int t = static_cast<int>(st % seq_len);
  const long long s = st / seq_len;
  const long long f = s * batch + b;
  const long long ring_row = (static_cast<long long>(starts[f]) + t) % cap;
  const long long cell = ring_row * n_envs + envs[f];
  for (int k = 0; k < table.n_keys; ++k) {
    const long long n = table.row_bytes[k];
    const unsigned char* src = table.src[k] + cell * n;
    unsigned char* dst = table.dst[k] + r * n;
    const uintptr_t align = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst) |
                            static_cast<uintptr_t>(n);
    if ((align & 15) == 0) {
      const int4* s4 = reinterpret_cast<const int4*>(src);
      int4* d4 = reinterpret_cast<int4*>(dst);
      for (long long i = threadIdx.x; i < n / 16; i += kThreads) d4[i] = s4[i];
    } else if ((align & 3) == 0) {
      const int* s1 = reinterpret_cast<const int*>(src);
      int* d1 = reinterpret_cast<int*>(dst);
      for (long long i = threadIdx.x; i < n / 4; i += kThreads) d1[i] = s1[i];
    } else {
      for (long long i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
    }
  }
}

}  // namespace

extern "C" {

int sheeprl_gather_windows_max_keys() { return kMaxKeys; }

// srcs/dsts/row_bytes are host arrays of n_keys entries.  Returns the CUDA
// error of the launch (0 on success); launches nothing for an empty output.
int sheeprl_gather_windows(const void* const* srcs, void* const* dsts, const long long* row_bytes,
                           int n_keys, const int* starts, const int* envs, int n_samples,
                           int seq_len, int batch, int cap, int n_envs, void* stream) {
  if (n_keys < 1 || n_keys > kMaxKeys) return static_cast<int>(cudaErrorInvalidValue);
  Table table;
  for (int k = 0; k < n_keys; ++k) {
    table.src[k] = static_cast<const unsigned char*>(srcs[k]);
    table.dst[k] = static_cast<unsigned char*>(dsts[k]);
    table.row_bytes[k] = row_bytes[k];
  }
  table.n_keys = n_keys;
  const long long rows = static_cast<long long>(n_samples) * seq_len * batch;
  if (rows == 0) return 0;
  if (rows > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  gather_windows_kernel<<<static_cast<unsigned>(rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, starts, envs, seq_len, batch, cap, n_envs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
