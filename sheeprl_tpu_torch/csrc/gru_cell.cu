// One LayerNorm-GRU step for Hopper (sm_90a), with a plain C interface bound
// through ctypes (sheeprl_tpu_torch/ops/gru_cell.py builds and loads it).
//
// Replaces sheeprl_tpu/ops/pallas_gru.py:_gru_kernel (the pallas_call of
// fused_gru_cell).  For h (B,H) f32, x (B,X) f32|bf16, W (H+X,3H) f32|bf16
// stored row-major as the JAX package stores it, gamma/beta (3H,) f32:
//
//   parts = [h | x] @ W            operands rounded to W's type, f32 sums
//   parts = LN(parts) over 3H      two-pass variance (the fused kernel) or
//                                  max(E[p^2]-E[p]^2, 0) (the flax cell)
//   r = sigmoid(parts[:H]); c = tanh(r * parts[H:2H]); u = sigmoid(parts[2H:] - 1)
//   h' = u * c + (1 - u) * h       (B,H) f32
//
// What bounds it on an H100.  A serving step reads the whole of W once: at
// DV3-XL (H=4096, X=1024, so K=5120 and 3H=12288) that is 252 MB in f32 and
// 126 MB in bf16, 75 us and 38 us at 3.35 TB/s.  The product is 2*B*K*3H
// operations on the FP32 cores; at 67 TFLOP/s it overtakes the f32 read of W
// above B ~ 40.  Activations, gamma, beta and the output are a few MB at most.
//
// What the design does about it.  The TPU kernel keeps a (block_b, 3H) f32 row
// in VMEM and walks K in order; a Hopper block has neither the memory nor the
// order, so the step is three launches:
//   A  gru_product: split-K skinny product.  A block owns 1024 adjacent output
//      columns (256 threads x 4 columns, so a warp reads 512 contiguous bytes
//      of a W row in f32), one tile of up to 16 batch rows and one slice of K.
//      The slice's activations are staged in shared memory 32 rows of K at a
//      time and read as broadcasts; sums stay in registers.  The batch tile is
//      the fastest grid dimension, so blocks that read the same W tile run
//      together and share it through L2.  The split count is chosen so that a
//      few blocks run on every SM whatever B is, which is what keeps enough
//      loads in flight to stream W at memory rate.  Each block writes its f32
//      partial sums to its own slice of the scratch: no atomics, a fixed order.
//   R  gru_reduce: sums the partial slices in order, in place into slice 0.
//   B  gru_ln_gates: one block per batch row computes the mean, then the
//      variance, and writes h' for its row.
// Left for later work: cp.async/TMA staging of W, wgmma for bf16 operands, and
// the LayerNorm sums in launch A's epilogue.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                // threads of a product block
constexpr int kCols = 4;                     // adjacent output columns per thread
constexpr int kBlockN = kThreads * kCols;    // output columns per product block
constexpr int kChunk = 32;                   // K rows staged per shared-memory chunk
constexpr int kLnThreads = 512;              // threads of a LayerNorm block

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Round an activation to the operand type: the TPU kernel casts [h | x] to
// the matmul dtype before the product (round to nearest even for bf16).
template <typename TW>
__device__ __forceinline__ float round_operand(float v);
template <>
__device__ __forceinline__ float round_operand<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_operand<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Four adjacent W values of one row, widened to f32.
__device__ __forceinline__ void load_w4(const float* p, float (&w)[kCols]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void load_w4(const __nv_bfloat16* p, float (&w)[kCols]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  w[0] = a.x; w[1] = a.y; w[2] = b.x; w[3] = b.y;
}

// Launch A.  Grid (ceil(B/BB), ceil(N/kBlockN), S); partials is (S, B, N).
// Two blocks per SM: the 16-row tile's 64 sums must fit in 128 registers.
template <typename TW, typename TX, int BB>
__global__ void __launch_bounds__(kThreads, 2) gru_product(
    const float* __restrict__ h, const TX* __restrict__ x, const TW* __restrict__ w,
    float* __restrict__ partials, int B, int H, int X, int ks) {
  __shared__ __align__(16) float act[kChunk][BB];
  const int N = 3 * H;
  const int K = H + X;
  const int b0 = blockIdx.x * BB;
  const int col = blockIdx.y * kBlockN + threadIdx.x * kCols;
  const int s = blockIdx.z;
  const int k_begin = s * ks;
  const int k_end = min(K, k_begin + ks);
  const bool active = col < N;  // N % kCols == 0: a thread's columns are all in or all out

  float acc[BB][kCols];
#pragma unroll
  for (int r = 0; r < BB; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kChunk) {
    __syncthreads();
    for (int i = threadIdx.x; i < kChunk * BB; i += kThreads) {
      const int kk = i / BB, r = i % BB;
      const int k = k0 + kk, b = b0 + r;
      float v = 0.f;
      if (k < k_end && b < B) {
        v = k < H ? round_operand<TW>(h[(size_t)b * H + k])
                  : round_operand<TW>(to_float(x[(size_t)b * X + (k - H)]));
      }
      act[kk][r] = v;
    }
    __syncthreads();
    if (active) {
      const int kn = min(kChunk, k_end - k0);
      const TW* wp = w + (size_t)k0 * N + col;
#pragma unroll 8
      for (int kk = 0; kk < kn; ++kk) {
        float wv[kCols];
        load_w4(wp + (size_t)kk * N, wv);
#pragma unroll
        for (int r = 0; r < BB; ++r) {
          const float a = act[kk][r];
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[r][j] = fmaf(a, wv[j], acc[r][j]);
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < BB; ++r) {
    const int b = b0 + r;
    if (b < B) {
      float4 v = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      *reinterpret_cast<float4*>(partials + ((size_t)s * B + b) * N + col) = v;
    }
  }
}

// Launch R.  partials[0] += partials[1] + ... + partials[S-1], in that order.
__global__ void gru_reduce(float* __restrict__ partials, int n4, int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4* p = reinterpret_cast<float4*>(partials);
  float4 acc = p[i];
  for (int s = 1; s < S; ++s) {
    const float4 v = p[(size_t)s * n4 + i];
    acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
  }
  p[i] = acc;
}

// Sum over the block; every thread gets the total.  scratch holds one float
// per warp and is free again when the call returns.
__device__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float t = 0.f;
  const int nwarps = blockDim.x >> 5;
  for (int i = 0; i < nwarps; ++i) t += scratch[i];
  __syncthreads();
  return t;
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// Launch B.  One block per batch row of parts (B, 3H).
__global__ void __launch_bounds__(kLnThreads) gru_ln_gates(
    const float* __restrict__ parts, const float* __restrict__ h,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    float* __restrict__ out, int H, float eps, int two_pass) {
  __shared__ float scratch[kLnThreads / 32];
  const int N = 3 * H;
  const float* p = parts + (size_t)blockIdx.x * N;
  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const float v = p[i];
    s1 += v;
    s2 += v * v;
  }
  const float mean = block_sum(s1, scratch) / N;
  float var;
  if (two_pass) {
    float d = 0.f;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      const float v = p[i] - mean;
      d += v * v;
    }
    var = block_sum(d, scratch) / N;
  } else {
    var = fmaxf(block_sum(s2, scratch) / N - mean * mean, 0.f);
  }
  const float inv = rsqrtf(var + eps);
  const float* hb = h + (size_t)blockIdx.x * H;
  float* ob = out + (size_t)blockIdx.x * H;
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    const float pr = (p[j] - mean) * inv * gamma[j] + beta[j];
    const float pc = (p[H + j] - mean) * inv * gamma[H + j] + beta[H + j];
    const float pu = (p[2 * H + j] - mean) * inv * gamma[2 * H + j] + beta[2 * H + j];
    const float reset = sigmoid(pr);
    const float cand = tanhf(reset * pc);
    const float update = sigmoid(pu - 1.f);
    ob[j] = update * cand + (1.f - update) * hb[j];
  }
}

template <typename TW, typename TX, int BB>
void launch_product(const void* h, const void* x, const void* w, float* partials, int B, int H,
                    int X, int ks, int S, cudaStream_t stream) {
  const dim3 grid((B + BB - 1) / BB, (3 * H + kBlockN - 1) / kBlockN, S);
  gru_product<TW, TX, BB><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(h), static_cast<const TX*>(x), static_cast<const TW*>(w),
      partials, B, H, X, ks);
}

template <typename TW, typename TX>
void dispatch_rows(const void* h, const void* x, const void* w, float* partials, int B, int H,
                   int X, int ks, int S, cudaStream_t stream) {
  if (B <= 1)
    launch_product<TW, TX, 1>(h, x, w, partials, B, H, X, ks, S, stream);
  else if (B <= 2)
    launch_product<TW, TX, 2>(h, x, w, partials, B, H, X, ks, S, stream);
  else if (B <= 4)
    launch_product<TW, TX, 4>(h, x, w, partials, B, H, X, ks, S, stream);
  else if (B <= 8)
    launch_product<TW, TX, 8>(h, x, w, partials, B, H, X, ks, S, stream);
  else
    launch_product<TW, TX, 16>(h, x, w, partials, B, H, X, ks, S, stream);
}

}  // namespace

extern "C" {

// One step.  partials is f32 scratch of S*B*3H elements; ks is the length of
// each K slice (S = ceil((H+X)/ks)).  Returns cudaGetLastError() after the
// launches, so a refused launch is reported to the caller.
int sheeprl_gru_cell_forward(const void* h, const void* x, const void* w, const void* gamma,
                             const void* beta, void* out, void* partials, int B, int H, int X,
                             int ks, int S, int w_bf16, int x_bf16, int two_pass, float eps,
                             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* part = static_cast<float*>(partials);
  if (w_bf16) {
    if (x_bf16)
      dispatch_rows<__nv_bfloat16, __nv_bfloat16>(h, x, w, part, B, H, X, ks, S, stream);
    else
      dispatch_rows<__nv_bfloat16, float>(h, x, w, part, B, H, X, ks, S, stream);
  } else {
    if (x_bf16)
      dispatch_rows<float, __nv_bfloat16>(h, x, w, part, B, H, X, ks, S, stream);
    else
      dispatch_rows<float, float>(h, x, w, part, B, H, X, ks, S, stream);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (S > 1) {
    const int n4 = B * 3 * H / 4;
    gru_reduce<<<(n4 + 255) / 256, 256, 0, stream>>>(part, n4, S);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gru_ln_gates<<<B, kLnThreads, 0, stream>>>(part, static_cast<const float*>(h),
                                             static_cast<const float*>(gamma),
                                             static_cast<const float*>(beta),
                                             static_cast<float*>(out), H, eps, two_pass);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
