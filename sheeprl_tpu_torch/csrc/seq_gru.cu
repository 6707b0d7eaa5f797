// The sequence LayerNorm-GRU for Hopper (sm_90a): T gated steps in one
// launch, with a plain C interface bound through ctypes
// (sheeprl_tpu_torch/ops/seq_gru.py builds and loads it).
//
// Replaces the Pallas kernel _seq_kernel of sheeprl_tpu/ops/seq_gru.py (the
// pallas_call of gru_sequence).  For t = 0 .. T-1, from h = h0:
//   hg    = (1 - is_first[t]) * h + is_first[t] * init_rec
//   z     = [hg, xs[t]] @ W                       W: (H + X, 3H) row-major
//   parts = (z - mu) * rsqrt(var + eps) * gamma + beta,
//           mu = mean(z), var = max(mean(z^2) - mu^2, 0) over the 3H columns
//   h     = u * tanh(r * parts[H:2H]) + (1 - u) * hg,
//           r = sigmoid(parts[:H]), u = sigmoid(parts[2H:] - 1)
//   hs[t] = h
// All f32.
//
// What bounds it on an H100.  The product: 2 T B (H + X) 3H operations,
// 3.2 GFLOP at DV3-S training (T = 64, B = 16, H = X = 512), 48 us at the
// 67 TFLOP/s f32 rate; its bytes (W once, xs, hs) are 10.6 MB, 3 us.  But the
// steps are sequential and each is small (16 rows): every step needs the
// whole previous state, and its LayerNorm needs the whole row of z, so a
// step is two grid-wide dependencies, and at this size their latency, not
// the operations, sets the time.
//
// What the design does about it.  One cooperative launch
// (cudaLaunchCooperativeKernel) of one block per SM (grid sized with the
// occupancy API; the launch is refused, and the wrapper raises, when the
// grid cannot be co-resident).  Block k owns S hidden units j in
// [k S, (k + 1) S) and their three columns j, H + j, 2H + j of W, which it
// keeps transposed in shared memory for all T steps (48 KB at DV3-S: W is
// read from device memory once).  At each step:
//   1. it stages the rows [hg, x_t] in shared memory (as many rows as the
//      rest of the SM's shared memory holds, all of B = 16 at DV3-S), with
//      16-byte loads that are independent of each other, so that a thread
//      has many in flight rather than one L2 latency per K step of a warp,
//      and reads init_rec only for rows that reset; then its warps compute
//      its 3S columns of z for every row, two rows a warp at a time so each
//      16-byte read of W from shared memory feeds eight FMAs; the K loop in
//      a fixed order, the 32 lanes' sums combined by a fixed shuffle tree;
//   2. it writes each row's partial sum and sum of squares over its columns
//      to a global scratch;  grid.sync();
//   3. every block copies all blocks' partials to shared memory and sums
//      them for every row in block order (no atomics, so every block gets
//      the same bits and every run the same result), forms mu and the
//      one-pass variance;
//   4. it applies gamma, beta and the gates to its S units and writes them
//      to hs[t];  grid.sync().
// hs[t] is the carried state: step t + 1 reads it back (through L2: loads
// of data written during the launch bypass the non-coherent L1).  A simple
// kernel: the product runs on the FP32 units, no tensor cores, no TMA.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxUnits = 8;

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

// the gated state (1 - f) h + f init, rounded as the reference rounds it
__device__ __forceinline__ float blend(float h, float init, float f) {
  return __fadd_rn(__fmul_rn(1.0f - f, h), __fmul_rn(f, init));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int S>
__global__ void __launch_bounds__(kThreads) gru_sequence_kernel(
    const float* h0, const float* __restrict__ xs, const float* __restrict__ w, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ is_first, const float* __restrict__ init_rec,
    float* hs, float* partials, int T, int B, int H, int X, int chunk_rows, float eps) {
  constexpr int C = 3 * S;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int K = H + X;
  float* ws = smem;                  // (C, K): column c = g S + u of this block's slice of W
  float* in = ws + C * K;            // (chunk_rows, K): rows of [hg, x_t]
  float2* pst = reinterpret_cast<float2*>(in + chunk_rows * K);  // (blocks, B): every block's partial sums
  float* zs = reinterpret_cast<float*>(pst + gridDim.x * B);     // (B, C): this step's z on this block's columns
  float* stat = zs + B * C;          // (B, 2): mean and rsqrt(var + eps) of each row
  const int j0 = blockIdx.x * S;
  const int units = min(S, H - j0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float inv_n = 1.0f / static_cast<float>(3 * H);
  const int H4 = H / 4, X4 = X / 4, K4 = K / 4;
  float4* in4 = reinterpret_cast<float4*>(in);
  const float4* ws4 = reinterpret_cast<const float4*>(ws);
  // with every row staged at once, step 4 finds hg in shared memory
  const bool staged = chunk_rows >= B;

  for (int idx = threadIdx.x; idx < K * C; idx += kThreads) {
    const int k = idx / C, c = idx % C;
    const int g = c / S, u = c % S;
    ws[c * K + k] = u < units ? w[static_cast<long long>(k) * 3 * H + g * H + j0 + u] : 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* hprev = t == 0 ? h0 : hs + static_cast<long long>(t - 1) * B * H;
    const float* xt = xs + static_cast<long long>(t) * B * X;
    const float* ft = is_first + static_cast<long long>(t) * B;

    // 1. z on this block's columns, chunk_rows rows at a time: the whole
    //    block stages the rows of [hg, x_t] in shared memory (independent
    //    loads, many in flight), then its warps take two rows each
    for (int r0 = 0; r0 < B; r0 += chunk_rows) {
      const int rows = min(chunk_rows, B - r0);
      const float4* h4 = reinterpret_cast<const float4*>(hprev) + static_cast<long long>(r0) * H4;
      const float4* i4 = reinterpret_cast<const float4*>(init_rec) + static_cast<long long>(r0) * H4;
      const float4* x4 = reinterpret_cast<const float4*>(xt) + static_cast<long long>(r0) * X4;
#pragma unroll 8
      for (int idx = threadIdx.x; idx < rows * H4; idx += kThreads) {
        const int r = idx / H4;
        const float f = __ldg(ft + r0 + r);
        float4 v = __ldcg(h4 + idx);
        if (f != 0.0f) {  // f = 0 (no reset, most rows) leaves h as it is: init_rec is not read
          const float4 i = __ldg(i4 + idx);
          v = make_float4(blend(v.x, i.x, f), blend(v.y, i.y, f), blend(v.z, i.z, f), blend(v.w, i.w, f));
        }
        in4[r * K4 + (idx - r * H4)] = v;
      }
#pragma unroll 8
      for (int idx = threadIdx.x; idx < rows * X4; idx += kThreads) {
        const int r = idx / X4;
        in4[r * K4 + H4 + (idx - r * X4)] = __ldg(x4 + idx);
      }
      __syncthreads();
      for (int ra = warp; ra < rows; ra += 2 * kWarps) {
        const int rb = ra + kWarps;
        const bool two = rb < rows;
        const float4* in0 = in4 + ra * K4;
        const float4* in1 = in4 + (two ? rb : ra) * K4;
        float acc0[C], acc1[C];
#pragma unroll
        for (int c = 0; c < C; ++c) acc0[c] = acc1[c] = 0.0f;
#pragma unroll 2
        for (int k4 = lane; k4 < K4; k4 += 32) {
          const float4 v0 = in0[k4], v1 = in1[k4];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float4 wv = ws4[c * K4 + k4];
            acc0[c] = fmaf(v0.w, wv.w, fmaf(v0.z, wv.z, fmaf(v0.y, wv.y, fmaf(v0.x, wv.x, acc0[c]))));
            acc1[c] = fmaf(v1.w, wv.w, fmaf(v1.z, wv.z, fmaf(v1.y, wv.y, fmaf(v1.x, wv.x, acc1[c]))));
          }
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          acc0[c] = warp_sum(acc0[c]);
          acc1[c] = warp_sum(acc1[c]);
        }
        if (lane == 0) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            zs[(r0 + ra) * C + c] = acc0[c];
            if (two) zs[(r0 + rb) * C + c] = acc1[c];
          }
        }
      }
      __syncthreads();  // the next chunk overwrites the staged rows
    }

    // 2. each row's partial sums over this block's columns, in column order
    for (int b = threadIdx.x; b < B; b += kThreads) {
      float s = 0.0f, q = 0.0f;
      for (int g = 0; g < 3; ++g) {
        for (int u = 0; u < units; ++u) {
          const float z = zs[b * C + g * S + u];
          s += z;
          q = fmaf(z, z, q);
        }
      }
      float* dst = partials + (static_cast<long long>(blockIdx.x) * B + b) * 2;
      dst[0] = s;
      dst[1] = q;
    }
    grid.sync();

    // 3. the row statistics: every block's partials staged once, coalesced
    //    (each warp reading across all blocks' lines would make every line
    //    of the scratch a hot spot read by all SMs), then one thread a row
    //    sums them in block order
    const int n_part = static_cast<int>(gridDim.x) * B;
    const float2* part2 = reinterpret_cast<const float2*>(partials);
#pragma unroll 4
    for (int idx = threadIdx.x; idx < n_part; idx += kThreads) pst[idx] = __ldcg(part2 + idx);
    __syncthreads();
    for (int b = threadIdx.x; b < B; b += kThreads) {
      float s = 0.0f, q = 0.0f;
      for (int k = 0; k < static_cast<int>(gridDim.x); ++k) {
        const float2 p = pst[k * B + b];
        s += p.x;
        q += p.y;
      }
      const float mu = s * inv_n;
      const float var = fmaxf(q * inv_n - mu * mu, 0.0f);
      stat[2 * b] = mu;
      stat[2 * b + 1] = rsqrtf(var + eps);
    }
    __syncthreads();

    // 4. LayerNorm, gates and the new state of this block's units
    float* ht = hs + static_cast<long long>(t) * B * H;
    for (int idx = threadIdx.x; idx < B * units; idx += kThreads) {
      const int b = idx / units, u = idx % units, j = j0 + u;
      const float mu = stat[2 * b], inv = stat[2 * b + 1];
      const float* zb = zs + b * C;
      const float p1 = (zb[u] - mu) * inv * gamma[j] + beta[j];
      const float p2 = (zb[S + u] - mu) * inv * gamma[H + j] + beta[H + j];
      const float p3 = (zb[2 * S + u] - mu) * inv * gamma[2 * H + j] + beta[2 * H + j];
      const float reset = sigmoid_f(p1);
      const float cand = tanhf(reset * p2);
      const float update = sigmoid_f(p3 - 1.0f);
      const long long bj = static_cast<long long>(b) * H + j;
      const float hg = staged ? in[b * K + j] : blend(__ldcg(hprev + bj), __ldg(init_rec + bj), __ldg(ft + b));
      ht[static_cast<long long>(b) * H + j] = update * cand + (1.0f - update) * hg;
    }
    grid.sync();
  }
}

template <int S>
int launch(const float* h0, const float* xs, const float* w, const float* gamma, const float* beta,
           const float* is_first, const float* init_rec, float* hs, float* partials, int T, int B, int H, int X,
           float eps, cudaStream_t stream) {
  auto kernel = gru_sequence_kernel<S>;
  const int blocks = (H + S - 1) / S;
  const int K = H + X;
  int dev = 0, coop = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  // W's slice, z and the row statistics stay; the staged rows take the rest
  const size_t fixed =
      sizeof(float) * (static_cast<size_t>(3 * S) * K + static_cast<size_t>(B) * 3 * S + 2 * B + 2 * B * blocks);
  const long long room = (static_cast<long long>(optin) - static_cast<long long>(fixed)) / (sizeof(float) * K);
  if (room < 1) return static_cast<int>(cudaErrorInvalidValue);
  int chunk_rows = static_cast<int>(room < B ? room : B);
  const size_t smem = fixed + sizeof(float) * static_cast<size_t>(chunk_rows) * K;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<long long>(per_sm) * sms < blocks) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&h0, &xs, &w, &gamma, &beta, &is_first, &init_rec, &hs, &partials, &T, &B, &H, &X, &chunk_rows, &eps};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(blocks), dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// hs: (T, B, H) output; partials: (ceil(H / units), B, 2) f32 scratch;
// is_first: (T, B).  H and X multiples of 4, and h0, xs, init_rec and hs
// 16-byte aligned (rows are staged as float4).  units in [1, kMaxUnits]
// hidden units a block.  Returns
// the CUDA error of the launch (0 on success): cudaErrorCooperativeLaunchTooLarge
// (720) when the grid cannot be co-resident.
int sheeprl_gru_sequence_forward(const float* h0, const float* xs, const float* w, const float* gamma,
                                 const float* beta, const float* is_first, const float* init_rec, float* hs,
                                 float* partials, int T, int B, int H, int X, int units, float eps, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || X < 0 || H % 4 || X % 4) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (units) {
    case 1: return launch<1>(h0, xs, w, gamma, beta, is_first, init_rec, hs, partials, T, B, H, X, eps, s);
    case 2: return launch<2>(h0, xs, w, gamma, beta, is_first, init_rec, hs, partials, T, B, H, X, eps, s);
    case 3: return launch<3>(h0, xs, w, gamma, beta, is_first, init_rec, hs, partials, T, B, H, X, eps, s);
    case 4: return launch<4>(h0, xs, w, gamma, beta, is_first, init_rec, hs, partials, T, B, H, X, eps, s);
    case 5: return launch<5>(h0, xs, w, gamma, beta, is_first, init_rec, hs, partials, T, B, H, X, eps, s);
    case 6: return launch<6>(h0, xs, w, gamma, beta, is_first, init_rec, hs, partials, T, B, H, X, eps, s);
    case 7: return launch<7>(h0, xs, w, gamma, beta, is_first, init_rec, hs, partials, T, B, H, X, eps, s);
    case 8: return launch<8>(h0, xs, w, gamma, beta, is_first, init_rec, hs, partials, T, B, H, X, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
