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
// 67 TFLOP/s f32 rate, or 19.5 us as three TF32 passes on the tensor cores
// (495 TFLOP/s); its bytes (W once, xs, hs) are 10.6 MB, 3 us.  But the
// steps are sequential and each is small (16 rows): every step needs the
// whole previous state, and its LayerNorm needs the whole row of z, so a
// step is two dependencies across every block that holds a part of W, and
// at this size their latency, not the operations, sets the time.
//
// Two routes, chosen by the host (ops/seq_gru.py:sequence_route).
//
// The cluster route (gru_sequence_cluster), for H a multiple of 128 whose
// W[:H] and state fit 16 blocks' shared memory (H <= 512 at B <= 16):
//   0. Half of the product, xs @ W[H:], does not depend on the recurrence.
//      The host computes it before this launch for all T B rows in one
//      hand-written launch over the whole card (csrc/gru_cell.cu:
//      sheeprl_gru_input_product, 3xTF32 mma.sync): zx (T, B, 3H) f32.
//   1. One cluster of 16 blocks (a non-portable cluster size) runs the T
//      steps of z_t = hg_t @ W[:H] + zx[t].  Block r owns the U = H / 16
//      units [r U, (r + 1) U) and their 3U columns of W[:H], which it keeps
//      in shared memory for all steps, f32 in the order the mma.sync B
//      fragments read them (192 KB at H = 512: no padding, conflict-free
//      8-byte reads).  The whole hg (16 rows a tile, H columns, 32 KB at
//      H = 512) sits beside it, f32 in A-fragment order (pair_slot).  W's
//      slice does not fit the registers (96 a thread at 512 threads), so it
//      is read from shared memory once a step; nor do its two TF32 parts
//      fit shared memory (twice 192 KB), so it is kept f32 and split as it
//      is read, every step.
//   2. The product on the tensor cores in 3xTF32 (m16n8k8; each operand
//      split in registers into its TF32 part and the rest, small_tf32, as
//      csrc/gru_cell.cu does), the K = H rows split over 4 warps for each
//      group of 8 (or 16) units, so that a warp owns all three gates of its
//      units.  Each 64 K rows accumulate apart and are then added in f32:
//      the tensor cores' truncating sums lose about 2^-24 of the value a
//      product (gru_cell.cu does the same).
//   3. The 4 K groups' sums meet in shared memory (the hg buffer is free
//      once every warp has read it); the lanes that finish a unit add them
//      in a fixed order and zx[t], and each row's sum and sum of squares
//      over the block's columns go to every block of the cluster by
//      st.async, counted on each block's row-sum mbarrier.
//   4. Every block waits for the 16 blocks' row sums, adds them in block
//      order (the same bits in every block and every run), forms the
//      one-pass LayerNorm, the gates (expf, tanhf) and its units' new
//      state, gated by is_first[t + 1], to its slice of an exchange buffer
//      in global memory; one thread multicasts the slice into every
//      block's hg buffer (cp.async.bulk ... multicast::cluster), counted on
//      each block's state mbarrier, which the next step waits on; then
//      hs[t] and the next step's zx and is_first loads.  The loop has no
//      cluster barrier: each block waits only for the data it needs, and
//      the data orders the reuse of every buffer (a block sends step t + 1's
//      row sums only after it has every block's state, which each block
//      sends only after reading step t's row sums and scratch).
//
// The grid route (gru_sequence_kernel), for the other shapes: one
// cooperative launch (cudaLaunchCooperativeKernel) of one block per SM
// (grid sized with the occupancy API; the launch is refused, and the
// wrapper raises, when the grid cannot be co-resident).  Block k owns S
// hidden units j in [k S, (k + 1) S) and their three columns j, H + j,
// 2H + j of the whole W, which it keeps transposed in shared memory for
// all T steps.  At each step:
//   1. it stages the rows [hg, x_t] in shared memory (as many rows as the
//      rest of the SM's shared memory holds), with 16-byte loads that are
//      independent of each other, and reads init_rec only for rows that
//      reset; then its warps compute its 3S columns of z for every row, two
//      rows a warp at a time so each 16-byte read of W from shared memory
//      feeds eight FMAs; the K loop in a fixed order, the 32 lanes' sums
//      combined by a fixed shuffle tree;
//   2. it writes each row's partial sum and sum of squares over its columns
//      to a global scratch;  grid.sync();
//   3. every block copies all blocks' partials to shared memory and sums
//      them for every row in block order, forms mu and the one-pass
//      variance;
//   4. it applies gamma, beta and the gates to its S units and writes them
//      to hs[t];  grid.sync().
// hs[t] is the carried state: step t + 1 reads it back through L2.  The
// product runs on the FP32 units.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// ------------------------------------------------------------ cluster route

constexpr int kCluster = 16;  // blocks of the cluster route
constexpr int kKGroups = 4;   // warps that split K for one group of units

// small = a - tf32(a), exact; the tensor cores read a .tf32 operand's upper
// 19 bits, so a's own register serves as the big part, and a is kept to
// within 2^-20 (csrc/gru_cell.cu: small_tf32).
__device__ __forceinline__ uint32_t small_tf32(uint32_t v) {
  return __float_as_uint(__uint_as_float(v) - __uint_as_float(v & 0xffffe000u));
}

// Not volatile: a product has no side effects, and ptxas may then interleave
// the independent ones.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The state's hand-over: an mbarrier in each block counts the bytes of the
// 16 slices that the blocks multicast into it (cp.async.bulk ...
// multicast::cluster from the exchange buffer in global memory, one copy a
// slice lands in every block of the cluster at the same offset).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// this block's one arrival of the phase, and the bytes the phase waits for
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// wait for the phase of this parity to complete; a wait that never ends
// (a missing slice) traps, so the launch fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (int tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1 << 22)) __trap();
  }
}
// The row sums' hand-over: st.async of 8 bytes into a block of the cluster,
// counted on that block's mbarrier (addresses mapped with mapa).
__device__ __forceinline__ uint32_t map_rank(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_async(uint32_t addr, float2 v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n"
               ::"r"(addr), "f"(v.x), "f"(v.y), "r"(bar)
               : "memory");
}

// bytes of global memory at src to offset dst of every block's shared memory
// in the cluster, each counted on that block's bar
__device__ __forceinline__ void multicast(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster [%0], [%1], %2, [%3], %4;\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(static_cast<uint16_t>((1u << kCluster) - 1))
      : "memory");
}


// hg's buffer holds the state as the product takes it: per 16-row tile mt
// and group ks of 8 units, 32 lanes x 4 floats, lane (g, t) holding {row g,
// row g + 8} x {unit 2t, unit 2t + 1}.  The product reads the group's units
// in the order 0, 2, 4, 6, 1, 3, 5, 7 (W's slice is staged in the same
// order), so these are the rows and k of an m16n8k8 A fragment (a0..a3 =
// x, z, y, w), and the rows and columns of the C fragment the lane
// finishes: the lane that computes units 2t and 2t + 1 of a row writes
// them as one 8-byte pair.  pair_slot: the float of unit 2t.
__device__ __forceinline__ int pair_slot(int row, int k, int KS) {
  const int r = row & 15;
  return ((((row >> 4) * KS + (k >> 3)) * 32 + (r & 7) * 4 + ((k & 7) >> 1)) << 2) + (r >> 3) * 2;
}

// Shared memory of the cluster route, in floats (ops/seq_gru.py:
// cluster_smem_bytes computes the same): W[:H]'s slice, hg, every block's
// row sums, the unit groups' row sums and two mbarriers (the state's and
// the row sums').
__host__ __device__ constexpr int cluster_floats(int H, int MT) {
  return 3 * H * H / 16 + MT * 16 * H + kCluster * MT * 16 * 2 + (H / kCluster / 8) * MT * 16 * 2 + 4;
}

// MT tiles of 16 rows (B <= 16 MT); UG groups of 8 units a warp.  Block r of
// the one cluster owns units [r U, (r + 1) U), U = H / 16; warp w is unit
// group ng = w % NG (NG = U / (8 UG)) of K group kg = w / NG.  The step's
// last part runs on the warps kg < 2 UG: warp kg finishes unit group
// ng UG + kg / 2 of rows 16 mt + g + 8 (kg % 2), two units a lane.
template <int MT, int UG>
__global__ void __launch_bounds__(UG == 2 ? 256 : 384) gru_sequence_cluster(
    const float* __restrict__ h0, const float* __restrict__ zx, const float* __restrict__ w,
    const float* __restrict__ gamma, const float* __restrict__ beta, const float* __restrict__ is_first,
    const float* __restrict__ init_rec, float* __restrict__ hs, float* __restrict__ xg, int T, int B, int H,
    float eps) {
  constexpr int R = 16 * MT;  // rows of the tiles
  constexpr int J = 3 * UG;   // a warp's n-tiles: gates 0, 1, 2 of each of its unit groups
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int U = H / kCluster, NT = 3 * U / 8, KS = H / 8, KSW = KS / kKGroups, NG = U / (8 * UG);
  const int j0 = rank * U;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ng = warp % NG, kg = warp / NG;
  const int g = lane >> 2, tq = lane & 3;
  const int N = 3 * H;
  const float inv_n = 1.0f / static_cast<float>(N);
  extern __shared__ __align__(16) float smem[];
  float* wf = smem;                      // (KS, NT, 32 lanes, 2): W[:H]'s slice as B fragments
  float* hgb = wf + 3 * H * H / 16;      // (MT, KS, 32 lanes, 4): hg, see pair_slot
  float* lns = hgb + MT * 16 * H;        // (16 blocks, R, 2): every block's row sum and sum of squares
  float* rowp = lns + kCluster * R * 2;  // (U / 8, R, 2): this block's unit groups' row sums
  uint64_t* mbar = reinterpret_cast<uint64_t*>(rowp + U / 8 * R * 2);  // the state's arrival
  uint64_t* sbar = mbar + 1;                                           // the row sums' arrival
  const uint32_t state_bytes = sizeof(float) * R * H, sums_bytes = sizeof(float2) * kCluster * R;

  // W[:H]'s columns of this block in B-fragment order (b0, b1: rows 2t and
  // 2t + 1 of the group, see pair_slot).  Item i covers lanes (g, t) of
  // n-tile jn at step ks for t = i % 4 and the 4 columns g of half
  // (i / 4) % 2, (ks, jn) = i / 8: it reads rows 2t and 2t + 1 of the group
  // of 8 as two 16-byte vectors (a warp reads 8 rows x 32 bytes of 4 tiles)
  // and writes 4 fragments.
  {
    const int items = KS * NT * 8;
    for (int base = threadIdx.x; base < items; base += 8 * blockDim.x) {
      float4 v[8][2];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int item = base + i * blockDim.x;
        if (item < items) {
          const int f = item >> 3, ks = f / NT, jn = f - ks * NT;
          const float* src = w + static_cast<long long>(ks * 8 + 2 * (item & 3)) * N + (jn % 3) * H + j0 +
                             (jn / 3) * 8 + ((item >> 2) & 1) * 4;
          v[i][0] = __ldg(reinterpret_cast<const float4*>(src));
          v[i][1] = __ldg(reinterpret_cast<const float4*>(src + N));
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int item = base + i * blockDim.x;
        if (item < items) {
          float2* dst = reinterpret_cast<float2*>(wf) + (item >> 3) * 32 + ((item >> 2) & 1) * 16 + (item & 3);
          dst[0] = make_float2(v[i][0].x, v[i][1].x);  // lane (g, t), g = 4 half + q
          dst[4] = make_float2(v[i][0].y, v[i][1].y);
          dst[8] = make_float2(v[i][0].z, v[i][1].z);
          dst[12] = make_float2(v[i][0].w, v[i][1].w);
        }
      }
    }
  }
  // hg_0 for all rows (every block computes the whole of it; rows past B 0),
  // four units a thread at a time, all of a thread's loads in flight at once
  {
    constexpr int kPer = 8;
    const int total = R * H / 4;
    for (int base = threadIdx.x; base < total; base += kPer * blockDim.x) {
      float4 v[kPer];
      float f[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int idx = base + i * blockDim.x, row = idx * 4 / H;
        const bool ok = idx < total && row < B;
        v[i] = ok ? __ldg(reinterpret_cast<const float4*>(h0) + idx) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        f[i] = ok ? __ldg(is_first + row) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int idx = base + i * blockDim.x;
        if (idx >= total) continue;
        if (f[i] != 0.0f) {
          const float4 r = __ldg(reinterpret_cast<const float4*>(init_rec) + idx);
          v[i] = make_float4(blend(v[i].x, r.x, f[i]), blend(v[i].y, r.y, f[i]), blend(v[i].z, r.z, f[i]),
                             blend(v[i].w, r.w, f[i]));
        }
        const int row = idx * 4 / H, k = idx * 4 - row * H;
        *reinterpret_cast<float2*>(hgb + pair_slot(row, k, KS)) = make_float2(v[i].x, v[i].y);
        *reinterpret_cast<float2*>(hgb + pair_slot(row, k + 2, KS)) = make_float2(v[i].z, v[i].w);
      }
    }
  }
  __syncthreads();

  // the finishing lanes keep their units' hg, gamma and beta in registers
  const bool fin = kg < 2 * UG;
  const int hi = kg & 1;
  const int ks_own = j0 / 8 + ng * UG + (kg >> 1);  // the lane's group of 8 units
  const int ju = ks_own * 8 + 2 * tq;               // its first unit
  float hreg[MT][2], gm[3][2], bt[3][2];
  float2 init[MT];  // init_rec of the lane's row and units, for the steps that reset
  if (fin) {
#pragma unroll
    for (int gate = 0; gate < 3; ++gate)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        gm[gate][c] = gamma[gate * H + ju + c];
        bt[gate][c] = beta[gate * H + ju + c];
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int row = mt * 16 + g + 8 * hi;
      float2 v = make_float2(0.0f, 0.0f);
      init[mt] = v;
      if (row < B) {
        v = *reinterpret_cast<const float2*>(h0 + static_cast<long long>(row) * H + ju);
        init[mt] = *reinterpret_cast<const float2*>(init_rec + static_cast<long long>(row) * H + ju);
        const float f = is_first[row];
        if (f != 0.0f) v = make_float2(blend(v.x, init[mt].x, f), blend(v.y, init[mt].y, f));
      }
      hreg[mt][0] = v.x;
      hreg[mt][1] = v.y;
    }
  }
  // the finishing lanes' zx[t] (their 3 gates x 2 units) and is_first[t + 1],
  // loaded a step ahead, while the block waits at the state's barrier
  float2 zv[MT][3];
  float fnext[MT];
  auto prefetch = [&](int t) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int row = mt * 16 + g + 8 * hi;
      const bool ok = fin && row < B;
#pragma unroll
      for (int gate = 0; gate < 3; ++gate)
        zv[mt][gate] = ok ? __ldg(reinterpret_cast<const float2*>(zx + (static_cast<long long>(t) * B + row) * N +
                                                                   gate * H + ju))
                          : make_float2(0.0f, 0.0f);
      fnext[mt] = ok && t + 1 < T ? __ldg(is_first + static_cast<long long>(t + 1) * B + row) : 0.0f;
    }
  };
  prefetch(0);
  if (threadIdx.x == 0) {
    mbar_init(mbar);
    mbar_init(sbar);
    if (T > 1) mbar_expect(mbar, state_bytes);  // hg_1
    mbar_expect(sbar, sums_bytes);               // step 0's row sums
  }
  cluster.sync();  // every block runs (its mbarrier set) before any block writes another's shared memory

  for (int t = 0; t < T; ++t) {
    const bool more = t + 1 < T;
    if (t > 0) {
      mbar_wait(mbar, (t - 1) & 1);  // hg_t is whole in this block's buffer
      if (threadIdx.x == 0 && more) mbar_expect(mbar, state_bytes);  // hg_{t+1}
    }

    // 1. this warp's K rows of hg @ W[:H] on its n-tiles in 3xTF32, each
    //    64 K rows into one accumulator a pass (so that no product waits
    //    for the one before it), then added to acc: (small big + big small)
    //    + big big
    float acc[MT][J][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int jj = 0; jj < J; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][jj][e] = 0.0f;
    const float2* wq = reinterpret_cast<const float2*>(wf) + (kg * KSW * NT + ng * J) * 32 + lane;
    const float* aq = hgb + (kg * KSW * 32 + lane) * 4;
    for (int s0 = 0; s0 < KSW; s0 += 8) {
      float part[3][MT][J][4];
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int jj = 0; jj < J; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[p][mt][jj][e] = 0.0f;
      const int s1 = s0 + 8 < KSW ? s0 + 8 : KSW;
#pragma unroll 2
      for (int s = s0; s < s1; ++s) {
        uint32_t ab[MT][4], as[MT][4], bb[J][2], bs[J][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float4 a = *reinterpret_cast<const float4*>(aq + (mt * KS + s) * 128);
          ab[mt][0] = __float_as_uint(a.x);
          ab[mt][1] = __float_as_uint(a.z);
          ab[mt][2] = __float_as_uint(a.y);
          ab[mt][3] = __float_as_uint(a.w);
#pragma unroll
          for (int e = 0; e < 4; ++e) as[mt][e] = small_tf32(ab[mt][e]);
        }
#pragma unroll
        for (int jj = 0; jj < J; ++jj) {
          const float2 b = wq[(s * NT + jj) * 32];
          bb[jj][0] = __float_as_uint(b.x);
          bb[jj][1] = __float_as_uint(b.y);
          bs[jj][0] = small_tf32(bb[jj][0]);
          bs[jj][1] = small_tf32(bb[jj][1]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int jj = 0; jj < J; ++jj) mma_tf32(part[0][mt][jj], as[mt], bb[jj][0], bb[jj][1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int jj = 0; jj < J; ++jj) mma_tf32(part[1][mt][jj], ab[mt], bs[jj][0], bs[jj][1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int jj = 0; jj < J; ++jj) mma_tf32(part[2][mt][jj], ab[mt], bb[jj][0], bb[jj][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int jj = 0; jj < J; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][jj][e] += (part[0][mt][jj][e] + part[1][mt][jj][e]) + part[2][mt][jj][e];
    }
    __syncthreads();  // every warp has read hg: its buffer is the K groups' scratch

    // 2. every K group's sums to the scratch; the finishing lanes add the
    //    four for their units in group order, then zx[t]
    float4* scratch = reinterpret_cast<float4*>(hgb);
    auto slot = [&](int k, int mt, int jj) { return (((k * NG + ng) * MT + mt) * J + jj) * 32 + lane; };
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int jj = 0; jj < J; ++jj)
        scratch[slot(kg, mt, jj)] = make_float4(acc[mt][jj][0], acc[mt][jj][1], acc[mt][jj][2], acc[mt][jj][3]);
    __syncthreads();
    float z[MT][3][2];
    if (fin) {
      const float* sc = reinterpret_cast<const float*>(hgb) + 2 * hi;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float sum = 0.0f, sq = 0.0f;
#pragma unroll
        for (int gate = 0; gate < 3; ++gate) {
          const int jj = (kg >> 1) * 3 + gate;
          float2 v = *reinterpret_cast<const float2*>(sc + 4 * slot(0, mt, jj));
#pragma unroll
          for (int k = 1; k < kKGroups; ++k) {
            const float2 p = *reinterpret_cast<const float2*>(sc + 4 * slot(k, mt, jj));
            v.x += p.x;
            v.y += p.y;
          }
          z[mt][gate][0] = v.x + zv[mt][gate].x;
          z[mt][gate][1] = v.y + zv[mt][gate].y;
          sum += z[mt][gate][0] + z[mt][gate][1];
          sq = fmaf(z[mt][gate][0], z[mt][gate][0], sq);
          sq = fmaf(z[mt][gate][1], z[mt][gate][1], sq);
        }
        // over the 4 lanes of the row (a butterfly: every lane the same bits)
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
          sq += __shfl_xor_sync(0xffffffffu, sq, off);
        }
        if (tq == 0) {
          float* dst = rowp + ((ng * UG + (kg >> 1)) * R + mt * 16 + g + 8 * hi) * 2;
          dst[0] = sum;
          dst[1] = sq;
        }
      }
    }
    __syncthreads();
    // 3. the block's row sums (unit groups in order) to every block
    if (threadIdx.x < R) {
      const int row = threadIdx.x;
      float2 v = make_float2(0.0f, 0.0f);
      for (int n = 0; n < U / 8; ++n) {
        v.x += rowp[(n * R + row) * 2];
        v.y += rowp[(n * R + row) * 2 + 1];
      }
      float* dst = lns + (rank * R + row) * 2;
      for (int r = 0; r < kCluster; ++r) st_async(map_rank(dst, r), v, map_rank(sbar, r));
    }

    // 4. LayerNorm from the 16 blocks' sums in block order, gates, the new
    //    state to hs[t] and, gated by is_first[t + 1], to every block's hg
    float2 hout[MT];
    if (fin) {
      mbar_wait(sbar, t & 1);  // every block's row sums have arrived
      if (threadIdx.x == 0 && more) mbar_expect(sbar, sums_bytes);  // step t + 1's
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row = mt * 16 + g + 8 * hi;
        float sum = 0.0f, sq = 0.0f;
        for (int r = 0; r < kCluster; ++r) {
          const float2 p = *reinterpret_cast<const float2*>(lns + (r * R + row) * 2);
          sum += p.x;
          sq += p.y;
        }
        const float mu = sum * inv_n;
        const float rstd = rsqrtf(fmaxf(sq * inv_n - mu * mu, 0.0f) + eps);
        float hn[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float pr = (z[mt][0][c] - mu) * rstd * gm[0][c] + bt[0][c];
          const float pc = (z[mt][1][c] - mu) * rstd * gm[1][c] + bt[1][c];
          const float pu = (z[mt][2][c] - mu) * rstd * gm[2][c] + bt[2][c];
          const float reset = sigmoid_f(pr);
          const float cand = tanhf(reset * pc);
          const float update = sigmoid_f(pu - 1.0f);
          hn[c] = update * cand + (1.0f - update) * hreg[mt][c];
        }
        hout[mt] = make_float2(hn[0], hn[1]);
        if (more) {
          const float f = fnext[mt];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float v = row < B ? hn[c] : 0.0f;
            hreg[mt][c] = f != 0.0f ? blend(v, c ? init[mt].y : init[mt].x, f) : v;
          }
          *reinterpret_cast<float2*>(xg + pair_slot(row, ju, KS)) = make_float2(hreg[mt][0], hreg[mt][1]);
        }
      }
      asm volatile("fence.proxy.async.global;\n" ::: "memory");  // the slice, to the bulk copy's reads
    }
    if (more) {
      __syncthreads();  // this block's slice of hg_{t+1} is whole in the exchange buffer
      if (threadIdx.x == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int off = (mt * KS + j0 / 8) * 128;
          multicast(hgb + off, xg + off, sizeof(float) * 16 * U, mbar);
        }
      }
    }
    if (fin) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row = mt * 16 + g + 8 * hi;
        if (row < B) *reinterpret_cast<float2*>(hs + (static_cast<long long>(t) * B + row) * H + ju) = hout[mt];
      }
      if (more) prefetch(t + 1);
    }
  }
  cluster.sync();  // no block leaves while another's copies to it may be in flight
}

template <int MT, int UG>
cudaLaunchConfig_t cluster_config(int H, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(32 * kKGroups * (H / kCluster / (8 * UG)));
  cfg.dynamicSmemBytes = sizeof(float) * static_cast<size_t>(cluster_floats(H, MT));
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The kernel's attributes for the current device (the non-portable cluster
// size, and all the shared memory a block may opt in to, so that one setting
// serves every H), and whether one cluster of 16 blocks at H fits.
template <int MT, int UG>
int prepare_cluster(int H) {
  auto kernel = gru_sequence_cluster<MT, UG>;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config<MT, UG>(H, nullptr, attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  return clusters < 1 ? static_cast<int>(cudaErrorLaunchOutOfResources) : 0;
}

template <int MT, int UG>
int launch_cluster(const float* h0, const float* zx, const float* w, const float* gamma, const float* beta,
                   const float* is_first, const float* init_rec, float* hs, float* xg, int T, int B, int H,
                   float eps, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config<MT, UG>(H, stream, attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, gru_sequence_cluster<MT, UG>, h0, zx, w, gamma, beta, is_first,
                                             init_rec, hs, xg, T, B, H, eps);
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

// Shared memory a block of the current device may opt in to.
int sheeprl_gru_sequence_smem_optin() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) return 0;
  return optin;
}

// The cluster route's shared memory in bytes (0 for a shape it does not
// take): ops/seq_gru.py:cluster_smem_bytes must agree.
long long sheeprl_gru_sequence_cluster_smem(int H, int B) {
  if (H <= 0 || H % 128 || B <= 0 || B > 32) return 0;
  return static_cast<long long>(sizeof(float)) * cluster_floats(H, (B + 15) / 16);
}

// The cluster route's attributes on the current device, and whether a
// cluster of 16 blocks at (H, B) fits: 0, or the CUDA error
// (cudaErrorLaunchOutOfResources when no cluster fits).  Once a device and
// shape, before the first sheeprl_gru_sequence_cluster.
int sheeprl_gru_sequence_cluster_prepare(int H, int B) {
  if (B <= 0 || B > 32 || H <= 0 || H % 128) return static_cast<int>(cudaErrorInvalidValue);
  const bool two = (H / kCluster) % 16 == 0;
  if (B <= 16) return two ? prepare_cluster<1, 2>(H) : prepare_cluster<1, 1>(H);
  return two ? prepare_cluster<2, 2>(H) : prepare_cluster<2, 1>(H);
}

// The cluster route: hs (T, B, H) from zx = xs @ W[H:] (T, B, 3H), computed
// before, and W's first H rows.  xg: 16 ceil(B / 16) x H f32 scratch, 16-byte
// aligned, through which the blocks pass the state.  H a multiple of 128
// (U = H / 16 units a block, in groups of 8), B <= 32, T >= 1; h0, zx,
// init_rec and hs 8-byte aligned, w 16-byte aligned; the shape prepared by
// sheeprl_gru_sequence_cluster_prepare.  Returns the CUDA error of the
// launch (0 on success).
int sheeprl_gru_sequence_cluster(const float* h0, const float* zx, const float* w, const float* gamma,
                                 const float* beta, const float* is_first, const float* init_rec, float* hs,
                                 float* xg, int T, int B, int H, float eps, void* stream) {
  if (T <= 0 || B <= 0 || B > 32 || H <= 0 || H % 128) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool two = (H / kCluster) % 16 == 0;
  if (B <= 16) {
    return two ? launch_cluster<1, 2>(h0, zx, w, gamma, beta, is_first, init_rec, hs, xg, T, B, H, eps, s)
               : launch_cluster<1, 1>(h0, zx, w, gamma, beta, is_first, init_rec, hs, xg, T, B, H, eps, s);
  }
  return two ? launch_cluster<2, 2>(h0, zx, w, gamma, beta, is_first, init_rec, hs, xg, T, B, H, eps, s)
             : launch_cluster<2, 1>(h0, zx, w, gamma, beta, is_first, init_rec, hs, xg, T, B, H, eps, s);
}

}  // extern "C"
