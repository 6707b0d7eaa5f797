// One LayerNorm-GRU step for Hopper (sm_90a), with a plain C interface bound
// through ctypes (sheeprl_tpu_torch/ops/gru_cell.py builds and loads it).
//
// Replaces sheeprl_tpu/ops/pallas_gru.py:_gru_kernel (the pallas_call of
// fused_gru_cell).  For h (B,H) f32, x (B,X) f32|bf16, W (H+X,3H) f32|bf16
// stored row-major as the JAX package stores it, gamma/beta (3H,) f32:
//
//   parts = [h | x] @ W            operands rounded to W's type, f32 sums
//   parts = bf16(parts)            only with round_parts: the unfused flax
//                                  cell under bf16 rounds its product
//   parts = LN(parts) over 3H      two-pass variance (the fused kernel) or
//                                  max(E[p^2]-E[p]^2, 0) (the flax cell)
//   r = sigmoid(parts[:H]); c = tanh(r * parts[H:2H]); u = sigmoid(parts[2H:] - 1)
//   h' = u * c + (1 - u) * h       (B,H) f32
//
// What bounds it on an H100.  The product is 2*B*K*3H operations (K = H+X).
// For f32 W the least time of an f32-accurate product is on the tensor cores
// as three TF32 passes (495 TFLOP/s each): at DV3-XL imagination (B=1024,
// H=4096, X=1024) 3 x 128.8 GFLOP, 0.78 ms.  mma.sync, which this kernel
// issues, reaches about 320 TFLOP/s of TF32 on an H100 SXM at 700 W
// (chip_smoke.py --gru-bench), so this design cannot go below 1.21 ms there;
// only wgmma reaches the full rate.  A serving or scan step (B <= 64)
// reads the whole of W once: 252 MB in f32, 126 MB in bf16, 75 us and 38 us at
// 3.35 TB/s, which is more than its tensor-core time.
//
// What the design does about it.  The TPU kernel keeps a (block_b, 3H) f32 row
// in VMEM and walks K in order; a Hopper block has neither the memory nor the
// order, so the step is two launches:
//   A  gru_mma: a tiled product on the tensor cores with mma.sync.  A block
//      owns BM batch rows (128, 64 or 16, chosen in ops/gru_cell.py:split_k
//      so that every shape fills the 132 SMs) x 128 output columns and one
//      slice of the K tiles; 8 warps, each a (BM/WM) x (128/WN) warp tile.
//      K is walked in tiles of 64 (128-row blocks) or 32 rows: first the h
//      segment, then the x segment, each tile zero-filled past its
//      segment's end, so a tile never straddles h and x and [h | x] is
//      never written out.  A 3- or 4-stage cp.async ring of 16-byte copies
//      stages both the activation tile and the W tile in shared memory
//      (zero-filled copies past B, N and the segment), two or three tiles
//      ahead of the one the warps multiply; rows are padded so that every
//      fragment load is free of bank conflicts.
//        f32 W: 3xTF32.  Each f32 operand a is split in registers into
//          big = a cut to TF32 and small = a - big, and each 8-deep step
//          issues m16n8k8 TF32 mma three times into one f32 accumulator,
//          small terms first (a_small b_big, a_big b_small, a_big b_big).
//          The dropped small*small term is ~2^-20 of each product; every
//          64 K rows the products' accumulator is added to the block's sum
//          on the CUDA cores (see gru_mma), so the result stays at f32
//          rounding level.
//        bf16 W: m16n8k16 bf16 mma; W's fragments come straight from its
//          row-major tile through ldmatrix.trans, the activations are
//          rounded to bf16 (nearest even) as the fragments are built.
//      Each block writes its f32 partial sums to its own slice of the
//      scratch: no atomics, a fixed order.
//   B  gru_ln_gates: one block per batch row sums the K slices in order
//      (rounding to bf16 with round_parts), then computes the mean, the
//      variance and h' for its row.
// Left for later work: wgmma (TF32 wgmma needs a K-major B, so a K-major copy
// of W kept per weight version), TMA, and the LayerNorm sums in launch A.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps a product block
constexpr int kBN = 128;       // output columns a product block
constexpr int kLnThreads = 512;

typedef __nv_bfloat16 bf16;

// Row strides of the staged tiles, in elements, padded so that fragment
// reads hit distinct banks.  W: 136, i.e. 8 mod 32 words in f32 (the TF32
// reads of rows t and t+4 by lane (g, t)) and 272 B in bf16 (ldmatrix's
// eight 16-byte rows).  Activations: an f32 tile for TF32 is read with
// ldmatrix, 144 B rows; every other tile with 4- or 8-byte reads, 40
// elements (f32 160 B, bf16 80 B), which keeps 16-byte rows for cp.async.
constexpr int kLdW = kBN + 8;
template <typename TW, typename TA, int BK>
__host__ __device__ constexpr int lda() { return sizeof(TW) == 4 && sizeof(TA) == 4 ? BK + 4 : BK + 8; }

template <typename TW, int BM>
struct Tile {
  static constexpr int kWarpsM = BM == 16 ? 1 : 2;
  static constexpr int kWarpsN = 8 / kWarpsM;
  static constexpr int kMT = BM / kWarpsM / 16;  // 16-row MMA tiles a warp
  static constexpr int kNT = kBN / kWarpsN / 8;  // 8-column MMA tiles a warp
  // K rows a tile and the cp.async ring's depth: 128-row blocks (one an SM)
  // take 64-deep tiles in three stages, half the barriers of 32-deep ones;
  // the smaller blocks (two an SM) take 32-deep tiles in four stages.
  static constexpr int kBK = BM == 128 ? 64 : 32;
  static constexpr int kStages = BM == 128 ? 3 : 4;
  static constexpr int kABytes = BM * (kBK + 8) * 4;  // the widest activation tile
  static constexpr int kStageBytes = kABytes + kBK * kLdW * (int)sizeof(TW);
  static constexpr int kSmem = kStages * kStageBytes;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !ok (src is then unread).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                                  const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p)));
}

// Two adjacent activations as one bf16x2 register, the lower column in the
// low half: rounded to nearest even from f32, or read as they are.
__device__ __forceinline__ uint32_t pair_bf16(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  const __nv_bfloat162 r = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<const uint32_t*>(&r);
}
__device__ __forceinline__ uint32_t pair_bf16(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// The activation fragment of a 16-row MMA tile for TF32 (a0..a3: rows g,
// g+8 at k = t, then rows g, g+8 at k = t+4), in four consecutive registers
// as the MMA takes them.  f32: one ldmatrix.x4, reading each f32 as a pair
// of b16 (lanes 0-7 address rows 0-7 at k = 0, 8-15 rows 8-15, 16-31 the
// same at k = 4).  bf16 x: four reads, widened.
template <int BK>
__device__ __forceinline__ void frag_a_tf32(uint32_t (&r)[4], const float* a, int row0, int kk, int lane) {
  constexpr int kLd = lda<float, float, BK>();
  ldmatrix_x4(r, a + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd + kk + (lane >> 4) * 4);
}
template <int BK>
__device__ __forceinline__ void frag_a_tf32(uint32_t (&r)[4], const bf16* a, int row0, int kk, int lane) {
  constexpr int kLd = lda<float, bf16, BK>();
  const bf16* q = a + (row0 + (lane >> 2)) * kLd + kk + (lane & 3);
  r[0] = __float_as_uint(__bfloat162float(q[0]));
  r[1] = __float_as_uint(__bfloat162float(q[8 * kLd]));
  r[2] = __float_as_uint(__bfloat162float(q[4]));
  r[3] = __float_as_uint(__bfloat162float(q[8 * kLd + 4]));
}

// small = a - tf32(a), exact; the tensor cores read a .tf32 operand's upper
// 19 bits, so a's own register serves as big, and small is cut to within
// 2^-20 of a.  (cvt.rna.tf32.f32 for both parts would cost two conversions a
// value more and gain nothing visible after the LayerNorm:
// tests/test_torch_gru_cell.py.)
__device__ __forceinline__ uint32_t small_tf32(uint32_t v) {
  return __float_as_uint(__uint_as_float(v) - __uint_as_float(v & 0xffffe000u));
}

// One staged tile's product, f32 W: four 8-deep steps of 3xTF32 into part.
// a: the (BM, BK) activation tile, w: the (BK, kBN) W tile.  The three
// passes go over all of the warp's tiles in turn, so that consecutive
// products are independent.
template <int BK, typename TA, int MT, int NT>
__device__ __forceinline__ void tile_tf32(const TA* a, const float* w, float (&part)[MT][NT][4], int wm0, int wn0,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 8) {
    uint32_t bb[NT][2], bs[NT][2], ab[MT][4], as[MT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* p = w + (kk + t) * kLdW + wn0 + j * 8 + g;
      bb[j][0] = __float_as_uint(p[0]);
      bb[j][1] = __float_as_uint(p[4 * kLdW]);
      bs[j][0] = small_tf32(bb[j][0]);
      bs[j][1] = small_tf32(bb[j][1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      frag_a_tf32<BK>(ab[i], a, wm0 + i * 16, kk, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) as[i][e] = small_tf32(ab[i][e]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(part[i][j], as[i], bb[j][0], bb[j][1]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(part[i][j], ab[i], bs[j][0], bs[j][1]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(part[i][j], ab[i], bb[j][0], bb[j][1]);
  }
}

// One staged tile's product, bf16 W: two 16-deep steps of bf16 mma.
template <int BK, typename TA, int MT, int NT>
__device__ __forceinline__ void tile_bf16(const TA* a, const bf16* w, float (&acc)[MT][NT][4], int wm0, int wn0,
                                          int lane) {
  constexpr int kLd = lda<bf16, TA, BK>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t b[NT][2];
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      // lanes 0-7 address k rows kk..kk+7 and 8-15 rows kk+8..kk+15 at column
      // block j; lanes 16-31 the same rows at column block j+1
      const int r = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int c = wn0 + j * 8 + (lane >> 4) * 8;
      ldmatrix_x4_trans(b[j][0], b[j][1], b[j + 1][0], b[j + 1][1], w + r * kLdW + c);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const TA* q = a + (wm0 + i * 16 + g) * kLd + kk + 2 * t;
      uint32_t af[4];
      af[0] = pair_bf16(q);
      af[1] = pair_bf16(q + 8 * kLd);
      af[2] = pair_bf16(q + 8);
      af[3] = pair_bf16(q + 8 * kLd + 8);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af, b[j][0], b[j][1]);
    }
  }
}

template <int BK, typename TA, int MT, int NT>
__device__ __forceinline__ void tile_mma(const TA* a, const float* w, float (&acc)[MT][NT][4], int wm0, int wn0,
                                         int lane) {
  tile_tf32<BK, TA, MT, NT>(a, w, acc, wm0, wn0, lane);
}
template <int BK, typename TA, int MT, int NT>
__device__ __forceinline__ void tile_mma(const TA* a, const bf16* w, float (&acc)[MT][NT][4], int wm0, int wn0,
                                         int lane) {
  tile_bf16<BK, TA, MT, NT>(a, w, acc, wm0, wn0, lane);
}

// One thread's share of a tile's 16-byte copies: chunk `col` of rows
// row, row + kStep, ...  (kPasses of them) of a (ROWS, COLS) tile of T.
// The addresses are worked out once per block; a tile then costs one
// pointer add and one predicate per copy.
template <typename T, int ROWS, int COLS>
struct Copies {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kPerRow = COLS / kVec;
  static constexpr int kStep = kThreads / kPerRow;
  static constexpr int kPasses = (ROWS + kStep - 1) / kStep;
  static_assert(kThreads % kPerRow == 0, "a row's chunks must not straddle threads");
  int row, col;
  __device__ __forceinline__ Copies() : row(threadIdx.x / kPerRow), col((threadIdx.x % kPerRow) * kVec) {}
  __device__ __forceinline__ bool in_tile(int j) const { return ROWS % kStep == 0 || row + j * kStep < ROWS; }
};

// Launch A.  Grid (ceil(B/BM), ceil(N/kBN), S); block z owns K tiles
// [z*ts, min(T, (z+1)*ts)) of the T = ceil(H/BK) + ceil(X/BK) tiles;
// partials is (S, B, N).  The step passes N = 3H; the sequence's input
// product (sheeprl_gru_input_product) passes H = 0, so K is x's alone.
template <typename TW, typename TX, int BM>
__global__ void __launch_bounds__(kThreads, BM == 128 ? 1 : 2) gru_mma(
    const float* __restrict__ h, const TX* __restrict__ x, const TW* __restrict__ w,
    float* __restrict__ partials, int B, int H, int X, int N, int ts) {
  using T = Tile<TW, BM>;
  constexpr int kBK = T::kBK, kStages = T::kStages;
  constexpr int kLdH = lda<TW, float, kBK>(), kLdX = lda<TW, TX, kBK>();
  extern __shared__ __align__(16) unsigned char smem[];

  const int b0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int th = (H + kBK - 1) / kBK;
  const int t_begin = blockIdx.z * ts;
  const int n_tiles = min(th + (X + kBK - 1) / kBK, t_begin + ts) - t_begin;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm0 = (warp / T::kWarpsN) * (BM / T::kWarpsM);
  const int wn0 = (warp % T::kWarpsN) * (kBN / T::kWarpsN);

  auto stage = [&](int s) { return smem + s * T::kStageBytes; };
  auto stage_w = [&](int s) { return reinterpret_cast<TW*>(stage(s) + T::kABytes); };

  // The copy plans: W's (kBK, kBN) tile and the (BM, kBK) tiles of h and x.
  // Rows past B, columns past N and K rows past the segment are zero-filled.
  const Copies<TW, kBK, kBN> cw;
  const Copies<float, BM, kBK> ch;
  const Copies<TX, BM, kBK> cx;
  const TW* w_src = w + (size_t)cw.row * N + n0 + cw.col;
  const bool w_col_ok = n0 + cw.col < N;
  const size_t w_step = (size_t)cw.kStep * N;
  const float* h_src = h + (size_t)(b0 + ch.row) * H + ch.col;
  const size_t h_step = (size_t)ch.kStep * H;
  const TX* x_src = x + (size_t)(b0 + cx.row) * X + cx.col;
  const size_t x_step = (size_t)cx.kStep * X;
  unsigned h_rows = 0, x_rows = 0;  // bit j: pass j's row is a row of the batch
#pragma unroll
  for (int j = 0; j < ch.kPasses; ++j) h_rows |= (unsigned)(b0 + ch.row + j * ch.kStep < B) << j;
#pragma unroll
  for (int j = 0; j < cx.kPasses; ++j) x_rows |= (unsigned)(b0 + cx.row + j * cx.kStep < B) << j;

  auto load = [&](int i) {
    const int t = t_begin + i, s = i % kStages;
    int k0, k_end;  // the tile's rows of W and where its segment ends
    if (t < th) {
      k0 = t * kBK;
      k_end = H;
      float* a = reinterpret_cast<float*>(stage(s)) + ch.row * kLdH + ch.col;
      const float* src = h_src + k0;
      const bool k_ok = k0 + ch.col < H;
#pragma unroll
      for (int j = 0; j < ch.kPasses; ++j, src += h_step) {
        if (!ch.in_tile(j)) continue;
        const bool ok = k_ok && (h_rows >> j & 1u);
        cp_async16(a + j * ch.kStep * kLdH, ok ? src : h, ok);
      }
    } else {
      k0 = H + (t - th) * kBK;
      k_end = H + X;
      TX* a = reinterpret_cast<TX*>(stage(s)) + cx.row * kLdX + cx.col;
      const TX* src = x_src + (k0 - H);
      const bool k_ok = k0 - H + cx.col < X;
#pragma unroll
      for (int j = 0; j < cx.kPasses; ++j, src += x_step) {
        if (!cx.in_tile(j)) continue;
        const bool ok = k_ok && (x_rows >> j & 1u);
        cp_async16(a + j * cx.kStep * kLdX, ok ? src : x, ok);
      }
    }
    TW* ws = stage_w(s) + cw.row * kLdW + cw.col;
    const TW* src = w_src + (size_t)k0 * N;
    const int k_left = k_end - k0 - cw.row;  // pass j copies a row of the segment if j * kStep < k_left
#pragma unroll
    for (int j = 0; j < cw.kPasses; ++j, src += w_step) {
      const bool ok = w_col_ok && j * cw.kStep < k_left;
      cp_async16(ws + j * cw.kStep * kLdW, ok ? src : w, ok);
    }
  };

  // f32 W: the tensor cores add into their f32 accumulator rounding toward
  // zero, so a sum carried through all of K's 3 x K/8 products shrinks by
  // ~K/8 x 2^-24 of itself (5e-5 of the normalised parts at K = 5120, over
  // the f32 tolerance).  The products of 64 K rows go to part, which is then
  // added to acc on the CUDA cores, rounding to nearest.  bf16 W
  // accumulates into acc directly: its tolerance is 100 times wider.
  constexpr bool kFold = sizeof(TW) == 4;
  constexpr int kFoldTiles = 64 / kBK;
  float acc[T::kMT][T::kNT][4], part[T::kMT][T::kNT][4];
#pragma unroll
  for (int i = 0; i < T::kMT; ++i)
#pragma unroll
    for (int j = 0; j < T::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = part[i][j][e] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();  // tile i has landed (this thread's copies)
    __syncthreads();               // everyone's copies, and tile i-1 is consumed
    if (i + kStages - 1 < n_tiles) load(i + kStages - 1);
    cp_async_commit();
    const int s = i % kStages;
    auto& sum = kFold ? part : acc;
    if (t_begin + i < th)
      tile_mma<kBK, float>(reinterpret_cast<const float*>(stage(s)), stage_w(s), sum, wm0, wn0, lane);
    else
      tile_mma<kBK, TX>(reinterpret_cast<const TX*>(stage(s)), stage_w(s), sum, wm0, wn0, lane);
    if (kFold && (i % kFoldTiles == kFoldTiles - 1 || i == n_tiles - 1)) {
#pragma unroll
      for (int a = 0; a < T::kMT; ++a)
#pragma unroll
        for (int b = 0; b < T::kNT; ++b)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[a][b][e] += part[a][b][e];
            part[a][b][e] = 0.f;
          }
    }
  }
  cp_async_wait<0>();

  float* out = partials + (size_t)blockIdx.z * B * N;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < T::kMT; ++i) {
    const int row = b0 + wm0 + i * 16 + g;
#pragma unroll
    for (int j = 0; j < T::kNT; ++j) {
      const int col = n0 + wn0 + j * 8 + 2 * t;
      if (col >= N) continue;
      if (row < B)
        *reinterpret_cast<float2*>(out + (size_t)row * N + col) = make_float2(acc[i][j][0], acc[i][j][1]);
      if (row + 8 < B)
        *reinterpret_cast<float2*>(out + (size_t)(row + 8) * N + col) = make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
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

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ float gate(float pr, float pc, float pu, float h) {
  const float reset = sigmoid(pr);
  const float cand = tanhf(reset * pc);
  const float update = sigmoid(pu - 1.f);
  return update * cand + (1.f - update) * h;
}

// Launch B.  One block per batch row, four columns a thread at a time
// (3H % 4 == 0).  The first pass sums the row's S slices of parts in slice
// order (and rounds to bf16 with round_parts), writing the result into
// slice 0, which the later passes read.
__global__ void __launch_bounds__(kLnThreads) gru_ln_gates(
    float* __restrict__ parts, const float* __restrict__ h, const float* __restrict__ gamma,
    const float* __restrict__ beta, float* __restrict__ out, int B, int H, int S, float eps, int two_pass,
    int round_parts) {
  __shared__ float scratch[kLnThreads / 32];
  const int N = 3 * H, n4 = N / 4, h4 = H / 4;
  float4* p = reinterpret_cast<float4*>(parts + (size_t)blockIdx.x * N);
  // The first pass reads the S slices and writes slice 0 only at elements
  // it has read: two views, so that the next chunk's reads need not wait
  // for this chunk's write.
  const float4* __restrict__ in = p;
  float4* __restrict__ sum = p;
  const size_t slice4 = (size_t)B * n4;
  const bool write = S > 1 || round_parts;
  float s1 = 0.f, s2 = 0.f;
#pragma unroll 2
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    float4 v = in[i];
#pragma unroll 4
    for (int s = 1; s < S; ++s) {
      const float4 u = in[s * slice4 + i];
      v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
    }
    if (round_parts) v = make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z), round_bf16(v.w));
    if (write) sum[i] = v;
    s1 += (v.x + v.y) + (v.z + v.w);
    s2 += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
  }
  const float mean = block_sum(s1, scratch) / N;
  float var;
  if (two_pass) {
    float d = 0.f;
#pragma unroll 2
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      const float4 v = p[i];
      const float a = v.x - mean, b = v.y - mean, c = v.z - mean, e = v.w - mean;
      d += (a * a + b * b) + (c * c + e * e);
    }
    var = block_sum(d, scratch) / N;
  } else {
    var = fmaxf(block_sum(s2, scratch) / N - mean * mean, 0.f);
  }
  const float inv = rsqrtf(var + eps);
  const float4* g4 = reinterpret_cast<const float4*>(gamma);
  const float4* b4 = reinterpret_cast<const float4*>(beta);
  const float4* hb = reinterpret_cast<const float4*>(h + (size_t)blockIdx.x * H);
  float4* ob = reinterpret_cast<float4*>(out + (size_t)blockIdx.x * H);
#pragma unroll 2
  for (int j = threadIdx.x; j < h4; j += blockDim.x) {
    float4 v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float4 q = p[c * h4 + j], gm = g4[c * h4 + j], bt = b4[c * h4 + j];
      v[c] = make_float4((q.x - mean) * inv * gm.x + bt.x, (q.y - mean) * inv * gm.y + bt.y,
                         (q.z - mean) * inv * gm.z + bt.z, (q.w - mean) * inv * gm.w + bt.w);
    }
    const float4 hv = hb[j];
    ob[j] = make_float4(gate(v[0].x, v[1].x, v[2].x, hv.x), gate(v[0].y, v[1].y, v[2].y, hv.y),
                        gate(v[0].z, v[1].z, v[2].z, hv.z), gate(v[0].w, v[1].w, v[2].w, hv.w));
  }
}

template <typename TW, typename TX, int BM>
cudaError_t launch_mma(const void* h, const void* x, const void* w, float* partials, int B, int H, int X, int N,
                       int ts, int S, cudaStream_t stream) {
  const int smem = Tile<TW, BM>::kSmem;
  auto kernel = gru_mma<TW, TX, BM>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + BM - 1) / BM, (N + kBN - 1) / kBN, S);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const float*>(h), static_cast<const TX*>(x),
                                           static_cast<const TW*>(w), partials, B, H, X, N, ts);
  return cudaGetLastError();
}

template <typename TW, typename TX>
cudaError_t dispatch_rows(const void* h, const void* x, const void* w, float* partials, int B, int H, int X, int N,
                          int bm, int ts, int S, cudaStream_t stream) {
  switch (bm) {
    case 16: return launch_mma<TW, TX, 16>(h, x, w, partials, B, H, X, N, ts, S, stream);
    case 64: return launch_mma<TW, TX, 64>(h, x, w, partials, B, H, X, N, ts, S, stream);
    case 128: return launch_mma<TW, TX, 128>(h, x, w, partials, B, H, X, N, ts, S, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One step.  partials is f32 scratch of S*B*3H elements; bm is the block's
// batch rows (16, 64 or 128) and ts the K tiles of each of the S slices
// (S = ceil(T/ts), T = ceil(H/BK) + ceil(X/BK), BK = 64 for 128 rows, else 32).  The caller guarantees
// 16-byte aligned rows: H % 4 == 0, X % 4 == 0 (X % 8 == 0 for bf16 x) and
// H % 8 == 0 for bf16 W.  Returns the first CUDA error of the attribute call
// and the launches, so a refused launch is reported to the caller.
int sheeprl_gru_cell_forward(const void* h, const void* x, const void* w, const void* gamma,
                             const void* beta, void* out, void* partials, int B, int H, int X,
                             int bm, int ts, int S, int w_bf16, int x_bf16, int two_pass, int round_parts,
                             float eps, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* part = static_cast<float*>(partials);
  cudaError_t err;
  const int N = 3 * H;
  if (w_bf16)
    err = x_bf16 ? dispatch_rows<bf16, bf16>(h, x, w, part, B, H, X, N, bm, ts, S, stream)
                 : dispatch_rows<bf16, float>(h, x, w, part, B, H, X, N, bm, ts, S, stream);
  else
    err = x_bf16 ? dispatch_rows<float, bf16>(h, x, w, part, B, H, X, N, bm, ts, S, stream)
                 : dispatch_rows<float, float>(h, x, w, part, B, H, X, N, bm, ts, S, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  gru_ln_gates<<<B, kLnThreads, 0, stream>>>(part, static_cast<const float*>(h), static_cast<const float*>(gamma),
                                             static_cast<const float*>(beta), static_cast<float*>(out), B, H, S,
                                             eps, two_pass, round_parts);
  return static_cast<int>(cudaGetLastError());
}

// The sequence's input product (ops/seq_gru.py, the cluster route):
// out (M, N) = x (M, X) @ w (X, N), all f32 and row-major, by launch A
// alone in 3xTF32 with K = X in one slice (partials is then out itself).
// bm: the block's rows (16, 64 or 128; ops/gru_cell.py:tile_rows).  The
// caller guarantees X % 4 == 0, N % 4 == 0 and 16-byte aligned x, w, out.
int sheeprl_gru_input_product(const void* x, const void* w, void* out, int M, int X, int N, int bm,
                              void* stream_ptr) {
  if (M <= 0 || X <= 0 || N <= 0 || X % 4 || N % 4) return static_cast<int>(cudaErrorInvalidValue);
  const int depth = bm == 128 ? Tile<float, 128>::kBK : Tile<float, 64>::kBK;
  const int tiles = (X + depth - 1) / depth;
  return static_cast<int>(dispatch_rows<float, float>(x, x, w, static_cast<float*>(out), M, 0, X, N, bm, tiles, 1,
                                                      static_cast<cudaStream_t>(stream_ptr)));
}

}  // extern "C"
