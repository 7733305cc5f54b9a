// Flash-attention backward (dq and dk/dv) for Hopper (sm_90a), with every
// product on the tensor cores.
//
// Replaces the TPU kernels deeplearning4j_tpu/ops/pallas_kernels.py
// `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel` (their pallas_calls
// are in `_flash_bwd`). q, k, v and dO are dense [b*h, t, d]; lse is the
// float32 [b*h, t] row statistic m + log(l) that the forward kernel
// returned; delta is the float32 [b*h, t] row sum of dO * O, computed by the
// wrapper (the JAX package leaves it to XLA).
//
// What they compute, as the TPU kernels do (q, k, v and dO widened to
// float32; P, dP and dS float32):
//   - s = scale * (q . k), the scale applied to the float32 product;
//   - P is rebuilt from lse: p = exp(s - lse), set to 0 where causal
//     masking removes the key; dP = dO . v^T; dS = p * (dP - delta);
//   - dq = scale * sum over keys of dS . k;
//   - dv = sum over queries of P^T . dO, dk = scale * sum over queries of
//     dS^T . q;
//   - all sums in float32, results rounded once to the input's type.
// Unlike the TPU kernels they take any t: query and key rows at or past t
// are zero-filled and their p set to 0, and nothing past t is stored.
//
// Numerics. bfloat16 operands enter m16n8k16 products as they are (q . k
// and dO . v are exact products); P and dS, float32, enter theirs as a
// bfloat16 pair hi + lo (about 16 bits; split_bf16), two products, so they
// are not rounded once to bfloat16 as library kernels round them. float32
// products run as 3xTF32 on m16n8k8 (split_tf32 in hopper_mma.cuh): the
// three products of each 8-deep step go into a fresh tile that a float32
// add carries into the accumulator, which holds float32 accuracy over the
// long sums (dq over up to t keys, dk and dv over up to t queries).
//
// Bound on an H100 SXM at the trained TransformerLM shape (b=16, h=8,
// t=512, d=64, causal): per causal (q, k) pair dq does three products of
// 2*d operations (q.k, dO.v, dS.k) and dk/dv four (k.q, v.dO, P^T.dO,
// dS^T.q); with t(t+1)/2 pairs per head that is 6.45 GFLOP for dq and 8.61
// GFLOP for dk/dv. float32: 3xTF32 runs three TF32 products for each, over
// the dense 495 TFLOP/s, 0.039 ms (dq) and 0.052 ms (dk/dv); the float32
// bytes (each input read once, each output written once: 86 MB and 103 MB)
// take 0.026 and 0.031 ms at 3.35 TB/s. bfloat16: the bytes bound it
// (0.0127 and 0.0152 ms); its products, the hi + lo pairs counted twice,
// take 0.0087 and 0.0130 ms at 989 TFLOP/s.
//
// Design. Both kernels are one product shape: a block's warps each own 16
// rows of resident operands in shared memory, and 64-row tiles of the
// other operands stream through a 2-stage cp.async ring (16-byte copies
// where the tensors start on 16 bytes, else 4-byte copies for float32 and
// plain loads for bfloat16, zero-filled past t). Rows are padded by 16
// bytes, so the 8 rows an ldmatrix reads, and the rows the scalar TF32
// loads below read, sit on distinct banks.
//   dq:  one block per (batch*head, query tile); Q and dO resident, K and V
//        streamed up to the diagonal (causal early stop). Per key tile each
//        warp computes S = Q . K^T and dP = dO . V^T (A and B both [rows][d],
//        fragments by ldmatrix), forms dS in registers, and adds dS . K, dS
//        as the A operand straight from the accumulators.
//   dkv: one block per (batch*head, key tile); K and V resident, Q, dO and
//        the tile's lse and delta streamed from the diagonal on. Each warp
//        computes S^T = K . Q^T and dP^T = V . dO^T, so P^T and dS^T come
//        out in the accumulator layout and are the A operands of dV += P^T
//        . dO and dK += dS^T . Q.
// An accumulator is an A operand without shuffles or shared memory: for
// bfloat16 the m16n8 C layout of two neighbouring column tiles is the
// m16n8k16 A layout; for TF32 the thread holding columns (2i, 2i + 1) of a
// C tile holds A columns (i, i + 4) once the 8-deep step's keys are taken
// in the order 0, 2, 4, 6, 1, 3, 5, 7, and B's rows are read in that order
// (the sum does not depend on it). The B operand of these products is the
// streamed tile read across its rows: ldmatrix.trans for bfloat16, scalar
// loads for TF32 (ldmatrix has no 32-bit transpose).
// Every warp reads all of a streamed tile, so the TF32 split of its values
// would be done once per warp: for float32 up to d = 64 the block splits
// each tile once as it arrives (hi in place, lo beside it) and 8 warps (128
// resident rows) share it; bfloat16 needs no split, and float32 at d = 128
// has no room for the parts, so there 4 warps (64 rows) split in registers
// (Shape). Where a warp's accumulators and a whole streamed tile's S and
// dP do not fit in registers, it takes the tile in passes of 32 or 16 rows.
// Under causal masking a warp skips the passes whose keys all lie past its
// rows (dq) or whose queries all lie before its keys (dk/dv). Blocks are
// issued heaviest causal tile first across all heads; no float atomics
// (two launches give the same bits). Shared memory at float32: d =
// 64 170 KB (dq) and 171 KB (dk/dv), one block of 8 warps an SM; d = 128
// 198 KB and 199 KB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

constexpr int kB = 64;              // rows of a streamed tile
constexpr int kStages = 2;          // depth of the streamed tiles' ring
constexpr int kStats = 2 * kB * 4;  // a dk/dv stage's lse and delta, float32

// A block's shape for operands of type T and head dim D.
template <typename T, int D>
struct Shape {
  // float32 streamed tiles up to d = 64 are split into their TF32 parts
  // once, as they arrive, and 8 warps share them; elsewhere each of 4 warps
  // splits its fragments in registers (at d = 128 the parts do not fit)
  static constexpr bool kSplit = sizeof(T) == 4 && D <= 64;
  static constexpr int kWarps = kSplit ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;  // resident rows, 16 a warp
  static constexpr int kP = D * static_cast<int>(sizeof(T)) + 16;  // row
  static constexpr int kT = kB * kP;                // a streamed tile
  static constexpr int kLo = kSplit ? 2 * kT : 0;   // a stage's lo parts
  static constexpr int kDqSmem = 2 * kRows * kP + kStages * 2 * kT + kLo;
  static constexpr int kDkvSmem =
      2 * kRows * kP + kStages * (2 * kT + kStats) + kLo;
  static_assert(kDkvSmem <= 232448 && kDqSmem <= 232448,
                "a block's shared memory on an H100");
};

// Rows [r0, r0 + R) of a dense [t][D] matrix of T into a tile, zero at
// and past t, by the block's N threads. vec: the matrix starts on 16 bytes
// (its rows then do: D * sizeof(T) is a multiple of 16).
template <typename T, int D, int R, int N>
__device__ __forceinline__ void load_tile(uint8_t* s, const T* p, int r0,
                                          int t, bool vec) {
  constexpr int kP = Shape<T, D>::kP;
  if (vec) {
    constexpr int kPer = D * static_cast<int>(sizeof(T)) / 16;
#pragma unroll
    for (int i = 0; i < R * kPer / N; ++i) {
      const int e = threadIdx.x + i * N;
      const int r = e / kPer, c = e % kPer;
      const bool in = r0 + r < t;
      const uint8_t* src = reinterpret_cast<const uint8_t*>(
          p + static_cast<int64_t>(in ? r0 + r : 0) * D);
      cp_async16(s + r * kP + c * 16, src + c * 16, in ? 16 : 0);
    }
  } else {  // cold: bounded unrolling keeps the registers for the products
#pragma unroll 4
    for (int i = 0; i < R * D / N; ++i) {
      const int e = threadIdx.x + i * N;
      const int r = e / D, c = e % D;
      const bool in = r0 + r < t;
      copy_elem(s + r * kP + c * static_cast<int>(sizeof(T)),
                in ? p + static_cast<int64_t>(r0 + r) * D + c : p, in);
    }
  }
}

// lse and delta of rows [r0, r0 + 64) into s[0, 64) and s[64, 128), zero
// past t
__device__ __forceinline__ void load_stats(float* s, const float* lse,
                                           const float* delta, int r0,
                                           int t) {
  if (threadIdx.x >= 2 * kB) return;
  const int i = threadIdx.x & (kB - 1);
  const float* src = threadIdx.x < kB ? lse : delta;
  const bool in = r0 + i < t;
  cp_async4(s + threadIdx.x, in ? src + r0 + i : src, in ? 4 : 0);
}

// A stage's two float32 tiles (st and st + kT, one run of 128 rows) into
// their TF32 parts: hi in place, lo at the same offsets from lo.
template <typename T, int D>
__device__ __forceinline__ void split_stage(uint8_t* st, uint8_t* lo) {
  using S = Shape<T, D>;
  constexpr int kPer = D * 4 / 16;  // 16-byte pieces of a row
#pragma unroll
  for (int i = 0; i < 2 * kB * kPer / S::kThreads; ++i) {
    const int e = threadIdx.x + i * S::kThreads;
    const int off = (e / kPer) * S::kP + (e % kPer) * 16;
    uint4 v = *reinterpret_cast<const uint4*>(st + off), l;
    split_tf32(v.x, v.x, l.x);
    split_tf32(v.y, v.y, l.y);
    split_tf32(v.z, v.z, l.z);
    split_tf32(v.w, v.w, l.w);
    *reinterpret_cast<uint4*>(st + off) = v;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// (x0, x1) = hi + lo, each a pair of bfloat16 in one register (x0 low):
// hi rounded to nearest, lo the rest (exact in float32) rounded to nearest
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
}

// acc[i] += (ah + al) . (bh[i] + bl[i]) as 3xTF32 for N n8 tiles: the
// three products of each tile go into a fresh tile (small terms first, N
// independent products between dependent ones), then a float32 add carries
// it into acc. The tensor core adds with truncation, aligned to the largest
// of its terms and C: carried along a whole sum in acc, that bias grows
// with its length; reset every 8-deep step it stays at the step's own sum.
template <int N>
__device__ __forceinline__ void mma3_tf32(float (*acc)[4], const uint32_t ah[4],
                                          const uint32_t al[4],
                                          const uint32_t (&bh)[N][2],
                                          const uint32_t (&bl)[N][2]) {
  float t[N][4];
  zero(t);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(t[i], al, bh[i][0], bh[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(t[i], ah, bl[i][0], bl[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(t[i], ah, bh[i][0], bh[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] += t[i][e];
}

// acc[nt] += A . B^T over K = D: A the warp's 16 rows at a, B the 8 NT
// rows at b, both [rows][D] tiles of T; acc[nt] is the m16n8 tile of B's
// rows 8 nt + [0, 8), in mma's C layout. Split shapes: b holds B's TF32 hi
// parts and b_lo, at the same offsets, its lo parts. ldmatrix x4: lane l
// addresses row l % 8 of matrix l / 8; for A the matrices are (rows 0-7,
// k lo), (rows 8-15, k lo), (0-7, k hi), (8-15, k hi), for B (n 0-7, k lo),
// (n 0-7, k hi), (n 8-15, k lo), (n 8-15, k hi). A float32 row of 16 bytes
// is 4 TF32 values, and the 8 x 8 b16 matrices' thread layout is then
// mma's TF32 layout.
template <typename T, int D, int NT>
__device__ __forceinline__ void product_abt(float (&acc)[NT][4],
                                            const uint8_t* a,
                                            const uint8_t* b,
                                            const uint8_t* b_lo) {
  constexpr int kP = Shape<T, D>::kP;
  const int lane = threadIdx.x & 31;
  const int ar = (lane & 7) + ((lane >> 3) & 1) * 8, ak = (lane >> 4) * 16;
  const int br = (lane & 7) + (lane >> 4) * 8, bk = ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int ks = 0; ks < D * static_cast<int>(sizeof(T)) / 32; ++ks) {
    uint32_t af[4];  // 32 bytes of K: k16 bfloat16, k8 TF32
    ldsm_x4(af, a + ar * kP + ks * 32 + ak);
    const int boff = br * kP + ks * 32 + bk;
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldsm_x4(r, b + np * 16 * kP + boff);
        mma_bf16(acc[2 * np], af, r[0], r[1]);
        mma_bf16(acc[2 * np + 1], af, r[2], r[3]);
      }
    } else {
      uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) split_tf32(af[j], ah[j], al[j]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldsm_x4(r, b + np * 16 * kP + boff);
        if constexpr (Shape<T, D>::kSplit) {
          uint32_t rl[4];
          ldsm_x4(rl, b_lo + np * 16 * kP + boff);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            bh[2 * np + j / 2][j % 2] = r[j];
            bl[2 * np + j / 2][j % 2] = rl[j];
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            split_tf32(r[j], bh[2 * np + j / 2][j % 2],
                       bl[2 * np + j / 2][j % 2]);
        }
      }
      mma3_tf32<NT>(acc, ah, al, bh, bl);
    }
  }
}

// acc[nt] += X . B over K = 8 KT: X the warp's 16 x 8 KT float32 tile in
// mma's C layout (x[j] the m16n8 tile of columns 8 j + [0, 8)), B the 8 KT
// rows at b of a [rows][D] tile of T, B's rows X's columns; acc[nt] is the
// m16n8 tile of B's columns 8 nt + [0, 8). Split shapes as for product_abt.
template <typename T, int D, int KT>
__device__ __forceinline__ void product_ab(float (&acc)[D / 8][4],
                                           const float (&x)[KT][4],
                                           const uint8_t* b,
                                           const uint8_t* b_lo) {
  constexpr int kP = Shape<T, D>::kP;
  const int lane = threadIdx.x & 31;
  if constexpr (sizeof(T) == 2) {
    // ldmatrix.trans x4: matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7,
    // n 8-15), (k 8-15, n 8-15): b0, b1 of two n8 tiles
    const int br = (lane & 7) + ((lane >> 3) & 1) * 8, bn = (lane >> 4) * 16;
#pragma unroll
    for (int ks = 0; ks < KT / 2; ++ks) {  // k16: C tiles 2 ks, 2 ks + 1
      uint32_t ah[4], al[4];
      split_bf16(x[2 * ks][0], x[2 * ks][1], ah[0], al[0]);
      split_bf16(x[2 * ks][2], x[2 * ks][3], ah[1], al[1]);
      split_bf16(x[2 * ks + 1][0], x[2 * ks + 1][1], ah[2], al[2]);
      split_bf16(x[2 * ks + 1][2], x[2 * ks + 1][3], ah[3], al[3]);
      uint32_t r[D / 16][4];
#pragma unroll
      for (int np = 0; np < D / 16; ++np)
        ldsm_x4_trans(r[np], b + (ks * 16 + br) * kP + np * 32 + bn);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        mma_bf16(acc[2 * np], al, r[np][0], r[np][1]);
        mma_bf16(acc[2 * np + 1], al, r[np][2], r[np][3]);
      }
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        mma_bf16(acc[2 * np], ah, r[np][0], r[np][1]);
        mma_bf16(acc[2 * np + 1], ah, r[np][2], r[np][3]);
      }
    }
  } else {
    // k8 step ks takes X's columns 8 ks + (0, 2, 4, 6, 1, 3, 5, 7): the A
    // fragment (g, tig), (g + 8, tig), (g, tig + 4), (g + 8, tig + 4) is
    // then C's (g, 2 tig), (g + 8, 2 tig), (g, 2 tig + 1), (g + 8, 2 tig +
    // 1), and b0, b1 are B's rows 8 ks + 2 tig and 8 ks + 2 tig + 1 at
    // column 8 nt + g (banks 8 tig + g: D + 4 words per row)
    const int g = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int ks = 0; ks < KT; ++ks) {
      const uint32_t a[4] = {__float_as_uint(x[ks][0]),
                             __float_as_uint(x[ks][2]),
                             __float_as_uint(x[ks][1]),
                             __float_as_uint(x[ks][3])};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) split_tf32(a[j], ah[j], al[j]);
      const int off = (ks * 8 + 2 * tig) * kP + g * 4;
      constexpr int kG = D / 8 < 8 ? D / 8 : 8;  // n8 tiles per group
#pragma unroll
      for (int n0 = 0; n0 < D / 8; n0 += kG) {
        uint32_t bh[kG][2], bl[kG][2];
#pragma unroll
        for (int i = 0; i < kG; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int o = off + j * kP + (n0 + i) * 32;
            const uint32_t v = *reinterpret_cast<const uint32_t*>(b + o);
            if constexpr (Shape<T, D>::kSplit) {
              bh[i][j] = v;
              bl[i][j] = *reinterpret_cast<const uint32_t*>(b_lo + o);
            } else {
              split_tf32(v, bh[i][j], bl[i][j]);
            }
          }
        mma3_tf32<kG>(acc + n0, ah, al, bh, bl);
      }
    }
  }
}

// rows row0 and row0 + 8 of a dense [t][D] output from the warp's C-layout
// tiles, times `mul`; nothing at or past t
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[D / 8][4],
                                           int row0, int t, float mul,
                                           bool pair) {
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= t) continue;
    T* p = out + static_cast<int64_t>(row) * D;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      store2(p, nt * 8 + 2 * tig, D, acc[nt][2 * i] * mul,
             acc[nt][2 * i + 1] * mul, pair);
  }
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(Shape<T, D>::kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int t, int nbh, int ntiles, float scale, bool vec,
                        bool pair) {
  using S = Shape<T, D>;
  constexpr int kP = S::kP, kT = S::kT, kR = S::kRows;
  // keys per pass over a streamed tile: fewer where the accumulator and a
  // pass's S and dP would not fit in registers (float32 at d = 64 and 128)
  constexpr int kCols = sizeof(T) == 2 || D <= 32 ? kB : D == 64 ? 32 : 16;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* qs = smem;
  uint8_t* dos = smem + kR * kP;
  uint8_t* lo = smem + 2 * kR * kP + kStages * 2 * kT;  // kSplit only
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  // the heaviest causal tiles (the last query tiles) of every head first
  const int64_t bh = blockIdx.x % nbh;
  const int qt = ntiles - 1 - static_cast<int>(blockIdx.x / nbh);
  const int q0 = qt * kR;
  const int64_t base = bh * t * D;

  load_tile<T, D, kR, S::kThreads>(qs, q + base, q0, t, vec);
  load_tile<T, D, kR, S::kThreads>(dos, dout + base, q0, t, vec);
  const int row0 = q0 + warp * 16 + g;  // and row0 + 8
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row0 + 8 * i < t;
    row_lse[i] = in ? lse[bh * t + row0 + 8 * i] : 0.0f;
    row_delta[i] = in ? delta[bh * t + row0 + 8 * i] : 0.0f;
  }

  float acc[D / 8][4];
  zero(acc);
  // exclusive key bound: causal rows of this tile see keys < q0 + kR only
  const int kend = CAUSAL ? min(q0 + kR, t) : t;
  ring<2 * kT, kStages>(
      smem + 2 * kR * kP, (kend + kB - 1) / kB,
      [&](int kt, uint8_t* st) {
        load_tile<T, D, kB, S::kThreads>(st, k + base, kt * kB, t, vec);
        load_tile<T, D, kB, S::kThreads>(st + kT, v + base, kt * kB, t, vec);
      },
      [](int) {},
      [&](int kt, uint8_t* st) {
        if constexpr (S::kSplit) {
          split_stage<T, D>(st, lo);
          __syncthreads();
        }
        const int k0 = kt * kB;
        const bool edge =
            k0 + kB > t || q0 + kR > t || (CAUSAL && k0 + kB - 1 > q0);
#pragma unroll 1
        for (int c0 = 0; c0 < kB; c0 += kCols) {  // keys k0 + c0 + [0, kCols)
          // causal: every key of the pass past the warp's last row (only
          // possible with more rows than keys per block, or several passes)
          if constexpr (CAUSAL && (kR > kB || kCols < kB))
            if (k0 + c0 > q0 + warp * 16 + 15) break;
          const int o = c0 * kP;
          float s[kCols / 8][4], dp[kCols / 8][4];
          zero(s);
          zero(dp);
          product_abt<T, D, kCols / 8>(s, qs + warp * 16 * kP, st + o,
                                       lo + o);
          product_abt<T, D, kCols / 8>(dp, dos + warp * 16 * kP, st + kT + o,
                                       lo + kT + o);
#pragma unroll
          for (int nt = 0; nt < kCols / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = row0 + (e >> 1) * 8;
              const int key = k0 + c0 + nt * 8 + 2 * tig + (e & 1);
              float p = expf(s[nt][e] * scale - row_lse[e >> 1]);
              if (edge && (row >= t || key >= t || (CAUSAL && key > row)))
                p = 0.0f;
              dp[nt][e] = p * (dp[nt][e] - row_delta[e >> 1]);  // dS
            }
          product_ab<T, D, kCols / 8>(acc, dp, st + o, lo + o);  // dS . K
        }
      });
  store_rows<T, D>(dq + base, acc, row0, t, scale, pair);
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(Shape<T, D>::kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int t, int nbh, int ntiles,
                         float scale, bool vec, bool pair) {
  using S = Shape<T, D>;
  constexpr int kP = S::kP, kT = S::kT, kR = S::kRows;
  // queries per pass over a streamed tile: fewer where the two
  // accumulators and a pass's S^T and dP^T would not fit in registers (at
  // 32 ptxas spills in the causal float32 kernel at d = 64)
  constexpr int kCols = sizeof(T) * D < 256 ? kB
                        : sizeof(T) * D == 256 && !(CAUSAL && S::kSplit) ? 32
                                                                          : 16;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ks = smem;
  uint8_t* vs = smem + kR * kP;
  uint8_t* lo = smem + 2 * kR * kP + kStages * (2 * kT + kStats);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  // key tile 0 sees every query tile under causal masking: the first key
  // tiles of every head first
  const int64_t bh = blockIdx.x % nbh;
  const int kt = static_cast<int>(blockIdx.x / nbh);
  const int k0 = kt * kR;
  const int64_t base = bh * t * D;

  load_tile<T, D, kR, S::kThreads>(ks, k + base, k0, t, vec);
  load_tile<T, D, kR, S::kThreads>(vs, v + base, k0, t, vec);
  const int key0 = k0 + warp * 16 + g;  // and key0 + 8

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  // query tiles wholly before this key tile see none of it
  const int qt0 = CAUSAL ? k0 / kB : 0;
  ring<2 * kT + kStats, kStages>(
      smem + 2 * kR * kP, (t + kB - 1) / kB - qt0,
      [&](int c, uint8_t* st) {
        const int q0 = (qt0 + c) * kB;
        load_tile<T, D, kB, S::kThreads>(st, q + base, q0, t, vec);
        load_tile<T, D, kB, S::kThreads>(st + kT, dout + base, q0, t, vec);
        load_stats(reinterpret_cast<float*>(st + 2 * kT), lse + bh * t,
                   delta + bh * t, q0, t);
      },
      [](int) {},
      [&](int c, uint8_t* st) {
        if constexpr (S::kSplit) {
          split_stage<T, D>(st, lo);
          __syncthreads();
        }
        const int q0 = (qt0 + c) * kB;
        const float* st_lse = reinterpret_cast<const float*>(st + 2 * kT);
        const float* st_delta = st_lse + kB;
        const bool edge =
            k0 + kR > t || q0 + kB > t || (CAUSAL && k0 + kR - 1 > q0);
#pragma unroll 1
        for (int c0 = 0; c0 < kB; c0 += kCols) {  // queries q0 + c0 + ...
          // causal: the warp's first key past every query of the pass
          if constexpr (CAUSAL && (kR > kB || kCols < kB))
            if (k0 + warp * 16 > q0 + c0 + kCols - 1) continue;
          const int o = c0 * kP;
          float s[kCols / 8][4], dp[kCols / 8][4];  // S^T, dP^T
          zero(s);
          zero(dp);
          product_abt<T, D, kCols / 8>(s, ks + warp * 16 * kP, st + o,
                                       lo + o);
          product_abt<T, D, kCols / 8>(dp, vs + warp * 16 * kP, st + kT + o,
                                       lo + kT + o);
#pragma unroll
          for (int nt = 0; nt < kCols / 8; ++nt) {
            const int col = c0 + nt * 8 + 2 * tig;
            const float2 l2 = *reinterpret_cast<const float2*>(st_lse + col);
            const float2 d2 =
                *reinterpret_cast<const float2*>(st_delta + col);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = key0 + (e >> 1) * 8;
              const int query = q0 + col + (e & 1);
              float p = expf(s[nt][e] * scale - ((e & 1) ? l2.y : l2.x));
              if (edge &&
                  (key >= t || query >= t || (CAUSAL && key > query)))
                p = 0.0f;
              s[nt][e] = p;                                           // P^T
              dp[nt][e] = p * (dp[nt][e] - ((e & 1) ? d2.y : d2.x));  // dS^T
            }
          }
          product_ab<T, D, kCols / 8>(dv_acc, s, st + kT + o,
                                      lo + kT + o);  // P^T . dO
          product_ab<T, D, kCols / 8>(dk_acc, dp, st + o, lo + o);  // dS^T . Q
        }
      });
  store_rows<T, D>(dk + base, dk_acc, key0, t, scale, pair);
  store_rows<T, D>(dv + base, dv_acc, key0, t, 1.0f, pair);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int64_t bh;
  int t;
  float scale;
  int device;
  bool vec, pair;
  cudaStream_t stream;
};

template <typename T, int D, bool CAUSAL>
cudaError_t launch_dq(const Args& a, int ntiles) {
  using S = Shape<T, D>;
  const cudaError_t err =
      allow_smem<flash_bwd_dq_kernel<T, D, CAUSAL>>(a.device, S::kDqSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D, CAUSAL>
      <<<static_cast<unsigned int>(a.bh * ntiles), S::kThreads, S::kDqSmem,
         a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
          a.delta, static_cast<T*>(a.dq), a.t, static_cast<int>(a.bh),
          ntiles, a.scale, a.vec, a.pair);
  return cudaGetLastError();
}

template <typename T, int D, bool CAUSAL>
cudaError_t launch_dkv(const Args& a, int ntiles) {
  using S = Shape<T, D>;
  const cudaError_t err =
      allow_smem<flash_bwd_dkv_kernel<T, D, CAUSAL>>(a.device, S::kDkvSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<T, D, CAUSAL>
      <<<static_cast<unsigned int>(a.bh * ntiles), S::kThreads, S::kDkvSmem,
         a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
          a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.t,
          static_cast<int>(a.bh), ntiles, a.scale, a.vec, a.pair);
  return cudaGetLastError();
}

// which: 0 = dq, 1 = dk/dv; one block per (batch*head, resident tile)
template <typename T, int D>
cudaError_t launch_causal(const Args& a, int causal, int which) {
  constexpr int kR = Shape<T, D>::kRows;
  const int ntiles = (a.t + kR - 1) / kR;
  if (a.bh * ntiles > 0x7fffffff) return cudaErrorInvalidValue;
  if (which == 0)
    return causal ? launch_dq<T, D, true>(a, ntiles)
                  : launch_dq<T, D, false>(a, ntiles);
  return causal ? launch_dkv<T, D, true>(a, ntiles)
                : launch_dkv<T, D, false>(a, ntiles);
}

template <typename T>
cudaError_t launch_d(Args a, int d, int causal, int which) {
  // every row of d elements starts on 16 bytes when the tensor does
  a.vec = aligned(a.q, 16) && aligned(a.k, 16) && aligned(a.v, 16) &&
          aligned(a.dout, 16);
  a.pair = which == 0 ? pairs<T>(a.dq, d)
                      : pairs<T>(a.dk, d) && pairs<T>(a.dv, d);
  switch (d) {
    case 16:
      return launch_causal<T, 16>(a, causal, which);
    case 32:
      return launch_causal<T, 32>(a, causal, which);
    case 64:
      return launch_causal<T, 64>(a, causal, which);
    case 128:
      return launch_causal<T, 128>(a, causal, which);
    default:
      return cudaErrorInvalidValue;
  }
}

int launch(const Args& a, int d, int causal, int dtype, int which) {
  if (a.bh <= 0 || a.t <= 0) return 0;
  // this library carries its own CUDA runtime, whose current device is per
  // thread and independent of PyTorch's
  const cudaError_t set = cudaSetDevice(a.device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (dtype == 0) return static_cast<int>(launch_d<float>(a, d, causal, which));
  if (dtype == 1)
    return static_cast<int>(launch_d<__nv_bfloat16>(a, d, causal, which));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q, k, v, dout, dq: dense [bh, t, d] of `dtype` (0 = float32, 1 =
// bfloat16); lse, delta: dense float32 [bh, t]. d in {16, 32, 64, 128}.
// `scale` multiplies q . k in float32. device: the CUDA device that holds
// the tensors and owns `stream`. Returns the CUDA error code of the launch
// (0 = launched); launches nothing for an empty input.
int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dq, int64_t bh,
                                  int64_t t, int d, float scale, int causal,
                                  int dtype, int device, void* stream) {
  if (t > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, nullptr, nullptr, bh,
               static_cast<int>(t), scale, device, false, false,
               static_cast<cudaStream_t>(stream)};
  return launch(a, d, causal, dtype, 0);
}

// As above, writing dk and dv (dense [bh, t, d] of `dtype`).
int flash_attention_bwd_dkv_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int64_t bh, int64_t t,
                                   int d, float scale, int causal, int dtype,
                                   int device, void* stream) {
  if (t > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), nullptr, dk, dv, bh,
               static_cast<int>(t), scale, device, false, false,
               static_cast<cudaStream_t>(stream)};
  return launch(a, d, causal, dtype, 1);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
