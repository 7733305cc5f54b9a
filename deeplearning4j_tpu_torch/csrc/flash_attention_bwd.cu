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
// 198 KB and 199 KB. The tile loads, the split and both products are in
// flash_tiles.cuh, shared with the forward kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tiles.cuh"

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
  static constexpr int kP = row_pitch<T, D>();      // bytes of a row
  static constexpr int kT = kB * kP;                // a streamed tile
  static constexpr int kLo = kSplit ? 2 * kT : 0;   // a stage's lo parts
  static constexpr int kDqSmem = 2 * kRows * kP + kStages * 2 * kT + kLo;
  static constexpr int kDkvSmem =
      2 * kRows * kP + kStages * (2 * kT + kStats) + kLo;
  static_assert(kDkvSmem <= 232448 && kDqSmem <= 232448,
                "a block's shared memory on an H100");
};

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
          split_stage<D, 2 * kB, S::kThreads>(st, lo);
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
          product_abt<T, D, S::kSplit, kCols / 8>(s, qs + warp * 16 * kP,
                                                   st + o, lo + o);
          product_abt<T, D, S::kSplit, kCols / 8>(dp, dos + warp * 16 * kP,
                                                   st + kT + o, lo + kT + o);
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
          product_ab<T, D, S::kSplit, true, kCols / 8>(acc, dp, st + o,
                                                       lo + o);  // dS . K
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
          split_stage<D, 2 * kB, S::kThreads>(st, lo);
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
          product_abt<T, D, S::kSplit, kCols / 8>(s, ks + warp * 16 * kP,
                                                   st + o, lo + o);
          product_abt<T, D, S::kSplit, kCols / 8>(dp, vs + warp * 16 * kP,
                                                   st + kT + o, lo + kT + o);
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
          product_ab<T, D, S::kSplit, true, kCols / 8>(
              dv_acc, s, st + kT + o, lo + kT + o);  // P^T . dO
          product_ab<T, D, S::kSplit, true, kCols / 8>(
              dk_acc, dp, st + o, lo + o);  // dS^T . Q
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
