// Flash-attention forward o = softmax(q * scale . k^T) . v for Hopper
// (sm_90a), with both products on the tensor cores.
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas_kernels.py
// `_flash_fwd_kernel` (pallas_call in `_flash_fwd`). q, k and v are dense
// [b*h, t, d] (the [b, h, t, d] tensors of MultiHeadAttention, contiguous);
// o has q's type; lse, when asked for, is the float32 row statistic
// m + log(l) that the backward kernels rebuild P from.
//
// What it computes, as the TPU kernel does:
//   - q is multiplied by `scale` in q's type (the wrapper passes the scale
//     already rounded to that type), then s = q . k^T accumulates in float32;
//   - causal: keys after the query position are set to NEG_INF = -1e30, and
//     key tiles wholly in the future are not visited (causal early stop);
//   - online softmax per query row in float32: m starts at NEG_INF, l at 0,
//     m' = max(m, rowmax s), p = exp(s - m'), l = l * exp(m - m') + sum p,
//     acc = acc * exp(m - m') + p . v, with p rounded to v's type before the
//     product (bfloat16 rounds P as the TPU's MXU feed does; l sums the
//     unrounded p);
//   - o = acc / max(l, 1e-37) in q's type, lse = m + log(max(l, 1e-37)).
// Unlike the TPU kernel it takes any t: keys at or past t get -inf (p = 0,
// zero-filled K and V), and nothing past t is stored.
//
// Numerics. bfloat16 q and k enter m16n8k16 products as they are (exact
// products, float32 sums); P enters P . V once, rounded to nearest
// bfloat16. float32 products run as 3xTF32 on m16n8k8 (split_tf32 in
// hopper_mma.cuh, both parts rounded to nearest): the three products of
// each 8-deep step go into a fresh tile that a float32 add carries into S
// or O, which holds float32 accuracy over the sums. bfloat16 takes p =
// exp(x) by ex2.approx (within about 2^-21 of it, far below P's rounding);
// float32 takes expf.
//
// Bound on an H100 SXM at the served TransformerLM shape (b=16, h=8,
// t=512, d=64, causal): a causal row attends to t(t+1)/2 (q, k) pairs per
// (b, h); two products of 2*d operations per pair give 4.30 GFLOP per
// launch. float32: three TF32 products for each, over the dense 495
// TFLOP/s, 0.0261 ms; its 67 MB (q, k, v read once, o written once) take
// 0.020 ms at 3.35 TB/s, so operations bound it. bfloat16: its 34 MB
// bound it at 0.010 ms; the products take 0.0043 ms at 989 TFLOP/s.
//
// Design (the backward's shape; the tile helpers are in flash_tiles.cuh).
// One block per (batch*head, query tile); each warp owns 16 query rows of
// the resident Q tile, which it scales in place in q's type once Q has
// arrived. 64-row tiles of K and V stream through a cp.async ring (16-byte
// copies where q, k and v start on 16 bytes, else 4-byte copies for
// float32 and plain loads for bfloat16, zero-filled past t) up to the
// query tile's last row; 3 stages for bfloat16 up to d = 64, whose tiles'
// products are too short to hide the copies behind 2. A warp takes a tile
// in passes of 64 keys, or 32 (float32, d = 64) or 16 (float32, d = 128)
// where the O accumulator and a pass's S would not fit in registers. Per
// pass it computes S = Q . K^T (fragments by ldmatrix) into registers in
// mma's C layout, where each thread holds two rows (g and g + 8) of every
// n8 tile: the row max is taken over the 4 lanes of a quad by two
// shuffles, m stays in registers, each thread keeps its own part of l
// (summed over the quad once, at the end), and the O accumulator's rows are
// rescaled in place. S never goes to shared memory: P is the A operand of
// O += P . V straight from the accumulators (for bfloat16 two neighbouring
// n8 C tiles are the m16n8k16 A layout; for TF32 the keys of each 8-deep
// step are taken in the order 0, 2, 4, 6, 1, 3, 5, 7, which makes a
// thread's C pair its A pair, and V's rows are read in that order).
// float32 K and V tiles up to d = 64 are split into their TF32 parts once
// per block as they arrive and shared by 8 warps (128 query rows); at d =
// 128 the parts do not fit, so 4 warps (64 rows) split their fragments in
// registers; bfloat16 takes 8 warps up to d = 64 and 4 at d = 128
// (registers). The launch bounds keep bfloat16 up to d = 64 at 128
// registers, two 8-warp blocks an SM; float32 runs one block an SM and
// takes up to 255 (no spill at d = 64). Causal: a warp skips the passes
// wholly after its last row, and in the others the n8 tiles wholly after
// it (their p is exactly 0, and key 0 is seen first, so m is finite);
// blocks run heaviest causal tile first across all heads. No
// atomics: two launches give the same bits. The shared-memory attribute
// is asked once per kernel and device (allow_smem).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tiles.cuh"

namespace {

constexpr int kB = 64;  // keys of a streamed tile
constexpr float kNegInf = -1e30f;

// A block's shape for operands of type T and head dim D.
template <typename T, int D>
struct Shape {
  // float32 K and V tiles up to d = 64 are split into their TF32 parts
  // once, as they arrive; at d = 128 the parts do not fit beside them
  static constexpr bool kSplit = sizeof(T) == 4 && D <= 64;
  static constexpr int kWarps = D <= 64 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  // resident blocks an SM that ptxas must leave room for: two 8-warp
  // blocks (at most 128 registers) in bfloat16 up to d = 64; float32 runs
  // one block and gains from up to 255 registers
  static constexpr int kMinBlocks = sizeof(T) == 2 && D <= 64 ? 2 : 1;
  static constexpr int kRows = 16 * kWarps;        // query rows, 16 a warp
  static constexpr int kP = row_pitch<T, D>();     // bytes of a row
  static constexpr int kT = kB * kP;               // a streamed tile
  // depth of K's and V's ring: a third stage hides the copies' latency
  // in bfloat16 (a tile's products are short); where the tiles are large
  // it only takes shared memory
  static constexpr int kStages = sizeof(T) == 2 && D <= 64 ? 3 : 2;
  static constexpr int kLo = kSplit ? 2 * kT : 0;  // K's and V's lo parts
  // keys per pass over a streamed tile: fewer where the O accumulator and
  // a pass's S would not fit in registers (float32 from d = 64 on)
  static constexpr int kCols = sizeof(T) == 2 || D < 64 ? kB
                               : D == 64                ? 32
                                                        : 16;
  // bfloat16 takes p = exp(x) by ex2.approx (__expf, within about 2^-21
  // of it): P is rounded to 8 bits, and l's error stays far below lse's
  // 1e-5; float32 keeps expf, whose last bits the training checks see
  static constexpr bool kFastExp = sizeof(T) == 2;
  static constexpr int kSmem = kRows * kP + kStages * 2 * kT + kLo;
  static_assert(kSmem <= 232448, "a block's shared memory on an H100");
};

// the warp's 16 rows of Q, in place: x * scale rounded to T
__device__ __forceinline__ void scale_rows(float* q, int n, float scale) {
  for (int e = threadIdx.x & 31; e < n; e += 32) q[e] = __fmul_rn(q[e], scale);
}
__device__ __forceinline__ void scale_rows(__nv_bfloat16* q, int n,
                                           float scale) {
  for (int e = threadIdx.x & 31; e < n; e += 32)
    q[e] = __float2bfloat16_rn(__fmul_rn(__bfloat162float(q[e]), scale));
}

// One pass over the keys k0 + [0, kCols) for the warp's 16 query rows
// (row0 = the thread's first row, last = the warp's last row), K's rows at
// kp and V's at kp + kT (lo: their TF32 lo parts): S = Q . K^T, the online
// softmax update of m, l (this thread's part) and acc, then acc += P . V.
// kEdge: the pass holds keys past t or, causal, after the warp's first
// row; they are masked, and n8 tiles wholly past t or after `last` are
// skipped (their p is exactly 0).
template <typename T, int D, bool CAUSAL, bool kEdge>
__device__ __forceinline__ void key_pass(float (&acc)[D / 8][4],
                                         float (&m)[2], float (&l)[2],
                                         const uint8_t* qw,
                                         const uint8_t* kp,
                                         const uint8_t* lo, int k0,
                                         int row0, int last, int t) {
  using S = Shape<T, D>;
  constexpr int NT = S::kCols / 8;
  const int tig = threadIdx.x & 3;
  int live = NT;
  if constexpr (kEdge) {
    live = min(live, (t - k0 + 7) / 8);
    if constexpr (CAUSAL) live = min(live, (last - k0) / 8 + 1);
  }
  float s[NT][4];
  zero(s);
  product_abt<T, D, S::kSplit, NT>(s, qw, kp, lo, live);
  if constexpr (kEdge) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * tig + (e & 1);
        if (key >= t)
          s[nt][e] = -INFINITY;  // past the sequence: no part of the row
        else if (CAUSAL && key > row0 + (e >> 1) * 8)
          s[nt][e] = kNegInf;  // the TPU kernel's causal mask value
      }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
  float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    corr[i] = expf(m[i] - mx[i]);
    m[i] = mx[i];
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[nt][e] - mx[e >> 1];
      s[nt][e] = S::kFastExp ? __expf(x) : expf(x);  // P, unrounded
      sum[e >> 1] += s[nt][e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] *= corr[e >> 1];
  product_ab<T, D, S::kSplit, false, NT>(acc, s, kp + S::kT, lo + S::kT,
                                         live);
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(Shape<T, D>::kThreads,
                                  Shape<T, D>::kMinBlocks)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int t, int nbh, int ntiles,
                     float scale, bool vec, bool pair) {
  using S = Shape<T, D>;
  constexpr int kP = S::kP, kT = S::kT, kR = S::kRows, kC = S::kCols;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* lo = smem + kR * kP + S::kStages * 2 * kT;  // kSplit only
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  // the heaviest causal tiles (the last query tiles) of every head first
  const int64_t bh = blockIdx.x % nbh;
  const int qt = ntiles - 1 - static_cast<int>(blockIdx.x / nbh);
  const int q0 = qt * kR;
  const int64_t base = bh * t * D;
  uint8_t* qw = smem + warp * 16 * kP;  // the warp's 16 rows of Q
  const int row0 = q0 + warp * 16 + g;  // and row0 + 8
  const int last = q0 + warp * 16 + 15;

  load_tile<T, D, kR, S::kThreads>(smem, q + base, q0, t, vec);
  float acc[D / 8][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  zero(acc);
  // exclusive key bound: causal rows of this tile see keys < q0 + kR only
  const int kend = CAUSAL ? min(q0 + kR, t) : t;
  ring<2 * kT, S::kStages>(
      smem + kR * kP, (kend + kB - 1) / kB,
      [&](int kt, uint8_t* st) {
        load_tile<T, D, kB, S::kThreads>(st, k + base, kt * kB, t, vec);
        load_tile<T, D, kB, S::kThreads>(st + kT, v + base, kt * kB, t, vec);
      },
      [](int) {},
      [&](int kt, uint8_t* st) {
        if (kt == 0) {  // Q (in the first tile's copy group) has arrived
          T* qrow = reinterpret_cast<T*>(qw);
#pragma unroll 1
          for (int r = 0; r < 16; ++r)
            scale_rows(qrow + r * (kP / static_cast<int>(sizeof(T))), D,
                       scale);
          __syncwarp();
        }
        if constexpr (S::kSplit) {
          split_stage<D, 2 * kB, S::kThreads>(st, lo);
          __syncthreads();
        }
#pragma unroll 1
        for (int c0 = 0; c0 < kB; c0 += kC) {  // keys k0 + [0, kC)
          const int k0 = kt * kB + c0;
          if (CAUSAL && k0 > last) break;  // every key after the warp's rows
          const int off = c0 * kP;
          if (k0 + kC > t || (CAUSAL && k0 + kC - 1 > q0 + warp * 16))
            key_pass<T, D, CAUSAL, true>(acc, m, l, qw, st + off, lo + off,
                                         k0, row0, last, t);
          else
            key_pass<T, D, CAUSAL, false>(acc, m, l, qw, st + off, lo + off,
                                          k0, row0, last, t);
        }
      });

#pragma unroll
  for (int i = 0; i < 2; ++i) {  // the row's l: the quad's parts
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = row0 + 8 * i;
    if (row >= t) continue;
    const float li = fmaxf(l[i], 1e-37f);
    T* p = o + base + static_cast<int64_t>(row) * D;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      store2(p, nt * 8 + 2 * tig, D, acc[nt][2 * i] / li,
             acc[nt][2 * i + 1] / li, pair);
    if (lse != nullptr && tig == 0) lse[bh * t + row] = m[i] + logf(li);
  }
}

template <typename T, int D, bool CAUSAL>
cudaError_t launch_one(const void* q, const void* k, const void* v, void* o,
                       float* lse, int64_t bh, int t, float scale, int device,
                       cudaStream_t stream) {
  using S = Shape<T, D>;
  const int ntiles = (t + S::kRows - 1) / S::kRows;
  if (bh * ntiles > 0x7fffffff) return cudaErrorInvalidValue;
  const cudaError_t err =
      allow_smem<flash_fwd_kernel<T, D, CAUSAL>>(device, S::kSmem);
  if (err != cudaSuccess) return err;
  // every row of d elements starts on 16 bytes when the tensor does
  const bool vec = aligned(q, 16) && aligned(k, 16) && aligned(v, 16);
  flash_fwd_kernel<T, D, CAUSAL>
      <<<static_cast<unsigned int>(bh * ntiles), S::kThreads, S::kSmem,
         stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                   static_cast<const T*>(v), static_cast<T*>(o), lse, t,
                   static_cast<int>(bh), ntiles, scale, vec,
                   pairs<T>(o, D));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_causal(const void* q, const void* k, const void* v,
                          void* o, float* lse, int64_t bh, int t, float scale,
                          int causal, int device, cudaStream_t stream) {
  if (causal)
    return launch_one<T, D, true>(q, k, v, o, lse, bh, t, scale, device,
                                  stream);
  return launch_one<T, D, false>(q, k, v, o, lse, bh, t, scale, device,
                                 stream);
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     float* lse, int64_t bh, int t, int d, float scale,
                     int causal, int device, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_causal<T, 16>(q, k, v, o, lse, bh, t, scale, causal,
                                  device, stream);
    case 32:
      return launch_causal<T, 32>(q, k, v, o, lse, bh, t, scale, causal,
                                  device, stream);
    case 64:
      return launch_causal<T, 64>(q, k, v, o, lse, bh, t, scale, causal,
                                  device, stream);
    case 128:
      return launch_causal<T, 128>(q, k, v, o, lse, bh, t, scale, causal,
                                   device, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, o: dense [bh, t, d] of `dtype` (0 = float32, 1 = bfloat16);
// lse: dense float32 [bh, t], or null when not wanted. d in {16, 32, 64,
// 128}. `scale` multiplies q in q's type. device: the CUDA device that
// holds the tensors and owns `stream`. Returns the CUDA error code of the
// launch (0 = launched); launches nothing for an empty input.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, void* lse, int64_t bh, int64_t t, int d,
                           float scale, int causal, int dtype, int device,
                           void* stream) {
  if (bh <= 0 || t <= 0) return 0;
  if (t > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  // this library carries its own CUDA runtime, whose current device is
  // per thread and independent of PyTorch's
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const int ti = static_cast<int>(t);
  if (dtype == 0)
    return static_cast<int>(launch_d<float>(q, k, v, o, l, bh, ti, d, scale,
                                            causal, device, s));
  if (dtype == 1)
    return static_cast<int>(launch_d<__nv_bfloat16>(
        q, k, v, o, l, bh, ti, d, scale, causal, device, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
