// Flash-attention forward o = softmax(q * scale . k^T) . v for Hopper (sm_90a).
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
//     product (bfloat16 rounds P as the TPU's MXU feed does);
//   - o = acc / max(l, 1e-37) in q's type, lse = m + log(max(l, 1e-37)).
// Unlike the TPU kernel it takes any t: the ragged last query tile is not
// stored and keys past t are left out of the row (p = 0, zero-filled V).
//
// Bound on an H100 SXM at the served TransformerLM shape (b=16, h=8,
// t=512, d=64, causal): a causal row attends to t(t+1)/2 (q, k) pairs per
// (b, h); two products of 2*d operations per pair give 4.30 GFLOP per
// launch against 67 MB moved in float32 (q, k, v read once, o written
// once). This kernel keeps float32 arithmetic on the CUDA cores (no TF32),
// so it is bound by operations: 4.30e9 / 67e12 = 0.064 ms per launch. In
// bfloat16 the same work on the tensor cores would be bound by its 34 MB
// of bytes (0.010 ms); this kernel still does float32 FMAs there.
//
// Design (simple and right; mma/wgmma and TMA are later work): one block of
// 256 threads per (batch*head, 64-row query tile). The query tile is loaded
// once into shared memory, pre-scaled; key and value tiles of 64 rows are
// streamed through shared memory (as float32, whatever the input type). Per
// key tile: S = Q K^T as a 4x4 register micro-tile per thread into shared
// memory, masked; one warp per 8 rows runs the online-softmax update and
// writes P over S; then each thread updates its 4 x d/16 slice of the output
// accumulator (rows ty + 16i, columns tx + 16c: the same rows it scored), in
// float32 registers, rescaled by the row's correction factor. Row state m, l
// and the correction live in shared memory. Padded row strides (d + 1,
// 64 + 1) keep the column walks free of bank conflicts. Blocks are issued
// heaviest causal tile first to shorten the tail.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // key rows per streamed tile
constexpr int kThreads = 256;   // 16 x 16 thread grid over the 64 x 64 tile
constexpr float kNegInf = -1e30f;
static_assert(kBQ == kBK,
              "load_tile and the causal key bound assume one tile height");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to T and widened back to float32
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(kBQ) * (D + 1) +       // Q tile
          2 * static_cast<size_t>(kBK) * (D + 1) +   // K and V tiles
          static_cast<size_t>(kBQ) * (kBK + 1) +     // S / P tile
          3 * kBQ);                                  // row m, l, correction
}

// Loads rows [row0, row0 + 64) of a [t, D] matrix into a float32 tile with
// row stride D + 1; rows at or past t are zero. `scale` != 1 multiplies in
// T's arithmetic (the pre-scaled query).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int t, float scale, bool scaled) {
  for (int e = threadIdx.x; e < kBK * D; e += kThreads) {
    const int r = e / D, c = e % D;
    float x = 0.0f;
    if (row0 + r < t) {
      x = to_float(src[static_cast<int64_t>(row0 + r) * D + c]);
      if (scaled) x = round_as(__fmul_rn(x, scale), src);
    }
    dst[r * (D + 1) + c] = x;
  }
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int t, int nqt, float scale) {
  constexpr int LD = D + 1;
  constexpr int LS = kBK + 1;
  constexpr int NC = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ss = Vs + kBK * LD;
  float* row_m = Ss + kBQ * LS;
  float* row_l = row_m + kBQ;
  float* row_c = row_l + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int64_t bh = blockIdx.x / nqt;
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x % nqt);
  const int q0 = qt * kBQ;
  const int64_t base = bh * static_cast<int64_t>(t) * D;

  load_tile<T, D>(Qs, q + base, q0, t, scale, true);
  if (tid < kBQ) {
    row_m[tid] = kNegInf;
    row_l[tid] = 0.0f;
  }
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;

  // exclusive key bound: causal rows of this tile see keys < q0 + 64 only
  const int kend = CAUSAL ? min(q0 + kBQ, t) : t;
  const int nkt = (kend + kBK - 1) / kBK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers of K, V and P are done
    load_tile<T, D>(Ks, k + base, k0, t, 1.0f, false);
    load_tile<T, D>(Vs, v + base, k0, t, 1.0f, false);
    __syncthreads();

    // S = Q K^T for rows ty + 16i, keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = tx + 16 * j;
        float x = s[i][j];
        if (k0 + kk >= t)
          x = -INFINITY;  // past the sequence: no part of the row
        else if (CAUSAL && k0 + kk > q0 + r)
          x = kNegInf;  // the TPU kernel's causal mask value
        Ss[r * LS + kk] = x;
      }
    }
    __syncthreads();

    // online softmax: one warp per 8 rows, two keys per lane
#pragma unroll 1
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * (kBQ / 8) + rr;
      const float a = Ss[r * LS + lane];
      const float b = Ss[r * LS + lane + 32];
      float mx = fmaxf(a, b);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      const float pa = expf(a - m_new);
      const float pb = expf(b - m_new);
      float sum = pa + pb;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      Ss[r * LS + lane] = round_as(pa, v);
      Ss[r * LS + lane + 32] = round_as(pb, v);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        row_c[r] = corr;
        row_l[r] = row_l[r] * corr + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V for rows ty + 16i, columns tx + 16c
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = row_c[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ss[(ty + 16 * i) * LS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[j * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

  // row_m / row_l are final: the last tile's softmax was followed by a
  // barrier
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= t) continue;
    const float l = fmaxf(row_l[r], 1e-37f);
    T* orow = o + base + static_cast<int64_t>(q0 + r) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) store_as(orow + tx + 16 * c, acc[i][c] / l);
  }
  if (lse != nullptr && tid < kBQ && q0 + tid < t) {
    lse[bh * t + q0 + tid] = row_m[tid] + logf(fmaxf(row_l[tid], 1e-37f));
  }
}

template <typename T, int D, bool CAUSAL>
cudaError_t launch_one(const void* q, const void* k, const void* v, void* o,
                       float* lse, int64_t bh, int t, float scale,
                       cudaStream_t stream) {
  const int nqt = (t + kBQ - 1) / kBQ;
  const int64_t blocks = bh * nqt;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  constexpr size_t bytes = smem_bytes<D>();
  // above 48 KB a block's shared memory must be asked for per kernel
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, CAUSAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T, D, CAUSAL>
      <<<static_cast<unsigned int>(blocks), kThreads, bytes, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o), lse, t, nqt, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_causal(const void* q, const void* k, const void* v,
                          void* o, float* lse, int64_t bh, int t, float scale,
                          int causal, cudaStream_t stream) {
  if (causal)
    return launch_one<T, D, true>(q, k, v, o, lse, bh, t, scale, stream);
  return launch_one<T, D, false>(q, k, v, o, lse, bh, t, scale, stream);
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     float* lse, int64_t bh, int t, int d, float scale,
                     int causal, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_causal<T, 16>(q, k, v, o, lse, bh, t, scale, causal,
                                  stream);
    case 32:
      return launch_causal<T, 32>(q, k, v, o, lse, bh, t, scale, causal,
                                  stream);
    case 64:
      return launch_causal<T, 64>(q, k, v, o, lse, bh, t, scale, causal,
                                  stream);
    case 128:
      return launch_causal<T, 128>(q, k, v, o, lse, bh, t, scale, causal,
                                   stream);
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
    return static_cast<int>(
        launch_d<float>(q, k, v, o, l, bh, ti, d, scale, causal, s));
  if (dtype == 1)
    return static_cast<int>(
        launch_d<__nv_bfloat16>(q, k, v, o, l, bh, ti, d, scale, causal, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
