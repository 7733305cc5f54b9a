// Flash-attention backward (dq and dk/dv) for Hopper (sm_90a).
//
// Replaces the TPU kernels deeplearning4j_tpu/ops/pallas_kernels.py
// `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel` (their pallas_calls
// are in `_flash_bwd`). q, k, v and dO are dense [b*h, t, d]; lse is the
// float32 [b*h, t] row statistic m + log(l) that the forward kernel
// returned; delta is the float32 [b*h, t] row sum of dO * O, computed by the
// wrapper (the JAX package leaves it to XLA).
//
// What they compute, as the TPU kernels do:
//   - q is widened to float32 and multiplied by `scale` in float32 (the
//     backward does NOT round the scale or the product to q's type, unlike
//     the forward: the TPU kernels differ the same way);
//   - P is rebuilt from lse: p = exp(q.k - lse), set to 0 where causal
//     masking removes the key; dP = dO . v^T; dS = p * (dP - delta);
//   - dq = scale * sum over keys of dS . k (one factor of scale);
//   - dv = sum over queries of P^T . dO, dk = sum over queries of dS^T . q
//     with the pre-scaled q (dk carries its factor of scale through q);
//   - all sums in float32, results rounded once to the input's type.
// Unlike the TPU kernels they take any t: query and key rows at or past t
// are zero-filled and their p set to 0, and nothing past t is stored.
//
// Bound on an H100 SXM at the trained TransformerLM shape (b=16, h=8,
// t=512, d=64, causal): per causal (q, k) pair dq does three products of
// 2*d operations (q.k, dO.v, dS.k) and dk/dv four (q.k, dO.v, P^T.dO,
// dS^T.q); with t(t+1)/2 pairs per head that is 6.45 GFLOP for dq and 8.61
// GFLOP for dk/dv. These kernels keep float32 arithmetic on the CUDA cores,
// so they are bound by operations: 0.096 ms and 0.128 ms at 67 TFLOP/s
// (float32 bytes, each input read once and each output written once: 86 MB
// for dq, 103 MB for dk/dv, 0.026 and 0.031 ms at 3.35 TB/s).
//
// Design (simple and right; mma/wgmma and TMA are later work), the forward
// kernel's layout: 256 threads in a 16 x 16 grid over a 64 x 64 tile, each
// thread a 4 x 4 register micro-tile (rows ty + 16i, columns tx + 16j).
//   dq:  one block per (batch*head, 64-row query tile). The query and dO
//        tiles stay in shared memory; key and value tiles of 64 rows stream
//        through it up to the diagonal (causal early stop). Per key tile:
//        S and dP as micro-tiles, dS into shared memory, then each thread
//        adds dS . K into its 4 x d/16 slice of the dq accumulator in
//        registers. Blocks are issued heaviest causal tile first.
//   dkv: one block per (batch*head, 64-row key tile). The key and value
//        tiles stay in shared memory; query and dO tiles stream through it
//        from the diagonal on. Per query tile: S and dP as micro-tiles, P
//        and dS into shared memory, then each thread adds P^T . dO and
//        dS^T . Q into its 4 x d/16 slices of the dv and dk accumulators.
// Padded row strides (d + 1, 64 + 1) keep the column walks free of bank
// conflicts. Shared memory: at d = 128, 149 KB (dq) and 166 KB (dkv).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;          // rows per query or key tile
constexpr int kThreads = 256;   // 16 x 16 thread grid over a 64 x 64 tile
constexpr int kLS = kB + 1;     // row stride of a 64 x 64 score tile

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Loads rows [row0, row0 + 64) of a [t, D] matrix into a float32 tile with
// row stride D + 1, each value times `scale` in float32; rows at or past t
// are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int t, float scale) {
  for (int e = threadIdx.x; e < kB * D; e += kThreads) {
    const int r = e / D, c = e % D;
    float x = 0.0f;
    if (row0 + r < t)
      x = __fmul_rn(to_float(src[static_cast<int64_t>(row0 + r) * D + c]),
                    scale);
    dst[r * (D + 1) + c] = x;
  }
}

// Row statistics of rows [row0, row0 + 64): lse and delta, 0 past t.
__device__ __forceinline__ void load_rows(float* row_lse, float* row_delta,
                                          const float* lse, const float* delta,
                                          int64_t off, int row0, int t) {
  const int r = threadIdx.x;
  if (r < kB) {
    const bool in = row0 + r < t;
    row_lse[r] = in ? lse[off + row0 + r] : 0.0f;
    row_delta[r] = in ? delta[off + row0 + r] : 0.0f;
  }
}

// s = A_r . B_k and dp = C_r . E_k over the 4 x 4 micro-tile of rows
// ty + 16i of (A, C) against rows tx + 16j of (B, E), all row stride D + 1.
template <int D>
__device__ __forceinline__ void two_products(const float* A, const float* B,
                                             const float* C, const float* E,
                                             int ty, int tx, float s[4][4],
                                             float dp[4][4]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    float a[4], b[4], cc[4], e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = A[(ty + 16 * i) * LD + c];
      cc[i] = C[(ty + 16 * i) * LD + c];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = B[(tx + 16 * j) * LD + c];
      e[j] = E[(tx + 16 * j) * LD + c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        dp[i][j] = fmaf(cc[i], e[j], dp[i][j]);
      }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * static_cast<size_t>(kB) * (D + 1) +  // Q dO K V
                          static_cast<size_t>(kB) * kLS +          // dS
                          2 * kB);                                 // lse, delta
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * static_cast<size_t>(kB) * (D + 1) +  // K V Q dO
                          2 * static_cast<size_t>(kB) * kLS +      // P, dS
                          2 * kB);                                 // lse, delta
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int t, int nqt, float scale) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kB * LD;
  float* Ks = dOs + kB * LD;
  float* Vs = Ks + kB * LD;
  float* dSs = Vs + kB * LD;
  float* row_lse = dSs + kB * kLS;
  float* row_delta = row_lse + kB;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t bh = blockIdx.x / nqt;
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x % nqt);
  const int q0 = qt * kB;
  const int64_t base = bh * static_cast<int64_t>(t) * D;

  load_tile<T, D>(Qs, q + base, q0, t, scale);
  load_tile<T, D>(dOs, dout + base, q0, t, 1.0f);
  load_rows(row_lse, row_delta, lse, delta, bh * t, q0, t);

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;

  // exclusive key bound: causal rows of this tile see keys < q0 + 64 only
  const int kend = CAUSAL ? min(q0 + kB, t) : t;
  const int nkt = (kend + kB - 1) / kB;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();  // the previous tile's readers of K and dS are done
    load_tile<T, D>(Ks, k + base, k0, t, 1.0f);
    load_tile<T, D>(Vs, v + base, k0, t, 1.0f);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_products<D>(Qs, Ks, dOs, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        float p = expf(s[i][j] - row_lse[r]);
        if (row >= t || key >= t || (CAUSAL && key > row)) p = 0.0f;
        dSs[r * kLS + tx + 16 * j] = p * (dp[i][j] - row_delta[r]);
      }
    }
    __syncthreads();

    // acc += dS K for rows ty + 16i, columns tx + 16c
#pragma unroll 4
    for (int j = 0; j < kB; ++j) {
      float ds[4], kv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty + 16 * i) * kLS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = Ks[j * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(ds[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= t) continue;
    T* out = dq + base + static_cast<int64_t>(row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) store_as(out + tx + 16 * c, acc[i][c] * scale);
  }
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int t, int nkt, float scale) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kB * LD;
  float* Qs = Vs + kB * LD;
  float* dOs = Qs + kB * LD;
  float* Ps = dOs + kB * LD;
  float* dSs = Ps + kB * kLS;
  float* row_lse = dSs + kB * kLS;
  float* row_delta = row_lse + kB;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t bh = blockIdx.x / nkt;
  // key tile 0 sees every query tile under causal masking: issue it first
  const int kt = static_cast<int>(blockIdx.x % nkt);
  const int k0 = kt * kB;
  const int64_t base = bh * static_cast<int64_t>(t) * D;
  const int nqt = (t + kB - 1) / kB;

  load_tile<T, D>(Ks, k + base, k0, t, 1.0f);
  load_tile<T, D>(Vs, v + base, k0, t, 1.0f);

  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.0f;

  // query tiles strictly before this key tile see none of it
  for (int qt = CAUSAL ? kt : 0; qt < nqt; ++qt) {
    const int q0 = qt * kB;
    __syncthreads();  // the previous tile's readers of Q, dO, P, dS are done
    load_tile<T, D>(Qs, q + base, q0, t, scale);
    load_tile<T, D>(dOs, dout + base, q0, t, 1.0f);
    load_rows(row_lse, row_delta, lse, delta, bh * t, q0, t);
    __syncthreads();

    // S and dP for query rows ty + 16i, keys tx + 16j
    float s[4][4], dp[4][4];
    two_products<D>(Qs, Ks, dOs, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = tx + 16 * j;
        const int key = k0 + kk;
        float p = expf(s[i][j] - row_lse[r]);
        if (row >= t || key >= t || (CAUSAL && key > row)) p = 0.0f;
        Ps[r * kLS + kk] = p;
        dSs[r * kLS + kk] = p * (dp[i][j] - row_delta[r]);
      }
    }
    __syncthreads();

    // dv += P^T dO, dk += dS^T Q for keys ty + 16i, columns tx + 16c
#pragma unroll 2
    for (int j = 0; j < kB; ++j) {
      float pv[4], dsv[4], dov[NC], qv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[j * kLS + ty + 16 * i];
        dsv[i] = dSs[j * kLS + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        dov[c] = dOs[j * LD + tx + 16 * c];
        qv[c] = Qs[j * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dv_acc[i][c] = fmaf(pv[i], dov[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(dsv[i], qv[c], dk_acc[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= t) continue;
    T* kout = dk + base + static_cast<int64_t>(key) * D;
    T* vout = dv + base + static_cast<int64_t>(key) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      store_as(kout + tx + 16 * c, dk_acc[i][c]);
      store_as(vout + tx + 16 * c, dv_acc[i][c]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int64_t bh;
  int t;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, bool CAUSAL>
cudaError_t launch_dq(const Args& a) {
  const int nqt = (a.t + kB - 1) / kB;
  const int64_t blocks = a.bh * nqt;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  constexpr size_t bytes = dq_smem_bytes<D>();
  // above 48 KB a block's shared memory must be asked for per kernel
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D, CAUSAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D, CAUSAL>
      <<<static_cast<unsigned int>(blocks), kThreads, bytes, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
          a.delta, static_cast<T*>(a.dq), a.t, nqt, a.scale);
  return cudaGetLastError();
}

template <typename T, int D, bool CAUSAL>
cudaError_t launch_dkv(const Args& a) {
  const int nkt = (a.t + kB - 1) / kB;
  const int64_t blocks = a.bh * nkt;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  constexpr size_t bytes = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D, CAUSAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<T, D, CAUSAL>
      <<<static_cast<unsigned int>(blocks), kThreads, bytes, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
          a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.t, nkt,
          a.scale);
  return cudaGetLastError();
}

// which: 0 = dq, 1 = dk/dv
template <typename T, int D>
cudaError_t launch_causal(const Args& a, int causal, int which) {
  if (which == 0)
    return causal ? launch_dq<T, D, true>(a) : launch_dq<T, D, false>(a);
  return causal ? launch_dkv<T, D, true>(a) : launch_dkv<T, D, false>(a);
}

template <typename T>
cudaError_t launch_d(const Args& a, int d, int causal, int which) {
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

int launch(const Args& a, int d, int causal, int dtype, int device,
           int which) {
  if (a.bh <= 0 || a.t <= 0) return 0;
  // this library carries its own CUDA runtime, whose current device is per
  // thread and independent of PyTorch's
  const cudaError_t set = cudaSetDevice(device);
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
// `scale` multiplies q in float32. device: the CUDA device that holds the
// tensors and owns `stream`. Returns the CUDA error code of the launch (0 =
// launched); launches nothing for an empty input.
int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dq, int64_t bh,
                                  int64_t t, int d, float scale, int causal,
                                  int dtype, int device, void* stream) {
  if (t > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, nullptr, nullptr, bh,
               static_cast<int>(t), scale, static_cast<cudaStream_t>(stream)};
  return launch(a, d, causal, dtype, device, 0);
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
               static_cast<int>(t), scale, static_cast<cudaStream_t>(stream)};
  return launch(a, d, causal, dtype, device, 1);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
