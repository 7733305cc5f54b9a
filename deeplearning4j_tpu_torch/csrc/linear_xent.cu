// Fused linear + softmax cross-entropy, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels deeplearning4j_tpu/ops/xent_kernel.py
// `_fwd_kernel` (pallas_call in `_fwd`) and `_bwd_kernel` with its two dz
// variants `_dz_dense` and `_dz_idx` (pallas_call in `_bwd`). x is dense
// [n, d], W dense [d, v] (both float32, or both bfloat16 under the mixed
// precision policy), b float32 [v], labels float32 [n, v].
//
// Forward, per row (z = x . W + b, never written to device memory):
//   per_row = T * lse(z) - sum(t * z),  T = sum(t),  lse = m + log(s)
// with the online logsumexp (m starts at -1e30, s at 0), and the side
// outputs the backward reads: lse, T, the label argmax and the one-hot flag
// (|T - 1|, |sum t^2 - 1| and |max t - 1| all below 1e-4). The argmax is
// the first column holding the row's largest label; the TPU kernel's
// differs for rows with tied maxima (it depends on its vocab block), which
// are never one-hot, so the backward never reads it for them.
// Backward, with g the float32 per-row cotangent: z recomputed per tile,
// p = exp(z - lse), and
//   dz = (p * T - t) * g            dense labels (soft rows anywhere)
//   dz = (p - onehot(idx)) * g      every row one-hot: no label bytes read
// The choice is made in the kernel from the device flag `all_onehot` (the
// TPU kernel's lax.cond on the same flag), so the host never waits for it.
// dz is spilled in x's type (bfloat16 on the mixed path) for the wrapper's
// dW = x^T . dz gemm; dx = dz . W^T accumulates in float32 from the float32
// dz; db is summed per 64-row block, then over blocks in order by a second
// kernel (deterministic, no atomics).
//
// Bound on an H100 SXM at the trained TransformerLM shape (n = 16 * 512 =
// 8192 rows, d = 512, v = 8192, float32): the forward does one product of
// 2*n*d*v = 68.7 GFLOP (1.03 ms at 67 TFLOP/s) and reads the 268 MB of
// labels once (0.08 ms); the backward two products (z and dx), 137 GFLOP
// (2.05 ms), and writes the 268 MB dz spill (0.08 ms). Both are bound by
// operations on the CUDA cores until a later version moves the products
// onto the tensor cores.
//
// Design (simple and right; mma/wgmma and TMA are later work): 256 threads
// in a 16 x 16 grid over a 64-row x 64-column tile of z, each thread a
// 4 x 4 register micro-tile (rows ty + 16i, columns tx + 16j); the product
// streams x and W through shared memory in chunks of 32 along d.
//   forward:  a block owns 64 rows and one of `nsplit` contiguous ranges of
//             vocab tiles (nsplit chosen by the wrapper so that the grid
//             fills the card); each thread keeps an online (m, s), the label
//             sums and its argmax over its own columns; the 16 threads of a
//             row merge at the end into per-(split, row) partials, which a
//             second kernel merges over splits in order.
//   backward: a block owns 64 rows and walks every vocab tile: z, dz into
//             shared memory (and the spill), the block's column sums of dz
//             (db partials), then dx += dz . W^T with W streamed in chunks
//             of 64 rows; the dx accumulator of 64 x 512 float32 lives in
//             shared memory (178 KB in all). Wider d runs in passes of 512
//             columns, each recomputing z; only the first writes dz and db.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBN = 64;        // rows per block
constexpr int kBV = 64;        // vocab columns per tile
constexpr int kKC = 32;        // chunk of d per product step
constexpr int kThreads = 256;  // 16 x 16 thread grid over a 64 x 64 tile
constexpr int kDxW = 512;      // dx columns accumulated per backward pass
constexpr int kLX = kKC + 1;   // row stride of the x chunk
constexpr int kLZ = kBV + 1;   // row stride of the dz tile and W^T chunk
constexpr int kLDx = kDxW + 16;  // dx row stride: rows ty, ty+1 on other banks
constexpr float kNegInit = -1e30f;  // the TPU kernel's initial running max

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// z[i][j] = x[r0 + ty + 16i, :] . W[:, v0 + tx + 16j] in float32 (0 outside
// the matrices), x and W streamed through Xc [64 x 33] and Wc [32 x 64].
template <typename T>
__device__ __forceinline__ void z_tile(const T* __restrict__ x,
                                       const T* __restrict__ w, int n, int d,
                                       int v, int r0, int v0, float* Xc,
                                       float* Wc, float z[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) z[i][j] = 0.0f;
  for (int d0 = 0; d0 < d; d0 += kKC) {
    __syncthreads();  // the previous readers of Xc and Wc are done
    for (int e = tid; e < kBN * kKC; e += kThreads) {
      const int r = e / kKC, c = e % kKC;
      const int row = r0 + r, col = d0 + c;
      Xc[r * kLX + c] = (row < n && col < d)
                            ? to_float(x[static_cast<int64_t>(row) * d + col])
                            : 0.0f;
    }
    for (int e = tid; e < kKC * kBV; e += kThreads) {
      const int kk = e / kBV, vv = e % kBV;
      const int dd = d0 + kk, col = v0 + vv;
      Wc[kk * kBV + vv] = (dd < d && col < v)
                              ? to_float(w[static_cast<int64_t>(dd) * v + col])
                              : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kKC; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Xc[(ty + 16 * i) * kLX + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Wc[kk * kBV + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) z[i][j] = fmaf(a[i], b[j], z[i][j]);
    }
  }
}

// ------------------------------------------------------------------ forward
// Partials, per (split, row): part[(k * nsplit + split) * n + row] for k =
// 0 m, 1 s, 2 sum t*z, 3 T, 4 sum t^2, 5 max t; part_idx[split * n + row].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    xent_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ b,
                    const float* __restrict__ labels, float* __restrict__ part,
                    int* __restrict__ part_idx, int n, int d, int v,
                    int tiles_per_split, int nsplit) {
  __shared__ float Xc[kBN * kLX];
  __shared__ float Wc[kKC * kBV];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.x * kBN;
  const int split = blockIdx.y;
  const int nvt = (v + kBV - 1) / kBV;
  const int vt0 = split * tiles_per_split;
  const int vt1 = min(nvt, vt0 + tiles_per_split);

  float m[4], s[4], tz[4], ts[4], t2[4], bt[4];
  int bi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInit;
    s[i] = tz[i] = ts[i] = t2[i] = 0.0f;
    bt[i] = -1.0f;
    bi[i] = 0;
  }
  for (int vt = vt0; vt < vt1; ++vt) {
    const int v0 = vt * kBV;
    float z[4][4];
    z_tile<T>(x, w, n, d, v, r0, v0, Xc, Wc, z);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty + 16 * i;
      float zz[4], tt[4];
      float mx = kNegInit;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = v0 + tx + 16 * j;
        const bool in = row < n && col < v;
        zz[j] = in ? z[i][j] + b[col] : -INFINITY;
        tt[j] = in ? labels[static_cast<int64_t>(row) * v + col] : 0.0f;
        mx = fmaxf(mx, zz[j]);
      }
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sum += expf(zz[j] - m_new);
        if (zz[j] != -INFINITY) {
          tz[i] = fmaf(tt[j], zz[j], tz[i]);
          ts[i] += tt[j];
          t2[i] = fmaf(tt[j], tt[j], t2[i]);
          if (tt[j] > bt[i]) {  // strict: the first column keeps a tie
            bt[i] = tt[j];
            bi[i] = v0 + tx + 16 * j;
          }
        }
      }
      s[i] = s[i] * expf(m[i] - m_new) + sum;
      m[i] = m_new;
    }
  }

  // merge the 16 threads of each row (lanes that differ in bits 0-3)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float s_o = __shfl_xor_sync(0xffffffffu, s[i], off);
      const float m_new = fmaxf(m[i], m_o);
      s[i] = s[i] * expf(m[i] - m_new) + s_o * expf(m_o - m_new);
      m[i] = m_new;
      tz[i] += __shfl_xor_sync(0xffffffffu, tz[i], off);
      ts[i] += __shfl_xor_sync(0xffffffffu, ts[i], off);
      t2[i] += __shfl_xor_sync(0xffffffffu, t2[i], off);
      const float bt_o = __shfl_xor_sync(0xffffffffu, bt[i], off);
      const int bi_o = __shfl_xor_sync(0xffffffffu, bi[i], off);
      if (bt_o > bt[i] || (bt_o == bt[i] && bi_o < bi[i])) {
        bt[i] = bt_o;
        bi[i] = bi_o;
      }
    }
    const int row = r0 + ty + 16 * i;
    if (tx == 0 && row < n) {
      const float vals[6] = {m[i], s[i], tz[i], ts[i], t2[i], bt[i]};
#pragma unroll
      for (int k = 0; k < 6; ++k)
        part[(static_cast<int64_t>(k) * nsplit + split) * n + row] = vals[k];
      part_idx[static_cast<int64_t>(split) * n + row] = bi[i];
    }
  }
}

__global__ void xent_fwd_combine_kernel(const float* __restrict__ part,
                                        const int* __restrict__ part_idx,
                                        float* __restrict__ per_row,
                                        float* __restrict__ lse,
                                        float* __restrict__ tsum,
                                        int* __restrict__ idx,
                                        float* __restrict__ onehot, int n,
                                        int nsplit) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float m = kNegInit, s = 0.0f, tz = 0.0f, ts = 0.0f, t2 = 0.0f, bt = -1.0f;
  int bi = 0;
  for (int sp = 0; sp < nsplit; ++sp) {
    const float* p = part + static_cast<int64_t>(sp) * n + row;
    const int64_t stride = static_cast<int64_t>(nsplit) * n;
    const float m_o = p[0], s_o = p[stride];
    const float m_new = fmaxf(m, m_o);
    s = s * expf(m - m_new) + s_o * expf(m_o - m_new);
    m = m_new;
    tz += p[2 * stride];
    ts += p[3 * stride];
    t2 += p[4 * stride];
    const float bt_o = p[5 * stride];
    if (bt_o > bt) {  // splits in vocab order: the first keeps a tie
      bt = bt_o;
      bi = part_idx[static_cast<int64_t>(sp) * n + row];
    }
  }
  const float l = m + logf(s);
  lse[row] = l;
  tsum[row] = ts;
  per_row[row] = ts * l - tz;
  idx[row] = bi;
  onehot[row] = (fabsf(ts - 1.0f) < 1e-4f && fabsf(t2 - 1.0f) < 1e-4f &&
                 fabsf(bt - 1.0f) < 1e-4f)
                    ? 1.0f
                    : 0.0f;
}

// ----------------------------------------------------------------- backward
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBN) * kLDx +  // dx
                          kBN * kLX +                        // x chunk
                          kBN * kLZ +                        // W chunks
                          kBN * kLZ +                        // dz tile
                          3 * kBN) +                         // lse, T, g
         sizeof(int) * kBN;                                  // idx
}
static_assert(kKC * kBV <= kBN * kLZ, "the W buffer holds both chunk shapes");

template <typename T>
__global__ void __launch_bounds__(kThreads)
    xent_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ b,
                    const float* __restrict__ labels,
                    const int* __restrict__ idx,
                    const float* __restrict__ all_onehot,
                    const float* __restrict__ lse,
                    const float* __restrict__ tsum,
                    const float* __restrict__ g, T* __restrict__ dx,
                    T* __restrict__ dz, float* __restrict__ db_part, int n,
                    int d, int v, int dx_c0, int dx_w, int first_pass) {
  extern __shared__ float smem[];
  float* Dx = smem;
  float* Xc = Dx + kBN * kLDx;
  float* Wb = Xc + kBN * kLX;
  float* Dz = Wb + kBN * kLZ;
  float* row_lse = Dz + kBN * kLZ;
  float* row_T = row_lse + kBN;
  float* row_g = row_T + kBN;
  int* row_idx = reinterpret_cast<int*>(row_g + kBN);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int rb = blockIdx.x;
  const int r0 = rb * kBN;
  // the TPU kernel's lax.cond, read on the device
  const bool use_idx = *all_onehot > 0.5f;

  for (int e = tid; e < kBN * kLDx; e += kThreads) Dx[e] = 0.0f;
  if (tid < kBN) {
    const int row = r0 + tid;
    const bool in = row < n;
    row_lse[tid] = in ? lse[row] : 0.0f;
    row_T[tid] = in ? tsum[row] : 0.0f;
    row_g[tid] = in ? g[row] : 0.0f;
    row_idx[tid] = in ? idx[row] : -1;
  }

  const int nvt = (v + kBV - 1) / kBV;
  for (int vt = 0; vt < nvt; ++vt) {
    const int v0 = vt * kBV;
    float z[4][4];
    z_tile<T>(x, w, n, d, v, r0, v0, Xc, Wb, z);  // begins with a barrier
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int row = r0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int vv = tx + 16 * j;
        const int col = v0 + vv;
        float dzv = 0.0f;
        if (row < n && col < v) {
          const float p = expf(z[i][j] + b[col] - row_lse[r]);
          if (use_idx) {
            dzv = (p - (col == row_idx[r] ? 1.0f : 0.0f)) * row_g[r];
          } else {
            const float t = labels[static_cast<int64_t>(row) * v + col];
            dzv = (p * row_T[r] - t) * row_g[r];
          }
          if (first_pass)
            store_as(dz + static_cast<int64_t>(row) * v + col, dzv);
        }
        Dz[r * kLZ + vv] = dzv;
      }
    }
    __syncthreads();
    if (first_pass && tid < kBV && v0 + tid < v) {
      float sum = 0.0f;
      for (int r = 0; r < kBN; ++r) sum += Dz[r * kLZ + tid];
      db_part[static_cast<int64_t>(rb) * v + v0 + tid] = sum;
    }

    // dx[:, c] += sum_j dz[:, j] * W[c, v0 + j] for this pass's columns
    for (int dc = 0; dc < dx_w; dc += kBV) {
      __syncthreads();  // the previous readers of Wb (and Dz's sums) are done
      for (int e = tid; e < kBV * kBV; e += kThreads) {
        const int cc = e / kBV, vv = e % kBV;
        const int dd = dx_c0 + dc + cc, col = v0 + vv;
        Wb[cc * kLZ + vv] = (dc + cc < dx_w && col < v)
                                ? to_float(w[static_cast<int64_t>(dd) * v + col])
                                : 0.0f;
      }
      __syncthreads();
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[i][c] = Dx[(ty + 16 * i) * kLDx + dc + tx + 16 * c];
#pragma unroll 8
      for (int j = 0; j < kBV; ++j) {
        float a[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Dz[(ty + 16 * i) * kLZ + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) wv[c] = Wb[(tx + 16 * c) * kLZ + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(a[i], wv[c], acc[i][c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          Dx[(ty + 16 * i) * kLDx + dc + tx + 16 * c] = acc[i][c];
    }
  }
  __syncthreads();
  for (int e = tid; e < kBN * dx_w; e += kThreads) {
    const int r = e / dx_w, c = e % dx_w;
    const int row = r0 + r;
    if (row < n)
      store_as(dx + static_cast<int64_t>(row) * d + dx_c0 + c,
               Dx[r * kLDx + c]);
  }
}

__global__ void xent_db_kernel(const float* __restrict__ db_part,
                               float* __restrict__ db, int nrb, int v) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= v) return;
  float sum = 0.0f;
  for (int rb = 0; rb < nrb; ++rb)
    sum += db_part[static_cast<int64_t>(rb) * v + col];
  db[col] = sum;
}

template <typename T>
cudaError_t fwd(const void* x, const void* w, const float* b,
                const float* labels, float* part, int* part_idx,
                float* per_row, float* lse, float* tsum, int* idx,
                float* onehot, int n, int d, int v, int nsplit,
                cudaStream_t stream) {
  const int nrb = (n + kBN - 1) / kBN;
  const int nvt = (v + kBV - 1) / kBV;
  const int per = (nvt + nsplit - 1) / nsplit;
  xent_fwd_kernel<T><<<dim3(nrb, nsplit), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), b, labels, part,
      part_idx, n, d, v, per, nsplit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  xent_fwd_combine_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      part, part_idx, per_row, lse, tsum, idx, onehot, n, nsplit);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* x, const void* w, const float* b,
                const float* labels, const int* idx, const float* all_onehot,
                const float* lse, const float* tsum, const float* g, void* dx,
                void* dz, float* db_part, float* db, int n, int d, int v,
                cudaStream_t stream) {
  const int nrb = (n + kBN - 1) / kBN;
  constexpr size_t bytes = bwd_smem_bytes();
  // above 48 KB a block's shared memory must be asked for per kernel
  cudaError_t err = cudaFuncSetAttribute(
      xent_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  for (int c0 = 0; c0 < d; c0 += kDxW) {
    xent_bwd_kernel<T><<<nrb, kThreads, bytes, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), b, labels, idx,
        all_onehot, lse, tsum, g, static_cast<T*>(dx), static_cast<T*>(dz),
        db_part, n, d, v, c0, min(kDxW, d - c0), c0 == 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  xent_db_kernel<<<(v + 255) / 256, 256, 0, stream>>>(db_part, db, nrb, v);
  return cudaGetLastError();
}

bool bad_sizes(int64_t n, int64_t d, int64_t v) {
  return n < 0 || d <= 0 || v <= 0 || n > 0x7fffffff || d > 0x7fffffff ||
         v > 0x7fffffff;
}

}  // namespace

extern "C" {

// x [n, d] and w [d, v] dense of `dtype` (0 = float32, 1 = bfloat16); b
// float32 [v]; labels float32 [n, v]; part float32 [6 * nsplit * n] and
// part_idx int32 [nsplit * n] scratch; outputs float32 [n] per_row, lse,
// tsum, onehot and int32 [n] idx. Returns the CUDA error code of the
// launches (0 = launched); launches nothing for n = 0.
int linear_xent_fwd_launch(const void* x, const void* w, const void* b,
                           const void* labels, void* part, void* part_idx,
                           void* per_row, void* lse, void* tsum, void* idx,
                           void* onehot, int64_t n, int64_t d, int64_t v,
                           int nsplit, int dtype, int device, void* stream) {
  if (bad_sizes(n, d, v) || nsplit < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  // this library carries its own CUDA runtime, whose current device is per
  // thread and independent of PyTorch's
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(b);
  const float* lf = static_cast<const float*>(labels);
  float* pf = static_cast<float*>(part);
  int* pi = static_cast<int*>(part_idx);
  float *o_row = static_cast<float*>(per_row), *o_lse = static_cast<float*>(lse),
        *o_ts = static_cast<float*>(tsum), *o_oh = static_cast<float*>(onehot);
  int* o_idx = static_cast<int*>(idx);
  const int ni = static_cast<int>(n), di = static_cast<int>(d),
            vi = static_cast<int>(v);
  if (dtype == 0)
    return static_cast<int>(fwd<float>(x, w, bf, lf, pf, pi, o_row, o_lse,
                                       o_ts, o_idx, o_oh, ni, di, vi, nsplit,
                                       s));
  if (dtype == 1)
    return static_cast<int>(fwd<__nv_bfloat16>(x, w, bf, lf, pf, pi, o_row,
                                               o_lse, o_ts, o_idx, o_oh, ni,
                                               di, vi, nsplit, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, w, b, labels as above; idx int32 [n], lse, tsum, g float32 [n] and
// all_onehot a float32 scalar, all on the device; outputs dx [n, d] and the
// dz spill [n, v] of `dtype`, db float32 [v]; db_part float32 [ceil(n / 64)
// * v] scratch. Returns the CUDA error code of the launches; launches
// nothing for n = 0 (db is then left to the caller).
int linear_xent_bwd_launch(const void* x, const void* w, const void* b,
                           const void* labels, const void* idx,
                           const void* all_onehot, const void* lse,
                           const void* tsum, const void* g, void* dx, void* dz,
                           void* db_part, void* db, int64_t n, int64_t d,
                           int64_t v, int dtype, int device, void* stream) {
  if (bad_sizes(n, d, v)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(b);
  const float* lf = static_cast<const float*>(labels);
  const int* ii = static_cast<const int*>(idx);
  const float* oh = static_cast<const float*>(all_onehot);
  const float* lsef = static_cast<const float*>(lse);
  const float* tsf = static_cast<const float*>(tsum);
  const float* gf = static_cast<const float*>(g);
  float* dbp = static_cast<float*>(db_part);
  float* dbf = static_cast<float*>(db);
  const int ni = static_cast<int>(n), di = static_cast<int>(d),
            vi = static_cast<int>(v);
  if (dtype == 0)
    return static_cast<int>(bwd<float>(x, w, bf, lf, ii, oh, lsef, tsf, gf, dx,
                                       dz, dbp, dbf, ni, di, vi, s));
  if (dtype == 1)
    return static_cast<int>(bwd<__nv_bfloat16>(x, w, bf, lf, ii, oh, lsef,
                                               tsf, gf, dx, dz, dbp, dbf, ni,
                                               di, vi, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* linear_xent_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
