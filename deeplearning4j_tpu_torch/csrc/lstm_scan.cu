// Fused LSTM forward over all timesteps, in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas_kernels.py
// `_lstm_kernel` (pallas_call in `_lstm_fwd`, entry points `lstm_scan` and
// `lstm_scan_peephole`). Inputs, all of one type T (float32 or bfloat16),
// dense row-major:
//   zx [b, t, 4n]   x @ W + bias, gate order i, f, g, o
//   R  [n, 4n]      recurrent weights
//   p  [3, n]       Graves peepholes (pi, pf, po), or null
//   h0, c0 [b, n]   initial carry
//   mask [b, t]     float32 sequence mask, or null; a step is live iff > 0
// Outputs in T: hs [b, t, n] at every step, hT and cT [b, n] once at the end.
// The chunked entry point (`lstm_scan_chunked_launch`, which replaces the TPU
// kernel `_lstm_chunk_fwd_kernel`, pallas_call in `_lstm_chunked`) also
// writes float32 checkpoints hck, cck [ceil(t / tc), b, n]: the carry
// entering steps 0, tc, 2 tc, ... (hck[0] = h0), which the chunked backward
// (lstm_scan_bwd.cu) recomputes each chunk from. It is the same kernel: the
// TPU needed a second one only because its full-t kernel kept [bb, t, 4n]
// resident in VMEM, while here zx and hs stream through device memory at
// every t.
//
// What it computes, as `_lstm_kernel` does: R, p, z_t, h0 and c0 are raised
// to float32; h and c are carried in float32 across steps; per step
//   z = z_t + h @ R                          (float32 FMAs, no TF32)
//   i = sigmoid(z_i + pi*c), f = sigmoid(z_f + pf*c), g = tanh(z_g)
//   c' = f*c + i*g,  o = sigmoid(z_o + po*c'),  h' = o * tanh(c')
// and a masked step outputs 0 and carries h and c through unchanged. Only
// hs, hT and cT are rounded to T. sigmoid(x) = 1 / (1 + expf(-x)); the
// build has no fast-math.
//
// Bound on an H100 SXM at the served TextGenerationLSTM shape (b=64, t=64,
// n=256, float32): 2*b*n*4n*t = 2.15 GFLOP of recurrent products against
// 22.3 MB moved, so operations bind: 2.15e9 / 67e12 = 0.032 ms per launch.
// The bound does not count the chain of t dependent steps, each of which
// needs the whole previous h: that latency, not the FMA rate, is what a
// small-batch recurrence pays.
//
// Design (column split over a thread-block cluster; simple and right first,
// wgmma/TMA/multicast are later work). R [n, 4n] is 1 MiB at n=256 in
// float32, more than one SM's shared memory, and every step needs all of h
// against all of R. So a cluster of kCluster = 8 blocks shares one batch
// tile of kRows = 8 rows: block q owns hidden units [q*J, (q+1)*J), J =
// ceil(n/8), and the C = 4J columns of R that feed their gates. Its slice
// of R stays resident in shared memory for all t steps (as float32, [k][C])
// when it fits (n up to about 290), else it is read from L2 every step.
// Each step: (1) every block forms z for its C columns and 8 rows from the
// full h_{t-1} in its own shared memory, split over k: KS groups of threads
// each take a range of k, and each thread keeps an 8-row x 4-column tile of
// sums in registers, so one broadcast float4 of h and one float4 of R feed
// 16 FMAs and shared-memory loads do not bound the product; the KS partial
// sums go to shared memory; (2) one thread per (row, unit) adds the partials
// and zx, applies the cell, keeps c and h in registers, writes hs, and
// stores h_t into the next h buffer of all 8 blocks of the cluster
// (distributed shared memory); (3) one cluster barrier. The h buffers are
// double-buffered, so that barrier is the only one across blocks per step.
// Batch tiles run as independent clusters along grid y. n is capped at
// kMaxN = 1024 (each thread keeps at most 4 (row, unit) carries in
// registers).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;    // blocks per cluster: the column split
constexpr int kRows = 8;       // batch rows per cluster
constexpr int kThreads = 256;
constexpr int kMaxN = 1024;
constexpr int kPairs = 4;      // max (row, unit) pairs per thread
static_assert(kRows * ((kMaxN + kCluster - 1) / kCluster) <=
                  kPairs * kThreads,
              "each thread carries at most kPairs (row, unit) pairs");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

constexpr int kCols = 4;       // columns per thread in the product tile

struct Dims {
  int b, t, n;
  int J;      // hidden units per block
  int C;      // 4 * J columns per block
  int NP;     // n rounded up to 4: h row stride, resident R rows
  int TPG;    // threads per k-group: ceil(C / kCols)
  int KS;     // k-groups (kThreads / TPG)
  int KC;     // k per group, a multiple of 4
};

template <typename T, bool RESIDENT>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    lstm_scan_kernel(const T* __restrict__ zx, const T* __restrict__ R,
                     const T* __restrict__ p, const float* __restrict__ mask,
                     const T* __restrict__ h0, const T* __restrict__ c0,
                     T* __restrict__ hs, T* __restrict__ hT,
                     T* __restrict__ cT, float* __restrict__ hck,
                     float* __restrict__ cck, int tc, Dims d) {
  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int n = d.n, J = d.J, C = d.C, NP = d.NP;
  const int u0 = q * J;                    // first hidden unit of this block
  const int b0 = blockIdx.y * kRows;       // first batch row of the cluster
  const int64_t n4 = 4 * static_cast<int64_t>(n);

  extern __shared__ __align__(16) float smem[];
  float* hbuf0 = smem;                     // [kRows, NP] h_{t-1}
  float* hbuf1 = hbuf0 + kRows * NP;       // [kRows, NP] h_t
  float* part = hbuf1 + kRows * NP;        // [KS, kRows, C] partial sums
  float* Rs = part + d.KS * kRows * C;     // [NP, C] resident R slice

  // ---- set-up: zeroed h buffers (the pad columns stay 0), h0, R slice
  for (int e = tid; e < 2 * kRows * NP; e += kThreads) smem[e] = 0.0f;
  __syncthreads();
  for (int e = tid; e < kRows * n; e += kThreads) {
    const int r = e / n, k = e % n;
    if (b0 + r < d.b)
      hbuf0[r * NP + k] =
          to_float(h0[static_cast<int64_t>(b0 + r) * n + k]);
  }
  if (RESIDENT) {
    // kCopy loads in flight per thread: one at a time, the copy of a 128 KB
    // slice waits on memory latency for tens of microseconds
    constexpr int kCopy = 16;
    for (int e0 = tid; e0 < NP * C; e0 += kCopy * kThreads) {
      float v[kCopy];
#pragma unroll
      for (int i = 0; i < kCopy; ++i) {
        const int e = e0 + i * kThreads;
        const int k = e / C, c = e % C;
        const int g = c / J, u = u0 + c % J;
        v[i] = e < NP * C && k < n && u < n
                   ? to_float(R[k * n4 + g * n + u])
                   : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kCopy; ++i)
        if (e0 + i * kThreads < NP * C) Rs[e0 + i * kThreads] = v[i];
    }
  }

  // ---- this thread's product tile: k-group kg, columns col0 .. col0 + 3
  const int kg = tid / d.TPG;
  const int col0 = (tid % d.TPG) * kCols;
  const bool tile_ok = kg < d.KS;
  const int k_lo = kg * d.KC;
  const int k_hi = min(NP, k_lo + d.KC);
  int64_t rofs[kCols];  // column offsets into a row of R (global path)
  bool rok[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const int c = col0 + i;
    rok[i] = u0 + c % J < n;
    rofs[i] = rok[i] ? (c / J) * n + u0 + c % J : 0;
  }

  // ---- this thread's (row, unit) pairs: carries and peepholes in registers
  float hreg[kPairs], creg[kPairs], pi[kPairs], pf[kPairs], po[kPairs];
  int prow[kPairs], punit[kPairs];
  bool pok[kPairs];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int pidx = tid + i * kThreads;
    const int r = pidx / J, j = pidx % J;
    prow[i] = b0 + r;
    punit[i] = u0 + j;
    pok[i] = pidx < kRows * J && r < kRows && b0 + r < d.b && u0 + j < n;
    hreg[i] = creg[i] = pi[i] = pf[i] = po[i] = 0.0f;
    if (pok[i]) {
      const int64_t at = static_cast<int64_t>(prow[i]) * n + punit[i];
      hreg[i] = to_float(h0[at]);
      creg[i] = to_float(c0[at]);
      if (p != nullptr) {
        pi[i] = to_float(p[punit[i]]);
        pf[i] = to_float(p[n + punit[i]]);
        po[i] = to_float(p[2 * n + punit[i]]);
      }
    }
  }
  // every block's buffers are ready before any peer writes into them
  cluster.sync();

  float* hcur = hbuf0;
  float* hnext = hbuf1;
  const int n_even = n & ~3;
  for (int s = 0; s < d.t; ++s) {
    // checkpoint the float32 carry entering each chunk
    if (hck != nullptr && s % tc == 0) {
      const int64_t ck = static_cast<int64_t>(s / tc) * d.b * n;
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        if (!pok[i]) continue;
        hck[ck + static_cast<int64_t>(prow[i]) * n + punit[i]] = hreg[i];
        cck[ck + static_cast<int64_t>(prow[i]) * n + punit[i]] = creg[i];
      }
    }
    // zx and mask of this step, loaded before the product hides their
    // latency behind it
    float zxv[kPairs][4];
    bool live[kPairs];
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      live[i] = true;
#pragma unroll
      for (int g = 0; g < 4; ++g) zxv[i][g] = 0.0f;
      if (pok[i]) {
        const int64_t row = (static_cast<int64_t>(prow[i]) * d.t + s) * n4;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          zxv[i][g] = to_float(zx[row + g * n + punit[i]]);
        if (mask != nullptr)
          live[i] = mask[static_cast<int64_t>(prow[i]) * d.t + s] > 0.0f;
      }
    }

    // (1) part[kg][r][c] = sum over this group's k of h[r][k] * R[k][c]
    if (tile_ok) {
      float acc[kRows][kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int i = 0; i < kCols; ++i) acc[r][i] = 0.0f;
      for (int k = k_lo; k < k_hi; k += 4) {
        float4 h4[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          h4[r] = *reinterpret_cast<const float4*>(&hcur[r * NP + k]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float4 rv;
          if (RESIDENT) {
            rv = *reinterpret_cast<const float4*>(&Rs[(k + kk) * C + col0]);
          } else {
            const bool in = k + kk < n;
            const T* row = R + (k + kk) * n4;
            rv.x = in && rok[0] ? to_float(row[rofs[0]]) : 0.0f;
            rv.y = in && rok[1] ? to_float(row[rofs[1]]) : 0.0f;
            rv.z = in && rok[2] ? to_float(row[rofs[2]]) : 0.0f;
            rv.w = in && rok[3] ? to_float(row[rofs[3]]) : 0.0f;
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float hv = kk == 0   ? h4[r].x
                             : kk == 1 ? h4[r].y
                             : kk == 2 ? h4[r].z
                                       : h4[r].w;
            acc[r][0] = fmaf(hv, rv.x, acc[r][0]);
            acc[r][1] = fmaf(hv, rv.y, acc[r][1]);
            acc[r][2] = fmaf(hv, rv.z, acc[r][2]);
            acc[r][3] = fmaf(hv, rv.w, acc[r][3]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        *reinterpret_cast<float4*>(&part[(kg * kRows + r) * C + col0]) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
    __syncthreads();

    // (2) the cell, one thread per (row, unit)
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      if (!pok[i]) continue;
      const int pidx = tid + i * kThreads;
      const int r = pidx / J, j = pidx % J;
      float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int g2 = 0; g2 < d.KS; ++g2) {
        const float* pz = part + (g2 * kRows + r) * C + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) z[g] += pz[g * J];
      }
      const float c_prev = creg[i];
      const float ig = sigmoid(zxv[i][0] + z[0] + pi[i] * c_prev);
      const float fg = sigmoid(zxv[i][1] + z[1] + pf[i] * c_prev);
      const float gg = tanhf(zxv[i][2] + z[2]);
      float c_new = fg * c_prev + ig * gg;
      const float og = sigmoid(zxv[i][3] + z[3] + po[i] * c_new);
      float h_new = og * tanhf(c_new);
      float h_out = h_new;
      if (!live[i]) {
        h_out = 0.0f;
        h_new = hreg[i];
        c_new = c_prev;
      }
      hreg[i] = h_new;
      creg[i] = c_new;
      store_as(hs + (static_cast<int64_t>(prow[i]) * d.t + s) * n + punit[i],
               h_out);
#pragma unroll
      for (int peer = 0; peer < kCluster; ++peer)
        cluster.map_shared_rank(hnext, peer)[r * NP + punit[i]] = h_new;
    }
    // (3) h_t is in every block's next buffer; part and hcur are free again
    cluster.sync();
    float* tmp = hcur;
    hcur = hnext;
    hnext = tmp;
  }

#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    if (!pok[i]) continue;
    const int64_t at = static_cast<int64_t>(prow[i]) * n + punit[i];
    store_as(hT + at, hreg[i]);
    store_as(cT + at, creg[i]);
  }
}

Dims make_dims(int64_t b, int64_t t, int64_t n) {
  Dims d;
  d.b = static_cast<int>(b);
  d.t = static_cast<int>(t);
  d.n = static_cast<int>(n);
  d.J = (d.n + kCluster - 1) / kCluster;
  d.C = 4 * d.J;
  d.NP = (d.n + 3) & ~3;
  d.TPG = (d.C + kCols - 1) / kCols;
  d.KS = kThreads / d.TPG;
  d.KC = (((d.NP + d.KS - 1) / d.KS) + 3) & ~3;
  return d;
}

size_t smem_bytes(const Dims& d, bool resident) {
  size_t floats = 2 * static_cast<size_t>(kRows) * d.NP +
                  static_cast<size_t>(d.KS) * kRows * d.C;
  if (resident) floats += static_cast<size_t>(d.NP) * d.C;
  return floats * sizeof(float);
}

template <typename T, bool RESIDENT>
cudaError_t launch_one(const void* zx, const void* R, const void* p,
                       const float* mask, const void* h0, const void* c0,
                       void* hs, void* hT, void* cT, float* hck, float* cck,
                       int tc, const Dims& d, size_t bytes, int device,
                       int optin, cudaStream_t stream) {
  // above 48 KB a block's shared memory must be asked for, once per kernel
  // and device: up to the device's limit, which covers every n
  cudaError_t err = allow_smem<lstm_scan_kernel<T, RESIDENT>>(device, optin);
  if (err != cudaSuccess) return err;
  // the cluster shape is the kernel's own (__cluster_dims__): grid x is
  // exactly one cluster, grid y one cluster per batch tile
  const dim3 grid(kCluster, (d.b + kRows - 1) / kRows);
  lstm_scan_kernel<T, RESIDENT><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(zx), static_cast<const T*>(R),
      static_cast<const T*>(p), mask, static_cast<const T*>(h0),
      static_cast<const T*>(c0), static_cast<T*>(hs), static_cast<T*>(hT),
      static_cast<T*>(cT), hck, cck, tc, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* zx, const void* R, const void* p,
                         const float* mask, const void* h0, const void* c0,
                         void* hs, void* hT, void* cT, float* hck,
                         float* cck, int tc, const Dims& d, int device,
                         cudaStream_t stream) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t resident = smem_bytes(d, true);
  if (resident <= static_cast<size_t>(optin))
    return launch_one<T, true>(zx, R, p, mask, h0, c0, hs, hT, cT, hck,
                               cck, tc, d, resident, device, optin, stream);
  return launch_one<T, false>(zx, R, p, mask, h0, c0, hs, hT, cT, hck, cck,
                              tc, d, smem_bytes(d, false), device, optin,
                              stream);
}

}  // namespace

extern "C" {

// Whether the launch for (n, dtype) keeps its slice of R in shared memory
// (1) or reads it from L2 every step (0); negative on a CUDA error.
int lstm_scan_resident(int64_t n, int device) {
  int optin = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return smem_bytes(make_dims(1, 1, n), true) <= static_cast<size_t>(optin);
}

// Both entry points: zx [b, t, 4n], R [n, 4n], p [3, n] or null, h0/c0
// [b, n] of `dtype` (0 = float32, 1 = bfloat16); mask float32 [b, t] or null;
// hs [b, t, n], hT/cT [b, n] of `dtype`; all dense. device: the CUDA device
// that holds them and owns `stream`. Return the CUDA error code of the
// launch (0 = launched); launch nothing for an empty input.
static int launch_any(const void* zx, const void* R, const void* p,
                      const void* mask, const void* h0, const void* c0,
                      void* hs, void* hT, void* cT, float* hck, float* cck,
                      int64_t b, int64_t t, int64_t n, int64_t tc, int dtype,
                      int device, void* stream) {
  if (b <= 0 || t <= 0) return 0;
  if (n <= 0 || n > kMaxN || t > 0x7fffffff ||
      (b + kRows - 1) / kRows > 65535 || tc <= 0 || tc > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  // this library carries its own CUDA runtime, whose current device is
  // per thread and independent of PyTorch's
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Dims d = make_dims(b, t, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  const int c = static_cast<int>(tc);
  if (dtype == 0)
    return static_cast<int>(launch_typed<float>(
        zx, R, p, m, h0, c0, hs, hT, cT, hck, cck, c, d, device, s));
  if (dtype == 1)
    return static_cast<int>(launch_typed<__nv_bfloat16>(
        zx, R, p, m, h0, c0, hs, hT, cT, hck, cck, c, d, device, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

int lstm_scan_launch(const void* zx, const void* R, const void* p,
                     const void* mask, const void* h0, const void* c0,
                     void* hs, void* hT, void* cT, int64_t b, int64_t t,
                     int64_t n, int dtype, int device, void* stream) {
  return launch_any(zx, R, p, mask, h0, c0, hs, hT, cT, nullptr, nullptr, b,
                    t, n, 1, dtype, device, stream);
}

// As lstm_scan_launch, and also the float32 checkpoints hck, cck
// [ceil(t / tc), b, n] of the carry entering every tc-th step.
int lstm_scan_chunked_launch(const void* zx, const void* R, const void* p,
                             const void* mask, const void* h0,
                             const void* c0, void* hs, void* hT, void* cT,
                             void* hck, void* cck, int64_t b, int64_t t,
                             int64_t n, int64_t tc, int dtype, int device,
                             void* stream) {
  if (hck == nullptr || cck == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_any(zx, R, p, mask, h0, c0, hs, hT, cT,
                    static_cast<float*>(hck), static_cast<float*>(cck), b, t,
                    n, tc, dtype, device, stream);
}

const char* lstm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
