// Fused LSTM backward over all timesteps for Hopper (sm_90a).
//
// Replaces two TPU kernels of deeplearning4j_tpu/ops/pallas_kernels.py:
//   row 6  `_lstm_bwd_kernel` (pallas_call in `_lstm_bwd`), the backward of
//          `lstm_scan` / `lstm_scan_peephole`: reads the forward's hs;
//   row 8  `_lstm_chunk_bwd_kernel` (pallas_call in `_lstm_chunked_bwd`),
//          the backward of the chunked family: reads the float32 carry
//          checkpoints hck, cck [ceil(t / tc), b, n] of lstm_scan.cu's
//          chunked entry point and walks the chunks in reverse.
// Row 6 is row 8 with one chunk of t steps whose h carry comes from hs.
//
// Inputs of type T (float32 or bfloat16), dense row-major: zx [b, t, 4n]
// (gate order i, f, g, o), R [n, 4n], p [3, n] (pi, pf, po) or null, h0, c0
// [b, n] and hs [b, t, n] (row 6) or hck, cck float32 (row 8), the
// cotangents g_hs [b, t, n], g_hT, g_cT [b, n]; mask float32 [b, t] or null
// (a step is live iff > 0). Outputs: dzx [b, t, 4n] in T; dR [n, 4n], dp
// [3, n], dh0, dc0 [b, n] in float32.
//
// What it computes, as the TPU kernels do, in float32 (sigmoid(x) = 1 / (1
// + expf(-x)), no fast-math; products as below):
//   phase 1, per chunk from its entry carry (h0, c0 or the checkpoint):
//     z_s = zx_s + h_{s-1} R, the gates, c_s; the h carry is hs_s (row 6,
//     no mask: the TPU kernel reads hs, rounded to T) or recomputed in
//     float32 (with a mask, where hs is 0 at masked steps, and in row 8);
//     a masked step carries h and c through.
//   phase 2, s from the chunk's end down to its start:
//     dh = g_hs_s + dh_next, dc_in = dc_next (both 0 at a masked step)
//     dzo = dh tanh(c_s) o (1 - o)
//     dc  = dh o (1 - tanh^2 c_s) + dc_in + po dzo
//     dzg = dc i (1 - g^2), dzi = dc g i (1 - i), dzf = dc c_{s-1} f (1 - f)
//     dh_next = dz R^T (+ dh_next at a masked step)
//     dc_next = dc f + pi dzi + pf dzf (+ dc_next at a masked step)
//   and, over every step, dR = sum h_{s-1}^T dz_s, dp = (sum dzi c_{s-1},
//   sum dzf c_{s-1}, sum dzo c_s); rows past b never enter them.
//
// Bound on an H100 SXM at the trained TextGenerationLSTM shape (b=64, t=64,
// n=256, float32): the z recompute, the dh product and dR are 3 x 2 b t n 4n
// = 6.44 GFLOP; as 3xTF32 on the tensor cores that is 19.3 GFLOP over 495
// TFLOP/s, 0.039 ms per launch, against about 40 MB moved (0.012 ms). The
// bound does not count the chain of t dependent steps, which sets the time
// at small b.
//
// Design. Every product runs on the tensor cores (`mma.sync` m16n8k8 TF32,
// hopper_mma.cuh): float32 operands as 3xTF32 with both parts rounded to
// nearest, the three products of a k8 step in a fresh tile added to the
// float32 sum (one tensor-core accumulator along K truncates past what the
// training checks hold); an operand that is bfloat16 at its source is exact
// in TF32 and enters once (one product when both are, two when one is).
// The work is split into kernels so that only what is serial stays on the
// chain, all ordered on the caller's stream and two side streams by events:
//   prep        R as float32, once per call;
//   recompute   phase 1 of one chunk, serial (row 8; row 6 with a mask): a
//               cluster of 8 blocks per 8 batch rows, block q owning hidden
//               units [q J, (q+1) J), J = ceil(n / 8), and the C = 4 J
//               columns of R that feed them, resident in shared memory as
//               float32 (128 KB at n = 256, so TF32 hi and lo parts of it
//               would not both fit: each warp splits its fragments per step,
//               which costs integer instructions beside the products). Per
//               step: z^T = R_q^T h^T on the tensor cores (the 8 batch rows
//               are N = 8), the cell, h_s split into its TF32 parts by the
//               pair that forms it and sent to the 8 blocks through
//               distributed shared memory, one cluster barrier (z, c and
//               the h carry go to the workspace between its halves);
//   z product, c scan   phase 1 of row 6 without a mask: the h carry is
//               hs, so z = zx + H R is one product over b t rows and c is
//               an elementwise forward scan, both off the chain;
//   reverse     phase 2 of one chunk, serial: the same cluster split; per
//               step each block forms dz of its (row, unit) pairs, then its
//               partial dh^T = R_q dz^T over all n units on the tensor
//               cores, sends each unit's partial to the block that owns it
//               (distributed shared memory, double-buffered), one cluster
//               barrier (arrive; the step's stores and the next step's
//               loads; wait), and each owner adds the 8 partials in block
//               order;
//   dR          dR += H^T DZ over the chunk's (row, step) pairs: a tiled
//               product over the whole card, its K split into ranges that
//               a second pass adds in order, chunks added in order;
//   dp          the per-(row, unit) dp sums added over the rows in order.
// With more than one chunk (row 8), the caller's stream reverses chunk j
// while one side stream first adds chunk j + 1's dR and the other then
// recomputes chunk j - 1 into the slot that dR frees: a step costs the
// slower chain, not the sum. The workspace holds two chunk slots (z / dz,
// c, h carry), so it does not grow with t; `lstm_scan_bwd_workspace_floats`
// gives its size. One chunk (row 6, and row 8 with t <= tc) has nothing to
// overlap, so every kernel then runs on the caller's stream, with no event.
// The reverse chain sets the time of both rows, and its product most of
// each step (profile_resnet_torch.py --model lstm-bwd-split, which builds
// this source with the probes below; PERF.md). No atomics: every sum has
// a fixed order, so results repeat bit for bit. n is capped at kMaxN =
// 1024: past n = 256 or so the R slice does not fit in shared memory and
// the serial kernels read it from L2 every step, several times slower.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "hopper_mma.cuh"

namespace cg = cooperative_groups;

// Built with -DLSTM_BWD_PROBES (profile_resnet_torch.py --model
// lstm-bwd-split), thread 0 of the first cluster's block 0 reads clock64 at
// each phase boundary of the serial kernels' steps, PROBE(i) closing phase
// i, and PROBE_END adds the cycles to g_probe[first + i], the loop's
// %globaltimer ns to g_probe[first + 6] and its steps to g_probe[first + 7]
// (recompute first = 0, reverse 16). Otherwise the probes are empty.
#ifdef LSTM_BWD_PROBES
__device__ unsigned long long g_probe[32];
#define PROBE_START                                                    \
  const bool probe0 = blockIdx.y == 0 && cluster.block_rank() == 0 && \
                      threadIdx.x == 0;                               \
  unsigned long long pacc[8] = {0}, ns0;                              \
  long long ta = clock64();                                           \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns0));
#define PROBE(i)                    \
  if (probe0) {                     \
    const long long tb = clock64(); \
    pacc[i] += tb - ta;             \
    ta = tb;                        \
  }
#define PROBE_END(first, count, steps)                                 \
  if (probe0) {                                                        \
    unsigned long long ns1;                                            \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns1));            \
    for (int i = 0; i < (count); ++i) g_probe[(first) + i] += pacc[i]; \
    g_probe[(first) + 6] += ns1 - ns0;                                 \
    g_probe[(first) + 7] += (steps);                                   \
  }
#else
#define PROBE_START
#define PROBE(i)
#define PROBE_END(first, count, steps)
#endif

namespace {

constexpr int kCluster = 8;    // blocks per cluster: the column split
constexpr int kRows = 8;       // batch rows per cluster: the products' N
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
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
__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

// the cluster barrier in two halves: work between them overlaps the wait
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One k8 step of a product into a fresh tile t, small terms first: A is
// split into its TF32 parts here when SA (float32), else exact in TF32
// (bfloat16 at its source); B comes as its parts, bh and, when BLO, bl.
template <bool SA, bool BLO>
__device__ __forceinline__ void k8_parts(float t[4], const uint32_t a[4],
                                         uint32_t bh0, uint32_t bh1,
                                         uint32_t bl0, uint32_t bl1) {
  t[0] = t[1] = t[2] = t[3] = 0.0f;
  if constexpr (SA) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) split_tf32(a[j], ah[j], al[j]);
    mma_tf32(t, al, bh0, bh1);
    if constexpr (BLO) mma_tf32(t, ah, bl0, bl1);
    mma_tf32(t, ah, bh0, bh1);
  } else {
    if constexpr (BLO) mma_tf32(t, a, bl0, bl1);
    mma_tf32(t, a, bh0, bh1);
  }
}

// As k8_parts with B's fragment b0, b1 as it is: split here when SB.
template <bool SA, bool SB>
__device__ __forceinline__ void k8_step(float t[4], const uint32_t a[4],
                                        uint32_t b0, uint32_t b1) {
  if constexpr (SB) {
    uint32_t bh0, bl0, bh1, bl1;
    split_tf32(b0, bh0, bl0);
    split_tf32(b1, bh1, bl1);
    k8_parts<SA, true>(t, a, bh0, bh1, bl0, bl1);
  } else {
    k8_parts<SA, false>(t, a, b0, b1, 0u, 0u);
  }
}

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

struct Dims {
  int b, t, n;
  int tw;     // steps a chunk slot holds (min(tc, t))
  int J;      // hidden units per block
  int C;      // 4 * J columns per block
  // recompute: z^T [C, 8] = R_q^T [C, n] h^T [n, 8]
  int CPm;    // C rounded up to 16 (M)
  int NPk;    // n rounded up to 8 (K)
  int S1;     // row stride of its R slice [NPk][S1], = 8 mod 16
  int HP;     // row stride of h [8][n][hi, lo]: 2 n rounded to 32, + 8
  int ZP;     // row stride of the z tile [8][ZP], = 4 mod 8
  // reverse: dh^T [n, 8] = R_q [n, C] dz^T [C, 8]
  int NPm;    // n rounded up to 16 (M)
  int CPk;    // C rounded up to 8 (K)
  int S2;     // row stride of its R slice [NPm][S2], = 4 mod 8
  int DP;     // row stride of dz [8][DP], = 4 mod 8
  int tiles;  // clusters: batch tiles of kRows rows
};

Dims make_dims(int64_t b, int64_t t, int64_t n, int64_t tw) {
  Dims d;
  d.b = static_cast<int>(b);
  d.t = static_cast<int>(t);
  d.n = static_cast<int>(n);
  d.tw = static_cast<int>(tw);
  d.J = (d.n + kCluster - 1) / kCluster;
  d.C = 4 * d.J;
  d.CPm = round_up(d.C, 16);
  d.NPk = round_up(d.n, 8);
  d.S1 = d.CPm + 8;
  d.HP = 2 * round_up(d.n, 16) + 8;
  d.ZP = d.CPm + 4;
  d.NPm = round_up(d.n, 16);
  d.CPk = round_up(d.C, 8);
  d.S2 = d.CPk + 4;
  d.DP = d.CPk + 4;
  d.tiles = static_cast<int>((b + kRows - 1) / kRows);
  return d;
}

size_t recompute_smem(const Dims& d, bool resident) {
  // h's parts (two buffers), the z tile, the R slice
  size_t floats = 2 * static_cast<size_t>(kRows) * d.HP +
                  static_cast<size_t>(kRows) * d.ZP;
  if (resident) floats += static_cast<size_t>(d.NPk) * d.S1;
  return floats * sizeof(float);
}

size_t reverse_smem(const Dims& d, bool resident) {
  size_t floats = 2 * static_cast<size_t>(kRows) * d.DP +
                  2 * static_cast<size_t>(kCluster) * kRows * d.J;
  if (resident) floats += static_cast<size_t>(d.NPm) * d.S2;
  return floats * sizeof(float);
}

// One chunk: steps [s0, s0 + L), its slot's regions of the workspace
// (float offsets: z then dz [b][tw][4n], c [b][tw][n], the h carry
// entering each step [b][tw][n]); last: the chunk the reverse walk starts
// with (the cotangents g_hT, g_cT enter it; dp and dR are written, not
// added to).
struct Chunk {
  int j, s0, L, last;
  int64_t z, c, h;
};

// Column c of block q's slice, as a column of R [n, 4n]; -1 past the edge.
__device__ __forceinline__ int64_t slice_col(int c, int C, int J, int u0,
                                             int n) {
  if (c >= C || u0 + c % J >= n) return -1;
  return static_cast<int64_t>(c / J) * n + u0 + c % J;
}

// This thread's (row, unit) pairs of the cluster's tile.
struct Pairs {
  int prow[kPairs], punit[kPairs], pr[kPairs], pj[kPairs];
  bool pok[kPairs];
  float pi[kPairs], pf[kPairs], po[kPairs];
};

template <typename T>
__device__ __forceinline__ void make_pairs(Pairs& P, const T* p, int b0,
                                           int u0, const Dims& d) {
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int pidx = threadIdx.x + i * kThreads;
    P.pr[i] = pidx / d.J;
    P.pj[i] = pidx % d.J;
    P.prow[i] = b0 + P.pr[i];
    P.punit[i] = u0 + P.pj[i];
    P.pok[i] = pidx < kRows * d.J && P.pr[i] < kRows && P.prow[i] < d.b &&
               P.punit[i] < d.n;
    P.pi[i] = P.pf[i] = P.po[i] = 0.0f;
    if (P.pok[i] && p != nullptr) {
      P.pi[i] = to_float(p[P.punit[i]]);
      P.pf[i] = to_float(p[d.n + P.punit[i]]);
      P.po[i] = to_float(p[2 * d.n + P.punit[i]]);
    }
  }
}

// rows x cols of a block's slice of Rq (row stride ld) into shared memory
// (row stride S): 16-byte cp.async copies, all in flight at once (cols, ld
// and S are multiples of 4). The caller's next barrier publishes them.
__device__ __forceinline__ void copy_slice(float* Rs, int S, const float* Rg,
                                           int ld, int rows, int cols) {
  const int vecs = cols / 4;
  for (int v = threadIdx.x; v < rows * vecs; v += kThreads) {
    const int r = v / vecs, c = (v % vecs) * 4;
    cp_async16(Rs + r * S + c, Rg + r * ld + c, 16);
  }
  cp_async_commit();
  cp_async_wait<0>();
}

// ------------------------------------------------------------------ prep
// R as float32 twice: Rf [n][4n] for the z product, and Rq [kCluster][NPm]
// [CPm], block q's slice [unit][column] zero-padded, which the serial
// kernels copy to shared memory or, past its size, read from L2 with no
// index arithmetic but a multiply-add
template <typename T>
__global__ void __launch_bounds__(256)
    lstm_bwd_prep(const T* __restrict__ R, float* __restrict__ Rf,
                  float* __restrict__ Rq, Dims d) {
  const int64_t n4 = 4 * static_cast<int64_t>(d.n);
  const int64_t nf = d.n * n4, nq = int64_t{kCluster} * d.NPm * d.CPm;
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       e < nf + nq; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    if (e < nf) {
      Rf[e] = to_float(R[e]);
      continue;
    }
    const int64_t i = e - nf;
    const int c = static_cast<int>(i % d.CPm);
    const int64_t qk = i / d.CPm;
    const int k = static_cast<int>(qk % d.NPm);
    const int q = static_cast<int>(qk / d.NPm);
    const int64_t col = slice_col(c, d.C, d.J, q * d.J, d.n);
    Rq[i] = k < d.n && col >= 0 ? to_float(R[k * n4 + col]) : 0.0f;
  }
}

// the h carry of row 6 without a mask: h0 at step 0, else hs_{s-1}
template <typename T>
__global__ void __launch_bounds__(256)
    lstm_bwd_carry(const T* __restrict__ h0, const T* __restrict__ hs,
                   float* __restrict__ ws, Dims d, Chunk ch) {
  const int64_t count = static_cast<int64_t>(d.b) * ch.L * d.n;
  float* hw = ws + ch.h;
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       e < count; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t k = e % d.n, rs = e / d.n;
    const int64_t r = rs / ch.L, ls = rs % ch.L, s = ch.s0 + ls;
    const float v = s == 0 ? to_float(h0[r * d.n + k])
                           : to_float(hs[(r * d.t + s - 1) * d.n + k]);
    hw[(r * d.tw + ls) * d.n + k] = v;
  }
}

// c of row 6 without a mask, from the chunk's z (zx + H R): one thread per
// (row, unit), forward over the steps
template <typename T>
__global__ void __launch_bounds__(128)
    lstm_bwd_cscan(const T* __restrict__ c0, const T* __restrict__ p,
                   float* __restrict__ ws, Dims d, Chunk ch) {
  const int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (e >= static_cast<int64_t>(d.b) * d.n) return;
  const int n = d.n;
  const int64_t r = e / n, u = e % n, n4 = 4 * static_cast<int64_t>(n);
  const float pi = p != nullptr ? to_float(p[u]) : 0.0f;
  const float pf = p != nullptr ? to_float(p[n + u]) : 0.0f;
  const float* zr = ws + ch.z + r * d.tw * n4 + u;
  float* cr = ws + ch.c + r * d.tw * n + u;
  float c = to_float(c0[r * n + u]);
  // the loads of kBatch steps go out before their stores (which the
  // compiler may not move them past: both point into ws)
  constexpr int kBatch = 8;
  for (int l0 = 0; l0 < ch.L; l0 += kBatch) {
    float zi[kBatch], zf[kBatch], zg[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const float* z = zr + (l0 + k) * n4;
      const bool in = l0 + k < ch.L;
      zi[k] = in ? z[0] : 0.0f;
      zf[k] = in ? z[n] : 0.0f;
      zg[k] = in ? z[2 * n] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (l0 + k >= ch.L) break;
      const float ig = sigmoid(zi[k] + pi * c);
      const float fg = sigmoid(zf[k] + pf * c);
      c = fg * c + ig * tanhf(zg[k]);
      cr[(l0 + k) * static_cast<int64_t>(n)] = c;
    }
  }
}

// dp [3, n]: the per-(row, unit) sums [3][b][n] added over rows in order
__global__ void __launch_bounds__(256)
    lstm_bwd_dp(const float* __restrict__ dpw, float* __restrict__ dp,
                int b, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 3 * n) return;
  const int g = e / n, u = e % n;
  float v = 0.0f;
  for (int r = 0; r < b; ++r)
    v += dpw[(static_cast<int64_t>(g) * b + r) * n + u];
  dp[e] = v;
}

// ------------------------------------------------------- the two products
// C [M, N] = (accumulate ? C : 0) + (add ? add : 0) + A B on the tensor
// cores, tiles of 64 x 64 per block of 4 warps (32 x 32 each), K in steps
// of 16 through a cp.async ring. B is [K][N] (N contiguous). A is [M][K]
// (the z product: H [b t, n] R) or, A_KM, [K][M] (dR: H^T DZ, K the
// chunk's (row, step) pairs, whose rows sit at (k / L) tw + k % L). With
// gridDim.z > 1 (dR, whose 64 x 64 tiles are too few to fill the card)
// block z takes the z-th range of K and writes its sum to part [z][M][ldc];
// lstm_bwd_splits adds the ranges in order.
constexpr int kGM = 64, kGN = 64, kGK = 16, kGThreads = 128, kGDepth = 4;
constexpr int kAKP = kGM + 8;  // A_KM tile [kGK][kAKP]: = 8 mod 32
constexpr int kAMP = kGK + 4;  // A tile [kGM][kAMP]: = 4 mod 8
constexpr int kBP = kGN + 8;   // B tile [kGK][kBP]: = 8 mod 32
constexpr int kAFloats =
    kGK * kAKP > kGM * kAMP ? kGK * kAKP : kGM * kAMP;
constexpr int kStageFloats = kAFloats + kGK * kBP;

struct Gemm {
  const float* A;
  const float* B;
  float* C;
  const void* add;  // T [M][ldc], or null
  int M, N, K, lda, ldb, ldc;
  int L, tw;        // A_KM: the row of pair k is (k / L) tw + k % L
  int accumulate;
  float* part;      // gridDim.z > 1: the ranges' sums [gridDim.z][M][ldc]
};

template <typename T, bool A_KM, bool SA, bool SB>
__global__ void __launch_bounds__(kGThreads) lstm_bwd_gemm(Gemm g) {
  __shared__ __align__(16) uint8_t smem[kGDepth * kStageFloats * 4];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  const int nk_all = (g.K + kGK - 1) / kGK;
  const int per = (nk_all + gridDim.z - 1) / gridDim.z;
  const int kt0 = blockIdx.z * per;
  const int nk = max(0, min(nk_all, kt0 + per) - kt0);
  const bool vecA = g.lda % 4 == 0;  // A's rows load as 16-byte copies
  auto krow = [&](int k) -> int64_t {
    return A_KM ? static_cast<int64_t>(k / g.L) * g.tw + k % g.L : k;
  };
  auto load = [&](int c, uint8_t* st) {
    float* As = reinterpret_cast<float*>(st);
    float* Bs = As + kAFloats;
    const int k0 = (kt0 + c) * kGK;
    for (int v = tid; v < kGK * kGN / 4; v += kGThreads) {
      const int kk = v / (kGN / 4), col = (v % (kGN / 4)) * 4;
      const bool in = k0 + kk < g.K && n0 + col < g.N;
      const float* src =
          in ? g.B + krow(k0 + kk) * g.ldb + n0 + col : g.B;
      cp_async16(Bs + kk * kBP + col, src, in ? 16 : 0);
    }
    if constexpr (A_KM) {
      for (int v = tid; v < kGK * kGM / 4; v += kGThreads) {
        const int kk = v / (kGM / 4), mm = (v % (kGM / 4)) * 4;
        const int k = k0 + kk, m = m0 + mm;
        float* dst = As + kk * kAKP + mm;
        const float* src = g.A + (k < g.K ? krow(k) * g.lda + m : 0);
        if (vecA) {
          const bool in = k < g.K && m < g.M;
          cp_async16(dst, in ? src : g.A, in ? 16 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool in = k < g.K && m + e < g.M;
            cp_async4(dst + e, in ? src + e : g.A, in ? 4 : 0);
          }
        }
      }
    } else {
      for (int v = tid; v < kGM * kGK / 4; v += kGThreads) {
        const int mm = v / (kGK / 4), kk = (v % (kGK / 4)) * 4;
        const int m = m0 + mm, k = k0 + kk;
        float* dst = As + mm * kAMP + kk;
        const float* src =
            g.A + (m < g.M ? static_cast<int64_t>(m) * g.lda + k : 0);
        if (vecA) {
          const bool in = m < g.M && k < g.K;
          cp_async16(dst, in ? src : g.A, in ? 16 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool in = m < g.M && k + e < g.K;
            cp_async4(dst + e, in ? src + e : g.A, in ? 4 : 0);
          }
        }
      }
    }
  };
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  auto consume = [&](int, uint8_t* st) {
    const float* As = reinterpret_cast<const float*>(st);
    const float* Bs = As + kAFloats;
    auto a_at = [&](int m, int k) {
      return bits(A_KM ? As[k * kAKP + m] : As[m * kAMP + k]);
    };
#pragma unroll
    for (int kk = 0; kk < kGK; kk += 8) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int mb = wm * 32 + i * 16 + g8;
        a[i][0] = a_at(mb, kk + t4);
        a[i][1] = a_at(mb + 8, kk + t4);
        a[i][2] = a_at(mb, kk + t4 + 4);
        a[i][3] = a_at(mb + 8, kk + t4 + 4);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nb = wn * 32 + j * 8 + g8;
        b[j][0] = bits(Bs[(kk + t4) * kBP + nb]);
        b[j][1] = bits(Bs[(kk + t4 + 4) * kBP + nb]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t[4];
          k8_step<SA, SB>(t, a[i], b[j][0], b[j][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += t[e];
        }
    }
  };
  ring<kStageFloats * 4, kGDepth>(smem, nk, load, [](int) {}, consume);
  const T* add = static_cast<const T*>(g.add);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 32 + i * 16 + g8 + (e >> 1) * 8;
        const int col = n0 + wn * 32 + j * 8 + 2 * t4 + (e & 1);
        if (m >= g.M || col >= g.N) continue;
        const int64_t at = static_cast<int64_t>(m) * g.ldc + col;
        float v = acc[i][j][e];
        if (gridDim.z > 1) {
          g.part[blockIdx.z * static_cast<int64_t>(g.M) * g.ldc + at] = v;
          continue;
        }
        if (add != nullptr) v += to_float(add[at]);
        if (g.accumulate) v += g.C[at];
        g.C[at] = v;
      }
}

// C = (accumulate ? C : 0) + the sum of the K ranges' parts, in order
__global__ void __launch_bounds__(256)
    lstm_bwd_splits(const float* __restrict__ part, float* __restrict__ C,
                    int64_t count, int splits, int accumulate) {
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       e < count; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float v = part[e];
    for (int z = 1; z < splits; ++z) v += part[z * count + e];
    C[e] = accumulate ? C[e] + v : v;
  }
}

// ------------------------------------------------- phase 1, serial form
template <typename T, bool RESIDENT>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    lstm_bwd_recompute(const T* __restrict__ zx, const float* __restrict__ Rq,
                       const T* __restrict__ p, const float* __restrict__ mask,
                       const T* __restrict__ h0, const T* __restrict__ c0,
                       const float* __restrict__ hck,
                       const float* __restrict__ cck, float* ws, Dims d,
                       Chunk ch) {
  constexpr bool kSplitR = sizeof(T) == 4;
  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int n = d.n, J = d.J, HP = d.HP, ZP = d.ZP, S1 = d.S1;
  const int u0 = q * J;
  const int b0 = blockIdx.y * kRows;
  const int64_t n4 = 4 * static_cast<int64_t>(n);
  float* zw = ws + ch.z;
  float* cw = ws + ch.c;
  float* hw = ws + ch.h;

  extern __shared__ __align__(16) float smem[];
  // h's TF32 parts [2 buffers][kRows][HP]: unit k's hi, lo at 2 k, 2 k + 1
  // (one 8-byte load of the product's B, one remote store); the pair that
  // forms h_s splits it and writes it into every block's next buffer
  float* hbuf = smem;
  float* zs = hbuf + 2 * kRows * HP;    // [kRows][ZP] this step's h R
  float* Rs = zs + kRows * ZP;          // [NPk][S1] R slice, [k][column]
  const float* Rg = Rq + static_cast<int64_t>(q) * d.NPm * d.CPm;

  const int zero = 2 * kRows * HP + kRows * ZP;
  for (int e = tid; e < zero; e += kThreads) smem[e] = 0.0f;
  if (RESIDENT) copy_slice(Rs, S1, Rg, d.CPm, d.NPk, d.CPm);
  Pairs P;
  make_pairs(P, p, b0, u0, d);
  // the chunk's entry carry: every block holds all of h, each pair its own
  const int64_t ck = static_cast<int64_t>(ch.j) * d.b * n;
  __syncthreads();
  for (int e = tid; e < kRows * n; e += kThreads) {
    const int r = e / n, k = e % n;
    if (b0 + r >= d.b) continue;
    const int64_t at = static_cast<int64_t>(b0 + r) * n + k;
    uint32_t hi, lo;
    split_tf32(bits(hck != nullptr ? hck[ck + at] : to_float(h0[at])), hi,
               lo);
    *reinterpret_cast<float2*>(hbuf + r * HP + 2 * k) =
        make_float2(__uint_as_float(hi), __uint_as_float(lo));
  }
  float hreg[kPairs], creg[kPairs];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    hreg[i] = creg[i] = 0.0f;
    if (!P.pok[i]) continue;
    const int64_t at = static_cast<int64_t>(P.prow[i]) * n + P.punit[i];
    hreg[i] = hck != nullptr ? hck[ck + at] : to_float(h0[at]);
    creg[i] = cck != nullptr ? cck[ck + at] : to_float(c0[at]);
  }
  // every block's buffers are ready before any peer writes into them
  cluster.sync();

  auto r_at = [&](int k, int c) -> uint32_t {
    return bits(RESIDENT ? Rs[k * S1 + c] : __ldg(Rg + k * d.CPm + c));
  };
  float zxv[kPairs][4];
  bool live[kPairs];
  auto load_step = [&](int s) {
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      live[i] = true;
#pragma unroll
      for (int g = 0; g < 4; ++g) zxv[i][g] = 0.0f;
      if (!P.pok[i]) continue;
      const int64_t row = (static_cast<int64_t>(P.prow[i]) * d.t + s) * n4;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        zxv[i][g] = to_float(zx[row + g * n + P.punit[i]]);
      if (mask != nullptr)
        live[i] = mask[static_cast<int64_t>(P.prow[i]) * d.t + s] > 0.0f;
    }
  };
  load_step(ch.s0);
  PROBE_START

  float* hcur = hbuf;
  float* hnext = hbuf + kRows * HP;
  const int mtiles = d.CPm / 16, ksteps = d.NPk / 8;
  for (int ls = 0; ls < ch.L; ++ls) {
    // zs[r][c] = sum_k h[r][k] R[k][c]: z^T = R_q^T h^T, M = columns
    for (int mt = warp; mt < mtiles; mt += kWarps) {
      const int m0 = mt * 16;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int ks = 0; ks < ksteps; ++ks) {
        const int k0 = ks * 8;
        uint32_t a[4];
        a[0] = r_at(k0 + t4, m0 + g8);
        a[1] = r_at(k0 + t4, m0 + g8 + 8);
        a[2] = r_at(k0 + t4 + 4, m0 + g8);
        a[3] = r_at(k0 + t4 + 4, m0 + g8 + 8);
        const float2 b0 = *reinterpret_cast<const float2*>(
            hcur + g8 * HP + 2 * (k0 + t4));
        const float2 b1 = *reinterpret_cast<const float2*>(
            hcur + g8 * HP + 2 * (k0 + t4 + 4));
        float t[4];
        k8_parts<kSplitR, true>(t, a, bits(b0.x), bits(b1.x), bits(b0.y),
                                bits(b1.y));
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += t[e];
      }
      zs[(2 * t4) * ZP + m0 + g8] = acc[0];
      zs[(2 * t4 + 1) * ZP + m0 + g8] = acc[1];
      zs[(2 * t4) * ZP + m0 + g8 + 8] = acc[2];
      zs[(2 * t4 + 1) * ZP + m0 + g8 + 8] = acc[3];
    }
    PROBE(0)  // the product
    __syncthreads();
    PROBE(1)  // its barrier

    // the cell, one thread per (row, unit); z, c and the h carry entering
    // the step go to the workspace after the barrier's arrive
    float z[kPairs][4], h_in[kPairs];
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      h_in[i] = hreg[i];
      if (!P.pok[i]) continue;
      const int r = P.pr[i], jj = P.pj[i];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        z[i][g] = zs[r * ZP + g * J + jj] + zxv[i][g];
      const float c_prev = creg[i];
      const float ig = sigmoid(z[i][0] + P.pi[i] * c_prev);
      const float fg = sigmoid(z[i][1] + P.pf[i] * c_prev);
      const float gg = tanhf(z[i][2]);
      float c_new = fg * c_prev + ig * gg;
      const float og = sigmoid(z[i][3] + P.po[i] * c_new);
      float h_new = og * tanhf(c_new);
      if (!live[i]) {
        h_new = hreg[i];
        c_new = c_prev;
      }
      hreg[i] = h_new;
      creg[i] = c_new;
      uint32_t hi, lo;
      split_tf32(bits(h_new), hi, lo);
      const float2 parts =
          make_float2(__uint_as_float(hi), __uint_as_float(lo));
#pragma unroll
      for (int peer = 0; peer < kCluster; ++peer)
        *reinterpret_cast<float2*>(cluster.map_shared_rank(hnext, peer) +
                                   r * HP + 2 * P.punit[i]) = parts;
    }
    PROBE(2)  // the cell and the DSMEM broadcast
    // h_s is in every block's next buffer once all have arrived. The
    // workspace stores and the next step's loads overlap the wait (stores
    // issued before the arrive would hold up its release)
    cluster_arrive();
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      if (!P.pok[i]) continue;
      const int64_t rs = static_cast<int64_t>(P.prow[i]) * d.tw + ls;
      float* zrow = zw + rs * n4 + P.punit[i];
#pragma unroll
      for (int g = 0; g < 4; ++g) zrow[g * n] = z[i][g];
      cw[rs * n + P.punit[i]] = creg[i];
      hw[rs * n + P.punit[i]] = h_in[i];
    }
    if (ls + 1 < ch.L) load_step(ch.s0 + ls + 1);
    PROBE(3)  // the arrive, the stores and the next step's loads
    cluster_wait();
    PROBE(4)  // the cluster wait
    float* tmp = hcur;
    hcur = hnext;
    hnext = tmp;
  }
  PROBE_END(0, 5, ch.L)
}

// ------------------------------------------------------ phase 2, serial
template <typename T, bool RESIDENT>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    lstm_bwd_reverse(const float* __restrict__ Rq, const T* __restrict__ p,
                     const float* __restrict__ mask, const T* __restrict__ c0,
                     const float* __restrict__ cck, const T* __restrict__ ghs,
                     const T* __restrict__ ghT, const T* __restrict__ gcT,
                     T* __restrict__ dzx, float* __restrict__ dh0,
                     float* __restrict__ dc0, float* ws,
                     float* __restrict__ dpw, Dims d, Chunk ch) {
  constexpr bool kSplitR = sizeof(T) == 4;
  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int n = d.n, J = d.J, DP = d.DP, S2 = d.S2;
  const int u0 = q * J;
  const int b0 = blockIdx.y * kRows;
  const int64_t n4 = 4 * static_cast<int64_t>(n);
  float* zw = ws + ch.z;
  const float* cw = ws + ch.c;

  extern __shared__ __align__(16) float smem[];
  float* dzh = smem;                    // [kRows][DP] TF32 parts of dz
  float* dzl = dzh + kRows * DP;
  float* recv = dzl + kRows * DP;       // [2][kCluster][kRows][J]
  float* Rs = recv + 2 * kCluster * kRows * J;  // [NPm][S2], [unit][col]
  const float* Rg = Rq + static_cast<int64_t>(q) * d.NPm * d.CPm;

  for (int e = tid; e < 2 * kRows * DP; e += kThreads) smem[e] = 0.0f;
  if (RESIDENT) copy_slice(Rs, S2, Rg, d.CPm, d.NPm, d.CPk);
  Pairs P;
  make_pairs(P, p, b0, u0, d);
  float dh[kPairs], dc[kPairs], c_entry[kPairs];
  float dpi[kPairs], dpf[kPairs], dpo[kPairs];
  const int64_t ck = static_cast<int64_t>(ch.j) * d.b * n;
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    dh[i] = dc[i] = c_entry[i] = dpi[i] = dpf[i] = dpo[i] = 0.0f;
    if (!P.pok[i]) continue;
    const int64_t at = static_cast<int64_t>(P.prow[i]) * n + P.punit[i];
    dh[i] = ch.last ? to_float(ghT[at]) : dh0[at];
    dc[i] = ch.last ? to_float(gcT[at]) : dc0[at];
    c_entry[i] = cck != nullptr ? cck[ck + at] : to_float(c0[at]);
  }
  // every block's buffers are ready before any peer writes into them
  cluster.sync();

  auto r_at = [&](int u, int c) -> uint32_t {
    return bits(RESIDENT ? Rs[u * S2 + c] : __ldg(Rg + u * d.CPm + c));
  };
  // the values of the step about to run, loaded one step ahead
  float zv[kPairs][4], cn[kPairs], cp[kPairs], gh[kPairs];
  bool lv[kPairs];
  auto load_step = [&](int ls) {
    const int s = ch.s0 + ls;
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      lv[i] = true;
      cn[i] = cp[i] = gh[i] = 0.0f;
#pragma unroll
      for (int g = 0; g < 4; ++g) zv[i][g] = 0.0f;
      if (!P.pok[i]) continue;
      const int64_t rs = static_cast<int64_t>(P.prow[i]) * d.tw + ls;
      const float* zrow = zw + rs * n4 + P.punit[i];
#pragma unroll
      for (int g = 0; g < 4; ++g) zv[i][g] = zrow[g * n];
      cn[i] = cw[rs * n + P.punit[i]];
      cp[i] = ls > 0 ? cw[(rs - 1) * n + P.punit[i]] : c_entry[i];
      const int64_t at = static_cast<int64_t>(P.prow[i]) * d.t + s;
      gh[i] = to_float(ghs[at * n + P.punit[i]]);
      if (mask != nullptr) lv[i] = mask[at] > 0.0f;
    }
  };
  load_step(ch.L - 1);
  PROBE_START

  const int mtiles = d.NPm / 16, ksteps = d.CPk / 8;
  int rbuf = 0;
  for (int ls = ch.L - 1; ls >= 0; --ls) {
    const int s = ch.s0 + ls;
    float dh_pass[kPairs], dc_prev[kPairs], dz[kPairs][4];
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      dh_pass[i] = dc_prev[i] = 0.0f;
      if (!P.pok[i]) continue;
      const int r = P.pr[i], jj = P.pj[i];
      const float c_new = cn[i], c_prev = cp[i];
      const float dh_in = lv[i] ? gh[i] + dh[i] : 0.0f;
      const float dc_in = lv[i] ? dc[i] : 0.0f;
      const float ig = sigmoid(zv[i][0] + P.pi[i] * c_prev);
      const float fg = sigmoid(zv[i][1] + P.pf[i] * c_prev);
      const float gg = tanhf(zv[i][2]);
      const float og = sigmoid(zv[i][3] + P.po[i] * c_new);
      const float tcn = tanhf(c_new);
      const float dzo = dh_in * tcn * og * (1.0f - og);
      const float dcc = dh_in * og * (1.0f - tcn * tcn) + dc_in +
                        P.po[i] * dzo;
      const float dzg = dcc * ig * (1.0f - gg * gg);
      const float dzi = dcc * gg * ig * (1.0f - ig);
      const float dzf = dcc * c_prev * fg * (1.0f - fg);
      dz[i][0] = dzi;
      dz[i][1] = dzf;
      dz[i][2] = dzg;
      dz[i][3] = dzo;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        uint32_t hi, lo;
        split_tf32(bits(dz[i][g]), hi, lo);
        dzh[r * DP + g * J + jj] = __uint_as_float(hi);
        dzl[r * DP + g * J + jj] = __uint_as_float(lo);
      }
      dpi[i] += dzi * c_prev;
      dpf[i] += dzf * c_prev;
      dpo[i] += dzo * c_new;
      dc_prev[i] = dcc * fg + P.pi[i] * dzi + P.pf[i] * dzf +
                   (lv[i] ? 0.0f : dc[i]);
      dh_pass[i] = lv[i] ? 0.0f : dh[i];
    }
    PROBE(0)  // the cell (dz)
    __syncthreads();
    PROBE(1)  // its barrier

    // dh^T [units, rows] = R_q dz^T over this block's columns; each unit's
    // partial goes to the block that owns the unit
    float* rb = recv + rbuf * kCluster * kRows * J;
    for (int mt = warp; mt < mtiles; mt += kWarps) {
      const int m0 = mt * 16;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int ks = 0; ks < ksteps; ++ks) {
        const int k0 = ks * 8;
        uint32_t a[4];
        a[0] = r_at(m0 + g8, k0 + t4);
        a[1] = r_at(m0 + g8 + 8, k0 + t4);
        a[2] = r_at(m0 + g8, k0 + t4 + 4);
        a[3] = r_at(m0 + g8 + 8, k0 + t4 + 4);
        const int db = g8 * DP + k0 + t4;
        float t[4];
        k8_parts<kSplitR, true>(t, a, bits(dzh[db]), bits(dzh[db + 4]),
                                bits(dzl[db]), bits(dzl[db + 4]));
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += t[e];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = m0 + g8 + (e >> 1) * 8, r = 2 * t4 + (e & 1);
        if (u < n)
          cluster.map_shared_rank(rb, u / J)[(q * kRows + r) * J + u % J] =
              acc[e];
      }
    }
    PROBE(2)  // the product and the DSMEM partials
    // dzx and the workspace's dz after the arrive: stores issued before it
    // would hold up its release
    cluster_arrive();
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      if (!P.pok[i]) continue;
      const int64_t rs = static_cast<int64_t>(P.prow[i]) * d.tw + ls;
      T* out = dzx + (static_cast<int64_t>(P.prow[i]) * d.t + s) * n4 +
               P.punit[i];
      float* zrow = zw + rs * n4 + P.punit[i];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        store_as(out + g * n, dz[i][g]);
        zrow[g * n] = dz[i][g];
      }
    }
    if (ls > 0) load_step(ls - 1);
    PROBE(3)  // the arrive, the stores and the next step's loads
    cluster_wait();
    PROBE(4)  // the cluster wait
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      if (!P.pok[i]) continue;
      float v = 0.0f;
#pragma unroll
      for (int peer = 0; peer < kCluster; ++peer)
        v += rb[(peer * kRows + P.pr[i]) * J + P.pj[i]];
      dh[i] = v + dh_pass[i];
      dc[i] = dc_prev[i];
    }
    rbuf ^= 1;
    PROBE(5)  // the gather
  }
  PROBE_END(16, 6, ch.L)

  // the carries' cotangents entering the chunk, and its dp sums
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    if (!P.pok[i]) continue;
    const int64_t at = static_cast<int64_t>(P.prow[i]) * n + P.punit[i];
    dh0[at] = dh[i];
    dc0[at] = dc[i];
    const int64_t bn = static_cast<int64_t>(d.b) * n;
    float* slot = dpw + at;
    slot[0] = ch.last ? dpi[i] : slot[0] + dpi[i];
    slot[bn] = ch.last ? dpf[i] : slot[bn] + dpf[i];
    slot[2 * bn] = ch.last ? dpo[i] : slot[2 * bn] + dpo[i];
  }
}

// ------------------------------------------------------------------ host
struct Args {
  const void *zx, *R, *p, *h0, *c0, *hs, *ghs, *ghT, *gcT;
  const float *mask, *hck, *cck;
  void* dzx;
  float *dR, *dp, *dh0, *dc0, *ws;
};

// Workspace regions, float offsets, each on 128 bytes: R as float32
// [n][4n], and as the blocks' slices [kCluster][NPm][CPm]; dp sums
// [3][b][n]; kSlots chunk slots of z / dz [b][tw][4n], c and the h carry
// [b][tw][n] (one chunk uses slot 0 only); dR's K ranges [splits][n][4n];
// the total. Chunk j lives in slot j % kSlots.
constexpr int kSlots = 2;
enum Region {
  kRf, kRq, kDpw, kZ0, kC0, kH0, kZ1, kC1, kH1, kPart, kTotal, kRegions
};

struct Layout {
  int64_t at[kRegions];
  int splits;  // the K ranges of a chunk's dR product
};

// tw: steps per chunk (tc clamped to t). A chunk's dR has too few 64 x 64
// tiles to fill the card, so its K = b tw (row, step) pairs splits into
// ranges, enough for about 512 blocks, each at least 128 pairs, at most 8.
Layout make_layout(int64_t b, int64_t t, int64_t n, int64_t tw) {
  Layout L;
  const int64_t tiles = ((n + 63) / 64) * ((4 * n + 63) / 64);
  int64_t splits = (512 + tiles - 1) / tiles;
  if (splits > 8) splits = 8;
  if (splits > b * tw / 128) splits = b * tw / 128;
  L.splits = static_cast<int>(splits > 1 ? splits : 1);
  const Dims d = make_dims(b, t, n, tw);
  const int64_t slot = b * tw * n;
  const int64_t sizes[kTotal] = {
      4 * n * n, int64_t{kCluster} * d.NPm * d.CPm, 3 * b * n,
      4 * slot,  slot, slot, 4 * slot, slot, slot,
      L.splits > 1 ? L.splits * 4 * n * n : 0};
  const bool one = tw >= t;
  int64_t at = 0;
  for (int i = 0; i < kTotal; ++i) {
    if (one && i >= kZ1 && i <= kH1) {
      L.at[i] = L.at[i - 3];
      continue;
    }
    L.at[i] = at;
    at += (sizes[i] + 31) / 32 * 32;
  }
  L.at[kTotal] = at;
  return L;
}

// The side streams and events of one device, made once.
struct Streams {
  cudaStream_t side[2];  // recompute, dR
  cudaEvent_t start, p2_done, p1_done[kSlots], slot_free[kSlots];
  bool made;
};

std::mutex g_streams_lock;
Streams g_streams[64];

cudaError_t streams_for(int device, Streams** out) {
  if (device < 0 || device >= 64) return cudaErrorInvalidValue;
  Streams& s = g_streams[device];
  if (!s.made) {
    cudaError_t err = cudaSuccess;
    for (int i = 0; i < 2 && err == cudaSuccess; ++i)
      err = cudaStreamCreateWithFlags(&s.side[i], cudaStreamNonBlocking);
    cudaEvent_t* evs[2 + 2 * kSlots] = {&s.start, &s.p2_done};
    for (int i = 0; i < kSlots; ++i) {
      evs[2 + i] = &s.p1_done[i];
      evs[2 + kSlots + i] = &s.slot_free[i];
    }
    for (cudaEvent_t* e : evs)
      if (err == cudaSuccess)
        err = cudaEventCreateWithFlags(e, cudaEventDisableTiming);
    if (err != cudaSuccess) return err;
    s.made = true;
  }
  *out = &s;
  return cudaSuccess;
}

int blocks_for(int64_t count, int threads) {
  const int64_t b = (count + threads - 1) / threads;
  return static_cast<int>(b < 4096 ? (b > 0 ? b : 1) : 4096);
}

template <typename T>
struct Launcher {
  const Args& a;
  const Dims& d;
  const int64_t* lay;
  int nt, tc, splits;
  bool res1, res2;
  cudaStream_t main;

  Chunk chunk(int j) const {
    const int slot = 3 * (j % kSlots);
    Chunk ch;
    ch.j = j;
    ch.s0 = j * tc;
    ch.L = (ch.s0 + tc < d.t ? ch.s0 + tc : d.t) - ch.s0;
    ch.last = j == nt - 1;
    ch.z = lay[kZ0 + slot];
    ch.c = lay[kC0 + slot];
    ch.h = lay[kH0 + slot];
    return ch;
  }

  template <bool SA, bool SB, bool A_KM>
  cudaError_t gemm(const Gemm& g, int z, cudaStream_t s) const {
    const dim3 grid((g.N + kGN - 1) / kGN, (g.M + kGM - 1) / kGM, z);
    lstm_bwd_gemm<T, A_KM, SA, SB><<<grid, kGThreads, 0, s>>>(g);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || z == 1) return err;
    const int64_t count = static_cast<int64_t>(g.M) * g.ldc;
    lstm_bwd_splits<<<blocks_for(count, 256), 256, 0, s>>>(
        g.part, g.C, count, z, g.accumulate);
    return cudaGetLastError();
  }

  // phase 1 of chunk j into its slot, on stream s
  cudaError_t recompute(int j, bool products, cudaStream_t s) const {
    const Chunk ch = chunk(j);
    const T* h0 = static_cast<const T*>(a.h0);
    const T* c0 = static_cast<const T*>(a.c0);
    if (products) {
      // row 6 without a mask: the h carry is hs, z one product, c a scan
      const int64_t hn = static_cast<int64_t>(d.b) * ch.L * d.n;
      lstm_bwd_carry<T><<<blocks_for(hn, 256), 256, 0, s>>>(
          h0, static_cast<const T*>(a.hs), a.ws, d, ch);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      Gemm g;
      g.A = a.ws + ch.h;
      g.B = a.ws + lay[kRf];
      g.C = a.ws + ch.z;
      g.add = a.zx;
      g.M = d.b * d.t;
      g.N = 4 * d.n;
      g.K = d.n;
      g.lda = d.n;
      g.ldb = g.ldc = 4 * d.n;
      g.L = g.tw = 1;
      g.accumulate = 0;
      g.part = nullptr;
      constexpr bool kF32 = sizeof(T) == 4;
      err = gemm<kF32, kF32, false>(g, 1, s);
      if (err != cudaSuccess) return err;
      const int64_t bn = static_cast<int64_t>(d.b) * d.n;
      lstm_bwd_cscan<T><<<blocks_for(bn, 128), 128, 0, s>>>(
          c0, static_cast<const T*>(a.p), a.ws, d, ch);
      return cudaGetLastError();
    }
    const dim3 grid(kCluster, d.tiles);
    const size_t bytes = recompute_smem(d, res1);
    auto kernel = res1 ? lstm_bwd_recompute<T, true>
                       : lstm_bwd_recompute<T, false>;
    kernel<<<grid, kThreads, bytes, s>>>(
        static_cast<const T*>(a.zx), a.ws + lay[kRq],
        static_cast<const T*>(a.p), a.mask, h0, c0, a.hck, a.cck, a.ws, d,
        ch);
    return cudaGetLastError();
  }

  // phase 2 of chunk j, on the caller's stream
  cudaError_t reverse(int j) const {
    const Chunk ch = chunk(j);
    const dim3 grid(kCluster, d.tiles);
    const size_t bytes = reverse_smem(d, res2);
    auto kernel = res2 ? lstm_bwd_reverse<T, true>
                       : lstm_bwd_reverse<T, false>;
    kernel<<<grid, kThreads, bytes, main>>>(
        a.ws + lay[kRq], static_cast<const T*>(a.p), a.mask,
        static_cast<const T*>(a.c0), a.cck, static_cast<const T*>(a.ghs),
        static_cast<const T*>(a.ghT), static_cast<const T*>(a.gcT),
        static_cast<T*>(a.dzx), a.dh0, a.dc0, a.ws, a.ws + lay[kDpw], d, ch);
    return cudaGetLastError();
  }

  // dR (+)= H^T DZ over chunk j's pairs, on stream s; H is exact in TF32
  // where it is bfloat16 hs (row 6 without a mask)
  cudaError_t dR(int j, bool h_exact, cudaStream_t s) const {
    const Chunk ch = chunk(j);
    Gemm g;
    g.A = a.ws + ch.h;
    g.B = a.ws + ch.z;
    g.C = a.dR;
    g.add = nullptr;
    g.M = d.n;
    g.N = 4 * d.n;
    g.K = d.b * ch.L;
    g.lda = d.n;
    g.ldb = g.ldc = 4 * d.n;
    g.L = ch.L;
    g.tw = d.tw;
    g.accumulate = !ch.last;
    g.part = a.ws + lay[kPart];
    return h_exact ? gemm<false, true, true>(g, splits, s)
                   : gemm<true, true, true>(g, splits, s);
  }
};

int smem_optin(int device, int* optin) {
  return static_cast<int>(cudaDeviceGetAttribute(
      optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

template <typename T>
cudaError_t allow_all(int device, int optin, bool res1, bool res2) {
  cudaError_t err = res1 ? allow_smem<lstm_bwd_recompute<T, true>>(device,
                                                                   optin)
                         : allow_smem<lstm_bwd_recompute<T, false>>(device,
                                                                    optin);
  if (err != cudaSuccess) return err;
  return res2 ? allow_smem<lstm_bwd_reverse<T, true>>(device, optin)
              : allow_smem<lstm_bwd_reverse<T, false>>(device, optin);
}

template <typename T>
cudaError_t run(const Args& a, const Dims& d, const Layout& lay, int nt,
                int tc, bool products, int device, cudaStream_t main) {
  int optin = 0;
  cudaError_t err = static_cast<cudaError_t>(smem_optin(device, &optin));
  if (err != cudaSuccess) return err;
  const bool res1 = recompute_smem(d, true) <= static_cast<size_t>(optin);
  const bool res2 = reverse_smem(d, true) <= static_cast<size_t>(optin);
  err = allow_all<T>(device, optin, res1, res2);
  if (err != cudaSuccess) return err;
  Launcher<T> L{a, d, lay.at, nt, tc, lay.splits, res1, res2, main};
  const bool h_exact = products && sizeof(T) == 2;

  const int64_t nr = 4 * static_cast<int64_t>(d.n) * d.n +
                     int64_t{kCluster} * d.NPm * d.CPm;
  lstm_bwd_prep<T><<<blocks_for(nr, 256), 256, 0, main>>>(
      static_cast<const T*>(a.R), a.ws + lay.at[kRf], a.ws + lay.at[kRq], d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (nt == 1) {
    if ((err = L.recompute(0, products, main)) || (err = L.reverse(0)) ||
        (err = L.dR(0, h_exact, main)))
      return err;
  } else {
    // Reversing chunk j waits for its recompute, and its dR for the
    // reverse; recomputing chunk j - 1 waits for the dR of chunk j + 1,
    // which held its slot; the caller's stream waits for the last dR.
    std::lock_guard<std::mutex> guard(g_streams_lock);
    Streams* st = nullptr;
    if ((err = streams_for(device, &st))) return err;
    cudaStream_t rec = st->side[0], red = st->side[1];
    // the side streams start after the caller's earlier work and the prep
    if ((err = cudaEventRecord(st->start, main)) ||
        (err = cudaStreamWaitEvent(rec, st->start, 0)) ||
        (err = cudaStreamWaitEvent(red, st->start, 0)) ||
        (err = L.recompute(nt - 1, products, rec)) ||
        (err = cudaEventRecord(st->p1_done[(nt - 1) % kSlots], rec)))
      return err;
    for (int j = nt - 1; j >= 0; --j) {
      const int slot = j % kSlots, prev = (j + kSlots - 1) % kSlots;
      if ((err = cudaStreamWaitEvent(main, st->p1_done[slot], 0)) ||
          (err = L.reverse(j)) ||
          (err = cudaEventRecord(st->p2_done, main)) ||
          (err = cudaStreamWaitEvent(red, st->p2_done, 0)) ||
          (err = L.dR(j, h_exact, red)) ||
          (err = cudaEventRecord(st->slot_free[slot], red)))
        return err;
      if (j == 0) break;
      if ((j + 1 < nt &&
           (err = cudaStreamWaitEvent(rec, st->slot_free[prev], 0))) ||
          (err = L.recompute(j - 1, products, rec)) ||
          (err = cudaEventRecord(st->p1_done[prev], rec)))
        return err;
    }
    if ((err = cudaStreamWaitEvent(main, st->slot_free[0], 0))) return err;
  }
  lstm_bwd_dp<<<(3 * d.n + 255) / 256, 256, 0, main>>>(a.ws + lay.at[kDpw],
                                                       a.dp, d.b, d.n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Whether both serial kernels keep their slice of R in shared memory at
// hidden width n (1) or read it from L2 every step (0); negative on a CUDA
// error.
int lstm_scan_bwd_resident(int64_t n, int device) {
  int optin = 0;
  const int err = smem_optin(device, &optin);
  if (err != 0) return -err;
  if (n <= 0 || n > kMaxN) return 0;
  const Dims d = make_dims(1, 1, n, 1);
  return recompute_smem(d, true) <= static_cast<size_t>(optin) &&
         reverse_smem(d, true) <= static_cast<size_t>(optin);
}

// The floats of the workspace a launch at (b, t, n, tc) takes: two chunk
// slots of tc steps whatever t is (one when tc >= t); 0 for sizes the
// launch refuses.
int64_t lstm_scan_bwd_workspace_floats(int64_t b, int64_t t, int64_t n,
                                       int64_t tc) {
  if (b <= 0 || t <= 0 || n <= 0 || n > kMaxN || tc <= 0) return 0;
  return make_layout(b, t, n, tc < t ? tc : t).at[kTotal];
}

// Row 6 (h0, c0, hs given; hck, cck null; tc = t) or row 8 (hck, cck
// given; tc the checkpoint interval): zx [b, t, 4n], R [n, 4n], p [3, n]
// or null, h0, c0 [b, n], hs, g_hs [b, t, n], g_hT, g_cT [b, n] and dzx
// [b, t, 4n] of `dtype` (0 = float32, 1 = bfloat16); mask float32 [b, t]
// or null; hck, cck float32 [ceil(t / tc), b, n]; dR [n, 4n], dp [3, n],
// dh0, dc0 [b, n] and the workspace ws float32
// [lstm_scan_bwd_workspace_floats(b, t, n, tc)]; all dense. Row 6 without
// a mask forms phase 1 as one product and a scan. device: the CUDA device
// that holds them and owns `stream`. Returns the CUDA error code of the
// launches (0 = launched).
int lstm_scan_bwd_launch(const void* zx, const void* R, const void* p,
                         const void* mask, const void* h0, const void* c0,
                         const void* hs, const void* hck, const void* cck,
                         const void* g_hs, const void* g_hT,
                         const void* g_cT, void* dzx, void* dR, void* dp,
                         void* dh0, void* dc0, void* ws, int64_t b,
                         int64_t t, int64_t n, int64_t tc, int dtype,
                         int device, void* stream) {
  if (b <= 0 || t <= 0) return 0;
  const bool chunked = hck != nullptr;
  if (n <= 0 || n > kMaxN || t > 0x7fffffff || tc <= 0 || tc > t ||
      b * t > 0x7fffffff || (b + kRows - 1) / kRows > 65535 ||
      (chunked && cck == nullptr) ||
      (!chunked && (h0 == nullptr || c0 == nullptr || hs == nullptr ||
                    tc != t)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool products = !chunked && mask == nullptr;
  const int nt = static_cast<int>((t + tc - 1) / tc);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Dims d = make_dims(b, t, n, tc);
  const Layout lay = make_layout(b, t, n, tc);
  Args a;
  a.zx = zx;
  a.R = R;
  a.p = p;
  a.h0 = h0;
  a.c0 = c0;
  a.hs = hs;
  a.ghs = g_hs;
  a.ghT = g_hT;
  a.gcT = g_cT;
  a.mask = static_cast<const float*>(mask);
  a.hck = static_cast<const float*>(hck);
  a.cck = static_cast<const float*>(cck);
  a.dzx = dzx;
  a.dR = static_cast<float*>(dR);
  a.dp = static_cast<float*>(dp);
  a.dh0 = static_cast<float*>(dh0);
  a.dc0 = static_cast<float*>(dc0);
  a.ws = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = static_cast<int>(tc);
  if (dtype == 0)
    return static_cast<int>(
        run<float>(a, d, lay, nt, c, products, device, s));
  if (dtype == 1)
    return static_cast<int>(
        run<__nv_bfloat16>(a, d, lay, nt, c, products, device, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* lstm_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef LSTM_BWD_PROBES
int lstm_scan_bwd_probe_reset() {
  const unsigned long long zero[32] = {0};
  return static_cast<int>(cudaMemcpyToSymbol(g_probe, zero, sizeof(zero)));
}
int lstm_scan_bwd_probe_read(unsigned long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_probe, 32 * sizeof(unsigned long long)));
}
#endif

}  // extern "C"
