// Fused LSTM backward over all timesteps, in one launch, for Hopper (sm_90a).
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
// What it computes, as the TPU kernels do, in float32 with no TF32 and no
// fast-math (sigmoid(x) = 1 / (1 + expf(-x))):
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
// = 6.44 GFLOP against about 40 MB moved, so operations bind: 0.096 ms per
// launch. As in the forward, the bound does not count the two serial chains
// of t dependent steps (phase 1 and phase 2), which set the time at small b.
//
// Design (the forward's cluster split; simple and right first). A cluster of
// kCluster = 8 blocks owns a tile of kRows = 8 batch rows; block q owns the
// hidden units U_q = [q J, (q+1) J), J = ceil(n / 8), and the C = 4 J
// columns of R that feed their gates, resident in shared memory (row stride
// C + 4, so that phase 2's column reads are free of bank conflicts) when
// they fit, else read from L2. Phase 1 is the forward's step (split-k 8 x 4
// register tile, h exchanged through distributed shared memory, one cluster
// barrier per step); it stores z and c of its (row, unit) pairs and the h
// carry entering each step in a float32 workspace, so phase 2 needs no
// second product for z. Phase 2, per step: each block forms dz for its 8
// rows x C columns, writes dzx, forms its partial dh_prev = dz[:, C_q]
// R[:, C_q]^T over all n units (8 rows x 4 units per thread, split over the
// columns), and reduce-scatters it over the cluster through distributed
// shared memory: every block receives the 8 partials of its own units and
// adds them in block order (double-buffered, one cluster barrier per step).
// After each chunk every block adds h_carry^T dz over the chunk's rows and
// steps to its columns of a per-tile dR partial, a small product whose
// operands are staged through shared memory in slabs of 40 (row, step)
// pairs, 4 x 8 sums per thread (no atomics: each element has one owner); dp is summed per (row, unit) in registers and over the
// tile's rows in order at the end. A second kernel adds the tiles' partials
// in tile order. Every sum has a fixed order, so results repeat bit for bit.
// n is capped at kMaxN = 1024.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;    // blocks per cluster: the column split
constexpr int kRows = 8;       // batch rows per cluster
constexpr int kThreads = 256;
constexpr int kMaxN = 1024;
constexpr int kPairs = 4;      // max (row, unit) pairs per thread
constexpr int kCols = 4;       // columns per thread in phase 1's product
// the dR sum: units and columns per pass (32 x 8 threads, 4 x 8 sums each)
// and (row, step) pairs per slab staged in shared memory
constexpr int kDRK = 128;
constexpr int kDRC = 64;
constexpr int kSlab = 40;
constexpr int kBatch = 10;     // slab loads in flight per thread
static_assert(kThreads == (kDRK / 4) * (kDRC / 8), "one 4 x 8 tile each");
static_assert(kSlab * kDRK % (kThreads * kBatch) == 0 &&
                  kSlab * kDRC % (kThreads * kBatch) == 0,
              "slabs load in whole batches");
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

struct Dims {
  int b, t, n;
  int J;      // hidden units per block
  int C;      // 4 * J columns per block
  int NP;     // n rounded up to 4: h row stride, resident R rows
  int S;      // row stride of the resident R slice, C + 4
  int TPG;    // phase 1: threads per k-group, ceil(C / kCols)
  int KS;     // phase 1: k-groups
  int KC;     // phase 1: k per group, a multiple of 4
  int KG;     // phase 2: unit groups (each thread takes 4 strided units)
  int KP;     // phase 2: 4 * KG, the padded partial row
  int CS;     // phase 2: column splits
  int CC;     // phase 2: columns per split, a multiple of 4
  int CSa;    // phase 2: column splits that hold any column
  int part;   // floats of the shared partial-sum buffer
  int tc;     // steps per chunk (t for row 6)
  int tw;     // steps the workspace holds, min(tc, t)
  int nt;     // chunks
  int tiles;  // clusters: batch tiles of kRows rows
  int64_t off_c, off_h, off_r, off_p, total;  // workspace layout, floats
};

__host__ __device__ inline int64_t round4(int64_t x) { return (x + 3) & ~3LL; }

Dims make_dims(int64_t b, int64_t t, int64_t n, int64_t tc) {
  Dims d;
  d.b = static_cast<int>(b);
  d.t = static_cast<int>(t);
  d.n = static_cast<int>(n);
  d.J = (d.n + kCluster - 1) / kCluster;
  d.C = 4 * d.J;
  d.NP = (d.n + 3) & ~3;
  d.S = d.C + 4;
  d.TPG = (d.C + kCols - 1) / kCols;
  d.KS = kThreads / d.TPG;
  d.KC = (((d.NP + d.KS - 1) / d.KS) + 3) & ~3;
  d.KG = (d.NP + 3) / 4;
  d.KP = 4 * d.KG;
  d.CS = kThreads / d.KG;
  d.CC = (((d.C + d.CS - 1) / d.CS) + 3) & ~3;
  d.CSa = (d.C + d.CC - 1) / d.CC;
  int part = d.KS * kRows * d.C;
  if (d.CS * kRows * d.KP > part) part = d.CS * kRows * d.KP;
  if (3 * kRows * d.J > part) part = 3 * kRows * d.J;
  if (kSlab * (kDRK + kDRC) > part) part = kSlab * (kDRK + kDRC);
  d.part = part;
  d.tc = static_cast<int>(tc < t ? tc : t);
  d.tw = d.tc;
  d.nt = static_cast<int>((t + d.tc - 1) / d.tc);
  d.tiles = static_cast<int>((b + kRows - 1) / kRows);
  const int64_t tiles = d.tiles, tw = d.tw;
  // z, then dz: [tile][q][r][tw][C]; c: [tile][q][r][tw][J];
  // h carry entering each step: [tile][r][tw][NP]; dR partial [tile][n][4n];
  // dp partial [tile][3][n]
  d.off_c = round4(tiles * kCluster * kRows * tw * d.C);
  d.off_h = d.off_c + round4(tiles * kCluster * kRows * tw * d.J);
  d.off_r = d.off_h + round4(tiles * kRows * tw * d.NP);
  d.off_p = d.off_r + round4(tiles * n * 4 * n);
  d.total = d.off_p + round4(tiles * 3 * n);
  return d;
}

// dynamic shared memory of a launch
size_t smem_bytes(const Dims& d, bool resident) {
  size_t floats = 2 * static_cast<size_t>(kRows) * d.NP + d.part +
                  static_cast<size_t>(kRows) * d.C +
                  2 * static_cast<size_t>(kCluster) * kRows * d.J;
  if (resident) floats += static_cast<size_t>(d.NP) * d.S;
  return floats * sizeof(float);
}

template <typename T, bool RESIDENT>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    lstm_bwd_kernel(const T* __restrict__ zx, const T* __restrict__ R,
                    const T* __restrict__ p, const float* __restrict__ mask,
                    const T* __restrict__ h0, const T* __restrict__ c0,
                    const T* __restrict__ hs, const float* __restrict__ hck,
                    const float* __restrict__ cck,
                    const T* __restrict__ ghs, const T* __restrict__ ghT,
                    const T* __restrict__ gcT, T* __restrict__ dzx,
                    float* __restrict__ dh0, float* __restrict__ dc0,
                    float* ws, Dims d) {
  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int n = d.n, J = d.J, C = d.C, NP = d.NP, S = d.S, tw = d.tw;
  const int u0 = q * J;                    // first hidden unit of this block
  const int tile = blockIdx.y;
  const int b0 = tile * kRows;             // first batch row of the cluster
  const int64_t n4 = 4 * static_cast<int64_t>(n);
  const bool chunked = hck != nullptr;

  // this block's workspace: z then dz [r][tw][C] and c [r][tw][J] (private),
  // the cluster's h carries [r][tw][NP] (written by all 8 blocks), the
  // tile's dR partial [n][4n] and dp partial [3][n]
  float* zw = ws + (static_cast<int64_t>(tile) * kCluster + q) * kRows * tw * C;
  float* cw = ws + d.off_c +
              (static_cast<int64_t>(tile) * kCluster + q) * kRows * tw * J;
  float* hw = ws + d.off_h + static_cast<int64_t>(tile) * kRows * tw * NP;
  float* dRp = ws + d.off_r + static_cast<int64_t>(tile) * n * n4;
  float* dpp = ws + d.off_p + static_cast<int64_t>(tile) * 3 * n;

  extern __shared__ __align__(16) float smem[];
  float* hbuf0 = smem;                     // [kRows, NP] h_{s-1}
  float* hbuf1 = hbuf0 + kRows * NP;       // [kRows, NP] h_s
  float* part = hbuf1 + kRows * NP;        // partial sums, both products
  float* dzs = part + d.part;              // [kRows, C] this step's dz
  float* recv = dzs + kRows * C;           // [2][kCluster][kRows][J]
  float* Rs = recv + 2 * kCluster * kRows * J;  // [NP][S] resident R slice

  // ---- set-up: zeroed h buffers, dz and receive buffers, the R slice
  for (int e = tid; e < 2 * kRows * NP; e += kThreads) smem[e] = 0.0f;
  for (int e = tid; e < kRows * C + 2 * kCluster * kRows * J; e += kThreads)
    dzs[e] = 0.0f;
  if (RESIDENT) {
    constexpr int kCopy = 16;
    for (int e0 = tid; e0 < NP * C; e0 += kCopy * kThreads) {
      float v[kCopy];
#pragma unroll
      for (int i = 0; i < kCopy; ++i) {
        const int e = e0 + i * kThreads;
        const int k = e / C, c = e % C;
        const int g = c / J, u = u0 + c % J;
        v[i] = e < NP * C && k < n && u < n ? to_float(R[k * n4 + g * n + u])
                                            : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kCopy; ++i) {
        const int e = e0 + i * kThreads;
        if (e < NP * C) Rs[(e / C) * S + e % C] = v[i];
      }
    }
  }

  // ---- phase 1's product tile: k-group kg, columns col0 .. col0 + 3
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
  // ---- phase 2's product tile: units kg2 + i KG (i < 4), column split cs2
  const int kg2 = tid % d.KG;
  const int cs2 = tid / d.KG;
  const bool ok2 = cs2 < d.CSa;
  const int c_lo2 = cs2 * d.CC;
  const int c_hi2 = min(C, c_lo2 + d.CC);

  // ---- this thread's (row, unit) pairs
  float pi[kPairs], pf[kPairs], po[kPairs];
  float hreg[kPairs], creg[kPairs], c_entry[kPairs];
  float dh[kPairs], dc[kPairs], dpi[kPairs], dpf[kPairs], dpo[kPairs];
  int prow[kPairs], punit[kPairs], pr[kPairs], pj[kPairs];
  bool pok[kPairs];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int pidx = tid + i * kThreads;
    pr[i] = pidx / J;
    pj[i] = pidx % J;
    prow[i] = b0 + pr[i];
    punit[i] = u0 + pj[i];
    pok[i] = pidx < kRows * J && pr[i] < kRows && prow[i] < d.b &&
             punit[i] < n;
    pi[i] = pf[i] = po[i] = 0.0f;
    hreg[i] = creg[i] = c_entry[i] = 0.0f;
    dh[i] = dc[i] = dpi[i] = dpf[i] = dpo[i] = 0.0f;
    if (pok[i]) {
      const int64_t at = static_cast<int64_t>(prow[i]) * n + punit[i];
      dh[i] = to_float(ghT[at]);
      dc[i] = to_float(gcT[at]);
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
  int rbuf = 0;
  const int rows_valid = min(kRows, d.b - b0);
  for (int j = d.nt - 1; j >= 0; --j) {
    const int s0 = j * d.tc;
    const int s1 = min(d.t, s0 + d.tc);

    // ================= phase 1: the chunk's z, c and h carries ============
    for (int e = tid; e < kRows * n; e += kThreads) {
      const int r = e / n, k = e % n;
      float v = 0.0f;
      if (b0 + r < d.b) {
        const int64_t at = static_cast<int64_t>(b0 + r) * n + k;
        v = chunked ? hck[static_cast<int64_t>(j) * d.b * n + at]
                    : to_float(h0[at]);
      }
      hcur[r * NP + k] = v;
    }
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      if (!pok[i]) continue;
      const int64_t at = static_cast<int64_t>(prow[i]) * n + punit[i];
      hreg[i] = chunked ? hck[static_cast<int64_t>(j) * d.b * n + at]
                        : to_float(h0[at]);
      creg[i] = chunked ? cck[static_cast<int64_t>(j) * d.b * n + at]
                        : to_float(c0[at]);
      c_entry[i] = creg[i];
    }
    __syncthreads();

    for (int s = s0; s < s1; ++s) {
      const int ls = s - s0;
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
          // the h carry entering step s, for dR
          hw[(static_cast<int64_t>(pr[i]) * tw + ls) * NP + punit[i]] =
              hreg[i];
        }
      }

      // part[kg][r][c] = sum over this group's k of h[r][k] * R[k][c]
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
              rv = *reinterpret_cast<const float4*>(&Rs[(k + kk) * S + col0]);
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

      // the cell, one thread per (row, unit); z and c go to the workspace
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        if (!pok[i]) continue;
        const int r = pr[i], jj = pj[i];
        float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int g2 = 0; g2 < d.KS; ++g2) {
          const float* pz = part + (g2 * kRows + r) * C + jj;
#pragma unroll
          for (int g = 0; g < 4; ++g) z[g] += pz[g * J];
        }
#pragma unroll
        for (int g = 0; g < 4; ++g) z[g] += zxv[i][g];
        const float c_prev = creg[i];
        const float ig = sigmoid(z[0] + pi[i] * c_prev);
        const float fg = sigmoid(z[1] + pf[i] * c_prev);
        const float gg = tanhf(z[2]);
        float c_new = fg * c_prev + ig * gg;
        const float og = sigmoid(z[3] + po[i] * c_new);
        float h_new = og * tanhf(c_new);
        if (mask != nullptr) {
          if (!live[i]) {
            h_new = hreg[i];
            c_new = c_prev;
          }
        } else if (!chunked) {
          h_new = to_float(
              hs[(static_cast<int64_t>(prow[i]) * d.t + s) * n + punit[i]]);
        }
        float* zrow = zw + (static_cast<int64_t>(r) * tw + ls) * C;
#pragma unroll
        for (int g = 0; g < 4; ++g) zrow[g * J + jj] = z[g];
        cw[(static_cast<int64_t>(r) * tw + ls) * J + jj] = c_new;
        hreg[i] = h_new;
        creg[i] = c_new;
#pragma unroll
        for (int peer = 0; peer < kCluster; ++peer)
          cluster.map_shared_rank(hnext, peer)[r * NP + punit[i]] = h_new;
      }
      // h_s is in every block's next buffer; part and hcur are free again
      cluster.sync();
      float* tmp = hcur;
      hcur = hnext;
      hnext = tmp;
    }

    // ================= phase 2: the reverse recurrence ====================
    for (int s = s1 - 1; s >= s0; --s) {
      const int ls = s - s0;
      float dh_pass[kPairs], dc_prev[kPairs];
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        dh_pass[i] = dc_prev[i] = 0.0f;
        if (!pok[i]) continue;
        const int r = pr[i], jj = pj[i];
        const int64_t rs = static_cast<int64_t>(prow[i]) * d.t + s;
        const bool lv = mask == nullptr || mask[rs] > 0.0f;
        float* zrow = zw + (static_cast<int64_t>(r) * tw + ls) * C;
        const float* crow = cw + static_cast<int64_t>(r) * tw * J + jj;
        const float c_new = crow[ls * J];
        const float c_prev = ls > 0 ? crow[(ls - 1) * J] : c_entry[i];
        float z[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) z[g] = zrow[g * J + jj];
        const float gh = to_float(ghs[rs * n + punit[i]]);
        const float dh_in = lv ? gh + dh[i] : 0.0f;
        const float dc_in = lv ? dc[i] : 0.0f;
        const float ig = sigmoid(z[0] + pi[i] * c_prev);
        const float fg = sigmoid(z[1] + pf[i] * c_prev);
        const float gg = tanhf(z[2]);
        const float og = sigmoid(z[3] + po[i] * c_new);
        const float tcn = tanhf(c_new);
        const float dzo = dh_in * tcn * og * (1.0f - og);
        const float dcc = dh_in * og * (1.0f - tcn * tcn) + dc_in +
                          po[i] * dzo;
        const float dzg = dcc * ig * (1.0f - gg * gg);
        const float dzi = dcc * gg * ig * (1.0f - ig);
        const float dzf = dcc * c_prev * fg * (1.0f - fg);
        const float dz[4] = {dzi, dzf, dzg, dzo};
        T* out = dzx + rs * n4 + punit[i];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          store_as(out + g * n, dz[g]);
          zrow[g * J + jj] = dz[g];
          dzs[r * C + g * J + jj] = dz[g];
        }
        dpi[i] += dzi * c_prev;
        dpf[i] += dzf * c_prev;
        dpo[i] += dzo * c_new;
        dc_prev[i] = dcc * fg + pi[i] * dzi + pf[i] * dzf +
                     (lv ? 0.0f : dc[i]);
        dh_pass[i] = lv ? 0.0f : dh[i];
      }
      __syncthreads();

      // part[cs][r][k] = sum over this split's columns c of dz[r][c] R[k][c]
      if (ok2) {
        float acc[kRows][4];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[r][i] = 0.0f;
        for (int c = c_lo2; c < c_hi2; c += 4) {
          float4 d4[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            d4[r] = *reinterpret_cast<const float4*>(&dzs[r * C + c]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int k = kg2 + i * d.KG;
            float4 rv;
            if (RESIDENT) {
              rv = k < NP ? *reinterpret_cast<const float4*>(&Rs[k * S + c])
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            } else {
              float v[4];
#pragma unroll
              for (int cc = 0; cc < 4; ++cc) {
                const int col = c + cc, u = u0 + col % J;
                v[cc] = k < n && u < n
                            ? to_float(R[k * n4 + (col / J) * n + u])
                            : 0.0f;
              }
              rv = make_float4(v[0], v[1], v[2], v[3]);
            }
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              acc[r][i] = fmaf(d4[r].x, rv.x, acc[r][i]);
              acc[r][i] = fmaf(d4[r].y, rv.y, acc[r][i]);
              acc[r][i] = fmaf(d4[r].z, rv.z, acc[r][i]);
              acc[r][i] = fmaf(d4[r].w, rv.w, acc[r][i]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            part[(cs2 * kRows + r) * d.KP + kg2 + i * d.KG] = acc[r][i];
      }
      __syncthreads();

      // reduce-scatter: unit k's sum of the splits goes to its owner block
      float* rb = recv + rbuf * kCluster * kRows * J;
      for (int k = tid; k < n; k += kThreads) {
        float* dst =
            cluster.map_shared_rank(rb, k / J) + q * kRows * J + k % J;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float v = 0.0f;
          for (int c2 = 0; c2 < d.CSa; ++c2)
            v += part[(c2 * kRows + r) * d.KP + k];
          dst[r * J] = v;
        }
      }
      cluster.sync();
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        if (!pok[i]) continue;
        float v = 0.0f;
        for (int peer = 0; peer < kCluster; ++peer)
          v += rb[(peer * kRows + pr[i]) * J + pj[i]];
        dh[i] = v + dh_pass[i];
        dc[i] = dc_prev[i];
      }
      rbuf ^= 1;
    }

    // ================= dR over this chunk =================================
    // dR[:, C_q] += H^T DZ over the chunk's M = rows x steps (row, step)
    // pairs, in (row, step) order: slabs of kSlab pairs of the h carries
    // (all blocks', read from L2 past this SM's L1) and of this block's dz
    // are staged in `part`; each thread keeps 4 units x 8 columns of sums
    // in registers (units tk*4 .. +3 of a kDRK block, so that a warp's
    // float4 reads of the h slab are free of bank conflicts; columns
    // tc*8 .. +7 of a kDRC block, a broadcast)
    {
      const int L = s1 - s0;
      const int M = rows_valid * L;
      const bool first = j == d.nt - 1;
      const int tk = tid % 32, tc = tid / 32;
      float* hsl = part;                       // [kSlab][kDRK]
      float* zsl = part + kSlab * kDRK;        // [kSlab][kDRC]
      for (int kb = 0; kb < n; kb += kDRK) {
        for (int cb = 0; cb < C; cb += kDRC) {
          float acc[4][8];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[a][c] = 0.0f;
          for (int m0 = 0; m0 < M; m0 += kSlab) {
            __syncthreads();  // the previous slab is consumed
            // kBatch loads in flight per thread before any is stored: one
            // at a time, each waits out the L2 latency alone
#pragma unroll
            for (int i0 = 0; i0 < kSlab * kDRK / kThreads; i0 += kBatch) {
              float v[kBatch];
#pragma unroll
              for (int i = 0; i < kBatch; ++i) {
                const int e = tid + (i0 + i) * kThreads;
                const int mm = m0 + e / kDRK, k = kb + e % kDRK;
                v[i] = mm < M && k < n
                           ? __ldcg(hw + (static_cast<int64_t>(mm / L) * tw +
                                          mm % L) * NP + k)
                           : 0.0f;
              }
#pragma unroll
              for (int i = 0; i < kBatch; ++i)
                hsl[tid + (i0 + i) * kThreads] = v[i];
            }
#pragma unroll
            for (int i0 = 0; i0 < kSlab * kDRC / kThreads; i0 += kBatch) {
              float v[kBatch];
#pragma unroll
              for (int i = 0; i < kBatch; ++i) {
                const int e = tid + (i0 + i) * kThreads;
                const int mm = m0 + e / kDRC, c = cb + e % kDRC;
                v[i] = mm < M && c < C
                           ? __ldcg(zw + (static_cast<int64_t>(mm / L) * tw +
                                          mm % L) * C + c)
                           : 0.0f;
              }
#pragma unroll
              for (int i = 0; i < kBatch; ++i)
                zsl[tid + (i0 + i) * kThreads] = v[i];
            }
            __syncthreads();
            for (int mm = 0; mm < kSlab; ++mm) {
              const float4 hv = *reinterpret_cast<const float4*>(
                  hsl + mm * kDRK + tk * 4);
              const float4 za = *reinterpret_cast<const float4*>(
                  zsl + mm * kDRC + tc * 8);
              const float4 zb = *reinterpret_cast<const float4*>(
                  zsl + mm * kDRC + tc * 8 + 4);
              const float h4[4] = {hv.x, hv.y, hv.z, hv.w};
              const float zv[8] = {za.x, za.y, za.z, za.w,
                                   zb.x, zb.y, zb.z, zb.w};
#pragma unroll
              for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int c = 0; c < 8; ++c)
                  acc[a][c] = fmaf(h4[a], zv[c], acc[a][c]);
            }
          }
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int k = kb + tk * 4 + a;
            if (k >= n) continue;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const int col = cb + tc * 8 + c;
              if (col >= C || u0 + col % J >= n) continue;
              float* at = dRp + k * n4 + (col / J) * n + u0 + col % J;
              *at = first ? acc[a][c] : *at + acc[a][c];
            }
          }
        }
      }
    }
    // the next chunk's phase 1 overwrites the h carries every block reads
    cluster.sync();
  }

  // ---- dh0, dc0 and the tile's dp partial (rows summed in order)
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    if (!pok[i]) continue;
    const int64_t at = static_cast<int64_t>(prow[i]) * n + punit[i];
    dh0[at] = dh[i];
    dc0[at] = dc[i];
    float* slot = part + (pr[i] * J + pj[i]) * 3;
    slot[0] = dpi[i];
    slot[1] = dpf[i];
    slot[2] = dpo[i];
  }
  __syncthreads();
  for (int e = tid; e < 3 * J; e += kThreads) {
    const int g = e / J, jj = e % J;
    if (u0 + jj >= n) continue;
    float v = 0.0f;
    for (int r = 0; r < rows_valid; ++r) v += part[(r * J + jj) * 3 + g];
    dpp[g * n + u0 + jj] = v;
  }
}

// dR and dp: the tiles' partials added in tile order
__global__ void __launch_bounds__(256)
    lstm_bwd_reduce(const float* ws, float* __restrict__ dR,
                    float* __restrict__ dp, Dims d) {
  const int64_t nR = static_cast<int64_t>(d.n) * 4 * d.n;
  const int64_t total = nR + 3 * static_cast<int64_t>(d.n);
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float v = 0.0f;
    if (e < nR) {
      for (int tl = 0; tl < d.tiles; ++tl) v += ws[d.off_r + tl * nR + e];
      dR[e] = v;
    } else {
      const int64_t i = e - nR;
      for (int tl = 0; tl < d.tiles; ++tl)
        v += ws[d.off_p + tl * 3 * static_cast<int64_t>(d.n) + i];
      dp[i] = v;
    }
  }
}

struct Args {
  const void *zx, *R, *p, *h0, *c0, *hs, *ghs, *ghT, *gcT;
  const float *mask, *hck, *cck;
  void* dzx;
  float *dR, *dp, *dh0, *dc0, *ws;
};

template <typename T, bool RESIDENT>
cudaError_t launch_one(const Args& a, const Dims& d, size_t bytes,
                       cudaStream_t stream) {
  // above 48 KB a block's shared memory must be asked for per kernel
  cudaError_t err = cudaFuncSetAttribute(
      lstm_bwd_kernel<T, RESIDENT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  // grid x is exactly one cluster (__cluster_dims__), grid y one cluster
  // per batch tile
  const dim3 grid(kCluster, d.tiles);
  lstm_bwd_kernel<T, RESIDENT><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(a.zx), static_cast<const T*>(a.R),
      static_cast<const T*>(a.p), a.mask, static_cast<const T*>(a.h0),
      static_cast<const T*>(a.c0), static_cast<const T*>(a.hs), a.hck, a.cck,
      static_cast<const T*>(a.ghs), static_cast<const T*>(a.ghT),
      static_cast<const T*>(a.gcT), static_cast<T*>(a.dzx), a.dh0, a.dc0,
      a.ws, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = static_cast<int64_t>(d.n) * 4 * d.n + 3 * d.n;
  const int blocks = static_cast<int>((total + 255) / 256 < 1024
                                          ? (total + 255) / 256
                                          : 1024);
  lstm_bwd_reduce<<<blocks, 256, 0, stream>>>(a.ws, a.dR, a.dp, d);
  return cudaGetLastError();
}

int smem_optin(int device, int* optin) {
  return static_cast<int>(cudaDeviceGetAttribute(
      optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

template <typename T>
cudaError_t launch_typed(const Args& a, const Dims& d, int device,
                         cudaStream_t stream) {
  int optin = 0;
  const int err = smem_optin(device, &optin);
  if (err != 0) return static_cast<cudaError_t>(err);
  const size_t resident = smem_bytes(d, true);
  if (resident <= static_cast<size_t>(optin))
    return launch_one<T, true>(a, d, resident, stream);
  return launch_one<T, false>(a, d, smem_bytes(d, false), stream);
}

}  // namespace

extern "C" {

// Floats of float32 workspace a launch at (b, t, n, tc) needs (tc = t for
// row 6).
int64_t lstm_scan_bwd_workspace_floats(int64_t b, int64_t t, int64_t n,
                                       int64_t tc) {
  if (b <= 0 || t <= 0 || n <= 0 || tc <= 0) return 0;
  return make_dims(b, t, n, tc).total;
}

// Whether the backward keeps its slice of R in shared memory at hidden
// width n (1) or reads it from L2 every step (0); negative on a CUDA error.
int lstm_scan_bwd_resident(int64_t n, int device) {
  int optin = 0;
  const int err = smem_optin(device, &optin);
  if (err != 0) return -err;
  return smem_bytes(make_dims(1, 1, n, 1), true) <=
         static_cast<size_t>(optin);
}

// Row 6 (h0, c0, hs given; hck, cck null; tc = t) or row 8 (hck, cck
// given; h0, c0, hs null): zx [b, t, 4n], R [n, 4n], p [3, n] or null, h0,
// c0 [b, n], hs, g_hs [b, t, n], g_hT, g_cT [b, n] and dzx [b, t, 4n] of
// `dtype` (0 = float32, 1 = bfloat16); mask float32 [b, t] or null; hck, cck
// float32 [ceil(t / tc), b, n]; dR [n, 4n], dp [3, n], dh0, dc0 [b, n] and
// ws (lstm_scan_bwd_workspace_floats) float32; all dense. device: the CUDA
// device that holds them and owns `stream`. Returns the CUDA error code of
// the launches (0 = launched); launches nothing for an empty input.
int lstm_scan_bwd_launch(const void* zx, const void* R, const void* p,
                         const void* mask, const void* h0, const void* c0,
                         const void* hs, const void* hck, const void* cck,
                         const void* g_hs, const void* g_hT,
                         const void* g_cT, void* dzx, void* dR, void* dp,
                         void* dh0, void* dc0, void* ws,
                         int64_t b, int64_t t, int64_t n, int64_t tc,
                         int dtype, int device, void* stream) {
  if (b <= 0 || t <= 0) return 0;
  const bool chunked = hck != nullptr;
  if (n <= 0 || n > kMaxN || t > 0x7fffffff || tc <= 0 ||
      (b + kRows - 1) / kRows > 65535 || (chunked && cck == nullptr) ||
      (!chunked && (h0 == nullptr || c0 == nullptr || hs == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Dims d = make_dims(b, t, n, chunked ? tc : t);
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
  if (dtype == 0) return static_cast<int>(launch_typed<float>(a, d, device, s));
  if (dtype == 1)
    return static_cast<int>(launch_typed<__nv_bfloat16>(a, d, device, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* lstm_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
