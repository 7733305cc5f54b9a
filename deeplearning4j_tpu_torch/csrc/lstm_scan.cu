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
//   z = z_t + h @ R
//   i = sigmoid(z_i + pi*c), f = sigmoid(z_f + pf*c), g = tanh(z_g)
//   c' = f*c + i*g,  o = sigmoid(z_o + po*c'),  h' = o * tanh(c')
// and a masked step outputs 0 and carries h and c through unchanged. Only
// hs, hT and cT are rounded to T. sigmoid(x) = 1 / (1 + expf(-x)); the
// build has no fast-math. For n <= 256, h @ R is float32 FMAs on the CUDA
// cores in a fixed order: K in 8 groups of n / 8 units (n rounded up to
// the cluster's units), k ascending within a group from 0, the groups'
// sums added in order. The tensor cores were tried for it and left: as
// 3xTF32 on mma.sync (three products per k8 step, in a fresh tile or in
// three, with and without lo x lo) the step was faster, but every
// arrangement moved chip_smoke.py's chunked training check against the
// CPU (three RmsProp steps at 2 x 1024) past its 1e-5, which this order
// holds; wgmma at N = 8 was slower than mma.sync. Past n = 256 the product
// runs on mma.sync as 3xTF32 (hopper_mma.cuh; in bfloat16 R is exact in
// TF32 and h enters as its two parts).
//
// Bound on an H100 SXM at the served TextGenerationLSTM shape (b=64, t=64,
// n=256, float32): 2*b*n*4n*t = 2.15 GFLOP of recurrent products over 67
// TFLOP/s of float32 FMAs, 0.032 ms per launch, against 22.3 MB moved
// (0.0067 ms). The bound does not count the chain of t dependent steps,
// each of which needs the whole previous h: that latency, not the FMA
// rate, is what a small-batch recurrence pays.
//
// Design: a column split over a thread-block cluster. Every step needs all
// of h against all of R (1 MiB at n = 256 in float32), so a cluster of cl
// blocks shares one batch tile of rows batch rows: block q owns hidden
// units [q J, (q + 1) J) and the C = 4 J columns of R that feed their gates
// (column g J + j is gate g of unit q J + j). The host's plan (plan_for,
// printed by chip_smoke.py) picks per shape:
//   cl    8 for n <= 128, else 16 (a cluster of 16 is non-portable), so a
//         block's slice of R is at most 64 KB at n <= 256;
//   rows  the fewest batch rows per cluster, at most 16, with which every
//         batch tile runs at once (the card's count of co-resident
//         clusters, asked once per device: 7 of 16 blocks on an H100 SXM,
//         15 of 8), so that each block's products and exchange shrink with
//         b; past 16 rows the tiles wait for a second wave. The L2 path
//         takes 8 rows (one mma N tile);
//   R     resident for n <= 256: J = 16, so a block has 64 columns; each of
//         its 256 threads owns 4 columns for half the batch rows over one
//         of the 8 K groups, and holds that part of R (at most 32 x 4
//         floats) in registers for all t steps: one 16-byte load of h
//         feeds 16 FMAs. Past n = 256 the slice does not fit on chip: R is
//         read from L2 every step, several times slower.
// Each block holds an SM of its own (its shared memory is asked for at more
// than half of an SM's). A step:
//   (1) wait for h_{s-1}: each block's mbarrier counts the bytes that the
//       cl blocks' st.async stores bring into its receive buffer;
//   (2) the product into shared memory (resident: one partial sum per K
//       group), one __syncthreads;
//   (3) the cell, one thread per (row, unit): the partials added in group
//       order (so results repeat bit for bit), + zx; h and c carried in
//       registers;
//   (4) h_s to the cl blocks' other receive buffer: four lanes gather four
//       units of a row into one 16-byte st.async per peer, which completes
//       on that peer's mbarrier (no cluster barrier per step);
//   (5) hs, the chunk checkpoints and the next step's zx and mask loads,
//       off the chain: the exchange's latency covers them.
// The receive buffers and mbarriers are double-buffered: a block sends
// h_{s+1} only after it received h_s from every block, which each sent only
// after it had read h_{s-1}, so no buffer is overwritten while it is read
// and no mbarrier phase sees the next step's bytes. Batch tiles run as
// independent clusters along grid y. n is capped at kMaxN = 1024.
// profile_resnet_torch.py --model lstm-split builds this source with the
// probes below and splits a step by phase (PERF.md).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "hopper_mma.cuh"

namespace cg = cooperative_groups;

// Built with -DLSTM_FWD_PROBES (profile_resnet_torch.py --model
// lstm-split), thread 0 of the first cluster's block 0 reads clock64 at each
// phase boundary of every step, PROBE(i) closing phase i, and PROBE_END
// adds the cycles to g_probe[i], the loop's %globaltimer ns to g_probe[14]
// and its steps to g_probe[15]; lstm_scan_probe_names() names the phases.
// Otherwise the probes are empty.
#ifdef LSTM_FWD_PROBES
__device__ unsigned long long g_probe[16];
#define PROBE_START                                                    \
  const bool probe0 = blockIdx.y == 0 && cluster.block_rank() == 0 && \
                      threadIdx.x == 0;                               \
  unsigned long long pacc[14] = {0}, ns0;                             \
  long long ta = clock64();                                           \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns0));
#define PROBE(i)                    \
  if (probe0) {                     \
    const long long tb = clock64(); \
    pacc[i] += tb - ta;             \
    ta = tb;                        \
  }
#define PROBE_END(count, steps)                               \
  if (probe0) {                                               \
    unsigned long long ns1;                                   \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns1));   \
    for (int i = 0; i < (count); ++i) g_probe[i] += pacc[i];  \
    g_probe[14] += ns1 - ns0;                                 \
    g_probe[15] += (steps);                                   \
  }
#else
#define PROBE_START
#define PROBE(i)
#define PROBE_END(count, steps)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 1024;
constexpr int kRegN = 256;     // widest n whose R slices fit in registers
constexpr int kSmallN = 128;   // widest n that a cluster of 8 blocks takes
// resident: J = 16 units, so 64 columns per block; each thread of the
// product owns 4 of them for half the batch rows over one of kShares K
// shares of at most kShareK units (n <= 256)
constexpr int kShares = 8;
constexpr int kShareK = 32;
// a block's least shared memory: more than half of an SM's 228 KB
constexpr size_t kOwnSm = 116 * 1024;
constexpr int kBarFloats = 4;  // the mbarriers at the start of it

std::atomic<int> g_queries[2];  // attribute calls, occupancy queries

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

// ------------------------------------------------------------------ PTX
// the cluster barrier in two halves
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// p's address in the shared memory of cluster block `rank`
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// the initialised mbarriers are seen by the cluster's other blocks
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// the phase's one arrival, expecting `bytes` from st.async stores
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Waits for the phase of `parity` to complete. A phase that never does (a
// lost exchange) ends the launch with an error after 2^34 cycles, about ten
// seconds, rather than holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const long long start = clock64();
  uint32_t done = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}
// 16 bytes into a cluster block's shared memory, counted on its mbarrier
__device__ __forceinline__ void st_async4(uint32_t addr, float4 v,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "r"(bits(v.x)), "r"(bits(v.y)), "r"(bits(v.z)), "r"(bits(v.w)),
      "r"(bar)
      : "memory");
}

struct Dims {
  int b, t, n, tc;
  int rows;   // batch rows per cluster
  int cl;     // blocks per cluster
  int J;      // hidden units per block, a power of two (16 when resident)
  int LJ;     // log2 J
  int C;      // 4 J columns per block, gate-major
  int HW;     // cl J >= n: units in a row of h
  int SK;     // resident: units of a K share, HW / kShares
  int HWP;    // row stride of a receive buffer: resident kShares (SK + 4),
              // else HW + 4
  int RS;     // floats of a receive buffer [rows][HWP]
  int CP;     // row stride of the partial sums: C + 4
  int KW;     // partial sums per z: kShares (resident), else 1
  int KS;     // L2 path: k8 steps, ceil(n / 8)
  int MT;     // L2 path: 16-column tiles, C / 16
};

struct Plan {
  int cl, rows, tiles, active;
  int J;  // hidden units per block
  bool resident;
};

// The plan for (b, n) on a card that runs `active8` clusters of 8 blocks or
// `active16` of 16 at once (at one block per SM)
Plan plan_for(int64_t b, int64_t n, int active8, int active16) {
  Plan pl;
  pl.resident = n <= kRegN;
  pl.cl = n <= kSmallN ? 8 : 16;
  pl.active = pl.cl == 8 ? active8 : active16;
  // resident: the fewest rows (at most 16) with which every batch tile runs
  // at once; the L2 path's product takes 8, one mma N tile
  pl.rows = 8;
  if (pl.resident && pl.active > 0)
    pl.rows = static_cast<int>(
        std::min<int64_t>(16, std::max<int64_t>(1, (b + pl.active - 1) /
                                                       pl.active)));
  pl.tiles = static_cast<int>((b + pl.rows - 1) / pl.rows);
  // resident: 16 units, so a block's 64 columns fill its 256 threads' 8 K
  // shares; else the power of two >= 4 that covers n
  pl.J = pl.resident ? 16 : 4;
  while (pl.J * pl.cl < n) pl.J *= 2;
  return pl;
}

Dims make_dims(int64_t b, int64_t t, int64_t n, int64_t tc, const Plan& pl) {
  Dims d;
  d.b = static_cast<int>(b);
  d.t = static_cast<int>(t);
  d.n = static_cast<int>(n);
  d.tc = static_cast<int>(tc);
  d.rows = pl.rows;
  d.cl = pl.cl;
  d.J = pl.J;
  d.LJ = 0;
  while ((1 << d.LJ) < d.J) ++d.LJ;
  d.C = 4 * d.J;
  d.HW = d.cl * d.J;
  d.SK = d.HW / kShares;
  d.HWP = pl.resident ? kShares * (d.SK + 4) : d.HW + 4;
  d.RS = pl.rows * d.HWP;
  d.CP = d.C + 4;
  d.KW = pl.resident ? kShares : 1;
  d.KS = (d.n + 7) / 8;
  d.MT = d.C / 16;
  return d;
}

size_t smem_bytes(const Dims& d) {
  // the mbarriers, two receive buffers, the partial sums
  const size_t floats = kBarFloats + 2 * static_cast<size_t>(d.RS) +
                        static_cast<size_t>(d.KW) * d.rows * d.CP;
  return floats * sizeof(float) > kOwnSm ? floats * sizeof(float) : kOwnSm;
}

// L2 path: one k8 step of z^T += R_q^T h^T into a fresh tile added to acc,
// small terms first: A as its TF32 parts (a_lo unused when R is exact in
// TF32), B as this lane's h values' parts: units k0 + t4 (bh0, bl0) and
// k0 + t4 + 4 (bh1, bl1)
template <bool kSplitR>
__device__ __forceinline__ void k8_step(float acc[4], const uint32_t a_hi[4],
                                        const uint32_t a_lo[4], uint32_t bh0,
                                        uint32_t bh1, uint32_t bl0,
                                        uint32_t bl1) {
  float tt[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (kSplitR) mma_tf32(tt, a_lo, bh0, bh1);
  mma_tf32(tt, a_hi, bl0, bl1);
  mma_tf32(tt, a_hi, bh0, bh1);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += tt[e];
}

// RESIDENT: R's slice in registers, FMAs for d.rows <= 16 batch rows; else
// R from L2, mma.sync for 8 rows
template <typename T, bool RESIDENT>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_scan_kernel(const T* __restrict__ zx, const T* __restrict__ R,
                     const T* __restrict__ p, const float* __restrict__ mask,
                     const T* __restrict__ h0, const T* __restrict__ c0,
                     T* __restrict__ hs, T* __restrict__ hT,
                     T* __restrict__ cT, float* __restrict__ hck,
                     float* __restrict__ cck, Dims d) {
  constexpr int NT = 1;  // the L2 path's mma N tiles of 8 rows
  constexpr bool kSplitR = sizeof(T) == 4;  // bfloat16 is exact in TF32
  constexpr int kPairs = RESIDENT ? 1 : 2;  // (row, unit) pairs per thread
  constexpr int kKW = RESIDENT ? kShares : 1;  // = d.KW
  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int n = d.n, J = d.J, CP = d.CP, HWP = d.HWP, SK = d.SK;
  const int u0 = q * J;                    // first hidden unit of this block
  const int rows = d.rows;
  const int b0 = blockIdx.y * rows;        // first batch row of the cluster
  const int64_t n4 = 4 * static_cast<int64_t>(n);

  extern __shared__ __align__(16) float smem[];
  // kBarFloats: two mbarriers, one per receive buffer (dynamic shared
  // memory, so that all of it may be asked for)
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* hrecv = smem + kBarFloats;        // [2][rows][HWP] h
  float* part = hrecv + 2 * d.RS;          // [KW][rows][CP] partial z
  // h[r][k]: resident, [kShares][SK + 4] per row, so that two K shares'
  // 16-byte loads fall in distinct banks; else [HW + 4]
  auto hoff = [&](int r, int k) {
    return RESIDENT ? r * HWP + (k / SK) * (SK + 4) + k % SK : r * HWP + k;
  };
  // the bytes that arrive per step: every block's rows x J values
  const int bytes = rows * d.HW * static_cast<int>(sizeof(float));

  // ---- set-up: zeroed buffers (pad units stay 0), h0, the mbarriers
  for (int e = tid; e < 2 * d.RS + kKW * rows * CP; e += kThreads)
    hrecv[e] = 0.0f;
  __syncthreads();
  for (int e = tid; e < rows * n; e += kThreads) {
    const int r = e / n, k = e % n;
    if (b0 + r < d.b)
      hrecv[hoff(r, k)] = to_float(h0[static_cast<int64_t>(b0 + r) * n + k]);
  }
  if (tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    mbar_init_fence();
    mbar_expect(bars, bytes);
    mbar_expect(bars + 1, bytes);
  }

  // R_q^T [C][k] at column c (gate c / J, unit u0 + c % J) and row k
  auto r_at = [&](int k, int c) -> float {
    const int u = u0 + (c & (J - 1));
    return k < n && u < n ? to_float(R[k * n4 + (c >> d.LJ) * n + u]) : 0.0f;
  };
  // resident: this thread's nr rows from half fr, K share fks and columns
  // 4 fcq .. 4 fcq + 3, their part of R in registers
  const int fr = tid >> 7, fks = (tid >> 4) & 7, fcq = tid & 15;
  const int half = (rows + 1) / 2, nr = min(half, rows - fr * half);
  float rr[RESIDENT ? kShareK : 1][4];
  if (RESIDENT) {
#pragma unroll
    for (int i = 0; i < kShareK; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        rr[i][c] = i < SK ? r_at(fks * SK + i, 4 * fcq + c) : 0.0f;
  }

  // ---- this thread's (row, unit) pairs: carries and peepholes in
  // registers; pad rows and units carry zeros. Four lanes 4a .. 4a + 3
  // all have a pair i or none (rows J is a multiple of 4)
  float hreg[kPairs], creg[kPairs], pi[kPairs], pf[kPairs], po[kPairs];
  int prow[kPairs], punit[kPairs], pr[kPairs], pj[kPairs];
  bool pin[kPairs], pok[kPairs];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int pidx = tid + i * kThreads;
    pin[i] = pidx < rows * J;
    pr[i] = pidx >> d.LJ;
    pj[i] = pidx & (J - 1);
    prow[i] = b0 + pr[i];
    punit[i] = u0 + pj[i];
    pok[i] = pin[i] && prow[i] < d.b && punit[i] < n;
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
      if (hck != nullptr) {  // the carry entering chunk 0
        hck[at] = hreg[i];
        cck[at] = creg[i];
      }
    }
  }
  float zxv[kPairs][4];
  bool live[kPairs];
  auto load_step = [&](int s) {
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      live[i] = true;
#pragma unroll
      for (int g = 0; g < 4; ++g) zxv[i][g] = 0.0f;
      if (!pok[i]) continue;
      const int64_t row = (static_cast<int64_t>(prow[i]) * d.t + s) * n4;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        zxv[i][g] = to_float(zx[row + g * n + punit[i]]);
      if (mask != nullptr)
        live[i] = mask[static_cast<int64_t>(prow[i]) * d.t + s] > 0.0f;
    }
  };
  load_step(0);
  // every block's buffers and mbarriers are ready before any peer sends
  cluster.sync();
  PROBE_START

  for (int s = 0; s < d.t; ++s) {
    const int buf = s & 1;
    const float* hin = hrecv + buf * d.RS;
    // (1) h_{s-1} from every block (h0 was loaded by each block itself)
    if (s > 0) mbar_wait(bars + buf, ((s - 1) >> 1) & 1);
    PROBE(0)  // waiting for h

    // (2) part[w][r][c] = sum over K share w's k of h[r][k] R[k][c]
    if (RESIDENT) {
      // float32 FMAs, k ascending, two rows at a time: eight chains, and
      // one float4 of h feeds 16 FMAs
      const float* hk = hin + (half * fr) * HWP + fks * (SK + 4);
      float* pw = part + (fks * rows + half * fr) * CP + 4 * fcq;
      for (int r = 0; r < nr; r += 2) {
        const bool two = r + 1 < nr;
        const float* hx = hk + r * HWP;
        const float* hy = hk + (two ? r + 1 : r) * HWP;
        float ax[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float ay[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int i = 0; i < kShareK; i += 4) {
          if (i < SK) {
            const float4 x = *reinterpret_cast<const float4*>(hx + i);
            const float4 y = *reinterpret_cast<const float4*>(hy + i);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              ax[c] = fmaf(x.x, rr[i][c], ax[c]);
              ay[c] = fmaf(y.x, rr[i][c], ay[c]);
              ax[c] = fmaf(x.y, rr[i + 1][c], ax[c]);
              ay[c] = fmaf(y.y, rr[i + 1][c], ay[c]);
              ax[c] = fmaf(x.z, rr[i + 2][c], ax[c]);
              ay[c] = fmaf(y.z, rr[i + 2][c], ay[c]);
              ax[c] = fmaf(x.w, rr[i + 3][c], ax[c]);
              ay[c] = fmaf(y.w, rr[i + 3][c], ay[c]);
            }
          }
        }
        *reinterpret_cast<float4*>(pw + r * CP) =
            make_float4(ax[0], ax[1], ax[2], ax[3]);
        if (two)
          *reinterpret_cast<float4*>(pw + (r + 1) * CP) =
              make_float4(ay[0], ay[1], ay[2], ay[3]);
      }
    } else {
      // mma.sync, 3xTF32: R read from L2 and split every step, h split as
      // each warp reads it
      for (int m = warp; m < d.MT; m += kWarps) {
        const int m0 = m * 16;
        float acc[NT][4] = {};
#pragma unroll 2
        for (int ks = 0; ks < d.KS; ++ks) {
          const int k0 = ks * 8;
          float a[4];
          a[0] = r_at(k0 + t4, m0 + g8);
          a[1] = r_at(k0 + t4, m0 + g8 + 8);
          a[2] = r_at(k0 + t4 + 4, m0 + g8);
          a[3] = r_at(k0 + t4 + 4, m0 + g8 + 8);
          uint32_t a_hi[4], a_lo[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (kSplitR) {
              split_tf32(bits(a[j]), a_hi[j], a_lo[j]);
            } else {
              a_hi[j] = bits(a[j]);
              a_lo[j] = 0u;
            }
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int r = nt * 8 + g8;
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(bits(hin[hoff(r, k0 + t4)]), bh0, bl0);
            split_tf32(bits(hin[hoff(r, k0 + t4 + 4)]), bh1, bl1);
            k8_step<kSplitR>(acc[nt], a_hi, a_lo, bh0, bh1, bl0, bl1);
          }
        }
        float* zw = part + m0 + g8;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int r = nt * 8 + 2 * t4;
          zw[r * CP] = acc[nt][0];
          zw[(r + 1) * CP] = acc[nt][1];
          zw[r * CP + 8] = acc[nt][2];
          zw[(r + 1) * CP + 8] = acc[nt][3];
        }
      }
    }
    PROBE(1)  // the product
    __syncthreads();
    // every thread is past the wait: the mbarrier's next phase may start
    if (s > 0 && tid == 0) mbar_expect(bars + buf, bytes);
    PROBE(2)  // its barrier

    // (3) the cell, one thread per (row, unit): the K shares' partial sums
    // added in order
    float h_out[kPairs];
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      h_out[i] = 0.0f;
      if (!pok[i]) continue;
      float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int w = 0; w < kKW; ++w) {
        const float* pz = part + (w * rows + pr[i]) * CP + pj[i];
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
      h_out[i] = h_new;
      if (!live[i]) {
        h_out[i] = 0.0f;
        h_new = hreg[i];
        c_new = c_prev;
      }
      hreg[i] = h_new;
      creg[i] = c_new;
    }
    PROBE(3)  // the cell

    // (4) h_s to every block of the cluster (none needs the last step's):
    // lanes 4a .. 4a + 3 hold units j .. j + 3 of one row, in one K share
    if (s + 1 < d.t) {
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        const int base = lane & ~3;
        const float4 v =
            make_float4(__shfl_sync(0xffffffffu, hreg[i], base),
                        __shfl_sync(0xffffffffu, hreg[i], base + 1),
                        __shfl_sync(0xffffffffu, hreg[i], base + 2),
                        __shfl_sync(0xffffffffu, hreg[i], base + 3));
        if (!pin[i]) continue;
        const float* dst =
            hrecv + (buf ^ 1) * d.RS + hoff(pr[i], u0 + (pj[i] & ~3));
        for (int peer = t4; peer < d.cl; peer += 4)
          st_async4(peer_addr(dst, peer), v,
                    peer_addr(bars + (buf ^ 1), peer));
      }
    }
    PROBE(4)  // the sends

    // (5) outputs and the next step's loads, while h_s travels
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      if (!pok[i]) continue;
      store_as(hs + (static_cast<int64_t>(prow[i]) * d.t + s) * n + punit[i],
               h_out[i]);
      if (hck != nullptr && (s + 1) % d.tc == 0 && s + 1 < d.t) {
        const int64_t at =
            (static_cast<int64_t>((s + 1) / d.tc) * d.b + prow[i]) * n +
            punit[i];
        hck[at] = hreg[i];
        cck[at] = creg[i];
      }
    }
    if (s + 1 < d.t) load_step(s + 1);
    PROBE(5)  // stores and the next step's loads
  }
  PROBE_END(6, d.t)

#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    if (!pok[i]) continue;
    const int64_t at = static_cast<int64_t>(prow[i]) * n + punit[i];
    store_as(hT + at, hreg[i]);
    store_as(cT + at, creg[i]);
  }
  // no block leaves while a peer may still address its shared memory
  cluster_arrive();
  cluster_wait();
}

// Above 48 KB a block's shared memory must be asked for, and a cluster of
// 16 blocks allowed, per kernel and device. The calls cost host time, and a
// training step of the char-RNN is host-bound: ask once.
template <auto kKernel>
cudaError_t prepare(int device, int optin) {
  static std::atomic<bool> done[64];
  if (device >= 0 && device < 64 && done[device].load()) return cudaSuccess;
  g_queries[0] += 2;
  cudaError_t err = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kKernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return err;
}

cudaLaunchConfig_t config(int cl, int tiles, size_t bytes,
                          cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of 8 and of 16 blocks the card runs at once, every
// block on an SM of its own: asked once per device (of the resident
// kernel; every launch takes an SM per block, so the count holds for all)
cudaError_t active_clusters(int device, int optin, int* a8, int* a16) {
  static std::atomic<int> known[64][2];  // count + 1, 0 until asked
  if (device >= 0 && device < 64 && known[device][0].load() > 0 &&
      known[device][1].load() > 0) {
    *a8 = known[device][0].load() - 1;
    *a16 = known[device][1].load() - 1;
    return cudaSuccess;
  }
  constexpr auto kernel = lstm_scan_kernel<float, true>;
  cudaError_t err = prepare<kernel>(device, optin);
  int got[2] = {0, 0};
  for (int i = 0; i < 2 && err == cudaSuccess; ++i) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        config(8 << i, 1, kOwnSm, nullptr, &attr);
    g_queries[1] += 1;
    err = cudaOccupancyMaxActiveClusters(&got[i], kernel, &cfg);
  }
  if (err != cudaSuccess) return err;
  if (device >= 0 && device < 64) {
    known[device][0] = got[0] + 1;
    known[device][1] = got[1] + 1;
  }
  *a8 = got[0];
  *a16 = got[1];
  return cudaSuccess;
}

template <typename T, bool RESIDENT>
cudaError_t launch_one(const void* zx, const void* R, const void* p,
                       const float* mask, const void* h0, const void* c0,
                       void* hs, void* hT, void* cT, float* hck, float* cck,
                       const Dims& d, int tiles, size_t bytes, int device,
                       int optin, cudaStream_t stream) {
  constexpr auto kernel = lstm_scan_kernel<T, RESIDENT>;
  cudaError_t err = prepare<kernel>(device, optin);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(d.cl, tiles, bytes, stream, &attr);
  return cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(zx), static_cast<const T*>(R),
      static_cast<const T*>(p), mask, static_cast<const T*>(h0),
      static_cast<const T*>(c0), static_cast<T*>(hs), static_cast<T*>(hT),
      static_cast<T*>(cT), hck, cck, d);
}

cudaError_t device_plan(int64_t b, int64_t n, int device, int* optin,
                        Plan* pl) {
  cudaError_t err = cudaDeviceGetAttribute(
      optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  int a8 = 0, a16 = 0;
  if (err == cudaSuccess) err = active_clusters(device, *optin, &a8, &a16);
  if (err == cudaSuccess) *pl = plan_for(b, n, a8, a16);
  return err;
}

template <typename T>
cudaError_t launch_typed(const void* zx, const void* R, const void* p,
                         const float* mask, const void* h0, const void* c0,
                         void* hs, void* hT, void* cT, float* hck,
                         float* cck, int64_t b, int64_t t, int64_t n,
                         int64_t tc, int device, cudaStream_t stream) {
  int optin = 0;
  Plan pl;
  cudaError_t err = device_plan(b, n, device, &optin, &pl);
  if (err != cudaSuccess) return err;
  if (pl.active < 1 || pl.tiles > 65535) return cudaErrorInvalidValue;
  const Dims d = make_dims(b, t, n, tc, pl);
  const size_t bytes = smem_bytes(d);
  if (bytes > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  return (pl.resident ? launch_one<T, true> : launch_one<T, false>)(
      zx, R, p, mask, h0, c0, hs, hT, cT, hck, cck, d, pl.tiles, bytes,
      device, optin, stream);
}

}  // namespace

extern "C" {

// Whether the plan for width n keeps R's slices on chip (in registers) for
// all steps (1) or reads them from L2 every step (0).
int lstm_scan_resident(int64_t n, int device) {
  (void)device;
  return n <= kRegN;
}

static void plan_out(const Plan& pl, int* out) {
  out[0] = pl.cl;
  out[1] = pl.rows;
  out[2] = pl.tiles;
  out[3] = pl.resident;
  out[4] = pl.active;
  out[5] = pl.J;
}

// The plan for (b, n) on a card that runs `active8` clusters of 8 blocks and
// `active16` of 16 at once: out = {blocks per cluster, batch rows per
// cluster, batch tiles (clusters), R resident, clusters of that size the
// card runs at once, hidden units per block}.
void lstm_scan_plan_for(int64_t b, int64_t n, int active8, int active16,
                        int* out) {
  plan_out(plan_for(b, n, active8, active16), out);
}

// As lstm_scan_plan_for, with the counts of `device` (asked once per
// device); returns the CUDA error code.
int lstm_scan_plan(int64_t b, int64_t n, int device, int* out) {
  int optin = 0;
  Plan pl;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaError_t err = device_plan(b, n, device, &optin, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan_out(pl, out);
  return 0;
}

// How often this library has called cudaFuncSetAttribute (kind 0) and
// cudaOccupancyMaxActiveClusters (kind 1) since it was loaded.
int lstm_scan_queries(int kind) {
  return kind == 0 || kind == 1 ? g_queries[kind].load() : -1;
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
  if (n <= 0 || n > kMaxN || t > 0x7fffffff || b > 0x7fffffff || tc <= 0 ||
      tc > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  // this library carries its own CUDA runtime, whose current device is
  // per thread and independent of PyTorch's
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  if (dtype == 0)
    return static_cast<int>(launch_typed<float>(
        zx, R, p, m, h0, c0, hs, hT, cT, hck, cck, b, t, n, tc, device, s));
  if (dtype == 1)
    return static_cast<int>(launch_typed<__nv_bfloat16>(
        zx, R, p, m, h0, c0, hs, hT, cT, hck, cck, b, t, n, tc, device, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

int lstm_scan_launch(const void* zx, const void* R, const void* p,
                     const void* mask, const void* h0, const void* c0,
                     void* hs, void* hT, void* cT, int64_t b, int64_t t,
                     int64_t n, int dtype, int device, void* stream) {
  return launch_any(zx, R, p, mask, h0, c0, hs, hT, cT, nullptr, nullptr, b,
                    t, n, t, dtype, device, stream);
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

#ifdef LSTM_FWD_PROBES
const char* lstm_scan_probe_names() {
  return "wait for h;product;sync;cell;send h;stores, next loads";
}
int lstm_scan_probe_reset() {
  const unsigned long long zero[16] = {0};
  return static_cast<int>(cudaMemcpyToSymbol(g_probe, zero, sizeof(zero)));
}
int lstm_scan_probe_read(unsigned long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_probe, 16 * sizeof(unsigned long long)));
}
#endif

}  // extern "C"
