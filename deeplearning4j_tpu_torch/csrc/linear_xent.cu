// Fused linear + softmax cross-entropy, forward and backward, for Hopper
// (sm_90a), with both products on the tensor cores.
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
// dz is spilled in x's type (bfloat16 on the mixed path, as the TPU
// kernel's MXU rounds it) and dx = dz . W^T is a second product that reads
// the spill; the wrapper's dW = x^T . dz reads it too. db is summed per
// 128-row tile, then over tiles in order by a third kernel (deterministic,
// no atomics anywhere).
//
// Bound on an H100 SXM at the trained TransformerLM shape (n = 16 * 512 =
// 8192 rows, d = 512, v = 8192): the forward does one product of 2*n*d*v =
// 68.7 GFLOP and reads the 268 MB of float32 labels once (0.08 ms); the
// backward two products (z and dx) and writes and reads the dz spill.
// bfloat16 products run at 989 TFLOP/s (forward 0.07 ms: the labels'
// bytes bound it). float32 products run as 3xTF32: each operand is split
// in registers into a TF32 part hi and the rest lo (split_tf32), and
// lo.hi + hi.lo + hi.hi of each k8 step is summed on the tensor core into
// a fresh tile that a float32 add then carries into the accumulator
// (mma_stage says why), which keeps float32 accuracy: the port's float32
// kernels compute float32 whatever the precision policy, and the training
// checks against the CPU hold at their float32 tolerances. That is 3 x
// 68.7 GFLOP over TF32's 495 TFLOP/s, 0.42 ms forward and 0.83 ms
// backward.
//
// Design. Every product is A . B^T with both operands [rows][K] in memory:
// z = x . (W^T)^T, from a copy wt = W^T [v][d] that a small kernel makes
// first (d v elements, read and written once), and dx = dz . (W)^T. A
// block of 8 warps computes a 128 x 128 tile, each warp a 64 x 32 piece
// of it as 4 x 4 mma.sync tiles (m16n8k16 bf16, or m16n8k8 tf32 three
// times), 64 float32 accumulators a thread, fragments from ldmatrix.
// Operands stream through a ring of 4 stages (3 for dx, whose bfloat16
// blocks then fit two to an SM) in dynamic shared memory, 128 bytes of K per row per
// stage, filled by cp.async (16-byte copies where rows are 16-byte
// aligned; otherwise 4-byte copies for float32 and plain loads for
// bfloat16, zero-filled past every edge), with one wait and one barrier
// per stage. Rows are padded by 16 bytes, so the 8 rows an ldmatrix reads
// at once sit on distinct banks.
//
// Both z kernels take grid (row tiles, vocab splits), the splits sized so
// that one wave of blocks fills the card; a block walks the vocab tiles of
// its split with the ring running on from one tile into the next, and the
// labels' tile (when read) is staged into shared memory by 16-byte
// cp.async from the tile's first chunk on, behind the products.
//   forward:  each tile's epilogue stays in registers (bias, the ragged
//             column mask, the quad's max and sum of exp, the label sums
//             and the first-max argmax over the accumulator fragments,
//             reduced across the quad by shuffles), then the 4 column warps
//             meet in a small shared buffer where one thread per row keeps
//             the running (m, s) and sums. A second kernel merges the
//             splits in order.
//   backward: (a) z, then the dz epilogue (index or dense path from the
//             device flag) spills dz and writes the tile's column sums of
//             dz (db partials); (b) grid (d tiles, row tiles): dx = dz .
//             W^T with K = v on the same main loop; (c) the db sum.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

constexpr int kBM = 128;               // rows of a block tile
constexpr int kBN = 128;               // columns of a block tile
constexpr int kThreads = 256;          // 8 warps: 2 (rows) x 4 (columns)
constexpr int kZStages = 4;            // depth of the z kernels' copy ring
constexpr int kDxStages = 3;           // dx's: 2 dx blocks fit on an SM
constexpr int kChunk = 128;            // bytes of K per row per stage
constexpr int kMKPitch = kChunk + 16;  // bytes per row of a [rows][K] tile
constexpr int kMKBytes = kBM * kMKPitch;
constexpr int kStage = 2 * kMKBytes;   // both operands of one chunk
constexpr float kNegInit = -1e30f;     // the TPU kernel's initial running max

template <typename T>
constexpr int kChunkElems = kChunk / static_cast<int>(sizeof(T));

// A [rows][K] tile: rows r0 + [0, 128), K columns k0 + [0, kBK) of the
// row-major matrix p [nrows][ld] whose columns are valid below ncols, into
// s with row pitch kMKPitch. vec: p and its rows are 16-byte aligned.
template <typename T>
__device__ __forceinline__ void load_mk(uint8_t* s, const T* p, int64_t ld,
                                        int nrows, int ncols, int r0, int k0,
                                        bool vec) {
  constexpr int kES = sizeof(T), kBK = kChunkElems<T>;
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int kPer = kChunk / 16;
#pragma unroll
    for (int i = 0; i < kBM * kPer / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kPer, q = e % kPer;
      const int row = r0 + r, col = k0 + q * (16 / kES);
      const int bytes =
          (row < nrows && col < ncols) ? min(16, (ncols - col) * kES) : 0;
      cp_async16(s + r * kMKPitch + q * 16,
                 bytes ? p + row * ld + col : p, bytes);
    }
  } else {  // cold: bounded unrolling keeps the registers for the products
#pragma unroll 4
    for (int i = 0; i < kBM * kBK / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kBK, c = e % kBK;
      const int row = r0 + r, col = k0 + c;
      const bool in = row < nrows && col < ncols;
      copy_elem(s + r * kMKPitch + c * kES, in ? p + row * ld + col : p, in);
    }
  }
}

// The labels' [128][128] tile at (r0, v0) into s (float32, row pitch
// kLabPitch words: a quad's 8-byte reads of 4 rows hit 32 banks), zero
// past the edges; vec: labels and its rows are 16-byte aligned.
constexpr int kLabPitch = kBN + 8;
constexpr int kLabBytes = kBM * kLabPitch * 4;

__device__ __forceinline__ void load_labels(float* s,
                                            const float* __restrict__ labels,
                                            int n, int v, int r0, int v0,
                                            bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll 1  // once per tile; unrolled, its addresses hold registers
    for (int i = 0; i < kBM * kBN / 4 / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / (kBN / 4), c = (e % (kBN / 4)) * 4;
      const int row = r0 + r, col = v0 + c;
      const int bytes = (row < n && col < v) ? min(16, (v - col) * 4) : 0;
      cp_async16(s + r * kLabPitch + c,
                 bytes ? labels + static_cast<int64_t>(row) * v + col
                       : labels,
                 bytes);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < kBM * kBN / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kBN, c = e % kBN;
      const int row = r0 + r, col = v0 + c;
      const bool in = row < n && col < v;
      cp_async4(s + r * kLabPitch + c,
                in ? labels + static_cast<int64_t>(row) * v + col : labels,
                in ? 4 : 0);
    }
  }
}

// -------------------------------------------------------------- products
// acc += the stage's A tile (sa) times B^T, B its other tile (sb), both
// [rows][K], over kChunk bytes of K. Warp (wm, wn) owns rows wm * 64 +
// [0, 64) and columns wn * 32 + [0, 32): acc[mt][nt] is the m16n8 tile at
// rows + 16 mt, columns + 8 nt, in mma's C layout. Fragments come from
// ldmatrix for both types: a float32 row of 16 bytes is 4 TF32 values, and
// the 8 x 8 b16 matrices' thread layout is then mma's TF32 layout.
template <typename T>
__device__ __forceinline__ void mma_stage(const uint8_t* sa,
                                          const uint8_t* sb,
                                          float (&acc)[4][4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  // ldmatrix x4: lane l addresses row l % 8 of matrix l / 8; for A the
  // matrices are (rows 0-7, k lo), (rows 8-15, k lo), (0-7, k hi), (8-15,
  // k hi), for B (n 0-7, k lo), (n 0-7, k hi), (n 8-15, k lo), (n 8-15,
  // k hi): b0, b1 of two n8 tiles
  const int ar = (lane & 7) + ((lane >> 3) & 1) * 8, ak = (lane >> 4) * 16;
  const int br = (lane & 7) + (lane >> 4) * 8, bk = ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int ks = 0; ks < kChunk / 32; ++ks) {  // 32 bytes: k16 bf16, k8 tf32
    const uint8_t* arow = sa + (wm * 64 + ar) * kMKPitch + ks * 32 + ak;
    uint32_t b[4][2];
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t r[4];
      ldsm_x4(r, sb + (wn * 32 + np * 16 + br) * kMKPitch + ks * 32 + bk);
      b[2 * np][0] = r[0];
      b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2];
      b[2 * np + 1][1] = r[3];
    }
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t a[4];
        ldsm_x4(a, arow + mt * 16 * kMKPitch);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
      }
    } else {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) split_tf32(b[nt][j], bh[nt][j], bl[nt][j]);
      // Per row block, the three products of this k8 step go into a fresh
      // float32 tile t (small terms first; 4 independent products between
      // dependent ones), then t is added to acc with a float32 add. The
      // tensor core adds with truncation, aligned to the largest of its
      // terms and C: carried along all of d (or v) in acc, that bias grows
      // with K, past what the training checks against the CPU hold; reset
      // every k8 step it stays at the step's own sum, and acc's long sum
      // rounds to nearest. A row block's fragments are loaded and split
      // just before its products, which keeps the registers below the cap.
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t a[4], ah[4], al[4];
        ldsm_x4(a, arow + mt * 16 * kMKPitch);
#pragma unroll
        for (int j = 0; j < 4; ++j) split_tf32(a[j], ah[j], al[j]);
        float t[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) t[nt][e] = 0.0f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_tf32(t[nt], al, bh[nt][0], bh[nt][1]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_tf32(t[nt], ah, bl[nt][0], bl[nt][1]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_tf32(t[nt], ah, bh[nt][0], bh[nt][1]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += t[nt][e];
      }
    }
  }
}

// Before a tile's epilogue reads labels that extra() issued at its first
// chunk: with fewer chunks than that group's lag, wait for every copy.
__device__ __forceinline__ void labels_ready(int nk) {
  if (nk < kZStages) {
    cp_async_wait<0>();
    __syncthreads();
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4][4]) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
}

// The tiles (r0, vt) of x . W for vt in [vt0, vt1) (b is the epilogue's),
// from x and wt = W^T [v][d]
// on the ring, which runs on from one tile into the next; when
// need_labels, the labels' tile is staged into lab by cp.async from the
// tile's first chunk on, behind the products. epilogue(v0, acc) ends each
// tile.
template <typename T, typename Epilogue>
__device__ __forceinline__ void walk_z_tiles(
    uint8_t* smem, float* lab, const T* __restrict__ x,
    const T* __restrict__ wt, const float* __restrict__ labels, int n, int d,
    int v, int r0, int vt0, int vt1, bool need_labels, bool vec_xw,
    bool vec_l, Epilogue&& epilogue) {
  constexpr int kBK = kChunkElems<T>;
  const int nk = (d + kBK - 1) / kBK;
  const int total = max(0, vt1 - vt0) * nk;
  float acc[4][4][4];
  zero(acc);
  ring<kStage, kZStages>(
      smem, total,
      [&](int c, uint8_t* st) {
        const int vt = vt0 + c / nk, k0 = (c % nk) * kBK;
        load_mk<T>(st, x, d, n, d, r0, k0, vec_xw);
        load_mk<T>(st + kMKBytes, wt, d, v, d, vt * kBN, k0, vec_xw);
      },
      [&](int c) {
        if (need_labels && c % nk == 0)
          load_labels(lab, labels, n, v, r0, (vt0 + c / nk) * kBN, vec_l);
      },
      [&](int c, const uint8_t* st) {
        mma_stage<T>(st, st + kMKBytes, acc);
        if (c % nk == nk - 1) {
          if (need_labels) labels_ready(nk);
          epilogue((vt0 + c / nk) * kBN, acc);
          zero(acc);
        }
      });
}

// ------------------------------------------------------------------ forward
constexpr int kFwdRed = 6 * 4 * kBM * 4 + 4 * kBM * 4;  // red, red_idx

template <typename T>
constexpr int fwd_smem() {
  return kZStages * kStage + kLabBytes + kFwdRed;
}

// Partials, per (split, row): part[(k * nsplit + split) * n + row] for k =
// 0 m, 1 s, 2 sum t*z, 3 T, 4 sum t^2, 5 max t; part_idx[split * n + row].
// The launch bound names one block an SM, as the shared memory allows:
// left to its own register target ptxas gave the bfloat16 instance 128
// registers and a spill.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    xent_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                    const float* __restrict__ b,
                    const float* __restrict__ labels, float* __restrict__ part,
                    int* __restrict__ part_idx, int n, int d, int v,
                    int tiles_per_split, int nsplit, bool vec_xw,
                    bool vec_l) {
  extern __shared__ __align__(128) uint8_t smem[];
  float* lab = reinterpret_cast<float*>(smem + kZStages * kStage);
  float* red = lab + kBM * kLabPitch;                          // [6][4][kBM]
  int* red_idx = reinterpret_cast<int*>(red + 6 * 4 * kBM);   // [4][kBM]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int r0 = blockIdx.x * kBM;
  const int split = blockIdx.y;
  const int nvt = (v + kBN - 1) / kBN;
  const int vt0 = split * tiles_per_split;
  const int vt1 = min(nvt, vt0 + tiles_per_split);

  // the running state of row r0 + tid, kept by thread tid < kBM
  float m = kNegInit, s = 0.0f, tz = 0.0f, ts = 0.0f, t2 = 0.0f, bt = -1.0f;
  int bi = 0;

  walk_z_tiles<T>(
      smem, lab, x, wt, labels, n, d, v, r0, vt0, vt1, true, vec_xw, vec_l,
      [&](int v0, float (&acc)[4][4][4]) {
        float bias[4][2];
        bool okc[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = v0 + wn * 32 + nt * 8 + 2 * t4 + e;
            okc[nt][e] = col < v;
            bias[nt][e] = okc[nt][e] ? b[col] : 0.0f;
          }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int rl = wm * 64 + mt * 16 + h * 8 + g;
            const float* lrow = lab + rl * kLabPitch + wn * 32 + 2 * t4;
            float mx = kNegInit, ltz = 0.0f, lts = 0.0f, lt2 = 0.0f;
            float lbt = -1.0f;
            int lbi = 0;
            float z[4][2];
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              // (zero past the edges)
              const float2 t = *reinterpret_cast<const float2*>(lrow + nt * 8);
              const float tt[2] = {t.x, t.y};
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                z[nt][e] = okc[nt][e] ? acc[mt][nt][2 * h + e] + bias[nt][e]
                                      : -INFINITY;
                mx = fmaxf(mx, z[nt][e]);
                if (okc[nt][e]) {
                  ltz = fmaf(tt[e], z[nt][e], ltz);
                  lts += tt[e];
                  lt2 = fmaf(tt[e], tt[e], lt2);
                  if (tt[e] > lbt) {  // strict: the first column keeps a tie
                    lbt = tt[e];
                    lbi = v0 + wn * 32 + nt * 8 + 2 * t4 + e;
                  }
                }
              }
            }
            // the quad (t4 = 0..3) shares the row
#pragma unroll
            for (int off = 1; off < 4; off <<= 1)
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            float se = 0.0f;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) se += expf(z[nt][e] - mx);
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
              se += __shfl_xor_sync(0xffffffffu, se, off);
              ltz += __shfl_xor_sync(0xffffffffu, ltz, off);
              lts += __shfl_xor_sync(0xffffffffu, lts, off);
              lt2 += __shfl_xor_sync(0xffffffffu, lt2, off);
              const float bo = __shfl_xor_sync(0xffffffffu, lbt, off);
              const int io = __shfl_xor_sync(0xffffffffu, lbi, off);
              if (bo > lbt || (bo == lbt && io < lbi)) {
                lbt = bo;
                lbi = io;
              }
            }
            if (t4 == 0) {
              const float vals[6] = {mx, se, ltz, lts, lt2, lbt};
#pragma unroll
              for (int k = 0; k < 6; ++k)
                red[(k * 4 + wn) * kBM + rl] = vals[k];
              red_idx[wn * kBM + rl] = lbi;
            }
          }
        __syncthreads();
        if (tid < kBM) {  // the 4 column warps, in column order
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float mo = red[(0 * 4 + q) * kBM + tid];
            const float so = red[(1 * 4 + q) * kBM + tid];
            const float m_new = fmaxf(m, mo);
            s = s * expf(m - m_new) + so * expf(mo - m_new);
            m = m_new;
            tz += red[(2 * 4 + q) * kBM + tid];
            ts += red[(3 * 4 + q) * kBM + tid];
            t2 += red[(4 * 4 + q) * kBM + tid];
            const float bo = red[(5 * 4 + q) * kBM + tid];
            if (bo > bt) {
              bt = bo;
              bi = red_idx[q * kBM + tid];
            }
          }
        }
        // red and lab are written again only after the ring's next barrier
      });

  const int row = r0 + tid;
  if (tid < kBM && row < n) {
    const float vals[6] = {m, s, tz, ts, t2, bt};
#pragma unroll
    for (int k = 0; k < 6; ++k)
      part[(static_cast<int64_t>(k) * nsplit + split) * n + row] = vals[k];
    part_idx[static_cast<int64_t>(split) * n + row] = bi;
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
template <typename T>
constexpr int dz_smem() {  // ring, labels, column sums
  return kZStages * kStage + kLabBytes + 2 * kBN * 4;
}

template <typename T>
constexpr int dx_smem() {
  return kDxStages * kStage;
}

// (a): the z tiles of row tile blockIdx.x in vocab split blockIdx.y, each
// then dz into the spill and the tile's column sums of dz into
// db_part[blockIdx.x][v].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    xent_dz_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                   const float* __restrict__ b,
                   const float* __restrict__ labels,
                   const int* __restrict__ idx,
                   const float* __restrict__ all_onehot,
                   const float* __restrict__ lse,
                   const float* __restrict__ tsum,
                   const float* __restrict__ g_in, T* __restrict__ dz,
                   float* __restrict__ db_part, int n, int d, int v,
                   int tiles_per_split, bool vec_xw, bool vec_l,
                   bool pair_dz) {
  extern __shared__ __align__(128) uint8_t smem[];
  float* lab = reinterpret_cast<float*>(smem + kZStages * kStage);
  float* col_red = lab + kBM * kLabPitch;  // [2][kBN]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int r0 = blockIdx.x * kBM;
  const int nvt = (v + kBN - 1) / kBN;
  const int vt0 = blockIdx.y * tiles_per_split;
  const int vt1 = min(nvt, vt0 + tiles_per_split);
  // the TPU kernel's lax.cond, read on the device: the index path reads
  // no labels
  const bool use_idx = *all_onehot > 0.5f;

  walk_z_tiles<T>(
      smem, lab, x, wt, labels, n, d, v, r0, vt0, vt1, !use_idx, vec_xw,
      vec_l, [&](int v0, float (&acc)[4][4][4]) {
        // this thread's 8 rows' lse, T, g and label index, read together
        // per tile (held across the products they would cost registers)
        float rows[4][2][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = min(r0 + wm * 64 + mt * 16 + h * 8 + g, n - 1);
            rows[mt][h][0] = lse[row];
            rows[mt][h][1] = tsum[row];
            rows[mt][h][2] = g_in[row];
            rows[mt][h][3] = __int_as_float(idx[row]);
          }
        float bias[4][2], csum[4][2];
        bool okc[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = v0 + wn * 32 + nt * 8 + 2 * t4 + e;
            okc[nt][e] = col < v;
            bias[nt][e] = okc[nt][e] ? b[col] : 0.0f;
            csum[nt][e] = 0.0f;
          }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int rl = wm * 64 + mt * 16 + h * 8 + g;
            const int row = r0 + rl;
            if (row >= n) continue;
            const float r_lse = rows[mt][h][0], r_t = rows[mt][h][1],
                        r_g = rows[mt][h][2];
            const int r_idx = __float_as_int(rows[mt][h][3]);
            const float* lrow = lab + rl * kLabPitch + wn * 32 + 2 * t4;
            T* drow = dz + static_cast<int64_t>(row) * v;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const int col = v0 + wn * 32 + nt * 8 + 2 * t4;
              float dzv[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                dzv[e] = 0.0f;
                if (okc[nt][e]) {
                  const float p =
                      expf(acc[mt][nt][2 * h + e] + bias[nt][e] - r_lse);
                  dzv[e] = use_idx
                               ? (p - (col + e == r_idx ? 1.0f : 0.0f)) * r_g
                               : (p * r_t - lrow[nt * 8 + e]) * r_g;
                }
                csum[nt][e] += dzv[e];
              }
              store2(drow, col, v, dzv[0], dzv[1], pair_dz);
            }
          }
        // column sums over the warp's 64 rows (lanes of one t4), then over
        // the two row warps in order
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int off = 4; off < 32; off <<= 1)
              csum[nt][e] += __shfl_xor_sync(0xffffffffu, csum[nt][e], off);
        if (g == 0) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              col_red[wm * kBN + wn * 32 + nt * 8 + 2 * t4 + e] = csum[nt][e];
        }
        __syncthreads();
        if (tid < kBN && v0 + tid < v)
          db_part[static_cast<int64_t>(blockIdx.x) * v + v0 + tid] =
              col_red[tid] + col_red[kBN + tid];
        // col_red and lab are written again only after the ring's next
        // barrier
      });
}

// (b): the [128 x 128] tile (row tile blockIdx.y, d tile blockIdx.x) of
// dx = dz . W^T, K = v; both operands are [rows][K] (dz rows, W rows).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    xent_dx_kernel(const T* __restrict__ dz, const T* __restrict__ w,
                   T* __restrict__ dx, int n, int d, int v, bool vec_dz,
                   bool vec_w, bool pair_dx) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int kBK = kChunkElems<T>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int c0 = blockIdx.x * kBN, r0 = blockIdx.y * kBM;
  const int nk = (v + kBK - 1) / kBK;

  float acc[4][4][4];
  zero(acc);
  ring<kStage, kDxStages>(
      smem, nk,
      [&](int c, uint8_t* st) {
        load_mk<T>(st, dz, v, n, v, r0, c * kBK, vec_dz);
        load_mk<T>(st + kMKBytes, w, v, d, v, c0, c * kBK, vec_w);
      },
      [](int) {},
      [&](int, const uint8_t* st) {
        mma_stage<T>(st, st + kMKBytes, acc);
      });
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + wm * 64 + mt * 16 + h * 8 + g;
      if (row >= n) continue;
      T* drow = dx + static_cast<int64_t>(row) * d;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        store2(drow, c0 + wn * 32 + nt * 8 + 2 * t4, d, acc[mt][nt][2 * h],
               acc[mt][nt][2 * h + 1], pair_dx);
    }
}

// W [d][v] -> wt = W^T [v][d] for the z kernels, through a 32 x 33 tile
// (the pad keeps the column reads on 32 banks)
template <typename T>
__global__ void xent_wt_kernel(const T* __restrict__ w, T* __restrict__ wt,
                               int d, int v) {
  __shared__ T tile[32][33];
  const int j0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int k = k0 + r, j = j0 + threadIdx.x;
    if (k < d && j < v)
      tile[r][threadIdx.x] = w[static_cast<int64_t>(k) * v + j];
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int j = j0 + r, k = k0 + threadIdx.x;
    if (j < v && k < d)
      wt[static_cast<int64_t>(j) * d + k] = tile[threadIdx.x][r];
  }
}

// (c): db[col] = the row tiles' column sums, added in order
__global__ void xent_db_kernel(const float* __restrict__ db_part,
                               float* __restrict__ db, int nrt, int v) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= v) return;
  float sum = 0.0f;
  for (int rt = 0; rt < nrt; ++rt)
    sum += db_part[static_cast<int64_t>(rt) * v + col];
  db[col] = sum;
}

// ------------------------------------------------------------------ host
// The wrapper splits the vocabulary so that nrt x nsplit blocks make one
// wave: a z kernel's shared memory holds an SM to one block (228 KB an SM,
// 1 KB of it reserved per block).
static_assert(2 * (fwd_smem<float>() + 1024) > 228 * 1024 &&
                  2 * (dz_smem<float>() + 1024) > 228 * 1024,
              "the vocabulary splits count one z block per SM");

template <typename T>
cudaError_t transpose_w(const void* w, void* wt, int d, int v,
                        cudaStream_t stream) {
  xent_wt_kernel<T><<<dim3((v + 31) / 32, (d + 31) / 32), dim3(32, 8), 0,
                      stream>>>(static_cast<const T*>(w),
                                static_cast<T*>(wt), d, v);
  return cudaGetLastError();
}

// x and wt [., d]: their rows take 16-byte copies
template <typename T>
bool rows16_xw(const void* x, const void* wt, int d) {
  return rows16<T>(x, d) && rows16<T>(wt, d);
}

template <typename T>
cudaError_t fwd(const void* x, const void* w, void* wt, const float* b,
                const float* labels, float* part, int* part_idx,
                float* per_row, float* lse, float* tsum, int* idx,
                float* onehot, int n, int d, int v, int nsplit, int device,
                cudaStream_t stream) {
  const int nrt = (n + kBM - 1) / kBM;
  const int nvt = (v + kBN - 1) / kBN;
  const int per = (nvt + nsplit - 1) / nsplit;
  constexpr int bytes = fwd_smem<T>();
  cudaError_t err = allow_smem<xent_fwd_kernel<T>>(device, bytes);
  if (err != cudaSuccess) return err;
  err = transpose_w<T>(w, wt, d, v, stream);
  if (err != cudaSuccess) return err;
  xent_fwd_kernel<T><<<dim3(nrt, nsplit), kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wt), b, labels, part,
      part_idx, n, d, v, per, nsplit, rows16_xw<T>(x, wt, d),
      rows16<float>(labels, v));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  xent_fwd_combine_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      part, part_idx, per_row, lse, tsum, idx, onehot, n, nsplit);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* x, const void* w, void* wt, const float* b,
                const float* labels, const int* idx, const float* all_onehot,
                const float* lse, const float* tsum, const float* g, void* dx,
                void* dz, float* db_part, float* db, int n, int d, int v,
                int nsplit, int device, cudaStream_t stream) {
  const int nrt = (n + kBM - 1) / kBM;
  const int nvt = (v + kBN - 1) / kBN;
  const int ndt = (d + kBN - 1) / kBN;
  const int per = (nvt + nsplit - 1) / nsplit;
  cudaError_t err = allow_smem<xent_dz_kernel<T>>(device, dz_smem<T>());
  if (err != cudaSuccess) return err;
  err = allow_smem<xent_dx_kernel<T>>(device, dx_smem<T>());
  if (err != cudaSuccess) return err;
  err = transpose_w<T>(w, wt, d, v, stream);
  if (err != cudaSuccess) return err;
  xent_dz_kernel<T><<<dim3(nrt, nsplit), kThreads, dz_smem<T>(), stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(wt), b, labels,
          idx, all_onehot, lse, tsum, g, static_cast<T*>(dz), db_part, n, d,
          v, per, rows16_xw<T>(x, wt, d), rows16<float>(labels, v),
          pairs<T>(dz, v));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the d tiles of one row tile run side by side and share its dz in L2
  xent_dx_kernel<T><<<dim3(ndt, nrt), kThreads, dx_smem<T>(), stream>>>(
      static_cast<const T*>(dz), static_cast<const T*>(w), static_cast<T*>(dx),
      n, d, v, rows16<T>(dz, v), rows16<T>(w, v), pairs<T>(dx, d));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  xent_db_kernel<<<(v + 255) / 256, 256, 0, stream>>>(db_part, db, nrt, v);
  return cudaGetLastError();
}

bool bad_sizes(int64_t n, int64_t d, int64_t v) {
  return n < 0 || d <= 0 || v <= 0 || n > 0x7fffffff || d > 0x7fffffff ||
         v > 0x7fffffff;
}

}  // namespace

extern "C" {

// x [n, d] and w [d, v] dense of `dtype` (0 = float32, 1 = bfloat16); b
// float32 [v]; labels float32 [n, v]; wt [v, d] of `dtype`, part float32
// [6 * nsplit * n] and part_idx int32 [nsplit * n] scratch; outputs
// float32 [n] per_row, lse, tsum, onehot and int32 [n] idx. Returns the
// CUDA error code of the launches (0 = launched); launches nothing for
// n = 0.
int linear_xent_fwd_launch(const void* x, const void* w, const void* b,
                           const void* labels, void* wt, void* part,
                           void* part_idx,
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
    return static_cast<int>(fwd<float>(x, w, wt, bf, lf, pf, pi, o_row,
                                       o_lse, o_ts, o_idx, o_oh, ni, di, vi,
                                       nsplit, device, s));
  if (dtype == 1)
    return static_cast<int>(fwd<__nv_bfloat16>(x, w, wt, bf, lf, pf, pi,
                                               o_row, o_lse, o_ts, o_idx,
                                               o_oh, ni, di, vi, nsplit,
                                               device, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, w, b, labels as above; idx int32 [n], lse, tsum, g float32 [n] and
// all_onehot a float32 scalar, all on the device; outputs dx [n, d] and the
// dz spill [n, v] of `dtype`, db float32 [v]; wt [v, d] of `dtype` and
// db_part float32 [ceil(n / 128) * v] scratch; nsplit vocabulary splits
// of the z tiles, as for the forward. Returns the CUDA error code of the
// launches; launches nothing for n = 0 (db is then left to the caller).
int linear_xent_bwd_launch(const void* x, const void* w, const void* b,
                           const void* labels, void* wt, const void* idx,
                           const void* all_onehot, const void* lse,
                           const void* tsum, const void* g, void* dx, void* dz,
                           void* db_part, void* db, int64_t n, int64_t d,
                           int64_t v, int nsplit, int dtype, int device,
                           void* stream) {
  if (bad_sizes(n, d, v) || nsplit < 1)
    return static_cast<int>(cudaErrorInvalidValue);
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
    return static_cast<int>(bwd<float>(x, w, wt, bf, lf, ii, oh, lsef, tsf,
                                       gf, dx, dz, dbp, dbf, ni, di, vi,
                                       nsplit, device, s));
  if (dtype == 1)
    return static_cast<int>(bwd<__nv_bfloat16>(x, w, wt, bf, lf, ii, oh,
                                               lsef, tsf, gf, dx, dz, dbp,
                                               dbf, ni, di, vi, nsplit,
                                               device, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* linear_xent_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
