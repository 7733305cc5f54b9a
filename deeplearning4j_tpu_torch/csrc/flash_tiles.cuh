// Tile helpers shared by the flash-attention kernels for Hopper (sm_90a):
// the forward (flash_attention.cu) and the backward (flash_attention_bwd.cu).
//
// A tile is [rows][D] of T in shared memory, each row padded by 16 bytes
// (row_pitch), so the 8 rows an ldmatrix reads, and the rows the scalar
// TF32 loads read, sit on distinct banks. A float32 tile may be split once
// into its TF32 parts (kSplit: hi in place, lo at the same offset from a
// second buffer) and then shared by every warp that reads it; elsewhere each
// warp splits its fragments in registers. Products run on mma.sync:
// bfloat16 as m16n8k16, float32 as 3xTF32 on m16n8k8 (hopper_mma.cuh).
// ops/_build.py hashes this header, and the one it includes, into the name
// of every library whose source includes it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

// bytes of one row of a [rows][D] tile of T
template <typename T, int D>
__host__ __device__ constexpr int row_pitch() {
  return D * static_cast<int>(sizeof(T)) + 16;
}

// Rows [r0, r0 + R) of a dense [t][D] matrix of T into a tile, zero at
// and past t, by the block's N threads. vec: the matrix starts on 16 bytes
// (its rows then do: D * sizeof(T) is a multiple of 16).
template <typename T, int D, int R, int N>
__device__ __forceinline__ void load_tile(uint8_t* s, const T* p, int r0,
                                          int t, bool vec) {
  constexpr int kP = row_pitch<T, D>();
  if (vec) {
    constexpr int kPer = D * static_cast<int>(sizeof(T)) / 16;
    // pieces a thread copies; the last round is partial where the tile
    // has fewer pieces than a multiple of N
    constexpr int kIters = (R * kPer + N - 1) / N;
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int e = threadIdx.x + i * N;
      if (kIters * N != R * kPer && e >= R * kPer) break;
      const int r = e / kPer, c = e % kPer;
      const bool in = r0 + r < t;
      const uint8_t* src = reinterpret_cast<const uint8_t*>(
          p + static_cast<int64_t>(in ? r0 + r : 0) * D);
      cp_async16(s + r * kP + c * 16, src + c * 16, in ? 16 : 0);
    }
  } else {  // cold: bounded unrolling keeps the registers for the products
#pragma unroll 4
    for (int i = 0; i < R * D / N; ++i) {
      const int e = threadIdx.x + i * N;
      const int r = e / D, c = e % D;
      const bool in = r0 + r < t;
      copy_elem(s + r * kP + c * static_cast<int>(sizeof(T)),
                in ? p + static_cast<int64_t>(r0 + r) * D + c : p, in);
    }
  }
}

// R rows of float32 tiles at st (one run of rows, row pitch of a [.][D]
// float32 tile) into their TF32 parts by the block's N threads: hi in
// place, lo at the same offsets from lo.
template <int D, int R, int N>
__device__ __forceinline__ void split_stage(uint8_t* st, uint8_t* lo) {
  constexpr int kP = row_pitch<float, D>();
  constexpr int kPer = D * 4 / 16;  // 16-byte pieces of a row
#pragma unroll
  for (int i = 0; i < R * kPer / N; ++i) {
    const int e = threadIdx.x + i * N;
    const int off = (e / kPer) * kP + (e % kPer) * 16;
    uint4 v = *reinterpret_cast<const uint4*>(st + off), l;
    split_tf32(v.x, v.x, l.x);
    split_tf32(v.y, v.y, l.y);
    split_tf32(v.z, v.z, l.z);
    split_tf32(v.w, v.w, l.w);
    *reinterpret_cast<uint4*>(st + off) = v;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// (x0, x1) rounded to nearest bfloat16, one register (x0 low)
__device__ __forceinline__ uint32_t bf16x2(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x0, x1) = hi + lo, each a pair of bfloat16 in one register (x0 low):
// hi rounded to nearest, lo the rest (exact in float32) rounded to nearest
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
}

// acc[i] += (ah + al) . (bh[i] + bl[i]) as 3xTF32 for the first `live` of
// N n8 tiles: the three products of each tile go into a fresh tile (small
// terms first, N independent products between dependent ones), then a
// float32 add carries it into acc. The tensor core adds with truncation,
// aligned to the largest of its terms and C: carried along a whole sum in
// acc, that bias grows with its length; reset every 8-deep step it stays at
// the step's own sum.
template <int N>
__device__ __forceinline__ void mma3_tf32(float (*acc)[4], const uint32_t ah[4],
                                          const uint32_t al[4],
                                          const uint32_t (&bh)[N][2],
                                          const uint32_t (&bl)[N][2],
                                          int live = N) {
  float t[N][4];
  zero(t);
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < live) mma_tf32(t[i], al, bh[i][0], bh[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < live) mma_tf32(t[i], ah, bl[i][0], bl[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < live) mma_tf32(t[i], ah, bh[i][0], bh[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < live)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] += t[i][e];
}

// acc[nt] += A . B^T over K = D: A the warp's 16 rows at a, B the 8 NT
// rows at b, both [rows][D] tiles of T; acc[nt] is the m16n8 tile of B's
// rows 8 nt + [0, 8), in mma's C layout. Only the first `live` tiles are
// computed (at least those; bfloat16 takes them in pairs); the others are
// left as they are. kSplit (float32): b holds B's TF32 hi parts and b_lo,
// at the same offsets, its lo parts. ldmatrix x4: lane l addresses row l %
// 8 of matrix l / 8; for A the matrices are (rows 0-7, k lo), (rows 8-15, k
// lo), (0-7, k hi), (8-15, k hi), for B (n 0-7, k lo), (n 0-7, k hi), (n
// 8-15, k lo), (n 8-15, k hi). A float32 row of 16 bytes is 4 TF32 values,
// and the 8 x 8 b16 matrices' thread layout is then mma's TF32 layout.
template <typename T, int D, bool kSplit, int NT>
__device__ __forceinline__ void product_abt(float (&acc)[NT][4],
                                            const uint8_t* a,
                                            const uint8_t* b,
                                            const uint8_t* b_lo,
                                            int live = NT) {
  constexpr int kP = row_pitch<T, D>();
  const int lane = threadIdx.x & 31;
  const int ar = (lane & 7) + ((lane >> 3) & 1) * 8, ak = (lane >> 4) * 16;
  const int br = (lane & 7) + (lane >> 4) * 8, bk = ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int ks = 0; ks < D * static_cast<int>(sizeof(T)) / 32; ++ks) {
    uint32_t af[4];  // 32 bytes of K: k16 bfloat16, k8 TF32
    ldsm_x4(af, a + ar * kP + ks * 32 + ak);
    const int boff = br * kP + ks * 32 + bk;
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        if (2 * np < live) {
          uint32_t r[4];
          ldsm_x4(r, b + np * 16 * kP + boff);
          mma_bf16(acc[2 * np], af, r[0], r[1]);
          mma_bf16(acc[2 * np + 1], af, r[2], r[3]);
        }
      }
    } else {
      uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) split_tf32(af[j], ah[j], al[j]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        if (2 * np < live) {
          uint32_t r[4];
          ldsm_x4(r, b + np * 16 * kP + boff);
          if constexpr (kSplit) {
            uint32_t rl[4];
            ldsm_x4(rl, b_lo + np * 16 * kP + boff);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              bh[2 * np + j / 2][j % 2] = r[j];
              bl[2 * np + j / 2][j % 2] = rl[j];
            }
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              split_tf32(r[j], bh[2 * np + j / 2][j % 2],
                         bl[2 * np + j / 2][j % 2]);
          }
        }
      }
      mma3_tf32<NT>(acc, ah, al, bh, bl, live);
    }
  }
}

// acc[nt] += X . B over K = 8 KT: X the warp's 16 x 8 KT float32 tile in
// mma's C layout (x[j] the m16n8 tile of columns 8 j + [0, 8)), B the 8 KT
// rows at b of a [rows][D] tile of T, B's rows X's columns; acc[nt] is the
// m16n8 tile of B's columns 8 nt + [0, 8). Only X's first `live` column
// tiles enter (at least those; bfloat16 takes them in pairs): the others
// must be zero. bfloat16: kPair takes X as a bfloat16 pair hi + lo (two
// products, about 16 bits), else X rounded once to bfloat16; float32 X is
// split into its TF32 parts (3xTF32) either way. Split shapes as for
// product_abt.
template <typename T, int D, bool kSplit, bool kPair, int KT>
__device__ __forceinline__ void product_ab(float (&acc)[D / 8][4],
                                           const float (&x)[KT][4],
                                           const uint8_t* b,
                                           const uint8_t* b_lo,
                                           int live = KT) {
  constexpr int kP = row_pitch<T, D>();
  const int lane = threadIdx.x & 31;
  if constexpr (sizeof(T) == 2) {
    // ldmatrix.trans x4: matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7,
    // n 8-15), (k 8-15, n 8-15): b0, b1 of two n8 tiles
    const int br = (lane & 7) + ((lane >> 3) & 1) * 8, bn = (lane >> 4) * 16;
#pragma unroll
    for (int ks = 0; ks < KT / 2; ++ks) {  // k16: C tiles 2 ks, 2 ks + 1
      if (2 * ks < live) {
        uint32_t ah[4], al[4];
        if constexpr (kPair) {
          split_bf16(x[2 * ks][0], x[2 * ks][1], ah[0], al[0]);
          split_bf16(x[2 * ks][2], x[2 * ks][3], ah[1], al[1]);
          split_bf16(x[2 * ks + 1][0], x[2 * ks + 1][1], ah[2], al[2]);
          split_bf16(x[2 * ks + 1][2], x[2 * ks + 1][3], ah[3], al[3]);
        } else {
          ah[0] = bf16x2(x[2 * ks][0], x[2 * ks][1]);
          ah[1] = bf16x2(x[2 * ks][2], x[2 * ks][3]);
          ah[2] = bf16x2(x[2 * ks + 1][0], x[2 * ks + 1][1]);
          ah[3] = bf16x2(x[2 * ks + 1][2], x[2 * ks + 1][3]);
        }
        uint32_t r[D / 16][4];
#pragma unroll
        for (int np = 0; np < D / 16; ++np)
          ldsm_x4_trans(r[np], b + (ks * 16 + br) * kP + np * 32 + bn);
        if constexpr (kPair) {
#pragma unroll
          for (int np = 0; np < D / 16; ++np) {
            mma_bf16(acc[2 * np], al, r[np][0], r[np][1]);
            mma_bf16(acc[2 * np + 1], al, r[np][2], r[np][3]);
          }
        }
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          mma_bf16(acc[2 * np], ah, r[np][0], r[np][1]);
          mma_bf16(acc[2 * np + 1], ah, r[np][2], r[np][3]);
        }
      }
    }
  } else {
    // k8 step ks takes X's columns 8 ks + (0, 2, 4, 6, 1, 3, 5, 7): the A
    // fragment (g, tig), (g + 8, tig), (g, tig + 4), (g + 8, tig + 4) is
    // then C's (g, 2 tig), (g + 8, 2 tig), (g, 2 tig + 1), (g + 8, 2 tig +
    // 1), and b0, b1 are B's rows 8 ks + 2 tig and 8 ks + 2 tig + 1 at
    // column 8 nt + g (banks 8 tig + g: D + 4 words per row)
    const int g = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int ks = 0; ks < KT; ++ks) {
      if (ks < live) {
        const uint32_t a[4] = {__float_as_uint(x[ks][0]),
                               __float_as_uint(x[ks][2]),
                               __float_as_uint(x[ks][1]),
                               __float_as_uint(x[ks][3])};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) split_tf32(a[j], ah[j], al[j]);
        const int off = (ks * 8 + 2 * tig) * kP + g * 4;
        constexpr int kG = D / 8 < 8 ? D / 8 : 8;  // n8 tiles per group
#pragma unroll
        for (int n0 = 0; n0 < D / 8; n0 += kG) {
          uint32_t bh[kG][2], bl[kG][2];
#pragma unroll
          for (int i = 0; i < kG; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int o = off + j * kP + (n0 + i) * 32;
              const uint32_t v = *reinterpret_cast<const uint32_t*>(b + o);
              if constexpr (kSplit) {
                bh[i][j] = v;
                bl[i][j] = *reinterpret_cast<const uint32_t*>(b_lo + o);
              } else {
                split_tf32(v, bh[i][j], bl[i][j]);
              }
            }
          mma3_tf32<kG>(acc + n0, ah, al, bh, bl);
        }
      }
    }
  }
}

}  // namespace
