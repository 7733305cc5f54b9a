// Primitives shared by the port's tensor-core kernels for Hopper (sm_90a):
// cp.async copies and their ring, ldmatrix, mma.sync in bfloat16 and TF32,
// the TF32 split of 3xTF32, paired stores, and the host's alignment tests
// and once-per-device shared-memory attribute. Included by
// linear_xent.cu, lstm_scan.cu (the attribute), lstm_scan_bwd.cu and,
// through flash_tiles.cuh, by flash_attention.cu and flash_attention_bwd.cu;
// ops/_build.py hashes it into the name of every library whose source
// includes it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// ------------------------------------------------------------------ PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// ldmatrix with each 8 x 8 matrix of 16-bit values transposed on the way
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  // not volatile: the compiler may interleave independent products
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  // not volatile: the compiler may interleave independent products
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a = hi + lo, hi a TF32 value (a's bits rounded to nearest, ties away
// from zero, at the 13th bit from the bottom: an integer add and a mask),
// lo = a - hi (exact) rounded the same way; the tensor core reads the top
// 19 bits of each .tf32 operand, so both enter its products as they are.
// hi.hi + hi.lo + lo.hi then misses lo.lo and lo's rounding, below 2^-22
// of a.b. (cvt.rna.tf32.f32 rounds the same but issues at a quarter of
// the rate; truncating instead, hi = a & mask, left errors of 2^-20 that
// the training checks against the CPU did not hold.) lo is 0 for a value
// that is already TF32-exact. NaN: the add carries a NaN whose mantissa
// is all ones (0x7fffffff, the NaN the card's arithmetic makes) into the
// sign bit, so hi may become -0.0; lo = a - hi is then the card's NaN
// (0x7fffffff, whatever a's sign and payload), and the min() keeps it
// one through lo's add (0x7fffefff is a NaN), so the
// product stays NaN (an infinite a gives NaN too: its lo is inf - inf).
// Finite values keep their bits. The min() costs 1-5% of the xent and
// flash kernels (profile_split_tf32.py); clamping hi as well cost more.
__device__ __forceinline__ void split_tf32(uint32_t a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (a + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(a) - __uint_as_float(hi));
  lo = (static_cast<uint32_t>(min(static_cast<int>(lo), 0x7fffefff)) +
        0x1000u) & 0xffffe000u;
}

// ---------------------------------------------------------------- copies
// one element, zero past the edge: a 4-byte cp.async for float32, a plain
// load and store for bfloat16 (its rows may start 2 bytes off a word)
__device__ __forceinline__ void copy_elem(uint8_t* dst, const float* src,
                                          bool in) {
  cp_async4(dst, src, in ? 4 : 0);
}
__device__ __forceinline__ void copy_elem(uint8_t* dst,
                                          const __nv_bfloat16* src,
                                          bool in) {
  *reinterpret_cast<uint16_t*>(dst) =
      in ? *reinterpret_cast<const uint16_t*>(src) : uint16_t{0};
}

// The copy ring: chunk c's copies are issued kDepth - 1 chunks ahead of
// its products; one wait and one barrier per chunk (the barrier also frees
// the stage that the next copies overwrite). extra(c) may issue more
// copies right after that barrier: they join the group committed with
// chunk c + kDepth - 1, complete once the wait at that chunk returns.
template <int kStageBytes, int kDepth, typename Load, typename Extra,
          typename Consume>
__device__ __forceinline__ void ring(uint8_t* smem, int total, Load&& load,
                                     Extra&& extra, Consume&& consume) {
#pragma unroll
  for (int c = 0; c < kDepth - 1; ++c) {
    if (c < total) load(c, smem + c * kStageBytes);
    cp_async_commit();
  }
  for (int c = 0; c < total; ++c) {
    cp_async_wait<kDepth - 2>();
    __syncthreads();
    extra(c);
    const int next = c + kDepth - 1;
    if (next < total) load(next, smem + (next % kDepth) * kStageBytes);
    cp_async_commit();
    consume(c, smem + (c % kDepth) * kStageBytes);
  }
  cp_async_wait<0>();
}

// two neighbouring columns col, col + 1 of one row of a [., ld] matrix of
// T; pair: ld is even and p aligned to two elements, so one store does
__device__ __forceinline__ void store2(float* p, int col, int ncols,
                                       float v0, float v1, bool pair) {
  if (pair && col + 1 < ncols) {
    *reinterpret_cast<float2*>(p + col) = make_float2(v0, v1);
  } else {
    if (col < ncols) p[col] = v0;
    if (col + 1 < ncols) p[col + 1] = v1;
  }
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, int col, int ncols,
                                       float v0, float v1, bool pair) {
  if (pair && col + 1 < ncols) {
    *reinterpret_cast<__nv_bfloat162*>(p + col) =
        __floats2bfloat162_rn(v0, v1);
  } else {
    if (col < ncols) p[col] = __float2bfloat16_rn(v0);
    if (col + 1 < ncols) p[col + 1] = __float2bfloat16_rn(v1);
  }
}

// ------------------------------------------------------------------ host
bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// p and every row of ld elements of T start on 16 bytes
template <typename T>
bool rows16(const void* p, int ld) {
  return aligned(p, 16) && (static_cast<int64_t>(ld) * sizeof(T)) % 16 == 0;
}

// two neighbouring elements of a row are one aligned store
template <typename T>
bool pairs(const void* p, int ld) {
  return aligned(p, 2 * sizeof(T)) && ld % 2 == 0;
}

// Above 48 KB a block's shared memory must be asked for, per kernel and
// device. The call costs host time, and a training step of the char-RNN is
// host-bound: ask once.
template <auto kKernel>
cudaError_t allow_smem(int device, int bytes) {
  static std::atomic<bool> done[64];
  if (device >= 0 && device < 64 && done[device].load()) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return err;
}

}  // namespace
