// Fused BatchNorm epilogue y = act(x * scale + shift) for Hopper (sm_90a).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas_kernels.py
// `_bn_act_kernel` (pallas_call in `_bn_act_impl`). x is viewed as a dense
// [rows, c] matrix (every leading axis of an NHWC activation collapsed,
// channels contiguous); scale and shift are per-channel float32, cast to
// x's type before the multiply-add exactly as the TPU kernel does.
//
// Bound: device-memory bandwidth. The kernel does 2 operations per element
// and moves 2 * rows * c * itemsize bytes (x read once, y written once), so
// at 3.35 TB/s the least time is bytes / 3.35e12 s; one ResNet-50 forward at
// 224x224 moves 84.7 MB per image in float32 across its 53 calls.
//
// Design for that bound: each thread owns one 16-byte vector of channels
// (4 float32 or 8 bfloat16), loads its scale/shift for those channels once,
// and walks down the rows with a grid stride, so consecutive threads touch
// consecutive 16-byte words and every load and store is coalesced. Any row
// count works (the ragged edge is the loop bound; the TPU kernel refused rows
// not divisible by its block). Channel counts that are not a multiple of the
// vector width, or pointers not 16-byte aligned, take the same loop with one
// element per thread. The launcher's grid covers at most 2048 resident
// threads per SM.
//
// Rounding matches the plain PyTorch epilogue bit for bit: float32 is one
// rounded multiply then one rounded add (no FMA contraction, as PyTorch's
// separate mul and add kernels); bfloat16 rounds the product to bfloat16,
// then adds in float32 and rounds again, as PyTorch's bfloat16 operators do.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_elem(float f, float*) { return f; }
__device__ __forceinline__ __nv_bfloat16 to_elem(float f, __nv_bfloat16*) {
  return __float2bfloat16_rn(f);
}

template <bool RELU>
__device__ __forceinline__ float affine(float x, float s, float h) {
  const float y = __fadd_rn(__fmul_rn(x, s), h);
  // y < 0 (not fmaxf) so a NaN passes through, as jax.nn.relu and torch.relu
  return (RELU && y < 0.0f) ? 0.0f : y;
}

template <bool RELU>
__device__ __forceinline__ __nv_bfloat16 affine(__nv_bfloat16 x,
                                                __nv_bfloat16 s,
                                                __nv_bfloat16 h) {
  const __nv_bfloat16 p = __float2bfloat16_rn(
      __fmul_rn(__bfloat162float(x), __bfloat162float(s)));
  const float y = __fadd_rn(__bfloat162float(p), __bfloat162float(h));
  return (RELU && y < 0.0f) ? __float2bfloat16_rn(0.0f)
                            : __float2bfloat16_rn(y);
}

// One thread per (channel vector, row lane); lanes * vpr threads in all.
template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(kThreads)
    bn_act_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ shift, T* __restrict__ y,
                  int64_t rows, int64_t vpr, int64_t lanes) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= lanes * vpr) return;
  const int64_t cv = g % vpr;
  T s[V], h[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    s[k] = to_elem(scale[cv * V + k], static_cast<T*>(nullptr));
    h[k] = to_elem(shift[cv * V + k], static_cast<T*>(nullptr));
  }
  const Pack<T, V>* xp = reinterpret_cast<const Pack<T, V>*>(x);
  Pack<T, V>* yp = reinterpret_cast<Pack<T, V>*>(y);
  for (int64_t r = g / vpr; r < rows; r += lanes) {
    const int64_t i = r * vpr + cv;
    Pack<T, V> v = xp[i];
#pragma unroll
    for (int k = 0; k < V; ++k) v.v[k] = affine<RELU>(v.v[k], s[k], h[k]);
    yp[i] = v;
  }
}

template <typename T, int V>
cudaError_t launch(const void* x, const void* scale, const void* shift,
                   void* y, int64_t rows, int64_t c, int relu,
                   cudaStream_t stream) {
  const int64_t vpr = c / V;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // enough threads to fill every SM (2048 resident threads each), no more
  // row lanes than rows
  const int64_t target = static_cast<int64_t>(sms) * 2048;
  int64_t lanes = target / vpr;
  if (lanes < 1) lanes = 1;
  if (lanes > rows) lanes = rows;
  const int64_t threads = lanes * vpr;
  const unsigned int blocks =
      static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const float* st = static_cast<const float*>(scale);
  const float* ht = static_cast<const float*>(shift);
  if (relu) {
    bn_act_kernel<T, V, true><<<blocks, kThreads, 0, stream>>>(
        xt, st, ht, yt, rows, vpr, lanes);
  } else {
    bn_act_kernel<T, V, false><<<blocks, kThreads, 0, stream>>>(
        xt, st, ht, yt, rows, vpr, lanes);
  }
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; device: the CUDA device that holds the
// tensors and owns `stream`. Returns the CUDA error code of the launch
// (0 = launched). Launches nothing for an empty input.
int bn_act_launch(const void* x, const void* scale, const void* shift,
                  void* y, int64_t rows, int64_t c, int dtype, int relu,
                  int device, void* stream) {
  if (rows <= 0 || c <= 0) return 0;
  // this library carries its own CUDA runtime, whose current device is
  // per thread and independent of PyTorch's
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // scale/shift are read element by element, once per thread: only x and y
  // take 16-byte vector accesses
  const bool vec = aligned16(x) && aligned16(y);
  if (dtype == 0) {
    if (vec && c % 4 == 0)
      return launch<float, 4>(x, scale, shift, y, rows, c, relu, s);
    return launch<float, 1>(x, scale, shift, y, rows, c, relu, s);
  }
  if (dtype == 1) {
    if (vec && c % 8 == 0)
      return launch<__nv_bfloat16, 8>(x, scale, shift, y, rows, c, relu, s);
    return launch<__nv_bfloat16, 1>(x, scale, shift, y, rows, c, relu, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* bn_act_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
