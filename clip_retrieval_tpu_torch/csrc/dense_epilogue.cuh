// The arithmetic a dense applies after its product, one element at a time:
// the f32 accumulator plus the f32 bias, rounded to the output type, the
// activation, then the residual added.  Both kernels that end a dense include
// it, so that they compute each element alike by construction:
// `crt_dense_epilogue` (block_fused.cu), which reads an f32 accumulator that
// cuBLAS wrote, and `crt_dense_gemm` (dense_gemm.cu), which applies it to the
// accumulator in its own registers.
//
// Rounding follows the eager chain, so the port keeps the JAX package's
// casting points: t = round(acc + b); each activation rounds where its eager
// ops store a tensor (quick_gelu: round(1.702·t), round(sigmoid), round of
// the product; GELU and tanh GELU once, from the same f32 formulas as
// PyTorch's CUDA kernels); the caller rounds res + t where it stores.  In f32
// the rounding is the identity.

#pragma once

#include <cuda_bf16.h>

namespace {

enum Act { kNone = 0, kQuickGelu = 1, kGelu = 2, kGeluTanh = 3 };

// where the eager chain stores a tensor of type T: round to T and back
template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) { return x; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// The activation on t (already rounded to T), with the eager ops' own
// roundings inside; the caller rounds the result.  The f32 formulas are those
// of PyTorch's CUDA kernels (sigmoid, and GeluCUDAKernelImpl for both GELUs).
template <typename T, int ACT>
__device__ __forceinline__ float activation(float t) {
  if constexpr (ACT == kQuickGelu) {
    const float u = rnd<T>(t * 1.702f);                 // 1.702 * x
    const float s = rnd<T>(1.0f / (1.0f + expf(-u)));    // torch.sigmoid
    return t * s;
  } else if constexpr (ACT == kGelu) {
    constexpr float kAlpha = 0.70710678118654752440;     // M_SQRT1_2
    return t * 0.5f * (1.0f + erff(t * kAlpha));
  } else if constexpr (ACT == kGeluTanh) {
    constexpr float kBeta = 1.41421356237309504880 * 1.12837916709551257390 * 0.5;  // M_SQRT2 * M_2_SQRTPI / 2
    constexpr float kKappa = 0.044715;
    const float cube = t * t * t;
    const float inner = kBeta * (t + kKappa * cube);
    return 0.5f * t * (1.0f + tanhf(inner));
  } else {
    return t;
  }
}

// The two halves of one element's epilogue: t = round(acc + b), then, before
// the output's last rounding, res + round(act(t)).  `dense_gemm.cu` rounds t
// in the warps that hold the accumulator and runs the second half in others.
template <typename T>
__device__ __forceinline__ float epilogue_sum(float acc, float b) { return rnd<T>(acc + b); }

template <typename T, int ACT>
__device__ __forceinline__ float epilogue_act(float t, bool has_res, float res) {
  if constexpr (ACT != kNone) t = rnd<T>(activation<T, ACT>(t));
  return has_res ? res + t : t;
}

// One element of the output before its last rounding: res + act(round(acc + b)).
template <typename T, int ACT>
__device__ __forceinline__ float epilogue_one(float acc, float b, bool has_res, float res) {
  return epilogue_act<T, ACT>(epilogue_sum<T>(acc, b), has_res, res);
}

}  // namespace
