// Conversions between the kernels' element types (fp32, bf16) and fp32,
// and a store of two adjacent outputs: shared by the int8 lane's kernels
// (int8_gemm.cuh re-exports them as bvt_int8::) and the dequantising
// epilogue of the wgmma GEMM body (wgmma_gemm.cuh).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bvt_cvt {

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// p[0], p[1] = a, b in T (rounded to nearest even for bf16); p 2-element aligned
template <typename T> __device__ __forceinline__ void store2(T* p, float a, float b);
template <> __device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                                  float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

}  // namespace bvt_cvt
