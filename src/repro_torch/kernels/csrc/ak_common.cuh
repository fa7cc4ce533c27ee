// Key types shared by the kernels of this directory: float32, int32 and
// bfloat16, the dtypes of the reference's sort, histogram and search
// kernels. bfloat16 keys are compared through __bfloat162float. int64 keys
// (AK_I64) reach only the bitonic network, key-only: sortperm_lowmem's
// widened (key bits << 32) | index keys.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// dtype codes passed from Python (kernels/_dtypes in each wrapper)
// AK_BOOL only as the output of a logical reduction (kernels/_build.py)
enum AkDtype { AK_F32 = 0, AK_I32 = 1, AK_BF16 = 2, AK_BOOL = 3, AK_I64 = 4 };

template <typename K>
__device__ __forceinline__ float ak_to_float(K v) { return (float)v; }
template <>
__device__ __forceinline__ float ak_to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename K>
__device__ __forceinline__ bool ak_lt(K a, K b) { return a < b; }
template <>
__device__ __forceinline__ bool ak_lt<__nv_bfloat16>(__nv_bfloat16 a,
                                                     __nv_bfloat16 b) {
  return __bfloat162float(a) < __bfloat162float(b);
}

template <typename K>
__device__ __forceinline__ bool ak_eq(K a, K b) { return a == b; }
template <>
__device__ __forceinline__ bool ak_eq<__nv_bfloat16>(__nv_bfloat16 a,
                                                     __nv_bfloat16 b) {
  return __bfloat162float(a) == __bfloat162float(b);
}

// Raw bits of a key, for partial results read back across CTAs.
template <typename K> struct AkBits;
template <> struct AkBits<float> {
  typedef unsigned int T;
  __device__ static T to(float v) { return __float_as_uint(v); }
  __device__ static float from(T b) { return __uint_as_float(b); }
};
template <> struct AkBits<int32_t> {
  typedef unsigned int T;
  __device__ static T to(int32_t v) { return (unsigned int)v; }
  __device__ static int32_t from(T b) { return (int32_t)b; }
};
template <> struct AkBits<__nv_bfloat16> {
  typedef unsigned short T;
  __device__ static T to(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }
  __device__ static __nv_bfloat16 from(T b) { return __ushort_as_bfloat16(b); }
};

// Type-max / type-min (+-inf for floats), the reference's sentinels.
template <typename K> struct AkLimits;
template <> struct AkLimits<float> {
  __device__ static float max() { return __int_as_float(0x7f800000); }
  __device__ static float min() { return __int_as_float(0xff800000); }
};
template <> struct AkLimits<int32_t> {
  __device__ static int32_t max() { return 0x7fffffff; }
  __device__ static int32_t min() { return (int32_t)0x80000000; }
};
template <> struct AkLimits<__nv_bfloat16> {
  __device__ static __nv_bfloat16 max() { return __ushort_as_bfloat16(0x7f80); }
  __device__ static __nv_bfloat16 min() { return __ushort_as_bfloat16(0xff80); }
};

#define AK_EXPORT extern "C" __attribute__((visibility("default")))

// Each library of this directory is built from one .cu that includes this
// header once, so every library carries its own copy.
AK_EXPORT const char* ak_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
