// Shared pieces of the streaming kernels (map.cu, reduce.cu, scan.cu): the
// operator catalogue, the body catalogue, conversions and warp helpers.
//
// A hand-written kernel cannot run a Python closure, so the port's kernels
// take the combining operator and the elementwise body from fixed
// catalogues (kernels/common.py OPS, kernels/map_kernel.py BODIES), each
// entry a functor here. Float arithmetic goes through the _rn intrinsics so
// nvcc never contracts a multiply and an add into one FMA: every operation
// rounds once, as the plain PyTorch versions' separate operations do.
#pragma once

#include <type_traits>

#include "ak_common.cuh"

enum AkOp { AK_ADD = 0, AK_MUL = 1, AK_MIN = 2, AK_MAX = 3, AK_AND = 4,
            AK_OR = 5 };
enum AkBody { AK_IDENTITY = 0, AK_SQUARE = 1, AK_RBF = 2, AK_LJG = 3 };

// Up to six operand pointers, by value (the LJG body reads six arrays).
struct AkOperands { const void* p[6]; };
// Up to six float parameters of a body (LJG: 4 eps, eps, sigma, r0,
// cutoff, 2 * 0.02), already rounded to float32 on the host.
struct AkParams { float p[6]; };

// Accumulator of a value type: float for bfloat16 (exact for min/max, one
// rounding at the end for add/mul), int for bool, the type itself else.
template <typename T> struct AkAcc { typedef T type; };
template <> struct AkAcc<__nv_bfloat16> { typedef float type; };
template <> struct AkAcc<bool> { typedef int type; };

// Conversions, as torch's .to(dtype) does them: through float for
// bfloat16, truncation for float -> int, nonzero for -> bool.
template <typename To, typename From>
__device__ __forceinline__ To ak_cast(From v) {
  if constexpr (std::is_same<To, From>::value) {
    return v;
  } else if constexpr (std::is_same<From, __nv_bfloat16>::value) {
    return ak_cast<To, float>(__bfloat162float(v));
  } else if constexpr (std::is_same<To, __nv_bfloat16>::value) {
    return __float2bfloat16_rn(ak_cast<float, From>(v));
  } else if constexpr (std::is_same<To, bool>::value) {
    return v != From(0);
  } else if constexpr (std::is_same<To, float>::value &&
                       std::is_same<From, int32_t>::value) {
    return __int2float_rn(v);
  } else if constexpr (std::is_same<To, int32_t>::value &&
                       std::is_same<From, float>::value) {
    return __float2int_rz(v);
  } else {
    return static_cast<To>(v);
  }
}

template <typename A>
__device__ __forceinline__ A ak_from_double(double d) {
  if constexpr (std::is_same<A, float>::value) return (float)d;
  else return (A)(long long)d;
}

template <int OP> struct AkOpF;
template <> struct AkOpF<AK_ADD> {
  __device__ static float apply(float a, float b) { return __fadd_rn(a, b); }
  __device__ static int apply(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);  // wraps, as torch's int32 add
  }
};
template <> struct AkOpF<AK_MUL> {
  __device__ static float apply(float a, float b) { return __fmul_rn(a, b); }
  __device__ static int apply(int a, int b) {
    return (int)((unsigned)a * (unsigned)b);
  }
};
// min/max propagate NaN, as torch.minimum/maximum, cummin/cummax and the
// reference's jnp.minimum/maximum do: a NaN operand wins (b != b is false
// for integers).
template <> struct AkOpF<AK_MIN> {
  template <typename A> __device__ static A apply(A a, A b) {
    return (b < a || b != b) ? b : a;
  }
};
template <> struct AkOpF<AK_MAX> {
  template <typename A> __device__ static A apply(A a, A b) {
    return (a < b || b != b) ? b : a;
  }
};
template <> struct AkOpF<AK_AND> {
  __device__ static int apply(int a, int b) { return (a != 0) & (b != 0); }
};
template <> struct AkOpF<AK_OR> {
  __device__ static int apply(int a, int b) { return (a != 0) | (b != 0); }
};

// ---------------------------------------------------------------------------
// Bodies: out = body(operands[i], params). Each computes in the operands'
// type T and is the kernel twin of a plain torch function in map_kernel.py.
// ---------------------------------------------------------------------------

template <int BODY> struct AkBodyF;

template <> struct AkBodyF<AK_IDENTITY> {
  template <typename T>
  __device__ static T apply(const AkOperands& o, long long i,
                            const AkParams&) {
    return static_cast<const T*>(o.p[0])[i];
  }
};

template <> struct AkBodyF<AK_SQUARE> {
  template <typename T>
  __device__ static T apply(const AkOperands& o, long long i,
                            const AkParams&) {
    const T x = static_cast<const T*>(o.p[0])[i];
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      const float f = __bfloat162float(x);
      return __float2bfloat16_rn(__fmul_rn(f, f));
    } else {
      return AkOpF<AK_MUL>::apply(x, x);
    }
  }
};

// Paper Table II, Algorithm 4: rbf = exp(-1 / (1 - sqrt(x^2 + y^2 + z^2))).
template <> struct AkBodyF<AK_RBF> {
  template <typename T>
  __device__ static T apply(const AkOperands& o, long long i,
                            const AkParams&) {
    static_assert(std::is_same<T, float>::value, "rbf is float32 only");
    const float x = static_cast<const float*>(o.p[0])[i];
    const float y = static_cast<const float*>(o.p[1])[i];
    const float z = static_cast<const float*>(o.p[2])[i];
    const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                               __fmul_rn(z, z));
    const float r = __fsqrt_rn(r2);
    return expf(__fdiv_rn(-1.0f, __fsub_rn(1.0f, r)));
  }
};

// Paper Table II, Algorithm 5: Lennard-Jones-Gauss with the cutoff branch.
// params: 4 eps, eps, sigma, r0, cutoff, 2 * 0.02 (the Gaussian's width).
template <> struct AkBodyF<AK_LJG> {
  template <typename T>
  __device__ static T apply(const AkOperands& o, long long i,
                            const AkParams& q) {
    static_assert(std::is_same<T, float>::value, "ljg is float32 only");
    const float* const* p = reinterpret_cast<const float* const*>(o.p);
    const float dx = __fsub_rn(p[0][i], p[3][i]);
    const float dy = __fsub_rn(p[1][i], p[4][i]);
    const float dz = __fsub_rn(p[2][i], p[5][i]);
    const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
    const float r = __fsqrt_rn(r2);
    const float sr = __fdiv_rn(q.p[2], r);
    const float sr3 = __fmul_rn(__fmul_rn(sr, sr), sr);
    const float sr6 = __fmul_rn(sr3, sr3);
    const float sr12 = __fmul_rn(sr6, sr6);
    const float lj = __fmul_rn(q.p[0], __fsub_rn(sr12, sr6));
    const float d = __fsub_rn(r, q.p[3]);
    const float gauss = __fmul_rn(q.p[1], expf(__fdiv_rn(-__fmul_rn(d, d),
                                                          q.p[5])));
    const float u = __fsub_rn(lj, gauss);
    return r < q.p[4] ? u : 0.0f;
  }
};

// Calls f(BodyTag<B>, TypeTag<T>) for a valid (body, dtype) pair of the
// catalogue; returns cudaErrorInvalidValue for any other.
template <int B> struct AkBodyTag { static constexpr int value = B; };
template <typename T> struct AkTypeTag { typedef T type; };

template <typename F>
int ak_with_body(int body, int dtype, F&& f) {
  switch (body) {
    case AK_IDENTITY:
    case AK_SQUARE: {
      auto g = [&](auto tt) {
        return body == AK_IDENTITY ? f(AkBodyTag<AK_IDENTITY>{}, tt)
                                   : f(AkBodyTag<AK_SQUARE>{}, tt);
      };
      switch (dtype) {
        case AK_F32: return g(AkTypeTag<float>{});
        case AK_I32: return g(AkTypeTag<int32_t>{});
        case AK_BF16: return g(AkTypeTag<__nv_bfloat16>{});
      }
      break;
    }
    case AK_RBF:
      if (dtype == AK_F32) return f(AkBodyTag<AK_RBF>{}, AkTypeTag<float>{});
      break;
    case AK_LJG:
      if (dtype == AK_F32) return f(AkBodyTag<AK_LJG>{}, AkTypeTag<float>{});
      break;
  }
  return (int)cudaErrorInvalidValue;
}

template <typename F>
int ak_with_type(int dtype, F&& f) {
  switch (dtype) {
    case AK_F32: return f(AkTypeTag<float>{});
    case AK_I32: return f(AkTypeTag<int32_t>{});
    case AK_BF16: return f(AkTypeTag<__nv_bfloat16>{});
  }
  return (int)cudaErrorInvalidValue;
}

constexpr unsigned kAkFullMask = 0xffffffffu;

// Fold of a warp's 32 values into lane 0 (a fixed tree: deterministic).
template <int OP, typename A>
__device__ __forceinline__ A ak_warp_fold(A v) {
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1)
    v = AkOpF<OP>::apply(v, __shfl_down_sync(kAkFullMask, v, d));
  return v;
}
