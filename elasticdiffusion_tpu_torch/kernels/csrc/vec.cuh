// Shared helpers of the normalisation kernels: 16-byte vector loads and
// stores that convert to and from fp32, and a weight load that takes fp32
// or bf16 parameters.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) {
    v[0] = *p;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[1]) {
    *p = v[0];
  }
};

template <>
struct Vec<bf16, 8> {
  static __device__ __forceinline__ void load(const bf16* p, float (&v)[8]) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&v)[8]) {
    uint4 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = t;
  }
};

template <>
struct Vec<bf16, 1> {
  static __device__ __forceinline__ void load(const bf16* p, float (&v)[1]) {
    v[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&v)[1]) {
    *p = __float2bfloat16(v[0]);
  }
};

// weight and bias are fp32 or bf16, whichever the module holds
__device__ __forceinline__ float load_w(const void* p, int i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

}  // namespace
