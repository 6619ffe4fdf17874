// Row LayerNorm over the last dim for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel fused_layer_norm / _ln_kernel of
// elasticdiffusion_tpu/kernels/layernorm.py: fp32 mean, centred variance,
// rsqrt(var + eps), affine, cast back to the input type, in one pass over
// the row. Any C is taken (the TPU gate C % 128 == 0, rows % 8 == 0 was a
// Mosaic layout rule).
//
// Bound on this card: bytes (one read and one write of the activation).
// One warp owns one row: it reads the row once from device memory with
// 16-byte loads, parks it as fp32 in shared memory (each lane reads back
// only what it wrote, so no barrier is needed), reduces with shuffles, and
// writes the row once.

#include "vec.cuh"

namespace {

constexpr int WARPS = 4;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(WARPS * 32)
    layernorm_kernel(const T* __restrict__ x, const void* __restrict__ w,
                     const void* __restrict__ bias, int w_bf16,
                     T* __restrict__ y, long long N, int C, float eps) {
  extern __shared__ float sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + warp;
  if (row >= N) return;  // no block-wide barrier below
  const int CV = C / VEC;
  float* buf = sm + warp * C;  // [VEC][CV]: lanes hit neighbouring banks
  const T* xr = x + row * C;
  T* yr = y + row * C;

  float sum = 0.f;
  for (int cv = lane; cv < CV; cv += 32) {
    float v[VEC];
    Vec<T, VEC>::load(xr + cv * VEC, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      buf[e * CV + cv] = v[e];
      sum += v[e];
    }
  }
  const float mean = warp_sum(sum) / C;

  float sq = 0.f;
  for (int cv = lane; cv < CV; cv += 32) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float d = buf[e * CV + cv] - mean;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / C + eps);

  for (int cv = lane; cv < CV; cv += 32) {
    float v[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int c = cv * VEC + e;
      v[e] = (buf[e * CV + cv] - mean) * rstd * load_w(w, c, w_bf16) +
             load_w(bias, c, w_bf16);
    }
    Vec<T, VEC>::store(yr + cv * VEC, v);
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* w, const void* b, int w_bf16,
                   void* y, long long N, int C, float eps,
                   cudaStream_t stream) {
  const size_t smem = (size_t)WARPS * C * sizeof(float);
  auto kernel = layernorm_kernel<T, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (N + WARPS - 1) / WARPS;
  kernel<<<(unsigned)blocks, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(x), w, b, w_bf16, static_cast<T*>(y), N, C, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* ed_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = bf16, 1 = fp32 (of x and y). vectorized: 1 when C is a
// multiple of 16 bytes' worth of elements and x, y are 16-byte aligned.
extern "C" int ed_layer_norm(const void* x, const void* w, const void* b,
                             int w_bf16, void* y, long long N, int C, float eps,
                             int dtype, int vectorized, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(vectorized
                     ? launch<bf16, 8>(x, w, b, w_bf16, y, N, C, eps, st)
                     : launch<bf16, 1>(x, w, b, w_bf16, y, N, C, eps, st));
  if (dtype == 1)
    return (int)(vectorized
                     ? launch<float, 4>(x, w, b, w_bf16, y, N, C, eps, st)
                     : launch<float, 1>(x, w, b, w_bf16, y, N, C, eps, st));
  return -1;
}
