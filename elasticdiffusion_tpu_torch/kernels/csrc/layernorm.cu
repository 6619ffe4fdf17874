// Row LayerNorm over the last dim for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel fused_layer_norm / _ln_kernel of
// elasticdiffusion_tpu/kernels/layernorm.py: fp32 mean, centred variance,
// rsqrt(var + eps), affine, cast back to the input type, in one pass over
// the row. Any C is taken (the TPU gate C % 128 == 0, rows % 8 == 0 was a
// Mosaic layout rule).
//
// Bound on this card: bytes (one read and one write of the activation).
//
// layernorm_rows, the body of the widths on the paths (320, 640, 768, 1024,
// 1280 channels: the UNet transformer blocks and CLIP), and what it does
// about that bound:
//   * The width is a template parameter. LPR lanes share a row (8, 16 or 32:
//     the most that divide the row's 16-byte chunks evenly), so every lane
//     holds the same number VPL of chunks, neighbouring lanes on
//     neighbouring 16 bytes. The loop over a row is unrolled and all VPL
//     loads are issued before the first shuffle.
//   * The row stays in registers: mean, then the centred variance from the
//     same registers, then the affine; no shared-memory round trip.
//   * Weight and bias are read once per block as 16-byte vectors, kept in
//     shared memory as fp32 (the block walks many rows).
//   * A persistent grid (as many blocks as fit on the SMs) walks the rows;
//     each lane loads its next row's chunks before it reduces the current
//     one, so a row's loads are in flight under the previous row's math.
//   * The grid size and the shared-memory attribute are found once a
//     process, not at every launch.
//
// layernorm_any, every other width and unaligned rows: one warp a row, the
// row parked as fp32 in shared memory (each lane reads back only what it
// wrote), weight and bias read per element.

#include "vec.cuh"

namespace {

constexpr int THREADS = 256;

// A 16-byte chunk held as four words, unpacked to fp32 in registers.
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int VEC = 4;
  static __device__ __forceinline__ void unpack(const uint4& u,
                                                float (&f)[4]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

template <>
struct Chunk<bf16> {
  static constexpr int VEC = 8;
  // a bf16 is the upper half of an fp32; the lower address is the low half
  static __device__ __forceinline__ void unpack(const uint4& u,
                                                float (&f)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <int LANES>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 8 parameters from fp32 or bf16 storage, as 16-byte vectors
__device__ __forceinline__ void load_param8(const void* p, int i, int is_bf16,
                                            float* dst) {
  if (is_bf16) {
    float v[8];
    Vec<bf16, 8>::load(static_cast<const bf16*>(p) + i, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[e] = v[e];
  } else {
    float v[4];
    Vec<float, 4>::load(static_cast<const float*>(p) + i, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[e] = v[e];
    Vec<float, 4>::load(static_cast<const float*>(p) + i + 4, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[4 + e] = v[e];
  }
}

template <typename T, int C, int LPR>
__global__ void __launch_bounds__(THREADS)
    layernorm_rows(const T* __restrict__ x, const void* __restrict__ w,
                   const void* __restrict__ bias, int w_bf16,
                   T* __restrict__ y, long long N, float eps) {
  constexpr int VEC = Chunk<T>::VEC;        // elements a 16-byte chunk
  constexpr int VPL = C / (VEC * LPR);      // chunks a lane
  static_assert(VPL * VEC * LPR == C && C % 8 == 0, "width");
  __shared__ __align__(16) float w_s[C];
  __shared__ __align__(16) float b_s[C];
  for (int i = threadIdx.x * 8; i < C; i += THREADS * 8) {
    load_param8(w, i, w_bf16, w_s + i);
    load_param8(bias, i, w_bf16, b_s + i);
  }
  __syncthreads();

  const int sub = threadIdx.x % LPR;  // lane within the row's group
  const long long groups = (long long)gridDim.x * (THREADS / LPR);
  long long row = (long long)blockIdx.x * (THREADS / LPR) + threadIdx.x / LPR;
  // chunk v of a lane: elements (v * LPR + sub) * VEC ... + VEC of the row
  uint4 cur[VPL], nxt[VPL];
  if (row < N) {
#pragma unroll
    for (int v = 0; v < VPL; ++v)
      cur[v] = __ldg(reinterpret_cast<const uint4*>(
          x + row * C + (v * LPR + sub) * VEC));
  }
  for (; row < N; row += groups) {
    const long long next = row + groups;
    if (next < N) {
#pragma unroll
      for (int v = 0; v < VPL; ++v)
        nxt[v] = __ldg(reinterpret_cast<const uint4*>(
            x + next * C + (v * LPR + sub) * VEC));
    }
    float f[VPL][VEC];
    float sum = 0.f;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      Chunk<T>::unpack(cur[v], f[v]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) sum += f[v][e];
    }
    const float mean = group_sum<LPR>(sum) * (1.f / C);
    float sq = 0.f;
#pragma unroll
    for (int v = 0; v < VPL; ++v)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        f[v][e] -= mean;
        sq += f[v][e] * f[v][e];
      }
    const float rstd = rsqrtf(group_sum<LPR>(sq) * (1.f / C) + eps);
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int c0 = (v * LPR + sub) * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        f[v][e] = f[v][e] * rstd * w_s[c0 + e] + b_s[c0 + e];
      Vec<T, VEC>::store(y + row * C + c0, f[v]);
    }
#pragma unroll
    for (int v = 0; v < VPL; ++v) cur[v] = nxt[v];
  }
}

// Blocks of the persistent grid: as many as fit on the card at once.
template <typename Kernel>
int resident_blocks(Kernel kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                    0) != cudaSuccess)
    return 0;
  return sms * (per_sm > 0 ? per_sm : 1);
}

template <typename T, int C, int LPR>
cudaError_t launch_rows(const void* x, const void* w, const void* b,
                        int w_bf16, void* y, long long N, float eps,
                        cudaStream_t stream) {
  auto kernel = layernorm_rows<T, C, LPR>;
  static int resident = 0;  // found once a process for each instantiation
  if (resident == 0) resident = resident_blocks(kernel);
  if (resident == 0) {
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? err : cudaErrorInvalidConfiguration;
  }
  const long long needed = (N + THREADS / LPR - 1) / (THREADS / LPR);
  const int blocks = (int)(needed < resident ? needed : resident);
  kernel<<<blocks, THREADS, 0, stream>>>(static_cast<const T*>(x), w, b,
                                         w_bf16, static_cast<T*>(y), N, eps);
  return cudaGetLastError();
}

constexpr int ANY_WARPS = 4;

__device__ __forceinline__ float warp_sum(float v) { return group_sum<32>(v); }

template <typename T, int VEC>
__global__ void __launch_bounds__(ANY_WARPS * 32)
    layernorm_any(const T* __restrict__ x, const void* __restrict__ w,
                  const void* __restrict__ bias, int w_bf16,
                  T* __restrict__ y, long long N, int C, float eps) {
  extern __shared__ float sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * ANY_WARPS + warp;
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
cudaError_t launch_any(const void* x, const void* w, const void* b,
                       int w_bf16, void* y, long long N, int C, float eps,
                       cudaStream_t stream) {
  const size_t smem = (size_t)ANY_WARPS * C * sizeof(float);
  auto kernel = layernorm_any<T, VEC>;
  static size_t allowed = 48 * 1024;  // raised once, when a row needs more
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const long long blocks = (N + ANY_WARPS - 1) / ANY_WARPS;
  kernel<<<(unsigned)blocks, ANY_WARPS * 32, smem, stream>>>(
      static_cast<const T*>(x), w, b, w_bf16, static_cast<T*>(y), N, C, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* ed_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = bf16, 1 = fp32 (of x and y). plan: 1 = layernorm_rows, for a
// width instantiated below and 16-byte aligned x, y, w, b; 0 =
// layernorm_any, vectorized (1) when C is a multiple of 16 bytes' worth of
// elements and x, y are 16-byte aligned. Returns a cudaError_t, or -1 for a
// (dtype, width) that has no instantiation of layernorm_rows.
extern "C" int ed_layer_norm(const void* x, const void* w, const void* b,
                             int w_bf16, void* y, long long N, int C, float eps,
                             int dtype, int plan, int vectorized,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plan == 1) {
// per width: lanes a row in bf16, in fp32
#define ED_LN_ROWS(CC, LPR_BF16, LPR_F32)                                     \
  if (C == CC)                                                                \
    return (int)(dtype == 0                                                   \
                     ? launch_rows<bf16, CC, LPR_BF16>(x, w, b, w_bf16, y, N, \
                                                       eps, st)               \
                     : launch_rows<float, CC, LPR_F32>(x, w, b, w_bf16, y, N, \
                                                       eps, st));
    if (dtype != 0 && dtype != 1) return -1;
    ED_LN_ROWS(320, 8, 16)
    ED_LN_ROWS(640, 16, 32)
    ED_LN_ROWS(768, 32, 32)
    ED_LN_ROWS(1024, 32, 32)
    ED_LN_ROWS(1280, 32, 32)
#undef ED_LN_ROWS
    return -1;
  }
  if (dtype == 0)
    return (int)(vectorized
                     ? launch_any<bf16, 8>(x, w, b, w_bf16, y, N, C, eps, st)
                     : launch_any<bf16, 1>(x, w, b, w_bf16, y, N, C, eps, st));
  if (dtype == 1)
    return (int)(vectorized
                     ? launch_any<float, 4>(x, w, b, w_bf16, y, N, C, eps, st)
                     : launch_any<float, 1>(x, w, b, w_bf16, y, N, C, eps, st));
  return -1;
}
