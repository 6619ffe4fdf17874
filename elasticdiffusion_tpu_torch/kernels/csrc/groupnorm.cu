// NHWC GroupNorm with optional fused SiLU for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernels fused_group_norm / _stats_kernel /
// _apply_kernel of elasticdiffusion_tpu/kernels/groupnorm.py: per-channel
// sum and sum of squares in fp32, group moments var = E[x^2] - E[x]^2, then
// x * scale + shift (and SiLU) with the output in the input type.
//
// The TPU kernel carries its sums across a sequential grid. Blocks on this
// card run in no order, so the reduction is three launches with no atomics
// (the sum order is fixed, results repeat from run to run):
//   gn_stats     grid (chunks, B, channel blocks): a block reads a chunk of
//                rows of one image, every thread keeps one 16-byte channel
//                vector and walks down the rows, so loads are coalesced
//                along C; per-channel partial sums go to a small buffer.
//   gn_finalize  grid (groups, B): adds the partials of a group's channels
//                over all chunks and writes per-(b, c) scale and shift.
//   gn_apply     elementwise over 16-byte vectors, grid-stride.
//
// Bound on this card: bytes. The activation is read twice (stats, apply)
// and written once; the bound counts one read and one write, so the design
// sits at 1.5x of it at best. Keeping a whole (b, group) slab on chip
// between the two reads is the known next step.

#include "vec.cuh"

namespace {

constexpr int STATS_THREADS = 256;
constexpr int FINAL_THREADS = 128;
constexpr int APPLY_THREADS = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(STATS_THREADS)
    gn_stats(const T* __restrict__ x, float* __restrict__ partial, int S, int C,
             int rows_per_chunk, int TX, int TY) {
  extern __shared__ float sm[];  // [TY][TX][2 * VEC]
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int CV = C / VEC;
  const int cv = blockIdx.z * TX + tx;
  const int chunk = blockIdx.x, nchunks = gridDim.x, b = blockIdx.y;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(S, r0 + rows_per_chunk);

  float s[VEC], q[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) s[e] = q[e] = 0.f;
  if (cv < CV && ty < TY) {
    const T* base = x + ((long long)b * S) * C + cv * VEC;
    for (int r = r0 + ty; r < r1; r += TY) {
      float v[VEC];
      Vec<T, VEC>::load(base + (long long)r * C, v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        s[e] += v[e];
        q[e] = fmaf(v[e], v[e], q[e]);
      }
    }
  }
  if (ty < TY) {
    float* mine = sm + (ty * TX + tx) * 2 * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      mine[e] = s[e];
      mine[VEC + e] = q[e];
    }
  }
  __syncthreads();
  if (ty == 0 && cv < CV) {
    for (int t = 1; t < TY; ++t) {
      const float* other = sm + (t * TX + tx) * 2 * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        s[e] += other[e];
        q[e] += other[VEC + e];
      }
    }
    float* dst = partial + (((long long)b * nchunks + chunk) * 2) * C + cv * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      dst[e] = s[e];
      dst[C + e] = q[e];
    }
  }
}

__global__ void __launch_bounds__(FINAL_THREADS)
    gn_finalize(const float* __restrict__ partial, const void* __restrict__ w,
                const void* __restrict__ bias, int w_bf16,
                float* __restrict__ scale, float* __restrict__ shift, int S,
                int C, int G, int nchunks, float eps) {
  __shared__ float red[2][FINAL_THREADS];
  const int g = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int gs = C / G, c0 = g * gs;
  float s = 0.f, q = 0.f;
  for (int i = tid; i < nchunks * gs; i += FINAL_THREADS) {
    const int ch = i / gs, cc = i % gs;
    const float* src = partial + (((long long)b * nchunks + ch) * 2) * C + c0 + cc;
    s += src[0];
    q += src[C];
  }
  red[0][tid] = s;
  red[1][tid] = q;
  __syncthreads();
  for (int off = FINAL_THREADS / 2; off > 0; off >>= 1) {
    if (tid < off) {
      red[0][tid] += red[0][tid + off];
      red[1][tid] += red[1][tid + off];
    }
    __syncthreads();
  }
  const float cnt = (float)S * (float)gs;
  const float mean = red[0][0] / cnt;
  const float var = red[1][0] / cnt - mean * mean;
  const float inv = rsqrtf(var + eps);
  for (int cc = tid; cc < gs; cc += FINAL_THREADS) {
    const int c = c0 + cc;
    const float sc = load_w(w, c, w_bf16) * inv;
    scale[(long long)b * C + c] = sc;
    shift[(long long)b * C + c] = load_w(bias, c, w_bf16) - mean * sc;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(APPLY_THREADS)
    gn_apply(const T* __restrict__ x, const float* __restrict__ scale,
             const float* __restrict__ shift, T* __restrict__ y,
             long long total_vecs, long long vecs_per_image, int C, int silu) {
  const int CV = C / VEC;
  const long long stride = (long long)gridDim.x * APPLY_THREADS;
  for (long long i = (long long)blockIdx.x * APPLY_THREADS + threadIdx.x;
       i < total_vecs; i += stride) {
    const long long b = i / vecs_per_image;
    const int cv = (int)(i % CV);
    const float* sc = scale + b * C + cv * VEC;
    const float* sh = shift + b * C + cv * VEC;
    float v[VEC];
    Vec<T, VEC>::load(x + i * VEC, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float o = fmaf(v[e], sc[e], sh[e]);
      if (silu) o = o / (1.f + expf(-o));
      v[e] = o;
    }
    Vec<T, VEC>::store(y + i * VEC, v);
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* w, const void* bias, int w_bf16,
                   void* y, float* partial, float* scale, float* shift, int B,
                   int S, int C, int G, int nchunks, float eps, int silu,
                   cudaStream_t stream) {
  const int CV = C / VEC;
  const int TX = CV < STATS_THREADS ? CV : STATS_THREADS;
  const int TY = STATS_THREADS / TX;
  const int ZC = (CV + TX - 1) / TX;
  const int rows_per_chunk = (S + nchunks - 1) / nchunks;
  const size_t smem = (size_t)TY * TX * 2 * VEC * sizeof(float);
  gn_stats<T, VEC><<<dim3(nchunks, B, ZC), STATS_THREADS, smem, stream>>>(
      static_cast<const T*>(x), partial, S, C, rows_per_chunk, TX, TY);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_finalize<<<dim3(G, B), FINAL_THREADS, 0, stream>>>(
      partial, w, bias, w_bf16, scale, shift, S, C, G, nchunks, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long vecs_per_image = (long long)S * CV;
  const long long total = vecs_per_image * B;
  long long blocks = (total + APPLY_THREADS - 1) / APPLY_THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;
  gn_apply<T, VEC><<<(unsigned)blocks, APPLY_THREADS, 0, stream>>>(
      static_cast<const T*>(x), scale, shift, static_cast<T*>(y), total,
      vecs_per_image, C, silu);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* ed_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y: (B, S, C) contiguous, S = H * W. partial: (B, nchunks, 2, C) fp32
// scratch; scale, shift: (B, C) fp32 scratch. dtype: 0 = bf16, 1 = fp32.
// vectorized: 1 when C is a multiple of 16 bytes' worth of elements and x,
// y are 16-byte aligned.
extern "C" int ed_group_norm(const void* x, const void* w, const void* bias,
                             int w_bf16, void* y, void* partial, void* scale,
                             void* shift, int B, int S, int C, int G,
                             int nchunks, float eps, int silu, int dtype,
                             int vectorized, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(partial);
  float* sc = static_cast<float*>(scale);
  float* sh = static_cast<float*>(shift);
  if (dtype == 0)
    return (int)(vectorized ? launch<bf16, 8>(x, w, bias, w_bf16, y, pp, sc, sh,
                                              B, S, C, G, nchunks, eps, silu, st)
                            : launch<bf16, 1>(x, w, bias, w_bf16, y, pp, sc, sh,
                                              B, S, C, G, nchunks, eps, silu, st));
  if (dtype == 1)
    return (int)(vectorized ? launch<float, 4>(x, w, bias, w_bf16, y, pp, sc, sh,
                                               B, S, C, G, nchunks, eps, silu, st)
                            : launch<float, 1>(x, w, bias, w_bf16, y, pp, sc, sh,
                                               B, S, C, G, nchunks, eps, silu, st));
  return -1;
}
