// NHWC GroupNorm with optional fused SiLU for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernels fused_group_norm / _stats_kernel /
// _apply_kernel of elasticdiffusion_tpu/kernels/groupnorm.py: per-channel
// sum and sum of squares in fp32, group moments var = E[x^2] - E[x]^2, then
// x * scale + shift (and SiLU) with the output in the input type.
//
// Bound on this card: bytes, one read and one write of the activation. The
// TPU kernel reads it twice (statistics, then apply) and carries its sums
// across a sequential grid; blocks here run in no order, and a sum across
// blocks needs either a second pass or blocks that can see each other.
// groupnorm_plan in kernels/groupnorm.py mirrors the choice below.
//
// gn_cluster (plan 1), one launch, one read, one write. A cluster of 1-16
// blocks owns one (image, span) slab at a time: all rows of a span of whole
// groups, a whole number of 16-byte chunks wide. The grid is persistent (as
// many clusters as the card holds), and each cluster walks its slabs. Each
// block
//   * loads its share of the slab's rows into shared memory in TMA boxes of
//     BOX_ROWS rows x span channels (a 3-D tensor map over (C, S, B));
//   * sums per channel in fp32, a thread over its own chunk column, then
//     over its threads in a fixed order (partitions, then the partitions in
//     order), then over the channels of each group (a warp a group sum);
//   * adds the blocks' group sums through distributed shared memory in rank
//     order, so every block of the cluster holds the same bits;
//   * normalises its rows from shared memory and writes them with
//     chunk-wide stores straight from registers.
// The plan prefers spans a whole number of 32-byte sectors wide: where a
// sector is split between the spans of two blocks, a copy through shared
// memory moved about half the bytes a second on the H100. Storing from
// registers was faster there than writing the slab back to shared memory
// for a TMA store. A second slab buffer (the next slab loading while the
// current one is reduced and written) was no faster than the blocks an SM
// that one buffer leaves room for. No block leaves while a peer may still
// read its sums (a cluster barrier before the exit, and the sums
// double-buffered by slab parity). The grid walks the spans of one image
// before the next image.
//
// gn_stats + gn_apply (plan 2), two launches, for slabs too large for a
// cluster's shared memory (the VAE decoders at 512x768 px and above, the
// fp32 strip encodes at 1024 px). gn_stats: grid (chunks, B, channel
// blocks); a thread keeps one channel vector and walks down the rows of its
// chunk, UNROLL loads in flight; the block's per-channel partial sums go to a
// buffer, and the last block of an image to finish (a counter per image,
// reset by that block) adds the partials in chunk order and writes scale and
// shift. gn_apply walks the rows in reverse order, so the rows the
// statistics read last are read again first, from L2.
//
// No sum is taken with atomics: results repeat from run to run.

#include <cooperative_groups.h>

#include "sm90.cuh"
#include "vec.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may have
constexpr int UNROLL = 8;         // rows in flight a thread, gn_stats
constexpr int APPLY_BYTES = 32 * 1024;  // bytes a gn_apply block moves
constexpr int BOX_ROWS = 64;      // rows a TMA box, cluster body

// ---------------------------------------------------------------------------
// 16-byte chunks <-> fp32 elements; a bf16 is the upper half of an fp32,
// and the lower address is the low half of a word
// ---------------------------------------------------------------------------

template <typename T>
struct Chunk16;

template <>
struct Chunk16<float> {
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Chunk16<bf16> {
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// x * sigmoid(x) with the fast exponential and division (a few ulps, well
// inside the comparisons' band)
__device__ __forceinline__ float silu_f(float o) {
  return __fdividef(o, 1.f + __expf(-o));
}

// ---------------------------------------------------------------------------
// plan 1: a cluster a slab, persistent
// ---------------------------------------------------------------------------

// One box of a (C, S, B) tensor map into shared memory, completion counted
// in bytes on the mbarrier.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    gn_cluster(const __grid_constant__ CUtensorMap xmap,
               const void* __restrict__ w, const void* __restrict__ bias,
               int w_bf16, T* __restrict__ y, int S, int C, int gs, int span,
               int rows_per_cta, int units, float eps, int silu) {
  constexpr int VEC = 16 / sizeof(T);               // elements a chunk
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / csize, nclusters = gridDim.x / csize;
  const int nspans = C / span;
  const int sg = span / gs;                         // groups a span
  const int span_bytes = span * (int)sizeof(T);
  const int nch = span_bytes / 16;                  // chunks a row
  const int ncol = 2 * span;                        // sums, then squares
  const int TY = THREADS / nch;
  const int P = ncol < THREADS ? THREADS / ncol : 1;  // partitions of TY
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ci = tid % nch, k = tid / nch;
  const int r0 = rank * rows_per_cta;
  const int rows = max(0, min(S, r0 + rows_per_cta) - r0);
  const int nbox = (rows + BOX_ROWS - 1) / BOX_ROWS;
  // rows k, k + TY, ... of this block's share belong to this thread: it
  // sums them, normalises them and writes them out
  const int mine = (k < TY && rows > k) ? (rows - k + TY - 1) / TY : 0;

  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // the slab is in
  unsigned char* data = smem + 128;
  float* red1 = reinterpret_cast<float*>(
      data + ((rows_per_cta * span_bytes + 127) & ~127));  // [TY][ncol]
  float* red2 = red1 + TY * ncol;                   // [P][ncol]
  float* part = red2 + P * ncol;                    // [2][2 sg], by parity
  float* tot = part + 4 * sg;                       // [2 sg]

  const long long row_bytes = (long long)C * sizeof(T);
  const long long step_g = (long long)TY * row_bytes;  // my rows, in memory
  const int step_s = TY * nch * 16;                     // and in shared memory
  const int my_s = (k * nch + ci) * 16;
  auto offset = [&](int u) {
    return ((long long)(u / nspans) * S + r0 + k) * row_bytes +
           (long long)(u % nspans) * span_bytes + ci * 16;
  };
  // a slab into shared memory: TMA boxes issued by one thread
  auto stage = [&](int u) {
    if (tid == 0 && u < units && nbox > 0) {
      mbar_arrive_expect_tx(full, nbox * BOX_ROWS * span_bytes);
      for (int i = 0; i < nbox; ++i)
        tma_load_3d(data + i * BOX_ROWS * span_bytes, &xmap, full,
                    (u % nspans) * span, r0 + i * BOX_ROWS, u / nspans);
    }
  };

  if (tid == 0) {
    mbar_init(full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  stage(cid);
  const float cnt = (float)S * (float)gs;
  unsigned char* mine_s = data + my_s;
  int it = 0;
  for (int u = cid; u < units; u += nclusters, ++it) {
    const int sp = u % nspans;
    float wv[VEC], bv[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int c = sp * span + ci * VEC + e;
      wv[e] = load_w(w, c, w_bf16);
      bv[e] = load_w(bias, c, w_bf16);
    }
    if (nbox > 0) mbar_wait(full, it & 1);

    float s[VEC], sq[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) s[e] = sq[e] = 0.f;
#pragma unroll 4
    for (int j = 0; j < mine; ++j) {
      float v[VEC];
      Chunk16<T>::unpack(*reinterpret_cast<const uint4*>(mine_s + j * step_s), v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        s[e] += v[e];
        sq[e] = fmaf(v[e], v[e], sq[e]);
      }
    }

    // the block's sums a group: threads, partitions of them, channels
    if (k < TY) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        red1[k * ncol + ci * VEC + e] = s[e];
        red1[k * ncol + span + ci * VEC + e] = sq[e];
      }
    }
    __syncthreads();
    for (int i = tid; i < P * ncol; i += THREADS) {
      const int p = i / ncol, col = i % ncol;
      const int k0 = p * TY / P, k1 = (p + 1) * TY / P;
      float acc = 0.f;
      for (int kk = k0; kk < k1; ++kk) acc += red1[kk * ncol + col];
      red2[p * ncol + col] = acc;
    }
    __syncthreads();
    float* part_u = part + (it & 1) * 2 * sg;
    for (int pr = warp; pr < 2 * sg; pr += THREADS / 32) {
      const int col0 = (pr / sg) * span + (pr % sg) * gs;  // sums, then squares
      float acc = 0.f;
      for (int c = lane; c < gs; c += 32) {
        float v = 0.f;
        for (int p = 0; p < P; ++p) v += red2[p * ncol + col0 + c];
        acc += v;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) part_u[pr] = acc;
    }

    // the cluster's sums, rank by rank: the same bits in every block. A
    // block writes this parity's sums again two slabs later, after a barrier
    // that every peer passes only once it has read them.
    cluster.sync();
    if (tid < 2 * sg) {
      float acc = 0.f;
      for (int r = 0; r < csize; ++r)
        acc += *cluster.map_shared_rank(part_u + tid, r);
      tot[tid] = acc;
    }
    __syncthreads();

    if (mine > 0) {
      float sc[VEC], sh[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int g = (ci * VEC + e) / gs;
        const float mean = tot[g] / cnt;
        const float var = tot[sg + g] / cnt - mean * mean;
        sc[e] = wv[e] * rsqrtf(var + eps);
        sh[e] = bv[e] - mean * sc[e];
      }
      unsigned char* dst = reinterpret_cast<unsigned char*>(y) + offset(u);
#pragma unroll 4
      for (int j = 0; j < mine; ++j) {
        float v[VEC];
        Chunk16<T>::unpack(*reinterpret_cast<const uint4*>(mine_s + j * step_s), v);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float o = fmaf(v[e], sc[e], sh[e]);
          v[e] = silu ? silu_f(o) : o;
        }
        *reinterpret_cast<uint4*>(dst + j * step_g) = Chunk16<T>::pack(v);
      }
    }
    // the next slab, once every thread is done with the buffer
    __syncthreads();
    stage(u + nclusters);
  }
  cluster.sync();  // no block leaves while a peer may still read its sums
}

// ---------------------------------------------------------------------------
// plan 3: the whole grid, one launch, the tail of each block's rows resident
// ---------------------------------------------------------------------------

constexpr int GRID_THREADS = 512;
constexpr int GRID_UNROLL = 8;  // rows in flight a thread while streaming

// 16 bytes read for the last time: evicted first from L2
__device__ __forceinline__ uint4 ld_last(const void* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// K blocks an image, all resident at once (a cooperative launch). A block
// owns rows [r0, r1) of image b, all C channels (16-byte chunks, a thread a
// chunk column). It loads the last `resident` of them into shared memory
// (cp.async, in flight from the start) and streams the others through
// registers for the sums; the image's blocks then meet at a counter, add
// the K partial sums in block order and normalise: first the streamed rows,
// read again last row first so that the rows read most recently come from
// L2, then the resident rows from shared memory; the second reads are
// marked to leave L2 first (the outputs are not: the next layer reads them). The last block of an image to leave sets
// its counters back to 0.
template <typename T>
__global__ void __launch_bounds__(GRID_THREADS, 1)
    gn_grid(const T* __restrict__ x, const void* __restrict__ w,
            const void* __restrict__ bias, int w_bf16, T* __restrict__ y,
            float* __restrict__ partial, unsigned* __restrict__ counter,
            int B, int S, int C, int G, int K, int rows_per_cta, int resident,
            float eps, int silu) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int CV = C / VEC;
  const int TY = GRID_THREADS / CV;
  const int tid = threadIdx.x, ci = tid % CV, k = tid / CV;
  const bool active = k < TY;
  const int b = blockIdx.x / K, q = blockIdx.x % K;
  const int r0 = q * rows_per_cta;
  const int r1 = min(S, r0 + rows_per_cta);
  const int rs = max(r0, r1 - resident);  // first resident row
  const int row_bytes = C * (int)sizeof(T);
  float* red = reinterpret_cast<float*>(
      smem + ((resident * row_bytes + 15) & ~15));  // [TY][2C]
  float* tot = red + TY * 2 * C;                      // [2C]
  float* stat = tot + 2 * C;                          // mean, rsqrt [G]
  const T* xb = x + (long long)b * S * C + ci * VEC;
  T* yb = y + (long long)b * S * C + ci * VEC;
  auto res_at = [&](int r) {  // row r's chunk ci in shared memory
    return reinterpret_cast<T*>(smem + ((r - rs) * CV + ci) * 16);
  };

  if (active)
    for (int r = rs + k; r < r1; r += TY)
      cp_async16(res_at(r), xb + (long long)r * C, 16);
  cp_async_commit();

  // my streamed rows are r0 + k + j * TY, j < n
  const int n = rs > r0 + k ? (rs - r0 - k + TY - 1) / TY : 0;
  auto row = [&](int j) { return r0 + k + j * TY; };
  float s[VEC], sq[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) s[e] = sq[e] = 0.f;
  auto add = [&](const uint4& u) {
    float v[VEC];
    Chunk16<T>::unpack(u, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      s[e] += v[e];
      sq[e] = fmaf(v[e], v[e], sq[e]);
    }
  };
  if (active) {
    int j = 0;
    for (; j + GRID_UNROLL <= n; j += GRID_UNROLL) {
      uint4 in[GRID_UNROLL];
#pragma unroll
      for (int u = 0; u < GRID_UNROLL; ++u)
        in[u] = *reinterpret_cast<const uint4*>(xb + (long long)row(j + u) * C);
#pragma unroll
      for (int u = 0; u < GRID_UNROLL; ++u) add(in[u]);
    }
    for (; j < n; ++j)
      add(*reinterpret_cast<const uint4*>(xb + (long long)row(j) * C));
  }
  cp_async_wait<0>();
  if (active) {
    for (int r = rs + k; r < r1; r += TY)
      add(*reinterpret_cast<const uint4*>(res_at(r)));
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      red[k * 2 * C + ci * VEC + e] = s[e];
      red[k * 2 * C + C + ci * VEC + e] = sq[e];
    }
  }
  __syncthreads();
  float* mine = partial + ((long long)b * K + q) * 2 * C;
  for (int col = tid; col < 2 * C; col += GRID_THREADS) {
    float acc = 0.f;
    for (int kk = 0; kk < TY; ++kk) acc += red[kk * 2 * C + col];
    mine[col] = acc;
  }

  // the K blocks of image b meet
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    atomicAdd(counter + b, 1u);
    const long long t0 = clock64();
    while (ld_acquire(counter + b) < (unsigned)K)
      if (clock64() - t0 > (1LL << 33)) __trap();
  }
  __syncthreads();
  for (int col = tid; col < 2 * C; col += GRID_THREADS) {
    const float* src = partial + (long long)b * K * 2 * C + col;
    float acc = 0.f;
    for (int qq = 0; qq < K; ++qq) acc += __ldcg(src + (long long)qq * 2 * C);
    tot[col] = acc;
  }
  __syncthreads();
  if (tid == 0 && atomicAdd(counter + B + b, 1u) == (unsigned)K - 1) {
    counter[b] = 0;  // every block of the image is past its wait
    counter[B + b] = 0;
  }
  const int gs = C / G;
  for (int g = tid; g < G; g += GRID_THREADS) {
    float s1 = 0.f, s2 = 0.f;
    for (int c = g * gs; c < (g + 1) * gs; ++c) {
      s1 += tot[c];
      s2 += tot[C + c];
    }
    const float cnt = (float)S * (float)gs;
    const float mean = s1 / cnt;
    const float var = s2 / cnt - mean * mean;
    stat[g] = mean;
    stat[G + g] = rsqrtf(var + eps);
  }
  __syncthreads();
  if (!active) return;

  float sc[VEC], sh[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int c = ci * VEC + e, g = c / gs;
    sc[e] = load_w(w, c, w_bf16) * stat[G + g];
    sh[e] = load_w(bias, c, w_bf16) - stat[g] * sc[e];
  }
  auto norm_store = [&](const uint4& in, int r) {
    float v[VEC];
    Chunk16<T>::unpack(in, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float o = fmaf(v[e], sc[e], sh[e]);
      v[e] = silu ? silu_f(o) : o;
    }
    *reinterpret_cast<uint4*>(yb + (long long)r * C) = Chunk16<T>::pack(v);
  };
  // the streamed rows again, the last read first, before this block's
  // writes push them out of L2; then the resident rows
  int j = n - 1;
  for (; j >= GRID_UNROLL - 1; j -= GRID_UNROLL) {
    uint4 in[GRID_UNROLL];
#pragma unroll
    for (int u = 0; u < GRID_UNROLL; ++u)
      in[u] = ld_last(xb + (long long)row(j - u) * C);
#pragma unroll
    for (int u = 0; u < GRID_UNROLL; ++u) norm_store(in[u], row(j - u));
  }
  for (; j >= 0; --j) norm_store(ld_last(xb + (long long)row(j) * C), row(j));
  for (int r = rs + k; r < r1; r += TY)
    norm_store(*reinterpret_cast<const uint4*>(res_at(r)), r);
}

// ---------------------------------------------------------------------------
// plan 2: statistics, then apply
// ---------------------------------------------------------------------------

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
    gn_stats(const T* __restrict__ x, const void* __restrict__ w,
             const void* __restrict__ bias, int w_bf16,
             float* __restrict__ partial, float* __restrict__ scale,
             float* __restrict__ shift, unsigned* __restrict__ counter, int S,
             int C, int G, int rows_per_chunk, int TX, int TY, float eps) {
  extern __shared__ __align__(16) float sm[];
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
    int r = r0 + ty;
    for (; r + (UNROLL - 1) * TY < r1; r += UNROLL * TY) {
      float v[UNROLL][VEC];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        Vec<T, VEC>::load(base + (long long)(r + u * TY) * C, v[u]);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          s[e] += v[u][e];
          q[e] = fmaf(v[u][e], v[u][e], q[e]);
        }
    }
    for (; r < r1; r += TY) {
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

  // the last block of image b to finish turns the partials into scale and
  // shift; the others are done
  __threadfence();
  __syncthreads();
  int* flag = reinterpret_cast<int*>(sm);  // the sums above are all read
  if (threadIdx.x == 0)
    *flag = atomicAdd(counter + b, 1u) == (unsigned)(nchunks * gridDim.z) - 1;
  __syncthreads();
  const bool last = *flag;
  __syncthreads();  // read by all before the sums below overwrite it
  if (!last) return;
  __threadfence();
  float* tot = sm;             // [2][C]
  float* stat = sm + 2 * C;    // mean, rsqrt [G]
  for (int col = threadIdx.x; col < 2 * C; col += THREADS) {
    const float* src = partial + (long long)b * nchunks * 2 * C + col;
    float acc = 0.f;
    for (int ch = 0; ch < nchunks; ++ch) acc += __ldcg(src + (long long)ch * 2 * C);
    tot[col] = acc;
  }
  __syncthreads();
  const int gs = C / G;
  for (int g = threadIdx.x; g < G; g += THREADS) {
    float s1 = 0.f, s2 = 0.f;
    for (int c = g * gs; c < (g + 1) * gs; ++c) {
      s1 += tot[c];
      s2 += tot[C + c];
    }
    const float cnt = (float)S * (float)gs;
    const float mean = s1 / cnt;
    const float var = s2 / cnt - mean * mean;
    stat[g] = mean;
    stat[G + g] = rsqrtf(var + eps);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const int g = c / gs;
    const float sc = load_w(w, c, w_bf16) * stat[G + g];
    scale[(long long)b * C + c] = sc;
    shift[(long long)b * C + c] = load_w(bias, c, w_bf16) - stat[g] * sc;
  }
  if (threadIdx.x == 0) counter[b] = 0;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
    gn_apply(const T* __restrict__ x, const float* __restrict__ scale,
             const float* __restrict__ shift, T* __restrict__ y, int S, int C,
             int rows_per_block, int TX, int TY, int silu) {
  constexpr int U = 4;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int CV = C / VEC;
  const int cv = blockIdx.z * TX + tx;
  if (cv >= CV || ty >= TY) return;
  // the last rows of the last image first
  const int chunk = gridDim.x - 1 - blockIdx.x;
  const int b = gridDim.y - 1 - blockIdx.y;
  const int r0 = chunk * rows_per_block;
  const int r1 = min(S, r0 + rows_per_block);
  float sc[VEC], sh[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    sc[e] = scale[(long long)b * C + cv * VEC + e];
    sh[e] = shift[(long long)b * C + cv * VEC + e];
  }
  const long long base = ((long long)b * S) * C + cv * VEC;
  int r = r0 + ty;
  for (; r + (U - 1) * TY < r1; r += U * TY) {
    float v[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u)
      Vec<T, VEC>::load(x + base + (long long)(r + u * TY) * C, v[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float o = fmaf(v[u][e], sc[e], sh[e]);
        v[u][e] = silu ? silu_f(o) : o;
      }
      Vec<T, VEC>::store(y + base + (long long)(r + u * TY) * C, v[u]);
    }
  }
  for (; r < r1; r += TY) {
    float v[VEC];
    Vec<T, VEC>::load(x + base + (long long)r * C, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float o = fmaf(v[e], sc[e], sh[e]);
      v[e] = silu ? silu_f(o) : o;
    }
    Vec<T, VEC>::store(y + base + (long long)r * C, v);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// The attributes of each cluster instantiation, set once a process (shared
// memory to the most any plan asks for), not at every launch.
template <typename T>
cudaError_t cluster_attrs() {
  static cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        gn_cluster<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_MAX);
    if (e != cudaSuccess) return e;
    // clusters of 16, where a slab does not fit 8 blocks
    return cudaFuncSetAttribute(
        gn_cluster<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  return err;
}

cudaLaunchConfig_t cluster_config(int cluster, int clusters, int smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(cluster * clusters));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of one shape the card holds at once
// (cudaOccupancyMaxActiveClusters), asked once a (type, cluster, shared
// memory) and remembered; a negative value is minus a CUDA error.
template <typename T>
int max_clusters(int cluster, int smem) {
  struct Seen { int cluster, smem, n; };
  static Seen seen[256];
  static int nseen = 0;
  for (int i = 0; i < nseen; ++i)
    if (seen[i].cluster == cluster && seen[i].smem == smem) return seen[i].n;
  cudaError_t err = cluster_attrs<T>();
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(cluster, 132, smem, 0, attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(
      &n, reinterpret_cast<const void*>(gn_cluster<T>), &cfg);
  if (err != cudaSuccess) return -(int)err;
  if (nseen < 256) seen[nseen++] = {cluster, smem, n};
  return n;
}

// Tensor map of a (B, S, C) array as dims (C, S, B), boxes of span channels
// x BOX_ROWS rows of one image, no swizzle (a box lands in shared memory as
// BOX_ROWS dense rows of span channels), rows past S read as zeros.
template <typename T>
bool make_slab_map(CUtensorMap* map, const void* ptr, int B, int S, int C,
                   int span) {
  EncodeTiledFn encode = encode_tiled_entry();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * sizeof(T),
                                 (cuuint64_t)S * C * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)span, (cuuint32_t)BOX_ROWS, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map,
                sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                               : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                3, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
cudaError_t launch_cluster(const void* x, const void* w, const void* bias,
                           int w_bf16, void* y, int B, int S, int C, int G,
                           float eps, int silu, int cluster, int span,
                           int rows_per_cta, int smem, int blocks,
                           cudaStream_t stream) {
  const int gs = C / G;
  const int units = B * (C / span);
  // slabs are loaded by TMA: the span is whole 16-byte chunks and the rows
  // a block holds whole boxes
  if (span % gs || C % span || (span * (int)sizeof(T)) % 16 ||
      blocks != units * cluster || smem > SMEM_MAX ||
      rows_per_cta % BOX_ROWS || span > 256)
    return cudaErrorInvalidValue;
  CUtensorMap xmap;
  if (!make_slab_map<T>(&xmap, x, B, S, C, span)) return cudaErrorInvalidValue;
  const int held = max_clusters<T>(cluster, smem);
  if (held < 0) return (cudaError_t)(-held);
  if (held == 0) return cudaErrorInvalidConfiguration;
  // persistent: as many clusters as the card holds, each walking slabs
  const int clusters = units < held ? units : held;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(cluster, clusters, smem, stream,
                                          attr);
  return cudaLaunchKernelEx(&cfg, gn_cluster<T>, xmap, w, bias, w_bf16,
                            static_cast<T*>(y), S, C, gs, span, rows_per_cta,
                            units, eps, silu);
}

template <typename T, int VEC>
cudaError_t launch_two_pass(const void* x, const void* w, const void* bias,
                            int w_bf16, void* y, float* partial, float* scale,
                            float* shift, unsigned* counter, int B, int S,
                            int C, int G, float eps, int silu,
                            int rows_per_chunk, int smem, int blocks,
                            cudaStream_t stream) {
  const int CV = C / VEC;
  const int TX = CV < THREADS ? CV : THREADS;
  const int TY = THREADS / TX;
  const int ZC = (CV + TX - 1) / TX;
  const int nchunks = (S + rows_per_chunk - 1) / rows_per_chunk;
  const int need = 4 * (TY * TX * 2 * VEC > 2 * C + 2 * G ? TY * TX * 2 * VEC
                                                          : 2 * C + 2 * G);
  if (blocks != nchunks * B * ZC || smem != need || smem > SMEM_MAX)
    return cudaErrorInvalidValue;
  // rows wider than 48 KB of fp32 sums need the attribute (set once)
  static cudaError_t attr = cudaFuncSetAttribute(
      gn_stats<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (attr != cudaSuccess) return attr;
  gn_stats<T, VEC><<<dim3(nchunks, B, ZC), THREADS, smem, stream>>>(
      static_cast<const T*>(x), w, bias, w_bf16, partial, scale, shift,
      counter, S, C, G, rows_per_chunk, TX, TY, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int row_bytes = C * (int)sizeof(T);
  int rows = (APPLY_BYTES / row_bytes) / TY * TY;
  if (rows < TY) rows = TY;
  gn_apply<T, VEC><<<dim3((S + rows - 1) / rows, B, ZC), THREADS, 0, stream>>>(
      static_cast<const T*>(x), scale, shift, static_cast<T*>(y), S, C, rows,
      TX, TY, silu);
  return cudaGetLastError();
}

// Plan 3: B x K blocks, all resident at once (a cooperative launch; the
// card is asked first). The rows a block keeps resident follow from its
// shared memory.
template <typename T>
cudaError_t launch_grid(const void* x, const void* w, const void* bias,
                        int w_bf16, void* y, float* partial, unsigned* counter,
                        int B, int S, int C, int G, float eps, int silu,
                        int rows_per_cta, int smem, int blocks,
                        cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int CV = C / VEC;
  const int K = blocks / B;
  const int TY = CV > 0 ? GRID_THREADS / CV : 0;
  const int scratch = 4 * (TY * 2 * C + 2 * C + 2 * G) + 16;
  const int resident = (smem - scratch) / (C * (int)sizeof(T));
  if (C % VEC || CV > GRID_THREADS || blocks != B * K || K < 1 ||
      smem > SMEM_MAX || resident < 0 ||
      (long long)K * rows_per_cta < S)
    return cudaErrorInvalidValue;
  static cudaError_t attr = cudaFuncSetAttribute(
      gn_grid<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (attr != cudaSuccess) return attr;
  int per_sm = 0, sms = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gn_grid<T>,
                                                        GRID_THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm * sms < blocks) return cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(GRID_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeCooperative;
  attrs[0].val.cooperative = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, gn_grid<T>, static_cast<const T*>(x), w,
                            bias, w_bf16, static_cast<T*>(y), partial, counter,
                            B, S, C, G, K, rows_per_cta, resident, eps, silu);
}

}  // namespace

extern "C" const char* ed_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y: (B, S, C) contiguous, S = H * W. dtype: 0 = bf16, 1 = fp32. plan,
// vec, cluster, span, rows_per_cta, smem, blocks: groupnorm_plan's
// fields (blocks: the slabs times the cluster size; the launch holds no more
// clusters than the card does at once).
// Plan 2: partial (B, chunks, 2, C) fp32 scratch, scale_shift (2, B, C)
// fp32 scratch, counter: B int32 zeros (left zero). Plan 3: partial
// (B, blocks / B, 2, C) fp32 scratch, counter: 2 B int32 zeros (left zero).
extern "C" int ed_group_norm(const void* x, const void* w, const void* bias,
                             int w_bf16, void* y, void* partial,
                             void* scale_shift, void* counter, int B, int S,
                             int C, int G, float eps, int silu, int dtype,
                             int plan, int vec, int cluster, int span,
                             int rows_per_cta, int smem, int blocks,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plan == 1) {
    if (dtype == 0 && vec == 16)
      return (int)launch_cluster<bf16>(x, w, bias, w_bf16, y, B, S, C, G, eps,
                                       silu, cluster, span, rows_per_cta, smem,
                                       blocks, st);
    if (dtype == 1 && vec == 16)
      return (int)launch_cluster<float>(x, w, bias, w_bf16, y, B, S, C, G, eps,
                                        silu, cluster, span, rows_per_cta, smem,
                                        blocks, st);
    return -1;
  }
  if (plan == 3) {
    float* pp = static_cast<float*>(partial);
    unsigned* cnt = static_cast<unsigned*>(counter);
    if (dtype == 0 && vec == 16)
      return (int)launch_grid<bf16>(x, w, bias, w_bf16, y, pp, cnt, B, S, C, G,
                                    eps, silu, rows_per_cta, smem, blocks, st);
    if (dtype == 1 && vec == 16)
      return (int)launch_grid<float>(x, w, bias, w_bf16, y, pp, cnt, B, S, C,
                                     G, eps, silu, rows_per_cta, smem, blocks,
                                     st);
    return -1;
  }
  if (plan == 2) {
    float* pp = static_cast<float*>(partial);
    float* sc = static_cast<float*>(scale_shift);
    float* sh = sc + (long long)B * C;
    unsigned* cnt = static_cast<unsigned*>(counter);
#define ED_GN_TWO_PASS(T, VEC)                                                \
  return (int)launch_two_pass<T, VEC>(x, w, bias, w_bf16, y, pp, sc, sh, cnt, \
                                      B, S, C, G, eps, silu, rows_per_cta,    \
                                      smem, blocks, st)
    if (dtype == 0 && vec == 16) ED_GN_TWO_PASS(bf16, 8);
    if (dtype == 0 && vec == 2) ED_GN_TWO_PASS(bf16, 1);
    if (dtype == 1 && vec == 16) ED_GN_TWO_PASS(float, 4);
    if (dtype == 1 && vec == 4) ED_GN_TWO_PASS(float, 1);
#undef ED_GN_TWO_PASS
    return -1;
  }
  return -1;
}

// How many clusters of a plan-1 launch fit on the card at once
// (cudaOccupancyMaxActiveClusters); a negative value is minus a CUDA error.
extern "C" int ed_group_norm_max_clusters(int dtype, int cluster, int smem) {
  if (dtype == 0) return max_clusters<bf16>(cluster, smem);
  if (dtype == 1) return max_clusters<float>(cluster, smem);
  return -1;
}
