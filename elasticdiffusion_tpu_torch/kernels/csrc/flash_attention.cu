// Non-causal softmax(Q K^T / sqrt(D)) V for Hopper (sm_90a), plain C interface.
//
// Replaces the three Pallas TPU attention kernels of
// elasticdiffusion_tpu/kernels/flash_attention.py: the one-shot kernel
// (_oneshot_attention / _oneshot_math), the bf16 streaming kernel
// (_flash_kernel_bf16_nn) and the fp32 streaming kernel (_flash_kernel).
// The TPU split exists because of VMEM residency; the function is one, so
// here one online-softmax loop over key tiles serves every shape.
//
// Layout: q (B, Sq, H, D), k/v (B, Sk, H, D) with element strides for the
// batch, sequence and head dims (the last dim is contiguous), so the
// (B, S, H*D) output of a projection is read in place. Output is a fresh
// contiguous (B, Sq, H, D).
//
// Numerics, as the TPU kernels: raw scores, running max, denominator and
// the output accumulator are fp32; the 1/sqrt(D) scale is folded with
// log2(e) into one constant applied inside exp2; a ragged last key tile is
// masked in the kernel (Sk = 77, or Sk not a multiple of the tile); with
// bf16 inputs P is rounded to bf16 before P.V while the denominator sums
// the unrounded fp32 P.
//
// Two bodies share the softmax phase:
//   flash_mma_bf16  bf16 inputs, mma.sync m16n8k16 tensor-core products
//                   with fp32 accumulation.
//   flash_fma       fp32 inputs, full-precision FMA products on the CUDA
//                   cores (the fp32 path exists for precision; TF32 would
//                   defeat it).
// A block owns BM query rows. Per key tile: (1) S = Q K^T goes to shared
// memory, (2) all threads run the online-softmax update row by row and
// leave P in shared memory, (3) O += P V with the D columns of the
// accumulator split across the warps of the block. Step (3) is what lets a
// D = 512 accumulator (the VAE mid attention) live in registers: no thread
// holds more than 64 of its floats.
//
// Bound on this card: operations (4*B*H*Sq*Sk*D) for the self-attention
// shapes; the design reaches the tensor cores through mma.sync only. wgmma,
// TMA loads and a pipelined K/V ring are the known next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

struct AttnParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Sk, H;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float c;  // softmax scale * log2(e)
};

__device__ __forceinline__ void store_p(float* dst, float p) { *dst = p; }
__device__ __forceinline__ void store_p(bf16* dst, float p) {
  *dst = __float2bfloat16(p);
}

// One key tile of the online softmax. S holds the raw scores of BM rows;
// THREADS / BM neighbouring lanes share a row. Leaves P in `P` (which may
// alias S when PT is float), and updates the running max m, the running
// denominator l and the rescale factor alpha of every row.
template <int BM, int BN, int THREADS, typename PT>
__device__ __forceinline__ void softmax_tile(float* S, int lds, PT* P, int ldp,
                                             float* m_s, float* l_s,
                                             float* alpha_s, int valid_cols,
                                             float c, int tid) {
  constexpr int TPR = THREADS / BM;  // threads per row: power of two <= 32
  static_assert(TPR >= 1 && TPR <= 32 && (TPR & (TPR - 1)) == 0, "TPR");
  const int row = tid / TPR, sub = tid % TPR;
  float* srow = S + row * lds;
  PT* prow = P + row * ldp;
  float mx = -INFINITY;
  for (int j = sub; j < BN; j += TPR)
    if (j < valid_cols) mx = fmaxf(mx, srow[j]);
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float m_old = m_s[row];
  const float m_new = fmaxf(m_old, mx);
  float sum = 0.f;
  for (int j = sub; j < BN; j += TPR) {
    const float p = (j < valid_cols) ? exp2f((srow[j] - m_new) * c) : 0.f;
    sum += p;
    store_p(prow + j, p);
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (sub == 0) {
    const float alpha = exp2f((m_old - m_new) * c);  // 0 on the first tile
    m_s[row] = m_new;
    l_s[row] = l_s[row] * alpha + sum;
    alpha_s[row] = alpha;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core body
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Two transposed 8x8 bf16 matrices from shared memory: lanes 0-7 give the
// row addresses of the first, lanes 8-15 of the second. With rows = keys
// and columns = head dims this is exactly the col-major B fragment of P.V.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const bf16* row_ptr) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(row_ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

template <int D, int LD, int THREADS>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src,
                                               long long row_stride, int rows,
                                               int valid_rows, int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int idx = tid; idx < rows * CPR; idx += THREADS) {
    const int r = idx / CPR, cc = idx % CPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid_rows)
      val = *reinterpret_cast<const uint4*>(src + (long long)r * row_stride +
                                            cc * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + cc * 8) = val;
  }
}

template <int D, int BM, int BN, int WG>
struct MmaCfg {
  static constexpr int NW = (BM / 16) * WG;
  static constexpr int THREADS = NW * 32;
  static constexpr int LD = D + 8;    // bf16 elements; +16 bytes kills conflicts
  static constexpr int LDP = BN + 8;  // bf16 elements
  static constexpr int LDS = BN + 1;  // floats
  static constexpr size_t SMEM =
      (size_t)(BM * LD + 2 * BN * LD + BM * LDP) * sizeof(bf16) +
      (size_t)(BM * LDS + 3 * BM) * sizeof(float);
};

template <int D, int BM, int BN, int WG>
__global__ void __launch_bounds__(MmaCfg<D, BM, BN, WG>::THREADS)
    flash_mma_bf16(AttnParams p) {
  using Cfg = MmaCfg<D, BM, BN, WG>;
  constexpr int THREADS = Cfg::THREADS, LD = Cfg::LD, LDP = Cfg::LDP,
                LDS = Cfg::LDS;
  constexpr int KPW = BN / WG;    // keys per warp in the S phase
  constexpr int DPW = D / WG;     // head dims per warp in the P.V phase
  constexpr int NT_S = KPW / 8;   // 8-wide n-tiles of S per warp
  constexpr int NT_O = DPW / 8;   // 8-wide n-tiles of O per warp
  static_assert(KPW % 8 == 0 && DPW % 8 == 0 && D % 16 == 0 && BN % 16 == 0,
                "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BM * LD;
  bf16* Vs = Ks + BN * LD;
  bf16* Ps = Vs + BN * LD;
  float* Ss = reinterpret_cast<float*>(Ps + BM * LDP);
  float* m_s = Ss + BM * LDS;
  float* l_s = m_s + BM;
  float* a_s = l_s + BM;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;

  const bf16* qp = static_cast<const bf16*>(p.q) + (long long)b * p.q_sb +
                   (long long)h * p.q_sh + (long long)q0 * p.q_ss;
  const bf16* kp = static_cast<const bf16*>(p.k) + (long long)b * p.k_sb +
                   (long long)h * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + (long long)b * p.v_sb +
                   (long long)h * p.v_sh;

  load_tile_bf16<D, LD, THREADS>(Qs, qp, p.q_ss, BM, min(BM, p.Sq - q0), tid);
  if (tid < BM) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
    a_s[tid] = 0.f;
  }

  const int rg = warp / WG, wg = warp % WG;
  const int r0 = rg * 16;

  float acc[NT_O][4];
#pragma unroll
  for (int nt = 0; nt < NT_O; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int kt = 0; kt < p.Sk; kt += BN) {
    const int valid = min(BN, p.Sk - kt);
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile_bf16<D, LD, THREADS>(Ks, kp + (long long)kt * p.k_ss, p.k_ss, BN,
                                   valid, tid);
    load_tile_bf16<D, LD, THREADS>(Vs, vp + (long long)kt * p.v_ss, p.v_ss, BN,
                                   valid, tid);
    __syncthreads();

    // (1) S = Q K^T for rows r0..r0+15, keys wg*KPW..+KPW
    float s[NT_S][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll 8
    for (int ks = 0; ks < D / 16; ++ks) {
      const bf16* qa = Qs + (r0 + g) * LD + ks * 16 + 2 * tig;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(qa);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(qa + 8 * LD);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(qa + 8);
      const uint32_t a3 = *reinterpret_cast<const uint32_t*>(qa + 8 * LD + 8);
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        const bf16* kb = Ks + (wg * KPW + nt * 8 + g) * LD + ks * 16 + 2 * tig;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kb);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kb + 8);
        mma_bf16_16816(s[nt], a0, a1, a2, a3, b0, b1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      const int col = wg * KPW + nt * 8 + 2 * tig;
      Ss[(r0 + g) * LDS + col] = s[nt][0];
      Ss[(r0 + g) * LDS + col + 1] = s[nt][1];
      Ss[(r0 + g + 8) * LDS + col] = s[nt][2];
      Ss[(r0 + g + 8) * LDS + col + 1] = s[nt][3];
    }
    __syncthreads();

    // (2) online softmax; P rounded to bf16 for the tensor cores
    softmax_tile<BM, BN, THREADS, bf16>(Ss, LDS, Ps, LDP, m_s, l_s, a_s, valid,
                                        p.c, tid);
    __syncthreads();

    // (3) O = alpha * O + P V for rows r0..r0+15, head dims wg*DPW..+DPW
    const float al = a_s[r0 + g], ah = a_s[r0 + g + 8];
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
      acc[nt][0] *= al;
      acc[nt][1] *= al;
      acc[nt][2] *= ah;
      acc[nt][3] *= ah;
    }
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks) {
      const bf16* pa = Ps + (r0 + g) * LDP + ks * 16 + 2 * tig;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(pa);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(pa + 8 * LDP);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(pa + 8);
      const uint32_t a3 = *reinterpret_cast<const uint32_t*>(pa + 8 * LDP + 8);
      const bf16* vrow = Vs + (ks * 16 + (lane & 15)) * LD + wg * DPW;
#pragma unroll
      for (int nt = 0; nt < NT_O; ++nt) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vrow + nt * 8);
        mma_bf16_16816(acc[nt], a0, a1, a2, a3, b0, b1);
      }
    }
  }

  // l_s was last written before the barrier that precedes the final P.V
  const int row_lo = q0 + r0 + g, row_hi = row_lo + 8;
  const float il = 1.f / l_s[r0 + g], ih = 1.f / l_s[r0 + g + 8];
  bf16* op = static_cast<bf16*>(p.o);
#pragma unroll
  for (int nt = 0; nt < NT_O; ++nt) {
    const int col = wg * DPW + nt * 8 + 2 * tig;
    if (row_lo < p.Sq) {
      bf16* dst = op + (((long long)b * p.Sq + row_lo) * p.H + h) * D + col;
      *reinterpret_cast<__nv_bfloat162*>(dst) =
          __floats2bfloat162_rn(acc[nt][0] * il, acc[nt][1] * il);
    }
    if (row_hi < p.Sq) {
      bf16* dst = op + (((long long)b * p.Sq + row_hi) * p.H + h) * D + col;
      *reinterpret_cast<__nv_bfloat162*>(dst) =
          __floats2bfloat162_rn(acc[nt][2] * ih, acc[nt][3] * ih);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: full-precision FMA body
// ---------------------------------------------------------------------------

template <int D, int BM, int BN>
struct FmaCfg {
  static constexpr int THREADS = 256;
  static constexpr int LDQ = D + 1;   // floats; odd stride kills conflicts
  static constexpr int LDV = D;
  static constexpr int LDS = BN + 1;
  static constexpr size_t SMEM =
      (size_t)(BM * LDQ + BN * LDQ + BN * LDV + BM * LDS + 3 * BM) *
      sizeof(float);
};

template <int D, int LDX, int THREADS>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long row_stride, int rows,
                                              int valid_rows, int tid) {
  constexpr int CPR = D / 4;  // 16-byte chunks per row
  for (int idx = tid; idx < rows * CPR; idx += THREADS) {
    const int r = idx / CPR, cc = idx % CPR;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid_rows)
      val = *reinterpret_cast<const float4*>(src + (long long)r * row_stride +
                                             cc * 4);
    float* d = dst + r * LDX + cc * 4;
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

template <int D, int BM, int BN>
__global__ void __launch_bounds__(256) flash_fma_f32(AttnParams p) {
  using Cfg = FmaCfg<D, BM, BN>;
  constexpr int THREADS = Cfg::THREADS, LDQ = Cfg::LDQ, LDV = Cfg::LDV,
                LDS = Cfg::LDS;
  constexpr int TM = BM / 16, TN = BN / 16;  // S micro-tile of a thread
  constexpr int R = BM / 8;                  // O rows of a warp
  constexpr int KD = D / 32;                 // O head dims of a lane
  static_assert(BM % 16 == 0 && BN % 16 == 0 && D % 32 == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + BM * LDQ;
  float* Vs = Ks + BN * LDQ;
  float* Ss = Vs + BN * LDV;
  float* m_s = Ss + BM * LDS;
  float* l_s = m_s + BM;
  float* a_s = l_s + BM;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;

  const float* qp = static_cast<const float*>(p.q) + (long long)b * p.q_sb +
                    (long long)h * p.q_sh + (long long)q0 * p.q_ss;
  const float* kp = static_cast<const float*>(p.k) + (long long)b * p.k_sb +
                    (long long)h * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + (long long)b * p.v_sb +
                    (long long)h * p.v_sh;

  load_tile_f32<D, LDQ, THREADS>(Qs, qp, p.q_ss, BM, min(BM, p.Sq - q0), tid);
  if (tid < BM) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
    a_s[tid] = 0.f;
  }

  float acc[R][KD];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) acc[i][kk] = 0.f;

  for (int kt = 0; kt < p.Sk; kt += BN) {
    const int valid = min(BN, p.Sk - kt);
    __syncthreads();
    load_tile_f32<D, LDQ, THREADS>(Ks, kp + (long long)kt * p.k_ss, p.k_ss, BN,
                                   valid, tid);
    load_tile_f32<D, LDV, THREADS>(Vs, vp + (long long)kt * p.v_ss, p.v_ss, BN,
                                   valid, tid);
    __syncthreads();

    // (1) S = Q K^T: thread (ty, tx) owns rows ty+16a, keys tx+16b
    float s[TM][TN];
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int bb = 0; bb < TN; ++bb) s[a][bb] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[TM], kv[TN];
#pragma unroll
      for (int a = 0; a < TM; ++a) qv[a] = Qs[(ty + 16 * a) * LDQ + d];
#pragma unroll
      for (int bb = 0; bb < TN; ++bb) kv[bb] = Ks[(tx + 16 * bb) * LDQ + d];
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int bb = 0; bb < TN; ++bb) s[a][bb] = fmaf(qv[a], kv[bb], s[a][bb]);
    }
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int bb = 0; bb < TN; ++bb)
        Ss[(ty + 16 * a) * LDS + tx + 16 * bb] = s[a][bb];
    __syncthreads();

    // (2) online softmax, P written over S
    softmax_tile<BM, BN, THREADS, float>(Ss, LDS, Ss, LDS, m_s, l_s, a_s, valid,
                                         p.c, tid);
    __syncthreads();

    // (3) O = alpha * O + P V: warp owns rows warp*R.., lane owns dims lane+32k
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float al = a_s[warp * R + i];
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) acc[i][kk] *= al;
    }
    for (int j = 0; j < BN; ++j) {
      float vv[KD];
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) vv[kk] = Vs[j * LDV + lane + 32 * kk];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float pij = Ss[(warp * R + i) * LDS + j];
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          acc[i][kk] = fmaf(pij, vv[kk], acc[i][kk]);
      }
    }
  }

  float* op = static_cast<float*>(p.o);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + warp * R + i;
    if (row < p.Sq) {
      const float il = 1.f / l_s[warp * R + i];
      float* dst = op + (((long long)b * p.Sq + row) * p.H + h) * D;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) dst[lane + 32 * kk] = acc[i][kk] * il;
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, int threads, int bm,
                   const AttnParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq + bm - 1) / bm, p.H, p.B);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* ed_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = bf16, 1 = fp32. Returns a cudaError_t, or -1 for a
// (dtype, head dim) pair that has no instantiation.
extern "C" int ed_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int B, int Sq, int Sk, int H, int D,
                                  long long q_sb, long long q_ss, long long q_sh,
                                  long long k_sb, long long k_ss, long long k_sh,
                                  long long v_sb, long long v_ss, long long v_sh,
                                  int dtype, float scale_log2e, void* stream) {
  AttnParams p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.H = H;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.c = scale_log2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) {
    using Cfg = MmaCfg<64, 64, 64, 2>;
    return (int)launch(flash_mma_bf16<64, 64, 64, 2>, Cfg::SMEM, Cfg::THREADS,
                       64, p, st);
  }
  if (dtype == 0 && D == 512) {
    using Cfg = MmaCfg<512, 32, 32, 4>;
    return (int)launch(flash_mma_bf16<512, 32, 32, 4>, Cfg::SMEM, Cfg::THREADS,
                       32, p, st);
  }
  if (dtype == 1 && D == 64) {
    using Cfg = FmaCfg<64, 64, 64>;
    return (int)launch(flash_fma_f32<64, 64, 64>, Cfg::SMEM, Cfg::THREADS, 64,
                       p, st);
  }
  if (dtype == 1 && D == 512) {
    using Cfg = FmaCfg<512, 32, 32>;
    return (int)launch(flash_fma_f32<512, 32, 32>, Cfg::SMEM, Cfg::THREADS, 32,
                       p, st);
  }
  return -1;
}
