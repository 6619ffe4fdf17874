// 3x3 SAME stride-1 NHWC convolution (+ bias, optional SiLU) for Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel conv3x3 / _kernel of
// elasticdiffusion_tpu/kernels/conv3x3.py. It computes what that kernel
// computes and shares none of its structure: the TPU version builds a
// separate halo operand outside the kernel, takes three sublane-shifted
// copies of its tile and plans blocks against VMEM, all of which answer the
// TPU's DMA and layout rules. Here a block loads its own halo from global
// memory with zero fill at the image edge, and a shifted tap is an address
// offset into shared memory.
//
// Function: y[b,h,w,o] = act(bias[o] + sum_{dy,dx,c} x[b,h+dy-1,w+dx-1,c] *
// w[dy,dx,c,o]), x zero outside the image. The sum over the 9 taps and C is
// one fp32 accumulation; the bias is added in fp32; SiLU, where asked, acts
// on the fp32 sum; one rounding to the type of x.
//
// Operands: x (B,H,W,C) and w (3,3,C,O) with element strides and channel
// stride 1 in both (C is the reduction dim), so the NHWC view of a
// channels_last activation and the HWIO view of a channels_last (O,C,3,3)
// weight are read in place. y is a fresh contiguous (B,H,W,O). C and O are
// multiples of 8 (16-byte loads); H, W, C and O need not be multiples of any
// tile: ragged edges are masked.
//
// Design: a block owns an 8x16 tile of output pixels of one image and BN
// output channels. It loops over C in chunks of BK; per chunk it stages the
// 10x18 halo'd input tile and the nine (BN, BK) weight slabs in shared memory
// (cp.async, 16 bytes a thread, zero fill where the source does not exist),
// then runs 9 x BK/16 accumulating steps.
//   conv3x3_mma_bf16  bf16: mma.sync m16n8k16 with fp32 accumulation. The 16
//                     rows of an A fragment are the 16 pixels of one tile
//                     row; ldmatrix takes one address per lane, so tap
//                     (dy, dx) is the same fragment load at a shifted halo
//                     address. B rows are output channels, contiguous along
//                     C, which is the col-major operand mma wants from a
//                     plain ldmatrix. Rows are padded by 16 bytes, which
//                     keeps the 8 rows of every ldmatrix on distinct banks.
//   conv3x3_fma_f32   fp32: full-precision FMAs on the CUDA cores (no TF32:
//                     the fp32 path exists for precision); a thread owns one
//                     pixel column of the tile and BN/16 output channels.
//
// Bound on this card: operations (2*9*C*O*B*H*W) at every UNet shape. The
// design reaches the tensor cores through mma.sync and hides load latency
// only by running several blocks on an SM; wgmma, TMA and a pipelined ring
// of chunks are the known next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TH = 8, TW = 16;             // output pixels of a block
constexpr int HH = TH + 2, HW = TW + 2;    // with the halo
constexpr int HALO = HH * HW;
constexpr int THREADS = 256;

struct ConvParams {
  const void* x;
  const void* w;
  const void* bias;  // fp32 or bf16, or null
  void* y;
  int B, H, W, C, O;
  long long x_sb, x_sh, x_sw;  // element strides of x; channel stride 1
  long long w_sy, w_sx, w_so;  // element strides of w[dy][dx][c][o]; c stride 1
  int bias_kind;               // 0 none, 1 fp32, 2 bf16
  int silu;
  int tiles_x;
};

__device__ __forceinline__ float load_bias(const ConvParams& p, int o) {
  if (p.bias_kind == 1) return static_cast<const float*>(p.bias)[o];
  if (p.bias_kind == 2)
    return __bfloat162float(static_cast<const bf16*>(p.bias)[o]);
  return 0.f;
}

__device__ __forceinline__ float finish(float v, int silu) {
  return silu ? v / (1.f + __expf(-v)) : v;
}

// 16 bytes global -> shared; src_bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(d), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8x8 bf16 matrices: lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// bf16: tensor-core body
// ---------------------------------------------------------------------------

template <int BN, int BK>
struct MmaCfg {
  static constexpr int LD = BK + 8;  // bf16 elements per shared-memory row
  static constexpr size_t SMEM = (size_t)(HALO + 9 * BN) * LD * sizeof(bf16);
};

template <int BN, int BK>
__global__ void __launch_bounds__(THREADS, 2) conv3x3_mma_bf16(ConvParams p) {
  constexpr int LD = MmaCfg<BN, BK>::LD;
  constexpr int CPR = BK / 8;  // 16-byte chunks per row
  constexpr int WN = BN / 2;   // output channels of a warp
  constexpr int NT = WN / 8;   // its 8-wide n-tiles
  static_assert(BK % 16 == 0 && NT % 2 == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);  // [HALO][LD]
  bf16* Ws = Xs + HALO * LD;                     // [9][BN][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int ty0 = (blockIdx.x / p.tiles_x) * TH;
  const int tx0 = (blockIdx.x % p.tiles_x) * TW;
  const int o0 = blockIdx.y * BN, b = blockIdx.z;
  // 8 warps: 4 along the tile rows (2 rows = 2 m16 tiles each), 2 along O
  const int wm = warp & 3, wn = warp >> 2;

  const bf16* xb = static_cast<const bf16*>(p.x) + (long long)b * p.x_sb;
  const bf16* wp = static_cast<const bf16*>(p.w);

  // per-lane offsets of the ldmatrix row addresses
  const int a_col = lane & 15, a_k = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_k = ((lane >> 3) & 1) * 8;

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  for (int c0 = 0; c0 < p.C; c0 += BK) {
    __syncthreads();  // the previous chunk is no longer read
    for (int idx = tid; idx < HALO * CPR; idx += THREADS) {
      const int px = idx / CPR, ch = idx % CPR;
      const int gy = ty0 + px / HW - 1, gx = tx0 + px % HW - 1;
      const int c = c0 + ch * 8;
      const bool ok = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W && c < p.C;
      const bf16* src = ok ? xb + gy * p.x_sh + gx * p.x_sw + c : xb;
      cp_async16(Xs + px * LD + ch * 8, src, ok ? 16 : 0);
    }
    for (int idx = tid; idx < 9 * BN * CPR; idx += THREADS) {
      const int row = idx / CPR, ch = idx % CPR;  // row = tap * BN + channel
      const int tap = row / BN, o = o0 + row % BN;
      const int c = c0 + ch * 8;
      const bool ok = o < p.O && c < p.C;
      const bf16* src =
          ok ? wp + (tap / 3) * p.w_sy + (tap % 3) * p.w_sx + o * p.w_so + c
             : wp;
      cp_async16(Ws + row * LD + ch * 8, src, ok ? 16 : 0);
    }
    cp_async_wait_all();
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4(a[mt], Xs + ((2 * wm + mt + dy) * HW + a_col + dx) * LD +
                                 ks * 16 + a_k);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bq[4];
          ldmatrix_x4(bq, Ws + (tap * BN + wn * WN + np * 16 + b_row) * LD +
                              ks * 16 + b_k);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16_16816(acc[mt][2 * np], a[mt], bq[0], bq[1]);
            mma_bf16_16816(acc[mt][2 * np + 1], a[mt], bq[2], bq[3]);
          }
        }
      }
    }
  }

  bf16* yb = static_cast<bf16*>(p.y);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int gy = ty0 + 2 * wm + mt;
    if (gy >= p.H) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int o = o0 + wn * WN + nt * 8 + 2 * tig;
      if (o >= p.O) continue;  // O is a multiple of 8: o + 1 < O too
      const float b0 = load_bias(p, o), b1 = load_bias(p, o + 1);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gx = tx0 + g + 8 * half;
        if (gx >= p.W) continue;
        const float v0 = finish(acc[mt][nt][2 * half] + b0, p.silu);
        const float v1 = finish(acc[mt][nt][2 * half + 1] + b1, p.silu);
        bf16* dst = yb + (((long long)b * p.H + gy) * p.W + gx) * p.O + o;
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: full-precision FMA body
// ---------------------------------------------------------------------------

template <int BN, int BK>
struct FmaCfg {
  static constexpr int LD = BK + 1;  // floats; odd stride kills conflicts
  static constexpr size_t SMEM = (size_t)(HALO + 9 * BN) * LD * sizeof(float);
};

template <int BN, int BK>
__global__ void __launch_bounds__(THREADS) conv3x3_fma_f32(ConvParams p) {
  constexpr int LD = FmaCfg<BN, BK>::LD;
  constexpr int CPR = BK / 4;  // 16-byte chunks per row
  constexpr int NJ = BN / 16;  // output channels of a thread
  static_assert(THREADS == 16 * TW && BN % 16 == 0 && BK % 4 == 0,
                "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Xs = reinterpret_cast<float*>(smem_raw);  // [HALO][LD]
  float* Ws = Xs + HALO * LD;                      // [9][BN][LD]

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output channels tx + 16 j
  const int tc = tid / 16;  // pixel column of the tile; rows 0..TH-1
  const int ty0 = (blockIdx.x / p.tiles_x) * TH;
  const int tx0 = (blockIdx.x % p.tiles_x) * TW;
  const int o0 = blockIdx.y * BN, b = blockIdx.z;

  const float* xb = static_cast<const float*>(p.x) + (long long)b * p.x_sb;
  const float* wp = static_cast<const float*>(p.w);

  float acc[TH][NJ];
#pragma unroll
  for (int i = 0; i < TH; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < p.C; c0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < HALO * CPR; idx += THREADS) {
      const int px = idx / CPR, ch = idx % CPR;
      const int gy = ty0 + px / HW - 1, gx = tx0 + px % HW - 1;
      const int c = c0 + ch * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gy >= 0 && gy < p.H && gx >= 0 && gx < p.W && c < p.C)
        v = *reinterpret_cast<const float4*>(xb + gy * p.x_sh + gx * p.x_sw + c);
      float* d = Xs + px * LD + ch * 4;
      d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
    }
    for (int idx = tid; idx < 9 * BN * CPR; idx += THREADS) {
      const int row = idx / CPR, ch = idx % CPR;
      const int tap = row / BN, o = o0 + row % BN;
      const int c = c0 + ch * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (o < p.O && c < p.C)
        v = *reinterpret_cast<const float4*>(
            wp + (tap / 3) * p.w_sy + (tap % 3) * p.w_sx + o * p.w_so + c);
      float* d = Ws + row * LD + ch * 4;
      d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const float* xcol = Xs + (dy * HW + tc + dx) * LD;
      const float* wrow = Ws + (tap * BN + tx) * LD;
#pragma unroll 4
      for (int k = 0; k < BK; ++k) {
        float av[TH], bv[NJ];
#pragma unroll
        for (int i = 0; i < TH; ++i) av[i] = xcol[i * HW * LD + k];
#pragma unroll
        for (int j = 0; j < NJ; ++j) bv[j] = wrow[16 * j * LD + k];
#pragma unroll
        for (int i = 0; i < TH; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }

  float* yb = static_cast<float*>(p.y);
  const int gx = tx0 + tc;
  if (gx >= p.W) return;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int o = o0 + tx + 16 * j;
    if (o >= p.O) continue;
    const float bo = load_bias(p, o);
#pragma unroll
    for (int i = 0; i < TH; ++i) {
      const int gy = ty0 + i;
      if (gy < p.H)
        yb[(((long long)b * p.H + gy) * p.W + gx) * p.O + o] =
            finish(acc[i][j] + bo, p.silu);
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, int bn, const ConvParams& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles_y = (p.H + TH - 1) / TH;
  dim3 grid(p.tiles_x * tiles_y, (p.O + bn - 1) / bn, p.B);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* ed_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype of x, w and y: 0 = bf16, 1 = fp32. bias_kind: 0 none, 1 fp32,
// 2 bf16. Returns a cudaError_t, or -1 for a dtype that has no kernel.
extern "C" int ed_conv3x3(const void* x, const void* w, const void* bias,
                          void* y, int B, int H, int W, int C, int O,
                          long long x_sb, long long x_sh, long long x_sw,
                          long long w_sy, long long w_sx, long long w_so,
                          int bias_kind, int silu, int dtype, void* stream) {
  ConvParams p;
  p.x = x; p.w = w; p.bias = bias; p.y = y;
  p.B = B; p.H = H; p.W = W; p.C = C; p.O = O;
  p.x_sb = x_sb; p.x_sh = x_sh; p.x_sw = x_sw;
  p.w_sy = w_sy; p.w_sx = w_sx; p.w_so = w_so;
  p.bias_kind = bias_kind;
  p.silu = silu;
  p.tiles_x = (W + TW - 1) / TW;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    using Cfg = MmaCfg<64, 32>;
    return (int)launch(conv3x3_mma_bf16<64, 32>, Cfg::SMEM, 64, p, st);
  }
  if (dtype == 1) {
    using Cfg = FmaCfg<64, 16>;
    return (int)launch(conv3x3_fma_f32<64, 16>, Cfg::SMEM, 64, p, st);
  }
  return -1;
}
