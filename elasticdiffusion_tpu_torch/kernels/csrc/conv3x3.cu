// 3x3 SAME stride-1 NHWC convolution (+ bias, optional SiLU) for Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel conv3x3 / _kernel of
// elasticdiffusion_tpu/kernels/conv3x3.py. It computes what that kernel
// computes and shares none of its structure: the TPU version builds a
// separate halo operand outside the kernel, takes three sublane-shifted
// copies of its tile and plans blocks against VMEM, all of which answer the
// TPU's DMA and layout rules.
//
// Function: y[b,h,w,o] = act(bias[o] + sum_{dy,dx,c} x[b,h+dy-1,w+dx-1,c] *
// w[dy,dx,c,o]), x zero outside the image. The sum over the 9 taps and C is
// one fp32 accumulation (or, split over blocks, fp32 partial sums added in a
// fixed order); the bias is added in fp32; SiLU, where asked, acts on the
// fp32 sum; one rounding to the type of x.
//
// Operands: x (B,H,W,C) and w (3,3,C,O) with element strides and channel
// stride 1 in both (C is the reduction dim), so the NHWC view of a
// channels_last activation and the HWIO view of a channels_last (O,C,3,3)
// weight are read in place. y is a fresh contiguous (B,H,W,O). C and O are
// multiples of 8 (16-byte rows); H, W, C and O need not be multiples of any
// tile.
//
// Bound on this card: operations (2*9*C*O*B*H*W over the bf16 tensor-core
// peak) at every UNet shape.
//
// conv3x3_wgmma_bf16, the bf16 body, and what it does about that bound:
//   * An implicit matrix product: M = output pixels, N = output channels,
//     K = 9 taps x C. A tile is 128 or 256 pixels (a 16x8 or 16x16 patch of
//     one image, or 8x8 patches of 2 or 4 images where W <= 8: no pixel of a
//     tile is masked at the UNet's latents) by BN output channels (128 or
//     160), and its K loop runs over (64-channel chunk, tap), taps fastest.
//     The wrapper's plan picks the instantiation per shape; 256 pixels halve
//     the B loads a product and most shapes run them.
//   * Operands arrive by TMA, issued by one thread of a producer warpgroup.
//     The A tile of tap (dy, dx) is one box of a 4-D tensor map over
//     (C, W, H, B) at the signed coordinates (c0, x0+dx-1, y0+dy-1, b0):
//     TMA fills what lies outside the image with zeros, which is the SAME
//     padding, so no halo is staged and no tap is a shifted address inside
//     a swizzled tile. The nine re-reads of a pixel come from L2. The B tile
//     is a box of a map over the weight's (C, dx, dy, O) view, K-major.
//     Both use 128-byte rows (64 channels) under the 128-byte swizzle, and
//     a ragged C or O is zero-filled by TMA too.
//   * A ring of 4-6 stages guarded by full/empty mbarriers (sm90.cuh) keeps
//     loads in flight while two consumer warpgroups, 64 or 128 pixels each
//     (one or two 64-row accumulators), run wgmma.m64nBNk16 with fp32
//     accumulators in registers; a stage is given back once the products
//     that read it have retired (wgmma.wait_group 1). setmaxnreg moves
//     registers from the producer to the consumers.
//   * Persistent: one block an SM walks over the output tiles, and the ring
//     runs on from one tile to the next, so the producer loads the next
//     tile's first stages while the consumers run this tile's epilogue.
//   * Epilogue from registers: bias, SiLU, one rounding to bf16, NHWC store.
//   * Too few tiles to fill 132 SMs (the 8x8 and 16x16 latents of SD 1.5):
//     the plan splits each tile's K loop into several work items. Each split
//     writes fp32 partial sums to a workspace the wrapper allocates;
//     conv3x3_splitk_sum adds them in split order (no atomics, the same
//     result on every run), then the bias and SiLU, and rounds once.
//   * C < 64 runs the same body: TMA fills the rest of the 64-channel box
//     with zeros.
//
// conv3x3_mma_f32x3, the fp32 body (the UNet's convolutions under --fp32
// with conv_impl="kernel"), and what it does about its operation bound
// (three times 2*9*C*O*B*H*W over the TF32 tensor cores' 495 TFLOP/s, 2.5
// times below the CUDA cores' fp32 bound; the body reaches about a quarter
// of it):
//   * The same implicit matrix product, on mma.sync.m16n8k8 with TF32
//     operands in three passes (sm90.cuh: each operand split as hi + lo in
//     registers, a_lo b_hi + a_hi b_lo + a_hi b_hi into one fp32
//     accumulator; the fp32 result to a few units of its last place, where
//     one TF32 pass keeps about 3 decimal digits). wgmma was not tried: it
//     would read the weight from shared memory (split once per weight into
//     two copies for TMA) and the activations split in registers.
//   * A tile is 128 consecutive output pixels in (b, h, w) order, across
//     rows and images, by 64 output channels: a pixel's 16-byte cp.async
//     reads its own (tap-shifted) address, and zero fill where it falls
//     outside the image is the SAME padding, so small latents waste no part
//     of a tile. The K loop runs over (32-channel chunk, tap), taps fastest,
//     through a 3-stage cp.async ring loaded under the products of the stage
//     before; eight warps of 32 pixels x 32 channels, two blocks an SM.
//   * The tensor cores' fp32 accumulation does not round to nearest, so a
//     stage's 12 products a fragment go to registers of their own, and the
//     running sum is taken in the CUDA cores.
//   * Where the tiles leave some SMs one item more than others (the small
//     latents, and 160 tiles on 132 SMs), the plan splits the K loop;
//     conv3x3_splitk_sum adds the fp32 partials in split order (no
//     atomics), then the bias and SiLU.
//   * Epilogue from registers: bias and SiLU on the fp32 sum, NHWC store.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

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
  // the wgmma body: pixel tile (tw x th x tb = 128 or 256 pixels), tiles
  // along H, output-channel tiles, K splits and their fp32 workspace
  // (splits, B*H*W, O); the fp32 body: its K splits and workspace
  int tiles_x, tw, th, tb, tiles_y, tiles_n, splits;
  float* ws;
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

// ---------------------------------------------------------------------------
// fp32: three TF32 passes on the tensor cores
// ---------------------------------------------------------------------------

// A tile of BM consecutive output pixels (in (b, h, w) order, across rows
// and images) by BN output channels; the K loop over (BK-channel chunk, tap),
// taps fastest, through a cp.async ring of STAGES stages. Eight warps of 32
// pixels x 32 channels. Rows of a stage are BK floats padded to LD: the
// fragment reads (8 bytes at 8 ks + 2 t of four rows a half-warp) meet no
// bank twice with LD = 8 mod 32.
struct TcConvCfg {
  static constexpr int BM = 128, BN = 64, BK = 32, STAGES = 3, THREADS = 256;
  static constexpr int LD = BK + 8;
  static constexpr int A_FLOATS = BM * LD, B_FLOATS = BN * LD;
  static constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE_FLOATS * sizeof(float);
  static_assert(SMEM <= 232448 / 2, "two blocks an SM");
};

// Split z of p.splits takes K iterations [I z / splits, I (z+1) / splits)
// of the I = 9 ceil(C / BK); with one split the block writes y, with more
// its fp32 partial sums go to p.ws and conv3x3_splitk_sum adds them.
__global__ void __launch_bounds__(256, 2) conv3x3_mma_f32x3(ConvParams p) {
  using Cfg = TcConvCfg;
  constexpr int BM = Cfg::BM, BN = Cfg::BN, BK = Cfg::BK, LD = Cfg::LD,
                STAGES = Cfg::STAGES;
  extern __shared__ __align__(16) float smf[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;  // pixels 32 wm.., channels 32 wn..
  const int HW = p.H * p.W;
  const long long M = (long long)p.B * HW;
  const long long m0 = (long long)blockIdx.x * BM;
  const int o0 = blockIdx.y * BN, split = blockIdx.z;
  const int kiters = 9 * ((p.C + BK - 1) / BK);
  const int k_begin = (int)((long long)kiters * split / p.splits);
  const int nk = (int)((long long)kiters * (split + 1) / p.splits) - k_begin;

  const float* xp = static_cast<const float*>(p.x);
  const float* wp = static_cast<const float*>(p.w);
  // this thread's share of a stage: 16 bytes (channels 4 lc..) of pixel rows
  // lr + 32 i (i < 4) and of output-channel rows lr + 32 i (i < 2)
  const int lr = tid >> 3, lc = tid & 7;
  long long xoff[4];
  int py[4], px[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + lr + 32 * i;
    py[i] = -2;  // past M: every tap reads zeros
    px[i] = 0;
    xoff[i] = 0;
    if (m < M) {
      const int b = (int)(m / HW), r = (int)(m % HW);
      py[i] = r / p.W;
      px[i] = r % p.W;
      xoff[i] = b * p.x_sb + py[i] * p.x_sh + px[i] * p.x_sw;
    }
  }

  auto issue = [&](int i) {
    if (i < nk) {
      const int k = k_begin + i, c = (k / 9) * BK + 4 * lc, tap = k % 9;
      const int dy = tap / 3, dx = tap % 3;
      float* as = smf + (i % STAGES) * Cfg::STAGE_FLOATS;
      float* bs = as + Cfg::A_FLOATS;
      const bool cin = c < p.C;  // C is a multiple of 4: whole 16 bytes
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int y = py[r] + dy - 1, x = px[r] + dx - 1;
        const bool ok = cin && y >= 0 && y < p.H && x >= 0 && x < p.W;
        const float* src =
            xp + xoff[r] + (dy - 1) * p.x_sh + (dx - 1) * p.x_sw + c;
        cp_async16(as + (lr + 32 * r) * LD + 4 * lc, ok ? src : xp,
                   ok ? 16 : 0);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int o = o0 + lr + 32 * r;
        const bool ok = cin && o < p.O;
        cp_async16(bs + (lr + 32 * r) * LD + 4 * lc,
                   ok ? wp + dy * p.w_sy + dx * p.w_sx + o * p.w_so + c : wp,
                   ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float acc[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][n][e] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<STAGES - 2>();  // stage i landed for this thread
    __syncthreads();  // ... for all; the slot of stage i - 1 is free again
    issue(i + STAGES - 1);
    const float* as = smf + (i % STAGES) * Cfg::STAGE_FLOATS + wm * 32 * LD;
    const float* bs = smf + (i % STAGES) * Cfg::STAGE_FLOATS + Cfg::A_FLOATS +
                      wn * 32 * LD;
    // the stage's products into registers of their own, then added to the
    // sum in the CUDA cores: the tensor cores' accumulation does not round
    // to nearest, and a sum carried through all 9 C products drifts toward
    // zero (rel L2 2e-5 at C = 320, 1.5e-4 at 2560 in a development run)
    float part[2][4][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[a][n][e] = 0.f;
    // four k-steps of 8 channels (sm90.cuh, ld_chunk)
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        float lo[2], hi[2];
        ld_chunk<8>(lo, as + (16 * a + g) * LD + 8 * ks + 2 * t);
        ld_chunk<8>(hi, as + (16 * a + g + 8) * LD + 8 * ks + 2 * t);
        split_a(lo[0], hi[0], lo[1], hi[1], ah[a], al[a]);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float bf[2];
        uint32_t bh[2], bl[2];
        ld_chunk<8>(bf, bs + (8 * n + g) * LD + 8 * ks + 2 * t);
        split_b(bf[0], bf[1], bh, bl);
#pragma unroll
        for (int a = 0; a < 2; ++a)
          mma_tf32x3(part[a][n], ah[a], al[a], bh, bl);
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][n][e] += part[a][n][e];
  }
  cp_async_wait<0>();

  // a thread holds channels 8n + 2t + {0, 1} of pixels g and g + 8 of each
  // 16-pixel row tile
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm * 32 + 16 * a + g + 8 * half;
      if (m >= M) continue;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int o = o0 + wn * 32 + 8 * n + 2 * t;
        if (o >= p.O) continue;  // O is a multiple of 8: o + 1 < O too
        const float v0 = acc[a][n][2 * half], v1 = acc[a][n][2 * half + 1];
        if (p.splits == 1)
          *reinterpret_cast<float2*>(static_cast<float*>(p.y) + m * p.O + o) =
              make_float2(finish(v0 + load_bias(p, o), p.silu),
                          finish(v1 + load_bias(p, o + 1), p.silu));
        else
          *reinterpret_cast<float2*>(p.ws + (split * M + m) * p.O + o) =
              make_float2(v0, v1);
      }
    }
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA body
// ---------------------------------------------------------------------------

constexpr int kSMs = 132;  // H100 SXM: the persistent grid of the wgmma body

// BN output channels a tile, STAGES (A, B) tiles in the ring. Two consumer
// warpgroups of MT x 64 pixels and one producer warpgroup.
template <int BN, int STAGES, int MT>
struct WgConvCfg {
  static constexpr int BM = 128 * MT;
  static constexpr int THREADS = 384;
  static constexpr int A_BYTES = BM * 128;  // 64 channels of BM pixels
  static constexpr int B_BYTES = BN * 128;  // 64 channels of BN outputs
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // the producer keeps the work-item arithmetic of the persistent loop
  static constexpr int REGS_PRODUCER = 40;
  static constexpr int REGS_CONSUMER = 232;
  // 1024 bytes of slack to align the tiles, 128 bytes of barriers
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE_BYTES + 128;
  static_assert(B_BYTES % 1024 == 0 && BN % 8 == 0 && BN * MT <= 320,
                "tile: A and B rows, accumulators a consumer thread");
  static_assert(2 * STAGES * 8 <= 128, "barriers");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// One work item of the wgmma body: its output tile and its split's share
// of the K loop, iterations (64-channel chunk, tap) with taps fastest.
struct ConvTile {
  int x0, y0, b0, o0, split, k_begin, nk;
};

template <int BN>
__device__ __forceinline__ ConvTile conv_tile(const ConvParams& p, int item,
                                              int tiles_mn, int kiters) {
  ConvTile t;
  t.split = item / tiles_mn;
  const int r = item % tiles_mn;
  const int m_tile = r / p.tiles_n;
  t.o0 = (r % p.tiles_n) * BN;
  t.x0 = (m_tile % p.tiles_x) * p.tw;
  t.y0 = ((m_tile / p.tiles_x) % p.tiles_y) * p.th;
  t.b0 = (m_tile / (p.tiles_x * p.tiles_y)) * p.tb;
  t.k_begin = (int)((long long)kiters * t.split / p.splits);
  t.nk = (int)((long long)kiters * (t.split + 1) / p.splits) - t.k_begin;
  return t;
}

template <int BN, int STAGES, int MT>
__global__ void __launch_bounds__(384, 1)
    conv3x3_wgmma_bf16(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_w,
                       ConvParams p) {
  using Cfg = WgConvCfg<BN, STAGES, MT>;
  extern __shared__ unsigned char smem_dyn[];
  // the swizzle works on address bits: tiles start on 1024-byte boundaries
  unsigned char* base =
      smem_dyn + ((1024u - (smem_u32(smem_dyn) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + STAGES * Cfg::STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  // work items: (split, pixel tile, channel tile), channel tiles fastest,
  // so the blocks that read the same pixels run side by side; a block takes
  // items blockIdx.x, + gridDim.x, ... and the ring runs on across them
  const int tiles_mn = p.tiles_x * p.tiles_y * ((p.B + p.tb - 1) / p.tb) *
                       p.tiles_n;
  const int items = tiles_mn * p.splits;
  const int kiters = 9 * ((p.C + 63) / 64);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        Cfg::REGS_PRODUCER));
    if (threadIdx.x == 256) {
      int g = 0;  // iterations so far, over all of this block's items
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const ConvTile t = conv_tile<BN>(p, item, tiles_mn, kiters);
        for (int i = 0; i < t.nk; ++i, ++g) {
          const int st = g % STAGES;
          const uint32_t use = g / STAGES;
          // the first time round the ring every stage is free
          mbar_wait(&empty[st], (use & 1u) ^ 1u);
          mbar_arrive_expect_tx(&full[st], Cfg::STAGE_BYTES);
          const int k = t.k_begin + i, c0 = (k / 9) * 64, tap = k % 9;
          const int dy = tap / 3, dx = tap % 3;
          unsigned char* a = base + st * Cfg::STAGE_BYTES;
          tma_load_4d(a, &map_x, &full[st], c0, t.x0 + dx - 1, t.y0 + dy - 1,
                      t.b0);
          tma_load_4d(a + Cfg::A_BYTES, &map_w, &full[st], c0, dx, dy, t.o0);
        }
      }
    }
  } else {
    // ---- consumers: 64 MT pixels each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        Cfg::REGS_CONSUMER));
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const long long M = (long long)p.B * p.H * p.W;
    // rows wg * 64 MT + 64 mt + (0..63) of the tile, mt < MT
    float acc[MT][BN / 2];
    int g = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const ConvTile t = conv_tile<BN>(p, item, tiles_mn, kiters);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0.f;
      for (int i = 0; i < t.nk; ++i, ++g) {
        const int st = g % STAGES;
        mbar_wait(&full[st], (g / STAGES) & 1);
        const unsigned char* a = base + st * Cfg::STAGE_BYTES;
        const uint64_t b_desc = smem_desc_sw128(a + Cfg::A_BYTES);
        wgmma_fence();
        // four k-steps of 16 channels: 32 bytes into the 128-byte rows
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            wgmma_ss<BN>(acc[mt],
                         smem_desc_sw128(a + (wg * MT + mt) * 64 * 128) + 2 * ks,
                         b_desc + 2 * ks, 1);
        wgmma_commit();
        // the products of the iteration before have retired: give its
        // stage back
        wgmma_wait<1>();
        if (i > 0 && lane == 0) mbar_arrive(&empty[(g - 1) % STAGES]);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) pin(acc[mt]);
      // the producer may fill the last stage with the next item's tiles
      // while this one's epilogue runs
      if (lane == 0) mbar_arrive(&empty[(g - 1) % STAGES]);

      // a thread holds columns 8j + 2(lane % 4) + {0, 1} of rows lane / 4
      // (acc[4j], acc[4j+1]) and lane / 4 + 8 (acc[4j+2], acc[4j+3]) of
      // its warp's 16 pixels
      const int cbase = t.o0 + 2 * (lane & 3);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = (wg * MT + mt) * 64 + warp * 16 + (lane >> 2) + 8 * half;
        const int gx = t.x0 + m % p.tw, gy = t.y0 + (m / p.tw) % p.th;
        const int gb = t.b0 + m / (p.tw * p.th);
        if (gx >= p.W || gy >= p.H || gb >= p.B) continue;
        const long long pix = ((long long)gb * p.H + gy) * p.W + gx;
        const float* r = acc[mt];
        if (p.splits == 1) {
          bf16* dst = static_cast<bf16*>(p.y) + pix * p.O;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int o = cbase + 8 * j;
            if (o >= p.O) continue;  // O is a multiple of 8: o + 1 < O too
            const float v0 =
                finish(r[4 * j + 2 * half] + load_bias(p, o), p.silu);
            const float v1 =
                finish(r[4 * j + 2 * half + 1] + load_bias(p, o + 1), p.silu);
            *reinterpret_cast<__nv_bfloat162*>(dst + o) =
                __floats2bfloat162_rn(v0, v1);
          }
        } else {
          float* dst = p.ws + ((long long)t.split * M + pix) * p.O;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int o = cbase + 8 * j;
            if (o >= p.O) continue;
            *reinterpret_cast<float2*>(dst + o) =
                make_float2(r[4 * j + 2 * half], r[4 * j + 2 * half + 1]);
          }
        }
      }
    }
  }
}

// y = act(bias + sum of the splits' partial sums, split 0 first), rounded
// once to OutT; four outputs a thread
__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void store4(bf16* dst, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
}

template <typename OutT>
__global__ void __launch_bounds__(256) conv3x3_splitk_sum(ConvParams p) {
  const long long MO = (long long)p.B * p.H * p.W * p.O;
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= MO) return;
  float4 s = *reinterpret_cast<const float4*>(p.ws + i);
  for (int z = 1; z < p.splits; ++z) {
    const float4 t = *reinterpret_cast<const float4*>(p.ws + z * MO + i);
    s.x += t.x;
    s.y += t.y;
    s.z += t.z;
    s.w += t.w;
  }
  const int o = (int)(i % p.O);
  store4(static_cast<OutT*>(p.y) + i,
         make_float4(finish(s.x + load_bias(p, o), p.silu),
                     finish(s.y + load_bias(p, o + 1), p.silu),
                     finish(s.z + load_bias(p, o + 2), p.silu),
                     finish(s.w + load_bias(p, o + 3), p.silu)));
}

template <typename OutT>
cudaError_t launch_splitk_sum(const ConvParams& p, cudaStream_t stream) {
  const long long groups = (long long)p.B * p.H * p.W * p.O / 4;
  conv3x3_splitk_sum<OutT>
      <<<(unsigned)((groups + 255) / 256), 256, 0, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_mma_f32(const ConvParams& p, cudaStream_t stream) {
  using Cfg = TcConvCfg;
  const int kiters = 9 * ((p.C + Cfg::BK - 1) / Cfg::BK);
  if (p.splits < 1 || p.splits > kiters || (p.splits > 1 && p.ws == nullptr))
    return cudaErrorInvalidValue;
  auto kernel = conv3x3_mma_f32x3;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cfg::SMEM);
  if (err != cudaSuccess) return err;
  const long long M = (long long)p.B * p.H * p.W;
  dim3 grid((unsigned)((M + Cfg::BM - 1) / Cfg::BM),
            (p.O + Cfg::BN - 1) / Cfg::BN, p.splits);
  kernel<<<grid, Cfg::THREADS, Cfg::SMEM, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  return launch_splitk_sum<float>(p, stream);
}

// The tensor maps are encoded on the host at every launch and travel by
// value in the kernel's parameters: x as (C, W, H, B), boxes of 64 channels
// of a tw x th x tb pixel tile; w as (C, dx, dy, O), boxes of 64 channels of
// BN output channels.
template <int BN, int STAGES, int MT>
cudaError_t launch_wgmma(ConvParams p, cudaStream_t stream) {
  using Cfg = WgConvCfg<BN, STAGES, MT>;
  if (p.tw * p.th * p.tb != Cfg::BM || p.splits < 1 ||
      p.splits > 9 * ((p.C + 63) / 64) || (p.splits > 1 && p.ws == nullptr))
    return cudaErrorInvalidValue;
  p.tiles_x = (p.W + p.tw - 1) / p.tw;
  p.tiles_y = (p.H + p.th - 1) / p.th;
  p.tiles_n = (p.O + BN - 1) / BN;
  const long long tiles_b = (p.B + p.tb - 1) / p.tb;
  CUtensorMap map_x, map_w;
  if (!make_map_4d_bf16(&map_x, p.x, {p.C, p.W, p.H, p.B},
                        {p.x_sw, p.x_sh, p.x_sb}, {64, p.tw, p.th, p.tb}) ||
      !make_map_4d_bf16(&map_w, p.w, {p.C, 3, 3, p.O}, {p.w_sx, p.w_sy, p.w_so},
                        {64, 1, 1, BN}))
    return cudaErrorInvalidValue;
  auto kernel = conv3x3_wgmma_bf16<BN, STAGES, MT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cfg::SMEM);
  if (err != cudaSuccess) return err;
  // one block an SM, each walking over the work items
  const long long items =
      tiles_b * p.tiles_x * p.tiles_y * p.tiles_n * p.splits;
  const unsigned grid = (unsigned)(items > kSMs ? kSMs : items);
  kernel<<<grid, Cfg::THREADS, Cfg::SMEM, stream>>>(map_x, map_w, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  return launch_splitk_sum<bf16>(p, stream);
}

}  // namespace

extern "C" const char* ed_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype of x, w and y: 0 = bf16, 1 = fp32. bias_kind: 0 none, 1 fp32,
// 2 bf16. plan: 0 = the fp32 body (three TF32 passes; tw, th, tb unused);
// 1-4 = the bf16 wgmma body with 128 pixels by 128 (1) or 160 (2) output
// channels a tile, or 256 pixels by 128 (3) or 160 (4), a (tw, th, tb) pixel
// tile of that many pixels. Both take `splits` K splits whose partial sums
// go to `ws` (splits x B*H*W x O floats; unused at one split). Returns a
// cudaError_t, or -1 for a (dtype, plan) that has no kernel.
extern "C" int ed_conv3x3(const void* x, const void* w, const void* bias,
                          void* y, int B, int H, int W, int C, int O,
                          long long x_sb, long long x_sh, long long x_sw,
                          long long w_sy, long long w_sx, long long w_so,
                          int bias_kind, int silu, int dtype, int plan,
                          int tw, int th, int tb, int splits, void* ws,
                          void* stream) {
  ConvParams p;
  p.x = x; p.w = w; p.bias = bias; p.y = y;
  p.B = B; p.H = H; p.W = W; p.C = C; p.O = O;
  p.x_sb = x_sb; p.x_sh = x_sh; p.x_sw = x_sw;
  p.w_sy = w_sy; p.w_sx = w_sx; p.w_so = w_so;
  p.bias_kind = bias_kind;
  p.silu = silu;
  p.tiles_x = 0;
  p.tw = tw; p.th = th; p.tb = tb;
  p.tiles_y = 0; p.tiles_n = 0;
  p.splits = splits;
  p.ws = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && plan == 1) return (int)launch_wgmma<128, 6, 1>(p, st);
  if (dtype == 0 && plan == 2) return (int)launch_wgmma<160, 5, 1>(p, st);
  if (dtype == 0 && plan == 3) return (int)launch_wgmma<128, 4, 2>(p, st);
  if (dtype == 0 && plan == 4) return (int)launch_wgmma<160, 4, 2>(p, st);
  if (dtype == 1 && plan == 0) return (int)launch_mma_f32(p, st);
  return -1;
}
