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
// Four bodies:
//   flash_wgmma_bf16    bf16 inputs, head dims 64 (every UNet attention of
//                       SD 2.x and SDXL) and 40 / 80 / 160 (SD 1.x UNet, 8
//                       heads per block), self and cross: the body designed
//                       for this card, described below.
//   flash_fma_f32_d512  fp32 inputs, head dim 512 (the VAE mid block of the
//                       SDXL fp32 decode and of the fp32 strip encodes):
//                       register-tiled full-precision FMAs with split keys,
//                       described further below.
//   flash_wgmma_bf16_d512
//                       bf16 inputs, head dim 512 (the VAE mid block of the
//                       SD 1.x / 2.x decodes): the wgmma body with the head
//                       dim split over two consumer warpgroups and split
//                       keys, described further below.
//   flash_mma_f32x3     fp32 inputs at head dims 40 / 64 / 80 / 160 (every
//                       UNet attention under --fp32): both products in
//                       three TF32 passes on the tensor cores, described
//                       further below.
// The fp32 bodies keep fp32 accuracy: flash_fma_f32_d512 in full-precision
// FMAs, as the JAX kernel's Precision.HIGHEST; flash_mma_f32x3 in three TF32
// passes, each operand split as hi + lo, which hold the fp32 product to a
// few units of its last place (the JAX one-shot kernel it replaces pins
// Precision.DEFAULT, one bf16 pass on a TPU; the port holds fp32 to 2e-5).
//
// Bound on this card: operations (4*B*H*Sq*Sk*D over the bf16 tensor-core
// peak; in fp32 at D = 512 over the CUDA cores' 67 TFLOP/s, and three times
// as many over the TF32 tensor cores' 495 at the other head dims, which run
// three TF32 passes) for self-attention;
// the q and output bytes for cross-attention (Sk = 77). At D = 64 a 128-key
// tile costs the tensor cores and the exponential unit about the same number
// of cycles, so the two must overlap.
//
// flash_wgmma_bf16, and what each part does about that bound:
//   * Both products are wgmma.mma_async. A consumer warpgroup owns 64 query
//     rows. S = Q K^T reads Q and K from shared memory, both K-major (D
//     contiguous, as the (B, S, H*D) projections give them). O += P V takes
//     P from registers: the fp32 accumulator layout of S, packed to bf16
//     pairs, is the A-fragment layout of the next wgmma; V is read from
//     shared memory as the MN-major (transposed) B operand. S and P never
//     pass through shared memory.
//   * The softmax runs in registers. A thread holds two rows' slices of S;
//     the row max is a 4-lane shuffle inside the quad; the running max and
//     the per-thread partial denominator stay in registers (the quad sum of
//     the denominator is taken once, at the end); O is rescaled in registers
//     after wgmma.wait_group.
//   * One elected thread of a producer warpgroup loads Q once and the K and V
//     tiles into a ring of stages with TMA (cp.async.bulk.tensor.4d on a
//     (D, H, S, B) tensor map built from the strides of the views, 128-byte
//     swizzle, rows past the end of a sequence filled with zeros). Each stage
//     has a full and an empty mbarrier. Loads, tensor cores and the
//     exponential unit run at the same time: inside a warpgroup S of tile j
//     and P V of tile j-1 are in flight while the softmax of tile j runs, and
//     the two consumer warpgroups of a block interleave freely.
//   * With two consumer warpgroups (128 query rows, one block per SM) the
//     producer gives its registers to the consumers (setmaxnreg, 24 and 240).
//     With one (64 query rows and 64-key tiles, two blocks per SM, one at
//     D = 160; chosen by the wrapper when 128-row blocks would leave SMs
//     idle) the registers a thread starts with are enough.
//   * Self-attention uses 128-key tiles and a ring of 3 stages; Sk <= 80 (the
//     77 text tokens) is one tile of 80 keys (wgmma N = 80), no ring, and
//     64-row blocks, two on an SM, because that chain of one load, two small
//     products and one store is bound by latency. Keys past Sk are masked to
//     -inf before the max, so a ragged last tile needs no second code path.
//     Rows past Sq are computed on zeros and not stored.
//   * Other head dims run in the same 64-column (128-byte) rows. The tensor
//     map's innermost dim is D and its box 64 wide, so TMA fills the columns
//     of a box past D with zeros (the next head is another coordinate, not
//     the next column). D = 40 is one such slab: Q K^T takes 3 k-steps
//     instead of 4, P V is a wgmma of N = 40 on the first 40 columns of V's
//     rows, and 40 columns are stored. D = 80 and 160 are 2 and 3 slabs, each
//     a tile of its own: k-step ks of Q K^T reads slab ks / 4, and P V is one
//     wgmma per slab (N = 64, 64, 32 or 64, 16) into its own accumulators. A
//     narrow last slab wastes shared memory, not time; D = 160 uses 64-key
//     tiles so that the ring still fits.
//   * Output: registers to global memory with masked 4-byte stores (a quad
//     writes 16 contiguous bytes of a row, the two n-tiles of a 32-byte
//     sector back to back). A TMA store through shared memory is not used.
//   * A barrier wait that outlasts some seconds traps: a fault in the
//     protocol is a CUDA error at the next synchronise, not a hang.
//
// flash_fma_f32_d512, and what it does about the fp32 operation bound (at
// D = 512 the exponentials are 1/1024 of the work: the two products are it):
//   * A block owns 64 query rows with 256 threads, and each thread a
//     register micro-tile of both products: 4 rows x 4 keys of S = Q K^T
//     (operands read from shared memory as float4 along the head dim: 64
//     FMAs for 8 loads) and 8 rows x 16 head dims of O += P V (float4 rows
//     of P and V: 512 FMAs for 24 loads). The 64 x 512 fp32 accumulator of
//     O is 128 registers a thread, resident for the whole key loop.
//   * Q is loaded once and stays in shared memory. Each 64-key tile streams
//     through a ring of 2 slots, filled with cp.async one item ahead: 4 K
//     chunks of 128 head dims, then 4 V chunks of 16 keys x 512 dims, so the
//     loads of the next chunk run under the FMAs of the current one (each
//     is 2048 FMAs a thread: the block's barriers are few).
//   * S stays in registers through the online softmax (max and sum over a
//     row's 16 threads are half-warp shuffles; each thread keeps its share
//     of the denominator); P and the rescale factors pass through shared
//     memory once, to the threads of the P V layout.
//   * Where 64-row blocks cannot fill 132 SMs evenly (the strip encodes at
//     704-2816 tokens, and the 576 blocks of a 36864-token decode), the wrapper
//     splits the keys over blocks: each split writes its unnormalised O and
//     its rows' running max and denominator in fp32 to a workspace, and
//     flash_combine merges them in split order (no atomics).
//
// flash_wgmma_bf16_d512, and what it does about the bf16 operation bound
// (the 64 x 512 fp32 O accumulator of a 64-row wgmma tile is 256 registers
// a thread: more than one warpgroup can hold):
//   * A block owns 64 query rows with three warpgroups. Consumer warpgroup w
//     owns head dims [256 w, 256 w + 256) of Q, K, V and O: its half of O is
//     64 x 256 fp32, 128 registers a thread.
//   * S = Q K^T in two halves: each consumer computes its half-D partial S
//     of a 32-key tile with wgmma (16 k-steps, N = 32). The two partials meet
//     in shared memory behind a named barrier of the 256 consumer threads
//     (8 KB a warpgroup, two parities so that a tile's writes never meet the
//     other warpgroup's reads of the tile before); each adds the other's to
//     its own, and IEEE addition is commutative, so both hold the same S and
//     run the same online softmax in registers. P, packed to bf16 pairs from
//     the accumulator layout, is the register A operand of each consumer's
//     P V wgmmas (N = 64, one a 64-column slab of V, MN-major).
//   * Registers are the limit: ptxas compiles the whole kernel within the
//     168 registers a thread that 384 threads allow (setmaxnreg moves them
//     at run time, not in the compiler's budget), and O, S and P take 152
//     of them. So every shared-memory address and descriptor of the key
//     loop is a constant offset from one 32-bit base that the loop re-reads
//     as opaque at each tile; hoisted out of the loop, the descriptors
//     spilled, and the spills slowed the loop. Q in registers (64 more a
//     thread), two chains of S products, and S of the next tile in flight
//     under the softmax each need more registers, and each was slower for
//     its spills in development runs.
//   * One elected thread of the producer warpgroup loads Q once (64 KB, it
//     stays) and the K and V tiles by TMA into two rings of two slots (32 KB a
//     slot), each slot with a full and an empty mbarrier. K and V have rings
//     of their own because they are released at different times: a K slot
//     when S of its tile is done, a V slot when P V of its tile is done. The
//     next K tile then loads under the softmax and P V of the current one.
//     Inside a consumer, S of tile j and P V of tile j-1 are in flight under
//     the exchange and the softmax of tile j.
//   * Keys split over blocks where the query rows cannot fill the card (6144
//     and 9216 tokens give 96 and 144 blocks of 64 rows on 132 SMs): as in
//     the fp32 body, each split writes its unnormalised fp32 O and its rows'
//     (m, l) to a workspace, and flash_combine merges them in split order
//     and writes bf16. No atomics.
//
// flash_mma_f32x3, and what it does about its operation bound (three TF32
// passes over the tensor cores' 495 TFLOP/s, 2.5 times below the CUDA
// cores' fp32 bound; the body reaches about a fifth of it at 4096 tokens):
//   * Both products are mma.sync.m16n8k8 with TF32 operands, three passes
//     each (sm90.cuh: a_lo b_hi + a_hi b_lo + a_hi b_hi into one fp32
//     accumulator; the dropped a_lo b_lo is below 2^-21 of the product).
//     Operands are split in registers as they are read: each value of Q once
//     for a tile, of K, V and P once a warp. Four warps of 16 query rows a
//     block (two warps, to fill the card at batches 2 and 3 at 256 tokens,
//     were slower at every shape in a development run).
//   * The tensor cores' fp32 accumulation does not round to nearest: a sum
//     carried through thousands of products drifts toward zero (3e-5 rel
//     L2 at 4096 keys). So each key tile's P V goes to registers of its
//     own, and O = alpha O + P V is taken in the CUDA cores; S is fresh at
//     every tile (at most 60 products).
//   * wgmma (not tried) reads its B operand from shared memory, K-major in
//     TF32: V is MN-major, so every K and V tile would need a split (and V
//     a transposed) copy there before the tensor cores could read it.
//     mma.sync takes its TF32 fragments from registers, so K and V are read
//     once from the tile that cp.async wrote.
//   * The order of the reduction dim inside a product is free, so Q and K
//     are read in chunks of 32 head dims with two 16-byte loads a fragment
//     row (sm90.cuh, ld_chunk). P V takes P from S's accumulator registers
//     (k-step j: keys 8j + 2t and 8j + 2t + 1, read in that order from V's
//     rows), so S and P never pass through shared memory, and the online
//     softmax runs on those registers as in the bf16 body (softmax_regs).
//   * D = 40 and 80 compute on exactly D columns: chunks of 32, then one of
//     8 or 16 head dims for Q K^T, and D / 8 column tiles of P V.
//   * K and V tiles (64 keys; 32 at D = 80 and 160) stream through a
//     cp.async ring of 2 stages with zero fill past Sk, loaded under the
//     products of the tile before; keys past Sk are masked to -inf before
//     the max. Rows of LD = 4 mod 32 floats keep the fragment reads free of
//     bank conflicts.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

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

// ---------------------------------------------------------------------------
// bf16, head dim 64: wgmma + TMA body
// ---------------------------------------------------------------------------

// D (64 x N) += A (64 x 16, bf16 pairs in registers) * B (16 x N, shared,
// MN-major: rows are the reduction dim); N = 64, or the first 40, 32 or 16
// columns of the 64-wide rows.
__device__ __forceinline__ void wgmma_rs_n64(float* d, uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n40(float* d, uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float* d, uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n16(float* d, uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint64_t db) {
  static_assert(N == 64 || N == 40 || N == 32 || N == 16, "slab width");
  if constexpr (N == 64) wgmma_rs_n64(d, a0, a1, a2, a3, db);
  if constexpr (N == 40) wgmma_rs_n40(d, a0, a1, a2, a3, db);
  if constexpr (N == 32) wgmma_rs_n32(d, a0, a1, a2, a3, db);
  if constexpr (N == 16) wgmma_rs_n16(d, a0, a1, a2, a3, db);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D is the true head dim. Shared-memory rows are 64 columns (128 bytes, one
// swizzle span) wide: a head dim above 64 is cut into slabs of 64 columns,
// each a tile of its own, and what a slab holds past column D is zeros.
// NCWG consumer warpgroups (64 query rows each) and one producer warpgroup;
// BN keys per tile; STAGES (K, V) tiles in the ring.
template <int D, int NCWG, int BN, int STAGES>
struct WgCfg {
  static constexpr int NSLAB = (D + 63) / 64;
  static constexpr int BM = 64 * NCWG;
  static constexpr int THREADS = 128 * (NCWG + 1);
  // Three warpgroups start with 168 registers a thread; the producer hands
  // its share to the consumers. Two warpgroups run two blocks on an SM with
  // 128 registers a thread where O, S and P fit them (the compiler does not
  // raise its budget past a bound set for two blocks), else one.
  static constexpr bool REBALANCE = NCWG == 2;
  static constexpr int MIN_BLOCKS =
      (NCWG == 1 && D / 2 + BN / 2 + BN / 4 <= 96) ? 2 : 1;
  static constexpr int REGS_PRODUCER = 24;
  static constexpr int REGS_CONSUMER = 240;
  static constexpr int Q_SLAB = BM * 128, Q_BYTES = NSLAB * Q_SLAB;
  static constexpr int SLAB = BN * 128, TILE_BYTES = NSLAB * SLAB;
  // 1024 bytes of slack to align the tiles, 128 bytes of barriers
  static constexpr size_t SMEM =
      1024 + Q_BYTES + (size_t)STAGES * 2 * TILE_BYTES + 128;
  static_assert(D % 8 == 0 && NSLAB <= 3, "head dim");
  static_assert(SLAB % 1024 == 0 && (1 + 2 * STAGES) * 8 <= 128, "smem");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// columns of slab `i` of a head dim D that hold values
template <int D>
__host__ __device__ constexpr int slab_width(int i) {
  return D - 64 * i < 64 ? D - 64 * i : 64;
}

// One key tile of the online softmax on the accumulator registers of S: a
// thread holds columns 8j + 2(lane % 4) + {0, 1} of rows lane / 4 (s[4j],
// s[4j+1]) and lane / 4 + 8 (s[4j+2], s[4j+3]) of its warp's 16 rows. Leaves
// the fp32 P in s, the rescale factors of the two rows in a0 and a1, and
// updates the running max m and the thread's partial denominator l.
template <int NS>
__device__ __forceinline__ void softmax_regs(float (&s)[NS], int valid,
                                             float c, float& m0, float& m1,
                                             float& l0, float& l1, float& a0,
                                             float& a1, int lane) {
  if (valid < NS * 2) {  // ragged last tile: keys past Sk leave the max and sum
    const int col0 = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
      if (8 * j + col0 >= valid) s[4 * j] = s[4 * j + 2] = -INFINITY;
      if (8 * j + col0 + 1 >= valid) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
    }
  }
  float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    t0 = fmaxf(t0, fmaxf(s[4 * j], s[4 * j + 1]));
    t1 = fmaxf(t1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 1));
  t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 1));
  t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 2));
  t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 2));
  const float n0 = fmaxf(m0, t0), n1 = fmaxf(m1, t1);
  a0 = ex2((m0 - n0) * c);  // 0 on the first tile
  a1 = ex2((m1 - n1) * c);
  m0 = n0;
  m1 = n1;
  const float b0 = -n0 * c, b1 = -n1 * c;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    s[4 * j] = ex2(fmaf(s[4 * j], c, b0));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], c, b0));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], c, b1));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], c, b1));
    sum0 += s[4 * j] + s[4 * j + 1];
    sum1 += s[4 * j + 2] + s[4 * j + 3];
  }
  l0 = l0 * a0 + sum0;
  l1 = l1 * a1 + sum1;
}

// S = Q K^T of one key tile: ceil(D / 16) k-steps of 16 head dims; k-step ks
// lies in slab ks / 4, 32 * (ks % 4) bytes inside the swizzled 128-byte rows
// (the last k-step of D = 40 is half zeros).
template <int D, int BN>
__device__ __forceinline__ void start_s(float (&s)[BN / 2],
                                        const unsigned char* q_rows,
                                        int q_slab_bytes,
                                        const unsigned char* k_tile) {
#pragma unroll
  for (int ks = 0; ks < (D + 15) / 16; ++ks) {
    const uint64_t q_desc = smem_desc_sw128(q_rows + (ks / 4) * q_slab_bytes);
    const uint64_t k_desc = smem_desc_sw128(k_tile + (ks / 4) * BN * 128);
    wgmma_ss<BN>(s, q_desc + 2 * (ks % 4), k_desc + 2 * (ks % 4), ks > 0);
  }
  wgmma_commit();
}

// O += P V of one key tile: BN / 16 k-steps of 16 keys (16 rows of V, 2048
// bytes), each one wgmma per slab of V's columns; the accumulators of slab i
// are o[32 i ...].
template <int D, int BN>
__device__ __forceinline__ void start_pv(float (&o)[D / 2],
                                         const uint32_t (&pk)[BN / 4],
                                         const unsigned char* v_tile) {
  constexpr int NSLAB = (D + 63) / 64;
#pragma unroll
  for (int ks = 0; ks < BN / 16; ++ks) {
    const uint32_t a0 = pk[4 * ks], a1 = pk[4 * ks + 1], a2 = pk[4 * ks + 2],
                   a3 = pk[4 * ks + 3];
    wgmma_rs<slab_width<D>(0)>(o, a0, a1, a2, a3,
                               smem_desc_sw128(v_tile) + 128 * ks);
    if constexpr (NSLAB > 1)
      wgmma_rs<slab_width<D>(1)>(
          o + 32, a0, a1, a2, a3,
          smem_desc_sw128(v_tile + BN * 128) + 128 * ks);
    if constexpr (NSLAB > 2)
      wgmma_rs<slab_width<D>(2)>(
          o + 64, a0, a1, a2, a3,
          smem_desc_sw128(v_tile + 2 * BN * 128) + 128 * ks);
  }
  wgmma_commit();
}

// The accumulator layout of S, rounded to bf16 pairs, is the A fragment of
// the next wgmma.
template <int NS>
__device__ __forceinline__ void pack_p(const float (&s)[NS],
                                       uint32_t (&pk)[NS / 2]) {
#pragma unroll
  for (int i = 0; i < NS / 2; ++i) pk[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

template <int D, int NCWG, int BN, int STAGES>
__global__ void __launch_bounds__(WgCfg<D, NCWG, BN, STAGES>::THREADS,
                                  WgCfg<D, NCWG, BN, STAGES>::MIN_BLOCKS)
    flash_wgmma_bf16(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, AttnParams p) {
  using Cfg = WgCfg<D, NCWG, BN, STAGES>;
  constexpr int BM = Cfg::BM, TILE_BYTES = Cfg::TILE_BYTES,
                NSLAB = Cfg::NSLAB;
  constexpr int NS = BN / 2;  // fp32 registers of S per thread

  extern __shared__ unsigned char smem_dyn[];
  // the swizzle works on address bits: tiles start on 1024-byte boundaries
  unsigned char* base =
      smem_dyn + ((1024u - (smem_u32(smem_dyn) & 1023u)) & 1023u);
  unsigned char* Qs = base;                  // NSLAB slabs of BM rows
  unsigned char* KVs = base + Cfg::Q_BYTES;  // stage s: K, then V, in slabs
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(KVs + STAGES * 2 * TILE_BYTES);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + STAGES;

  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int nt = (p.Sk + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCWG * 4);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == NCWG) {
    // ---- producer: the whole lifetime of this warpgroup ----
    if (Cfg::REBALANCE)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          Cfg::REGS_PRODUCER));
    if (threadIdx.x == NCWG * 128) {
      mbar_arrive_expect_tx(q_bar, Cfg::Q_BYTES);
#pragma unroll
      for (int i = 0; i < NSLAB; ++i)
        tma_load_4d(Qs + i * Cfg::Q_SLAB, &tq, q_bar, 64 * i, h, q0, b);
      for (int j = 0; j < nt; ++j) {
        const int st = j % STAGES;
        const uint32_t use = j / STAGES;
        // the first time round the ring every stage is free
        mbar_wait(&empty[st], (use & 1u) ^ 1u);
        mbar_arrive_expect_tx(&full[st], 2 * TILE_BYTES);
        unsigned char* ks = KVs + st * 2 * TILE_BYTES;
#pragma unroll
        for (int i = 0; i < NSLAB; ++i) {
          tma_load_4d(ks + i * Cfg::SLAB, &tk, &full[st], 64 * i, h, j * BN, b);
          tma_load_4d(ks + TILE_BYTES + i * Cfg::SLAB, &tv, &full[st], 64 * i,
                      h, j * BN, b);
        }
      }
    }
  } else {
    // ---- consumer: 64 query rows ----
    if (Cfg::REBALANCE)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
          Cfg::REGS_CONSUMER));
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const unsigned char* q_rows = Qs + wg * 64 * 128;

    float o[D / 2], s[NS];
    uint32_t pk[NS / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, a0, a1;

    mbar_wait(q_bar, 0);
    mbar_wait(&full[0], 0);
    wgmma_fence();
    start_s<D, BN>(s, q_rows, Cfg::Q_SLAB, KVs);
    wgmma_wait<0>();
    pin(s);
    softmax_regs<NS>(s, p.Sk, p.c, m0, m1, l0, l1, a0, a1, lane);
    pack_p<NS>(s, pk);

    for (int j = 1; j < nt; ++j) {
      const int st = j % STAGES, prev = (j - 1) % STAGES;
      mbar_wait(&full[st], (j / STAGES) & 1);
      wgmma_fence();
      // S of tile j, and behind it in the tensor cores O += P V of tile j-1
      start_s<D, BN>(s, q_rows, Cfg::Q_SLAB, KVs + st * 2 * TILE_BYTES);
      start_pv<D, BN>(o, pk, KVs + prev * 2 * TILE_BYTES + TILE_BYTES);
      wgmma_wait<1>();  // S is there; P V runs under the softmax
      pin(s);
      softmax_regs<NS>(s, p.Sk - j * BN, p.c, m0, m1, l0, l1, a0, a1, lane);
      wgmma_wait<0>();
      pin(o);
      pin(pk);
      pin(s);
      if (lane == 0) mbar_arrive(&empty[prev]);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[4 * i] *= a0;
        o[4 * i + 1] *= a0;
        o[4 * i + 2] *= a1;
        o[4 * i + 3] *= a1;
      }
      pack_p<NS>(s, pk);
    }
    wgmma_fence();
    start_pv<D, BN>(o, pk,
                    KVs + ((nt - 1) % STAGES) * 2 * TILE_BYTES + TILE_BYTES);
    wgmma_wait<0>();
    pin(o);
    pin(pk);

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    const int row_lo = q0 + wg * 64 + warp * 16 + (lane >> 2);
    const int row_hi = row_lo + 8;
    bf16* op = static_cast<bf16*>(p.o) + h * D + 2 * (lane & 3);
    bf16* dst_lo = op + ((long long)b * p.Sq + row_lo) * p.H * D;
    bf16* dst_hi = op + ((long long)b * p.Sq + row_hi) * p.H * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      if (row_lo < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(dst_lo + 8 * i) =
            __floats2bfloat162_rn(o[4 * i] * i0, o[4 * i + 1] * i0);
      if (row_hi < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(dst_hi + 8 * i) =
            __floats2bfloat162_rn(o[4 * i + 2] * i1, o[4 * i + 3] * i1);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, head dim 512: wgmma + TMA body, the head dim split over two
// consumer warpgroups
// ---------------------------------------------------------------------------

// 64 query rows, 32-key tiles; consumer warpgroup w owns the four 64-column
// slabs 4w..4w+3 of Q, K, V and O.
struct W512Cfg {
  static constexpr int D = 512, BM = 64, BN = 32, THREADS = 384, SLOTS = 2;
  static constexpr int Q_SLAB = BM * 128, Q_BYTES = 8 * Q_SLAB;  // 64 KB
  static constexpr int SLAB = BN * 128, TILE_BYTES = 8 * SLAB;   // 32 KB
  static constexpr int NS = BN / 2;  // fp32 registers of S a thread
  // the S exchange: 2 parities x 2 warpgroups x NS floats x 128 threads
  static constexpr int X_BYTES = 2 * 2 * NS * 128 * 4;
  static constexpr int REGS_PRODUCER = 24, REGS_CONSUMER = 240;
  // 1024 bytes of slack to align the tiles, 128 bytes of barriers
  static constexpr size_t SMEM =
      1024 + Q_BYTES + 2 * SLOTS * TILE_BYTES + X_BYTES + 128;
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// A value the compiler must take as computed here: addresses and
// descriptors derived from it by one add each are not hoisted out of the
// key loop (the 16 descriptors of S alone would hold 32 registers, and the
// kernel has none to spare).
__device__ __forceinline__ uint32_t opaque(uint32_t d) {
  asm volatile("" : "+r"(d));
  return d;
}

// S (64 x 32) = this warpgroup's half of Q K^T: 16 k-steps over the four
// slabs of its head dims (shared-memory addresses of its Q and K slabs).
__device__ __forceinline__ void start_s_d512(float (&s)[W512Cfg::NS],
                                             uint32_t q_half, uint32_t k_half) {
  const uint64_t qd = smem_desc_sw128(q_half), kd = smem_desc_sw128(k_half);
#pragma unroll
  for (int ks = 0; ks < 16; ++ks) {
    // descriptors count 16-byte units: slab ks / 4, 32 bytes a k-step
    wgmma_ss<32>(s, qd + (ks / 4) * (W512Cfg::Q_SLAB >> 4) + 2 * (ks % 4),
                 kd + (ks / 4) * (W512Cfg::SLAB >> 4) + 2 * (ks % 4), ks > 0);
  }
  wgmma_commit();
}

// O (64 x 256) += P V of one 32-key tile: two k-steps of 16 keys (2048
// bytes of each slab), one wgmma of N = 64 a slab.
__device__ __forceinline__ void start_pv_d512(float (&o)[128],
                                              const uint32_t (&pk)[8],
                                              uint32_t v_half) {
  const uint64_t vd = smem_desc_sw128(v_half);
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wgmma_rs_n64(o + 32 * i, pk[4 * ks], pk[4 * ks + 1], pk[4 * ks + 2],
                   pk[4 * ks + 3], vd + i * (W512Cfg::SLAB >> 4) + 128 * ks);
  }
  wgmma_commit();
}

// Adds the other consumer warpgroup's partial S to this one's. Thread t of
// a warpgroup writes register i at float i * 128 + t of its own area (xch:
// the shared-memory address of the exchange).
__device__ __forceinline__ void exchange_s(float (&s)[W512Cfg::NS],
                                           uint32_t xch, int parity, int wg,
                                           int t) {
  constexpr int NS = W512Cfg::NS;
  const uint32_t area = xch + 4 * t;
  const uint32_t own = area + (parity * 2 + wg) * NS * 128 * 4;
  const uint32_t other = area + (parity * 2 + (wg ^ 1)) * NS * 128 * 4;
#pragma unroll
  for (int i = 0; i < NS; ++i)
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(own + i * 512), "f"(s[i])
                 : "memory");
  asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the consumers only
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    float x;
    asm volatile("ld.shared.f32 %0, [%1];\n"
                 : "=f"(x)
                 : "r"(other + i * 512)
                 : "memory");
    s[i] += x;
  }
}

// Split z of `splits` takes key tiles [T z / splits, T (z+1) / splits) of
// the T = ceil(Sk / 32) tiles. With one split the block writes the bf16
// output; with more, its unnormalised O and per row (m, l) go to the
// workspace, laid out as for flash_fma_f32_d512.
__global__ void __launch_bounds__(W512Cfg::THREADS, 1)
    flash_wgmma_bf16_d512(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, AttnParams p,
                          int splits, float* ws) {
  using Cfg = W512Cfg;
  constexpr int BN = Cfg::BN, NS = Cfg::NS, TILE_BYTES = Cfg::TILE_BYTES;

  extern __shared__ unsigned char smem_dyn[];
  // the swizzle works on address bits: tiles start on 1024-byte boundaries
  unsigned char* base =
      smem_dyn + ((1024u - (smem_u32(smem_dyn) & 1023u)) & 1023u);
  unsigned char* Qs = base;
  unsigned char* Ks = Qs + Cfg::Q_BYTES;                // SLOTS K tiles
  unsigned char* Vs = Ks + Cfg::SLOTS * TILE_BYTES;     // SLOTS V tiles
  float* xch = reinterpret_cast<float*>(Vs + Cfg::SLOTS * TILE_BYTES);
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(xch) + Cfg::X_BYTES);
  uint64_t* k_full = q_bar + 1;
  uint64_t* k_empty = k_full + Cfg::SLOTS;
  uint64_t* v_full = k_empty + Cfg::SLOTS;
  uint64_t* v_empty = v_full + Cfg::SLOTS;

  const int q0 = blockIdx.x * Cfg::BM, h = blockIdx.y;
  const int b = blockIdx.z / splits, split = blockIdx.z % splits;
  const int T = (p.Sk + BN - 1) / BN;
  const int t0 = (int)((long long)T * split / splits);
  const int nt = (int)((long long)T * (split + 1) / splits) - t0;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
#pragma unroll
    for (int s = 0; s < Cfg::SLOTS; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 8);  // lane 0 of every consumer warp
      mbar_init(&v_empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    // ---- producer: the whole lifetime of this warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        Cfg::REGS_PRODUCER));
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(q_bar, Cfg::Q_BYTES);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        tma_load_4d(Qs + i * Cfg::Q_SLAB, &tq, q_bar, 64 * i, h, q0, b);
      for (int j = 0; j < nt; ++j) {
        const int st = j % Cfg::SLOTS;
        const uint32_t free_parity = ((j / Cfg::SLOTS) & 1u) ^ 1u;
        const int key0 = (t0 + j) * BN;
        mbar_wait(&k_empty[st], free_parity);
        mbar_arrive_expect_tx(&k_full[st], TILE_BYTES);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          tma_load_4d(Ks + st * TILE_BYTES + i * Cfg::SLAB, &tk, &k_full[st],
                      64 * i, h, key0, b);
        mbar_wait(&v_empty[st], free_parity);
        mbar_arrive_expect_tx(&v_full[st], TILE_BYTES);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          tma_load_4d(Vs + st * TILE_BYTES + i * Cfg::SLAB, &tv, &v_full[st],
                      64 * i, h, key0, b);
      }
    }
  } else {
    // ---- consumer: 64 query rows, head dims [256 wg, 256 wg + 256) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        Cfg::REGS_CONSUMER));
    const int t = threadIdx.x & 127, lane = t & 31, warp = t >> 5;
    // Every shared-memory address of the key loop is a constant offset from
    // one 32-bit base, taken as opaque at each tile: one register, where
    // the addresses of both slots would take many.
    const uint32_t sbase = smem_u32(base);
    const uint32_t q_half = 4 * wg * Cfg::Q_SLAB;
    const uint32_t k_half = Cfg::Q_BYTES + 4 * wg * Cfg::SLAB;
    const uint32_t v_half = k_half + Cfg::SLOTS * TILE_BYTES;
    constexpr uint32_t X_OFF = Cfg::Q_BYTES + 2 * Cfg::SLOTS * TILE_BYTES;
    constexpr uint32_t BAR = X_OFF + Cfg::X_BYTES;  // the barriers, as above
    constexpr uint32_t K_FULL = BAR + 8, K_EMPTY = K_FULL + 8 * Cfg::SLOTS,
                       V_FULL = K_EMPTY + 8 * Cfg::SLOTS,
                       V_EMPTY = V_FULL + 8 * Cfg::SLOTS;

    float o[128], s[NS];
    uint32_t pk[NS / 2];
#pragma unroll
    for (int i = 0; i < 128; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, a0, a1;

    mbar_wait(sbase + BAR, 0);
    mbar_wait(sbase + K_FULL, 0);
    wgmma_fence();
    start_s_d512(s, sbase + q_half, sbase + k_half);
    wgmma_wait<0>();
    pin(s);
    if (lane == 0) mbar_arrive(sbase + K_EMPTY);
    exchange_s(s, sbase + X_OFF, 0, wg, t);
    softmax_regs<NS>(s, p.Sk - t0 * BN, p.c, m0, m1, l0, l1, a0, a1, lane);
    pack_p<NS>(s, pk);

    for (int j = 1; j < nt; ++j) {
      const uint32_t sb = opaque(sbase);
      const uint32_t st = (j % Cfg::SLOTS), prev = (j - 1) % Cfg::SLOTS;
      mbar_wait(sb + K_FULL + 8 * st, (j / Cfg::SLOTS) & 1);
      mbar_wait(sb + V_FULL + 8 * prev, ((j - 1) / Cfg::SLOTS) & 1);
      wgmma_fence();
      // S of tile j, and behind it in the tensor cores O += P V of tile j-1
      start_s_d512(s, sb + q_half, sb + k_half + st * TILE_BYTES);
      start_pv_d512(o, pk, sb + v_half + prev * TILE_BYTES);
      wgmma_wait<1>();  // S is there; P V runs under the exchange and softmax
      pin(s);
      if (lane == 0) mbar_arrive(sb + K_EMPTY + 8 * st);
      exchange_s(s, sb + X_OFF, j & 1, wg, t);
      softmax_regs<NS>(s, p.Sk - (t0 + j) * BN, p.c, m0, m1, l0, l1, a0, a1,
                       lane);
      wgmma_wait<0>();
      pin(o);
      pin(pk);
      pin(s);
      if (lane == 0) mbar_arrive(sb + V_EMPTY + 8 * prev);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        o[4 * i] *= a0;
        o[4 * i + 1] *= a0;
        o[4 * i + 2] *= a1;
        o[4 * i + 3] *= a1;
      }
      pack_p<NS>(s, pk);
    }
    const uint32_t last = (nt - 1) % Cfg::SLOTS;
    mbar_wait(sbase + V_FULL + 8 * last, ((nt - 1) / Cfg::SLOTS) & 1);
    wgmma_fence();
    start_pv_d512(o, pk, sbase + v_half + last * TILE_BYTES);
    wgmma_wait<0>();
    pin(o);
    pin(pk);

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const int row_lo = q0 + warp * 16 + (lane >> 2), row_hi = row_lo + 8;
    const int col = 256 * wg + 2 * (lane & 3);
    const long long ri_lo = ((long long)b * p.Sq + row_lo) * p.H + h;
    const long long ri_hi = ((long long)b * p.Sq + row_hi) * p.H + h;
    if (splits == 1) {
      const float i0 = 1.f / l0, i1 = 1.f / l1;
      bf16* dst_lo = static_cast<bf16*>(p.o) + ri_lo * 512 + col;
      bf16* dst_hi = static_cast<bf16*>(p.o) + ri_hi * 512 + col;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (row_lo < p.Sq)
          *reinterpret_cast<__nv_bfloat162*>(dst_lo + 8 * i) =
              __floats2bfloat162_rn(o[4 * i] * i0, o[4 * i + 1] * i0);
        if (row_hi < p.Sq)
          *reinterpret_cast<__nv_bfloat162*>(dst_hi + 8 * i) =
              __floats2bfloat162_rn(o[4 * i + 2] * i1, o[4 * i + 3] * i1);
      }
    } else {
      const long long R = (long long)p.B * p.Sq * p.H;  // rows of all heads
      float* dst_lo = ws + ((long long)split * R + ri_lo) * 512 + col;
      float* dst_hi = ws + ((long long)split * R + ri_hi) * 512 + col;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (row_lo < p.Sq)
          *reinterpret_cast<float2*>(dst_lo + 8 * i) =
              make_float2(o[4 * i], o[4 * i + 1]);
        if (row_hi < p.Sq)
          *reinterpret_cast<float2*>(dst_hi + 8 * i) =
              make_float2(o[4 * i + 2], o[4 * i + 3]);
      }
      if (wg == 0 && (lane & 3) == 0) {
        float* ml = ws + (long long)splits * R * 512 + 2 * (long long)split * R;
        if (row_lo < p.Sq) {
          ml[2 * ri_lo] = m0;
          ml[2 * ri_lo + 1] = l0;
        }
        if (row_hi < p.Sq) {
          ml[2 * ri_hi] = m1;
          ml[2 * ri_hi + 1] = l1;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32, head dims 40 / 64 / 80 / 160: three TF32 passes on the tensor cores
// ---------------------------------------------------------------------------

// NW warps of 16 query rows; BN keys a tile; STAGES (K, V) tiles in the
// ring. Rows of Q, K and V are D floats padded to LD = 4 mod 32, so that
// the fragment reads of a quarter-warp (two rows, four lanes each) and the
// scalar V reads of a warp meet no bank twice.
template <int D, int NW, int BN, int STAGES>
struct TcCfg {
  static constexpr int BM = 16 * NW, THREADS = 32 * NW;
  static constexpr int LD = (D + 31) / 32 * 32 + 4;
  static constexpr size_t SMEM =
      (size_t)(BM + STAGES * 2 * BN) * LD * sizeof(float);
  static_assert(D % 32 == 0 || D % 32 == 8 || D % 32 == 16, "head dim");
  static_assert(BN % 8 == 0 && STAGES >= 2, "tile");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// S (this warp's 16 rows x BN keys) += Q K^T over the W head dims of one
// chunk: q and k point at the chunk's first column of the warp's first Q
// row and of the tile's first key. Q is split once for all the tile's keys.
template <int W, int BN, int LD>
__device__ __forceinline__ void qk_chunk(float (&s)[BN / 2], const float* q,
                                         const float* k, int g, int t) {
  constexpr int F = W / 4, KS = W / 8;
  float qa[F], qb[F];
  ld_chunk<W>(qa, q + g * LD + F * t);
  ld_chunk<W>(qb, q + (g + 8) * LD + F * t);
  uint32_t ah[KS][4], al[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    split_a(qa[2 * ks], qb[2 * ks], qa[2 * ks + 1], qb[2 * ks + 1], ah[ks],
            al[ks]);
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
    float kf[F];
    ld_chunk<W>(kf, k + (8 * n + g) * LD + F * t);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t bh[2], bl[2];
      split_b(kf[2 * ks], kf[2 * ks + 1], bh, bl);
      mma_tf32x3(s + 4 * n, ah[ks], al[ks], bh, bl);
    }
  }
}

// O (16 rows x D) = P V of one tile (o zeroed by the caller). P is S's
// accumulator layout: k-step j
// takes keys 8j + 2t and 8j + 2t + 1 as its k = t and k = t + 4, which is
// the A fragment {s[4j], s[4j+2], s[4j+1], s[4j+3]}; V's rows are read in
// the same order. P is split once for all D columns.
template <int D, int BN, int LD>
__device__ __forceinline__ void pv_tile(float (&o)[D / 2],
                                        const float (&s)[BN / 2],
                                        const float* v, int g, int t) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    uint32_t ah[4], al[4];
    split_a(s[4 * j], s[4 * j + 2], s[4 * j + 1], s[4 * j + 3], ah, al);
    const float* v0 = v + (8 * j + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t bh[2], bl[2];
      split_b(v0[8 * n], v0[LD + 8 * n], bh, bl);
      mma_tf32x3(o + 4 * n, ah, al, bh, bl);
    }
  }
}

template <int D, int NW, int BN, int STAGES>
__global__ void __launch_bounds__(TcCfg<D, NW, BN, STAGES>::THREADS)
    flash_mma_f32x3(AttnParams p) {
  using Cfg = TcCfg<D, NW, BN, STAGES>;
  constexpr int BM = Cfg::BM, LD = Cfg::LD, THREADS = Cfg::THREADS;
  constexpr int CPR = D / 4;  // 16-byte chunks a row
  constexpr int TILE = BN * LD;

  extern __shared__ __align__(16) float smf[];
  float* Qs = smf;            // [BM][LD]
  float* ring = Qs + BM * LD;  // STAGES x (K [BN][LD], V [BN][LD])

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int nt = (p.Sk + BN - 1) / BN;

  const float* qp = static_cast<const float*>(p.q) + (long long)b * p.q_sb +
                    (long long)h * p.q_sh;
  const float* kp = static_cast<const float*>(p.k) + (long long)b * p.k_sb +
                    (long long)h * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + (long long)b * p.v_sb +
                    (long long)h * p.v_sh;

  // Q, once, with the first tile: rows past Sq are zeros (computed on,
  // never stored)
  for (int idx = tid; idx < BM * CPR; idx += THREADS) {
    const int r = idx / CPR, c = idx % CPR;
    const bool ok = q0 + r < p.Sq;
    cp_async16(Qs + r * LD + 4 * c,
               qp + (ok ? (long long)(q0 + r) * p.q_ss : 0) + 4 * c,
               ok ? 16 : 0);
  }
  // tile j into slot j % STAGES; keys past Sk are zeros. Every call commits
  // a group (an empty one past the end), so the group count stays uniform.
  auto issue = [&](int j) {
    if (j < nt) {
      float* kd = ring + (j % STAGES) * 2 * TILE;
      const int k0 = j * BN;
      for (int idx = tid; idx < BN * CPR; idx += THREADS) {
        const int r = idx / CPR, c = idx % CPR;
        const bool ok = k0 + r < p.Sk;
        const long long row = ok ? k0 + r : 0;
        cp_async16(kd + r * LD + 4 * c, kp + row * p.k_ss + 4 * c,
                   ok ? 16 : 0);
        cp_async16(kd + TILE + r * LD + 4 * c, vp + row * p.v_ss + 4 * c,
                   ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) issue(j);

  float o[D / 2], s[BN / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, a0, a1;
  const float* qw = Qs + warp * 16 * LD;

  for (int j = 0; j < nt; ++j) {
    cp_async_wait<STAGES - 2>();  // tile j (and Q) landed for this thread
    __syncthreads();  // ... for all; the slot of tile j - 1 is free again
    issue(j + STAGES - 1);
    const float* kt = ring + (j % STAGES) * 2 * TILE;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 32; ++c)
      qk_chunk<32, BN, LD>(s, qw + 32 * c, kt + 32 * c, g, t);
    if constexpr (D % 32 != 0)
      qk_chunk<D % 32, BN, LD>(s, qw + D / 32 * 32, kt + D / 32 * 32, g, t);
    softmax_regs<BN / 2>(s, p.Sk - j * BN, p.c, m0, m1, l0, l1, a0, a1, lane);
    // P V of the tile into registers of its own, then O = alpha O + P V in
    // the CUDA cores: the tensor cores' accumulation does not round to
    // nearest, and a sum carried through every key tile drifts with Sk
    // (3e-5 rel L2 at 4096 keys in a development run)
    float pv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) pv[i] = 0.f;
    pv_tile<D, BN, LD>(pv, s, kt + TILE, g, t);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[4 * i] = fmaf(o[4 * i], a0, pv[4 * i]);
      o[4 * i + 1] = fmaf(o[4 * i + 1], a0, pv[4 * i + 1]);
      o[4 * i + 2] = fmaf(o[4 * i + 2], a1, pv[4 * i + 2]);
      o[4 * i + 3] = fmaf(o[4 * i + 3], a1, pv[4 * i + 3]);
    }
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;
  float* op = static_cast<float*>(p.o) + h * D + 2 * t;
  float* dst_lo = op + ((long long)b * p.Sq + row_lo) * p.H * D;
  float* dst_hi = op + ((long long)b * p.Sq + row_hi) * p.H * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    if (row_lo < p.Sq)
      *reinterpret_cast<float2*>(dst_lo + 8 * i) =
          make_float2(o[4 * i] * i0, o[4 * i + 1] * i0);
    if (row_hi < p.Sq)
      *reinterpret_cast<float2*>(dst_hi + 8 * i) =
          make_float2(o[4 * i + 2] * i1, o[4 * i + 3] * i1);
  }
}

// ---------------------------------------------------------------------------
// fp32, head dim 512: register-tiled FMA body with split keys
// ---------------------------------------------------------------------------

// 64 query rows and 64-key tiles, 256 threads. Q stays in shared memory;
// each key tile streams through a ring of two slots as 4 K chunks (64 keys x
// 128 dims) and then 4 V chunks (16 keys x 512 dims): large chunks, so the
// block meets a barrier every 2048 FMAs a thread (8 a key tile). Rows of 4-float
// (16-byte) groups are padded by one group where threads read down a column
// of rows, so the 8 lanes of every quarter-warp request hit distinct banks.
struct F512Cfg {
  static constexpr int D = 512, BM = 64, BN = 64, THREADS = 256, STAGES = 2;
  static constexpr int LDQ = D + 4;   // floats a Q row
  static constexpr int KC = 128;      // head dims of a K chunk
  static constexpr int LDK = KC + 4;  // floats a row of a K chunk
  static constexpr int VR = 16;       // keys of a V chunk (rows of D floats)
  static constexpr int LDP = BN + 4;  // floats a P row
  static constexpr int SLOT = BN * LDK;  // floats of a ring slot
  static constexpr int ITEMS = D / KC + BN / VR;  // ring items a key tile
  static constexpr size_t SMEM =
      (size_t)(BM * LDQ + STAGES * SLOT + BM * LDP + BM) * sizeof(float);
  static_assert(VR * D <= SLOT, "a V chunk fits a slot");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// Split z of `splits` takes key tiles [T z / splits, T (z+1) / splits) of
// the T = ceil(Sk / 64) tiles. With one split the block writes the output;
// with more it writes its unnormalised O and, per row, the running max m
// and denominator l to the workspace (O: splits x B*Sq*H x 512 floats, then
// (m, l): splits x B*Sq*H x 2), and flash_combine merges them.
__global__ void __launch_bounds__(256, 1)
    flash_fma_f32_d512(AttnParams p, int splits, float* ws) {
  using Cfg = F512Cfg;
  constexpr int D = Cfg::D, BM = Cfg::BM, BN = Cfg::BN, LDQ = Cfg::LDQ,
                KC = Cfg::KC, LDK = Cfg::LDK, VR = Cfg::VR, LDP = Cfg::LDP,
                STAGES = Cfg::STAGES, SLOT = Cfg::SLOT, ITEMS = Cfg::ITEMS;
  constexpr int NKC = D / KC;  // K chunks a tile; the V chunks follow

  extern __shared__ __align__(16) float smf[];
  float* Qs = smf;                       // [BM][LDQ]
  float* ring = Qs + BM * LDQ;           // STAGES slots
  float* Ps = ring + STAGES * SLOT;      // [BM][LDP]
  float* alpha_s = Ps + BM * LDP;        // [BM]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BM, h = blockIdx.y;
  const int b = blockIdx.z / splits, split = blockIdx.z % splits;
  const int T = (p.Sk + BN - 1) / BN;
  const int t_begin = (int)((long long)T * split / splits);
  const int nitems =
      ((int)((long long)T * (split + 1) / splits) - t_begin) * ITEMS;

  const float* qp = static_cast<const float*>(p.q) + (long long)b * p.q_sb +
                    (long long)h * p.q_sh;
  const float* kp = static_cast<const float*>(p.k) + (long long)b * p.k_sb +
                    (long long)h * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + (long long)b * p.v_sb +
                    (long long)h * p.v_sh;

  // Q, once: rows past Sq are zeros (computed on, never stored)
  for (int idx = tid; idx < BM * (D / 4); idx += Cfg::THREADS) {
    const int r = idx / (D / 4), c = idx % (D / 4);
    const bool ok = q0 + r < p.Sq;
    cp_async16(Qs + r * LDQ + 4 * c,
               ok ? qp + (long long)(q0 + r) * p.q_ss + 4 * c : qp,
               ok ? 16 : 0);
  }
  cp_async_commit();

  // ring item u into slot u % STAGES: K chunk i < NKC of its key tile, or V
  // chunk i - NKC; keys past Sk are zeros. Every call commits a group (an
  // empty one past the end), so the group count stays uniform.
  auto issue = [&](int u) {
    if (u < nitems) {
      const int k0 = (t_begin + u / ITEMS) * BN, i = u % ITEMS;
      float* dst = ring + (u % STAGES) * SLOT;
      if (i < NKC) {
        for (int idx = tid; idx < BN * (KC / 4); idx += Cfg::THREADS) {
          const int r = idx / (KC / 4), c = idx % (KC / 4);
          const bool ok = k0 + r < p.Sk;
          cp_async16(dst + r * LDK + 4 * c,
                     ok ? kp + (long long)(k0 + r) * p.k_ss + i * KC + 4 * c
                        : kp,
                     ok ? 16 : 0);
        }
      } else {
        const int j0 = k0 + (i - NKC) * VR;
        for (int idx = tid; idx < VR * (D / 4); idx += Cfg::THREADS) {
          const int r = idx / (D / 4), c = idx % (D / 4);
          const bool ok = j0 + r < p.Sk;
          cp_async16(dst + r * D + 4 * c,
                     ok ? vp + (long long)(j0 + r) * p.v_ss + 4 * c : vp,
                     ok ? 16 : 0);
        }
      }
    }
    cp_async_commit();
  };

  // S = Q K^T: thread (ty, tx) owns rows ty + 16a and keys tx + 16c of the
  // tile (a, c < 4); the 16 threads of a row are one half-warp.
  const int ty = tid >> 4, tx = tid & 15;
  float s[4][4];
  float m[4], l[4];  // running max, this thread's share of the denominator
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
  }
  // O += P V: warp w owns rows 16(w / 2) + 2r + lane / 16 (r < 8) and head
  // dims 256(w % 2) + 64c + 4(lane % 16) + {0..3} (c < 4)
  const int orow0 = 16 * (warp >> 1) + (lane >> 4);
  const int ocol0 = 256 * (warp & 1) + 4 * (lane & 15);
  float o[8][16];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int i = 0; i < 16; ++i) o[r][i] = 0.f;

  for (int u = 0; u < STAGES - 1; ++u) issue(u);

  for (int u = 0; u < nitems; ++u) {
    cp_async_wait<STAGES - 2>();  // Q and item u have landed (this thread)
    __syncthreads();  // ... for all; the slot of item u - 1 is free again
    issue(u + STAGES - 1);
    const float* slot = ring + (u % STAGES) * SLOT;
    const int i = u % ITEMS;
    if (i < NKC) {
      if (i == 0) {
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
      }
      const float* qa = Qs + ty * LDQ + i * KC;
      const float* kc = slot + tx * LDK;
#pragma unroll 4
      for (int d = 0; d < KC; d += 4) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          qv[a] = *reinterpret_cast<const float4*>(qa + 16 * a * LDQ + d);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          kv[c] = *reinterpret_cast<const float4*>(kc + 16 * c * LDK + d);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[a][c] = fmaf(qv[a].x, kv[c].x, s[a][c]);
            s[a][c] = fmaf(qv[a].y, kv[c].y, s[a][c]);
            s[a][c] = fmaf(qv[a].z, kv[c].z, s[a][c]);
            s[a][c] = fmaf(qv[a].w, kv[c].w, s[a][c]);
          }
      }
      if (i == NKC - 1) {
        // online softmax in registers; P and the rescale factors go to
        // shared memory, where the P V threads read them
        const int key0 = (t_begin + u / ITEMS) * BN + tx;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          float mx = -INFINITY;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (key0 + 16 * c >= p.Sk) s[a][c] = -INFINITY;
            mx = fmaxf(mx, s[a][c]);
          }
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float m_new = fmaxf(m[a], mx);
          const float alpha = exp2f((m[a] - m_new) * p.c);  // 0 at first
          m[a] = m_new;
          float sum = 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float pv = exp2f((s[a][c] - m_new) * p.c);
            sum += pv;
            Ps[(ty + 16 * a) * LDP + tx + 16 * c] = pv;
          }
          l[a] = l[a] * alpha + sum;
          if (tx == 0) alpha_s[ty + 16 * a] = alpha;
        }
      }
    } else {
      const int j0 = (i - NKC) * VR;  // key of the tile at the chunk's row 0
      if (j0 == 0) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float al = alpha_s[orow0 + 2 * r];
#pragma unroll
          for (int k = 0; k < 16; ++k) o[r][k] *= al;
        }
      }
#pragma unroll
      for (int jj = 0; jj < VR; jj += 4) {
        float4 pv[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          pv[r] = *reinterpret_cast<const float4*>(
              Ps + (orow0 + 2 * r) * LDP + j0 + jj);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float4 vv[4];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            vv[c] = *reinterpret_cast<const float4*>(
                slot + (jj + q) * D + ocol0 + 64 * c);
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float pr = q == 0 ? pv[r].x
                             : q == 1 ? pv[r].y
                             : q == 2 ? pv[r].z
                                      : pv[r].w;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              o[r][4 * c] = fmaf(pr, vv[c].x, o[r][4 * c]);
              o[r][4 * c + 1] = fmaf(pr, vv[c].y, o[r][4 * c + 1]);
              o[r][4 * c + 2] = fmaf(pr, vv[c].z, o[r][4 * c + 2]);
              o[r][4 * c + 3] = fmaf(pr, vv[c].w, o[r][4 * c + 3]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // the denominator of a row: the sum of its 16 threads' shares
  const long long R = (long long)p.B * p.Sq * p.H;  // rows of all heads
  float* l_s = alpha_s;  // alpha is no longer read after the barrier below
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l[a] += __shfl_xor_sync(0xffffffffu, l[a], off);
    const int row = q0 + ty + 16 * a;
    if (tx == 0) {
      l_s[ty + 16 * a] = l[a];
      if (splits > 1 && row < p.Sq) {
        float* ml = ws + (long long)splits * R * D +
                    2 * ((long long)split * R + ((long long)b * p.Sq + row) *
                                                    p.H + h);
        ml[0] = m[a];
        ml[1] = l[a];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = q0 + orow0 + 2 * r;
    if (row >= p.Sq) continue;
    const long long ri = ((long long)b * p.Sq + row) * p.H + h;
    float* dst;
    float scale = 1.f;
    if (splits == 1) {
      dst = static_cast<float*>(p.o) + ri * D + ocol0;
      scale = 1.f / l_s[orow0 + 2 * r];
    } else {
      dst = ws + ((long long)split * R + ri) * D + ocol0;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(dst + 64 * c) =
          make_float4(o[r][4 * c] * scale, o[r][4 * c + 1] * scale,
                      o[r][4 * c + 2] * scale, o[r][4 * c + 3] * scale);
  }
}

// Merges the key splits of the head-dim-512 bodies, split 0 first: with M
// the largest running max of a row and w_z = exp2((m_z - M) c), the output
// is sum_z w_z O_z / sum_z w_z l_z, written as OutT. One block of 128
// threads a row, four head dims a thread.
__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void store4(bf16* dst, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

template <typename OutT>
__global__ void __launch_bounds__(128)
    flash_combine(const float* ws, int splits, long long R, float c,
                  OutT* out) {
  constexpr int D = 512;
  const long long r = blockIdx.x;
  const float* ml = ws + (long long)splits * R * D;
  float mx = -INFINITY;
  for (int z = 0; z < splits; ++z) mx = fmaxf(mx, ml[2 * (z * R + r)]);
  float den = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int z = 0; z < splits; ++z) {
    const float w = exp2f((ml[2 * (z * R + r)] - mx) * c);
    den += w * ml[2 * (z * R + r) + 1];
    const float4 t = *reinterpret_cast<const float4*>(
        ws + (z * R + r) * D + 4 * threadIdx.x);
    acc.x = fmaf(w, t.x, acc.x);
    acc.y = fmaf(w, t.y, acc.y);
    acc.z = fmaf(w, t.z, acc.z);
    acc.w = fmaf(w, t.w, acc.w);
  }
  const float inv = 1.f / den;
  store4(out + r * D + 4 * threadIdx.x,
         make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv));
}

cudaError_t launch_f512(const AttnParams& p, int splits, float* ws,
                        cudaStream_t stream) {
  using Cfg = F512Cfg;
  auto kernel = flash_fma_f32_d512;
  const int T = (p.Sk + Cfg::BN - 1) / Cfg::BN;
  if (splits < 1 || splits > T || (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cfg::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq + Cfg::BM - 1) / Cfg::BM, p.H, p.B * splits);
  kernel<<<grid, Cfg::THREADS, Cfg::SMEM, stream>>>(p, splits, ws);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long R = (long long)p.B * p.Sq * p.H;
  flash_combine<float><<<(unsigned)R, 128, 0, stream>>>(
      ws, splits, R, p.c, static_cast<float*>(p.o));
  return cudaGetLastError();
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

// Tensor map of one bf16 (B, S, H, D) view, innermost dim first: (D, H, S,
// B) with the view's strides, boxes of 64 columns and `rows` sequence
// positions of one head, 128-byte swizzle. What a box holds outside the
// tensor is filled with zeros: rows past S, and for D = 40 columns 40-63
// (the next head is another coordinate, not the next column).
bool make_tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int H,
                     int D, long long sb, long long ss, long long sh,
                     int rows) {
  return make_map_4d_bf16(map, ptr, {D, H, S, B}, {sh, ss, sb},
                          {64, 1, rows, 1});
}

// The tensor maps are encoded on the host at every launch and travel by
// value in the kernel's parameters.
template <int D, int NCWG, int BN, int STAGES>
cudaError_t launch_wgmma(const AttnParams& p, cudaStream_t stream) {
  using Cfg = WgCfg<D, NCWG, BN, STAGES>;
  if (STAGES == 1 && p.Sk > BN) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!make_tensor_map(&tq, p.q, p.B, p.Sq, p.H, D, p.q_sb, p.q_ss, p.q_sh,
                       Cfg::BM) ||
      !make_tensor_map(&tk, p.k, p.B, p.Sk, p.H, D, p.k_sb, p.k_ss, p.k_sh,
                       BN) ||
      !make_tensor_map(&tv, p.v, p.B, p.Sk, p.H, D, p.v_sb, p.v_ss, p.v_sh,
                       BN))
    return cudaErrorInvalidValue;
  auto kernel = flash_wgmma_bf16<D, NCWG, BN, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cfg::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq + Cfg::BM - 1) / Cfg::BM, p.H, p.B);
  kernel<<<grid, Cfg::THREADS, Cfg::SMEM, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

cudaError_t launch_w512(const AttnParams& p, int splits, float* ws,
                        cudaStream_t stream) {
  using Cfg = W512Cfg;
  const int T = (p.Sk + Cfg::BN - 1) / Cfg::BN;
  if (splits < 1 || splits > T || (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!make_tensor_map(&tq, p.q, p.B, p.Sq, p.H, Cfg::D, p.q_sb, p.q_ss,
                       p.q_sh, Cfg::BM) ||
      !make_tensor_map(&tk, p.k, p.B, p.Sk, p.H, Cfg::D, p.k_sb, p.k_ss,
                       p.k_sh, Cfg::BN) ||
      !make_tensor_map(&tv, p.v, p.B, p.Sk, p.H, Cfg::D, p.v_sb, p.v_ss,
                       p.v_sh, Cfg::BN))
    return cudaErrorInvalidValue;
  auto kernel = flash_wgmma_bf16_d512;
  static bool configured = false;  // the attribute once, not at every launch
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cfg::SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((p.Sq + Cfg::BM - 1) / Cfg::BM, p.H, p.B * splits);
  kernel<<<grid, Cfg::THREADS, Cfg::SMEM, stream>>>(tq, tk, tv, p, splits, ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long R = (long long)p.B * p.Sq * p.H;
  flash_combine<bf16><<<(unsigned)R, 128, 0, stream>>>(
      ws, splits, R, p.c, static_cast<bf16*>(p.o));
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* ed_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = bf16, 1 = fp32. plan: 0 = the three-pass TF32 body (fp32,
// D = 40, 64, 80, 160); 1-3 = the wgmma body (bf16, D = 40, 64, 80 or
// 160): 128 query rows a block and a ring of 128-key (D = 160: 64-key)
// tiles (1), 64 query rows and a ring of 64-key tiles (2), or 64 query rows
// and one tile of at most 80 keys (3); 4 = the register-tiled fp32 body at
// D = 512; 5 = the wgmma body for bf16 at D = 512. Plans 4 and 5 split the
// keys over `splits` blocks whose partials go to `ws` (splits x B*Sq*H x 514
// floats; unused at one split). Returns a cudaError_t, or -1 for a (dtype,
// head dim, plan) that has no instantiation.
extern "C" int ed_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int B, int Sq, int Sk, int H, int D,
                                  long long q_sb, long long q_ss, long long q_sh,
                                  long long k_sb, long long k_ss, long long k_sh,
                                  long long v_sb, long long v_ss, long long v_sh,
                                  int dtype, float scale_log2e, int plan,
                                  int splits, void* ws, void* stream) {
  AttnParams p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.H = H;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.c = scale_log2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plan == 4) {
    if (dtype != 1 || D != 512) return -1;
    return (int)launch_f512(p, splits, static_cast<float*>(ws), st);
  }
  if (plan == 5) {
    if (dtype != 0 || D != 512) return -1;
    return (int)launch_w512(p, splits, static_cast<float*>(ws), st);
  }
  if (plan >= 1 && plan <= 3) {
    if (dtype != 0) return -1;
// per head dim: keys a tile and stages of plan 1, stages of plan 2
#define ED_FLASH_WGMMA(DD, BN1, ST1, ST2)                                     \
  if (D == DD) {                                                              \
    if (plan == 1) return (int)launch_wgmma<DD, 2, BN1, ST1>(p, st);          \
    if (plan == 2) return (int)launch_wgmma<DD, 1, 64, ST2>(p, st);           \
    if (plan == 3) return (int)launch_wgmma<DD, 1, 80, 1>(p, st);             \
  }
    ED_FLASH_WGMMA(40, 128, 3, 4)
    ED_FLASH_WGMMA(64, 128, 3, 4)
    ED_FLASH_WGMMA(80, 128, 3, 2)
    ED_FLASH_WGMMA(160, 64, 3, 2)
#undef ED_FLASH_WGMMA
    return -1;
  }
  if (dtype != 1 || plan != 0) return -1;
// per head dim: keys a tile and stages; four warps (64 query rows) a block
#define ED_FLASH_F32(DD, BN, ST)                                              \
  if (D == DD)                                                                \
    return (int)launch(flash_mma_f32x3<DD, 4, BN, ST>,                        \
                       TcCfg<DD, 4, BN, ST>::SMEM, 128, 64, p, st);
  ED_FLASH_F32(40, 64, 2)
  ED_FLASH_F32(64, 64, 2)
  ED_FLASH_F32(80, 32, 2)
  ED_FLASH_F32(160, 32, 2)
#undef ED_FLASH_F32
  return -1;
}
