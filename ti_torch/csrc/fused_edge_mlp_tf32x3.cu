// Kernel B4 in f32 on Hopper's tensor cores (sm_90a), in split-precision TF32
// ("3xTF32"): the fused edge MLP phi(in) * w(pe).
//
// Replaces ti_tpu/ops/pallas_kernels.py::fused_edge_mlp (the Pallas TPU kernel
// body _kernel) and computes what fused_edge_mlp.cu computes, with the same
// layouts: per row, phi(in) with in (2F) and w(pe) with pe (F), each MLP
// Dense -> LN-SiLU -> Dense -> LN-SiLU -> Dense 5F (LayerNorm with f32
// statistics and eps 1e-5), and their product (5F), in f32. Rows are the
// B N^2 pair rows of apply_dense(fused=True) or the B N(N-1) edge rows of
// cpainn_fused.apply_fused. fused_edge_mlp.cu keeps the f32-FMA kernel
// (variant "fma") to be timed beside this one.
//
// What bounds it on this card: operations. 15 F^2 multiply-adds a row (phi
// 8 F^2, w 7 F^2): at 128 chains of the dense grid (R = 46,208) 22.7 GFLOP,
// 0.138 ms as three TF32 products at 495 TFLOP/s. The rows in and out (189
// MB, of which the (R, 5F) output is 62%) take 0.056 ms at 3.35 TB/s.
//
// What the design does about it:
// - every product is mma.sync.m16n8k8 in 3xTF32 over the weights split and
//   packed once by ops/pair_layer_kernel.pack_tf32_weights
//   (with_tf32_weights), two k-steps into a fresh accumulator added in f32,
//   the A operand split by truncation (tf32_common.cuh::mma3t). A warp owns
//   32 rows and 32 columns of a 64-row tile;
// - one 64-row tile a CTA and two CTAs of 8 warps an SM (98,304 bytes of
//   shared memory each, at most 128 registers a thread): while one CTA waits
//   at a barrier or for its weights from L2, the other's products run. At
//   the dense_fused sampler's 11,552 rows all 181 CTAs are resident at once
//   on 132 SMs. At 128 registers the weight fragments are not loaded ahead
//   (AHEAD, CTAS_PER_SM below): one CTA an SM with them loaded ahead (178
//   registers) was slower at both row counts (tools/b4_tc_probe.py,
//   PERF.md section 6);
// - the [in] (64 x 2F) and [pe] (64 x F) tiles arrive by cp.async, and both
//   MLPs' fronts run in place on them: the halves of the [in] tile then hold
//   the pre-LN products and a2 of phi, the [pe] tile a2 of w;
// - each F-wide chunk of the 5F product: phi's chunk p goes, with its bias,
//   into the free half of the [in] tile, each thread at its own accumulator
//   positions; w's chunk q then forms in registers and is multiplied with
//   the thread's own p. No barrier in the chunk loop, and no (R, 5F)
//   intermediate in device memory;
// - the output leaves registers as 16-byte streaming stores (st.global.cs,
//   evict-first): neighbouring threads swap half their fragment, so each
//   holds 4 consecutive columns of one row. The packed weights (1.97 MB)
//   stay in L2;
// - padding rows of the last tile (R % 64) are zero in the input and never
//   stored. No atomics: two launches agree to the bit.
// Built at two widths from this file (PK_F, pair_common.cuh; ops/_build.py):
// F = 128 (library fused_edge_mlp_tf32x3) as above, and F = 256 (library
// fused_edge_mlp_tf32x3_f256, -DPK_F=256; the 10506 model's width), where a
// 64-row tile would take 196,608 bytes of shared memory: one CTA of 16 warps
// an SM, as B1 at F = 256. There the tile is ETR = 32 rows instead: 98,304
// bytes of shared memory (the [in] tile 32 x 512, the [pe] tile 32 x 256),
// so two CTAs of 8 warps still share an SM at 128 registers a thread, and
// warp w owns the tile's 32 rows and columns 32 w .. 32 w + 31 (the warp's
// block, accumulators and weight fragments are F = 128's). A CTA then reads
// the weights once for its 32 rows where at F = 128 its two row halves read
// them once each for 64: the same weight bytes a row. LayerNorm takes 4 rows
// a warp and 8 columns a lane (tf32_common.cuh::ln_silu_wide). The layer's
// weights are 3.9 MB, 7.9 MB packed hi/lo: in L2. At 13,456 dense pair rows
// (16 chains of 29 atoms) the bound is 0.160 ms as three TF32 passes.

#include "tf32_common.cuh"

namespace pk {
namespace tf32x3 {

static_assert(F == 128 || F == 256, "B4 is built at F = 128 and 256");
constexpr int ETR = F == 256 ? 32 : TR;  // rows of a CTA's tile
constexpr int RB = ETR / 32;             // its 32-row blocks: warp w owns rows 32 (w % RB) ..
static_assert(RB * (F / 32) == NW, "a warp a 32 x 32 block of the tile");
constexpr size_t EDGE_SMEM = sizeof(float) * (size_t)(ETR * LDX + ETR * F);
constexpr int CTAS_PER_SM = 2;  // CTAs of 8 warps an SM: at most 128 registers a thread
constexpr bool AHEAD = false;   // weight fragments loaded a k-step pair ahead: 32 more registers

// LayerNorm -> SiLU in place on the tile's F-wide rows: a warp a row, 8 rows a
// warp at F = 128, 4 at F = 256
__device__ __forceinline__ void ln_silu_tile(float* T, int ld, const float* __restrict__ scale,
                                             const float* __restrict__ bias) {
  if constexpr (F == 128)
    ln_silu_rows(T, ld, scale, bias);
  else
    ln_silu_wide<ETR / NW>(T, ld, warp_id(), scale, bias);
}

// (acc + bias) * p to rows r0 + r < r0 + nrows of o (row stride 5F), p read
// from this thread's own positions of the swizzled tile P (row stride LDX,
// as acc_store wrote it), as 16-byte streaming stores: neighbouring threads
// t, t ^ 1 swap half their fragment, so an even t holds row g, columns
// 2t .. 2t + 3 and an odd t row g + 8, columns 2t - 2 .. 2t + 1
__device__ __forceinline__ void product_store(float* __restrict__ o, size_t r0, int nrows,
                                              const float* P, int row0, int col0, const Acc& acc,
                                              const float* __restrict__ bias) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
  const bool odd = t & 1;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int col = col0 + 8 * p + 2 * t;
    const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
    for (int rt = 0; rt < 2; ++rt) {
      const int r = row0 + 16 * rt + g;
      const float2 p0 = *reinterpret_cast<const float2*>(P + swz(r, col, LDX));
      const float2 p1 = *reinterpret_cast<const float2*>(P + swz(r + 8, col, LDX));
      const float v0 = (acc[rt][p][0] + bb.x) * p0.x, v1 = (acc[rt][p][1] + bb.y) * p0.y;
      const float v2 = (acc[rt][p][2] + bb.x) * p1.x, v3 = (acc[rt][p][3] + bb.y) * p1.y;
      const float s0 = __shfl_xor_sync(0xffffffffu, odd ? v0 : v2, 1);
      const float s1 = __shfl_xor_sync(0xffffffffu, odd ? v1 : v3, 1);
      const float4 v = odd ? make_float4(s0, s1, v2, v3) : make_float4(v0, v1, s0, s1);
      const int ro = r + (odd ? 8 : 0);
      if (ro < nrows)
        __stcs(reinterpret_cast<float4*>(o + (r0 + ro) * 5 * F + col0 + 8 * p + 2 * (t & ~1)), v);
    }
  }
}

__global__ void __launch_bounds__(NT, CTAS_PER_SM)
edge_tf32x3_kernel(const float* __restrict__ in, const float* __restrict__ pe,
                   const float* __restrict__ wpk, const float* __restrict__ vecs,
                   float* __restrict__ out, int rows) {
  extern __shared__ __align__(16) float smem[];
  float* XB = smem;          // the [in] tile (row stride LDX); X1 | X2
  float* X1 = XB;            // phi's h1, a1; w's h1, a1; then each chunk's p
  float* X2 = XB + F;        // phi's h2, then a2
  float* Y = XB + ETR * LDX;  // the [pe] tile (row stride F); w's h2, then a2

  const int warp = warp_id();
  const int row0 = 32 * (warp % RB), col0 = 32 * (warp / RB), nt0 = 4 * (warp / RB);
  const float *vp = vecs + V_PHI, *vw = vecs + V_W;
  const size_t r0 = (size_t)blockIdx.x * ETR;
  const int nrows = min(ETR, rows - (int)r0);
  Acc acc;

  stage_rows<ETR>(XB, LDX, in, 2 * F, r0, nrows);
  stage_rows<ETR>(Y, F, pe, F, r0, nrows);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  // phi's front
  acc_zero(acc);
  mma3t<2 * F / 8, FN, AHEAD>(acc, XB, LDX, row0, wmat(wpk, M_PHI1), nt0);
  __syncthreads();  // every warp has read the input
  acc_store(X1, LDX, row0, col0, acc, vp + V_B1);
  __syncthreads();
  ln_silu_tile(X1, LDX, vp + V_LN1S, vp + V_LN1B);
  __syncthreads();
  acc_zero(acc);
  mma3t<F / 8, FN, AHEAD>(acc, X1, LDX, row0, wmat(wpk, M_PHI2), nt0);
  acc_store(X2, LDX, row0, col0, acc, vp + V_B2);  // X2 was last read before the barriers above
  __syncthreads();
  ln_silu_tile(X2, LDX, vp + V_LN2S, vp + V_LN2B);  // a2 of phi
  // w's front
  acc_zero(acc);
  mma3t<F / 8, FN, AHEAD>(acc, Y, F, row0, wmat(wpk, M_W1), nt0);
  acc_store(X1, LDX, row0, col0, acc, vw + V_B1);  // X1 was last read before the barrier above
  __syncthreads();
  ln_silu_tile(X1, LDX, vw + V_LN1S, vw + V_LN1B);
  __syncthreads();
  acc_zero(acc);
  mma3t<F / 8, FN, AHEAD>(acc, X1, LDX, row0, wmat(wpk, M_W2), nt0);
  acc_store(Y, F, row0, col0, acc, vw + V_B2);  // Y was last read before the barrier above
  __syncthreads();  // every warp is done with X1
  ln_silu_tile(Y, F, vw + V_LN2S, vw + V_LN2B);  // a2 of w
  __syncthreads();

  // the 5F chunks: p into this thread's positions of X1, then p q to the output
#pragma unroll 1
  for (int k = 0; k < 5; ++k) {
    acc_zero(acc);
    mma3t<F / 8, 5 * FN, AHEAD>(acc, X2, LDX, row0, wmat(wpk, M_PHI3), k * FN + nt0);
    acc_store(X1, LDX, row0, col0, acc, vp + V_B3 + k * F);
    acc_zero(acc);
    mma3t<F / 8, 5 * FN, AHEAD>(acc, Y, F, row0, wmat(wpk, M_W3), k * FN + nt0);
    product_store(out + k * F, r0, nrows, X1, row0, col0, acc, vw + V_B3 + k * F);
  }
}

}  // namespace tf32x3
}  // namespace pk

// mats is the layer's matrices split into TF32 hi and lo parts in fragment
// order (ops/pair_layer_kernel.pack_tf32_weights, 2 x 15 F^2 f32 values);
// one CTA an ETR-row tile (64 rows at F = 128, 32 at F = 256).
extern "C" int fused_edge_mlp_tf32x3(const void* in, const void* pe, const void* mats,
                                     const void* vecs, void* out, int rows, void* stream) {
  using namespace pk::tf32x3;
  if (rows < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(edge_tf32x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)EDGE_SMEM);
  if (err != cudaSuccess) return (int)err;
  edge_tf32x3_kernel<<<(rows + ETR - 1) / ETR, pk::NT, EDGE_SMEM, (cudaStream_t)stream>>>(
      (const float*)in, (const float*)pe, (const float*)mats, (const float*)vecs, (float*)out,
      rows);
  return (int)cudaGetLastError();
}

extern "C" unsigned long long fused_edge_mlp_tf32x3_smem_bytes() {
  return (unsigned long long)pk::tf32x3::EDGE_SMEM;
}

// rows of a CTA's tile
extern "C" int fused_edge_mlp_tf32x3_rows() { return pk::tf32x3::ETR; }

// CTAs of the kernel an SM can hold at once, as the card reports it (its
// registers and shared memory decide); negative: a CUDA error code
extern "C" int fused_edge_mlp_tf32x3_ctas_per_sm() {
  using namespace pk::tf32x3;
  cudaError_t err = cudaFuncSetAttribute(edge_tf32x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)EDGE_SMEM);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, edge_tf32x3_kernel, pk::NT, EDGE_SMEM);
  return err == cudaSuccess ? n : -(int)err;
}
