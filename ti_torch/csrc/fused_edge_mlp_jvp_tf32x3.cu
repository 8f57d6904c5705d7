// Kernel B5 in f32 on Hopper's tensor cores (sm_90a), in split-precision TF32
// ("3xTF32"): the tangent of the fused edge MLP phi(in) * w(pe) under K lanes
// of input tangents (din, dpe).
//
// Replaces ti_tpu/ops/pallas_kernels.py::fused_edge_mlp_jvp (the Pallas TPU
// kernel body _edge_jvp_kernel, tangent rules _ln_silu_jvp and _mlp_block_jvp)
// and computes what fused_edge_mlp_jvp.cu computes, with the same layouts: per
// row and lane, dp and dq, the tangents of both MLPs (Dense -> LN-SiLU
// tangent at the primal's statistics, twice, -> Dense 5F), and
// dp * q + p * dq, in f32. fused_edge_mlp_jvp.cu keeps the f32-FMA kernel
// (variant "fma") to be timed beside this one.
//
// What bounds it on this card: operations. 15 F^2 multiply-adds per row and
// pass, on R rows and 1 + K passes: at one exact node of 32 chains (K = 57,
// R = 11,552) 329 GFLOP, 2.0 ms as three TF32 products at 495 TFLOP/s. The
// lane tangents in and out (2.7 GB, of which the (K, R, 5F) output is 1.7 GB)
// take 0.8 ms at 3.35 TB/s.
//
// What the design does about it:
// - every product is mma.sync.m16n8k8 in 3xTF32 over the weights split and
//   packed once by ops/pair_layer_kernel.pack_tf32_weights (in
//   cpainn_dense.pack_message_layers), two k-steps into a fresh accumulator
//   added in f32, the next two k-steps' weight fragments loaded ahead
//   (tf32_common.cuh). A warp owns 32 rows and 32 columns of a 64-row tile.
//   The A operand splits by truncation (hi = a with its low 13 bits cleared,
//   lo = a - hi, exact): two operations an element instead of two cvt.rna
//   and a subtraction;
// - persistent CTAs, one an SM: the work is the (row tile, lane) units of
//   the launch, tile-major, and CTA c takes units [U c / C, U (c + 1) / C).
//   So the load is even to a unit at any K and R, and each CTA computes the
//   primal of a tile once for all its lanes of that tile (at most
//   C + tiles primal passes in all, against tiles x K lanes);
// - the primal keeps its replay residuals in shared memory (the pre-LN h of
//   the four LayerNorms with their mean and 1/std, 64 x F f32 each) and
//   writes its 5F products p, q to a scratch buffer of the CTA (320 KB, in
//   fragment order, so each thread writes and reads back its own accumulator
//   positions as 16-byte pieces, coalesced across the warp: no barrier and
//   no shared memory). Each lane's 5F chunk loads its p, q before its
//   products, so their trip from L2 overlaps them, and each lane costs its
//   15 F^2, not the FMA kernel's 15 F^2 + 10 F^2 / L;
// - the output (62% of the bytes) leaves registers as 16-byte streaming
//   stores (st.global.cs, evict-first): neighbouring threads swap half their
//   fragment, so each holds 4 consecutive columns of one row. The packed
//   weights and the scratch stay in L2;
// - padding rows of the last tile (R % 64) are zero in the input and never
//   stored. No atomics: two launches agree to the bit.
// Shared memory (231,424 bytes, fused_edge_mlp_jvp_tf32x3_smem_bytes): four
// residual tiles, the statistics, the [din | in] input tile (64 x 2F, whose
// halves then hold the fronts' products and phi's a2) and the [dpe | pe] tile
// (64 x F, then w's a2). One CTA of 8 warps an SM.
// Built at two widths from this file (PK_F, pair_common.cuh; ops/_build.py):
// F = 128 (library fused_edge_mlp_jvp_tf32x3) as above, and F = 256 (library
// fused_edge_mlp_jvp_tf32x3_f256, -DPK_F=256; the 10506 model's width), where
// the buffers above would take 460,800 bytes. There the row tile is ETR = 32
// rows, and warp w owns its 32 rows and columns 32 w .. 32 w + 31 (the warp's
// block, accumulators and weight fragments are F = 128's). The same buffers,
// four 32 x 256 residual tiles, the statistics, [din | in] (32 x 512) and
// [dpe | pe] (32 x 256), take 230,400 bytes: they stay in shared memory, one
// CTA an SM. A CTA's scratch holds p, q of 32 rows of 5F, the same 327,680
// bytes as at F = 128 (43 MB over 132 CTAs, in the 50 MB L2). LayerNorm and
// its tangent take 4 rows a warp and 8 columns a lane (two 128-wide chunks).
// At K = 32 over 13,456 rows (one node of 16 chains of 29 atoms) the bound
// is 5.29 ms as three TF32 passes.

#include "tf32_common.cuh"

namespace pk {
namespace tf32x3 {

static_assert(F == 128 || F == 256, "B5 is built at F = 128 and 256");
constexpr int ETR = F == 256 ? 32 : TR;  // rows of a row tile
constexpr int RB = ETR / 32;             // its 32-row blocks: warp w owns rows 32 (w % RB) ..
static_assert(RB * (F / 32) == NW, "a warp a 32 x 32 block of the tile");
constexpr int CH = F / 128;              // 128-wide chunks of a row: lane l takes 128 c + 4 l ..
constexpr int RW = ETR / NW;             // rows a warp in the LayerNorms
constexpr int TILE_F = ETR * F;          // one ETR x F f32 tile
constexpr int NSTAT = 8 * ETR;           // mean and 1/std of each row, per LayerNorm
constexpr size_t JVP_SMEM = sizeof(float) * (size_t)(4 * TILE_F + NSTAT + ETR * LDX + TILE_F);
constexpr int FRAG4 = 8;               // float4s of a thread's 32 x 32 accumulator block
constexpr int SCR4 = 5 * 2 * FRAG4 * NT;  // float4s of a CTA's scratch: [chunk][p | q][slot][thread]
static_assert(4 * SCR4 == 10 * ETR * F, "the scratch holds a tile's p and q");

// LayerNorm (f32 statistics, eps 1e-5) -> SiLU in place on a swizzled ETR-row
// tile, as ln_silu_rows (lane l the columns 128 c + 4 l .. + 3 of each chunk
// c); each row's pre-LN values go to H (row stride F) and its mean and 1/std
// to st[r], st[ETR + r]
__device__ __forceinline__ void ln_silu_keep_rows(float* T, int ld, float* H, float* st,
                                                  const float* __restrict__ scale,
                                                  const float* __restrict__ bias) {
  const int lane = lane_id(), w = warp_id();
  float4 sc[CH], bi[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    sc[c] = __ldg(reinterpret_cast<const float4*>(scale + 128 * c + 4 * lane));
    bi[c] = __ldg(reinterpret_cast<const float4*>(bias + 128 * c + 4 * lane));
  }
#pragma unroll 1
  for (int rr = 0; rr < RW; ++rr) {
    const int r = RW * w + rr;
    float4 v[CH];
    float sum, sq;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      v[c] = *reinterpret_cast<const float4*>(T + swz(r, 128 * c + 4 * lane, ld));
      *reinterpret_cast<float4*>(H + swz(r, 128 * c + 4 * lane, F)) = v[c];
      const float s = v[c].x + v[c].y + v[c].z + v[c].w;
      sum = c ? sum + s : s;
    }
    const float mu = warp_sum(sum) * (1.f / F);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const float d0 = v[c].x - mu, d1 = v[c].y - mu, d2 = v[c].z - mu, d3 = v[c].w - mu;
      const float s = d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3;
      sq = c ? sq + s : s;
    }
    const float rstd = 1.f / sqrtf(warp_sum(sq) * (1.f / F) + 1e-5f);
    if (lane == 0) {
      st[r] = mu;
      st[ETR + r] = rstd;
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const float d0 = v[c].x - mu, d1 = v[c].y - mu, d2 = v[c].z - mu, d3 = v[c].w - mu;
      *reinterpret_cast<float4*>(T + swz(r, 128 * c + 4 * lane, ld)) =
          make_float4(silu(d0 * rstd * sc[c].x + bi[c].x), silu(d1 * rstd * sc[c].y + bi[c].y),
                      silu(d2 * rstd * sc[c].z + bi[c].z), silu(d3 * rstd * sc[c].w + bi[c].w));
    }
  }
}

// Tangent of LayerNorm -> SiLU in place on a swizzled ETR-row tile, row r
// replayed at the pre-LN primal H[r] and its statistics st[r], st[ETR + r]
// (_ln_silu_jvp: the LN tangent at f32 statistics times SiLU's slope)
__device__ __forceinline__ void ln_silu_tan_keep_rows(float* T, int ld, const float* H,
                                                      const float* st,
                                                      const float* __restrict__ scale,
                                                      const float* __restrict__ bias) {
  const int lane = lane_id(), w = warp_id();
  float sc[CH][4], bi[CH][4];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const float4 s4 = __ldg(reinterpret_cast<const float4*>(scale + 128 * c + 4 * lane));
    const float4 b4 = __ldg(reinterpret_cast<const float4*>(bias + 128 * c + 4 * lane));
    sc[c][0] = s4.x, sc[c][1] = s4.y, sc[c][2] = s4.z, sc[c][3] = s4.w;
    bi[c][0] = b4.x, bi[c][1] = b4.y, bi[c][2] = b4.z, bi[c][3] = b4.w;
  }
#pragma unroll 1
  for (int rr = 0; rr < RW; ++rr) {
    const int r = RW * w + rr;
    const float mu = st[r], rstd = st[ETR + r];
    float dv[CH][4], cen[CH][4], sd, cd = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const float4 d4 = *reinterpret_cast<const float4*>(T + swz(r, 128 * c + 4 * lane, ld));
      const float4 h4 = *reinterpret_cast<const float4*>(H + swz(r, 128 * c + 4 * lane, F));
      dv[c][0] = d4.x, dv[c][1] = d4.y, dv[c][2] = d4.z, dv[c][3] = d4.w;
      cen[c][0] = h4.x - mu, cen[c][1] = h4.y - mu, cen[c][2] = h4.z - mu, cen[c][3] = h4.w - mu;
#pragma unroll
      for (int e = 0; e < 4; ++e) cd += cen[c][e] * dv[c][e];
      const float s = dv[c][0] + dv[c][1] + dv[c][2] + dv[c][3];
      sd = c ? sd + s : s;
    }
    const float dmu = warp_sum(sd) * (1.f / F);
    const float dvar = 2.f * (warp_sum(cd) * (1.f / F));
    const float drstd = -0.5f * rstd * rstd * rstd * dvar;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dl = ((dv[c][e] - dmu) * rstd + cen[c][e] * drstd) * sc[c][e];
        const float l = cen[c][e] * rstd * sc[c][e] + bi[c][e];
        const float sig = 1.f / (1.f + expf(-l));
        o[e] = sig * (1.f + l * (1.f - sig)) * dl;
      }
      *reinterpret_cast<float4*>(T + swz(r, 128 * c + 4 * lane, ld)) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

// acc + bias into this thread's 8 scratch slots (slot 4 rt + p holds
// acc[rt][p][0..3]; slot s of thread tid at sp[s NT + tid])
__device__ __forceinline__ void scratch_put(float4* sp, const Acc& acc, int col0,
                                            const float* __restrict__ bias) {
  const int t = lane_id() & 3;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + col0 + 8 * p + 2 * t));
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
      sp[(4 * rt + p) * NT + threadIdx.x] =
          make_float4(acc[rt][p][0] + bb.x, acc[rt][p][1] + bb.y, acc[rt][p][2] + bb.x,
                      acc[rt][p][3] + bb.y);
  }
}

__device__ __forceinline__ void scratch_get(float4 (&v)[FRAG4], const float4* sp) {
#pragma unroll
  for (int s = 0; s < FRAG4; ++s) v[s] = __ldcg(sp + s * NT + threadIdx.x);
}

__global__ void __launch_bounds__(NT, 1)
edge_jvp_tf32x3_kernel(const float* __restrict__ in, const float* __restrict__ pe,
                       const float* __restrict__ din, const float* __restrict__ dpe,
                       const float* __restrict__ wpk, const float* __restrict__ vecs,
                       float* __restrict__ out, float4* __restrict__ scratch, int rows, int K,
                       int ctas) {
  extern __shared__ __align__(16) float smem[];
  float* H1P = smem;               // pre-LN residuals (row stride F)
  float* H2P = H1P + TILE_F;
  float* H1W = H2P + TILE_F;
  float* H2W = H1W + TILE_F;
  float* ST = H2W + TILE_F;        // per LayerNorm (h1p, h2p, h1w, h2w): mean (ETR), 1/std (ETR)
  float* XB = ST + NSTAT;          // [in | din] of a tile (row stride LDX); X1 | X2
  float* X1 = XB;
  float* X2 = XB + F;              // phi's a2 (primal, then tangent)
  float* Y = XB + ETR * LDX;       // [pe | dpe] of a tile (row stride F); w's a2

  const int warp = warp_id(), lane = lane_id(), g = lane >> 2, t = lane & 3;
  const int row0 = 32 * (warp % RB), col0 = 32 * (warp / RB), nt0 = 4 * (warp / RB);
  const float *vp = vecs + V_PHI, *vw = vecs + V_W;
  float4* scr = scratch + (size_t)blockIdx.x * SCR4;
  const long long units = (long long)((rows + ETR - 1) / ETR) * K;
  const long long u0 = units * blockIdx.x / ctas, u1 = units * (blockIdx.x + 1) / ctas;
  long long primal_tile = -1;
  Acc acc;

  for (long long u = u0; u < u1; ++u) {
    const long long tile = u / K;
    const int l = (int)(u - tile * K);
    const size_t r0 = (size_t)tile * ETR;
    const int nrows = min(ETR, rows - (int)r0);
    __syncthreads();  // every warp is done with XB and Y

    if (tile != primal_tile) {
      // ---- the primal of the tile: residuals to shared memory, p, q to the scratch ----
      primal_tile = tile;
      stage_rows<ETR>(XB, LDX, in, 2 * F, r0, nrows);
      stage_rows<ETR>(Y, F, pe, F, r0, nrows);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      acc_zero(acc);
      mma3t<2 * F / 8, FN>(acc, XB, LDX, row0, wmat(wpk, M_PHI1), nt0);
      __syncthreads();  // every warp has read the input
      acc_store(X1, LDX, row0, col0, acc, vp + V_B1);
      __syncthreads();
      ln_silu_keep_rows(X1, LDX, H1P, ST, vp + V_LN1S, vp + V_LN1B);
      __syncthreads();
      acc_zero(acc);
      mma3t<F / 8, FN>(acc, X1, LDX, row0, wmat(wpk, M_PHI2), nt0);
      acc_store(X2, LDX, row0, col0, acc, vp + V_B2);  // X2 was last read before the barriers above
      __syncthreads();
      ln_silu_keep_rows(X2, LDX, H2P, ST + 2 * ETR, vp + V_LN2S, vp + V_LN2B);  // a2 of phi
      acc_zero(acc);
      mma3t<F / 8, FN>(acc, Y, F, row0, wmat(wpk, M_W1), nt0);
      acc_store(X1, LDX, row0, col0, acc, vw + V_B1);  // X1 was last read before the barrier above
      __syncthreads();
      ln_silu_keep_rows(X1, LDX, H1W, ST + 4 * ETR, vw + V_LN1S, vw + V_LN1B);
      __syncthreads();
      acc_zero(acc);
      mma3t<F / 8, FN>(acc, X1, LDX, row0, wmat(wpk, M_W2), nt0);
      acc_store(Y, F, row0, col0, acc, vw + V_B2);  // Y was last read before the barrier above
      __syncthreads();
      ln_silu_keep_rows(Y, F, H2W, ST + 6 * ETR, vw + V_LN2S, vw + V_LN2B);  // a2 of w
      __syncthreads();
#pragma unroll 1
      for (int k = 0; k < 5; ++k) {
        acc_zero(acc);
        mma3t<F / 8, 5 * FN>(acc, X2, LDX, row0, wmat(wpk, M_PHI3), k * FN + nt0);
        scratch_put(scr + (size_t)(2 * k) * FRAG4 * NT, acc, col0, vp + V_B3 + k * F);
        acc_zero(acc);
        mma3t<F / 8, 5 * FN>(acc, Y, F, row0, wmat(wpk, M_W3), k * FN + nt0);
        scratch_put(scr + (size_t)(2 * k + 1) * FRAG4 * NT, acc, col0, vw + V_B3 + k * F);
      }
      __syncthreads();  // every warp is done with X2 and Y
    }

    // ---- lane l of the tile ----
    stage_rows<ETR>(XB, LDX, din + (size_t)l * rows * 2 * F, 2 * F, r0, nrows);
    stage_rows<ETR>(Y, F, dpe + (size_t)l * rows * F, F, r0, nrows);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    // phi's tangent front, replayed at h1p, h2p
    acc_zero(acc);
    mma3t<2 * F / 8, FN>(acc, XB, LDX, row0, wmat(wpk, M_PHI1), nt0);
    __syncthreads();  // every warp has read din
    acc_put(X1, LDX, row0, col0, acc);
    __syncthreads();
    ln_silu_tan_keep_rows(X1, LDX, H1P, ST, vp + V_LN1S, vp + V_LN1B);
    __syncthreads();
    acc_zero(acc);
    mma3t<F / 8, FN>(acc, X1, LDX, row0, wmat(wpk, M_PHI2), nt0);
    acc_put(X2, LDX, row0, col0, acc);  // X2 was last read before the barriers above
    __syncthreads();
    ln_silu_tan_keep_rows(X2, LDX, H2P, ST + 2 * ETR, vp + V_LN2S, vp + V_LN2B);  // da2 of phi
    // w's tangent front, replayed at h1w, h2w
    acc_zero(acc);
    mma3t<F / 8, FN>(acc, Y, F, row0, wmat(wpk, M_W1), nt0);
    acc_put(X1, LDX, row0, col0, acc);  // X1 was last read before the barrier above
    __syncthreads();
    ln_silu_tan_keep_rows(X1, LDX, H1W, ST + 4 * ETR, vw + V_LN1S, vw + V_LN1B);
    __syncthreads();
    acc_zero(acc);
    mma3t<F / 8, FN>(acc, X1, LDX, row0, wmat(wpk, M_W2), nt0);
    acc_put(Y, F, row0, col0, acc);  // Y was last read before the barrier above
    __syncthreads();
    ln_silu_tan_keep_rows(Y, F, H2W, ST + 6 * ETR, vw + V_LN2S, vw + V_LN2B);  // da2 of w
    __syncthreads();

    // the 5F chunks: dp q + p dq from registers to the output
    float* ol = out + (size_t)l * rows * 5 * F;
#pragma unroll 1
    for (int k = 0; k < 5; ++k) {
      float4 pq[FRAG4];
      scratch_get(pq, scr + (size_t)(2 * k + 1) * FRAG4 * NT);  // q, in flight during dp's products
      acc_zero(acc);
      mma3t<F / 8, 5 * FN>(acc, X2, LDX, row0, wmat(wpk, M_PHI3), k * FN + nt0);
#pragma unroll
      for (int s = 0; s < FRAG4; ++s) {  // acc = dp q
        float* a = acc[s >> 2][s & 3];
        a[0] *= pq[s].x;
        a[1] *= pq[s].y;
        a[2] *= pq[s].z;
        a[3] *= pq[s].w;
      }
      scratch_get(pq, scr + (size_t)(2 * k) * FRAG4 * NT);  // p, in flight during dq's products
      Acc dq;
      acc_zero(dq);
      mma3t<F / 8, 5 * FN>(dq, Y, F, row0, wmat(wpk, M_W3), k * FN + nt0);
#pragma unroll
      for (int s = 0; s < FRAG4; ++s) {
        const int rt = s >> 2, p = s & 3;
        float v[4];
        v[0] = acc[rt][p][0] + pq[s].x * dq[rt][p][0];
        v[1] = acc[rt][p][1] + pq[s].y * dq[rt][p][1];
        v[2] = acc[rt][p][2] + pq[s].z * dq[rt][p][2];
        v[3] = acc[rt][p][3] + pq[s].w * dq[rt][p][3];
        // swap half with the neighbour t ^ 1: an even t keeps row g, columns
        // 2t .. 2t + 3; an odd t row g + 8, columns 2t - 2 .. 2t + 1
        const bool odd = t & 1;
        const float s0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[2], 1);
        const float s1 = __shfl_xor_sync(0xffffffffu, odd ? v[1] : v[3], 1);
        const float4 o = odd ? make_float4(s0, s1, v[2], v[3]) : make_float4(v[0], v[1], s0, s1);
        const int r = row0 + 16 * rt + g + (odd ? 8 : 0);
        if (r < nrows)
          __stcs(reinterpret_cast<float4*>(ol + (r0 + r) * 5 * F + k * F + col0 + 8 * p + 2 * (t & ~1)),
                 o);
      }
    }
  }
}

}  // namespace tf32x3
}  // namespace pk

// mats is the layer's matrices split into TF32 hi and lo parts in fragment
// order (ops/pair_layer_kernel.pack_tf32_weights, 2 x 15 F^2 f32 values);
// scratch holds ctas x 5 x 2 x ETR x F floats (each CTA's primal p, q; ETR = 64
// at F = 128, 32 at F = 256); 1 <= ctas <= ceil(rows / ETR) K.
extern "C" int fused_edge_mlp_jvp_tf32x3(const void* in, const void* pe, const void* din,
                                         const void* dpe, const void* mats, const void* vecs,
                                         void* out, void* scratch, int rows, int K, int ctas,
                                         void* stream) {
  using namespace pk::tf32x3;
  const long long units = (long long)((rows + ETR - 1) / ETR) * K;
  if (rows < 1 || K < 1 || ctas < 1 || ctas > units) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(edge_jvp_tf32x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)JVP_SMEM);
  if (err != cudaSuccess) return (int)err;
  edge_jvp_tf32x3_kernel<<<ctas, pk::NT, JVP_SMEM, (cudaStream_t)stream>>>(
      (const float*)in, (const float*)pe, (const float*)din, (const float*)dpe,
      (const float*)mats, (const float*)vecs, (float*)out, (float4*)scratch, rows, K, ctas);
  return (int)cudaGetLastError();
}

extern "C" unsigned long long fused_edge_mlp_jvp_tf32x3_smem_bytes() {
  return (unsigned long long)pk::tf32x3::JVP_SMEM;
}

// floats of one CTA's scratch
extern "C" int fused_edge_mlp_jvp_tf32x3_scratch_floats() { return 4 * pk::tf32x3::SCR4; }

// rows of a row tile
extern "C" int fused_edge_mlp_jvp_tf32x3_rows() { return pk::tf32x3::ETR; }
