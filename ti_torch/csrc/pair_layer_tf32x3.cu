// Kernel B1 in f32 on Hopper's tensor cores (sm_90a), in split-precision TF32
// ("3xTF32"): one cPaiNN message layer on the dense pair grid.
//
// Replaces ti_tpu/ops/pair_layer_kernel.py::_pair_layer_kernel (the Pallas TPU
// kernel built by _build_pair_layer) for f32 weights and one chain per grid
// step. It computes what pair_layer.cu computes for C = 1 in f32, with the
// same layouts: per pair row p = i*N + j the geometry, the positional encoding
// of dist, phi([s_j | e_ij]) * w(PE) with both MLPs Dense-LN-SiLU x2 -> Dense
// 5F, the diagonal mask, the sums over j, the chirality term and e + de.
// pair_layer.cu keeps the f32-FMA instantiation (variant "fma"), bf16_agg
// and the chain-blocked kernel B2.
//
// What bounds it on this card: operations. 15 F^2 multiply-adds per pair row
// on B*N^2 rows (22.7 GFLOP at 128 chains, N = 19), which in f32 FMA take
// 0.34 ms at 67 TFLOP/s. f32 accuracy on the tensor cores costs three TF32
// products per product (a = a_hi + a_lo, b = b_hi + b_lo; a_lo b_hi + a_hi b_lo
// + a_hi b_hi, dropping a_lo b_lo, about 2^-22 |ab|): 0.14 ms at 495 TFLOP/s.
// The bytes (e in and out, about 50 MB) take 0.015 ms.
//
// What the design does about it:
// - tight row tiles. A CTA takes TR = 64 consecutive rows of e, seen as the
//   (B*N*N, F) matrix it is, holding G = 64 / N whole (chain, dst atom)
//   groups: 57 rows at N = 19 (11% padding, where one group a CTA padded
//   19 rows to 32). Group q of the launch is (b, i) = (q / N, q % N), its
//   rows q*N + j, contiguous in e and e_out. The sums over j are segmented
//   sums over each group's N rows, in a fixed order, from shared memory:
//   no atomics, so two launches on the same inputs agree to the bit;
// - every product is mma.sync.m16n8k8 in 3xTF32, the two small terms issued
//   before the large one, two k-steps' products into a fresh accumulator
//   that is then added to the running sum in f32 (see mma3). A warp owns 32
//   rows (two row tiles) and 32 columns (four n-tiles): each A fragment,
//   split once into hi and lo (cvt.rna, a subtraction, cvt.rna), feeds 4
//   n-tiles, and each weight fragment feeds 2 row tiles. The weights are
//   split and packed once by the wrapper in fragment order
//   (ops/pair_layer_kernel.pack_tf32_weights): one 16-byte load a thread
//   carries b_hi and b_lo of one n-tile, read for two k-steps at once from
//   global memory through L1 (the layer's 1.97 MB stay in L2). No
//   shared-memory ring stages them: a probe that read every fragment from L1
//   ran about 9% faster (PERF.md section 6), and two k-steps of the CTA's
//   fragments (16 KB) do not fit beside two CTAs' tiles of an SM. In a k-step
//   the logical rows t and t + 4 of the fragments are the adjacent rows 2t
//   and 2t + 1, so an A fragment is two 8-byte loads;
// - the activations live in f32 shared-memory tiles swizzled in 16-byte
//   chunks (X = [s_j | e_ij], 64 x 256; Y = PE, 64 x 128), reused for the
//   pre-LN products, the a2 outputs of both MLPs and each F-wide chunk of
//   the 5F product, which is formed and consumed at once. LayerNorm and
//   SiLU run on the tile in shared memory, a warp's own 8 rows at a time
//   with rolled loops (with a register fragment the bf16 kernel spilled);
// - the epilogues are f32 (bias, LayerNorm with f32 statistics and eps 1e-5,
//   SiLU, the mask, sincosf), as the plain version computes them.
// Built at three widths from this file (PK_F, pair_common.cuh; ops/_build.py):
// - F = 128 (library pair_layer_tf32x3): 8 warps, 99,584 bytes of shared
//   memory and 128 registers a thread, no spills: two CTAs of 8 warps an SM;
// - F = 64 (library pair_layer_tf32x3_f64, -DPK_F=64; the validation CLIs'
//   default width): the same 64-row tile and 32 x 32 warp block, so a CTA has
//   F / 16 = 4 warps and 50,432 bytes of shared memory (X 64 x 128, Y 64 x
//   64), and four CTAs share an SM at the same 128-register cap a thread (16
//   warps an SM, as at F = 128). A row of 64 columns is half a warp's 32 x
//   4: LayerNorm takes a row a half-warp, with its own shuffle sums (16
//   rows a warp). The layer's f32 weights are 0.25 MB, 0.49 MB packed hi/lo;
// - F = 256 (library pair_layer_tf32x3_f256, -DPK_F=256): the same 64-row
//   tile and warp block, so the CTA has F / 16 = 16 warps (two row halves x
//   F / 32 column blocks) and 197,888 bytes of shared memory (X 64 x 512, Y
//   64 x 256): one CTA of 16 warps an SM, at the same 128-register cap a
//   thread. LayerNorm then takes 4 rows a warp and 8 columns a lane. The
//   layer's f32 weights are 3.9 MB, 7.9 MB packed hi/lo: still in L2.
// The tile, mma3 and the epilogues live in tf32_common.cuh, shared with B3
// in f32.

#include "tf32_common.cuh"

namespace pk {
namespace tf32x3 {

// geometry rows kept in shared memory, TGEO arrays of TR floats
enum { T_DIST, T_MASK, T_DIR0, T_DIR1, T_DIR2, TGEO };
constexpr size_t SMEM = sizeof(float) * ((size_t)TR * (LDX + F) + TGEO * TR);
// threads of a CTA: two 32-row halves x F / 32 column blocks of 32, a warp
// each (4 warps at F = 64, 8 at F = 128, 16 at F = 256); CTAs an SM the
// launch bounds ask
constexpr int BNT = 2 * F;
constexpr int BNW = BNT / 32;
constexpr int MIN_CTAS = F == 64 ? 4 : F == 128 ? 2 : 1;

// LayerNorm (f32 statistics, eps 1e-5) -> SiLU in place on a swizzled TR x F
// tile: ln_silu_rows at F = 128; at F = 64 warp w takes rows TR / BNW * w ..
// (16), two at a time, a half-warp a row and lane l of it the columns
// 4 (l % 16) .. + 3; at F = 256 warp w takes rows TR / BNW * w .. and lane l
// the columns 128 c + 4 l .. + 3 of each 128-wide chunk c, read from the
// tile once for the mean, once for the variance and once to write (holding
// a row's 8 values across the two reductions spilled registers)
__device__ __forceinline__ void ln_silu_tile(float* T, int ld, const float* __restrict__ scale,
                                             const float* __restrict__ bias) {
  if constexpr (F == 64) {
    constexpr int RW = TR / BNW;
    const int lane = lane_id(), hl = lane & 15, w = (threadIdx.x & (BNT - 1)) >> 5;
    const float4 sc = __ldg(reinterpret_cast<const float4*>(scale + 4 * hl));
    const float4 bi = __ldg(reinterpret_cast<const float4*>(bias + 4 * hl));
#pragma unroll 1
    for (int rr = lane >> 4; rr < RW; rr += 2) {  // both halves take RW / 2 rows
      float4* at = reinterpret_cast<float4*>(T + swz(RW * w + rr, 4 * hl, ld));
      const float4 v = *at;
      const float mu = half_sum(v.x + v.y + v.z + v.w) * (1.f / F);
      const float d0 = v.x - mu, d1 = v.y - mu, d2 = v.z - mu, d3 = v.w - mu;
      const float rstd = 1.f / sqrtf(half_sum(d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3) * (1.f / F) + 1e-5f);
      *at = make_float4(silu(d0 * rstd * sc.x + bi.x), silu(d1 * rstd * sc.y + bi.y),
                        silu(d2 * rstd * sc.z + bi.z), silu(d3 * rstd * sc.w + bi.w));
    }
  } else if constexpr (F == 128) {
    ln_silu_rows(T, ld, scale, bias);
  } else {
    constexpr int CH = F / 128, RW = TR / BNW;
    const int lane = lane_id(), w = (threadIdx.x & (BNT - 1)) >> 5;
#pragma unroll 1
    for (int rr = 0; rr < RW; ++rr) {
      const int r = RW * w + rr;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float4 v = *reinterpret_cast<const float4*>(T + swz(r, 128 * c + 4 * lane, ld));
        sum += v.x + v.y + v.z + v.w;
      }
      const float mu = warp_sum(sum) * (1.f / F);
      float sq = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float4 v = *reinterpret_cast<const float4*>(T + swz(r, 128 * c + 4 * lane, ld));
        const float d0 = v.x - mu, d1 = v.y - mu, d2 = v.z - mu, d3 = v.w - mu;
        sq += d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3;
      }
      const float rstd = 1.f / sqrtf(warp_sum(sq) * (1.f / F) + 1e-5f);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        float4* at = reinterpret_cast<float4*>(T + swz(r, 128 * c + 4 * lane, ld));
        const float4 v = *at;
        const float4 sc = __ldg(reinterpret_cast<const float4*>(scale + 128 * c + 4 * lane));
        const float4 bi = __ldg(reinterpret_cast<const float4*>(bias + 128 * c + 4 * lane));
        *at = make_float4(silu((v.x - mu) * rstd * sc.x + bi.x), silu((v.y - mu) * rstd * sc.y + bi.y),
                          silu((v.z - mu) * rstd * sc.z + bi.z), silu((v.w - mu) * rstd * sc.w + bi.w));
      }
    }
  }
}

__global__ void __launch_bounds__(BNT, MIN_CTAS)
pair_layer_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ s,
                         const float* __restrict__ v, const float* __restrict__ e,
                         const float* __restrict__ wpk, const float* __restrict__ vecs,
                         float* __restrict__ dv, float* __restrict__ ds,
                         float* __restrict__ e_out, int B, int N, int G, float pe_scale) {
  extern __shared__ __align__(16) float smem[];
  float* X = smem;                 // [s_j | e_ij]; later X1 | X2 (row stride LDX)
  float* X1 = X;                   // w's pre-LN products, then a2 of w
  float* X2 = X + F;               // phi's pre-LN products, then a2 of phi
  float* Y = X + TR * LDX;         // PE; later the 5F chunk h (row stride F)
  float* geo = Y + TR * F;
  const int tid = threadIdx.x, warp = (tid & (BNT - 1)) >> 5;  // warp_id() at F = 128
  const int row0 = 32 * (warp & 1), col0 = 32 * (warp >> 1), nt0 = 4 * (warp >> 1);
  const int q0 = blockIdx.x * G;                 // the CTA's first group
  const int ng = min(G, B * N - q0);             // its groups
  const int rows = ng * N;                       // its real pair rows
  const size_t e0 = (size_t)q0 * N;              // its first row of e

  // geometry of row r: r = x_j - x_i, dist, mask, dir = r / (1 + dist)
  for (int r = tid; r < TR; r += BNT) {
    float d = 0.f, msk = 0.f, dir[3] = {0.f, 0.f, 0.f};
    if (r < rows) {
      const int q = q0 + r / N, j = r % N, b = q / N, i = q % N;
      const float* xb = x + (size_t)b * N * 3;
      float rv[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) rv[c] = xb[j * 3 + c] - xb[i * 3 + c];
      d = sqrtf(rv[0] * rv[0] + rv[1] * rv[1] + rv[2] * rv[2]);
      const float inv = 1.f / (1.f + d);
#pragma unroll
      for (int c = 0; c < 3; ++c) dir[c] = rv[c] * inv;
      msk = j != i ? 1.f : 0.f;
    }
    geo[T_DIST * TR + r] = d;
    geo[T_MASK * TR + r] = msk;
#pragma unroll
    for (int c = 0; c < 3; ++c) geo[(T_DIR0 + c) * TR + r] = dir[c];
  }
  __syncthreads();

  // X = [s_j | e_ij], Y = PE(dist) (interleaved cos/sin, rank f/2 + 1); zero
  // past the last real row
  for (int idx = tid; idx < TR * F / 4; idx += BNT) {
    const int r = idx / (F / 4), f = 4 * (idx % (F / 4));
    float4 sv = make_float4(0.f, 0.f, 0.f, 0.f), ev = sv;
    if (r < rows) {
      const int q = q0 + r / N, j = r % N, b = q / N;
      sv = __ldg(reinterpret_cast<const float4*>(s + ((size_t)b * N + j) * F + f));
      ev = __ldg(reinterpret_cast<const float4*>(e + (e0 + r) * F + f));
    }
    *reinterpret_cast<float4*>(X + swz(r, f, LDX)) = sv;
    *reinterpret_cast<float4*>(X + swz(r, F + f, LDX)) = ev;
    const float dist = geo[T_DIST * TR + r];
    float pe[4];
#pragma unroll
    for (int c = 0; c < 4; c += 2) {
      const float rank = (float)((f + c) / 2 + 1);
      float sn, cs;
      sincosf(dist * rank * pe_scale, &sn, &cs);
      pe[c] = cs;
      pe[c + 1] = sn;
    }
    *reinterpret_cast<float4*>(Y + swz(r, f, F)) = make_float4(pe[0], pe[1], pe[2], pe[3]);
  }
  __syncthreads();

  const float *vp = vecs + V_PHI, *vw = vecs + V_W;
  Acc acc;
  // phi's front: X (64 x 2F) -> X1 -> a2 of phi in X2
  acc_zero(acc);
  mma3<2 * F / 8, FN>(acc, X, LDX, row0, wmat(wpk, M_PHI1), nt0);
  __syncthreads();  // every warp has read X
  acc_store(X1, LDX, row0, col0, acc, vp + V_B1);
  __syncthreads();
  ln_silu_tile(X1, LDX, vp + V_LN1S, vp + V_LN1B);
  __syncthreads();
  acc_zero(acc);
  mma3<F / 8, FN>(acc, X1, LDX, row0, wmat(wpk, M_PHI2), nt0);
  acc_store(X2, LDX, row0, col0, acc, vp + V_B2);  // X2 was last read before the barriers above
  __syncthreads();
  ln_silu_tile(X2, LDX, vp + V_LN2S, vp + V_LN2B);
  // w's front: Y (64 x F) -> Y -> a2 of w in X1
  acc_zero(acc);
  mma3<F / 8, FN>(acc, Y, F, row0, wmat(wpk, M_W1), nt0);
  __syncthreads();  // every warp has read Y
  acc_store(Y, F, row0, col0, acc, vw + V_B1);
  __syncthreads();
  ln_silu_tile(Y, F, vw + V_LN1S, vw + V_LN1B);
  __syncthreads();
  acc_zero(acc);
  mma3<F / 8, FN>(acc, Y, F, row0, wmat(wpk, M_W2), nt0);
  acc_store(X1, LDX, row0, col0, acc, vw + V_B2);  // X1 was last read by phi's second product
  __syncthreads();
  ln_silu_tile(X1, LDX, vw + V_LN2S, vw + V_LN2B);
  __syncthreads();

  // the 5F product, one F-wide chunk k at a time, into Y (gates | scale_dir |
  // ds | de | cross_gates), then its segmented sums over j: thread idx owns
  // (group idx / F, column idx % F) in every chunk, so it reads back what it
  // stored in dv
  const float* mask = geo + T_MASK * TR;
  for (int k = 0; k < 5; ++k) {
    acc_zero(acc);
    mma3<F / 8, 5 * FN>(acc, X2, LDX, row0, wmat(wpk, M_PHI3), k * FN + nt0);
    acc_store(Y, F, row0, col0, acc, vp + V_B3 + k * F);  // p
    acc_zero(acc);
    mma3<F / 8, 5 * FN>(acc, X1, LDX, row0, wmat(wpk, M_W3), k * FN + nt0);
    acc_gate(Y, row0, col0, acc, vw + V_B3 + k * F, mask);  // h = p q mask
    __syncthreads();
    if (k == 3) {  // e + de, on whole rows
      for (int idx = tid; idx < rows * (F / 4); idx += BNT) {
        const int r = idx / (F / 4), f = 4 * (idx % (F / 4));
        const float4 ev = __ldg(reinterpret_cast<const float4*>(e + (e0 + r) * F + f));
        const float4 h = *reinterpret_cast<const float4*>(Y + swz(r, f, F));
        *reinterpret_cast<float4*>(e_out + (e0 + r) * F + f) =
            make_float4(ev.x + h.x, ev.y + h.y, ev.z + h.z, ev.w + h.w);
      }
    } else {
      for (int idx = tid; idx < ng * F; idx += BNT) {
        const int grp = idx / F, f = idx % F, q = q0 + grp, b = q / N, i = q % N;
        const int r0 = grp * N;
        float* dvq[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) dvq[c] = dv + (((size_t)b * 3 + c) * N + i) * F + f;
        if (k == 0) {  // Σ_j gates · v_j
          float a[3] = {0.f, 0.f, 0.f};
          for (int j = 0; j < N; ++j) {
            const float h = Y[swz(r0 + j, f, F)];
#pragma unroll
            for (int c = 0; c < 3; ++c) a[c] += h * __ldg(v + (((size_t)b * 3 + c) * N + j) * F + f);
          }
#pragma unroll
          for (int c = 0; c < 3; ++c) *dvq[c] = a[c];
        } else if (k == 2) {  // Σ_j ds
          float a = 0.f;
          for (int j = 0; j < N; ++j) a += Y[swz(r0 + j, f, F)];
          ds[((size_t)b * N + i) * F + f] = a;
        } else {  // k = 1: + Σ_j scale_dir · dir_j; k = 4: + (Σ_j cross_gates · dir_j) x v_i
          float a[3] = {0.f, 0.f, 0.f};
          for (int j = 0; j < N; ++j) {
            const float h = Y[swz(r0 + j, f, F)];
#pragma unroll
            for (int c = 0; c < 3; ++c) a[c] += h * geo[(T_DIR0 + c) * TR + r0 + j];
          }
          if (k == 4) {
            float vi[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) vi[c] = __ldg(v + (((size_t)b * 3 + c) * N + i) * F + f);
            const float t0 = a[0], t1 = a[1], t2 = a[2];
            a[0] = t1 * vi[2] - t2 * vi[1];
            a[1] = t2 * vi[0] - t0 * vi[2];
            a[2] = t0 * vi[1] - t1 * vi[0];
          }
#pragma unroll
          for (int c = 0; c < 3; ++c) *dvq[c] += a[c];
        }
      }
    }
    __syncthreads();  // Y is free for the next chunk
  }
}

}  // namespace tf32x3
}  // namespace pk

// mats is the layer's matrices split into TF32 hi and lo parts in fragment
// order (ops/pair_layer_kernel.pack_tf32_weights), 2 x 15 F^2 f32 values.
extern "C" int pair_layer_tf32x3(const void* x, const void* s, const void* v, const void* e,
                                 const void* mats, const void* vecs, void* dv, void* ds,
                                 void* e_out, int B, int N, float pe_scale, void* stream) {
  using namespace pk::tf32x3;
  if (B < 1 || N < 2 || N > pk::R) return (int)cudaErrorInvalidValue;
  const int G = TR / N;
  const long long ctas = ((long long)B * N + G - 1) / G;
  cudaError_t err = cudaFuncSetAttribute(pair_layer_tf32x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  pair_layer_tf32x3_kernel<<<(unsigned)ctas, BNT, SMEM, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)s, (const float*)v, (const float*)e, (const float*)mats,
      (const float*)vecs, (float*)dv, (float*)ds, (float*)e_out, B, N, G, pe_scale);
  return (int)cudaGetLastError();
}

extern "C" unsigned long long pair_layer_tf32x3_smem_bytes() {
  return (unsigned long long)pk::tf32x3::SMEM;
}

extern "C" int pair_layer_tf32x3_threads() { return pk::tf32x3::BNT; }

// CTAs of the kernel an SM holds (four at F = 64, two at F = 128, one at F =
// 256), or minus the CUDA error
extern "C" int pair_layer_tf32x3_ctas_per_sm() {
  using namespace pk::tf32x3;
  cudaError_t err = cudaFuncSetAttribute(pair_layer_tf32x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, pair_layer_tf32x3_kernel, BNT, SMEM);
  return err == cudaSuccess ? n : -(int)err;
}
