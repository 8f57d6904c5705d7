// Shared device code of the hand-written kernels (pair_layer.cu, pair_tangent.cu,
// fused_edge_mlp.cu, fused_edge_mlp_jvp.cu, fused_mlp.cu): the layouts, the
// 32-row tile, the MLP products, LayerNorm and the primal message layer.
//
// A group of 256 threads owns one tile of R = 32 rows: in the pair kernels
// one (chain b, dst atom i), the pair rows i*N + j of the N <= 32 source atoms
// j, padded; in the fused-MLP kernels 32 consecutive rows. A CTA is one group,
// or C groups in the chain-blocked pair layer (B2). The 256 threads are 8 warps; warp w owns
// rows 4w..4w+3 and lane l owns columns 4l..4l+3 of a 128-wide column block,
// so one warp holds whole rows of an F = 128 activation and LayerNorm runs on
// registers with warp shuffles. The matrix products read their A operand
// from shared memory (a broadcast within the warp) and their weights from
// global memory through the read-only cache (one row of W per warp step,
// coalesced, shared by the 8 warps of the CTA through L1; the whole layer's
// weights, 0.98 MB in f32, stay in the 50 MB L2 across CTAs). Every product
// is an f32 FMA (no TF32, no tensor cores in this version). T is the storage
// type of activations and weights: float, or bf16 in the bf16_agg profile,
// where each product is accumulated in f32 and rounded once, exactly where
// the plain PyTorch version rounds.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pk {

// feature width: 128 for every library; pair_layer_mma.cu,
// pair_layer_tf32x3.cu, pair_tangent_mma.cu and pair_tangent_tf32x3.cu are
// built twice more, with -DPK_F=256 and -DPK_F=64 (ops/_build.py BUILT_FROM).
// Their width choices name all three widths, so no width runs another's design.
#ifndef PK_F
#define PK_F 128
#endif
constexpr int F = PK_F;
static_assert(F == 64 || F == 128 || F == 256, "the pair kernels are built at F = 64, 128 or 256");
constexpr int R = 32;           // pair rows per CTA (src atoms of one dst atom)
constexpr int NT = 256;         // threads per CTA
constexpr int NW = NT / 32;     // warps
constexpr int RPW = R / NW;     // rows per warp
constexpr int RF = R * F;

// geometry rows kept in shared memory, NGEO arrays of R floats
enum { G_R0, G_R1, G_R2, G_DIST, G_INV, G_SID, G_MASK, G_DIR0, G_DIR1, G_DIR2, NGEO };

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float tof(float v) { return v; }
__device__ __forceinline__ float tof(bf16 v) { return __bfloat162float(v); }

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  __device__ __forceinline__ static float from(float v) { return v; }
};
template <> struct Cvt<bf16> {
  __device__ __forceinline__ static bf16 from(float v) { return __float2bfloat16_rn(v); }
};

// round to T's precision and back (identity for float)
template <typename T> __device__ __forceinline__ float rnd(float v) { return tof(Cvt<T>::from(v)); }

__device__ __forceinline__ void unpack4(uint2 q, float o[4]) {
  __nv_bfloat162 a, b;
  *reinterpret_cast<uint32_t*>(&a) = q.x;
  *reinterpret_cast<uint32_t*>(&b) = q.y;
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  o[0] = fa.x; o[1] = fa.y; o[2] = fb.x; o[3] = fb.y;
}

// four consecutive values as floats (generic pointer: shared or global)
__device__ __forceinline__ void ld4(const float* p, float o[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  o[0] = q.x; o[1] = q.y; o[2] = q.z; o[3] = q.w;
}
__device__ __forceinline__ void ld4(const bf16* p, float o[4]) {
  unpack4(*reinterpret_cast<const uint2*>(p), o);
}
// the same from global memory through the read-only cache
__device__ __forceinline__ void ldg4(const float* p, float o[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = q.x; o[1] = q.y; o[2] = q.z; o[3] = q.w;
}
__device__ __forceinline__ void ldg4(const bf16* p, float o[4]) {
  unpack4(__ldg(reinterpret_cast<const uint2*>(p)), o);
}
__device__ __forceinline__ void st4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(bf16* p, const float v[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<uint32_t*>(&a);
  q.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = q;
}

// 16 bytes from global to shared memory without passing through registers
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// thread index within the thread's 256-thread group, and its warp there
__device__ __forceinline__ int ltid() { return threadIdx.x & (NT - 1); }
__device__ __forceinline__ int warp_id() { return ltid() >> 5; }
__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void zero(float a[RPW][4]) {
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) a[r][c] = 0.f;
}

// acc[r][c] += sum_k A[(4w+r)*lda + k] * W[k*ldw + 4*lane + c], k < K (K % 4 == 0).
// A in shared memory, W in global memory already offset to its column block.
template <typename T>
__device__ __forceinline__ void gemm(float acc[RPW][4], const T* A, int lda, int K,
                                     const T* __restrict__ W, int ldw) {
  const T* a = A + RPW * warp_id() * lda;
  const T* wp = W + 4 * lane_id();
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float av[RPW][4];
#pragma unroll
    for (int r = 0; r < RPW; ++r) ld4(a + r * lda + k, av[r]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float wv[4];
      ldg4(wp + (size_t)(k + kk) * ldw, wv);
#pragma unroll
      for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r][kk], wv[c], acc[r][c]);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_tile(T* B, const float v[RPW][4]) {
#pragma unroll
  for (int r = 0; r < RPW; ++r) st4(B + (RPW * warp_id() + r) * F + 4 * lane_id(), v[r]);
}

template <typename T>
__device__ __forceinline__ void load_tile(const T* B, float v[RPW][4]) {
#pragma unroll
  for (int r = 0; r < RPW; ++r) ld4(B + (RPW * warp_id() + r) * F + 4 * lane_id(), v[r]);
}

// the dot product's output in T, plus the bias in T (an add in T's precision)
template <typename T>
__device__ __forceinline__ void add_bias(float v[RPW][4], const float* __restrict__ b) {
  float bb[4];
  ldg4(b + 4 * lane_id(), bb);
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) v[r][c] = rnd<T>(rnd<T>(v[r][c]) + rnd<T>(bb[c]));
}

template <typename T>
__device__ __forceinline__ void round_tile(float v[RPW][4]) {
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) v[r][c] = rnd<T>(v[r][c]);
}

__device__ __forceinline__ float silu(float l) { return l / (1.f + expf(-l)); }

// LayerNorm (f32 statistics, eps 1e-5) -> SiLU on the warp's rows, in place;
// the output rounds to T.
template <typename T>
__device__ __forceinline__ void ln_silu(float v[RPW][4], const float* __restrict__ scale,
                                        const float* __restrict__ bias) {
  float sc[4], bi[4];
  ldg4(scale + 4 * lane_id(), sc);
  ldg4(bias + 4 * lane_id(), bi);
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const float mu = warp_sum(v[r][0] + v[r][1] + v[r][2] + v[r][3]) * (1.f / F);
    float d[4], q = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      d[c] = v[r][c] - mu;
      q += d[c] * d[c];
    }
    const float rstd = 1.f / sqrtf(warp_sum(q) * (1.f / F) + 1e-5f);
#pragma unroll
    for (int c = 0; c < 4; ++c) v[r][c] = rnd<T>(silu(d[c] * rstd * sc[c] + bi[c]));
  }
}

// Tangent of LayerNorm -> SiLU at the stored pre-LN primal HP (shared, R x F)
// under the tangent dv, in place; statistics recomputed in f32.
template <typename T>
__device__ __forceinline__ void ln_silu_tan(float dv[RPW][4], const T* HP,
                                            const float* __restrict__ scale,
                                            const float* __restrict__ bias) {
  float sc[4], bi[4];
  ldg4(scale + 4 * lane_id(), sc);
  ldg4(bias + 4 * lane_id(), bi);
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    float h[4];
    ld4(HP + (RPW * warp_id() + r) * F + 4 * lane_id(), h);
    const float mu = warp_sum(h[0] + h[1] + h[2] + h[3]) * (1.f / F);
    float cen[4], q = 0.f, cd = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      cen[c] = h[c] - mu;
      q += cen[c] * cen[c];
      cd += cen[c] * dv[r][c];
    }
    const float rstd = 1.f / sqrtf(warp_sum(q) * (1.f / F) + 1e-5f);
    const float dmu = warp_sum(dv[r][0] + dv[r][1] + dv[r][2] + dv[r][3]) * (1.f / F);
    const float dvar = 2.f * (warp_sum(cd) * (1.f / F));
    const float drstd = -0.5f * rstd * rstd * rstd * dvar;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float dl = ((dv[r][c] - dmu) * rstd + cen[c] * drstd) * sc[c];
      const float l = cen[c] * rstd * sc[c] + bi[c];
      const float sig = 1.f / (1.f + expf(-l));
      dv[r][c] = rnd<T>(sig * (1.f + l * (1.f - sig)) * dl);
    }
  }
}

// Sum NQ per-warp partial rows (part[q][c] at column 4*lane+c) over the
// warps, in warp order, into out[q*F + f]. Ends with a barrier.
template <int NQ>
__device__ __forceinline__ void reduce_rows(const float (&part)[NQ][4], float* red, float* out) {
  const int w = warp_id(), lane = lane_id();
#pragma unroll
  for (int q = 0; q < NQ; ++q) st4(red + (w * NQ + q) * F + 4 * lane, part[q]);
  __syncthreads();
  for (int idx = ltid(); idx < NQ * F; idx += NT) {
    float s = 0.f;
#pragma unroll
    for (int ww = 0; ww < NW; ++ww) s += red[ww * NQ * F + idx];
    out[idx] = s;
  }
  __syncthreads();
}

// Rows r0 .. r0+R-1 of a (rows x W) f32 matrix into the tile T (R x W), zero
// past the last row (W % 4 == 0). No barrier.
__device__ __forceinline__ void load_rows(float* T, const float* __restrict__ src, int W,
                                          size_t r0, int rows) {
  const int w4 = W / 4;
  for (int idx = ltid(); idx < R * w4; idx += NT) {
    const int r = idx / w4, c = 4 * (idx % w4);
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < (size_t)rows) q = __ldg(reinterpret_cast<const float4*>(src + (r0 + r) * W + c));
    *reinterpret_cast<float4*>(T + r * W + c) = q;
  }
}

// Offsets into one MLP's packed vectors, from the MLP's first one.
enum { V_B1 = 0, V_LN1S = F, V_LN1B = 2 * F, V_B2 = 3 * F, V_LN2S = 4 * F, V_LN2B = 5 * F, V_B3 = 6 * F };

// The two Dense-LN-SiLU blocks of one MLP on the tile's R rows: X holds the
// R x K input (row stride K, K % 4 == 0) and is a work buffer; the R x F
// output a2 goes to A2 (which may be X). W1 (K x F), W2 (F x F) and the
// vectors v are the MLP's; with H1/H2 non-null the pre-LN products are kept
// there (R x F). The caller puts a barrier between filling X and the call;
// the call ends with one.
template <typename T>
__device__ __forceinline__ void mlp_front(T* X, int K, const T* __restrict__ W1,
                                          const T* __restrict__ W2,
                                          const float* __restrict__ v, T* A2, T* H1 = nullptr,
                                          T* H2 = nullptr) {
  float a[RPW][4];
  zero(a);
  gemm<T>(a, X, K, K, W1, F);
  add_bias<T>(a, v + V_B1);
  if (H1) store_tile(H1, a);
  ln_silu<T>(a, v + V_LN1S, v + V_LN1B);
  __syncthreads();
  store_tile(X, a);
  __syncthreads();
  zero(a);
  gemm<T>(a, X, F, F, W2, F);
  add_bias<T>(a, v + V_B2);
  if (H2) store_tile(H2, a);
  ln_silu<T>(a, v + V_LN2S, v + V_LN2B);
  __syncthreads();
  store_tile(A2, a);
  __syncthreads();
}

// The tangent of mlp_front under the tangent rows in X (R x K), replayed at
// the primal's pre-LN products H1, H2 (no biases: they have no tangent);
// the tangent of a2 goes to DA. Same barriers as mlp_front.
template <typename T>
__device__ __forceinline__ void mlp_front_tan(T* X, int K, const T* __restrict__ W1,
                                              const T* __restrict__ W2,
                                              const float* __restrict__ v, const T* H1,
                                              const T* H2, T* DA) {
  float a[RPW][4];
  zero(a);
  gemm<T>(a, X, K, K, W1, F);
  round_tile<T>(a);
  ln_silu_tan<T>(a, H1, v + V_LN1S, v + V_LN1B);
  __syncthreads();
  store_tile(X, a);
  __syncthreads();
  zero(a);
  gemm<T>(a, X, F, F, W2, F);
  round_tile<T>(a);
  ln_silu_tan<T>(a, H2, v + V_LN2S, v + V_LN2B);
  __syncthreads();
  store_tile(DA, a);
  __syncthreads();
}

// Offsets into one layer's packed weights (ops/pair_layer_kernel.pack_layer):
// mats = phi.w1 (2F,F) | phi.w2 (F,F) | phi.w3 (F,5F) | w.w1 | w.w2 | w.w3;
// vecs = per MLP b1, ln1 scale, ln1 bias, b2, ln2 scale, ln2 bias, b3 (5F).
constexpr size_t M_PHI1 = 0, M_PHI2 = 2 * F * F, M_PHI3 = 3 * F * F;
constexpr size_t M_W1 = 8 * F * F, M_W2 = 9 * F * F, M_W3 = 10 * F * F;
constexpr int V_PHI = 0, V_W = 11 * F;

// Residuals of the primal layer that the tangent kernel replays (shared
// memory, R x F each): pre-LN h1/h2 and post-LN a2 of both MLPs, and the
// derivative of the positional encoding by dist.
template <typename T>
struct Residuals {
  T *h1p, *h2p, *a2p, *h1w, *h2w, *a2w, *pef;
};

// The primal message layer of tile (b, i). X (R x 2F) and Y (R x F) are work
// buffers; acc receives dv (3F), ds (F) and the chirality aggregate t_cg (3F)
// of dst atom i. With SAVE the residuals are kept for the tangent lanes.
// red may alias X's second half (R x F), which is free once phi's first
// product has read it. With store false nothing is written to device memory:
// the idle group of a chain-blocked CTA whose last block is not full still
// takes every barrier.
template <typename T, bool SAVE>
__device__ void primal_layer(int b, int i, int N, float pe_scale,
                             const float* __restrict__ x, const T* __restrict__ s,
                             const T* __restrict__ v, const T* __restrict__ e,
                             const T* __restrict__ mats, const float* __restrict__ vecs,
                             float* __restrict__ dv_out, float* __restrict__ ds_out,
                             T* __restrict__ e_out, T* X, T* Y, float* red, float* geo,
                             float* acc, Residuals<T> res, bool store = true) {
  const int tid = ltid(), lane = lane_id();
  const size_t NN = (size_t)N * N;
  const size_t pair0 = (size_t)b * NN + (size_t)i * N;  // pair row (b, i, j=0)

  // geometry of row j: r = x_j - x_i, dist, 1/(1+dist), 1/dist, mask, dir
  if (tid < R) {
    const int j = tid;
    const float* xb = x + (size_t)b * N * 3;
    float r0 = 0.f, r1 = 0.f, r2 = 0.f, dist = 0.f, msk = 0.f;
    if (j < N) {
      r0 = xb[j * 3 + 0] - xb[i * 3 + 0];
      r1 = xb[j * 3 + 1] - xb[i * 3 + 1];
      r2 = xb[j * 3 + 2] - xb[i * 3 + 2];
      dist = sqrtf(r0 * r0 + r1 * r1 + r2 * r2);
      msk = (j != i) ? 1.f : 0.f;
    }
    const float inv = 1.f / (1.f + dist);
    geo[G_R0 * R + j] = r0;
    geo[G_R1 * R + j] = r1;
    geo[G_R2 * R + j] = r2;
    geo[G_DIST * R + j] = dist;
    geo[G_INV * R + j] = inv;
    geo[G_SID * R + j] = dist > 0.f ? 1.f / fmaxf(dist, 1e-30f) : 0.f;
    geo[G_MASK * R + j] = msk;
    geo[G_DIR0 * R + j] = rnd<T>(r0 * inv);
    geo[G_DIR1 * R + j] = rnd<T>(r1 * inv);
    geo[G_DIR2 * R + j] = rnd<T>(r2 * inv);
  }
  __syncthreads();

  // X = [s_j | e_ij], Y = PE(dist_ij) (interleaved cos/sin, rank f/2+1)
  for (int idx = tid; idx < RF; idx += NT) {
    const int j = idx / F, f = idx % F;
    float sv = 0.f, ev = 0.f;
    if (j < N) {
      sv = tof(s[((size_t)b * N + j) * F + f]);
      ev = tof(e[(pair0 + j) * F + f]);
    }
    X[j * 2 * F + f] = Cvt<T>::from(sv);
    X[j * 2 * F + F + f] = Cvt<T>::from(ev);
    const float rank = (float)(f / 2 + 1);
    const float ang = geo[G_DIST * R + j] * rank * pe_scale;
    float sn, cs;
    sincosf(ang, &sn, &cs);
    Y[j * F + f] = Cvt<T>::from((f & 1) ? sn : cs);
    if (SAVE) res.pef[j * F + f] = Cvt<T>::from(((f & 1) ? cs : -sn) * rank * pe_scale);
  }
  __syncthreads();

  // both MLPs' fronts: a2 = LN-SiLU(LN-SiLU(in W1 + b1) W2 + b2)
  T* A2p = SAVE ? res.a2p : X;
  T* A2w = SAVE ? res.a2w : Y;
  mlp_front<T>(X, 2 * F, mats + M_PHI1, mats + M_PHI2, vecs + V_PHI, A2p,
               SAVE ? res.h1p : nullptr, SAVE ? res.h2p : nullptr);
  mlp_front<T>(Y, F, mats + M_W1, mats + M_W2, vecs + V_W, A2w, SAVE ? res.h1w : nullptr,
               SAVE ? res.h2w : nullptr);

  // the 5F product, one F-wide chunk at a time:
  // gates | scale_dir | ds | de | cross_gates
  float g[RPW][4];
  for (int k = 0; k < 5; ++k) {
    float p[RPW][4], q[RPW][4], h[RPW][4];
    zero(p);
    zero(q);
    gemm<T>(p, A2p, F, F, mats + M_PHI3 + k * F, 5 * F);
    add_bias<T>(p, vecs + V_PHI + V_B3 + k * F);
    gemm<T>(q, A2w, F, F, mats + M_W3 + k * F, 5 * F);
    add_bias<T>(q, vecs + V_W + V_B3 + k * F);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float m = geo[G_MASK * R + RPW * warp_id() + r];
#pragma unroll
      for (int c = 0; c < 4; ++c) h[r][c] = rnd<T>(rnd<T>(p[r][c] * q[r][c]) * m);
    }
    if (k == 0) {
#pragma unroll
      for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) g[r][c] = h[r][c];
    } else if (k == 1) {  // Σ_j gates·v_j + scale_dir·dir
      float part[3][4] = {};
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int j = RPW * warp_id() + r;
        if (j >= N) continue;
#pragma unroll
        for (int c3 = 0; c3 < 3; ++c3) {
          float vv[4];
          ldg4(v + (((size_t)b * 3 + c3) * N + j) * F + 4 * lane, vv);
          const float dir = geo[(G_DIR0 + c3) * R + j];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            part[c3][c] += rnd<T>(rnd<T>(g[r][c] * vv[c]) + rnd<T>(h[r][c] * dir));
        }
      }
      reduce_rows<3>(part, red, acc);
    } else if (k == 2) {  // Σ_j ds
      float part[1][4] = {};
#pragma unroll
      for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[0][c] += h[r][c];
      reduce_rows<1>(part, red, acc + 3 * F);
    } else if (k == 3) {  // e + de
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int j = RPW * warp_id() + r;
        if (j >= N || !store) continue;
        float ev[4], out[4];
        ldg4(e + (pair0 + j) * F + 4 * lane, ev);
#pragma unroll
        for (int c = 0; c < 4; ++c) out[c] = ev[c] + h[r][c];
        st4(e_out + (pair0 + j) * F + 4 * lane, out);
      }
    } else {  // t_cg = Σ_j cross_gates·dir
      float part[3][4] = {};
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int j = RPW * warp_id() + r;
#pragma unroll
        for (int c3 = 0; c3 < 3; ++c3) {
          const float dir = geo[(G_DIR0 + c3) * R + j];
#pragma unroll
          for (int c = 0; c < 4; ++c) part[c3][c] += rnd<T>(h[r][c] * dir);
        }
      }
      reduce_rows<3>(part, red, acc + 4 * F);
    }
  }

  // dv_i = Σ_j(...) + (t_cg × v_i); ds_i
  for (int f = tid; store && f < F; f += NT) {
    const float vx = tof(v[(((size_t)b * 3 + 0) * N + i) * F + f]);
    const float vy = tof(v[(((size_t)b * 3 + 1) * N + i) * F + f]);
    const float vz = tof(v[(((size_t)b * 3 + 2) * N + i) * F + f]);
    const float t0 = acc[4 * F + f], t1 = acc[5 * F + f], t2 = acc[6 * F + f];
    dv_out[(((size_t)b * 3 + 0) * N + i) * F + f] = acc[f] + (t1 * vz - t2 * vy);
    dv_out[(((size_t)b * 3 + 1) * N + i) * F + f] = acc[F + f] + (t2 * vx - t0 * vz);
    dv_out[(((size_t)b * 3 + 2) * N + i) * F + f] = acc[2 * F + f] + (t0 * vy - t1 * vx);
    ds_out[((size_t)b * N + i) * F + f] = acc[3 * F + f];
  }
}

}  // namespace pk

extern "C" const char* pk_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }
