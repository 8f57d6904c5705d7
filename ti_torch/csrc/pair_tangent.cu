// Kernel B3: one cPaiNN message layer with K forward-mode probe lanes, for
// Hopper (sm_90a).
//
// Replaces ti_tpu/ops/pair_tangent_kernel.py::_pair_tangent_kernel (the Pallas
// TPU kernel built by _build_pair_tangent_layer). It computes kernel B1's
// primal (pair_common.cuh) and, for each lane, the JVP of the layer under
// that lane's tangents of (x, s, v, e): dr -> ddist -> ddir and dPE, both MLP
// tangent chains, the product rule, the Σ_j aggregations and the chirality
// term.
//
// What bounds it on this card: operations. Each lane repeats the layer's
// 15F² multiply-adds per pair row, so one launch at 128 chains, N = 19,
// F = 128 and K = 57 lanes is about 58 x 22.7 GFLOP, against about 3.3 GB of
// f32 lane tangents in and out — compute-bound on any unit of the card.
//
// What the design does about it: the TPU kernel carried its residuals from
// grid step kb = 0 to later steps; blocks on this card run in no order, so
// one CTA per (dst atom i, chain b) computes the primal once, keeps the
// replay residuals in shared memory (pre-LN activations of both MLPs, their
// post-LN outputs and dPE/ddist) and loops over the lanes in blocks of L.
// The 5F outputs of the primal MLPs do not fit beside them (about 160 KB
// each in f32 at 32 rows), so each lane block recomputes the primal 5F
// product chunk by chunk next to the L lanes' tangent chunks — 1/L of the
// last Dense's work extra. L is a launch parameter; the shared memory it
// needs is (9 + 3L) x 32 x F x 4 bytes plus small buffers (only L = 1 fits).
// Only tangent inputs and outputs reach device memory.
// Every product here is an f32 FMA on the CUDA cores. This file builds the
// f32 instantiation only (pair_tangent_f32, reached as variant "fma"), kept to
// be timed beside the 3xTF32 tensor-core kernel that f32 layers run
// (pair_tangent_tf32x3.cu); bf16_agg runs pair_tangent_mma.cu.

#include "pair_common.cuh"

namespace pk {

template <typename T>
size_t tangent_smem_bytes(int L) {
  return sizeof(T) * (size_t)(9 + 3 * L) * RF +
         sizeof(float) * (size_t)(NW * 3 * F + NGEO * R + 4 * L * R + 7 * F + 7 * F * L);
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
pair_tangent_kernel(const float* __restrict__ x, const T* __restrict__ s, const T* __restrict__ v,
                    const T* __restrict__ e, const float* __restrict__ dx,
                    const T* __restrict__ dsT, const T* __restrict__ dvT,
                    const T* __restrict__ deT, const T* __restrict__ mats,
                    const float* __restrict__ vecs, float* __restrict__ dvp,
                    float* __restrict__ dsp, T* __restrict__ ep, float* __restrict__ dvt,
                    float* __restrict__ dst, T* __restrict__ et, int N, int K, int L,
                    float pe_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y, i = blockIdx.x;
  const int tid = threadIdx.x, lane = lane_id();
  const size_t NN = (size_t)N * N;

  // shared memory: T region, then f32 region
  T* base = reinterpret_cast<T*>(smem);
  Residuals<T> res = {base, base + RF, base + 2 * RF, base + 3 * RF,
                      base + 4 * RF, base + 5 * RF, base + 6 * RF};
  T* WX = base + 7 * RF;       // R x 2F work buffer
  T* DA = base + 9 * RF;       // per lane: phi a2 tangent, w a2 tangent
  T* DG = DA + 2 * L * RF;     // per lane: the gates chunk of dh
  float* red = reinterpret_cast<float*>(DG + L * RF);
  float* geo = red + NW * 3 * F;
  float* lgeo = geo + NGEO * R;  // per lane: ddir (3 x R), ddist (R)
  float* acc = lgeo + 4 * L * R; // primal dv (3F), ds (F), t_cg (3F)
  float* lacc = acc + 7 * F;     // per lane: dv (3F), ds (F), dt_cg (3F)

  primal_layer<T, true>(b, i, N, pe_scale, x, s, v, e, mats, vecs, dvp, dsp, ep, WX,
                        DA /* Y */, red, geo, acc, res);
  __syncthreads();

  const int nblk = K / L;
  for (int kb = 0; kb < nblk; ++kb) {
    // ---- per lane: geometry tangents and both MLP tangent chains ----
    for (int l = 0; l < L; ++l) {
      const size_t bk = (size_t)b * K + kb * L + l;
      float* lg = lgeo + 4 * l * R;
      if (tid < R) {
        const int j = tid;
        float d0 = 0.f, d1 = 0.f, d2 = 0.f;
        if (j < N) {
          const float* dxb = dx + bk * N * 3;
          d0 = dxb[j * 3 + 0] - dxb[i * 3 + 0];
          d1 = dxb[j * 3 + 1] - dxb[i * 3 + 1];
          d2 = dxb[j * 3 + 2] - dxb[i * 3 + 2];
        }
        const float r0 = geo[G_R0 * R + j], r1 = geo[G_R1 * R + j], r2 = geo[G_R2 * R + j];
        const float inv = geo[G_INV * R + j];
        const float dd = (r0 * d0 + r1 * d1 + r2 * d2) * geo[G_SID * R + j];
        const float dinv = -(inv * inv) * dd;
        lg[0 * R + j] = rnd<T>(d0 * inv + r0 * dinv);
        lg[1 * R + j] = rnd<T>(d1 * inv + r1 * dinv);
        lg[2 * R + j] = rnd<T>(d2 * inv + r2 * dinv);
        lg[3 * R + j] = rnd<T>(dd);
      }
      // din = [ds_j | de_ij]
      for (int idx = tid; idx < RF; idx += NT) {
        const int j = idx / F, f = idx % F;
        float sv = 0.f, ev = 0.f;
        if (j < N) {
          sv = tof(dsT[(bk * N + j) * F + f]);
          ev = tof(deT[(bk * NN + (size_t)i * N + j) * F + f]);
        }
        WX[j * 2 * F + f] = Cvt<T>::from(sv);
        WX[j * 2 * F + F + f] = Cvt<T>::from(ev);
      }
      __syncthreads();
      mlp_front_tan<T>(WX, 2 * F, mats + M_PHI1, mats + M_PHI2, vecs + V_PHI, res.h1p, res.h2p,
                       DA + 2 * l * RF);
      // dPE = dPE/ddist * ddist
      for (int idx = tid; idx < RF; idx += NT) {
        const int j = idx / F;
        WX[idx] = Cvt<T>::from(tof(res.pef[idx]) * lg[3 * R + j]);
      }
      __syncthreads();
      mlp_front_tan<T>(WX, F, mats + M_W1, mats + M_W2, vecs + V_W, res.h1w, res.h2w,
                       DA + (2 * l + 1) * RF);
    }

    // ---- the 5F chunks: primal recomputed once, then each lane ----
    float g[RPW][4];
    for (int k = 0; k < 5; ++k) {
      float p[RPW][4], q[RPW][4], h[RPW][4];
      zero(p);
      zero(q);
      gemm<T>(p, res.a2p, F, F, mats + M_PHI3 + k * F, 5 * F);
      add_bias<T>(p, vecs + V_PHI + V_B3 + k * F);
      gemm<T>(q, res.a2w, F, F, mats + M_W3 + k * F, 5 * F);
      add_bias<T>(q, vecs + V_W + V_B3 + k * F);
      float m[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        m[r] = geo[G_MASK * R + RPW * warp_id() + r];
#pragma unroll
        for (int c = 0; c < 4; ++c) h[r][c] = rnd<T>(rnd<T>(p[r][c] * q[r][c]) * m[r]);
      }
      if (k == 0) {
#pragma unroll
        for (int r = 0; r < RPW; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) g[r][c] = h[r][c];
      }
      for (int l = 0; l < L; ++l) {
        const size_t bk = (size_t)b * K + kb * L + l;
        const float* lg = lgeo + 4 * l * R;
        float* la = lacc + 7 * l * F;
        float dp[RPW][4], dq[RPW][4], dh[RPW][4];
        zero(dp);
        zero(dq);
        gemm<T>(dp, DA + 2 * l * RF, F, F, mats + M_PHI3 + k * F, 5 * F);
        round_tile<T>(dp);
        gemm<T>(dq, DA + (2 * l + 1) * RF, F, F, mats + M_W3 + k * F, 5 * F);
        round_tile<T>(dq);
#pragma unroll
        for (int r = 0; r < RPW; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            dh[r][c] = rnd<T>(rnd<T>(rnd<T>(dp[r][c] * q[r][c]) + rnd<T>(p[r][c] * dq[r][c])) * m[r]);
        T* DGl = DG + l * RF;
        if (k == 0) {
          store_tile(DGl, dh);  // read back at k == 1 by the same thread
        } else if (k == 1) {  // Σ_j dgates·v + gates·dv + dscale·dir + scale·ddir
          float dg[RPW][4];
          load_tile(DGl, dg);
          float part[3][4] = {};
#pragma unroll
          for (int r = 0; r < RPW; ++r) {
            const int j = RPW * warp_id() + r;
            if (j >= N) continue;
#pragma unroll
            for (int c3 = 0; c3 < 3; ++c3) {
              float vv[4], dvv[4];
              ldg4(v + (((size_t)b * 3 + c3) * N + j) * F + 4 * lane, vv);
              ldg4(dvT + ((bk * 3 + c3) * N + j) * F + 4 * lane, dvv);
              const float dir = geo[(G_DIR0 + c3) * R + j], ddir = lg[c3 * R + j];
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                float t = rnd<T>(rnd<T>(dg[r][c] * vv[c]) + rnd<T>(g[r][c] * dvv[c]));
                t = rnd<T>(t + rnd<T>(dh[r][c] * dir));
                part[c3][c] += rnd<T>(t + rnd<T>(h[r][c] * ddir));
              }
            }
          }
          reduce_rows<3>(part, red, la);
        } else if (k == 2) {  // Σ_j dds
          float part[1][4] = {};
#pragma unroll
          for (int r = 0; r < RPW; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) part[0][c] += dh[r][c];
          reduce_rows<1>(part, red, la + 3 * F);
        } else if (k == 3) {  // de + dde
#pragma unroll
          for (int r = 0; r < RPW; ++r) {
            const int j = RPW * warp_id() + r;
            if (j >= N) continue;
            const size_t row = bk * NN + (size_t)i * N + j;
            float ev[4], out[4];
            ldg4(deT + row * F + 4 * lane, ev);
#pragma unroll
            for (int c = 0; c < 4; ++c) out[c] = ev[c] + dh[r][c];
            st4(et + row * F + 4 * lane, out);
          }
        } else {  // dt_cg = Σ_j dcg·dir + cg·ddir
          float part[3][4] = {};
#pragma unroll
          for (int r = 0; r < RPW; ++r) {
            const int j = RPW * warp_id() + r;
#pragma unroll
            for (int c3 = 0; c3 < 3; ++c3) {
              const float dir = geo[(G_DIR0 + c3) * R + j], ddir = lg[c3 * R + j];
#pragma unroll
              for (int c = 0; c < 4; ++c)
                part[c3][c] += rnd<T>(rnd<T>(dh[r][c] * dir) + rnd<T>(h[r][c] * ddir));
            }
          }
          reduce_rows<3>(part, red, la + 4 * F);
        }
      }
    }

    // ---- per lane outputs of dst atom i: dv with the chirality tangent, ds ----
    for (int idx = tid; idx < L * F; idx += NT) {
      const int l = idx / F, f = idx % F;
      const size_t bk = (size_t)b * K + kb * L + l;
      const float* la = lacc + 7 * l * F;
      float vc[3], dvc[3];
#pragma unroll
      for (int c3 = 0; c3 < 3; ++c3) {
        vc[c3] = tof(v[(((size_t)b * 3 + c3) * N + i) * F + f]);
        dvc[c3] = tof(dvT[((bk * 3 + c3) * N + i) * F + f]);
      }
      const float t0 = acc[4 * F + f], t1 = acc[5 * F + f], t2 = acc[6 * F + f];
      const float u0 = la[4 * F + f], u1 = la[5 * F + f], u2 = la[6 * F + f];
      const float dcx = u1 * vc[2] + t1 * dvc[2] - u2 * vc[1] - t2 * dvc[1];
      const float dcy = u2 * vc[0] + t2 * dvc[0] - u0 * vc[2] - t0 * dvc[2];
      const float dcz = u0 * vc[1] + t0 * dvc[1] - u1 * vc[0] - t1 * dvc[0];
      dvt[((bk * 3 + 0) * N + i) * F + f] = la[f] + dcx;
      dvt[((bk * 3 + 1) * N + i) * F + f] = la[F + f] + dcy;
      dvt[((bk * 3 + 2) * N + i) * F + f] = la[2 * F + f] + dcz;
      dst[(bk * N + i) * F + f] = la[3 * F + f];
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* const* p, int B, int N, int K, int L, float pe_scale, void* stream) {
  if (B < 1 || N < 2 || N > R || L < 1 || K < 1 || K % L) return (int)cudaErrorInvalidValue;
  const size_t smem = tangent_smem_bytes<T>(L);
  cudaError_t err = cudaFuncSetAttribute(pair_tangent_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pair_tangent_kernel<T><<<dim3(N, B), NT, smem, (cudaStream_t)stream>>>(
      (const float*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3], (const float*)p[4],
      (const T*)p[5], (const T*)p[6], (const T*)p[7], (const T*)p[8], (const float*)p[9],
      (float*)p[10], (float*)p[11], (T*)p[12], (float*)p[13], (float*)p[14], (T*)p[15], N, K,
      L, pe_scale);
  return (int)cudaGetLastError();
}

}  // namespace pk

extern "C" int pair_tangent_f32(const void* x, const void* s, const void* v, const void* e,
                                const void* dx, const void* ds, const void* dv, const void* de,
                                const void* mats, const void* vecs, void* dvp, void* dsp, void* ep,
                                void* dvt, void* dst, void* et, int B, int N, int K, int L,
                                float pe_scale, void* stream) {
  const void* p[16] = {x, s, v, e, dx, ds, dv, de, mats, vecs, dvp, dsp, ep, dvt, dst, et};
  return pk::launch<float>(p, B, N, K, L, pe_scale, stream);
}
