// Kernel B7: the whole-network exact divergence of the dense-pair cPaiNN,
// for Hopper (sm_90a).
//
// Replaces ti_tpu/ops/div_kernel.py::_make_kernel (the Pallas TPU kernel run
// by _div_kernel_run). For one chain and one chunk of L identity-basis
// lanes it carries the lanes' tangents through every message and update
// layer, recomputing the primal message MLPs, and writes only the final node
// tangents d_v (3 components) and d_s of each lane. The primal per-layer
// states, the lane geometry and the readout stay plain PyTorch
// (ops/div_kernel.py), as in the JAX package.
//
// What bounds it on this card: operations. Per chain and layer each lane
// runs the w tangent (7F² multiply-adds per pair row) and, from layer 1 on,
// the phi tangent (8F²) over N² rows; at 128 chains, N = 19, F = 128,
// 5 layers and L = 4 that is about 9e12 FLOP per launch with the primal
// recompute, against about 0.5 GB of inputs and outputs.
//
// What the design does about the VMEM-to-shared-memory gap: the TPU kernel
// kept a chain's whole lane state in 100 MB of VMEM and looped over chunks
// inside one grid step. Lanes share no tangent state, so here one CTA takes
// one (chunk, chain) and the chunks run in any order. Inside the CTA:
// layers, then dst atoms i, one 32-row tile of source rows j each (N <= 32,
// padded). Per tile the primal fronts of phi and w are computed once and
// their pre-LN activations stay in shared memory (6 tiles of 32 x F f32);
// the lanes then run in sub-blocks of LB = 2: both MLP tangent fronts
// (2 tiles a lane), then the five F-wide chunks of the 5F products, where
// the primal chunk is recomputed once per sub-block (so 12 tiles, 217,600
// bytes in all, fit one CTA). The pair tangent d_e (L·N²·F floats, 739 KB at
// L = 4) lives in a global scratch slice of the CTA, updated in place: its
// rows i·N + j belong to tile i alone, so the update is race-free, and L2
// serves the reuse. The node tangents are double-buffered in global memory
// (the output and a scratch of the same shape): tiles read the previous
// layer's buffer as the source rows and write the new one for atom i; a
// barrier separates the layers, so no grid-wide sync is needed. After the
// tiles of a layer the update block runs on the L·N node rows, replaying the
// update MLP at its primal pre-LN activations, which the wrapper passes in.
// Buffers that the kernel writes are read with plain loads, never through
// the read-only cache. f32 FMA on the CUDA cores; wgmma and TMA are later
// work.

#include "pair_common.cuh"

namespace pk {

constexpr int LB = 2;  // lanes per sub-block
// rows of the primal node quantities per layer (ops/div_kernel.NODE_ROWS)
enum { N_Q = 0, N_UV = 3, N_VV = 6, N_VVN = 9, N_H1 = 10, N_H2 = 11, N_GU = 12, N_SSQ = 13, N_ROWS = 14 };

struct DivArgs {
  const float *s, *v, *e, *pe, *pep, *dir, *geom, *node;
  const float *w1, *w2, *w3, *vecs, *b3, *uk, *vk;
  float *out, *nodes, *de;
  int C, N, SL, L, n_chunks;
};

size_t div_smem_bytes() {
  return sizeof(float) * (size_t)(12 * RF + NW * 3 * F + 4 * R + LB * 4 * R + LB * 7 * F);
}

// One MLP of the stacks: W1 (2F x F, K rows used), W2 (F x F), W3 (F x 5F),
// vectors b1, ln1 scale/bias, b2, ln2 scale/bias (6F), b3 (5F).
struct Mlp {
  const float *w1, *w2, *w3, *v, *b3;
};

__device__ __forceinline__ Mlp mlp_at(const DivArgs& a, int idx) {
  return {a.w1 + (size_t)idx * 2 * F * F, a.w2 + (size_t)idx * F * F,
          a.w3 + (size_t)idx * F * 5 * F, a.vecs + (size_t)idx * 6 * F,
          a.b3 + (size_t)idx * 5 * F};
}

// The update block of one layer on the chunk's L·N node rows (lane-major,
// row = l·N + n), in place on the node tangents nw (L, 4, N, F): d_vv, d_|vv|,
// the update-MLP tangent at its primal pre-LN h1/h2, then d_v and d_s.
__device__ void update_block(const DivArgs& a, float* sm, float* nw, const float* nd, Mlp up,
                             const float* uk, const float* vk) {
  const int N = a.N, rows = a.L * N;
  const int tid = threadIdx.x, lane = lane_id(), wp = warp_id();
  float* DV = sm;           // 3 tiles: new d_v rows per component
  float* X = sm + 3 * RF;   // 2 tiles: [d_|vv| | d_s], then work
  float* H1 = sm + 5 * RF;
  float* H2 = sm + 6 * RF;
  float* DA = sm + 7 * RF;
  float* DN = sm + 8 * RF;  // d_|vv|
  for (int r0 = 0; r0 < rows; r0 += R) {
    for (int idx = tid; idx < RF; idx += NT) {
      const int rr = idx / F, f = idx % F, row = r0 + rr;
      float d0 = 0.f, d1 = 0.f, d2 = 0.f, ds = 0.f, h1 = 0.f, h2 = 0.f;
      if (row < rows) {
        const int l = row / N, n = row % N;
        const float* o = nw + (size_t)l * 4 * N * F + (size_t)n * F + f;
        d0 = o[0];
        d1 = o[(size_t)N * F];
        d2 = o[(size_t)2 * N * F];
        ds = o[(size_t)3 * N * F];
        h1 = nd[((size_t)N_H1 * N + n) * F + f];
        h2 = nd[((size_t)N_H2 * N + n) * F + f];
      }
      DV[idx] = d0;
      DV[RF + idx] = d1;
      DV[2 * RF + idx] = d2;
      X[rr * 2 * F + F + f] = ds;
      H1[idx] = h1;
      H2[idx] = h2;
    }
    __syncthreads();

    int nrow[RPW];
    bool live[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = r0 + RPW * wp + r;
      live[r] = row < rows;
      nrow[r] = live[r] ? row % N : 0;
    }
    // d_|vv| = Σ_c vv_c · (d_v_c V) / |vv|
    float dn[RPW][4];
    zero(dn);
    for (int c3 = 0; c3 < 3; ++c3) {
      float t[RPW][4];
      zero(t);
      gemm<float>(t, DV + c3 * RF, F, F, vk, F);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        float vv[4];
        ldg4(nd + ((size_t)(N_VV + c3) * N + nrow[r]) * F + 4 * lane, vv);
#pragma unroll
        for (int c = 0; c < 4; ++c) dn[r][c] += vv[c] * t[r][c];
      }
    }
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      float vn[4];
      ldg4(nd + ((size_t)N_VVN * N + nrow[r]) * F + 4 * lane, vn);
#pragma unroll
      for (int c = 0; c < 4; ++c) dn[r][c] /= vn[c];
      st4(X + (RPW * wp + r) * 2 * F + 4 * lane, dn[r]);
    }
    store_tile(DN, dn);
    __syncthreads();
    mlp_front_tan<float>(X, 2 * F, up.w1, up.w2, up.v, H1, H2, DA);

    // d_v_c += d_g_u · uv_c + g_u · (d_v_c U)
    float dgu[RPW][4];
    zero(dgu);
    gemm<float>(dgu, DA, F, F, up.w3, 5 * F);
    for (int c3 = 0; c3 < 3; ++c3) {
      float du[RPW][4];
      zero(du);
      gemm<float>(du, DV + c3 * RF, F, F, uk, F);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        if (!live[r]) continue;
        const int row = r0 + RPW * wp + r, l = row / N, n = nrow[r];
        float uv[4], gu[4], dv[4], o[4];
        ldg4(nd + ((size_t)(N_UV + c3) * N + n) * F + 4 * lane, uv);
        ldg4(nd + ((size_t)N_GU * N + n) * F + 4 * lane, gu);
        ld4(DV + c3 * RF + (RPW * wp + r) * F + 4 * lane, dv);
#pragma unroll
        for (int c = 0; c < 4; ++c) o[c] = dv[c] + dgu[r][c] * uv[c] + gu[c] * du[r][c];
        st4(nw + (((size_t)l * 4 + c3) * N + n) * F + 4 * lane, o);
      }
    }
    // d_s += 2 |vv| d_|vv| scale_sq + |vv|² d_scale_sq + d_add_inv
    float dsq[RPW][4], dad[RPW][4];
    zero(dsq);
    zero(dad);
    gemm<float>(dsq, DA, F, F, up.w3 + F, 5 * F);
    gemm<float>(dad, DA, F, F, up.w3 + 2 * F, 5 * F);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      if (!live[r]) continue;
      const int row = r0 + RPW * wp + r, l = row / N, n = nrow[r];
      float vn[4], sq[4], dnr[4], ds[4], o[4];
      float* p = nw + (((size_t)l * 4 + 3) * N + n) * F + 4 * lane;
      ldg4(nd + ((size_t)N_VVN * N + n) * F + 4 * lane, vn);
      ldg4(nd + ((size_t)N_SSQ * N + n) * F + 4 * lane, sq);
      ld4(DN + (RPW * wp + r) * F + 4 * lane, dnr);
      ld4(p, ds);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        o[c] = ds[c] + 2.f * vn[c] * dnr[c] * sq[c] + vn[c] * vn[c] * dsq[r][c] + dad[r][c];
      st4(p, o);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT, 1) div_kernel(DivArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int kk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = lane_id(), wp = warp_id();
  const int N = a.N, L = a.L, SL = a.SL, LP = a.n_chunks * a.L;
  const size_t NN = (size_t)N * N, NODE = (size_t)4 * N * F;

  float* H1P = sm;
  float* H2P = sm + RF;
  float* A2P = sm + 2 * RF;
  float* H1W = sm + 3 * RF;
  float* H2W = sm + 4 * RF;
  float* A2W = sm + 5 * RF;
  float* WX = sm + 6 * RF;    // 2 tiles: MLP inputs and work; the gates tangent in the 5F phase
  float* DA = sm + 8 * RF;    // per sub-block lane: phi a2 tangent, w a2 tangent
  float* red = sm + 12 * RF;
  float* gm = red + NW * 3 * F;  // mask (R), dir xyz (3R) of the tile's rows
  float* lg = gm + 4 * R;        // per sub-block lane: ddist (R), ddir xyz (3R)
  float* lacc = lg + LB * 4 * R; // per sub-block lane: Σ agg dv (3F), Σ dds (F), dq (3F)

  const size_t cta = (size_t)b * a.n_chunks + kk;
  float* bufA = a.out + cta * L * NODE;
  float* bufB = a.nodes + cta * L * NODE;
  float* de = a.de + cta * L * NN * F;
  const float* pe = a.pe + (size_t)b * NN * F;
  const float* pep = a.pep + (size_t)b * NN * F;
  const float* dir = a.dir + (size_t)b * NN * 4;

  for (int ly = 0; ly < SL; ++ly) {
    // the last layer writes the output buffer
    float* nw = ((SL - 1 - ly) % 2 == 0) ? bufA : bufB;
    const float* od = nw == bufA ? bufB : bufA;  // the previous layer's; unread at layer 0
    const bool first = ly == 0;
    const size_t cl = (size_t)b * SL + ly;
    const float* s = a.s + cl * N * F;
    const float* v = a.v + cl * 3 * N * F;
    const float* e = a.e + cl * NN * F;
    const float* nd = a.node + cl * N_ROWS * N * F;
    const Mlp phi = mlp_at(a, 3 * ly), w = mlp_at(a, 3 * ly + 1);

    for (int i = 0; i < N; ++i) {
      const size_t pi = (size_t)i * N;  // pair row (i, j = 0)
      if (tid < R) {
        const int j = tid;
        float m = 0.f, d0 = 0.f, d1 = 0.f, d2 = 0.f;
        if (j < N) {
          const float* dp = dir + (pi + j) * 4;
          m = j != i ? 1.f : 0.f;
          d0 = dp[0];
          d1 = dp[1];
          d2 = dp[2];
        }
        gm[j] = m;
        gm[R + j] = d0;
        gm[2 * R + j] = d1;
        gm[3 * R + j] = d2;
      }
      // ---- primal fronts of phi([s_j | e_ij]) and w(pe_ij), once per tile ----
      for (int idx = tid; idx < RF; idx += NT) {
        const int j = idx / F, f = idx % F;
        const bool in = j < N;
        WX[j * 2 * F + f] = in ? s[(size_t)j * F + f] : 0.f;
        WX[j * 2 * F + F + f] = in ? e[(pi + j) * F + f] : 0.f;
      }
      __syncthreads();
      mlp_front<float>(WX, 2 * F, phi.w1, phi.w2, phi.v, A2P, H1P, H2P);
      for (int idx = tid; idx < RF; idx += NT) {
        const int j = idx / F;
        WX[idx] = j < N ? pe[pi * F + idx] : 0.f;
      }
      __syncthreads();
      mlp_front<float>(WX, F, w.w1, w.w2, w.v, A2W, H1W, H2W);

      for (int l0 = 0; l0 < L; l0 += LB) {
        const int nb = min(LB, L - l0);
        // ---- per lane: geometry tangents and both MLP tangent fronts ----
        for (int l = 0; l < nb; ++l) {
          float* lgl = lg + 4 * l * R;
          if (tid < R) {
            const int j = tid;
            float g4[4] = {0.f, 0.f, 0.f, 0.f};
            if (j < N) ld4(a.geom + (((size_t)b * LP + kk * L + l0 + l) * NN + pi + j) * 4, g4);
#pragma unroll
            for (int q = 0; q < 4; ++q) lgl[q * R + j] = g4[q];
          }
          __syncthreads();
          for (int idx = tid; idx < RF; idx += NT) {  // d_pe = PE'(dist) · d_dist
            const int j = idx / F;
            WX[idx] = j < N ? pep[pi * F + idx] * lgl[j] : 0.f;
          }
          __syncthreads();
          mlp_front_tan<float>(WX, F, w.w1, w.w2, w.v, H1W, H2W, DA + (2 * l + 1) * RF);
          if (!first) {  // [d_s_j | d_e_ij]
            const float* dso = od + (size_t)(l0 + l) * NODE + (size_t)3 * N * F;
            const float* del = de + ((size_t)(l0 + l) * NN + pi) * F;
            for (int idx = tid; idx < RF; idx += NT) {
              const int j = idx / F, f = idx % F;
              const bool in = j < N;
              WX[j * 2 * F + f] = in ? dso[(size_t)j * F + f] : 0.f;
              WX[j * 2 * F + F + f] = in ? del[(size_t)j * F + f] : 0.f;
            }
            __syncthreads();
            mlp_front_tan<float>(WX, 2 * F, phi.w1, phi.w2, phi.v, H1P, H2P, DA + 2 * l * RF);
          }
        }

        // ---- the 5F chunks: primal recomputed per sub-block, then each lane ----
        float m[RPW];
#pragma unroll
        for (int r = 0; r < RPW; ++r) m[r] = gm[RPW * wp + r];
        float g[RPW][4];
        for (int k = 0; k < 5; ++k) {
          float p[RPW][4], q[RPW][4], h[RPW][4];
          zero(p);
          zero(q);
          gemm<float>(p, A2P, F, F, phi.w3 + k * F, 5 * F);
          add_bias<float>(p, phi.b3 + k * F);
          gemm<float>(q, A2W, F, F, w.w3 + k * F, 5 * F);
          add_bias<float>(q, w.b3 + k * F);
#pragma unroll
          for (int r = 0; r < RPW; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) h[r][c] = p[r][c] * q[r][c] * m[r];
          if (k == 0) {
#pragma unroll
            for (int r = 0; r < RPW; ++r)
#pragma unroll
              for (int c = 0; c < 4; ++c) g[r][c] = h[r][c];
          }
          for (int l = 0; l < nb; ++l) {
            const int lc = l0 + l;
            const float* lgl = lg + 4 * l * R;
            float* la = lacc + 7 * l * F;
            float dh[RPW][4], dq[RPW][4];
            zero(dq);
            gemm<float>(dq, DA + (2 * l + 1) * RF, F, F, w.w3 + k * F, 5 * F);
#pragma unroll
            for (int r = 0; r < RPW; ++r)
#pragma unroll
              for (int c = 0; c < 4; ++c) dh[r][c] = p[r][c] * dq[r][c];
            if (!first) {
              float dp[RPW][4];
              zero(dp);
              gemm<float>(dp, DA + 2 * l * RF, F, F, phi.w3 + k * F, 5 * F);
#pragma unroll
              for (int r = 0; r < RPW; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c) dh[r][c] += dp[r][c] * q[r][c];
            }
#pragma unroll
            for (int r = 0; r < RPW; ++r)
#pragma unroll
              for (int c = 0; c < 4; ++c) dh[r][c] *= m[r];
            float* DG = WX + l * RF;
            if (k == 0) {
              store_tile(DG, dh);  // read back at k == 1 by the same thread
            } else if (k == 1) {  // Σ_j dgates·v + gates·dv + dscale·dir + scale·ddir
              float dg[RPW][4];
              load_tile(DG, dg);
              float part[3][4] = {};
#pragma unroll
              for (int r = 0; r < RPW; ++r) {
                const int j = RPW * wp + r;
                if (j >= N) continue;
#pragma unroll
                for (int c3 = 0; c3 < 3; ++c3) {
                  float vv[4], dvv[4] = {0.f, 0.f, 0.f, 0.f};
                  ldg4(v + ((size_t)c3 * N + j) * F + 4 * lane, vv);
                  if (!first) ld4(od + (size_t)lc * NODE + ((size_t)c3 * N + j) * F + 4 * lane, dvv);
                  const float dr = gm[(1 + c3) * R + j], ddr = lgl[(1 + c3) * R + j];
#pragma unroll
                  for (int c = 0; c < 4; ++c)
                    part[c3][c] += dg[r][c] * vv[c] + g[r][c] * dvv[c] + dh[r][c] * dr + h[r][c] * ddr;
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
            } else if (k == 3) {  // d_e += dde, in place (rows of tile i only)
#pragma unroll
              for (int r = 0; r < RPW; ++r) {
                const int j = RPW * wp + r;
                if (j >= N) continue;
                float* dst = de + ((size_t)lc * NN + pi + j) * F + 4 * lane;
                float o[4] = {dh[r][0], dh[r][1], dh[r][2], dh[r][3]};
                if (!first) {
                  float ev[4];
                  ld4(dst, ev);
#pragma unroll
                  for (int c = 0; c < 4; ++c) o[c] += ev[c];
                }
                st4(dst, o);
              }
            } else {  // dq = Σ_j dcg·dir + cg·ddir
              float part[3][4] = {};
#pragma unroll
              for (int r = 0; r < RPW; ++r) {
                const int j = RPW * wp + r;
#pragma unroll
                for (int c3 = 0; c3 < 3; ++c3) {
                  const float dr = gm[(1 + c3) * R + j], ddr = lgl[(1 + c3) * R + j];
#pragma unroll
                  for (int c = 0; c < 4; ++c) part[c3][c] += dh[r][c] * dr + h[r][c] * ddr;
                }
              }
              reduce_rows<3>(part, red, la + 4 * F);
            }
          }
        }

        // ---- per lane, node i: d_v + agg + chirality tangent, d_s + Σ dds ----
        for (int idx = tid; idx < nb * F; idx += NT) {
          const int l = idx / F, f = idx % F, lc = l0 + l;
          const float* la = lacc + 7 * l * F;
          float vc[3], qv[3], dvo[3] = {0.f, 0.f, 0.f}, dso = 0.f;
#pragma unroll
          for (int c3 = 0; c3 < 3; ++c3) {
            vc[c3] = v[((size_t)c3 * N + i) * F + f];
            qv[c3] = nd[((size_t)(N_Q + c3) * N + i) * F + f];
            if (!first) dvo[c3] = od[(size_t)lc * NODE + ((size_t)c3 * N + i) * F + f];
          }
          if (!first) dso = od[(size_t)lc * NODE + ((size_t)3 * N + i) * F + f];
          const float u0 = la[4 * F + f], u1 = la[5 * F + f], u2 = la[6 * F + f];
          const float dcx = u1 * vc[2] + qv[1] * dvo[2] - u2 * vc[1] - qv[2] * dvo[1];
          const float dcy = u2 * vc[0] + qv[2] * dvo[0] - u0 * vc[2] - qv[0] * dvo[2];
          const float dcz = u0 * vc[1] + qv[0] * dvo[1] - u1 * vc[0] - qv[1] * dvo[0];
          float* o = nw + (size_t)lc * NODE + (size_t)i * F + f;
          o[0] = dvo[0] + la[f] + dcx;
          o[(size_t)N * F] = dvo[1] + la[F + f] + dcy;
          o[(size_t)2 * N * F] = dvo[2] + la[2 * F + f] + dcz;
          o[(size_t)3 * N * F] = dso + la[3 * F + f];
        }
        __syncthreads();
      }
    }
    // all dst tiles of the layer are written: the update block on node rows
    update_block(a, sm, nw, nd, mlp_at(a, 3 * ly + 2), a.uk + (size_t)ly * F * F,
                 a.vk + (size_t)ly * F * F);
  }
}

}  // namespace pk

extern "C" int div_kernel_f32(const void* s, const void* v, const void* e, const void* pe,
                              const void* pep, const void* dir, const void* geom,
                              const void* node, const void* w1, const void* w2, const void* w3,
                              const void* vecs, const void* b3, const void* uk, const void* vk,
                              void* out, void* nodes, void* de, int C, int N, int SL, int L,
                              int n_chunks, void* stream) {
  using namespace pk;
  if (C < 1 || C > 65535 || N < 2 || N > R || SL < 1 || L < 1 || n_chunks < 1)
    return (int)cudaErrorInvalidValue;
  DivArgs a = {(const float*)s,    (const float*)v,    (const float*)e,    (const float*)pe,
               (const float*)pep,  (const float*)dir,  (const float*)geom, (const float*)node,
               (const float*)w1,   (const float*)w2,   (const float*)w3,   (const float*)vecs,
               (const float*)b3,   (const float*)uk,   (const float*)vk,   (float*)out,
               (float*)nodes,      (float*)de,         C,                  N,
               SL,                 L,                  n_chunks};
  const size_t smem = div_smem_bytes();
  cudaError_t err =
      cudaFuncSetAttribute(div_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  div_kernel<<<dim3(n_chunks, C), NT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
