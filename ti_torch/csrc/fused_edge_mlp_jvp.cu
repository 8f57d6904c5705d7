// Kernel B5: the tangent of the fused edge MLP phi(in) * w(pe) under K lanes
// of input tangents (din, dpe), for Hopper (sm_90a).
//
// Replaces ti_tpu/ops/pallas_kernels.py::fused_edge_mlp_jvp (the Pallas TPU
// kernel body _edge_jvp_kernel), the tangent rule of fused_edge_mlp_diff. Per
// row and lane: dp and dq, the tangents of both MLPs (Dense -> LN-SiLU
// tangent at the primal's statistics, twice, -> Dense 5F), and
// dp * q + p * dq, in f32. On the exact divergence of apply_dense(fused=True)
// the K = 3N lanes of one node arrive in one launch per layer.
//
// What bounds it on this card: operations. Each lane repeats the MLPs' 15F²
// multiply-adds a row: at one exact node of 32 chains (K = 57, R = 11,552
// dense rows) that is 323.6 GFLOP, 4.8 ms at 67 TFLOP/s of f32 FMA, over the
// 2.7 GB of lane tangents in and out (0.8 ms at 3.35 TB/s).
//
// What the design does about it: the primal rows come once, (R, .), and the
// tangents as (K, R, .); nothing is expanded K times in device memory. One CTA
// of 256 threads per tile of 32 rows computes the primal chain once and keeps
// its replay residuals in shared memory (pre-LN products and post-LN outputs
// of both MLPs), then loops over the K lanes in blocks of L, as kernel B3
// does. The primal 5F outputs do not fit beside them (160 KB), so each lane
// block recomputes them chunk by chunk next to its L lanes' tangent chunks:
// 1/L of the last Dense's work extra. Shared memory is (8 + 2L) x 32 x F
// floats: L = 3 (224 KB) at most. f32 FMA on the CUDA cores in this version.

#include "pair_common.cuh"

namespace pk {

__host__ __device__ constexpr size_t jvp_smem_bytes(int L) {
  return sizeof(float) * (size_t)(8 + 2 * L) * RF;
}

__global__ void __launch_bounds__(NT, 1)
fused_edge_mlp_jvp_kernel(const float* __restrict__ in, const float* __restrict__ pe,
                          const float* __restrict__ din, const float* __restrict__ dpe,
                          const float* __restrict__ mats, const float* __restrict__ vecs,
                          float* __restrict__ out, int rows, int K, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* H1P = reinterpret_cast<float*>(smem);
  float* H2P = H1P + RF;
  float* A2P = H1P + 2 * RF;
  float* H1W = H1P + 3 * RF;
  float* H2W = H1P + 4 * RF;
  float* A2W = H1P + 5 * RF;
  float* X = H1P + 6 * RF;   // R x 2F work buffer
  float* DA = H1P + 8 * RF;  // per lane of the block: the tangents of phi's and w's a2
  const size_t r0 = (size_t)blockIdx.x * R;
  const size_t lane_stride = (size_t)rows;  // rows per lane in din, dpe, out
  const int lane = lane_id();

  // the primal chains, once
  load_rows(X, in, 2 * F, r0, rows);
  __syncthreads();
  mlp_front<float>(X, 2 * F, mats + M_PHI1, mats + M_PHI2, vecs + V_PHI, A2P, H1P, H2P);
  load_rows(X, pe, F, r0, rows);
  __syncthreads();
  mlp_front<float>(X, F, mats + M_W1, mats + M_W2, vecs + V_W, A2W, H1W, H2W);

  for (int kb = 0; kb < K / L; ++kb) {
    // the tangent chains of both MLPs' fronts, per lane
    for (int l = 0; l < L; ++l) {
      const size_t kk = (size_t)kb * L + l;
      load_rows(X, din + kk * lane_stride * 2 * F, 2 * F, r0, rows);
      __syncthreads();
      mlp_front_tan<float>(X, 2 * F, mats + M_PHI1, mats + M_PHI2, vecs + V_PHI, H1P, H2P,
                           DA + 2 * l * RF);
      load_rows(X, dpe + kk * lane_stride * F, F, r0, rows);
      __syncthreads();
      mlp_front_tan<float>(X, F, mats + M_W1, mats + M_W2, vecs + V_W, H1W, H2W,
                           DA + (2 * l + 1) * RF);
    }
    // the 5F chunks: the primal p, q once, then dp * q + p * dq per lane
    for (int k = 0; k < 5; ++k) {
      float p[RPW][4], q[RPW][4];
      zero(p);
      zero(q);
      gemm<float>(p, A2P, F, F, mats + M_PHI3 + k * F, 5 * F);
      add_bias<float>(p, vecs + V_PHI + V_B3 + k * F);
      gemm<float>(q, A2W, F, F, mats + M_W3 + k * F, 5 * F);
      add_bias<float>(q, vecs + V_W + V_B3 + k * F);
      for (int l = 0; l < L; ++l) {
        const size_t kk = (size_t)kb * L + l;
        float dp[RPW][4], dq[RPW][4];
        zero(dp);
        zero(dq);
        gemm<float>(dp, DA + 2 * l * RF, F, F, mats + M_PHI3 + k * F, 5 * F);
        gemm<float>(dq, DA + (2 * l + 1) * RF, F, F, mats + M_W3 + k * F, 5 * F);
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const size_t row = r0 + RPW * warp_id() + r;
          if (row >= (size_t)rows) continue;
          float h[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) h[c] = dp[r][c] * q[r][c] + p[r][c] * dq[r][c];
          st4(out + (kk * lane_stride + row) * 5 * F + k * F + 4 * lane, h);
        }
      }
    }
    __syncthreads();  // DA is rewritten by the next lane block
  }
}

}  // namespace pk

extern "C" int fused_edge_mlp_jvp_f32(const void* in, const void* pe, const void* din,
                                      const void* dpe, const void* mats, const void* vecs,
                                      void* out, int rows, int K, int L, void* stream) {
  if (rows < 1 || K < 1 || L < 1 || K % L) return (int)cudaErrorInvalidValue;
  const size_t smem = pk::jvp_smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(pk::fused_edge_mlp_jvp_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pk::fused_edge_mlp_jvp_kernel<<<(rows + pk::R - 1) / pk::R, pk::NT, smem,
                                  (cudaStream_t)stream>>>(
      (const float*)in, (const float*)pe, (const float*)din, (const float*)dpe,
      (const float*)mats, (const float*)vecs, (float*)out, rows, K, L);
  return (int)cudaGetLastError();
}
