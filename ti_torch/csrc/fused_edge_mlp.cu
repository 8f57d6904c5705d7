// Kernel B4: the fused edge MLP phi(in) * w(pe), for Hopper (sm_90a).
//
// Replaces ti_tpu/ops/pallas_kernels.py::fused_edge_mlp (the Pallas TPU kernel
// body _kernel). Per row: phi(in) with in (2F) and w(pe) with pe (F), each MLP
// Dense-LN-SiLU x2 -> Dense 5F, and their product (5F), in f32. Rows are the
// B·N² pair rows of apply_dense(fused=True) or the B·N(N-1) edge rows of
// cpainn_fused.apply_fused.
//
// What bounds it on this card: operations. 15F² multiply-adds a row (phi 8F²,
// w 7F²): at 128 chains of the dense grid, R = 46,208 rows, 22.7 GFLOP against
// 189 MB of rows in and out, so 0.34 ms at 67 TFLOP/s of f32 FMA over 0.056 ms
// for the bytes at 3.35 TB/s.
//
// What the design does about it: one CTA of 256 threads per tile of 32 rows
// (the ragged last tile masked), the MLP chain of pair_common.cuh (one warp
// owns 4 whole rows, so LayerNorm runs in registers). Both MLPs' activations
// stay in shared memory (48 KB) and registers; the 5F product is formed one
// F-wide chunk at a time and only it is written. Weights stream from L2
// through the read-only cache. f32 FMA on the CUDA cores in this version.

#include "pair_common.cuh"

namespace pk {

__global__ void __launch_bounds__(NT, 2)
fused_edge_mlp_kernel(const float* __restrict__ in, const float* __restrict__ pe,
                      const float* __restrict__ mats, const float* __restrict__ vecs,
                      float* __restrict__ out, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* X = reinterpret_cast<float*>(smem);  // R x 2F input, then phi's a2 (R x F)
  float* Y = X + 2 * RF;                      // R x F encoding, then w's a2
  const size_t r0 = (size_t)blockIdx.x * R;
  load_rows(X, in, 2 * F, r0, rows);
  load_rows(Y, pe, F, r0, rows);
  __syncthreads();
  mlp_front<float>(X, 2 * F, mats + M_PHI1, mats + M_PHI2, vecs + V_PHI, X);
  mlp_front<float>(Y, F, mats + M_W1, mats + M_W2, vecs + V_W, Y);
  const int lane = lane_id();
  for (int k = 0; k < 5; ++k) {
    float p[RPW][4], q[RPW][4];
    zero(p);
    zero(q);
    gemm<float>(p, X, F, F, mats + M_PHI3 + k * F, 5 * F);
    add_bias<float>(p, vecs + V_PHI + V_B3 + k * F);
    gemm<float>(q, Y, F, F, mats + M_W3 + k * F, 5 * F);
    add_bias<float>(q, vecs + V_W + V_B3 + k * F);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const size_t row = r0 + RPW * warp_id() + r;
      if (row >= (size_t)rows) continue;
      float h[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) h[c] = p[r][c] * q[r][c];
      st4(out + row * 5 * F + k * F + 4 * lane, h);
    }
  }
}

}  // namespace pk

extern "C" int fused_edge_mlp_f32(const void* in, const void* pe, const void* mats,
                                  const void* vecs, void* out, int rows, void* stream) {
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 3 * pk::RF;
  cudaError_t err = cudaFuncSetAttribute(pk::fused_edge_mlp_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pk::fused_edge_mlp_kernel<<<(rows + pk::R - 1) / pk::R, pk::NT, smem, (cudaStream_t)stream>>>(
      (const float*)in, (const float*)pe, (const float*)mats, (const float*)vecs, (float*)out,
      rows);
  return (int)cudaGetLastError();
}
