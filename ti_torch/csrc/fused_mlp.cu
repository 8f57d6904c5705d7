// Kernel B6: one reference MLP (Dense-LN-SiLU x2 -> Dense) over row tiles, for
// Hopper (sm_90a).
//
// Replaces ti_tpu/ops/pallas_kernels.py::fused_mlp (the Pallas TPU kernel body
// _single_mlp_kernel). x (rows, f_in) -> (rows, f_out), hidden width F, f32.
// In cpainn_fused.apply_fused it runs the combine (f_in = 4F in ambient
// conditioning, 3F in latent, -> F), update (2F -> 3F) and readout (F -> 2)
// MLPs, on the B·N node rows.
//
// What bounds it on this card: launching it. Its launches are small: 2432
// rows at 128 chains and N = 19, (f_in + F + f_out) F multiply-adds a row —
// 0.48 GFLOP for the update MLP, 7 us at 67 TFLOP/s of f32 FMA, 6.2 MB of rows
// in and out (1.9 us at 3.35 TB/s) — so launch overhead and the host's work
// between launches are of the order of its work. That is recorded, not fixed,
// here.
//
// What the design does about it: one CTA of 256 threads per tile of 32 rows,
// the MLP chain of pair_common.cuh; the input tile (32 x f_in) and the hidden
// activations stay in shared memory. The last Dense runs over F-wide column
// chunks of W3, padded with zeros to a multiple of F when the weights are
// packed (ops/pallas_kernels.pack_mlp), and stores only the f_out real
// columns of the real rows (the readout's f_out = 2 is a masked store). f32
// FMA on the CUDA cores.

#include "pair_common.cuh"

namespace pk {

__global__ void __launch_bounds__(NT, 2)
fused_mlp_kernel(const float* __restrict__ x, const float* __restrict__ mats,
                 const float* __restrict__ vecs, float* __restrict__ out, int rows, int f_in,
                 int f_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* X = reinterpret_cast<float*>(smem);  // R x f_in, then a2 (R x F)
  const int f_pad = (f_out + F - 1) / F * F;
  const float* W1 = mats;
  const float* W2 = W1 + (size_t)f_in * F;
  const float* W3 = W2 + (size_t)F * F;
  const size_t r0 = (size_t)blockIdx.x * R;
  const int lane = lane_id();
  load_rows(X, x, f_in, r0, rows);
  __syncthreads();
  mlp_front<float>(X, f_in, W1, W2, vecs, X);
  for (int k = 0; k < f_pad / F; ++k) {
    float a[RPW][4];
    zero(a);
    gemm<float>(a, X, F, F, W3 + k * F, f_pad);
    add_bias<float>(a, vecs + V_B3 + k * F);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const size_t row = r0 + RPW * warp_id() + r;
      if (row >= (size_t)rows) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k * F + 4 * lane + c;
        if (col < f_out) out[row * f_out + col] = a[r][c];
      }
    }
  }
}

}  // namespace pk

extern "C" int fused_mlp_f32(const void* x, const void* mats, const void* vecs, void* out,
                             int rows, int f_in, int f_out, void* stream) {
  if (rows < 1 || f_in < 4 || f_in % 4 || f_out < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * pk::R * (f_in > pk::F ? f_in : pk::F);
  cudaError_t err = cudaFuncSetAttribute(pk::fused_mlp_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pk::fused_mlp_kernel<<<(rows + pk::R - 1) / pk::R, pk::NT, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)mats, (const float*)vecs, (float*)out, rows, f_in, f_out);
  return (int)cudaGetLastError();
}
