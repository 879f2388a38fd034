// Single-shape forward of the 8x256 SDF MLP: raw points [N, 3] for one latent
// -> [N] float32 SDF values.
//
// Replaces the Pallas TPU kernel `_points_kernel` (trunk in `_points_trunk`)
// in shapegan_tpu/ops/sdf_mlp_pallas.py, launched by apply_points_fused. As
// there, only the raw points cross device memory on the way in (12 bytes a
// point here, float32 xyz, rounded to bf16 in the kernel as the TPU wrapper
// rounds them): BOTH fan-in projections run in the kernel, pts @ w1p before
// layer 1 and pts @ w5p inside the layer-5 epilogue, as float32 sums of
// bf16 x bf16 products rounded to bf16 (the TPU kernel's K=8 matmul with a
// float32 result). The latent enters as the zz1/zz5 bias rows ([256] bf16,
// z @ w1z / w5z + b, computed once outside); after fold_latent, L=0 and they
// are the folded biases.
//
// The K=3 projections are a few float32 FMAs a value on the CUDA cores, far
// below the 6 x 256 x 256 tensor-core trunk; what bounds the kernel and how
// it streams the trunk weights is in sdf_trunk.cuh.
#include "sdf_trunk.cuh"

namespace {

using sdf::BLOCK_M;
using sdf::THREADS;

struct __align__(16) PointsSmem {
  sdf::TrunkSmem trunk;
  sdf::PointsInput in;
};

__global__ void __launch_bounds__(THREADS, 1)
sdf_points_kernel(const float* __restrict__ pts, const __nv_bfloat16* __restrict__ w1p,
                  const __nv_bfloat16* __restrict__ w5p, const __nv_bfloat16* __restrict__ zz1,
                  const __nv_bfloat16* __restrict__ zz5, const __nv_bfloat16* __restrict__ w,
                  const __nv_bfloat16* __restrict__ bias, const __nv_bfloat16* __restrict__ w8,
                  float* __restrict__ out, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PointsSmem& s = *reinterpret_cast<PointsSmem*>(smem_raw);

  const size_t p0 = static_cast<size_t>(blockIdx.x) * BLOCK_M;
  const int rows = min(BLOCK_M, static_cast<int>(n - p0));

  sdf::start_trunk(s.trunk, w, bias, w8, zz5);
  for (int i = threadIdx.x; i < BLOCK_M * 3; i += THREADS)
    s.in.pts[i / 3][i % 3] = i / 3 < rows ? sdf::round_bf16(pts[p0 * 3 + i]) : 0.f;
  sdf::load_projections(s.in, w1p, w5p);
  __syncthreads();

  sdf::points_layer1(s.trunk, s.in, zz1);
  sdf::run_trunk(s.trunk, w, sdf::PointsSkip{&s.in});

  const float v = sdf::head(s.trunk);
  const int row = threadIdx.x >> 1;
  if ((threadIdx.x & 1) == 0 && row < rows) out[p0 + row] = v;
}

}  // namespace

extern "C" int sdf_points_forward(const void* pts, const void* w1p, const void* w5p,
                                  const void* zz1, const void* zz5, const void* w,
                                  const void* bias, const void* w8, void* out, int n, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(sdf_points_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(PointsSmem)));
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(n) + BLOCK_M - 1) / BLOCK_M);
  sdf_points_kernel<<<blocks, THREADS, sizeof(PointsSmem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const __nv_bfloat16*>(w1p),
      static_cast<const __nv_bfloat16*>(w5p), static_cast<const __nv_bfloat16*>(zz1),
      static_cast<const __nv_bfloat16*>(zz5), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias), static_cast<const __nv_bfloat16*>(w8),
      static_cast<float*>(out), n);
  return cudaGetLastError();
}
