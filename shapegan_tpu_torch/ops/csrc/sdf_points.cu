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
// What bounds it on the H100: the six 256x256 bf16 products a point, 1.67 ms
// at 128^3 (16 bytes a point cross device memory). The design is the
// persistent, warp-specialized wgmma trunk of sdf_trunk_sm90.cuh: one block
// per SM, its two consumer warpgroups taking 64-point tiles in turn
// (tile = 2 block + warpgroup, then every 2 x grid), the weight ring fed by
// TMA once for the whole launch. The K=3 projections are a few float32 FMAs
// a value on the CUDA cores, inside the epilogues.
#include "sdf_trunk_sm90.cuh"

namespace {

using sdf90::ROWS;

__device__ __forceinline__ float3 rounded_point(const float* __restrict__ pts, long long row, int n) {
  if (row >= n) return make_float3(0.f, 0.f, 0.f);
  return make_float3(sdf90::round_bf16(pts[row * 3]), sdf90::round_bf16(pts[row * 3 + 1]),
                     sdf90::round_bf16(pts[row * 3 + 2]));
}

__global__ void __launch_bounds__(sdf90::THREADS, 1)
sdf_points_kernel(const __grid_constant__ CUtensorMap wmap, const float* __restrict__ pts,
                  const __nv_bfloat16* __restrict__ w1p, const __nv_bfloat16* __restrict__ w5p,
                  const __nv_bfloat16* __restrict__ zz1, const __nv_bfloat16* __restrict__ zz5,
                  const __nv_bfloat16* __restrict__ bias, const __nv_bfloat16* __restrict__ w8,
                  float* __restrict__ out, int n) {
  extern __shared__ unsigned char smem_raw[];
  sdf90::Smem& s = sdf90::aligned_smem<sdf90::Smem>(smem_raw);
  sdf90::setup(s, &wmap, bias, w8, w1p, w5p, zz1, zz5);

  const int wg = threadIdx.x / 128;
  if (wg == sdf90::CONSUMERS) {
    sdf90::producer_start();
    if (threadIdx.x == sdf90::PRODUCER_THREAD) sdf90::produce(s, &wmap);
  } else {
    sdf90::consumer_start(wg);
    const int t = threadIdx.x & 127, q = t & 3;
    const int r0 = (t >> 5) * 16 + ((t & 31) >> 2);
    sdf90::RingPos pos;
    for (long long tile = 2LL * blockIdx.x + wg;; tile += 2LL * gridDim.x) {
      const long long row0 = tile * ROWS + r0, row1 = row0 + 8;
      if (!sdf90::consumers_any(tile * ROWS < n)) break;
      const float2 v = sdf90::evaluate(s, wg, pos, rounded_point(pts, row0, n), rounded_point(pts, row1, n));
      if (q == 0 && row0 < n) out[row0] = v.x;
      if (q == 1 && row1 < n) out[row1] = v.y;
    }
    sdf90::consumer_finish(s, wg);
  }
}

}  // namespace

extern "C" int sdf_points_forward(const void* pts, const void* w1p, const void* w5p,
                                  const void* zz1, const void* zz5, const void* w,
                                  const void* bias, const void* w8, void* out, int n, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaErrorInvalidValue;
  CUtensorMap wmap;
  err = sdf90::weight_map(&wmap, w);
  if (err != cudaSuccess) return err;
  const int smem = static_cast<int>(sizeof(sdf90::Smem)) + 1024;
  err = cudaFuncSetAttribute(sdf_points_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long tiles = (static_cast<long long>(n) + sdf90::BLOCK_ROWS - 1) / sdf90::BLOCK_ROWS;
  const unsigned blocks = static_cast<unsigned>(tiles < sms ? tiles : sms);
  using bf = __nv_bfloat16;
  sdf_points_kernel<<<blocks, sdf90::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      wmap, static_cast<const float*>(pts), static_cast<const bf*>(w1p), static_cast<const bf*>(w5p),
      static_cast<const bf*>(zz1), static_cast<const bf*>(zz5), static_cast<const bf*>(bias),
      static_cast<const bf*>(w8), static_cast<float*>(out), n);
  return cudaGetLastError();
}
