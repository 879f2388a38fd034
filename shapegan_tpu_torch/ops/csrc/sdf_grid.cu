// Grid forward of the 8x256 SDF MLP: B shape latents over one shared point
// grid -> [B, P] float32 SDF values.
//
// Replaces the Pallas TPU kernel `_kernel` in shapegan_tpu/ops/sdf_mlp_pallas.py
// (launched by apply_grid_fused). As there, the fan-in projections are done
// outside the kernel: pp1/pp5 = pts @ w1p / w5p ([P, 256] bf16, shared by all
// shapes) and zz1/zz5 = z @ w1z / w5z + b ([B, 256] bf16, one row per shape).
// The per-point latent repeat is never materialized: a block's rows are one
// point tile of one shape, its layer-1 input is relu(pp1[tile] + zz1[shape]),
// and layer 5 re-injects pp5[tile] + zz5[shape].
//
// Where the TPU kernel folded the whole shape batch into one grid step's rows
// (blocks run in order on one core there), here every (point tile, shape)
// pair is an independent block: nothing carries between blocks, and the
// 128-row tile x 256 columns of activations stays in shared memory through
// all layers (sdf_trunk.cuh says what bounds the kernel and how the weights
// are streamed). Consecutive blocks share a point tile, so its pp1/pp5 rows
// are read from device memory once and then hit L2 for the other shapes.
#include "sdf_trunk.cuh"

namespace {

using sdf::BLOCK_M;
using sdf::THREADS;
using sdf::WIDTH;

struct GridSkip {
  const __nv_bfloat16* pp5;  // this tile's first row
  int rows;                               // valid rows in the tile
  __device__ __forceinline__ float2 operator()(int row, int col) const {
    if (row >= rows) return make_float2(0.f, 0.f);
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(pp5 + static_cast<size_t>(row) * WIDTH + col));
  }
};

__global__ void __launch_bounds__(THREADS, 1)
sdf_grid_kernel(const __nv_bfloat16* __restrict__ pp1, const __nv_bfloat16* __restrict__ pp5,
                const __nv_bfloat16* __restrict__ zz1, const __nv_bfloat16* __restrict__ zz5,
                const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ bias,
                const __nv_bfloat16* __restrict__ w8, float* __restrict__ out, int batch,
                int points) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  sdf::TrunkSmem& s = *reinterpret_cast<sdf::TrunkSmem*>(smem_raw);

  const int shape = blockIdx.x % batch;
  const size_t p0 = static_cast<size_t>(blockIdx.x / batch) * BLOCK_M;
  const int rows = min(BLOCK_M, static_cast<int>(points - p0));

  sdf::start_trunk(s, w, bias, w8, zz5 + static_cast<size_t>(shape) * WIDTH);

  // Layer 1: relu(pp1 + zz1) in bf16, eight columns (16 bytes) per step.
  const __nv_bfloat16* zrow = zz1 + static_cast<size_t>(shape) * WIDTH;
  for (int i = threadIdx.x; i < BLOCK_M * WIDTH / 8; i += THREADS) {
    const int r = i / (WIDTH / 8), c = (i % (WIDTH / 8)) * 8;
    uint4 pv = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) pv = *reinterpret_cast<const uint4*>(pp1 + (p0 + r) * WIDTH + c);
    const uint4 zv = *reinterpret_cast<const uint4*>(zrow + c);
    const __nv_bfloat162* pp = reinterpret_cast<const __nv_bfloat162*>(&pv);
    const __nv_bfloat162* zp = reinterpret_cast<const __nv_bfloat162*>(&zv);
    uint4 xv;
    __nv_bfloat162* xp = reinterpret_cast<__nv_bfloat162*>(&xv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 a = __bfloat1622float2(pp[j]);
      const float2 z = __bfloat1622float2(zp[j]);
      xp[j] = __floats2bfloat162_rn(fmaxf(a.x + z.x, 0.f), fmaxf(a.y + z.y, 0.f));
    }
    *reinterpret_cast<uint4*>(s.x + r * sdf::X_STRIDE + c) = xv;
  }

  sdf::run_trunk(s, w, GridSkip{pp5 + p0 * WIDTH, rows});

  const float v = sdf::head(s);
  const int row = threadIdx.x >> 1;
  if ((threadIdx.x & 1) == 0 && row < rows)
    out[static_cast<size_t>(shape) * points + p0 + row] = v;
}

}  // namespace

extern "C" int sdf_grid_forward(const void* pp1, const void* pp5, const void* zz1,
                                const void* zz5, const void* w, const void* bias, const void* w8,
                                void* out, int batch, int points, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(sdf_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(sdf::TrunkSmem)));
  if (err != cudaSuccess) return err;
  const long long blocks = (static_cast<long long>(points) + BLOCK_M - 1) / BLOCK_M * batch;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  sdf_grid_kernel<<<static_cast<unsigned>(blocks), THREADS, sizeof(sdf::TrunkSmem),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(pp1), static_cast<const __nv_bfloat16*>(pp5),
      static_cast<const __nv_bfloat16*>(zz1), static_cast<const __nv_bfloat16*>(zz5),
      static_cast<const __nv_bfloat16*>(w), static_cast<const __nv_bfloat16*>(bias),
      static_cast<const __nv_bfloat16*>(w8), static_cast<float*>(out), batch, points);
  return cudaGetLastError();
}

extern "C" const char* sdf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
