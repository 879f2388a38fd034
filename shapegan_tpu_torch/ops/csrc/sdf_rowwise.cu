// Forward of the 8x256 SDF MLP with a latent per row: raw points [N, 3] and
// per-row latent terms zz1/zz5 [N, 256] bf16 -> [N] float32 SDF values (the
// DeepSDF autodecoder's training batch, each point carrying the code of its
// shape).
//
// Replaces the Pallas TPU kernel `_rowwise_kernel` (trunk in
// `_points_trunk`) in shapegan_tpu/ops/sdf_mlp_pallas.py, launched by
// `_rowwise_fwd` (the forward of apply_rowwise_trainable). zz1/zz5 =
// codes[shape] @ w1z / w5z + b1 / b5 are small bf16 products computed
// outside; both point projections run in the kernel, as in the points
// kernel (sdf_points.cu), at the same rounding points.
//
// What bounds it on the H100: the six 256x256 bf16 trunk products, 786
// kFLOP a row (15.7 GFLOP at the 20,000-row training batch: 16 us at the
// tensor cores' 989 TFLOP/s); the bytes are ~1 KB a row (12 of points,
// 2 x 512 of zz1/zz5, 4 out), 20 MB at 20,000 rows, 6 us at 3.35 TB/s. The
// trunk runs on the sdf_trunk.cuh main loop. What differs from the points
// kernel is where the latent terms live: one zz5 row fits in shared memory
// beside the trunk's ~191 KB, but a tile's 128 rows of zz1 and zz5 (128 KB)
// do not. So layer 1 reads each zz1 element once from device memory, as a
// bf16 pair, and the layer-5 epilogue does the same for zz5 (run_trunk's
// zz5 functor): 1 KB a row, read once, coalesced along the row.
#include "sdf_trunk.cuh"

namespace {

using sdf::BLOCK_M;
using sdf::THREADS;
using sdf::WIDTH;
using sdf::X_STRIDE;

struct __align__(16) RowwiseSmem {
  sdf::TrunkSmem trunk;
  sdf::PointsInput in;
};

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// run_trunk's layer-5 latent term: tile row `row`'s zz5 pair from device
// memory (zero for the rows past the end of the batch).
struct RowZz5 {
  const __nv_bfloat16* zz5;  // the tile's first row
  int rows;
  __device__ __forceinline__ float2 operator()(int row, int col) const {
    return row < rows ? load_pair(zz5 + static_cast<size_t>(row) * WIDTH + col) : make_float2(0.f, 0.f);
  }
};

__global__ void __launch_bounds__(THREADS, 1)
sdf_rowwise_kernel(const float* __restrict__ pts, const __nv_bfloat16* __restrict__ w1p,
                   const __nv_bfloat16* __restrict__ w5p, const __nv_bfloat16* __restrict__ zz1,
                   const __nv_bfloat16* __restrict__ zz5, const __nv_bfloat16* __restrict__ w,
                   const __nv_bfloat16* __restrict__ bias, const __nv_bfloat16* __restrict__ w8,
                   float* __restrict__ out, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  RowwiseSmem& s = *reinterpret_cast<RowwiseSmem*>(smem_raw);

  const size_t p0 = static_cast<size_t>(blockIdx.x) * BLOCK_M;
  const int rows = min(BLOCK_M, static_cast<int>(n - p0));

  sdf::start_weight_ring(s.trunk, w);
  for (int i = threadIdx.x; i < 8 * WIDTH; i += THREADS) s.trunk.bias[i] = bias[i];
  for (int i = threadIdx.x; i < WIDTH; i += THREADS) s.trunk.w8[i] = w8[i];
  for (int i = threadIdx.x; i < BLOCK_M * 3; i += THREADS)
    s.in.pts[i / 3][i % 3] = i / 3 < rows ? sdf::round_bf16(pts[p0 * 3 + i]) : 0.f;
  sdf::load_projections(s.in, w1p, w5p);
  __syncthreads();

  // Layer 1: relu(bf16(pts @ w1p) + zz1[row]), the sum rounded to bf16.
  const __nv_bfloat16* zrow = zz1 + p0 * WIDTH;
  for (int i = threadIdx.x; i < BLOCK_M * WIDTH / 2; i += THREADS) {
    const int r = i / (WIDTH / 2), c = (i % (WIDTH / 2)) * 2;
    const float2 a = sdf::project(s.in.pts[r], s.in.w1p, c);
    const float2 z = r < rows ? load_pair(zrow + static_cast<size_t>(r) * WIDTH + c) : make_float2(0.f, 0.f);
    *reinterpret_cast<__nv_bfloat162*>(s.trunk.x + r * X_STRIDE + c) =
        __floats2bfloat162_rn(fmaxf(a.x + z.x, 0.f), fmaxf(a.y + z.y, 0.f));
  }
  sdf::run_trunk(s.trunk, w, sdf::PointsSkip{&s.in}, RowZz5{zz5 + p0 * WIDTH, rows});

  const float v = sdf::head(s.trunk);
  const int row = threadIdx.x >> 1;
  if ((threadIdx.x & 1) == 0 && row < rows) out[p0 + row] = v;
}

}  // namespace

extern "C" int sdf_rowwise_forward(const void* pts, const void* w1p, const void* w5p,
                                   const void* zz1, const void* zz5, const void* w,
                                   const void* bias, const void* w8, void* out, int n, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(sdf_rowwise_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(RowwiseSmem)));
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(n) + BLOCK_M - 1) / BLOCK_M);
  using bf = __nv_bfloat16;
  sdf_rowwise_kernel<<<blocks, THREADS, sizeof(RowwiseSmem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const bf*>(w1p), static_cast<const bf*>(w5p),
      static_cast<const bf*>(zz1), static_cast<const bf*>(zz5), static_cast<const bf*>(w),
      static_cast<const bf*>(bias), static_cast<const bf*>(w8), static_cast<float*>(out), n);
  return cudaGetLastError();
}
