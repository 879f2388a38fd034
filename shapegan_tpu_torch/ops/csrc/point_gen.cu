// Forward of the point-GAN generator (SDFGenerator: 8 layers of 256,
// LayerNorm and relu after layers 0-6, the latent added at layers 0 and 4,
// the positions concatenated back in at layer 4, a raw head): positions
// [B, N, 3] float32 -> raw SDF values [B, N] float32 (the critic step's fake
// clouds).
//
// Replaces the Pallas TPU kernel `_kernel` in
// shapegan_tpu/ops/point_gen_pallas.py, launched by `generate_fused`, at its
// rounding points: each layer's product is a float32 sum of bf16 products;
// bias, position and latent terms are added in float32; the LayerNorm is
// two-pass float32 (mean, then the mean of squared deviations, eps 1e-6);
// gamma and beta are bf16; the relu output is rounded to bf16. The head is a
// float32 row dot with the bf16 w7 row, plus b7, with no tanh.
//
// What bounds it on the H100: the six 256x256 bf16 products, 786 kFLOP a
// row (1.03e11 at the trainer's 32 x 4096 points: 0.104 ms at the tensor
// cores' 989 TFLOP/s); its bytes are 16 a row (xyz in, one float out) plus
// ~0.4 MB of weights, ~1 us at 3.35 TB/s. So it is bound by operations, and
// the design keeps every activation on chip: B1's trunk (sdf_trunk.cuh) runs
// the products on a 128-row tile in shared memory, the six weight matrices
// (the DeepSDF trunk's shapes) streamed through its cp.async ring, with this
// kernel's own epilogue in place of the DeepSDF one. What is new is the
// LayerNorm in that epilogue: a row's 256 columns lie with 4 warps and, in
// each, with the 4 lanes of a quad, so each row sum takes two quad shuffles
// and an exchange of the 4 warps' partial sums through a 128 x 4 float array
// in shared memory, twice a layer (the mean, then the variance). Layer 0
// has no product: the same epilogue runs on a zero accumulator, adding the
// depth-3 product pos @ w0p on CUDA cores (float32 sums of bf16 products, as
// layer 4's pos @ w4p).
//
// Rows are flat over B * N; row r belongs to item r / N, whose latent rows
// zz1/zz2 (bf16, [B, 256]) are read from device memory (they stay in L2), so
// a tile may span two items and any B and N work; the tail tile is masked.
#include "sdf_trunk.cuh"

namespace {

using sdf::Acc;
using sdf::BLOCK_M;
using sdf::THREADS;
using sdf::WIDTH;
using sdf::X_STRIDE;

constexpr int ROW_PARTS = WIDTH / sdf::WARP_COLS;  // warps sharing a row: 4
constexpr int LAYERS = 8;
constexpr int SKIP_LAYER = 4;  // lin4: + pos @ w4p + b4 + zz2
constexpr float LN_EPS = 1e-6f;
constexpr float INV_WIDTH = 1.f / WIDTH;

struct __align__(16) PointGenSmem {
  sdf::TrunkSmem trunk;   // trunk.bias: rows b0..b6, b7 broadcast; trunk.w8: the w7 head row
  sdf::PointsInput in;    // bf16-rounded xyz; in.w1p: w0p, in.w5p: w4p
  __nv_bfloat16 gamma[LAYERS * WIDTH];
  __nv_bfloat16 beta[LAYERS * WIDTH];
  float part[2][BLOCK_M][ROW_PARTS];  // the row sums' partials: mean, variance
};

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The sum over a row's 256 columns of the per-thread partials `v[mi][h]`
// (16 columns each): a quad's 4 lanes, then the 4 warps through s.part[k].
// Every thread of the block must call it.
__device__ __forceinline__ void row_sums(PointGenSmem& s, int k, float (&v)[4][2]) {
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      v[mi][h] += __shfl_xor_sync(0xffffffffu, v[mi][h], 1);
      v[mi][h] += __shfl_xor_sync(0xffffffffu, v[mi][h], 2);
      if ((threadIdx.x & 3) == 0) s.part[k][sdf::frag_row(mi, h)][(threadIdx.x >> 5) & 3] = v[mi][h];
    }
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* p = s.part[k][sdf::frag_row(mi, h)];
      v[mi][h] = (p[0] + p[1]) + (p[2] + p[3]);
    }
}

// Model layer `layer` (0-6) from its float32 product in acc (zero for layer
// 0): + pos @ wp (layers 0 and 4), + bias, + the row's item's zz row
// (layers 0 and 4), then LayerNorm, gamma/beta, relu, bf16 into s.x.
struct LayerNormEpilogue {
  PointGenSmem& s;
  const __nv_bfloat16* zz1;  // [B, 256]
  const __nv_bfloat16* zz2;
  long long p0;              // the tile's first flat row
  int n;                     // points per item
  int batch;

  __device__ __forceinline__ void apply(int layer, Acc& acc) const {
    const bool latent = layer == 0 || layer == SKIP_LAYER;
    const float(*wp)[WIDTH] = layer == 0 ? s.in.w1p : s.in.w5p;
    const __nv_bfloat16* zz = layer == 0 ? zz1 : zz2;
    const __nv_bfloat16* bias = s.trunk.bias + layer * WIDTH;
    float sum[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = sdf::frag_row(mi, h);
        const __nv_bfloat16* zrow = nullptr;
        if (latent) zrow = zz + min((p0 + row) / n, static_cast<long long>(batch - 1)) * WIDTH;
        sum[mi][h] = 0.f;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const int col = sdf::frag_col(ni);
          float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
          if (latent) {
            const float2 p = sdf::project_f32(s.in.pts[row], wp, col);
            v0 = __fadd_rn(v0, p.x);
            v1 = __fadd_rn(v1, p.y);
          }
          v0 = __fadd_rn(v0, __bfloat162float(bias[col]));
          v1 = __fadd_rn(v1, __bfloat162float(bias[col + 1]));
          if (latent) {
            const float2 z = load_pair(zrow + col);
            v0 = __fadd_rn(v0, z.x);
            v1 = __fadd_rn(v1, z.y);
          }
          const float2 v = make_float2(v0, v1);
          acc[mi][ni][2 * h] = v.x;
          acc[mi][ni][2 * h + 1] = v.y;
          sum[mi][h] += v.x + v.y;
        }
      }
    row_sums(s, 0, sum);
    float mean[4][2], sq[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mean[mi][h] = sum[mi][h] * INV_WIDTH;
        sq[mi][h] = 0.f;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float dev = __fsub_rn(acc[mi][ni][2 * h + e], mean[mi][h]);
            sq[mi][h] = __fadd_rn(sq[mi][h], __fmul_rn(dev, dev));
          }
      }
    row_sums(s, 1, sq);
    const __nv_bfloat16* gamma = s.gamma + layer * WIDTH;
    const __nv_bfloat16* beta = s.beta + layer * WIDTH;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float inv = rsqrtf(__fadd_rn(sq[mi][h] * INV_WIDTH, LN_EPS));
        const int row = sdf::frag_row(mi, h);
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const int col = sdf::frag_col(ni);
          float y[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float norm = __fmul_rn(__fsub_rn(acc[mi][ni][2 * h + e], mean[mi][h]), inv);
            y[e] = __fadd_rn(__fmul_rn(norm, __bfloat162float(gamma[col + e])),
                             __bfloat162float(beta[col + e]));
          }
          *reinterpret_cast<__nv_bfloat162*>(s.trunk.x + row * X_STRIDE + col) =
              __floats2bfloat162_rn(fmaxf(y[0], 0.f), fmaxf(y[1], 0.f));
        }
      }
  }

  // run_layers' hook: trunk layer l is model layer l + 1.
  __device__ __forceinline__ void operator()(int layer, Acc& acc) const { apply(layer + 1, acc); }
};

// h6 . w7 + b7 for tile row threadIdx.x / 2 (two threads per row, 128
// columns each): products of bf16 values, exact in float32, summed in
// float32. Returns the value in the even thread of each pair.
__device__ __forceinline__ float raw_head(const sdf::TrunkSmem& s) {
  const int row = threadIdx.x >> 1, half = threadIdx.x & 1;
  const __nv_bfloat16* xr = s.x + row * X_STRIDE + half * (WIDTH / 2);
  const __nv_bfloat16* wr = s.w8 + half * (WIDTH / 2);
  float sum = 0.f;
#pragma unroll 8
  for (int c = 0; c < WIDTH / 2; c += 2) {
    const float2 xv = load_pair(xr + c);
    const float2 wv = load_pair(wr + c);
    sum = fmaf(xv.x, wv.x, sum);
    sum = fmaf(xv.y, wv.y, sum);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  return sum + __bfloat162float(s.bias[(LAYERS - 1) * WIDTH]);
}

__global__ void __launch_bounds__(THREADS, 1)
point_gen_kernel(const float* __restrict__ pos, const __nv_bfloat16* __restrict__ zz1,
                 const __nv_bfloat16* __restrict__ zz2, const __nv_bfloat16* __restrict__ w0p,
                 const __nv_bfloat16* __restrict__ w4p, const __nv_bfloat16* __restrict__ w,
                 const __nv_bfloat16* __restrict__ bias, const __nv_bfloat16* __restrict__ gamma,
                 const __nv_bfloat16* __restrict__ beta, const __nv_bfloat16* __restrict__ w7,
                 float* __restrict__ out, int batch, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PointGenSmem& s = *reinterpret_cast<PointGenSmem*>(smem_raw);

  const long long p0 = static_cast<long long>(blockIdx.x) * BLOCK_M;
  const int rows = static_cast<int>(min(static_cast<long long>(BLOCK_M),
                                        static_cast<long long>(batch) * n - p0));

  sdf::start_weight_ring(s.trunk, w);
  for (int i = threadIdx.x; i < LAYERS * WIDTH; i += THREADS) {
    s.trunk.bias[i] = bias[i];
    s.gamma[i] = gamma[i];
    s.beta[i] = beta[i];
  }
  for (int i = threadIdx.x; i < WIDTH; i += THREADS) s.trunk.w8[i] = w7[i];
  for (int i = threadIdx.x; i < BLOCK_M * 3; i += THREADS)
    s.in.pts[i / 3][i % 3] = i / 3 < rows ? sdf::round_bf16(pos[p0 * 3 + i]) : 0.f;
  sdf::load_projections(s.in, w0p, w4p);
  __syncthreads();

  const LayerNormEpilogue epilogue{s, zz1, zz2, p0, n, batch};
  {
    Acc zero;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) zero[mi][ni][e] = 0.f;
    epilogue.apply(0, zero);
  }
  sdf::run_layers(s.trunk, w, epilogue);

  const float v = raw_head(s.trunk);
  const int row = threadIdx.x >> 1;
  if ((threadIdx.x & 1) == 0 && row < rows) out[p0 + row] = v;
}

}  // namespace

extern "C" int point_gen_forward(const void* pos, const void* zz1, const void* zz2, const void* w0p,
                                 const void* w4p, const void* w, const void* bias, const void* gamma,
                                 const void* beta, const void* w7, void* out, int batch, int n,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(point_gen_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(PointGenSmem)));
  if (err != cudaSuccess) return err;
  const unsigned blocks =
      static_cast<unsigned>((static_cast<long long>(batch) * n + BLOCK_M - 1) / BLOCK_M);
  using bf = __nv_bfloat16;
  point_gen_kernel<<<blocks, THREADS, sizeof(PointGenSmem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const bf*>(zz1), static_cast<const bf*>(zz2),
      static_cast<const bf*>(w0p), static_cast<const bf*>(w4p), static_cast<const bf*>(w),
      static_cast<const bf*>(bias), static_cast<const bf*>(gamma), static_cast<const bf*>(beta),
      static_cast<const bf*>(w7), static_cast<float*>(out), batch, n);
  return cudaGetLastError();
}
