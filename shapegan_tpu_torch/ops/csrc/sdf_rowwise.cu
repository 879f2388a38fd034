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
// kernel (sdf_points.cu), at the same rounding points (the trunk header's):
// pp1 = bf16(xyz @ w1p), h1 = relu(bf16(pp1 + zz1[row])); each trunk product
// rounded to bf16 before its bias; layer 5 adds pp5 = bf16(xyz @ w5p),
// rounds, adds zz5[row], rounds; relu; the head tanh(h7 . w8 + b8).
//
// What bounds it on the H100: the six 256x256 bf16 trunk products, 786
// kFLOP a row (15.7 GFLOP at the 20,000-row training batch: 16 us at the
// tensor cores' 989 TFLOP/s); the bytes are ~1 KB a row (12 of points,
// 2 x 512 of zz1/zz5, 4 out), 20 MB at 20,000 rows, 6 us at 3.35 TB/s. The
// design is B3's: the persistent, warp-specialized wgmma trunk of
// sdf_trunk_sm90.cuh (one block per SM, two consumer warpgroups in
// ping-pong on 64-row tiles, the weight ring fed by TMA once for the whole
// launch), the activations in registers as the wgmma A operand. What
// differs is where the latent terms live: a tile's 64 rows of zz1 and zz5
// (64 KB) are read once, as bf16 pairs by row, into the free A registers
// (sdf_rows_sm90.cuh's load_tile: zz1 before layer 1, zz5 once layer 5's
// products are done), predicated past the end of the batch. At 20,000 rows
// the 313 tiles make two rounds of the 264 consumer warpgroups, so the time
// is two tile latencies and the launch, not throughput.
#include "sdf_trunk_sm90.cuh"
#include "sdf_rows_sm90.cuh"

namespace {

using sdf90::bf16;
using sdf90::CONSUMERS;
using sdf90::ROWS;
using sdf90::Rows;
using sdf90::SKIP_LAYER;
using sdf90::WIDTH;

// The launch's operands (a __grid_constant__ parameter).
struct Args {
  const float* pts;  // [N, 3]
  const bf16* zz1;   // [N, 256]
  const bf16* zz5;
  const bf16* w1p;   // [3, 256]
  const bf16* w5p;
  const bf16* bias;  // [8, 256]
  const bf16* w8;    // [256]
  float* out;        // [N]
  long long tiles;   // ceil(N / 64)
  int n;
};

// Row r0 + 8 hh's xyz, rounded to bf16 (zero past the end).
__device__ __forceinline__ float3 rounded_point(const float* pts, const Rows& r, int hh) {
  const float* x = pts + (r.row + 8 * hh) * 3;
  return make_float3(sdf90::round_bf16(sdf90::load_f32(x, r.ok(hh))),
                     sdf90::round_bf16(sdf90::load_f32(x + 1, r.ok(hh))),
                     sdf90::round_bf16(sdf90::load_f32(x + 2, r.ok(hh))));
}

template <int N>
__device__ __forceinline__ void tile(sdf90::Smem& s, const Args& g, int wg, sdf90::Ring<N>& pos, long long t) {
  const Rows r = sdf90::rows_of(t, 1, g.n, g.tiles);
  const float3 p0 = rounded_point(g.pts, r, 0), p1 = rounded_point(g.pts, r, 1);
  uint32_t a[16][4];
  float d[128];
  // Layer 1: relu(pp1 + zz1[row]), the sum rounded to bf16.
  sdf90::load_tile(a, g.zz1, r.row, r);
  const int q2 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      uint32_t& x = a[i / 2][2 * (i % 2) + hh];
      const float2 z = sdf90::unpack_bf16(x), pp = sdf90::project(hh ? p1 : p0, s.w1p, 8 * i + q2);
      x = sdf90::relu_bf16(sdf90::pack_bf16(pp.x + z.x, pp.y + z.y));
    }
#pragma unroll
  for (int layer = 0; layer < SKIP_LAYER; ++layer) {
    sdf90::layer_products(s, wg, pos, a, d);
    sdf90::epilogue<sdf90::kBias>(s, d, a, s.bias[layer], p0, p1);
  }
  // Layer 5: the product rounded, + pp5, rounded, + zz5[row] (loaded into
  // the free A registers), rounded, relu.
  sdf90::layer_products(s, wg, pos, a, d);
  sdf90::load_tile(a, g.zz5, r.row, r);
  const auto pp5 = [&](int, int h, int c) { return sdf90::project(h ? p1 : p0, s.w5p, c); };
  sdf90::trunk_epilogue<sdf90::kSkip>(d, a, sdf90::RegisterPair{a}, pp5, s.w8, &s.bias[sdf90::HEAD_BIAS_ROW][0]);
  sdf90::layer_products(s, wg, pos, a, d);
  sdf90::epilogue<sdf90::kBias>(s, d, a, s.bias[SKIP_LAYER + 1], p0, p1);
  sdf90::layer_products(s, wg, pos, a, d);
  const float2 v = sdf90::epilogue<sdf90::kHead>(s, d, a, s.bias[sdf90::LAYERS - 1], p0, p1);
  const int q = threadIdx.x & 3;
  sdf90::store_f32(g.out + r.row, v.x, r.ok(0) && q == 0);
  sdf90::store_f32(g.out + r.row + 8, v.y, r.ok(1) && q == 1);
}

__global__ void __launch_bounds__(sdf90::THREADS, 1)
sdf_rowwise_kernel(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ Args args) {
  extern __shared__ unsigned char smem_raw[];
  sdf90::Smem& s = sdf90::aligned_smem<sdf90::Smem>(smem_raw);
  // The trunk's shared operands; its zz1 / zz5 rows stay unused (per row here).
  sdf90::to_float(s.bias[0], args.bias, 8 * WIDTH);
  sdf90::to_float(s.w1p[0], args.w1p, 3 * WIDTH);
  sdf90::to_float(s.w5p[0], args.w5p, 3 * WIDTH);
  sdf90::to_float(s.w8, args.w8, WIDTH);
  if (threadIdx.x == 0) sdf90::ring_init<sdf90::STAGES>(s, &wmap);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    sdf90::producer_start();
    if (threadIdx.x == sdf90::PRODUCER_THREAD)
      sdf90::produce_slices(s, &wmap, sdf90::block_rounds(args.tiles) * sdf90::CHUNKS);
  } else {
    sdf90::consumer_start(wg);
    sdf90::RingPos pos;
    for (long long t = 2LL * blockIdx.x + wg;; t += 2LL * gridDim.x) {
      if (!sdf90::consumers_any(t < args.tiles)) break;
      tile(s, args, wg, pos, t);
    }
    sdf90::consumer_finish(s, wg);
  }
}

}  // namespace

extern "C" int sdf_rowwise_forward(const void* pts, const void* w1p, const void* w5p,
                                   const void* zz1, const void* zz5, const void* w,
                                   const void* bias, const void* w8, void* out, int n, int device,
                                   void* stream) {
  static sdf90::LastOf<const void*, CUtensorMap> weight_maps;
  static sdf90::OncePerDevice smem_limit;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaErrorInvalidValue;
  CUtensorMap wmap;
  err = weight_maps.get(w, &wmap, [&](CUtensorMap* m) { return sdf90::weight_map(m, w); });
  if (err != cudaSuccess) return err;
  const int smem = static_cast<int>(sizeof(sdf90::Smem)) + 1024;
  err = smem_limit(device, [&] {
    return cudaFuncSetAttribute(sdf_rowwise_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  });
  if (err != cudaSuccess) return err;
  int sms = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  Args args;
  args.pts = static_cast<const float*>(pts);
  args.zz1 = static_cast<const bf16*>(zz1);
  args.zz5 = static_cast<const bf16*>(zz5);
  args.w1p = static_cast<const bf16*>(w1p);
  args.w5p = static_cast<const bf16*>(w5p);
  args.bias = static_cast<const bf16*>(bias);
  args.w8 = static_cast<const bf16*>(w8);
  args.out = static_cast<float*>(out);
  args.tiles = (static_cast<long long>(n) + ROWS - 1) / ROWS;
  args.n = n;
  const long long pairs = (args.tiles + CONSUMERS - 1) / CONSUMERS;
  const unsigned blocks = static_cast<unsigned>(pairs < sms ? pairs : sms);
  sdf_rowwise_kernel<<<blocks, sdf90::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(wmap, args);
  return cudaGetLastError();
}
