// Forward of the point-GAN generator (SDFGenerator: 8 layers of 256,
// LayerNorm and relu after layers 0-6, the latent added at layers 0 and 4,
// the positions concatenated back in at layer 4, a raw head): positions
// [B, N, 3] float32 -> raw SDF values [B, N] float32 (the critic step's fake
// clouds).
//
// Replaces the Pallas TPU kernel `_kernel` in
// shapegan_tpu/ops/point_gen_pallas.py, launched by `generate_fused`, at its
// rounding points: each layer's product is a float32 sum of bf16 products;
// bias, position and latent terms are added to it in float32, unrounded
// (((product + pos @ wp) + bias) + zz); the LayerNorm is two-pass float32
// (mean, then the mean of squared deviations, eps 1e-6); gamma and beta are
// bf16; only the relu output is rounded to bf16. The head is a float32 row
// dot of h6 with the bf16 w7 row, plus b7, with no tanh.
//
// What bounds it on the H100: the six 256x256 bf16 products, 786 kFLOP a
// row (1.03e11 at the trainer's 32 x 4096 points: 0.104 ms at the tensor
// cores' 989 TFLOP/s); its bytes are 16 a row (xyz in, one float out) plus
// ~0.4 MB of weights, ~1 us at 3.35 TB/s. So it is bound by operations. The
// design is the persistent, warp-specialized wgmma trunk of
// sdf_trunk_sm90.cuh, as B3's: one block per SM, two consumer warpgroups in
// ping-pong on 64-row tiles of the flat B * N rows (tile t: rows 64 t on;
// 2 block + warpgroup, then every 2 x grid), one producer thread cycling the
// 24 K-slices of w (lin1, lin2, lin3, lin4's first 256 inputs, lin5, lin6:
// the trunk's K-major layout) through the 6-stage TMA ring, never
// restarting. The activations stay in registers as the wgmma A operand.
//
// Its own epilogue, not the trunk's (which rounds the product before the
// bias): in the m64n256 accumulator layout a row's 256 columns lie in the 4
// lanes of one quad, 64 a lane, so each LayerNorm row sum is a loop over the
// thread's own values and two xor shuffles (lanes 1 apart, then 2 apart):
// no shared memory and no barrier among the consumers. Layer 0 has no
// product: its float32 terms (pos @ w0p, b0, zz1) are summed into the
// zeroed accumulator and take the same epilogue. The latent rows zz1 / zz2
// ([B, 256] bf16) of row r's item r / N come from device memory (they stay
// in L2) into the free A registers before the layer's epilogue, so a tile
// may span two items and any B and N work; rows past the end compute on
// zero positions and store nothing (predicated loads and stores, no branch
// among the products). gamma, beta, the biases, w0p / w4p and w7 sit in
// shared memory as float32 beside the ring (226 KB in all). The producer
// knows the block's slices (produce_slices).
//
// On the H100 at 700 W the epilogue, not the products, bounds it: its
// CUDA-core work (the two reductions' passes and the affine map) takes longer
// than the other consumer's products and is not hidden; without the
// reductions the kernel takes ~60 % of its time (kernel_variants.py
// point_gen; PERF.md, section 6).
#include "sdf_trunk_sm90.cuh"
#include "sdf_rows_sm90.cuh"

namespace {

using sdf90::bf16;
using sdf90::CONSUMERS;
using sdf90::ROWS;
using sdf90::STAGES;
using sdf90::WIDTH;

constexpr int NORMS = 7;                 // LayerNorms, after model layers 0-6
constexpr int HEAD_BIAS_ROW = NORMS;     // b's last row: b7 broadcast
constexpr float LN_EPS = 1e-6f;
constexpr float INV_WIDTH = 1.f / WIDTH;

struct __align__(1024) Smem {
  bf16 ring[STAGES][WIDTH * sdf90::K_CHUNK];
  float bias[NORMS + 1][WIDTH];  // b0 .. b6, b7 broadcast
  float gamma[NORMS][WIDTH];
  float beta[NORMS][WIDTH];
  float w0p[3][WIDTH];           // lin0's position rows
  float w4p[3][WIDTH];           // lin4's
  float w7[WIDTH];               // the head row
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
  int done;
};
static_assert(sizeof(Smem) + 1024 <= 232448, "the block's shared memory");

// The launch's operands (a __grid_constant__ parameter).
struct Args {
  const float* pos;  // [B * N, 3]
  const bf16* zz1;   // [B, 256]
  const bf16* zz2;
  const bf16* w0p;   // [3, 256]
  const bf16* w4p;
  const bf16* bias;  // [8, 256]
  const bf16* gamma;
  const bf16* beta;
  const bf16* w7;    // [256]
  float* out;        // [B * N]
  long long rows;    // B * N
  long long tiles;   // ceil(rows / 64)
  int batch, n;
};

// A consumer thread's two rows of its tile: r0 = 16 warp + lane / 4 and
// r0 + 8.
struct TileRows {
  long long row[2];  // flat rows
  bool ok[2];        // the row exists
  float3 p[2];       // its bf16-rounded position (zero past the end)
  size_t item[2];    // its item (the last past the end)
};

__device__ __forceinline__ TileRows tile_rows(const Args& g, long long t) {
  const int u = threadIdx.x & 127;
  TileRows r;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    r.row[h] = t * ROWS + (u >> 5) * 16 + ((u & 31) >> 2) + 8 * h;
    r.ok[h] = r.row[h] < g.rows;
    const float* x = g.pos + r.row[h] * 3;
    r.p[h] = make_float3(sdf90::round_bf16(sdf90::load_f32(x, r.ok[h])),
                         sdf90::round_bf16(sdf90::load_f32(x + 1, r.ok[h])),
                         sdf90::round_bf16(sdf90::load_f32(x + 2, r.ok[h])));
    r.item[h] = static_cast<size_t>(min(r.row[h] / g.n, g.batch - 1LL));
  }
  return r;
}

// The latent rows of the thread's two rows' items into the A registers, in
// the accumulator's column order: a[j / 2][2 (j % 2) + h] = zz[item h] at
// columns 8 j + 2 (lane % 4), + 1 (all 64 loads in flight together).
__device__ __forceinline__ void load_latent(uint32_t (&a)[16][4], const bf16* zz, const TileRows& r) {
  const int q2 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) a[j / 2][2 * (j % 2) + h] = sdf90::shape_pair(zz + r.item[h] * WIDTH, 8 * j + q2);
}

// The sum over a row's quad (its 256 columns).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// The pair at columns col, col + 1 of a float row in shared memory. The
// block's shared memory is reached through a generic pointer (aligned_smem),
// which the compiler turns into generic loads; ld.shared took 3-8 % off
// the kernel on the H100 (kernel_variants.py point_gen; PERF.md).
__device__ __forceinline__ float2 smem_pair(const float* row, int col) {
  float2 v;
  asm("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "r"(sdf90::smem_addr(row + col)));
  return v;
}

enum Kind { kNorm, kLatent, kHead };

// Model layer `layer` (0-6) over its float32 product d (zero for layer 0):
// kLatent (layers 0 and 4) adds pos @ wp (float32 sums of bf16 products,
// unrounded) and then, after the bias, the item's latent pair that
// load_latent put in a; every kind adds the bias, then the LayerNorm,
// gamma / beta and relu, rounded to bf16. kNorm and kLatent pack the result
// into a, the next layer's A operand; kHead (layer 6) returns h6 . w7 + b7
// of both rows (each thread sums its 64 columns in ascending order, then
// the quad).
//
// Accumulator d[4 j + 2 h + e]: row r0 + 8 h, column 8 j + 2 (lane % 4) + e;
// A-fragment register a[j / 2][2 (j % 2) + h] holds the same row's pair at
// columns 8 j + 2 (lane % 4) + {0, 1}.
template <int KIND>
__device__ __forceinline__ float2 layer_norm(const Smem& s, int layer, float (&d)[128], uint32_t (&a)[16][4],
                                             const TileRows& r) {
  const int q2 = 2 * (threadIdx.x & 3);
  const float(*wp)[WIDTH] = layer == 0 ? s.w0p : s.w4p;
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int c = 8 * j + q2;
    const float2 b = smem_pair(s.bias[layer], c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
      if constexpr (KIND == kLatent) {
        const float2 pp =
            sdf90::project_f32(r.p[h], smem_pair(wp[0], c), smem_pair(wp[1], c), smem_pair(wp[2], c));
        v0 = __fadd_rn(v0, pp.x);
        v1 = __fadd_rn(v1, pp.y);
      }
      v0 = __fadd_rn(v0, b.x);
      v1 = __fadd_rn(v1, b.y);
      if constexpr (KIND == kLatent) {
        const float2 z = sdf90::unpack_bf16(a[j / 2][2 * (j % 2) + h]);
        v0 = __fadd_rn(v0, z.x);
        v1 = __fadd_rn(v1, z.y);
      }
      d[4 * j + 2 * h] = v0;
      d[4 * j + 2 * h + 1] = v1;
      sum[h] += v0 + v1;
    }
  }
  float mean[2], sq[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) mean[h] = quad_sum(sum[h]) * INV_WIDTH;
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dev = d[4 * j + 2 * h + e] - mean[h];
        sq[h] = fmaf(dev, dev, sq[h]);
      }
  float inv[2], head[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) inv[h] = rsqrtf(quad_sum(sq[h]) * INV_WIDTH + LN_EPS);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int c = 8 * j + q2;
    const float2 gm = smem_pair(s.gamma[layer], c), bt = smem_pair(s.beta[layer], c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float y0 = fmaf((d[4 * j + 2 * h] - mean[h]) * inv[h], gm.x, bt.x);
      const float y1 = fmaf((d[4 * j + 2 * h + 1] - mean[h]) * inv[h], gm.y, bt.y);
      const uint32_t x = sdf90::relu_bf16(sdf90::pack_bf16(y0, y1));
      if constexpr (KIND == kHead) {
        const float2 f = sdf90::unpack_bf16(x), w = smem_pair(s.w7, c);
        head[h] = fmaf(f.x, w.x, head[h]);
        head[h] = fmaf(f.y, w.y, head[h]);
      } else {
        a[j / 2][2 * (j % 2) + h] = x;
      }
    }
  }
  if constexpr (KIND == kHead) {
#pragma unroll
    for (int h = 0; h < 2; ++h) head[h] = quad_sum(head[h]) + s.bias[HEAD_BIAS_ROW][0];
  }
  return make_float2(head[0], head[1]);
}

template <int N>
__device__ __forceinline__ void tile(Smem& s, const Args& g, int wg, sdf90::Ring<N>& pos, long long t) {
  const TileRows r = tile_rows(g, t);
  uint32_t a[16][4];
  float d[128];
  // Model layer 0: pos @ w0p + b0 + zz1, no product.
  load_latent(a, g.zz1, r);
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;
  layer_norm<kLatent>(s, 0, d, a, r);
  // Layers 1-6 on the trunk's products (trunk layer 3 is lin4).
  sdf90::layer_products(s, wg, pos, a, d);
  layer_norm<kNorm>(s, 1, d, a, r);
  sdf90::layer_products(s, wg, pos, a, d);
  layer_norm<kNorm>(s, 2, d, a, r);
  sdf90::layer_products(s, wg, pos, a, d);
  layer_norm<kNorm>(s, 3, d, a, r);
  sdf90::layer_products(s, wg, pos, a, d);
  load_latent(a, g.zz2, r);
  layer_norm<kLatent>(s, 4, d, a, r);
  sdf90::layer_products(s, wg, pos, a, d);
  layer_norm<kNorm>(s, 5, d, a, r);
  sdf90::layer_products(s, wg, pos, a, d);
  const float2 v = layer_norm<kHead>(s, 6, d, a, r);
  const int q = threadIdx.x & 3;
  sdf90::store_f32(g.out + r.row[0], v.x, r.ok[0] && q == 0);
  sdf90::store_f32(g.out + r.row[1], v.y, r.ok[1] && q == 1);
}

__global__ void __launch_bounds__(sdf90::THREADS, 1)
point_gen_kernel(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ Args args) {
  extern __shared__ unsigned char smem_raw[];
  Smem& s = sdf90::aligned_smem<Smem>(smem_raw);
  sdf90::to_float(s.bias[0], args.bias, (NORMS + 1) * WIDTH);
  sdf90::to_float(s.gamma[0], args.gamma, NORMS * WIDTH);
  sdf90::to_float(s.beta[0], args.beta, NORMS * WIDTH);
  sdf90::to_float(s.w0p[0], args.w0p, 3 * WIDTH);
  sdf90::to_float(s.w4p[0], args.w4p, 3 * WIDTH);
  sdf90::to_float(s.w7, args.w7, WIDTH);
  if (threadIdx.x == 0) sdf90::ring_init<STAGES>(s, &wmap);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    sdf90::producer_start();
    if (threadIdx.x == sdf90::PRODUCER_THREAD)
      sdf90::produce_slices<STAGES>(s, &wmap, sdf90::block_rounds(args.tiles) * sdf90::CHUNKS);
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

extern "C" int point_gen_forward(const void* pos, const void* zz1, const void* zz2, const void* w0p,
                                 const void* w4p, const void* w, const void* bias, const void* gamma,
                                 const void* beta, const void* w7, void* out, int batch, int n,
                                 int device, void* stream) {
  static sdf90::LastOf<const void*, CUtensorMap> weight_maps;
  static sdf90::OncePerDevice smem_limit;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch <= 0 || n <= 0) return cudaErrorInvalidValue;
  CUtensorMap wmap;
  err = weight_maps.get(w, &wmap, [&](CUtensorMap* m) { return sdf90::weight_map(m, w); });
  if (err != cudaSuccess) return err;
  const int smem = static_cast<int>(sizeof(Smem)) + 1024;
  err = smem_limit(device, [&] {
    return cudaFuncSetAttribute(point_gen_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  });
  if (err != cudaSuccess) return err;
  int sms = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  Args args;
  args.pos = static_cast<const float*>(pos);
  args.zz1 = static_cast<const bf16*>(zz1);
  args.zz2 = static_cast<const bf16*>(zz2);
  args.w0p = static_cast<const bf16*>(w0p);
  args.w4p = static_cast<const bf16*>(w4p);
  args.bias = static_cast<const bf16*>(bias);
  args.gamma = static_cast<const bf16*>(gamma);
  args.beta = static_cast<const bf16*>(beta);
  args.w7 = static_cast<const bf16*>(w7);
  args.out = static_cast<float*>(out);
  args.rows = static_cast<long long>(batch) * n;
  args.tiles = (args.rows + ROWS - 1) / ROWS;
  args.batch = batch;
  args.n = n;
  const long long pairs = (args.tiles + CONSUMERS - 1) / CONSUMERS;
  const unsigned blocks = static_cast<unsigned>(pairs < sms ? pairs : sms);
  point_gen_kernel<<<blocks, sdf90::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(wmap, args);
  return cudaGetLastError();
}
