// Recompute backward of the rowwise MLP (B6b): for raw points [N, 3], per-row
// latent terms zz1/zz5 [N, 256] bf16 and a cotangent g [N] float32,
//   dzz1, dzz5 [N, 256]   per row (the cotangents of zz1 / zz5)
//   d_w [6, 256(in), 256(out)], d_b [8, 256], d_w8 [256], d_b8 [1]
// all float32, in the JAX package's [in, out] layout. d_b rows 3, 6 and 7
// are zero (b5 gets its gradient through zz5).
//
// Replaces the Pallas TPU kernel `_rowwise_bwd_kernel` in
// shapegan_tpu/ops/sdf_mlp_pallas.py (launched by `_rowwise_bwd`, the custom
// VJP of apply_rowwise_trainable). The chain back to w1p, w5p and the points
// is closed outside, in PyTorch, from dzz1 / dzz5.
//
// What bounds it on the H100: 17 bf16 products of 256 x 256 a row (6 to
// rebuild the forward, 5 to carry dh back to h1, 6 for the weight
// gradients), 2.2 MFLOP a row: 45 us at the tensor cores' 989 TFLOP/s for
// the 20,000-row training batch. The bytes it must move are ~2.1 KB a row
// (the zz inputs and the float32 dzz outputs), 13 us at 3.35 TB/s. As in the
// grid backward (sdf_grid_bwd.cu), a tile's seven activation sets do not
// fit in the 227 KB of shared memory a block may use, and blocks run in no
// order, so the TPU kernel's in-VMEM weight accumulators become passes over
// device-memory scratch (sdf_bwd_passes.cuh): a rows pass per 128-row tile
// (this file), then the weight pass, column sums and a fixed-order finish,
// with no atomics. The rows pass writes dzz1 and dzz5 straight to the
// outputs; there are no sums over shapes. Its scratch (h1..h7 and the six
// bf16 dz, ~6.7 KB a row) costs device-memory traffic the TPU kernel did not
// spend; keeping dz tiles on chip for the weight products is the next step
// for speed.
//
// Rounding points follow `_rowwise_bwd_kernel`, which are neither the
// forward's nor the grid backward's: layer 1 adds zz1 to the float32
// projection pts @ w1p (not rounded to bf16 first); layer 5 sums its
// product, pts @ w5p and zz5 in float32; every rebuilt layer rounds once to
// bf16 after its sums. Each dz is rounded to bf16 before it feeds d_w, d_b
// and the next dh; dzz5 is that bf16 dz5 as float32; dh and dzz1 stay
// float32. Rows past the end of the batch contribute nothing.
#include <utility>

#include "sdf_bwd_passes.cuh"

namespace {

struct __align__(16) RowwiseRowsSmem {
  RowsSmem r;  // trunk tile and ring, gz
  sdf::PointsInput in;
};

struct Scratch {
  __nv_bfloat16* h;     // [7][N][256]
  __nv_bfloat16* dz;    // [6][N][256]
  float* gz;            // [N]
  float* w_part;        // [6][slabs][256][256]
  float* col_part;      // [6 x slabs x 256]
};

__global__ void __launch_bounds__(THREADS, 1)
rowwise_rows_kernel(const float* __restrict__ pts, const __nv_bfloat16* __restrict__ w1p,
                    const __nv_bfloat16* __restrict__ w5p, const __nv_bfloat16* __restrict__ zz1,
                    const __nv_bfloat16* __restrict__ zz5, const __nv_bfloat16* __restrict__ w,
                    const __nv_bfloat16* __restrict__ wt, const __nv_bfloat16* __restrict__ bias,
                    const __nv_bfloat16* __restrict__ w8, const float* __restrict__ g,
                    float* __restrict__ dzz1, float* __restrict__ dzz5, Scratch sc, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  RowwiseRowsSmem& rr = *reinterpret_cast<RowwiseRowsSmem*>(smem_raw);
  sdf::TrunkSmem& s = rr.r.t;
  sdf::PointsInput& in = rr.in;

  const size_t p0 = static_cast<size_t>(blockIdx.x) * BLOCK_M;
  const int rows = min(BLOCK_M, static_cast<int>(n - p0));
  const size_t plane = static_cast<size_t>(n) * WIDTH;  // one [N, 256] array

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    load_bwd_chunk(s, w, wt, c);
    sdf::cp_async_commit();
  }
  for (int i = threadIdx.x; i < 8 * WIDTH; i += THREADS) s.bias[i] = bias[i];
  for (int i = threadIdx.x; i < WIDTH; i += THREADS) s.w8[i] = w8[i];
  for (int i = threadIdx.x; i < BLOCK_M * 3; i += THREADS)
    in.pts[i / 3][i % 3] = i / 3 < rows ? sdf::round_bf16(pts[p0 * 3 + i]) : 0.f;
  sdf::load_projections(in, w1p, w5p);
  __syncthreads();

  // Layer 1: relu(pts @ w1p + zz1) in float32, rounded once (= h1, scratch plane 0).
  for (int i = threadIdx.x; i < BLOCK_M * WIDTH / 2; i += THREADS) {
    const int r = i / (WIDTH / 2), c = (i % (WIDTH / 2)) * 2;
    const float2 a = sdf::project_f32(in.pts[r], in.w1p, c);
    float2 z = make_float2(0.f, 0.f);
    if (r < rows)
      z = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(zz1 + (p0 + r) * WIDTH + c));
    const __nv_bfloat162 hv =
        __floats2bfloat162_rn(fmaxf(__fadd_rn(a.x, z.x), 0.f), fmaxf(__fadd_rn(a.y, z.y), 0.f));
    *reinterpret_cast<__nv_bfloat162*>(s.x + r * X_STRIDE + c) = hv;
    if (r < rows) *reinterpret_cast<__nv_bfloat162*>(sc.h + (p0 + r) * WIDTH + c) = hv;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int row0 = (warp >> 2) * sdf::WARP_ROWS;
  const int col0 = (warp & 3) * sdf::WARP_COLS;

  float acc[4][8][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int c = 0; c < BWD_CHUNKS; ++c) {
    sdf::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (c + STAGES - 1 < BWD_CHUNKS) load_bwd_chunk(s, w, wt, c + STAGES - 1);
    sdf::cp_async_commit();
    bwd_mma_chunk(s, acc, c);

    if (c % CHUNKS_PER_LAYER != CHUNKS_PER_LAYER - 1) continue;
    const bool forward = c < LAYERS * CHUNKS_PER_LAYER;
    const int layer = forward ? c / CHUNKS_PER_LAYER
                              : LAYERS - 1 - (c - LAYERS * CHUNKS_PER_LAYER) / CHUNKS_PER_LAYER;
    __syncthreads();  // every warp has read this layer's input rows
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = row0 + mi * 16 + gq + hh * 8;
          const int col = col0 + ni * 8 + tq * 2;
          const bool valid = row < rows;
          float v0 = acc[mi][ni][2 * hh], v1 = acc[mi][ni][2 * hh + 1];
          acc[mi][ni][2 * hh] = 0.f;
          acc[mi][ni][2 * hh + 1] = 0.f;
          const size_t off = (p0 + row) * WIDTH + col;
          if (forward) {
            // h_{layer+2} = relu(acc + bias) (layer 5: acc + pts @ w5p + zz5), float32 sums.
            if (layer == SKIP_LAYER) {
              const float2 p = sdf::project_f32(in.pts[row], in.w5p, col);
              float2 z = make_float2(0.f, 0.f);
              if (valid) z = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(zz5 + off));
              v0 = __fadd_rn(__fadd_rn(v0, p.x), z.x);
              v1 = __fadd_rn(__fadd_rn(v1, p.y), z.y);
            } else {
              v0 = __fadd_rn(v0, __bfloat162float(s.bias[layer * WIDTH + col]));
              v1 = __fadd_rn(v1, __bfloat162float(s.bias[layer * WIDTH + col + 1]));
            }
            const __nv_bfloat162 hv = __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
            *reinterpret_cast<__nv_bfloat162*>(s.x + row * X_STRIDE + col) = hv;
            if (valid) *reinterpret_cast<__nv_bfloat162*>(sc.h + (layer + 1) * plane + off) = hv;
          } else {
            // acc = dh at this layer's input h_layer (plane `layer`): mask by it.
            float2 hv = make_float2(0.f, 0.f);
            if (valid) hv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                           sc.h + layer * plane + off));
            v0 = hv.x > 0.f ? v0 : 0.f;
            v1 = hv.y > 0.f ? v1 : 0.f;
            if (layer > 0) {
              const __nv_bfloat162 dz = __floats2bfloat162_rn(v0, v1);
              *reinterpret_cast<__nv_bfloat162*>(s.x + row * X_STRIDE + col) = dz;
              if (valid) {
                *reinterpret_cast<__nv_bfloat162*>(sc.dz + (layer - 1) * plane + off) = dz;
                if (layer - 1 == SKIP_LAYER)  // dz5 is the cotangent of zz5
                  *reinterpret_cast<float2*>(dzz5 + off) = __bfloat1622float2(dz);
              }
            } else if (valid) {
              *reinterpret_cast<float2*>(dzz1 + off) = make_float2(v0, v1);
            }
          }
        }

    if (forward && layer == LAYERS - 1) {
      // Head and the start of the backward: gz = g (1 - out^2), then
      // dz7 = bf16(gz w8 * (h7 > 0)) in place of h7.
      __syncthreads();  // h7 is complete
      const float out = sdf::head(s);
      const int hrow = threadIdx.x >> 1;
      if ((threadIdx.x & 1) == 0) {
        float gz = 0.f;
        if (hrow < rows) {
          gz = __fmul_rn(g[p0 + hrow], __fsub_rn(1.f, __fmul_rn(out, out)));
          sc.gz[p0 + hrow] = gz;
        }
        rr.r.gz[hrow] = gz;
      }
      __syncthreads();
      for (int i = threadIdx.x; i < BLOCK_M * WIDTH / 2; i += THREADS) {
        const int r = i / (WIDTH / 2), col = (i % (WIDTH / 2)) * 2;
        __nv_bfloat162* xp = reinterpret_cast<__nv_bfloat162*>(s.x + r * X_STRIDE + col);
        const float2 h7 = __bfloat1622float2(*xp);
        const float gz = rr.r.gz[r];
        const float d0 = h7.x > 0.f ? __fmul_rn(gz, __bfloat162float(s.w8[col])) : 0.f;
        const float d1 = h7.y > 0.f ? __fmul_rn(gz, __bfloat162float(s.w8[col + 1])) : 0.f;
        const __nv_bfloat162 dz = __floats2bfloat162_rn(d0, d1);
        *xp = dz;
        if (r < rows)
          *reinterpret_cast<__nv_bfloat162*>(sc.dz + (LAYERS - 1) * plane + (p0 + r) * WIDTH + col) = dz;
      }
    }
  }
  sdf::cp_async_wait<0>();
}

struct Layout {
  long long slabs;
  size_t h, dz, gz, w_part, col_part, total;
};

Layout layout(int n) {
  Layout l;
  const long long rows = n;
  l.slabs = ceil_div(rows, SLAB);
  auto up = [](size_t b) { return (b + 255) / 256 * 256; };
  l.h = 0;
  l.dz = l.h + up(HIDDEN * rows * WIDTH * 2);
  l.gz = l.dz + up(LAYERS * rows * WIDTH * 2);
  l.w_part = l.gz + up(rows * 4);
  l.col_part = l.w_part + up(LAYERS * l.slabs * WIDTH * WIDTH * 4);
  l.total = l.col_part + up(LAYERS * l.slabs * WIDTH * 4);
  return l;
}

}  // namespace

extern "C" long long sdf_rowwise_backward_scratch_bytes(int n) {
  return static_cast<long long>(layout(n).total);
}

extern "C" int sdf_rowwise_backward(const void* pts, const void* w1p, const void* w5p, const void* zz1,
                                    const void* zz5, const void* w, const void* wt, const void* bias,
                                    const void* w8, const void* g, void* dzz1, void* dzz5, void* d_w,
                                    void* d_b, void* d_w8, void* d_b8, void* scratch, int n, int device,
                                    void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(rowwise_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(RowwiseRowsSmem)));
  if (err != cudaSuccess) return err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  using bf = __nv_bfloat16;
  float* f_w = static_cast<float*>(d_w);
  float* f_b = static_cast<float*>(d_b);
  float* f_w8 = static_cast<float*>(d_w8);
  float* f_b8 = static_cast<float*>(d_b8);
  // The finish pass adds into the summed outputs, and d_b rows 3, 6, 7 stay zero.
  const std::pair<void*, size_t> summed[] = {
      {f_w, static_cast<size_t>(LAYERS) * WIDTH * WIDTH * 4}, {f_b, 8 * WIDTH * 4},
      {f_w8, WIDTH * 4}, {f_b8, 4}};
  for (const auto& out : summed) {
    err = cudaMemsetAsync(out.first, 0, out.second, stream);
    if (err != cudaSuccess) return err;
  }

  const Layout l = layout(n);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  Scratch sc{reinterpret_cast<bf*>(base + l.h), reinterpret_cast<bf*>(base + l.dz),
             reinterpret_cast<float*>(base + l.gz), reinterpret_cast<float*>(base + l.w_part),
             reinterpret_cast<float*>(base + l.col_part)};
  const size_t plane = static_cast<size_t>(n) * WIDTH;

  const unsigned blocks = static_cast<unsigned>(ceil_div(n, BLOCK_M));
  rowwise_rows_kernel<<<blocks, THREADS, sizeof(RowwiseRowsSmem), stream>>>(
      static_cast<const float*>(pts), static_cast<const bf*>(w1p), static_cast<const bf*>(w5p),
      static_cast<const bf*>(zz1), static_cast<const bf*>(zz5), static_cast<const bf*>(w),
      static_cast<const bf*>(wt), static_cast<const bf*>(bias), static_cast<const bf*>(w8),
      static_cast<const float*>(g), static_cast<float*>(dzz1), static_cast<float*>(dzz5), sc, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int slabs = static_cast<int>(l.slabs);
  bwd_weight_kernel<<<dim3(4, slabs, LAYERS), THREADS, 0, stream>>>(sc.h, sc.dz, sc.w_part, n, slabs);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_finish_kernel<<<grid_for(LAYERS * WIDTH * WIDTH), THREADS, 0, stream>>>(
      sc.w_part, LAYERS, slabs, WIDTH * WIDTH, f_w);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // d_b rows 0-2 and 4-5 (row 3, the skip layer, stays 0: b5's gradient is sum dzz5).
  bwd_colsum_kernel<bf><<<dim3(slabs, LAYERS), THREADS, 0, stream>>>(sc.dz, nullptr, n, WIDTH, slabs,
                                                                    sc.col_part);
  bwd_finish_kernel<<<grid_for(3 * WIDTH), THREADS, 0, stream>>>(sc.col_part, 3, slabs, WIDTH, f_b);
  bwd_finish_kernel<<<grid_for(2 * WIDTH), THREADS, 0, stream>>>(
      sc.col_part + static_cast<size_t>(4) * slabs * WIDTH, 2, slabs, WIDTH, f_b + 4 * WIDTH);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // d_w8 = sum h7 gz, d_b8 = sum gz.
  bwd_colsum_kernel<bf><<<dim3(slabs, 1), THREADS, 0, stream>>>(sc.h + LAYERS * plane, sc.gz, n, WIDTH,
                                                               slabs, sc.col_part);
  bwd_finish_kernel<<<grid_for(WIDTH), THREADS, 0, stream>>>(sc.col_part, 1, slabs, WIDTH, f_w8);
  bwd_colsum_kernel<float><<<dim3(slabs, 1), THREADS, 0, stream>>>(sc.gz, nullptr, n, 1, slabs,
                                                                  sc.col_part);
  bwd_finish_kernel<<<1, THREADS, 0, stream>>>(sc.col_part, 1, slabs, 1, f_b8);
  return cudaGetLastError();
}
