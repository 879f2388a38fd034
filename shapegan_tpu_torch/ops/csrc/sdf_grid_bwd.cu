// Recompute backward of the grid MLP (B2): for B shape latents over one
// shared point grid and a cotangent g [B, P] float32, the gradients of the
// trunk and the fan-in cotangents
//   d_pp1, d_pp5 [P, 256]   summed over shapes
//   d_zz1, d_zz5 [B, 256]   summed over points
//   d_w [6, 256(in), 256(out)], d_b [8, 256], d_w8 [256], d_b8 [1]
// all float32, in the JAX package's [in, out] layout.
//
// Replaces the Pallas TPU kernel `_bwd_kernel` in
// shapegan_tpu/ops/sdf_mlp_pallas.py (launched by `_trainable_bwd`, the
// custom VJP of apply_grid_trainable). The chain back to w1p/w1z/w5p/w5z,
// the points and the latents is closed outside, in PyTorch.
//
// What bounds it on the H100: 18 bf16 products of 256 x 256 per row (6 to
// rebuild the forward, 6 to carry dh back, 6 for the weight gradients), i.e.
// 2.4 MFLOP per row and ~9.9 TFLOP at 16 x 64^3: tensor-core work. The
// TPU kernel keeps one float32 dW block in VMEM across a grid that runs in
// order; here blocks run in no order, and a tile's seven activation sets
// (7 x 128 x 264 bf16, ~473 KB) do not fit in the 227 KB of shared memory a
// block may use. So the backward is split into passes over device-memory
// scratch, sized by the wrapper for a chunk of at most ROW_CAP rows (whole
// shapes; 16 x 64^3 runs as 16 chunks of one shape):
//   1. rows pass (one block per 128-row tile of one shape): the forward
//      rebuilt on the sdf_trunk.cuh main loop (same cp.async weight ring and
//      mma.sync fragments, with B2's own epilogue), then the six backward
//      products dh = dz @ W^T on the same ring, fed the [in, out] weight
//      stack. It writes h1..h7 and every bf16 dz to scratch, dx1 (layer 1,
//      float32) and gz = g (1 - out^2).
//   2. weight pass: d_w[l] = h_l^T dz_l as K = rows products, per 4096-row
//      slab into float32 partials (ldmatrix.trans feeds the row-major
//      scratch to mma.sync as column operands).
//   3. column sums (d_b, d_w8, d_b8, d_zz1, d_zz5) per slab into partials,
//      and sums over shapes for d_pp1 / d_pp5.
//   4. a fixed-order sum of the partials into the outputs.
// No atomics: every sum runs in one order, so the result is the same from
// run to run. Passes 2-4 and the rows pass's main loop are shared with the
// rowwise backward (sdf_bwd_passes.cuh). The scratch traffic (~7.7 KB
// written per row) costs device memory bandwidth the TPU kernel did not
// spend; keeping dz tiles on chip for the weight products is the next step
// for speed.
//
// Rounding points follow `_bwd_kernel`, not B1: the rebuilt layers add the
// bias (and at layer 5 pp5 then zz5) to the float32 product and round once
// to bf16; each dz is rounded to bf16 before it feeds d_w, d_b, d_pp5,
// d_zz5 and the next dh; dh and dx1 stay float32.
#include <algorithm>
#include <utility>

#include "sdf_bwd_passes.cuh"

namespace {

constexpr int ROW_CAP = 262144;       // rows of one chunk (one 64^3 shape)

struct Scratch {
  __nv_bfloat16* h;     // [7][R][256]
  __nv_bfloat16* dz;    // [6][R][256]
  float* dx1;           // [R][256]
  float* gz;            // [R]
  float* w_part;        // [6][slabs][256][256]
  float* col_part;      // [max(6 x slabs, shapes x slabs per shape) x 256]
};

// ------------------------------------------------------------ 1. rows pass

__global__ void __launch_bounds__(THREADS, 1)
bwd_rows_kernel(const __nv_bfloat16* __restrict__ pp1, const __nv_bfloat16* __restrict__ pp5,
                const __nv_bfloat16* __restrict__ zz1, const __nv_bfloat16* __restrict__ zz5,
                const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ wt,
                const __nv_bfloat16* __restrict__ bias, const __nv_bfloat16* __restrict__ w8,
                const float* __restrict__ g, Scratch sc, int shapes, int points, long long rows_total) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  RowsSmem& rs = *reinterpret_cast<RowsSmem*>(smem_raw);
  sdf::TrunkSmem& s = rs.t;

  const int shape = blockIdx.x % shapes;
  const int p0 = (blockIdx.x / shapes) * BLOCK_M;
  const int rows = min(BLOCK_M, points - p0);
  const size_t base = static_cast<size_t>(shape) * points + p0;  // first scratch row
  const size_t plane = static_cast<size_t>(rows_total) * WIDTH;   // one [R, 256] array

  // Ring start and small operands (sdf::start_trunk loads from w only).
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    load_bwd_chunk(s, w, wt, c);
    sdf::cp_async_commit();
  }
  for (int i = threadIdx.x; i < 8 * WIDTH; i += THREADS) s.bias[i] = bias[i];
  for (int i = threadIdx.x; i < WIDTH; i += THREADS) {
    s.w8[i] = w8[i];
    s.zz5[i] = zz5[static_cast<size_t>(shape) * WIDTH + i];
  }

  // Layer 1: relu(pp1 + zz1) in float32, rounded once (= h1, scratch plane 0).
  const __nv_bfloat16* zrow = zz1 + static_cast<size_t>(shape) * WIDTH;
  for (int i = threadIdx.x; i < BLOCK_M * WIDTH / 8; i += THREADS) {
    const int r = i / (WIDTH / 8), c = (i % (WIDTH / 8)) * 8;
    uint4 pv = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) pv = *reinterpret_cast<const uint4*>(pp1 + static_cast<size_t>(p0 + r) * WIDTH + c);
    const uint4 zv = *reinterpret_cast<const uint4*>(zrow + c);
    const __nv_bfloat162* pp = reinterpret_cast<const __nv_bfloat162*>(&pv);
    const __nv_bfloat162* zp = reinterpret_cast<const __nv_bfloat162*>(&zv);
    uint4 xv;
    __nv_bfloat162* xp = reinterpret_cast<__nv_bfloat162*>(&xv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 a = __bfloat1622float2(pp[j]);
      const float2 z = __bfloat1622float2(zp[j]);
      xp[j] = __floats2bfloat162_rn(fmaxf(__fadd_rn(a.x, z.x), 0.f), fmaxf(__fadd_rn(a.y, z.y), 0.f));
    }
    *reinterpret_cast<uint4*>(s.x + r * X_STRIDE + c) = xv;
    if (r < rows) *reinterpret_cast<uint4*>(sc.h + (base + r) * WIDTH + c) = xv;
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
          const size_t off = (base + row) * WIDTH + col;
          if (forward) {
            // h_{layer+2} = relu(acc + bias) (layer 5: acc + pp5 + zz5), float32 sums.
            if (layer == SKIP_LAYER) {
              float2 p = make_float2(0.f, 0.f);
              if (valid)
                p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                    pp5 + static_cast<size_t>(p0 + row) * WIDTH + col));
              v0 = __fadd_rn(__fadd_rn(v0, p.x), __bfloat162float(s.zz5[col]));
              v1 = __fadd_rn(__fadd_rn(v1, p.y), __bfloat162float(s.zz5[col + 1]));
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
              if (valid) *reinterpret_cast<__nv_bfloat162*>(sc.dz + (layer - 1) * plane + off) = dz;
            } else if (valid) {
              *reinterpret_cast<float2*>(sc.dx1 + off) = make_float2(v0, v1);
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
          const float gv = g[static_cast<size_t>(shape) * points + p0 + hrow];
          gz = __fmul_rn(gv, __fsub_rn(1.f, __fmul_rn(out, out)));
          sc.gz[base + hrow] = gz;
        }
        rs.gz[hrow] = gz;
      }
      __syncthreads();
      for (int i = threadIdx.x; i < BLOCK_M * WIDTH / 2; i += THREADS) {
        const int r = i / (WIDTH / 2), col = (i % (WIDTH / 2)) * 2;
        __nv_bfloat162* xp = reinterpret_cast<__nv_bfloat162*>(s.x + r * X_STRIDE + col);
        const float2 h7 = __bfloat1622float2(*xp);
        const float gz = rs.gz[r];
        const float d0 = h7.x > 0.f ? __fmul_rn(gz, __bfloat162float(s.w8[col])) : 0.f;
        const float d1 = h7.y > 0.f ? __fmul_rn(gz, __bfloat162float(s.w8[col + 1])) : 0.f;
        const __nv_bfloat162 dz = __floats2bfloat162_rn(d0, d1);
        *xp = dz;
        if (r < rows)
          *reinterpret_cast<__nv_bfloat162*>(sc.dz + (LAYERS - 1) * plane + (base + r) * WIDTH + col) = dz;
      }
    }
  }
  sdf::cp_async_wait<0>();
}

struct Layout {
  long long rows, slabs, seg_slabs;
  size_t h, dz, dx1, gz, w_part, col_part, total;
};

Layout layout(int points, int shapes_per_chunk) {
  Layout l;
  l.rows = static_cast<long long>(points) * shapes_per_chunk;
  l.slabs = ceil_div(l.rows, SLAB);
  l.seg_slabs = ceil_div(points, SLAB);
  const long long col_groups = std::max(static_cast<long long>(LAYERS) * l.slabs,
                                        static_cast<long long>(shapes_per_chunk) * l.seg_slabs);
  auto up = [](size_t b) { return (b + 255) / 256 * 256; };
  l.h = 0;
  l.dz = l.h + up(HIDDEN * l.rows * WIDTH * 2);
  l.dx1 = l.dz + up(LAYERS * l.rows * WIDTH * 2);
  l.gz = l.dx1 + up(l.rows * WIDTH * 4);
  l.w_part = l.gz + up(l.rows * 4);
  l.col_part = l.w_part + up(LAYERS * l.slabs * WIDTH * WIDTH * 4);
  l.total = l.col_part + up(col_groups * WIDTH * 4);
  return l;
}

}  // namespace

extern "C" int sdf_grid_backward_chunk_shapes(int points, int batch) {
  return std::max(1, std::min(batch, ROW_CAP / std::max(points, 1)));
}

extern "C" long long sdf_grid_backward_scratch_bytes(int points, int shapes_per_chunk) {
  return static_cast<long long>(layout(points, shapes_per_chunk).total);
}

extern "C" int sdf_grid_backward(const void* pp1, const void* pp5, const void* zz1, const void* zz5,
                                 const void* w, const void* wt, const void* bias, const void* w8,
                                 const void* g, void* d_pp1, void* d_pp5, void* d_zz1, void* d_zz5,
                                 void* d_w, void* d_b, void* d_w8, void* d_b8, void* scratch,
                                 int batch, int points, int shapes_per_chunk, int device,
                                 void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch <= 0 || points <= 0 || shapes_per_chunk <= 0) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(RowsSmem)));
  if (err != cudaSuccess) return err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  using bf = __nv_bfloat16;
  float* f_pp1 = static_cast<float*>(d_pp1);
  float* f_pp5 = static_cast<float*>(d_pp5);
  float* f_zz1 = static_cast<float*>(d_zz1);
  float* f_zz5 = static_cast<float*>(d_zz5);
  float* f_w = static_cast<float*>(d_w);
  float* f_b = static_cast<float*>(d_b);
  float* f_w8 = static_cast<float*>(d_w8);
  float* f_b8 = static_cast<float*>(d_b8);
  const size_t pw = static_cast<size_t>(points) * WIDTH;
  const std::pair<void*, size_t> outputs[] = {
      {f_pp1, pw * 4}, {f_pp5, pw * 4}, {f_zz1, static_cast<size_t>(batch) * WIDTH * 4},
      {f_zz5, static_cast<size_t>(batch) * WIDTH * 4},
      {f_w, static_cast<size_t>(LAYERS) * WIDTH * WIDTH * 4}, {f_b, 8 * WIDTH * 4},
      {f_w8, WIDTH * 4}, {f_b8, 4}};
  for (const auto& out : outputs) {  // the outputs accumulate over chunks
    err = cudaMemsetAsync(out.first, 0, out.second, stream);
    if (err != cudaSuccess) return err;
  }

  const Layout full = layout(points, shapes_per_chunk);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  for (int s0 = 0; s0 < batch; s0 += shapes_per_chunk) {
    const int shapes = std::min(shapes_per_chunk, batch - s0);
    const Layout l = layout(points, shapes);  // this chunk's row count and slabs
    Scratch sc{reinterpret_cast<bf*>(base + full.h), reinterpret_cast<bf*>(base + full.dz),
               reinterpret_cast<float*>(base + full.dx1), reinterpret_cast<float*>(base + full.gz),
               reinterpret_cast<float*>(base + full.w_part),
               reinterpret_cast<float*>(base + full.col_part)};
    const size_t plane = static_cast<size_t>(l.rows) * WIDTH;

    const long long blocks = ceil_div(points, BLOCK_M) * shapes;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    bwd_rows_kernel<<<static_cast<unsigned>(blocks), THREADS, sizeof(RowsSmem), stream>>>(
        static_cast<const bf*>(pp1), static_cast<const bf*>(pp5),
        static_cast<const bf*>(zz1) + static_cast<size_t>(s0) * WIDTH,
        static_cast<const bf*>(zz5) + static_cast<size_t>(s0) * WIDTH, static_cast<const bf*>(w),
        static_cast<const bf*>(wt), static_cast<const bf*>(bias), static_cast<const bf*>(w8),
        static_cast<const float*>(g) + static_cast<size_t>(s0) * points, sc, shapes, points, l.rows);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;

    const int slabs = static_cast<int>(l.slabs), seg_slabs = static_cast<int>(l.seg_slabs);
    bwd_weight_kernel<<<dim3(4, slabs, LAYERS), THREADS, 0, stream>>>(sc.h, sc.dz, sc.w_part, l.rows,
                                                                      slabs);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    bwd_finish_kernel<<<grid_for(LAYERS * WIDTH * WIDTH), THREADS, 0, stream>>>(
        sc.w_part, LAYERS, slabs, WIDTH * WIDTH, f_w);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;

    // d_b rows 0-2 and 4-5 (row 3, the skip layer, stays 0: b5's gradient is sum d_zz5).
    bwd_colsum_kernel<bf><<<dim3(slabs, LAYERS), THREADS, 0, stream>>>(sc.dz, nullptr, l.rows, WIDTH,
                                                                      slabs, sc.col_part);
    bwd_finish_kernel<<<grid_for(3 * WIDTH), THREADS, 0, stream>>>(sc.col_part, 3, slabs, WIDTH, f_b);
    bwd_finish_kernel<<<grid_for(2 * WIDTH), THREADS, 0, stream>>>(
        sc.col_part + static_cast<size_t>(4) * slabs * WIDTH, 2, slabs, WIDTH, f_b + 4 * WIDTH);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    // d_w8 = sum h7 gz, d_b8 = sum gz.
    bwd_colsum_kernel<bf><<<dim3(slabs, 1), THREADS, 0, stream>>>(sc.h + LAYERS * plane, sc.gz, l.rows,
                                                                 WIDTH, slabs, sc.col_part);
    bwd_finish_kernel<<<grid_for(WIDTH), THREADS, 0, stream>>>(sc.col_part, 1, slabs, WIDTH, f_w8);
    bwd_colsum_kernel<float><<<dim3(slabs, 1), THREADS, 0, stream>>>(sc.gz, nullptr, l.rows, 1, slabs,
                                                                    sc.col_part);
    bwd_finish_kernel<<<1, THREADS, 0, stream>>>(sc.col_part, 1, slabs, 1, f_b8);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    // d_zz5 / d_zz1: per-shape sums over points; d_pp5 / d_pp1: sums over shapes.
    bwd_colsum_kernel<bf><<<dim3(seg_slabs, shapes), THREADS, 0, stream>>>(
        sc.dz + SKIP_LAYER * plane, nullptr, points, WIDTH, seg_slabs, sc.col_part);
    bwd_finish_kernel<<<grid_for(shapes * WIDTH), THREADS, 0, stream>>>(
        sc.col_part, shapes, seg_slabs, WIDTH, f_zz5 + static_cast<size_t>(s0) * WIDTH);
    bwd_colsum_kernel<float><<<dim3(seg_slabs, shapes), THREADS, 0, stream>>>(
        sc.dx1, nullptr, points, WIDTH, seg_slabs, sc.col_part);
    bwd_finish_kernel<<<grid_for(shapes * WIDTH), THREADS, 0, stream>>>(
        sc.col_part, shapes, seg_slabs, WIDTH, f_zz1 + static_cast<size_t>(s0) * WIDTH);
    bwd_shape_sum_kernel<bf><<<grid_for(pw), THREADS, 0, stream>>>(sc.dz + SKIP_LAYER * plane, shapes,
                                                                   pw, f_pp5);
    bwd_shape_sum_kernel<float><<<grid_for(pw), THREADS, 0, stream>>>(sc.dx1, shapes, pw, f_pp1);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}
