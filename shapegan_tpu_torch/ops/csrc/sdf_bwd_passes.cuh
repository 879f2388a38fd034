// Pieces shared by the backward kernels, sdf_grid_bwd.cu (the grid MLP: the
// recompute backward B2 and the stash backward B5b) and sdf_rowwise_bwd.cu
// (B6b, points with per-row latents). Both sources split the backward into
// passes over device-memory scratch:
//   1. a rows pass per 128-row tile (each source has its own): the forward
//      rebuilt on the sdf_trunk.cuh main loop, then the six products
//      dh = dz @ W^T on the same weight ring, fed the [in, out] stack; it
//      writes h1..h7 and every bf16 dz to scratch (here: RowsSmem,
//      load_bwd_chunk, bwd_mma_chunk);
//   2. the weight pass: d_w[l] = h_l^T dz_l per SLAB-row slab into float32
//      partials (bwd_weight_kernel);
//   3. column sums per slab into partials (bwd_colsum_kernel);
//   4. a fixed-order sum of the partials (bwd_finish_kernel).
// No atomics: every sum runs in one order, so a result is the same from run
// to run. Everything here sits in an unnamed namespace: each backward
// source has its own copy.
#pragma once

#include <algorithm>
#include <utility>

#include "sdf_trunk.cuh"

namespace {

using sdf::BLOCK_M;
using sdf::CHUNKS_PER_LAYER;
using sdf::K_CHUNK;
using sdf::LAYERS;
using sdf::SKIP_LAYER;
using sdf::STAGES;
using sdf::THREADS;
using sdf::W_STRIDE;
using sdf::WIDTH;
using sdf::X_STRIDE;

constexpr int SLAB = 4096;            // rows of one partial sum
constexpr int BWD_CHUNKS = 2 * LAYERS * CHUNKS_PER_LAYER;
constexpr int HIDDEN = LAYERS + 1;    // h1..h7
constexpr int WB_TILE = 128;          // weight pass: output tile edge
constexpr int WB_K = 32;              // weight pass: rows per step
constexpr int WB_STRIDE = WB_TILE + 8;

struct __align__(16) RowsSmem {
  sdf::TrunkSmem t;
  float gz[BLOCK_M];
};

__host__ __device__ inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

__device__ __forceinline__ void cp_async16_zfill(void* smem_dst, const void* gmem_src, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src),
               "r"(bytes));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The seven h planes of a chunk's rows (h1..h7, each [R][256] bf16). The
// rowwise backward keeps them one after another in scratch; the grid
// backward reads its stashed planes (B5b) from the forward's stash instead.
struct HPlanes {
  __nv_bfloat16* p[HIDDEN];
};

inline HPlanes contiguous_planes(__nv_bfloat16* h, size_t plane) {
  HPlanes planes;
  for (int j = 0; j < HIDDEN; ++j) planes.p[j] = h + j * plane;
  return planes;
}

// Start the cp.async copies of K-slice `k_slice` of one 256 x 256 layer
// (`layer`: its first element) into ring stage `stage`.
__device__ __forceinline__ void load_weight_slice(sdf::TrunkSmem& s, const __nv_bfloat16* __restrict__ layer,
                                                  int k_slice, int stage) {
  const __nv_bfloat16* src = layer + k_slice * K_CHUNK;
  __nv_bfloat16* dst = s.w[stage];
#pragma unroll
  for (int i = 0; i < (WIDTH * K_CHUNK / 8) / THREADS; ++i) {
    const int piece = threadIdx.x + i * THREADS;
    const int n = piece / (K_CHUNK / 8), q = piece % (K_CHUNK / 8);
    sdf::cp_async16(dst + n * W_STRIDE + q * 8, src + n * WIDTH + q * 8);
  }
}

// Weight slice `chunk` of the 48 the rows pass streams: chunks 0-23 are the
// forward layers w2..w7 ([out, in]), chunks 24-47 the backward layers w7..w2
// ([in, out], the transposed stack).
__device__ __forceinline__ void load_bwd_chunk(sdf::TrunkSmem& s, const __nv_bfloat16* __restrict__ w,
                                               const __nv_bfloat16* __restrict__ wt, int chunk) {
  const int half = LAYERS * CHUNKS_PER_LAYER;
  const int layer = chunk < half ? chunk / CHUNKS_PER_LAYER
                                 : LAYERS - 1 - (chunk - half) / CHUNKS_PER_LAYER;
  load_weight_slice(s, (chunk < half ? w : wt) + static_cast<size_t>(layer) * WIDTH * WIDTH,
                    chunk % CHUNKS_PER_LAYER, chunk % STAGES);
}

// The mma.sync products of weight slice `c` (ring stage c % STAGES) with the
// activation tile: acc[mi][ni] += s.x[rows of this warp, K slice of c] x
// slice. The warp's 64 x 64 accumulator tile is that of run_trunk.
__device__ __forceinline__ void bwd_mma_chunk(const sdf::TrunkSmem& s, float (&acc)[4][8][4], int c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = (warp >> 2) * sdf::WARP_ROWS;
  const int col0 = (warp & 3) * sdf::WARP_COLS;
  const __nv_bfloat16* ws = s.w[c % STAGES];
  const int kx = (c % CHUNKS_PER_LAYER) * K_CHUNK;
#pragma unroll
  for (int kk = 0; kk < K_CHUNK; kk += 16) {
    uint32_t a[4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
      sdf::ldmatrix_x4(a[mi], s.x + (row0 + mi * 16 + (lane & 15)) * X_STRIDE + kx + kk +
                                  (lane >> 4) * 8);
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      uint32_t b[4];
      sdf::ldmatrix_x4(b, ws + (col0 + nj * 16 + (lane >> 4) * 8 + (lane & 7)) * W_STRIDE + kk +
                              ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        sdf::mma_16816(acc[mi][2 * nj], a[mi], b);
        sdf::mma_16816(acc[mi][2 * nj + 1], a[mi], b + 2);
      }
    }
  }
}

// Partial d_w[l][i][o] = sum over one slab of rows of h_l[r][i] dz_l[r][o]:
// block (output tile, slab, layer), 8 warps of 64 x 32 outputs each.
__global__ void __launch_bounds__(THREADS)
bwd_weight_kernel(HPlanes h, const __nv_bfloat16* __restrict__ dz,
                  float* __restrict__ part, long long rows_total, int slabs) {
  __shared__ __align__(16) __nv_bfloat16 as[2][WB_K * WB_STRIDE];
  __shared__ __align__(16) __nv_bfloat16 bs[2][WB_K * WB_STRIDE];
  const int m_base = (blockIdx.x >> 1) * WB_TILE, n_base = (blockIdx.x & 1) * WB_TILE;
  const int slab = blockIdx.y, layer = blockIdx.z;
  const size_t plane = static_cast<size_t>(rows_total) * WIDTH;
  const __nv_bfloat16* hl = h.p[layer];
  const __nv_bfloat16* dl = dz + layer * plane;
  const long long r_begin = static_cast<long long>(slab) * SLAB;
  const long long r_end = min(rows_total, r_begin + SLAB);
  const int steps = static_cast<int>(ceil_div(r_end - r_begin, WB_K));

  auto load = [&](int step, int buf) {
#pragma unroll
    for (int i = 0; i < (2 * WB_K * WB_TILE / 8) / THREADS; ++i) {
      const int piece = threadIdx.x + i * THREADS;
      const int which = piece / (WB_K * WB_TILE / 8);  // 0: h, 1: dz
      const int rem = piece % (WB_K * WB_TILE / 8);
      const int r = rem / (WB_TILE / 8), q = (rem % (WB_TILE / 8)) * 8;
      const long long grow = r_begin + static_cast<long long>(step) * WB_K + r;
      const bool valid = grow < r_end;
      const __nv_bfloat16* src = (which ? dl : hl) + (valid ? grow : 0) * WIDTH +
                                 (which ? n_base : m_base) + q;
      cp_async16_zfill((which ? bs[buf] : as[buf]) + r * WB_STRIDE + q, src, valid);
    }
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  load(0, 0);
  sdf::cp_async_commit();
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) load(step + 1, (step + 1) & 1);
    sdf::cp_async_commit();
    sdf::cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* a_s = as[step & 1];
    const __nv_bfloat16* b_s = bs[step & 1];
#pragma unroll
    for (int kk = 0; kk < WB_K; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4_trans(a[mi], a_s + (kk + (lane & 7) + ((lane >> 4) & 1) * 8) * WB_STRIDE +
                                     wm + mi * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, b_s + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * WB_STRIDE +
                                 wn + nj * 16 + ((lane >> 4) & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          sdf::mma_16816(acc[mi][2 * nj], a[mi], b);
          sdf::mma_16816(acc[mi][2 * nj + 1], a[mi], b + 2);
        }
      }
    }
    __syncthreads();  // this buffer is refilled two steps on
  }
  sdf::cp_async_wait<0>();

  float* out = part + (static_cast<size_t>(layer) * slabs + slab) * WIDTH * WIDTH;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = m_base + wm + mi * 16 + gq + hh * 8;
        const int n = n_base + wn + ni * 8 + tq * 2;
        *reinterpret_cast<float2*>(out + m * WIDTH + n) =
            make_float2(acc[mi][ni][2 * hh], acc[mi][ni][2 * hh + 1]);
      }
}

// ------------------------------------------------------------ 3. col sums

__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load_f(const float* p) { return *p; }

// part[(seg * slabs + slab) * cols + c] = sum over the slab's rows of
// src[seg][r][c] (* weight[seg][r] if given); segments are seg_rows long.
template <class T>
__global__ void bwd_colsum_kernel(const T* __restrict__ src, const float* __restrict__ weight,
                                  long long seg_rows, int cols, int slabs, float* __restrict__ part) {
  const int slab = blockIdx.x, seg = blockIdx.y;
  const long long r_begin = static_cast<long long>(slab) * SLAB;
  const long long r_end = min(seg_rows, r_begin + SLAB);
  const size_t seg_base = static_cast<size_t>(seg) * seg_rows;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    float sum = 0.f;
    for (long long r = r_begin; r < r_end; ++r) {
      const float v = load_f(src + (seg_base + r) * cols + c);
      sum += weight ? v * weight[seg_base + r] : v;
    }
    part[(static_cast<size_t>(seg) * slabs + slab) * cols + c] = sum;
  }
}

// dst[grp * n + i] += sum over s < slabs, in order, of part[(grp * slabs + s) * n + i].
__global__ void bwd_finish_kernel(const float* __restrict__ part, int groups, int slabs, long long n,
                                  float* __restrict__ dst) {
  const long long total = groups * n;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; idx < total;
       idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long grp = idx / n, i = idx % n;
    float sum = 0.f;
    for (int s = 0; s < slabs; ++s) sum += part[(grp * slabs + s) * n + i];
    dst[idx] += sum;
  }
}

// dst[i] += sum over shapes, in order, of src[s * n + i].
template <class T>
__global__ void bwd_shape_sum_kernel(const T* __restrict__ src, int shapes, long long n,
                                     float* __restrict__ dst) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float sum = dst[i];
    for (int s = 0; s < shapes; ++s) sum += load_f(src + s * n + i);
    dst[i] = sum;
  }
}

int grid_for(long long n) { return static_cast<int>(std::min(ceil_div(n, THREADS), 132LL * 16)); }

// The float32 outputs of a grid backward (B2, B5b), in the JAX package's
// layout; they accumulate over chunks.
struct GridGrads {
  float *pp1, *pp5, *zz1, *zz5, *w, *b, *w8, *b8;
};

// Passes 2-4 of one chunk of a grid backward (B2, B5b), after its rows pass:
// the chunk holds `shapes` whole shapes from shape s0 on, `points` rows each.
// The partials' scratch (w_part, col_part) is sized by the caller.
inline cudaError_t grid_bwd_passes(const HPlanes& h, const __nv_bfloat16* dz, const float* dx1,
                                   const float* gz, float* w_part, float* col_part, int shapes,
                                   int points, int s0, const GridGrads& out, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const long long rows = static_cast<long long>(shapes) * points;
  const int slabs = static_cast<int>(ceil_div(rows, SLAB));
  const int seg_slabs = static_cast<int>(ceil_div(points, SLAB));
  const size_t plane = static_cast<size_t>(rows) * WIDTH;
  const size_t pw = static_cast<size_t>(points) * WIDTH;
  cudaError_t err;

  bwd_weight_kernel<<<dim3(4, slabs, LAYERS), THREADS, 0, stream>>>(h, dz, w_part, rows, slabs);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_finish_kernel<<<grid_for(LAYERS * WIDTH * WIDTH), THREADS, 0, stream>>>(
      w_part, LAYERS, slabs, WIDTH * WIDTH, out.w);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // d_b rows 0-2 and 4-5 (row 3, the skip layer, stays 0: b5's gradient is sum d_zz5).
  bwd_colsum_kernel<bf><<<dim3(slabs, LAYERS), THREADS, 0, stream>>>(dz, nullptr, rows, WIDTH,
                                                                    slabs, col_part);
  bwd_finish_kernel<<<grid_for(3 * WIDTH), THREADS, 0, stream>>>(col_part, 3, slabs, WIDTH, out.b);
  bwd_finish_kernel<<<grid_for(2 * WIDTH), THREADS, 0, stream>>>(
      col_part + static_cast<size_t>(4) * slabs * WIDTH, 2, slabs, WIDTH, out.b + 4 * WIDTH);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // d_w8 = sum h7 gz, d_b8 = sum gz.
  bwd_colsum_kernel<bf><<<dim3(slabs, 1), THREADS, 0, stream>>>(h.p[LAYERS], gz, rows, WIDTH, slabs,
                                                               col_part);
  bwd_finish_kernel<<<grid_for(WIDTH), THREADS, 0, stream>>>(col_part, 1, slabs, WIDTH, out.w8);
  bwd_colsum_kernel<float><<<dim3(slabs, 1), THREADS, 0, stream>>>(gz, nullptr, rows, 1, slabs,
                                                                  col_part);
  bwd_finish_kernel<<<1, THREADS, 0, stream>>>(col_part, 1, slabs, 1, out.b8);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // d_zz5 / d_zz1: per-shape sums over points; d_pp5 / d_pp1: sums over shapes.
  bwd_colsum_kernel<bf><<<dim3(seg_slabs, shapes), THREADS, 0, stream>>>(
      dz + SKIP_LAYER * plane, nullptr, points, WIDTH, seg_slabs, col_part);
  bwd_finish_kernel<<<grid_for(shapes * WIDTH), THREADS, 0, stream>>>(
      col_part, shapes, seg_slabs, WIDTH, out.zz5 + static_cast<size_t>(s0) * WIDTH);
  bwd_colsum_kernel<float><<<dim3(seg_slabs, shapes), THREADS, 0, stream>>>(
      dx1, nullptr, points, WIDTH, seg_slabs, col_part);
  bwd_finish_kernel<<<grid_for(shapes * WIDTH), THREADS, 0, stream>>>(
      col_part, shapes, seg_slabs, WIDTH, out.zz1 + static_cast<size_t>(s0) * WIDTH);
  bwd_shape_sum_kernel<bf><<<grid_for(pw), THREADS, 0, stream>>>(dz + SKIP_LAYER * plane, shapes, pw,
                                                                 out.pp5);
  bwd_shape_sum_kernel<float><<<grid_for(pw), THREADS, 0, stream>>>(dx1, shapes, pw, out.pp1);
  return cudaGetLastError();
}

// Zero a grid backward's outputs before its chunks accumulate into them.
inline cudaError_t zero_grid_grads(const GridGrads& out, int batch, int points, cudaStream_t stream) {
  const size_t pw = static_cast<size_t>(points) * WIDTH;
  const std::pair<float*, size_t> outputs[] = {
      {out.pp1, pw * 4}, {out.pp5, pw * 4}, {out.zz1, static_cast<size_t>(batch) * WIDTH * 4},
      {out.zz5, static_cast<size_t>(batch) * WIDTH * 4},
      {out.w, static_cast<size_t>(LAYERS) * WIDTH * WIDTH * 4}, {out.b, 8 * WIDTH * 4},
      {out.w8, WIDTH * 4}, {out.b8, 4}};
  for (const auto& o : outputs) {
    const cudaError_t err = cudaMemsetAsync(o.first, 0, o.second, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
