// Pieces shared by the backward kernels, sdf_grid_bwd.cu (the grid MLP: the
// recompute backward B2 and the stash backward B5b) and sdf_rowwise_bwd.cu
// (B6b, points with per-row latents). Both sources split the backward into
// passes over device-memory scratch: a rows pass, then the Hopper passes of
// sdf_bwd_passes_sm90.cuh. B2's and B6b's rows pass is the Hopper kernel of
// sdf_grid_bwd_sm90.cuh; B5b's rows kernel (sdf_grid_bwd.cu) runs a 128-row
// tile on sdf_trunk.cuh's mma.sync pieces, the forward rebuilt and then the
// six products dh = dz @ W^T on the same weight ring, fed the [in, out]
// stack (here: RowsSmem, load_weight_slice, bwd_mma_chunk). The passes' partials
// are summed in one fixed order (bwd_finish_kernel): no atomics, so a
// result is the same from run to run. Everything here sits in an unnamed
// namespace: each backward source has its own copy.
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

constexpr int HIDDEN = LAYERS + 1;  // h1..h7

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

int grid_for(long long n) { return static_cast<int>(std::min(ceil_div(n, THREADS), 132LL * 16)); }

}  // namespace
