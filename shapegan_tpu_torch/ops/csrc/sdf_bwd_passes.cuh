// Pieces shared by the backward kernels, sdf_grid_bwd.cu (the grid MLP: the
// recompute backward B2 and the stash backward B5b) and sdf_rowwise_bwd.cu
// (B6b, points with per-row latents). Both sources split the backward into
// passes over device-memory scratch: the Hopper rows pass of
// sdf_grid_bwd_sm90.cuh, then the Hopper passes of sdf_bwd_passes_sm90.cuh.
// Here: the h planes as one pointer each, and the fixed-order finish of the
// passes' partials (bwd_finish_kernel): no atomics, so a result is the same
// from run to run. Everything here sits in an unnamed namespace: each
// backward source has its own copy.
#pragma once

#include <algorithm>
#include <utility>

#include "sdf_trunk_sm90.cuh"

namespace {

using sdf90::LAYERS;
using sdf90::SKIP_LAYER;
using sdf90::WIDTH;

constexpr int HIDDEN = LAYERS + 1;  // h1..h7
constexpr int FINISH_THREADS = 256;  // a bwd_finish_kernel block

__host__ __device__ inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

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

// Blocks of FINISH_THREADS for n outputs, at most 16 an SM.
int grid_for(long long n) { return static_cast<int>(std::min(ceil_div(n, FINISH_THREADS), 132LL * 16)); }

}  // namespace
