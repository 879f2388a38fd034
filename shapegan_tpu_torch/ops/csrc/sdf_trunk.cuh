// The mma.sync pieces of the stash backward's rows kernel (sdf_grid_bwd.cu,
// B5b; its weight slices and chunk product are in sdf_bwd_passes.cuh): the
// block's shared memory (a 128-row activation tile, a STAGES-deep cp.async
// weight ring, the small operands), bf16 mma.sync.m16n8k16 with float32
// accumulation on ldmatrix fragments, and the head. Every other kernel runs
// the wgmma trunk of sdf_trunk_sm90.cuh.
//
// The bf16 trunk weights (6 x 128 KB) do not fit in the 227 KB of shared
// memory a block may use, so they stream: the 6 layers are cut into 24
// K-slices of 64 input features (256 x 64 bf16, 32 KB each), kept in flight
// by cp.async while mma.sync consumes the current one. On the H100 at 700 W
// this reaches ~20 % of the bf16 tensor-core peak (PERF.md).
//
// Layout contract with the Python wrappers (ops/sdf_mlp_kernels.py):
//   w    [6, 256(out), 256(in)] bf16: w2, w3, w4, w5h, w6, w7, transposed
//   b    [8, 256] bf16: rows b2, b3, b4, <unused>, b6, b7, b8 broadcast, <unused>
//   w8   [256] bf16: the head weight as a row
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sdf {

constexpr int WIDTH = 256;                 // trunk breadth
constexpr int BLOCK_M = 128;               // rows of one block's tile
constexpr int THREADS = 256;               // 8 warps: 2 along rows x 4 along columns
constexpr int WARP_ROWS = 64;              // rows of one warp's accumulator tile
constexpr int WARP_COLS = 64;              // columns of one warp's accumulator tile
constexpr int X_STRIDE = WIDTH + 8;        // padded activation row: conflict-free fragment loads
constexpr int K_CHUNK = 64;                // input features per streamed weight slice
constexpr int W_STRIDE = K_CHUNK + 8;      // padded weight-slice row
constexpr int STAGES = 3;                  // depth of the weight ring
constexpr int LAYERS = 6;                  // w2, w3, w4, w5h, w6, w7
constexpr int SKIP_LAYER = 3;              // w5h: adds pp5 + zz5 instead of a bias
constexpr int CHUNKS_PER_LAYER = WIDTH / K_CHUNK;
constexpr int HEAD_BIAS_ROW = 6;

struct __align__(16) TrunkSmem {
  __nv_bfloat16 x[BLOCK_M * X_STRIDE];            // activation tile
  __nv_bfloat16 w[STAGES][WIDTH * W_STRIDE];      // weight ring
  __nv_bfloat16 bias[8 * WIDTH];
  __nv_bfloat16 w8[WIDTH];
  __nv_bfloat16 zz5[WIDTH];
};

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D = A(16x16, row-major) * B(16x8, column-major) + D, bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8 and receives element pair (l / 4, 2 * (l % 4)) of
// each matrix: the mma.sync fragment layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// tanh(h7 . w8 + b8) for tile row threadIdx.x / 2 (two threads per row,
// 128 columns each). Returns the value in the even thread of each pair.
__device__ __forceinline__ float head(const TrunkSmem& s) {
  const int row = threadIdx.x >> 1, half = threadIdx.x & 1;
  const __nv_bfloat16* xr = s.x + row * X_STRIDE + half * (WIDTH / 2);
  const __nv_bfloat16* wr = s.w8 + half * (WIDTH / 2);
  float sum = 0.f;
#pragma unroll 8
  for (int c = 0; c < WIDTH / 2; c += 2) {
    const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + c));
    const float2 wv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(wr + c));
    sum = fmaf(xv.x, wv.x, sum);
    sum = fmaf(xv.y, wv.y, sum);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  return tanhf(sum + __bfloat162float(s.bias[HEAD_BIAS_ROW * WIDTH]));
}

}  // namespace sdf
