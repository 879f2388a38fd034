// Shared trunk of the hand-written mma.sync SDF-MLP kernels for Hopper (sm_90a).
//
// The rowwise forward (sdf_rowwise.cu: points with per-row latent terms,
// B6a) runs the six 256x256 trunk layers and the head on a tile of BLOCK_M
// rows that stays in shared memory from the first layer to the output;
// only the [rows] float32 result goes back to device memory. The point-GAN
// generator (point_gen.cu, B7) runs the same products through run_layers
// with an epilogue of its own (LayerNorm), and the stash backward's rows
// kernel (sdf_grid_bwd.cu, B5b) its ring, fragments and head. The grid
// forward and its stash instance (B1, B5a), the points forward (B3), the
// sphere trace (B4) and the rows pass of the recompute backwards (B2, B6b)
// run the wgmma trunk of sdf_trunk_sm90.cuh instead.
//
// What bounds it on the H100: the six bf16 trunk products (6 x 2 x 256 x 256
// flops per row) are tensor-core work; device-memory traffic per row is a
// few hundred bytes at most, so the kernel is compute-bound. What stands in
// the way is that the bf16 trunk weights (6 x 128 KB) do not fit in the
// 227 KB of shared memory a block may use. The design streams them instead:
// the 6 layers are cut into 24 K-slices of 64 input features (256 x 64 bf16,
// 32 KB each), and a STAGES-deep cp.async ring keeps the next slices in
// flight while mma.sync consumes the current one. The ring runs straight
// through layer boundaries, since weights do not depend on activations, so
// the next layer's first slices arrive while the current layer's epilogue
// runs. The activation tile (128 x 256 bf16) is updated in place after each
// layer. Products are bf16 mma.sync.m16n8k16 with float32 accumulation, on
// fragments loaded with ldmatrix. On the H100 at 700 W this reaches ~20 % of
// the bf16 tensor-core peak (PERF.md). With one 256-thread block per SM the
// tensor cores sit idle during each layer's epilogue; sdf_trunk_sm90.cuh
// overlaps the two with wgmma in a persistent, warp-specialized loop.
//
// Rounding points follow the Pallas kernels (shapegan_tpu/ops/
// sdf_mlp_pallas.py, _points_trunk), not the XLA path: each
// layer's product is accumulated in float32 and rounded to bf16 BEFORE the
// bf16 bias is added (sum rounded to bf16), then relu. Layer 5 adds the
// skip term pp5 and then zz5, rounding to bf16 after each add. The head is
// a float32 row-dot of the bf16 layer-7 activations with the bf16 w8 row,
// plus b8, then tanh.
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
constexpr int CHUNKS = LAYERS * CHUNKS_PER_LAYER;
constexpr int HEAD_BIAS_ROW = 6;

struct __align__(16) TrunkSmem {
  __nv_bfloat16 x[BLOCK_M * X_STRIDE];            // activation tile
  __nv_bfloat16 w[STAGES][WIDTH * W_STRIDE];      // weight ring
  __nv_bfloat16 bias[8 * WIDTH];
  __nv_bfloat16 w8[WIDTH];
  __nv_bfloat16 zz5[WIDTH];
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

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

// Start the cp.async copies of weight slice `chunk` (layer
// chunk / CHUNKS_PER_LAYER, input features [K_CHUNK * (chunk %
// CHUNKS_PER_LAYER), +K_CHUNK)) into its ring stage: 256 rows of K_CHUNK
// bf16, in 16-byte pieces spread evenly over the threads.
__device__ __forceinline__ void load_weight_chunk(TrunkSmem& s, const __nv_bfloat16* __restrict__ w,
                                                  int chunk) {
  const int layer = chunk / CHUNKS_PER_LAYER;
  const int k0 = (chunk % CHUNKS_PER_LAYER) * K_CHUNK;
  const __nv_bfloat16* src = w + static_cast<size_t>(layer) * WIDTH * WIDTH + k0;
  __nv_bfloat16* dst = s.w[chunk % STAGES];
#pragma unroll
  for (int i = 0; i < (WIDTH * K_CHUNK / 8) / THREADS; ++i) {
    const int piece = threadIdx.x + i * THREADS;
    const int n = piece / (K_CHUNK / 8), q = piece % (K_CHUNK / 8);
    cp_async16(dst + n * W_STRIDE + q * 8, src + n * WIDTH + q * 8);
  }
}

// Start the copies of the first weight slices into the ring. run_trunk
// consumes the ring once; a kernel that runs the trunk again restarts it
// after run_trunk has returned.
__device__ __forceinline__ void start_weight_ring(TrunkSmem& s, const __nv_bfloat16* __restrict__ w) {
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    load_weight_chunk(s, w, c);
    cp_async_commit();
  }
}

// A thread's accumulator tile: acc[mi][ni][2 * h + e] is the float32
// product at tile row frag_row(mi, h), column frag_col(ni) + e (mma.sync's
// fragment layout over the warp's 64 x 64 block). A row's 256 columns lie
// with the 4 warps of one row half (warp & 3) and, inside each, with the 4
// lanes of a quad (lane & 3), 16 columns a lane.
typedef float Acc[4][8][4];

__device__ __forceinline__ int frag_row(int mi, int h) {
  return ((threadIdx.x >> 5) >> 2) * WARP_ROWS + mi * 16 + ((threadIdx.x & 31) >> 2) + h * 8;
}

__device__ __forceinline__ int frag_col(int ni) {
  return ((threadIdx.x >> 5) & 3) * WARP_COLS + ni * 8 + (threadIdx.x & 3) * 2;
}

// The six trunk layers' products over s.x (holding the first layer's
// activations on entry, the last layer's on exit). At the end of each
// layer, after a barrier (every warp has read the layer's input rows),
// `epilogue(layer, acc)` turns the float32 products into the next
// activations in s.x; acc is zeroed after.
template <class Epilogue>
__device__ __forceinline__ void run_layers(TrunkSmem& s, const __nv_bfloat16* __restrict__ w,
                                           const Epilogue& epilogue) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = (warp >> 2) * WARP_ROWS;
  const int col0 = (warp & 3) * WARP_COLS;

  Acc acc;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int c = 0; c < CHUNKS; ++c) {
    cp_async_wait<STAGES - 2>();  // slice c has landed (this thread's copies)
    __syncthreads();              // ... everyone's; and slice c - 1's stage is free
    if (c + STAGES - 1 < CHUNKS) load_weight_chunk(s, w, c + STAGES - 1);
    cp_async_commit();            // always commit: keeps the group count in step

    const __nv_bfloat16* ws = s.w[c % STAGES];
    const int kx = (c % CHUNKS_PER_LAYER) * K_CHUNK;
#pragma unroll
    for (int kk = 0; kk < K_CHUNK; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(a[mi], s.x + (row0 + mi * 16 + (lane & 15)) * X_STRIDE + kx + kk +
                               (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        // n-tiles 2 nj and 2 nj + 1, k halves 0 and 8: b[0..1] and b[2..3].
        uint32_t b[4];
        ldmatrix_x4(b, ws + (col0 + nj * 16 + (lane >> 4) * 8 + (lane & 7)) * W_STRIDE + kk +
                           ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma_16816(acc[mi][2 * nj], a[mi], b);
          mma_16816(acc[mi][2 * nj + 1], a[mi], b + 2);
        }
      }
    }

    if (c % CHUNKS_PER_LAYER == CHUNKS_PER_LAYER - 1) {
      __syncthreads();  // every warp has read this layer's input rows
      epilogue(c / CHUNKS_PER_LAYER, acc);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the last layer's activations are complete
}

// The DeepSDF trunk's epilogue (B6a): the product rounded to bf16,
// plus the bf16 bias (layer 5: the skip term, then zz5), each sum rounded
// to bf16, relu. `skip(row, col)` returns the bf16 pp5 pair of tile row
// `row`, columns col and col + 1, as floats; `zz5(row, col)` the bf16 zz5
// pair added after it.
template <class Skip, class Zz5>
struct TrunkEpilogue {
  TrunkSmem& s;
  const Skip& skip;
  const Zz5& zz5;

  __device__ __forceinline__ void operator()(int layer, Acc& acc) const {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = frag_row(mi, h);
          const int col = frag_col(ni);
          float v0 = round_bf16(acc[mi][ni][2 * h]);
          float v1 = round_bf16(acc[mi][ni][2 * h + 1]);
          if (layer == SKIP_LAYER) {
            const float2 p = skip(row, col);
            const float2 z = zz5(row, col);
            v0 = round_bf16(round_bf16(v0 + p.x) + z.x);
            v1 = round_bf16(round_bf16(v1 + p.y) + z.y);
          } else {
            v0 = round_bf16(v0 + __bfloat162float(s.bias[layer * WIDTH + col]));
            v1 = round_bf16(v1 + __bfloat162float(s.bias[layer * WIDTH + col + 1]));
          }
          *reinterpret_cast<__nv_bfloat162*>(s.x + row * X_STRIDE + col) =
              __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
        }
  }
};

// The six trunk layers over s.x (holding the layer-1 activations on entry,
// the layer-7 activations on exit), with the DeepSDF epilogue.
template <class Skip, class Zz5>
__device__ __forceinline__ void run_trunk(TrunkSmem& s, const __nv_bfloat16* __restrict__ w,
                                          const Skip& skip, const Zz5& zz5) {
  run_layers(s, w, TrunkEpilogue<Skip, Zz5>{s, skip, zz5});
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

// The raw-point input of the kernels that project in the kernel (rowwise
// B6a and the generator B7):
// the tile's bf16-rounded xyz and both fan-in projection weights as floats.
// Each projection is a float32 sum of bf16 x bf16 products, rounded to bf16
// (the TPU kernel's K=8 matmul with a float32 result).
struct __align__(16) PointsInput {
  float pts[BLOCK_M][3];
  float w1p[3][WIDTH];
  float w5p[3][WIDTH];
};

// Columns col and col + 1 of p @ wp in float32 (the generator adds them
// unrounded) ...
__device__ __forceinline__ float2 project_f32(const float* p, const float (*wp)[WIDTH], int col) {
  float a0 = p[0] * wp[0][col];
  float a1 = p[0] * wp[0][col + 1];
  a0 = fmaf(p[1], wp[1][col], a0);
  a1 = fmaf(p[1], wp[1][col + 1], a1);
  a0 = fmaf(p[2], wp[2][col], a0);
  a1 = fmaf(p[2], wp[2][col + 1], a1);
  return make_float2(a0, a1);
}

// ... and rounded to bf16 (the forward kernels).
__device__ __forceinline__ float2 project(const float* p, const float (*wp)[WIDTH], int col) {
  const float2 a = project_f32(p, wp, col);
  return make_float2(round_bf16(a.x), round_bf16(a.y));
}

// run_trunk's skip term: the bf16 pair of pts @ w5p.
struct PointsSkip {
  const PointsInput* in;
  __device__ __forceinline__ float2 operator()(int row, int col) const {
    return project(in->pts[row], in->w5p, col);
  }
};

__device__ __forceinline__ void load_projections(PointsInput& in, const __nv_bfloat16* __restrict__ w1p,
                                                 const __nv_bfloat16* __restrict__ w5p) {
  for (int i = threadIdx.x; i < 3 * WIDTH; i += THREADS) {
    in.w1p[i / WIDTH][i % WIDTH] = __bfloat162float(w1p[i]);
    in.w5p[i / WIDTH][i % WIDTH] = __bfloat162float(w5p[i]);
  }
}

}  // namespace sdf
