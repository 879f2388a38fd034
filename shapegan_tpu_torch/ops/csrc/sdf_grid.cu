// Grid forward of the 8x256 SDF MLP: B shape latents over one shared point
// grid -> [B, P] float32 SDF values (B1), optionally also writing h-chain
// positions (0-indexed into h1..h7) to one [B, P, 256] bf16 plane each, row
// shape * P + p, for the stash backward (B5a; sdf_grid_bwd.cu reads them).
//
// Replaces the Pallas TPU kernels `_kernel` (launched by apply_grid_fused)
// and `_stash_fwd_kernel` (launched by `_stash_fwd_call`, the forward of
// apply_grid_trainable_stash) in shapegan_tpu/ops/sdf_mlp_pallas.py. Both
// run one kernel template here: B1 is its instance without the stash writes
// (kStash false: no plane tests, so B1 compiles to the plain trunk), and the
// writes are the only difference, so B5a's output equals B1's bit for bit.
// As in the TPU kernels, the fan-in projections are done outside the kernel:
// pp1/pp5 = pts @ w1p / w5p ([P, 256] bf16, shared by all shapes) and
// zz1/zz5 = z @ w1z / w5z + b ([B, 256] bf16, one row per shape). The
// per-point latent repeat is never materialized: a block's rows are one
// point tile of one shape, its layer-1 input is relu(pp1[tile] + zz1[shape]),
// and layer 5 re-injects pp5[tile] + zz5[shape].
//
// Where the TPU kernel folded the whole shape batch into one grid step's rows
// (blocks run in order on one core there), here every (point tile, shape)
// pair is an independent block: nothing carries between blocks, and the
// 128-row tile x 256 columns of activations stays in shared memory through
// all layers (sdf_trunk.cuh says what bounds the kernel and how the weights
// are streamed). Consecutive blocks share a point tile, so its pp1/pp5 rows
// are read from device memory once and then hit L2 for the other shapes.
// A stashed position adds B * P * 512 bytes written (2.15 GB a plane at
// 16 x 64^3, ~0.64 ms each at 3.35 TB/s): after that layer's epilogue the
// tile's new activations are copied from shared memory to the plane, 16
// bytes a thread a step, valid rows only.
#include "sdf_trunk.cuh"

namespace {

using sdf::BLOCK_M;
using sdf::THREADS;
using sdf::WIDTH;

constexpr int HIDDEN = sdf::LAYERS + 1;  // h1..h7

// One [B, P, 256] bf16 plane per h-chain position, nullptr where the
// position is not stashed.
struct Stash {
  __nv_bfloat16* plane[HIDDEN];
};

struct GridSkip {
  const __nv_bfloat16* pp5;  // this tile's first row
  int rows;                  // valid rows in the tile
  __device__ __forceinline__ float2 operator()(int row, int col) const {
    if (row >= rows) return make_float2(0.f, 0.f);
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(pp5 + static_cast<size_t>(row) * WIDTH + col));
  }
};

// The tile's first `rows` activation rows to `dst` (the plane's row of the
// tile's first point).
__device__ __forceinline__ void store_tile(const sdf::TrunkSmem& s, __nv_bfloat16* dst, int rows) {
  for (int i = threadIdx.x; i < rows * WIDTH / 8; i += THREADS) {
    const int r = i / (WIDTH / 8), c = (i % (WIDTH / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * WIDTH + c) =
        *reinterpret_cast<const uint4*>(s.x + r * sdf::X_STRIDE + c);
  }
}

// The DeepSDF epilogue; after a layer whose output position is stashed,
// a barrier (the tile's new activations are complete) and the copy out.
// The next layer only reads s.x, and its epilogue writes s.x after a
// barrier, so the copy needs no second one.
template <class Inner>
struct StashEpilogue {
  const Inner& inner;
  const sdf::TrunkSmem& s;
  Stash stash;
  size_t row0;  // plane row of the tile's first point
  int rows;

  __device__ __forceinline__ void operator()(int layer, sdf::Acc& acc) const {
    inner(layer, acc);
    __nv_bfloat16* dst = sdf::pick(stash.plane, layer + 1);
    if (dst != nullptr) {
      __syncthreads();
      store_tile(s, dst + row0 * WIDTH, rows);
    }
  }
};

template <bool kStash>
__global__ void __launch_bounds__(THREADS, 1)
sdf_grid_kernel(const __nv_bfloat16* __restrict__ pp1, const __nv_bfloat16* __restrict__ pp5,
                const __nv_bfloat16* __restrict__ zz1, const __nv_bfloat16* __restrict__ zz5,
                const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ bias,
                const __nv_bfloat16* __restrict__ w8, float* __restrict__ out, Stash stash,
                int batch, int points) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  sdf::TrunkSmem& s = *reinterpret_cast<sdf::TrunkSmem*>(smem_raw);

  const int shape = blockIdx.x % batch;
  const size_t p0 = static_cast<size_t>(blockIdx.x / batch) * BLOCK_M;
  const int rows = min(BLOCK_M, static_cast<int>(points - p0));
  const size_t row0 = static_cast<size_t>(shape) * points + p0;

  sdf::start_trunk(s, w, bias, w8, zz5 + static_cast<size_t>(shape) * WIDTH);

  // Layer 1: relu(pp1 + zz1) in bf16, eight columns (16 bytes) per step
  // (= h1, stash position 0).
  const __nv_bfloat16* zrow = zz1 + static_cast<size_t>(shape) * WIDTH;
  __nv_bfloat16* h1 = kStash ? stash.plane[0] : nullptr;
  for (int i = threadIdx.x; i < BLOCK_M * WIDTH / 8; i += THREADS) {
    const int r = i / (WIDTH / 8), c = (i % (WIDTH / 8)) * 8;
    uint4 pv = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) pv = *reinterpret_cast<const uint4*>(pp1 + (p0 + r) * WIDTH + c);
    const uint4 zv = *reinterpret_cast<const uint4*>(zrow + c);
    const __nv_bfloat162* pp = reinterpret_cast<const __nv_bfloat162*>(&pv);
    const __nv_bfloat162* zp = reinterpret_cast<const __nv_bfloat162*>(&zv);
    uint4 xv;
    __nv_bfloat162* xp = reinterpret_cast<__nv_bfloat162*>(&xv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 a = __bfloat1622float2(pp[j]);
      const float2 z = __bfloat1622float2(zp[j]);
      xp[j] = __floats2bfloat162_rn(fmaxf(a.x + z.x, 0.f), fmaxf(a.y + z.y, 0.f));
    }
    *reinterpret_cast<uint4*>(s.x + r * sdf::X_STRIDE + c) = xv;
    if (h1 != nullptr && r < rows) *reinterpret_cast<uint4*>(h1 + (row0 + r) * WIDTH + c) = xv;
  }

  const GridSkip skip{pp5 + p0 * WIDTH, rows};
  if constexpr (kStash) {
    const sdf::SharedZz5 zz5_row{s.zz5};
    const sdf::TrunkEpilogue<GridSkip, sdf::SharedZz5> inner{s, skip, zz5_row};
    sdf::run_layers(s, w, StashEpilogue<decltype(inner)>{inner, s, stash, row0, rows});
  } else {
    sdf::run_trunk(s, w, skip);
  }

  const float v = sdf::head(s);
  const int row = threadIdx.x >> 1;
  if ((threadIdx.x & 1) == 0 && row < rows)
    out[static_cast<size_t>(shape) * points + p0 + row] = v;
}

template <bool kStash>
int launch_grid(const void* pp1, const void* pp5, const void* zz1, const void* zz5, const void* w,
                const void* bias, const void* w8, void* out, const Stash& stash, int batch,
                int points, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(sdf_grid_kernel<kStash>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(sdf::TrunkSmem)));
  if (err != cudaSuccess) return err;
  const long long blocks = (static_cast<long long>(points) + BLOCK_M - 1) / BLOCK_M * batch;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  sdf_grid_kernel<kStash><<<static_cast<unsigned>(blocks), THREADS, sizeof(sdf::TrunkSmem),
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(pp1), static_cast<const __nv_bfloat16*>(pp5),
      static_cast<const __nv_bfloat16*>(zz1), static_cast<const __nv_bfloat16*>(zz5),
      static_cast<const __nv_bfloat16*>(w), static_cast<const __nv_bfloat16*>(bias),
      static_cast<const __nv_bfloat16*>(w8), static_cast<float*>(out), stash, batch, points);
  return cudaGetLastError();
}

}  // namespace

// B1.
extern "C" int sdf_grid_forward(const void* pp1, const void* pp5, const void* zz1,
                                const void* zz5, const void* w, const void* bias, const void* w8,
                                void* out, int batch, int points, int device, void* stream) {
  return launch_grid<false>(pp1, pp5, zz1, zz5, w, bias, w8, out, Stash{}, batch, points, device,
                            stream);
}

// B5a. `stash`: HIDDEN plane pointers, NULL for a position that is not
// stashed.
extern "C" int sdf_grid_stash_forward(const void* pp1, const void* pp5, const void* zz1,
                                      const void* zz5, const void* w, const void* bias,
                                      const void* w8, void* out, void* const* stash, int batch,
                                      int points, int device, void* stream) {
  Stash planes;
  for (int j = 0; j < HIDDEN; ++j) planes.plane[j] = static_cast<__nv_bfloat16*>(stash[j]);
  return launch_grid<true>(pp1, pp5, zz1, zz5, w, bias, w8, out, planes, batch, points, device,
                           stream);
}

extern "C" const char* sdf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
