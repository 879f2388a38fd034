// Backward of the grid MLP: for B shape latents over one shared point grid
// and a cotangent g [B, P] float32, the gradients of the trunk and the
// fan-in cotangents
//   d_pp1, d_pp5 [P, 256]   summed over shapes
//   d_zz1, d_zz5 [B, 256]   summed over points
//   d_w [6, 256(in), 256(out)], d_b [8, 256], d_w8 [256], d_b8 [1]
// all float32, in the JAX package's [in, out] layout. Two entry points run
// the same kernels:
//   * the recompute backward (B2, sdf_grid_backward) rebuilds h1..h7;
//   * the stash backward (B5b, sdf_grid_stash_backward) reads the h-chain
//     positions that the stash forward (B5a, sdf_grid.cu) wrote to its
//     [B, P, 256] bf16 planes, and rebuilds only the others.
//
// Replaces the Pallas TPU kernels `_bwd_kernel` (launched by
// `_trainable_bwd`, the custom VJP of apply_grid_trainable) and
// `_stash_bwd_kernel` (launched by `_stash_trainable_bwd`, the custom VJP of
// apply_grid_trainable_stash) in shapegan_tpu/ops/sdf_mlp_pallas.py. The
// chain back to w1p/w1z/w5p/w5z, the points and the latents is closed
// outside, in PyTorch.
//
// What bounds it on the H100: 18 - s bf16 products of 256 x 256 per row
// (s = stashed positions among h2..h7, 0 for B2; 6 - s rebuild the forward,
// 6 carry dh back, 6 make the weight gradients), i.e. 2.4 MFLOP per row and
// ~9.9 TFLOP at 16 x 64^3 for B2: tensor-core work, plus s x 512 bytes a
// row read from the stash. The TPU kernel keeps one float32 dW block in VMEM
// across a grid that runs in order; here blocks run in no order, and a
// tile's seven activation sets (7 x 128 x 264 bf16, ~473 KB) do not fit in
// the 227 KB of shared memory a block may use. So the backward is split into
// passes over device-memory scratch, sized by the wrapper for a chunk of at
// most ROW_CAP rows (whole shapes; 16 x 64^3 runs as 16 chunks of one shape):
//   1. rows pass. B2 (nothing stashed) runs the Hopper rows kernel of
//      sdf_grid_bwd_sm90.cuh (wgmma, TMA weight ring, persistent
//      warp-specialized blocks; it writes the same scratch). B5b runs
//      bwd_rows_kernel below, one block per 128-row tile of one shape: the
//      forward layers that are rebuilt (the Plan's sequence) on the
//      sdf_trunk.cuh main loop (same cp.async weight ring and mma.sync
//      fragments, with this file's own epilogue), then the six backward
//      products dh = dz @ W^T on the same ring, fed the [in, out] weight
//      stack. Before a rebuilt layer whose input position is stashed, and
//      before the head when h7 is stashed, the tile's rows of that plane
//      are copied into the activation tile (cp.async, rows past the tile's
//      end zero-filled). It writes the rebuilt h planes and every bf16 dz to
//      scratch, dx1 (layer 1, float32) and gz = g (1 - out^2). A stashed
//      position is never written to scratch: the masks of the backward
//      sweep, the weight pass and the d_w8 column sum read it from the stash
//      plane at the chunk's offset (HPlanes: one pointer a plane).
//   2-4. the Hopper passes of sdf_bwd_passes_sm90.cuh (grid_bwd_passes),
//      for B2 and B5b alike: a persistent wgmma weight kernel, d_w[l] =
//      h_l^T dz_l over TMA tiles of the planes, with d_b's column sums taken
//      from the dz tiles in shared memory; one fan-in kernel that reads dz5,
//      dx1, h7 and gz once for d_pp1 / d_pp5 (summed over shapes), d_zz1 /
//      d_zz5, d_w8 and d_b8; fixed-order finishes of their partials.
// No atomics: every sum runs in one order, so the result is the same from
// run to run. B5b's rows kernel's main loop is in sdf_bwd_passes.cuh; B2's
// rows pass and the weight kernel are shared with the rowwise backward
// (sdf_rowwise_bwd.cu). The scratch traffic (~7.7 KB written per
// row for B2) costs device memory bandwidth the TPU kernel did not spend.
//
// Rounding points follow `_bwd_kernel` and `_stash_bwd_kernel`, not B1: h1
// is rebuilt as a float32 sum rounded once to bf16; a stashed position is
// the forward's own bf16 value; a rebuilt layer adds the bias (and at
// layer 5 pp5 then zz5) to the float32 product of its predecessor (which
// may be stashed) and rounds once to bf16; each dz is rounded to bf16
// before it feeds d_w, d_b, d_pp5, d_zz5 and the next dh; dh and dx1 stay
// float32. A stashed position 0 is ignored, as the TPU kernel ignores it.
#include <algorithm>
#include <utility>

#include "sdf_bwd_passes.cuh"
#include "sdf_bwd_passes_sm90.cuh"
#include "sdf_grid_bwd_sm90.cuh"

namespace {

constexpr int ROW_CAP = 262144;       // rows of one chunk (one 64^3 shape)

// What the rows pass rebuilds: the trunk layers whose output position is
// not stashed, in ascending order (layer l makes position l + 1).
struct Plan {
  int fwd_layers;
  int layer[LAYERS];
  unsigned stashed;  // bit j: position j (1..6) is read from the stash
};

Plan make_plan(unsigned mask) {
  Plan plan{};
  plan.stashed = mask & 0x7eu;  // h1 costs no product: always rebuilt
  for (int j = 1; j < HIDDEN; ++j)
    if (!((plan.stashed >> j) & 1u)) plan.layer[plan.fwd_layers++] = j - 1;
  return plan;
}

struct Scratch {
  HPlanes h;            // h1..h7 of the chunk's rows: scratch, or the stash
  __nv_bfloat16* dz;    // [6][R][256]
  float* dx1;           // [R][256]
  float* gz;            // [R]
  float* w_part;        // the passes' partials: sdf90_passes::weight_part_floats()
  float* col_part;      // and col_part_floats()
};

// Weight slice `c` of the rows pass: the Plan's forward layers ([out, in]),
// then the backward layers w7..w2 ([in, out]).
__device__ __forceinline__ void load_plan_chunk(sdf::TrunkSmem& s, const __nv_bfloat16* __restrict__ w,
                                                const __nv_bfloat16* __restrict__ wt, const Plan& plan,
                                                int c) {
  const int fwd_chunks = plan.fwd_layers * CHUNKS_PER_LAYER;
  const bool forward = c < fwd_chunks;
  const int layer = forward ? plan.layer[c / CHUNKS_PER_LAYER]
                            : LAYERS - 1 - (c - fwd_chunks) / CHUNKS_PER_LAYER;
  load_weight_slice(s, (forward ? w : wt) + static_cast<size_t>(layer) * WIDTH * WIDTH,
                    c % CHUNKS_PER_LAYER, c % STAGES);
}

// The tile's rows of a stash plane (`src`: the tile's first row) into s.x.
// Waits for every copy in flight, the weight ring's too.
__device__ __forceinline__ void load_stash_tile(sdf::TrunkSmem& s, const __nv_bfloat16* src, int rows) {
  __syncthreads();  // every warp is done with s.x
  for (int i = threadIdx.x; i < BLOCK_M * WIDTH / 8; i += THREADS) {
    const int r = i / (WIDTH / 8), c = (i % (WIDTH / 8)) * 8;
    cp_async16_zfill(s.x + r * X_STRIDE + c, src + static_cast<size_t>(r < rows ? r : 0) * WIDTH + c,
                     r < rows);
  }
  sdf::cp_async_commit();
  sdf::cp_async_wait<0>();
  __syncthreads();
}

// ------------------------------------------------------------ 1. rows pass

__global__ void __launch_bounds__(THREADS, 1)
bwd_rows_kernel(const __nv_bfloat16* __restrict__ pp1, const __nv_bfloat16* __restrict__ pp5,
                const __nv_bfloat16* __restrict__ zz1, const __nv_bfloat16* __restrict__ zz5,
                const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ wt,
                const __nv_bfloat16* __restrict__ bias, const __nv_bfloat16* __restrict__ w8,
                const float* __restrict__ g, Scratch sc, Plan plan, int shapes, int points,
                long long rows_total) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  RowsSmem& rs = *reinterpret_cast<RowsSmem*>(smem_raw);
  sdf::TrunkSmem& s = rs.t;

  const int shape = blockIdx.x % shapes;
  const int p0 = (blockIdx.x / shapes) * BLOCK_M;
  const int rows = min(BLOCK_M, points - p0);
  const size_t base = static_cast<size_t>(shape) * points + p0;  // first row of the chunk's planes
  const size_t plane = static_cast<size_t>(rows_total) * WIDTH;   // one [R, 256] dz array
  const int fwd_chunks = plan.fwd_layers * CHUNKS_PER_LAYER;
  const int chunks = fwd_chunks + LAYERS * CHUNKS_PER_LAYER;

  // Ring start (slices of w and wt, in the plan's order) and small operands.
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    load_plan_chunk(s, w, wt, plan, c);
    sdf::cp_async_commit();
  }
  for (int i = threadIdx.x; i < 8 * WIDTH; i += THREADS) s.bias[i] = bias[i];
  for (int i = threadIdx.x; i < WIDTH; i += THREADS) {
    s.w8[i] = w8[i];
    s.zz5[i] = zz5[static_cast<size_t>(shape) * WIDTH + i];
  }

  // Layer 1: relu(pp1 + zz1) in float32, rounded once (= h1, plane 0).
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
    if (r < rows) *reinterpret_cast<uint4*>(sc.h.p[0] + (base + r) * WIDTH + c) = xv;
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

  for (int c = 0; c < chunks; ++c) {
    if (c < fwd_chunks && c % CHUNKS_PER_LAYER == 0) {
      // A rebuilt layer starts: its input position is in s.x unless stashed.
      const int in = plan.layer[c / CHUNKS_PER_LAYER];
      if ((plan.stashed >> in) & 1u) load_stash_tile(s, sc.h.p[in] + base * WIDTH, rows);
    } else if (c == fwd_chunks) {
      // The forward is done: h7 into s.x if stashed, then the head and the
      // start of the backward: gz = g (1 - out^2), dz7 = bf16(gz w8 * (h7 > 0))
      // in place of h7.
      if ((plan.stashed >> LAYERS) & 1u) load_stash_tile(s, sc.h.p[LAYERS] + base * WIDTH, rows);
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

    sdf::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (c + STAGES - 1 < chunks) load_plan_chunk(s, w, wt, plan, c + STAGES - 1);
    sdf::cp_async_commit();
    bwd_mma_chunk(s, acc, c);

    if (c % CHUNKS_PER_LAYER != CHUNKS_PER_LAYER - 1) continue;
    const bool forward = c < fwd_chunks;
    const int layer = forward ? plan.layer[c / CHUNKS_PER_LAYER]
                              : LAYERS - 1 - (c - fwd_chunks) / CHUNKS_PER_LAYER;
    __syncthreads();  // every warp has read this layer's input rows
    __nv_bfloat16* h_out = forward ? sc.h.p[layer + 1] : nullptr;
    const __nv_bfloat16* h_in = sc.h.p[layer];
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
            if (valid) *reinterpret_cast<__nv_bfloat162*>(h_out + off) = hv;
          } else {
            // acc = dh at this layer's input h_layer (plane `layer`): mask by it.
            float2 hv = make_float2(0.f, 0.f);
            if (valid) hv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(h_in + off));
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
  }
  sdf::cp_async_wait<0>();
}

struct Layout {
  size_t h, dz, dx1, gz, w_part, col_part, total;
};

// Scratch of a chunk of `shapes_per_chunk` shapes, with `h_planes` h planes
// (the positions the rows pass writes: h1 and those not stashed).
Layout layout(int points, int shapes_per_chunk, int h_planes) {
  Layout l;
  const long long rows = static_cast<long long>(points) * shapes_per_chunk;
  auto up = [](size_t b) { return (b + 255) / 256 * 256; };
  l.h = 0;
  l.dz = l.h + up(h_planes * rows * WIDTH * 2);
  l.dx1 = l.dz + up(LAYERS * rows * WIDTH * 2);
  l.gz = l.dx1 + up(rows * WIDTH * 4);
  l.w_part = l.gz + up(rows * 4);
  l.col_part = l.w_part + up(sdf90_passes::weight_part_floats() * 4);
  l.total = l.col_part + up(sdf90_passes::col_part_floats(shapes_per_chunk, points) * 4);
  return l;
}

int h_planes(const Plan& plan) { return HIDDEN - __builtin_popcount(plan.stashed); }

// The rows pass of B2 (sdf_grid_bwd_sm90.cuh) over the chunk of `shapes`
// shapes from shape s0 on, into the scratch `base` laid out as `l`.
cudaError_t rows_sm90(const void* pp1, const void* pp5, const void* zz1, const void* zz5, const void* w,
                      const void* wt, const void* bias, const void* w8, const void* g, unsigned char* base,
                      const Layout& l, int s0, int shapes, int points, int device, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  sdf90_bwd::Args<sdf90_bwd::GridInputs> args{};
  args.in.pp1 = static_cast<const bf*>(pp1);
  args.in.pp5 = static_cast<const bf*>(pp5);
  args.in.zz1 = static_cast<const bf*>(zz1) + static_cast<size_t>(s0) * WIDTH;
  args.in.zz5 = static_cast<const bf*>(zz5) + static_cast<size_t>(s0) * WIDTH;
  args.bias = static_cast<const bf*>(bias);
  args.w8 = static_cast<const bf*>(w8);
  args.g = static_cast<const float*>(g) + static_cast<size_t>(s0) * points;
  args.h = reinterpret_cast<bf*>(base + l.h);
  args.dz = reinterpret_cast<bf*>(base + l.dz);
  args.dx1 = reinterpret_cast<float*>(base + l.dx1);
  args.gz = reinterpret_cast<float*>(base + l.gz);
  args.plane = static_cast<long long>(shapes) * points * WIDTH;
  args.shapes = shapes;
  args.points = points;
  return sdf90_bwd::rows_pass(w, wt, args, device, stream);
}

// Both entry points: `stash` holds HIDDEN plane pointers ([B, P, 256] bf16),
// NULL for a position that is not stashed (every one for B2).
int grid_backward(const void* pp1, const void* pp5, const void* zz1, const void* zz5, const void* w,
                  const void* wt, const void* bias, const void* w8, const void* g,
                  void* const* stash, void* d_pp1, void* d_pp5, void* d_zz1, void* d_zz5, void* d_w,
                  void* d_b, void* d_w8, void* d_b8, void* scratch, int batch, int points,
                  int shapes_per_chunk, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch <= 0 || points <= 0 || shapes_per_chunk <= 0) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(RowsSmem)));
  if (err != cudaSuccess) return err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  using bf = __nv_bfloat16;
  const GridGrads out{static_cast<float*>(d_pp1), static_cast<float*>(d_pp5),
                      static_cast<float*>(d_zz1), static_cast<float*>(d_zz5),
                      static_cast<float*>(d_w),   static_cast<float*>(d_b),
                      static_cast<float*>(d_w8),  static_cast<float*>(d_b8)};
  if ((err = zero_grid_grads(out, batch, points, stream)) != cudaSuccess) return err;

  unsigned mask = 0;
  for (int j = 0; j < HIDDEN; ++j)
    if (stash[j] != nullptr) mask |= 1u << j;
  const Plan plan = make_plan(mask);
  const Layout full = layout(points, shapes_per_chunk, h_planes(plan));
  const size_t pw = static_cast<size_t>(points) * WIDTH;
  unsigned char* base = static_cast<unsigned char*>(scratch);
  for (int s0 = 0; s0 < batch; s0 += shapes_per_chunk) {
    const int shapes = std::min(shapes_per_chunk, batch - s0);
    const long long rows = static_cast<long long>(shapes) * points;
    const size_t plane = static_cast<size_t>(rows) * WIDTH;
    Scratch sc{{}, reinterpret_cast<bf*>(base + full.dz), reinterpret_cast<float*>(base + full.dx1),
               reinterpret_cast<float*>(base + full.gz), reinterpret_cast<float*>(base + full.w_part),
               reinterpret_cast<float*>(base + full.col_part)};
    bf* scratch_h = reinterpret_cast<bf*>(base + full.h);
    for (int j = 0, k = 0; j < HIDDEN; ++j)
      sc.h.p[j] = ((plan.stashed >> j) & 1u) ? static_cast<bf*>(stash[j]) + static_cast<size_t>(s0) * pw
                                             : scratch_h + (k++) * plane;

    if (mask == 0) {  // B2: the Hopper rows kernel
      err = rows_sm90(pp1, pp5, zz1, zz5, w, wt, bias, w8, g, base, full, s0, shapes, points, device,
                      stream);
      if (err != cudaSuccess) return err;
    } else {  // B5b: the rows kernel that reads stashed planes
      const long long blocks = ceil_div(points, BLOCK_M) * shapes;
      if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
      bwd_rows_kernel<<<static_cast<unsigned>(blocks), THREADS, sizeof(RowsSmem), stream>>>(
          static_cast<const bf*>(pp1), static_cast<const bf*>(pp5),
          static_cast<const bf*>(zz1) + static_cast<size_t>(s0) * WIDTH,
          static_cast<const bf*>(zz5) + static_cast<size_t>(s0) * WIDTH, static_cast<const bf*>(w),
          static_cast<const bf*>(wt), static_cast<const bf*>(bias), static_cast<const bf*>(w8),
          static_cast<const float*>(g) + static_cast<size_t>(s0) * points, sc, plan, shapes, points,
          rows);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    err = grid_bwd_passes(sc.h, sc.dz, sc.dx1, sc.gz, sc.w_part, sc.col_part, shapes, points, s0, out,
                          stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int sdf_grid_backward_chunk_shapes(int points, int batch) {
  return std::max(1, std::min(batch, ROW_CAP / std::max(points, 1)));
}

// `mask`: bit j set for each stashed position j (0 for B2).
extern "C" long long sdf_grid_backward_scratch_bytes(int points, int shapes_per_chunk, int mask) {
  return static_cast<long long>(
      layout(points, shapes_per_chunk, h_planes(make_plan(static_cast<unsigned>(mask)))).total);
}

// The byte offsets of a chunk's scratch (h planes, dz planes, dx1, gz) and
// its size: out[5].
extern "C" void sdf_grid_backward_offsets(int points, int shapes_per_chunk, int mask, long long* out) {
  const Layout l = layout(points, shapes_per_chunk, h_planes(make_plan(static_cast<unsigned>(mask))));
  const size_t offsets[5] = {l.h, l.dz, l.dx1, l.gz, l.total};
  for (int i = 0; i < 5; ++i) out[i] = static_cast<long long>(offsets[i]);
}

// B2's rows pass alone over `shapes` shapes (one chunk: shapes x points <=
// the chunk's rows, or one shape), into `scratch` laid out as for a chunk
// of `shapes` shapes with nothing stashed.
extern "C" int sdf_grid_backward_rows(const void* pp1, const void* pp5, const void* zz1, const void* zz5,
                                      const void* w, const void* wt, const void* bias, const void* w8,
                                      const void* g, void* scratch, int shapes, int points, int device,
                                      void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (shapes <= 0 || points <= 0 || shapes > sdf_grid_backward_chunk_shapes(points, shapes))
    return cudaErrorInvalidValue;
  return rows_sm90(pp1, pp5, zz1, zz5, w, wt, bias, w8, g, static_cast<unsigned char*>(scratch),
                   layout(points, shapes, HIDDEN), 0, shapes, points, device,
                   static_cast<cudaStream_t>(stream_ptr));
}

// The scratch of sdf_grid_backward_passes for a chunk of `shapes` shapes.
extern "C" long long sdf_grid_backward_passes_scratch_bytes(int points, int shapes) {
  const Layout l = layout(points, shapes, HIDDEN);
  return static_cast<long long>(l.total - l.w_part);
}

// Passes 2-4 alone over one chunk's planes (as the rows pass writes them):
// `shapes` shapes from shape s0 on, `points` rows each; h [7, R, 256] and dz
// [6, R, 256] bf16, dx1 [R, 256] and gz [R] float32, R = shapes x points.
// The outputs are zeroed first (d_zz1 and d_zz5 have s0 + shapes rows; the
// chunk's are rows s0 on). `scratch`: sdf_grid_backward_passes_scratch_bytes.
extern "C" int sdf_grid_backward_passes(const void* h, const void* dz, const void* dx1, const void* gz,
                                        void* d_pp1, void* d_pp5, void* d_zz1, void* d_zz5, void* d_w,
                                        void* d_b, void* d_w8, void* d_b8, void* scratch, int shapes,
                                        int points, int s0, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (shapes <= 0 || points <= 0 || s0 < 0) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const GridGrads out{static_cast<float*>(d_pp1), static_cast<float*>(d_pp5),
                      static_cast<float*>(d_zz1), static_cast<float*>(d_zz5),
                      static_cast<float*>(d_w),   static_cast<float*>(d_b),
                      static_cast<float*>(d_w8),  static_cast<float*>(d_b8)};
  if ((err = zero_grid_grads(out, s0 + shapes, points, stream)) != cudaSuccess) return err;
  using bf = __nv_bfloat16;
  const Layout l = layout(points, shapes, HIDDEN);
  unsigned char* part = static_cast<unsigned char*>(scratch);  // the partials of a chunk's layout
  const size_t plane = static_cast<size_t>(shapes) * points * WIDTH;
  return grid_bwd_passes(contiguous_planes(static_cast<bf*>(const_cast<void*>(h)), plane),
                         static_cast<const bf*>(dz), static_cast<const float*>(dx1),
                         static_cast<const float*>(gz), reinterpret_cast<float*>(part),
                         reinterpret_cast<float*>(part + (l.col_part - l.w_part)), shapes, points, s0, out,
                         stream);
}

// B2.
extern "C" int sdf_grid_backward(const void* pp1, const void* pp5, const void* zz1, const void* zz5,
                                 const void* w, const void* wt, const void* bias, const void* w8,
                                 const void* g, void* d_pp1, void* d_pp5, void* d_zz1, void* d_zz5,
                                 void* d_w, void* d_b, void* d_w8, void* d_b8, void* scratch,
                                 int batch, int points, int shapes_per_chunk, int device,
                                 void* stream_ptr) {
  void* const none[HIDDEN] = {};
  return grid_backward(pp1, pp5, zz1, zz5, w, wt, bias, w8, g, none, d_pp1, d_pp5, d_zz1, d_zz5, d_w,
                       d_b, d_w8, d_b8, scratch, batch, points, shapes_per_chunk, device, stream_ptr);
}

// B5b. `stash`: HIDDEN plane pointers, NULL for a position that is not
// stashed.
extern "C" int sdf_grid_stash_backward(const void* pp1, const void* pp5, const void* zz1,
                                       const void* zz5, const void* w, const void* wt,
                                       const void* bias, const void* w8, const void* g,
                                       void* const* stash, void* d_pp1, void* d_pp5, void* d_zz1,
                                       void* d_zz5, void* d_w, void* d_b, void* d_w8, void* d_b8,
                                       void* scratch, int batch, int points, int shapes_per_chunk,
                                       int device, void* stream_ptr) {
  return grid_backward(pp1, pp5, zz1, zz5, w, wt, bias, w8, g, stash, d_pp1, d_pp5, d_zz1, d_zz5,
                       d_w, d_b, d_w8, d_b8, scratch, batch, points, shapes_per_chunk, device,
                       stream_ptr);
}
