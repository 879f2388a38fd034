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
//   1. rows pass: the Hopper rows kernel of sdf_grid_bwd_sm90.cuh (wgmma,
//      TMA weight ring, persistent warp-specialized blocks), B2's instance
//      (GridInputs) or B5b's (StashInputs: B2's inputs and the Plan below, a
//      launch constant; with h2..h7 all stashed, a compile-time one). It rebuilds the forward, runs the six backward
//      products dh = dz @ W^T on the same weight ring (fed the [in, out]
//      stack) and writes h1 and the rebuilt h planes, every bf16 dz, dx1
//      (layer 1, float32) and gz = g (1 - out^2) to scratch. A position the
//      plan stashes costs no products: its tile is read from the stash plane
//      (at the chunk's offset) into the registers as the next layer's
//      operand, and its mask kept. It is never written to scratch: the
//      weight pass and the d_w8 column sum read it from the stash plane
//      (HPlanes: one pointer a plane).
//   2-4. the Hopper passes of sdf_bwd_passes_sm90.cuh (grid_bwd_passes),
//      for B2 and B5b alike: a persistent wgmma weight kernel, d_w[l] =
//      h_l^T dz_l over TMA tiles of the planes, with d_b's column sums taken
//      from the dz tiles in shared memory; one fan-in kernel that reads dz5,
//      dx1, h7 and gz once for d_pp1 / d_pp5 (summed over shapes), d_zz1 /
//      d_zz5, d_w8 and d_b8; fixed-order finishes of their partials.
// No atomics: every sum runs in one order, so the result is the same from
// run to run. The rows pass and the weight kernel are shared with the
// rowwise backward (sdf_rowwise_bwd.cu). The scratch traffic (~7.7 KB
// written per row for B2) costs device memory bandwidth the TPU kernel did
// not spend.
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

using sdf90_bwd::Plan;

// What the rows pass rebuilds: the trunk layers whose output position is
// not stashed, in ascending order (layer l makes position l + 1).
Plan make_plan(unsigned mask) {
  Plan plan{};
  plan.stashed = mask & 0x7eu;  // h1 costs no product: always rebuilt
  for (int j = 1; j < HIDDEN; ++j)
    if (!((plan.stashed >> j) & 1u)) plan.layer[plan.rebuilt++] = j - 1;
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

// A chunk's scratch in `base` laid out as `l`: the chunk holds `shapes`
// shapes from shape s0 on, `points` rows each. Its h planes are h1 and the
// positions the plan rebuilds, one after another, and the stashed ones the
// stash planes (`stash`: HIDDEN [B, P, 256] pointers) at the chunk's rows.
Scratch chunk_scratch(unsigned char* base, const Layout& l, const Plan& plan, void* const* stash, int s0,
                      int shapes, int points) {
  using bf = __nv_bfloat16;
  const size_t plane = static_cast<size_t>(shapes) * points * WIDTH;
  const size_t pw = static_cast<size_t>(points) * WIDTH;
  Scratch sc{{}, reinterpret_cast<bf*>(base + l.dz), reinterpret_cast<float*>(base + l.dx1),
             reinterpret_cast<float*>(base + l.gz), reinterpret_cast<float*>(base + l.w_part),
             reinterpret_cast<float*>(base + l.col_part)};
  bf* scratch_h = reinterpret_cast<bf*>(base + l.h);
  for (int j = 0, k = 0; j < HIDDEN; ++j)
    sc.h.p[j] = ((plan.stashed >> j) & 1u) ? static_cast<bf*>(stash[j]) + static_cast<size_t>(s0) * pw
                                           : scratch_h + (k++) * plane;
  return sc;
}

// The rows pass (sdf_grid_bwd_sm90.cuh) over the chunk of `shapes` shapes
// from shape s0 on, into its scratch sc: B2's instance (plan: NULL), or
// B5b's given the plan (the instance for h2..h7 all stashed, or the one
// that reads its plan at run time).
cudaError_t rows_sm90(const void* pp1, const void* pp5, const void* zz1, const void* zz5, const void* w,
                      const void* wt, const void* bias, const void* w8, const void* g, const Scratch& sc,
                      const Plan* plan, int s0, int shapes, int points, int device, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const sdf90_bwd::GridInputs in{static_cast<const bf*>(pp1), static_cast<const bf*>(pp5),
                                 static_cast<const bf*>(zz1) + static_cast<size_t>(s0) * WIDTH,
                                 static_cast<const bf*>(zz5) + static_cast<size_t>(s0) * WIDTH};
  const auto launch = [&](auto args) {
    args.bias = static_cast<const bf*>(bias);
    args.w8 = static_cast<const bf*>(w8);
    args.g = static_cast<const float*>(g) + static_cast<size_t>(s0) * points;
    args.h = sc.h.p[0];  // B2: the seven planes one after another
    args.dz = sc.dz;
    args.dx1 = sc.dx1;
    args.gz = sc.gz;
    args.plane = static_cast<long long>(shapes) * points * WIDTH;
    args.shapes = shapes;
    args.points = points;
    return sdf90_bwd::rows_pass(w, wt, args, device, stream);
  };
  if (plan == nullptr) return launch(sdf90_bwd::Args<sdf90_bwd::GridInputs>{in});
  const auto stash = [&](auto args) {
    args.in.plan = *plan;
    for (int j = 0; j < HIDDEN; ++j) args.in.h[j] = sc.h.p[j];
    return launch(args);
  };
  using sdf90_bwd::StashInputs;
  if (plan->stashed == sdf90_bwd::FULL_PLAN) return stash(sdf90_bwd::Args<StashInputs<true>>{{in}});
  return stash(sdf90_bwd::Args<StashInputs<false>>{{in}});
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
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
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
  unsigned char* base = static_cast<unsigned char*>(scratch);
  for (int s0 = 0; s0 < batch; s0 += shapes_per_chunk) {
    const int shapes = std::min(shapes_per_chunk, batch - s0);
    const Scratch sc = chunk_scratch(base, full, plan, stash, s0, shapes, points);
    err = rows_sm90(pp1, pp5, zz1, zz5, w, wt, bias, w8, g, sc, mask == 0 ? nullptr : &plan, s0, shapes,
                    points, device, stream);
    if (err != cudaSuccess) return err;
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
  return rows_sm90(pp1, pp5, zz1, zz5, w, wt, bias, w8, g,
                   chunk_scratch(static_cast<unsigned char*>(scratch), layout(points, shapes, HIDDEN),
                                 make_plan(0), nullptr, 0, shapes, points),
                   nullptr, 0, shapes, points, device, static_cast<cudaStream_t>(stream_ptr));
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
