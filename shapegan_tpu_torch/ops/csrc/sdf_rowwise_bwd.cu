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
// the 20,000-row training batch. The bytes it must move are ~3.1 KB a row
// (xyz, zz1, zz5 and g in, dzz1 and dzz5 out as float32), 19 us at
// 3.35 TB/s. It runs on the grid backward's (B2's) Hopper designs:
//   1. the rows pass of sdf_grid_bwd_sm90.cuh with RowInputs: persistent,
//      warp-specialized wgmma blocks over 64-row tiles (313 at 20,000 rows
//      for 264 consumer warpgroups), the weights streamed by TMA through a
//      ring that never restarts, the ReLU masks kept as bits in shared
//      memory. It projects xyz by w1p and w5p in its epilogues, reads zz1
//      and zz5 per row, writes dzz1 from the registers, and h1..h7,
//      dz1..dz6 (bf16) and gz (float32) to scratch;
//   2. the weight kernel of sdf_bwd_passes_sm90.cuh (weight_passes): d_w[l]
//      = h_l^T dz_l over 11 row slabs, with d_b's column sums taken from the
//      dz tiles in shared memory, then fixed-order finishes;
//   3. tail_kernel over 32-row blocks: dzz5, dz5's plane widened to float32,
//      and the partials of d_w8 = h7^T gz and d_b8 = sum gz, then
//      tree_finish_kernel. dzz5 is not written by the rows pass: copying it
//      there, beside dz5's staged tile, spilled the rows pass's registers
//      (1.6 KB a thread) and cost it more than this pass's 30 MB at 20,000
//      rows (PERF.md, section 6).
// No atomics: every sum runs in one order, so a result is the same from run
// to run. The scratch is what this design adds to the bytes: ~6.7 KB a row
// written and read back, and 17 MB of d_w partials, ~0.1 ms at the memory
// rate at 20,000 rows, twice the bound.
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
#include "sdf_bwd_passes_sm90.cuh"
#include "sdf_grid_bwd_sm90.cuh"

namespace {

constexpr int TAIL_ROWS = 32;  // rows of one tail_kernel block

// Block b, over its rows (TAIL_ROWS from TAIL_ROWS b on): dzz5 = dz5 as
// float32 (8 columns a thread at a time), and d_w8's and d_b8's partials in
// row order: part[b][c] = sum of h7[r][c] gz[r] (thread c), part[blocks][b]
// = sum of gz[r].
__global__ void __launch_bounds__(WIDTH) tail_kernel(const __nv_bfloat16* __restrict__ dz5,
                                                     const __nv_bfloat16* __restrict__ h7,
                                                     const float* __restrict__ gz, int n,
                                                     float* __restrict__ dzz5, float* __restrict__ part) {
  const int c = threadIdx.x;
  const int r0 = blockIdx.x * TAIL_ROWS;
  const int count = min(TAIL_ROWS, n - r0);
  const uint4* src = reinterpret_cast<const uint4*>(dz5 + static_cast<size_t>(r0) * WIDTH);
  float4* dst = reinterpret_cast<float4*>(dzz5 + static_cast<size_t>(r0) * WIDTH);
  for (int i = c; i < count * WIDTH / 8; i += WIDTH) {
    const uint4 v = src[i];
    const auto lo = [](uint32_t x) { return __uint_as_float(x << 16); };
    const auto hi = [](uint32_t x) { return __uint_as_float(x & 0xffff0000u); };
    dst[2 * i] = make_float4(lo(v.x), hi(v.x), lo(v.y), hi(v.y));
    dst[2 * i + 1] = make_float4(lo(v.z), hi(v.z), lo(v.w), hi(v.w));
  }
  float w8 = 0.f, b8 = 0.f;
  for (int k = 0; k < count; ++k) {
    const float g = gz[r0 + k];
    w8 = fmaf(__bfloat162float(h7[static_cast<size_t>(r0 + k) * WIDTH + c]), g, w8);
    b8 += g;
  }
  part[static_cast<size_t>(blockIdx.x) * WIDTH + c] = w8;
  if (c == 0) part[static_cast<size_t>(gridDim.x) * WIDTH + blockIdx.x] = b8;
}

int tail_blocks(int n) { return static_cast<int>(ceil_div(n, TAIL_ROWS)); }

struct Layout {
  size_t h, dz, gz, w_part, b_part, head_part, total;
};

Layout layout(int n) {
  namespace P = sdf90_passes;
  Layout l;
  const long long rows = n;
  auto up = [](size_t b) { return (b + 255) / 256 * 256; };
  l.h = 0;
  l.dz = l.h + up(HIDDEN * rows * WIDTH * 2);
  l.gz = l.dz + up(LAYERS * rows * WIDTH * 2);
  l.w_part = l.gz + up(rows * 4);
  l.b_part = l.w_part + up(P::weight_part_floats() * 4);
  l.head_part = l.b_part + up(P::b_part_floats() * 4);
  l.total = l.head_part + up(static_cast<size_t>(tail_blocks(n)) * (WIDTH + 1) * 4);
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
  namespace P = sdf90_passes;
  using bf = __nv_bfloat16;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Layout l = layout(n);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  bf* h = reinterpret_cast<bf*>(base + l.h);
  bf* dz = reinterpret_cast<bf*>(base + l.dz);
  float* gz = reinterpret_cast<float*>(base + l.gz);
  const size_t plane = static_cast<size_t>(n) * WIDTH;

  sdf90_bwd::Args<sdf90_bwd::RowInputs> args{};
  args.in.pts = static_cast<const float*>(pts);
  args.in.w1p = static_cast<const bf*>(w1p);
  args.in.w5p = static_cast<const bf*>(w5p);
  args.in.zz1 = static_cast<const bf*>(zz1);
  args.in.zz5 = static_cast<const bf*>(zz5);
  args.bias = static_cast<const bf*>(bias);
  args.w8 = static_cast<const bf*>(w8);
  args.g = static_cast<const float*>(g);
  args.h = h;
  args.dz = dz;
  args.dx1 = static_cast<float*>(dzz1);
  args.gz = gz;
  args.plane = static_cast<long long>(plane);
  args.shapes = 1;
  args.points = n;
  if ((err = sdf90_bwd::rows_pass(w, wt, args, device, stream)) != cudaSuccess) return err;

  float* f_w = static_cast<float*>(d_w);
  float* f_b = static_cast<float*>(d_b);
  float* f_w8 = static_cast<float*>(d_w8);
  float* f_b8 = static_cast<float*>(d_b8);
  // The finishes add into the summed outputs, and d_b rows 3, 6, 7 stay zero.
  const std::pair<void*, size_t> summed[] = {
      {f_w, static_cast<size_t>(LAYERS) * WIDTH * WIDTH * 4}, {f_b, 8 * WIDTH * 4},
      {f_w8, WIDTH * 4}, {f_b8, 4}};
  for (const auto& out : summed) {
    err = cudaMemsetAsync(out.first, 0, out.second, stream);
    if (err != cudaSuccess) return err;
  }

  err = P::weight_passes(contiguous_planes(h, plane), dz, n, reinterpret_cast<float*>(base + l.w_part),
                         reinterpret_cast<float*>(base + l.b_part), f_w, f_b, stream);
  if (err != cudaSuccess) return err;

  // dzz5; d_w8 = sum h7 gz, d_b8 = sum gz.
  const int blocks = tail_blocks(n);
  float* head_part = reinterpret_cast<float*>(base + l.head_part);
  tail_kernel<<<blocks, WIDTH, 0, stream>>>(dz + SKIP_LAYER * plane, h + LAYERS * plane, gz, n,
                                            static_cast<float*>(dzz5), head_part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  P::tree_finish_kernel<<<WIDTH / 32, 1024, 0, stream>>>(head_part, blocks, WIDTH, f_w8);
  P::tree_finish_kernel<<<1, 1024, 0, stream>>>(head_part + static_cast<size_t>(blocks) * WIDTH, blocks, 1,
                                                f_b8);
  return cudaGetLastError();
}
