// K masked sphere-trace iterations per launch over rays [N]: each 128-lane
// tile keeps its lane state (points, directions, status, escape height) in
// shared memory for all K iterations and runs the single-shape SDF forward
// on its points every iteration.
//
// Replaces the Pallas TPU kernel built by `_make_trace_kernel` and launched
// by `trace_steps_fused` in shapegan_tpu/ops/sdf_mlp_pallas.py. Per
// iteration and per lane it computes what that kernel computes:
//   sdf    = clip(tanh(head(bf16(p))) + sdf_offset, -step_clamp, step_clamp)
//   p     += dir * (active ? sdf : 0)
//   hit    = active && 0 < sdf < threshold
//   miss   = active && outside(p): |p|^2 > radius^2 (the sum of squares) for
//            primary rays, p.y > the lane's escape height for shadow rays
//   status = hit ? HIT : miss ? MISS : status      (a hit beats a miss)
// The trunk's input is the float32 point rounded to bf16; the point itself
// stays float32. The advance and the sum of squares are written with
// __fmul_rn / __fadd_rn so nvcc contracts nothing into an FMA: each product
// and sum rounds once, as the plain PyTorch version's separate operations do.
//
// What bounds it on the H100: per lane and iteration the trunk does
// 6 x 2 x 256 x 256 flops on the tensor cores, the same work as the points
// kernel (sdf_points.cu), with which it shares the trunk (sdf_trunk.cuh);
// the lane state crosses device memory once per launch (28 bytes in, 16 out)
// instead of once per iteration. The 768 KB of trunk weights stream from L2
// through the cp.async ring once per iteration, as in the points kernel. A
// tile whose lanes are all resolved stops early (__syncthreads_or on "any
// active"): resolved lanes never change, so the result is the same.
#include "sdf_trunk.cuh"

namespace {

using sdf::BLOCK_M;
using sdf::THREADS;
using sdf::WIDTH;

constexpr int ACTIVE = 0, HIT = 1, MISS = 2;

struct __align__(16) TraceSmem {
  sdf::TrunkSmem trunk;
  sdf::PointsInput in;  // in.pts: the bf16-rounded points of this iteration
  float pos[BLOCK_M][3];
  float dir[BLOCK_M][3];
  float escape[BLOCK_M];
  float sdf[BLOCK_M];
  int status[BLOCK_M];
};

__global__ void __launch_bounds__(THREADS, 1)
sdf_trace_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                 const int* __restrict__ status, const float* __restrict__ escape,
                 const __nv_bfloat16* __restrict__ w1p, const __nv_bfloat16* __restrict__ w5p,
                 const __nv_bfloat16* __restrict__ zz1, const __nv_bfloat16* __restrict__ zz5,
                 const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ bias,
                 const __nv_bfloat16* __restrict__ w8, float* __restrict__ pts_out,
                 int* __restrict__ status_out, int n, int k, int shadow, float threshold,
                 float step_clamp, float sdf_offset, float radius, float radius_sq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TraceSmem& s = *reinterpret_cast<TraceSmem*>(smem_raw);

  const size_t p0 = static_cast<size_t>(blockIdx.x) * BLOCK_M;
  const int rows = min(BLOCK_M, static_cast<int>(n - p0));

  // Constant operands once per launch; the lane state; padded lanes are MISS.
  for (int i = threadIdx.x; i < 8 * WIDTH; i += THREADS) s.trunk.bias[i] = bias[i];
  for (int i = threadIdx.x; i < WIDTH; i += THREADS) {
    s.trunk.w8[i] = w8[i];
    s.trunk.zz5[i] = zz5[i];
  }
  sdf::load_projections(s.in, w1p, w5p);
  for (int i = threadIdx.x; i < BLOCK_M * 3; i += THREADS) {
    const bool live = i / 3 < rows;
    s.pos[i / 3][i % 3] = live ? pts[p0 * 3 + i] : 0.f;
    s.dir[i / 3][i % 3] = live ? dirs[p0 * 3 + i] : 0.f;
  }
  if (threadIdx.x < BLOCK_M) {
    const int t = threadIdx.x;
    s.status[t] = t < rows ? status[p0 + t] : MISS;
    s.escape[t] = t < rows && escape != nullptr ? escape[p0 + t] : radius;
  }

  for (int it = 0; it < k; ++it) {
    // Publishes the lane state (and, in later iterations, orders this
    // iteration's writes after every thread's reads of the last one).
    if (!__syncthreads_or(threadIdx.x < BLOCK_M && s.status[threadIdx.x] == ACTIVE)) break;
    sdf::start_weight_ring(s.trunk, w);
    for (int i = threadIdx.x; i < BLOCK_M * 3; i += THREADS)
      s.in.pts[i / 3][i % 3] = sdf::round_bf16(s.pos[i / 3][i % 3]);
    __syncthreads();

    sdf::points_layer1(s.trunk, s.in, zz1);
    sdf::run_trunk(s.trunk, w, sdf::PointsSkip{&s.in});
    const float v = sdf::head(s.trunk);
    if ((threadIdx.x & 1) == 0) s.sdf[threadIdx.x >> 1] = v;
    __syncthreads();

    if (threadIdx.x < BLOCK_M) {
      const int t = threadIdx.x;
      const float d = fminf(fmaxf(__fadd_rn(s.sdf[t], sdf_offset), -step_clamp), step_clamp);
      const bool active = s.status[t] == ACTIVE;
      const float step = active ? d : 0.f;
      const float x = __fadd_rn(s.pos[t][0], __fmul_rn(s.dir[t][0], step));
      const float y = __fadd_rn(s.pos[t][1], __fmul_rn(s.dir[t][1], step));
      const float z = __fadd_rn(s.pos[t][2], __fmul_rn(s.dir[t][2], step));
      s.pos[t][0] = x;
      s.pos[t][1] = y;
      s.pos[t][2] = z;
      const bool outside =
          shadow ? y > s.escape[t]
                 : __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z)) > radius_sq;
      if (active && d > 0.f && d < threshold)
        s.status[t] = HIT;
      else if (active && outside)
        s.status[t] = MISS;
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < rows * 3; i += THREADS) pts_out[p0 * 3 + i] = s.pos[i / 3][i % 3];
  if (threadIdx.x < rows) status_out[p0 + threadIdx.x] = s.status[threadIdx.x];
}

}  // namespace

extern "C" int sdf_trace_steps(const void* pts, const void* dirs, const void* status,
                               const void* escape, const void* w1p, const void* w5p,
                               const void* zz1, const void* zz5, const void* w, const void* bias,
                               const void* w8, void* pts_out, void* status_out, int n, int k,
                               int shadow, float threshold, float step_clamp, float sdf_offset,
                               float radius, float radius_sq, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0 || k < 0) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(sdf_trace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(TraceSmem)));
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(n) + BLOCK_M - 1) / BLOCK_M);
  using bf = __nv_bfloat16;
  sdf_trace_kernel<<<blocks, THREADS, sizeof(TraceSmem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(dirs),
      static_cast<const int*>(status), static_cast<const float*>(escape),
      static_cast<const bf*>(w1p), static_cast<const bf*>(w5p), static_cast<const bf*>(zz1),
      static_cast<const bf*>(zz5), static_cast<const bf*>(w), static_cast<const bf*>(bias),
      static_cast<const bf*>(w8), static_cast<float*>(pts_out), static_cast<int*>(status_out), n,
      k, shadow, threshold, step_clamp, sdf_offset, radius, radius_sq);
  return cudaGetLastError();
}
