// K masked sphere-trace iterations per launch over rays [N]: every lane
// takes exactly min(K, steps until it resolves) steps of the single-shape
// SDF forward, its state kept on chip between them.
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
// What bounds it on the H100: per lane-step the trunk's 6 x 2 x 256 x 256
// flops on the tensor cores (the points kernel's work, with which it shares
// the trunk of sdf_trunk_sm90.cuh); the lane state crosses device memory
// once (28 bytes in, 16 out). Only the lane-steps the rays need count:
// 39.47 M of the 51.2 M at 1600^2 x k=20 on the chair, 31.4 ms.
//
// The design against resolved lanes riding along: one persistent block per
// SM, each consumer warpgroup holding 64 lane slots (a slot: point,
// direction, escape height, its own step count, lane index). After each
// evaluation a slot whose lane has resolved or taken its K steps writes the
// lane out and takes the next lane index from a work counter in device
// memory (zeroed by the wrapper); a lane that is not ACTIVE on entry is
// written through unevaluated. Lanes are independent and each takes the
// same steps wherever it runs, so the result does not depend on which slot
// or block takes it, nor on the order. The block stops when the counter is
// spent and its slots are empty.
#include "sdf_trunk_sm90.cuh"

namespace {

using sdf90::ROWS;

constexpr int ACTIVE = 0, HIT = 1, MISS = 2;

struct Slot {
  float pos[3];
  float dir[3];
  float escape;
  int steps;
  int lane;  // -1: empty
};

struct TraceSmem {
  sdf90::Smem trunk;
  Slot slot[sdf90::CONSUMERS][ROWS];
};

// The rays and the trace's constants (a __grid_constant__ parameter: read
// in place, never copied).
struct Trace {
  const float* pts;
  const float* dirs;
  const int* status;
  const float* escape;  // shadow rays' escape heights, or null: radius
  float* pts_out;
  int* status_out;
  int* next;  // the work counter
  int n, k, shadow;
  float threshold, step_clamp, sdf_offset, radius, radius_sq;
};

// Fill `slot` with the next ACTIVE lane, writing the lanes that are not
// ACTIVE through on the way; empty once the counter is spent.
__device__ __forceinline__ void refill(Slot& slot, const Trace& r) {
  for (;;) {
    const int lane = atomicAdd(r.next, 1);
    if (lane >= r.n) {
      slot.lane = -1;
      for (int i = 0; i < 3; ++i) slot.pos[i] = 0.f;
      return;
    }
    const int st = r.status[lane];
    if (st != ACTIVE) {
      for (int i = 0; i < 3; ++i) r.pts_out[3LL * lane + i] = r.pts[3LL * lane + i];
      r.status_out[lane] = st;
      continue;
    }
    for (int i = 0; i < 3; ++i) {
      slot.pos[i] = r.pts[3LL * lane + i];
      slot.dir[i] = r.dirs[3LL * lane + i];
    }
    slot.escape = r.escape != nullptr ? r.escape[lane] : r.radius;
    slot.steps = 0;
    slot.lane = lane;
    return;
  }
}

// One trace step of the lane in `sl` given the SDF at its point; a lane
// that resolves or has taken its K steps is written out and the slot
// refilled. Out of line: none of the trunk's registers are live here.
__device__ __noinline__ void advance(Slot& sl, float sdf, const Trace& r) {
  const float d = fminf(fmaxf(__fadd_rn(sdf, r.sdf_offset), -r.step_clamp), r.step_clamp);
  const float x = __fadd_rn(sl.pos[0], __fmul_rn(sl.dir[0], d));
  const float y = __fadd_rn(sl.pos[1], __fmul_rn(sl.dir[1], d));
  const float z = __fadd_rn(sl.pos[2], __fmul_rn(sl.dir[2], d));
  sl.pos[0] = x;
  sl.pos[1] = y;
  sl.pos[2] = z;
  const bool outside =
      r.shadow ? y > sl.escape
               : __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z)) > r.radius_sq;
  const int st = d > 0.f && d < r.threshold ? HIT : outside ? MISS : ACTIVE;
  sl.steps += 1;
  if (st != ACTIVE || sl.steps >= r.k) {
    const long long lane = sl.lane;
    r.pts_out[3 * lane] = x;
    r.pts_out[3 * lane + 1] = y;
    r.pts_out[3 * lane + 2] = z;
    r.status_out[lane] = st;
    refill(sl, r);
  }
}

__device__ __noinline__ void first_fill(Slot& sl, const Trace& r) { refill(sl, r); }

__device__ __forceinline__ float3 rounded_pos(const Slot& slot) {
  return make_float3(sdf90::round_bf16(slot.pos[0]), sdf90::round_bf16(slot.pos[1]),
                     sdf90::round_bf16(slot.pos[2]));
}

__global__ void __launch_bounds__(sdf90::THREADS, 1)
sdf_trace_kernel(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ Trace trace,
                 const __nv_bfloat16* __restrict__ w1p, const __nv_bfloat16* __restrict__ w5p,
                 const __nv_bfloat16* __restrict__ zz1, const __nv_bfloat16* __restrict__ zz5,
                 const __nv_bfloat16* __restrict__ bias, const __nv_bfloat16* __restrict__ w8) {
  extern __shared__ unsigned char smem_raw[];
  TraceSmem& s = sdf90::aligned_smem<TraceSmem>(smem_raw);
  sdf90::setup(s.trunk, &wmap, bias, w8, w1p, w5p, zz1, zz5);

  const int wg = threadIdx.x / 128;
  if (wg == sdf90::CONSUMERS) {
    sdf90::producer_start();
    if (threadIdx.x == sdf90::PRODUCER_THREAD) sdf90::produce(s.trunk, &wmap);
  } else {
    sdf90::consumer_start(wg);
    const int t = threadIdx.x & 127, q = t & 3;
    const int r0 = (t >> 5) * 16 + ((t & 31) >> 2);
    // Lanes 0 and 1 of each quad keep the slots of rows r0 and r0 + 8.
    Slot* mine = q < 2 ? &s.slot[wg][r0 + 8 * q] : nullptr;
    if (mine != nullptr) first_fill(*mine, trace);
    sdf90::RingPos pos;
    while (sdf90::consumers_any(mine != nullptr && mine->lane >= 0)) {
      const float2 v = sdf90::evaluate(s.trunk, wg, pos, rounded_pos(s.slot[wg][r0]),
                                       rounded_pos(s.slot[wg][r0 + 8]));
      if (mine != nullptr && mine->lane >= 0) advance(*mine, q ? v.y : v.x, trace);
    }
    sdf90::consumer_finish(s.trunk, wg);
  }
}

}  // namespace

extern "C" int sdf_trace_steps(const void* pts, const void* dirs, const void* status,
                               const void* escape, const void* w1p, const void* w5p,
                               const void* zz1, const void* zz5, const void* w, const void* bias,
                               const void* w8, void* pts_out, void* status_out, void* counter, int n,
                               int k, int shadow, float threshold, float step_clamp, float sdf_offset,
                               float radius, float radius_sq, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0 || k <= 0) return cudaErrorInvalidValue;
  CUtensorMap wmap;
  err = sdf90::weight_map(&wmap, w);
  if (err != cudaSuccess) return err;
  const int smem = static_cast<int>(sizeof(TraceSmem)) + 1024;
  err = cudaFuncSetAttribute(sdf_trace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long tiles = (static_cast<long long>(n) + sdf90::BLOCK_ROWS - 1) / sdf90::BLOCK_ROWS;
  const unsigned blocks = static_cast<unsigned>(tiles < sms ? tiles : sms);
  const Trace trace{static_cast<const float*>(pts), static_cast<const float*>(dirs),
                    static_cast<const int*>(status), static_cast<const float*>(escape),
                    static_cast<float*>(pts_out), static_cast<int*>(status_out),
                    static_cast<int*>(counter), n, k, shadow, threshold, step_clamp, sdf_offset,
                    radius, radius_sq};
  using bf = __nv_bfloat16;
  sdf_trace_kernel<<<blocks, sdf90::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      wmap, trace, static_cast<const bf*>(w1p), static_cast<const bf*>(w5p), static_cast<const bf*>(zz1),
      static_cast<const bf*>(zz5), static_cast<const bf*>(bias), static_cast<const bf*>(w8));
  return cudaGetLastError();
}
