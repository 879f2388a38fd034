// Grid forward of the 8x256 SDF MLP: B shape latents over one shared point
// grid -> [B, P] float32 SDF values (B1), optionally also writing h-chain
// positions (0-indexed into h1..h7) to one [B, P, 256] bf16 plane each, row
// shape * P + p, for the stash backward (B5a; sdf_grid_bwd.cu reads them).
//
// Replaces the Pallas TPU kernels `_kernel` (launched by apply_grid_fused)
// and `_stash_fwd_kernel` (launched by `_stash_fwd_call`, the forward of
// apply_grid_trainable_stash) in shapegan_tpu/ops/sdf_mlp_pallas.py. Both
// run one kernel template here: B1 is its instance without the stash
// (kStash false), and B5a's products and epilogues are B1's, so its output
// equals B1's bit for bit; only the copies to the planes differ. As in the
// TPU kernels, the fan-in projections are done outside the kernel:
// pp1/pp5 = pts @ w1p / w5p ([P, 256] bf16, shared by all shapes) and
// zz1/zz5 = z @ w1z / w5z + b ([B, 256] bf16, one row per shape). The
// per-point latent repeat is never materialized: a tile's rows are points
// of one shape, its layer-1 input is relu(pp1[points] + zz1[shape]), and
// layer 5 re-injects pp5[points] + zz5[shape].
//
// What bounds it on the H100: the six 256 x 256 bf16 products a row, 3.3 ms
// at 16 x 64^3 (device-memory traffic is the 1 KB of pp1 and pp5 a point,
// read once per point tile and then from L2 for the other shapes, and 4
// bytes out a row). B5a adds B * P * 512 bytes written a stashed position
// (2.15 GB a plane at 16 x 64^3): with all six of h2..h7 stashed its bound
// is the bytes. The design is the persistent, warp-specialized wgmma trunk
// of sdf_trunk_sm90.cuh, as B3's, over the tiles of sdf_rows_sm90.cuh:
//
// * One block per SM; two consumer warpgroups in ping-pong take 64-row
//   tiles (tile t: shape t % B, points 64 (t / B) on: a point tile's B
//   tiles run back to back, so its pp1 and pp5 rows come from L2 after the
//   first), one producer thread cycles the 24 K-slices of w through the
//   TMA ring, never restarting.
// * The activations stay in registers as the wgmma A operand. pp1 and pp5
//   are read as bf16 pairs a row into the A registers (pp5 once layer 5's
//   products are done, when the registers are free); zz1 and zz5 a tile,
//   from the tile's shape row.
// * B5a: each stashed position's 64 x 256 tile is staged by stmatrix into
//   the consumer's staging tile, and each warp copies its 16 rows out once
//   the next layer's products are queued (sdf_rows_sm90.cuh). The ring
//   drops to 4 stages; its other two 32 KB slots are the staging tiles.
//
// Rounding points: `_kernel`'s (the trunk header's epilogue, as B3):
// h1 = relu(pp1 + zz1) rounded once; each trunk product rounded to bf16
// before the bias is added, the sum rounded; layer 5 adds pp5 and rounds,
// then zz5 and rounds; relu; the head tanh(h7 . w8 + b8) in float32.
#include "sdf_rows_sm90.cuh"

namespace {

using sdf90::bf16;
using sdf90::CONSUMERS;
using sdf90::Consumer;
using sdf90::LAYERS;
using sdf90::Pending;
using sdf90::Ring;
using sdf90::ROWS;
using sdf90::Rows;
using sdf90::SKIP_LAYER;
using sdf90::WIDTH;

constexpr int HIDDEN = LAYERS + 1;  // h1..h7
constexpr int SLOTS = 6;            // 32 KB slots: the ring's stages, then B5a's staging tiles

// The weight ring's depth: B1 keeps all six slots for it, B5a gives two to
// the consumers' staging tiles.
template <bool kStash>
constexpr int RING_STAGES = kStash ? SLOTS - CONSUMERS : SLOTS;

template <int STAGES>
struct __align__(1024) Smem {
  bf16 ring[SLOTS][WIDTH * sdf90::K_CHUNK];  // stages 0 .. STAGES - 1; then staging tiles
  float bias[LAYERS + 1][WIDTH];             // rows b2, b3, b4, <unused>, b6, b7, b8 broadcast
  float w8[WIDTH];
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
  int done;
};
static_assert(sizeof(Smem<SLOTS>) + 1024 <= 232448, "the block's shared memory");
static_assert(sdf90::ROWS * WIDTH == WIDTH * sdf90::K_CHUNK, "a staging tile fills one slot");

// The launch's operands (a __grid_constant__ parameter).
struct Args {
  const bf16* pp1;   // [P, 256]
  const bf16* pp5;
  const bf16* zz1;   // [B, 256]
  const bf16* zz5;
  const bf16* bias;  // [8, 256]
  const bf16* w8;    // [256]
  float* out;        // [B, P]
  bf16* plane[HIDDEN];  // B5a: [B, P, 256] a stashed position, nullptr elsewhere
  long long tiles;      // 64-row tiles: ceil(P / 64) x B
  int shapes, points;
};

// Stash position j's tile (the packed activations a) staged for its plane,
// or nothing (B1, or j not stashed).
template <bool kStash>
__device__ __forceinline__ Pending kept(const Consumer& c, const Rows& r, const uint32_t (&a)[16][4],
                                        bf16* plane) {
  if (!kStash || plane == nullptr) return {nullptr, 0};
  return sdf90::stage(c, r, a, plane);
}

// trunk_epilogue's skip term: none (kBias, kHead) ...
struct NoSkip {
  __device__ __forceinline__ float2 operator()(int, int, int) const { return make_float2(0.f, 0.f); }
};

// ... or the row's pp5 pair from the A registers (sdf90::RegisterPair).

// Trunk layer L (0..5: w2..w7) of a tile after its products d: the
// epilogue into a (h_{L+2}), staged for stash position L + 1. Layer 5 is the
// skip layer: pp5 comes first into the free A registers.
template <bool kStash, int L, class S>
__device__ __forceinline__ Pending hidden(const S& s, const Args& g, const Consumer& c, const Rows& r,
                                          const float (&d)[128], uint32_t (&a)[16][4]) {
  if (L == SKIP_LAYER) {
    const bf16* z5 = g.zz5 + static_cast<size_t>(r.shape) * WIDTH;
    sdf90::load_tile(a, g.pp5, r.point, r);
    sdf90::trunk_epilogue<sdf90::kSkip>(d, a, sdf90::ShapePair{z5}, sdf90::RegisterPair{a}, s.w8, &s.bias[LAYERS][0]);
  } else {
    sdf90::trunk_epilogue<sdf90::kBias>(d, a, sdf90::RowPair{s.bias[L]}, NoSkip{}, s.w8, &s.bias[LAYERS][0]);
  }
  return kept<kStash>(c, r, a, g.plane[L + 1]);
}

template <bool kStash, class S, int N>
__device__ __forceinline__ void tile(S& s, const Args& g, const Consumer& c, Ring<N>& pos, long long t) {
  const Rows r = sdf90::rows_of(t, g.shapes, g.points, g.tiles);
  uint32_t a[16][4];
  float d[128];
  // Layer 1: h1 = relu(pp1 + zz1), rounded once (stash position 0).
  sdf90::load_tile(a, g.pp1, r.point, r);
  const sdf90::ShapePair z1{g.zz1 + static_cast<size_t>(r.shape) * WIDTH};
  const int q2 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float2 z = z1(8 * i + q2);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      uint32_t& x = a[i / 2][2 * (i % 2) + hh];
      const float2 p = sdf90::unpack_bf16(x);
      x = sdf90::relu_bf16(sdf90::pack_bf16(p.x + z.x, p.y + z.y));
    }
  }
  // Each epilogue stages its position's tile; the next products copy it out.
  Pending p = kept<kStash>(c, r, a, g.plane[0]);
  const auto copy = [&] {
    if (kStash) sdf90::copy_out(c, p);
  };
  sdf90::layer_products(s, c.wg, pos, a, d, copy);
  p = hidden<kStash, 0>(s, g, c, r, d, a);
  sdf90::layer_products(s, c.wg, pos, a, d, copy);
  p = hidden<kStash, 1>(s, g, c, r, d, a);
  sdf90::layer_products(s, c.wg, pos, a, d, copy);
  p = hidden<kStash, 2>(s, g, c, r, d, a);
  sdf90::layer_products(s, c.wg, pos, a, d, copy);
  p = hidden<kStash, 3>(s, g, c, r, d, a);
  sdf90::layer_products(s, c.wg, pos, a, d, copy);
  p = hidden<kStash, 4>(s, g, c, r, d, a);
  sdf90::layer_products(s, c.wg, pos, a, d, copy);
  // Layer 7 and the head; B5a packs h7 too and copies it out at once (the
  // next products are the next tile's).
  const float2 v = sdf90::trunk_epilogue<sdf90::kHead, kStash>(d, a, sdf90::RowPair{s.bias[LAYERS - 1]}, NoSkip{},
                                                               s.w8, &s.bias[LAYERS][0]);
  if (kStash) sdf90::copy_out(c, kept<kStash>(c, r, a, g.plane[LAYERS]));
  const int q = threadIdx.x & 3;
  sdf90::store_f32(g.out + r.row, v.x, r.ok(0) && q == 0);
  sdf90::store_f32(g.out + r.row + 8, v.y, r.ok(1) && q == 1);
}

template <bool kStash>
__global__ void __launch_bounds__(sdf90::THREADS, 1)
sdf_grid_kernel(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ Args args) {
  constexpr int STAGES = RING_STAGES<kStash>;
  extern __shared__ unsigned char smem_raw[];
  Smem<STAGES>& s = sdf90::aligned_smem<Smem<STAGES>>(smem_raw);
  sdf90::to_float(s.bias[0], args.bias, (LAYERS + 1) * WIDTH);
  sdf90::to_float(s.w8, args.w8, WIDTH);
  if (threadIdx.x == 0) sdf90::ring_init<STAGES>(s, &wmap);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    sdf90::producer_start();
    if (threadIdx.x == sdf90::PRODUCER_THREAD) sdf90::produce<STAGES>(s, &wmap);
  } else {
    sdf90::consumer_start(wg);
    Consumer c{wg, 0u, 0u};
    if constexpr (kStash) c = {wg, sdf90::stage_base(s.ring[STAGES + wg]), sdf90::copy_base(s.ring[STAGES + wg])};
    Ring<STAGES> pos;
    for (long long t = 2LL * blockIdx.x + wg;; t += 2LL * gridDim.x) {
      if (!sdf90::consumers_any(t < args.tiles)) break;
      tile<kStash>(s, args, c, pos, t);
    }
    sdf90::consumer_finish(s, wg);
  }
}

template <bool kStash>
int launch_grid(const void* w, Args args, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (args.shapes <= 0 || args.points <= 0) return cudaErrorInvalidValue;
  CUtensorMap wmap;
  if ((err = sdf90::weight_map(&wmap, w)) != cudaSuccess) return err;
  const int smem = static_cast<int>(sizeof(Smem<RING_STAGES<kStash>>)) + 1024;
  err = cudaFuncSetAttribute(sdf_grid_kernel<kStash>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  args.tiles = (static_cast<long long>(args.points) + ROWS - 1) / ROWS * args.shapes;
  const long long pairs = (args.tiles + CONSUMERS - 1) / CONSUMERS;
  const unsigned blocks = static_cast<unsigned>(pairs < sms ? pairs : sms);
  sdf_grid_kernel<kStash><<<blocks, sdf90::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(wmap, args);
  return cudaGetLastError();
}

Args grid_args(const void* pp1, const void* pp5, const void* zz1, const void* zz5, const void* bias,
               const void* w8, void* out, int batch, int points) {
  Args args{};
  args.pp1 = static_cast<const bf16*>(pp1);
  args.pp5 = static_cast<const bf16*>(pp5);
  args.zz1 = static_cast<const bf16*>(zz1);
  args.zz5 = static_cast<const bf16*>(zz5);
  args.bias = static_cast<const bf16*>(bias);
  args.w8 = static_cast<const bf16*>(w8);
  args.out = static_cast<float*>(out);
  args.shapes = batch;
  args.points = points;
  return args;
}

}  // namespace

// B1.
extern "C" int sdf_grid_forward(const void* pp1, const void* pp5, const void* zz1,
                                const void* zz5, const void* w, const void* bias, const void* w8,
                                void* out, int batch, int points, int device, void* stream) {
  return launch_grid<false>(w, grid_args(pp1, pp5, zz1, zz5, bias, w8, out, batch, points), device, stream);
}

// B5a. `stash`: HIDDEN plane pointers, NULL for a position that is not
// stashed.
extern "C" int sdf_grid_stash_forward(const void* pp1, const void* pp5, const void* zz1,
                                      const void* zz5, const void* w, const void* bias,
                                      const void* w8, void* out, void* const* stash, int batch,
                                      int points, int device, void* stream) {
  Args args = grid_args(pp1, pp5, zz1, zz5, bias, w8, out, batch, points);
  for (int j = 0; j < HIDDEN; ++j) args.plane[j] = static_cast<bf16*>(stash[j]);
  return launch_grid<true>(w, args, device, stream);
}

extern "C" const char* sdf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
