// Passes 2-4 of the grid backward (B2, and the stash backward B5b) on Hopper:
// after the rows pass has written a chunk's scratch (h1..h7 and dz1..dz6 in
// bf16, dx1 and gz in float32; for B5b the stashed h planes are read in
// place), they make what `_bwd_kernel` (shapegan_tpu/ops/sdf_mlp_pallas.py)
// makes after its rebuild and its dh sweep:
//   d_w [6, 256(in), 256(out)] = h_l^T dz_l, d_b [8, 256] (column sums of
//   dz_l; row 3, the skip layer, stays 0), d_w8 = h7^T gz, d_b8 = sum gz,
//   d_zz1 / d_zz5 [B, 256] (dx1 / dz5 summed over points), d_pp1 / d_pp5
//   [P, 256] (summed over shapes),
// all float32, accumulated over the chunks of a call. The rowwise backward
// (B6b, sdf_rowwise_bwd.cu) runs the weight kernel and its finishes
// (weight_passes) on its own rows pass's planes, and sums d_w8 and d_b8
// itself: it has no d_pp and no sums over shapes.
//
// What bounds them on the H100: the bytes. Per row they read h1..h7 and
// dz1..dz6 (13 x 512 B), dx1 (1,024 B) and gz (4 B): 7,684 B, 32.2 GB at
// 16 x 64^3, 9.6 ms at 3.35 TB/s; the 3.3 TFLOP of weight products take
// 3.3 ms at the bf16 peak. The TPU kernel keeps one float32 dW block in VMEM
// across a grid that runs in order; here blocks run in no order, so each
// sum goes into per-item partials that a finish adds up in one fixed order.
// No atomics: the result is the same from run to run. Two kernels:
//
// * The weight kernel (weight_kernel). Work items are (layer l, half of the
//   256 input features, slab of the chunk's rows): 6 x 2 x SLABS = 132, one
//   per SM. One persistent block per SM, two consumer warpgroups and a
//   producer warp. The producer's one thread keeps a 4-stage ring of
//   KT-row tiles under full/empty mbarriers: per stage, by TMA with
//   128-byte swizzle, the two 64-column boxes of h_l the consumers need and
//   the four boxes of dz_l (all 256 output features). Both operands arrive
//   row-major over K (the rows): A = h_l^T is M-major and B = dz_l is
//   N-major. They stay in shared memory and go to
//   wgmma.mma_async.m64n256k16 through MN-major descriptors (the transpose
//   bits set; LBO the stride between 64-feature boxes, SBO the 1,024 bytes
//   between 8-row groups), so no registers hold operands: each consumer
//   holds only its m64n256 float32 slice of d_w[l] (128 registers a
//   thread). The two items of a (layer, slab) run side by side on
//   neighbouring blocks, so dz_l's second read mostly comes from L2. The
//   rows past the chunk's end are zero-filled by the tensor maps' bounds
//   (one map per plane, R rows). While the products of a tile run, the
//   consumers take the column sums of the dz tile already in shared memory
//   (d_b: each warpgroup half the tile's rows, a partial each), so d_b
//   re-reads nothing from device memory.
// * The fan-in kernel (fan_in_kernel). Each block owns 64 points and walks
//   the chunk's shapes in order, as `_bwd_kernel` does. It reads dz5, dx1,
//   h7 and gz of its rows once: d_pp5 and d_pp1 take their sums over the
//   chunk's shapes (added to the values of the earlier chunks, loaded
//   first), and per (shape, block) partials of d_zz5 and d_zz1, per block
//   partials of d_w8 and d_b8, go to scratch. d_w8 and d_b8 are here, not in
//   the weight kernel: h7 and gz are the fan-in's rows, and a tile of them
//   in the weight kernel's ring would cost a stage.
// * Finishes: the d_w and d_b partials in slab order (bwd_finish_kernel),
//   the fan-in's partials in a fixed two-level order (tree_finish_kernel).
// Both operands come from shared memory, not A from registers by
// ldmatrix.trans: wgmma's B is always in shared memory, so it needs the
// MN-major layout anyway, and with A there too the consumers issue no loads
// and keep their registers for the accumulators. At 16 x 64^3 on the H100
// (700 W) the passes take ~18.5 ms of device time in a B2 call, 0.53 of
// their bound's rate: the weight kernel ~8.5 ms (its 25.8 GB at ~3.0 TB/s),
// the fan-in ~9.1 (8.6 GB read once and 17.2 GB of d_pp read-modify-write
// over the 16 one-shape chunks, at ~2.8 TB/s), the finishes ~0.8
// (parent_ab.py, kernel_variants.py passes; PERF.md, section 6).
#pragma once

#include <array>

#include "sdf_bwd_passes.cuh"
#include "sdf_trunk_sm90.cuh"

namespace {  // each source that includes this has its own copy of the kernels
namespace sdf90_passes {

using bf16 = __nv_bfloat16;
using sdf90::CONSUMERS;
using sdf90::LAYERS;
using sdf90::WIDTH;

constexpr int KT = 64;                         // rows of one ring stage
constexpr int STAGES = 4;                      // depth of the ring
constexpr int BOX_COLS = 64;                   // one TMA box: KT rows x 64 columns (128 bytes)
constexpr int BOX_BYTES = KT * BOX_COLS * 2;   // 8 KB
constexpr int N_BOXES = WIDTH / BOX_COLS;      // dz_l's boxes
constexpr int HALF = CONSUMERS * BOX_COLS;     // input features of one item
constexpr int STAGE_BYTES = (CONSUMERS + N_BOXES) * BOX_BYTES;
constexpr int SLABS = 11;                      // row slabs of a chunk: 6 x 2 x 11 = 132 items
constexpr int ITEMS = LAYERS * (WIDTH / HALF) * SLABS;
constexpr int THREADS = 128 * (CONSUMERS + 1);  // consumers first, then the producer
constexpr int PRODUCER_THREAD = 128 * CONSUMERS;

struct __align__(1024) Smem {
  bf16 a[STAGES][CONSUMERS][KT * BOX_COLS];  // h_l: each consumer's 64 input features
  bf16 b[STAGES][N_BOXES][KT * BOX_COLS];    // dz_l: all 256 output features
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};
static_assert(sizeof(Smem) + 1024 <= 232448, "the block's shared memory");

// The tensor maps of a chunk's planes (a __grid_constant__ parameter): h_l
// and dz_l, l = 0..5, each [R rows, 256] bf16 in boxes of KT x 64.
struct Maps {
  CUtensorMap h[LAYERS];
  CUtensorMap dz[LAYERS];
};

struct WeightArgs {
  float* w_part;  // [6][SLABS][256][256]: d_w[l]'s partial of slab s
  float* b_part;  // [6][SLABS][CONSUMERS][256]: d_b[l]'s partials of slab s
  int tiles;      // KT-row tiles of the chunk
  int slab_tiles; // tiles of one slab (the last may have fewer, or none)
};

// Item i: half i % 2, slab (i / 2) % SLABS, layer i / (2 SLABS): the two
// halves of a (layer, slab) are neighbours.
struct Item {
  int layer, half, slab, t0, t1;
};

__device__ __forceinline__ Item item_of(int i, const WeightArgs& g) {
  Item it;
  it.half = i % 2;
  it.slab = (i / 2) % SLABS;
  it.layer = i / (2 * SLABS);
  it.t0 = min(it.slab * g.slab_tiles, g.tiles);
  it.t1 = min(it.t0 + g.slab_tiles, g.tiles);
  return it;
}

// One box (64 columns from col, KT rows from row) of `map` into dst,
// completing on bar; rows past the map's end arrive as zeros.
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map, int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(sdf90::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(sdf90::smem_addr(bar)), "r"(col), "r"(row)
      : "memory");
}

// Descriptor of an MN-major operand of 128-byte swizzled boxes (each KT rows
// of 128 bytes, 1024-byte aligned, BOX_BYTES apart along M or N): LBO the
// stride between boxes, SBO the stride between 8-row groups. Adding 128
// advances K by 16 rows (2,048 bytes).
__device__ __forceinline__ uint64_t mn_desc(const void* box) {
  return static_cast<uint64_t>((sdf90::smem_addr(box) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(BOX_BYTES >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 256, float32) += A (64 x 16) * B (16 x 256), both read from
// shared memory through MN-major descriptors (imm-trans-a = imm-trans-b = 1).
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// The consumer warpgroup frees a stage when `ok` (one arrival a warpgroup;
// predicated in the instruction, not branched, as sdf90::release).
__device__ __forceinline__ void release_if(Smem& s, int stage, bool ok) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(sdf90::smem_addr(&s.empty[stage])),
      "r"((threadIdx.x & 127) | (ok ? 0u : 1u))
      : "memory");
}

// Adds rows row0 .. row0 + KT/2 - 1 of a stage's dz tile (its four boxes,
// from `tile`) at the thread's columns 2t and 2t + 1 (t: its index in the
// warpgroup) to cs, in row order. Warp w reads box w, a whole 128-byte row
// a step: no bank conflicts.
__device__ __forceinline__ void column_sums(const bf16* tile, int row0, float2& cs) {
  const int t = threadIdx.x & 127;
  const unsigned char* box = reinterpret_cast<const unsigned char*>(tile) + (t >> 5) * BOX_BYTES;
  const int chunk = (t & 31) >> 2, byte = (t & 3) * 4;
#pragma unroll 8
  for (int k = row0; k < row0 + KT / 2; ++k) {
    const float2 v = sdf90::unpack_bf16(
        *reinterpret_cast<const uint32_t*>(box + k * 128 + ((chunk ^ (k & 7)) << 4) + byte));
    cs.x += v.x;
    cs.y += v.y;
  }
}

// The producer's one thread: each item's tiles in order through the ring.
// Every fill is consumed, so the block cannot exit with copies in flight.
__device__ __forceinline__ void produce(Smem& s, const Maps& m, const WeightArgs& g) {
  sdf90::Ring<STAGES> pos;
  int issued = 0;
  for (int i = blockIdx.x; i < ITEMS; i += gridDim.x) {
    const Item it = item_of(i, g);
    for (int tile = it.t0; tile < it.t1; ++tile, ++issued) {
      if (issued >= STAGES) sdf90::bar_wait(&s.empty[pos.stage], pos.phase ^ 1u);
      uint64_t* bar = &s.full[pos.stage];
      sdf90::bar_expect(bar, STAGE_BYTES);
      const int row = tile * KT;
      for (int c = 0; c < CONSUMERS; ++c)
        load_box(s.a[pos.stage][c], &m.h[it.layer], HALF * it.half + BOX_COLS * c, row, bar);
      for (int j = 0; j < N_BOXES; ++j) load_box(s.b[pos.stage][j], &m.dz[it.layer], BOX_COLS * j, row, bar);
      pos.next();
    }
  }
}

// Consumer warpgroup wg: per item, its 64 x 256 slice of d_w[l] (input
// features HALF half + 64 wg ...) over the slab's tiles; meanwhile the
// column sums of each dz tile's half wg. Accumulator d[4 j + 2 h + e]: row
// 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e.
__device__ __forceinline__ void consume(Smem& s, const WeightArgs& g, int wg) {
  sdf90::Ring<STAGES> pos;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  for (int i = blockIdx.x; i < ITEMS; i += gridDim.x) {
    const Item it = item_of(i, g);
    float d[128];
#pragma unroll
    for (int j = 0; j < 128; ++j) d[j] = 0.f;
    sdf90::fence_operand(d);
    float2 cs = make_float2(0.f, 0.f);
    int last = 0;
    for (int tile = it.t0; tile < it.t1; ++tile) {
      sdf90::bar_wait(&s.full[pos.stage], pos.phase);
      sdf90::wgmma_fence();
      const uint64_t da = mn_desc(s.a[pos.stage][wg]), db = mn_desc(s.b[pos.stage][0]);
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) wgmma_ss(d, da + 128 * kk, db + 128 * kk);
      sdf90::wgmma_commit();
      column_sums(s.b[pos.stage][0], wg * (KT / 2), cs);
      sdf90::wgmma_wait<1>();
      release_if(s, last, tile > it.t0);  // the previous tile's products are done
      last = pos.stage;
      pos.next();
    }
    sdf90::wgmma_wait<0>();
    sdf90::fence_operand(d);
    release_if(s, last, it.t1 > it.t0);
    float* out = g.w_part + static_cast<size_t>(it.layer * SLABS + it.slab) * WIDTH * WIDTH;
    const int m0 = HALF * it.half + BOX_COLS * wg + 16 * warp + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(m0 + 8 * h) * WIDTH + 8 * j + 2 * (lane & 3)) =
            make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    if (it.half == 0)  // both halves read the same dz tiles: one keeps the sums
      *reinterpret_cast<float2*>(g.b_part + (static_cast<size_t>(it.layer * SLABS + it.slab) * CONSUMERS + wg) *
                                                WIDTH + 2 * t) = cs;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
weight_kernel(const __grid_constant__ Maps maps, const __grid_constant__ WeightArgs args) {
  extern __shared__ unsigned char smem_raw[];
  Smem& s = sdf90::aligned_smem<Smem>(smem_raw);
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      sdf90::bar_init(&s.full[i], 1);
      sdf90::bar_init(&s.empty[i], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    sdf90::producer_start();
    if (threadIdx.x == PRODUCER_THREAD) produce(s, maps, args);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consume(s, args, wg);
  }
}

// ------------------------------------------------------------- the fan-in

constexpr int FAN_POINTS = 64;                       // points of one block
constexpr int FAN_QUADS = WIDTH / 4;                 // threads along a row: four columns each
constexpr int FAN_GROUPS = 8;                        // row groups of a block
constexpr int FAN_RUN = FAN_POINTS / FAN_GROUPS;     // points of one group
constexpr int FAN_THREADS = FAN_QUADS * FAN_GROUPS;

// Partials of the fan-in (floats, in this order): d_zz5 [shapes][blocks][256],
// d_zz1 [shapes][blocks][256], d_w8 [blocks][256], d_b8 [blocks].
struct FanArgs {
  const bf16* dz5;   // the chunk's rows [R, 256]: dz plane 3
  const float* dx1;  // [R, 256]
  const bf16* h7;    // [R, 256]
  const float* gz;   // [R]
  float* pp1;        // [P, 256]: accumulated over the chunks
  float* pp5;
  float* part;
  int shapes, points, blocks;
};

__device__ __forceinline__ float4 bf16x4(uint2 v) {
  const float2 lo = sdf90::unpack_bf16(v.x), hi = sdf90::unpack_bf16(v.y);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void add4(float4& a, const float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__device__ __forceinline__ float sum_groups(float (*sums)[3][WIDTH], int which, int col) {
  float t = 0.f;
#pragma unroll
  for (int g = 0; g < FAN_GROUPS; ++g) t += sums[g][which][col];
  return t;
}

// Block b owns points 64 b ... 64 b + 63; thread (group, quad): the group's 8
// points at columns 4 quad ... 4 quad + 3. d_pp takes each point's values
// shape by shape in order, after the earlier chunks' sum; a group's sums
// over its points go to shared memory and are added up in group order.
__global__ void __launch_bounds__(FAN_THREADS, 1) fan_in_kernel(const FanArgs a) {
  __shared__ float sums[FAN_GROUPS][3][WIDTH];
  __shared__ float sums_b8[FAN_GROUPS];
  const int q = threadIdx.x % FAN_QUADS, grp = threadIdx.x / FAN_QUADS, c = 4 * q;
  const int p0 = blockIdx.x * FAN_POINTS + grp * FAN_RUN;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 pp1[FAN_RUN], pp5[FAN_RUN];
#pragma unroll
  for (int i = 0; i < FAN_RUN; ++i) {
    const bool ok = p0 + i < a.points;
    const size_t o = static_cast<size_t>(ok ? p0 + i : 0) * WIDTH + c;
    pp1[i] = ok ? *reinterpret_cast<const float4*>(a.pp1 + o) : zero;
    pp5[i] = ok ? *reinterpret_cast<const float4*>(a.pp5 + o) : zero;
  }
  float4 w8 = zero;
  float b8 = 0.f;
  for (int s = 0; s < a.shapes; ++s) {
    float4 z1 = zero, z5 = zero;
#pragma unroll
    for (int i = 0; i < FAN_RUN; ++i) {
      if (p0 + i >= a.points) continue;
      const size_t row = static_cast<size_t>(s) * a.points + p0 + i;
      const float4 d5 = bf16x4(*reinterpret_cast<const uint2*>(a.dz5 + row * WIDTH + c));
      const float4 d1 = *reinterpret_cast<const float4*>(a.dx1 + row * WIDTH + c);
      const float4 h = bf16x4(*reinterpret_cast<const uint2*>(a.h7 + row * WIDTH + c));
      const float gz = a.gz[row];
      add4(pp5[i], d5);
      add4(pp1[i], d1);
      add4(z5, d5);
      add4(z1, d1);
      add4(w8, make_float4(h.x * gz, h.y * gz, h.z * gz, h.w * gz));
      b8 += gz;
    }
    *reinterpret_cast<float4*>(&sums[grp][0][c]) = z5;
    *reinterpret_cast<float4*>(&sums[grp][1][c]) = z1;
    __syncthreads();
    for (int j = threadIdx.x; j < 2 * WIDTH; j += FAN_THREADS) {
      const int which = j / WIDTH, col = j % WIDTH;
      a.part[((static_cast<size_t>(which) * a.shapes + s) * a.blocks + blockIdx.x) * WIDTH + col] =
          sum_groups(sums, which, col);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < FAN_RUN; ++i) {
    if (p0 + i >= a.points) continue;
    const size_t o = static_cast<size_t>(p0 + i) * WIDTH + c;
    *reinterpret_cast<float4*>(a.pp1 + o) = pp1[i];
    *reinterpret_cast<float4*>(a.pp5 + o) = pp5[i];
  }
  *reinterpret_cast<float4*>(&sums[grp][2][c]) = w8;
  if (q == 0) sums_b8[grp] = b8;
  __syncthreads();
  const size_t zz = static_cast<size_t>(a.shapes) * a.blocks * WIDTH;
  if (threadIdx.x < WIDTH)
    a.part[2 * zz + static_cast<size_t>(blockIdx.x) * WIDTH + threadIdx.x] = sum_groups(sums, 2, threadIdx.x);
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int g = 0; g < FAN_GROUPS; ++g) t += sums_b8[g];
    a.part[2 * zz + static_cast<size_t>(a.blocks) * WIDTH + blockIdx.x] = t;
  }
}

// dst[g n + i] += the sum over p < parts of part[(g parts + p) n + i],
// g = blockIdx.y, in one fixed order: lane l of 32 sums the parts p = l,
// l + 32, ... in order, then the 32 lane sums are added in lane order.
__global__ void __launch_bounds__(1024) tree_finish_kernel(const float* __restrict__ part, int parts, int n,
                                                           float* __restrict__ dst) {
  __shared__ float lanes[32][33];
  const int col = threadIdx.x & 31, lane = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + col;
  const float* src = part + static_cast<size_t>(blockIdx.y) * parts * n + i;
  float sum = 0.f;
  if (i < n)
    for (int p = lane; p < parts; p += 32) sum += src[static_cast<size_t>(p) * n];
  lanes[lane][col] = sum;
  __syncthreads();
  if (lane == 0 && i < n) {
    float t = 0.f;
    for (int l = 0; l < 32; ++l) t += lanes[l][col];
    dst[static_cast<size_t>(blockIdx.y) * n + i] += t;
  }
}

// ---------------------------------------------------------------- host

// The TMA map of one [rows, 256] bf16 plane in boxes of KT rows x 64
// columns, 128-byte swizzled; rows past the end read as zeros.
inline cudaError_t plane_map(CUtensorMap* map, const bf16* plane, long long rows) {
  sdf90::EncodeTiledFn encode;
  const cudaError_t err = sdf90::tiled_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {WIDTH, static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {WIDTH * sizeof(bf16)};
  const cuuint32_t box[2] = {BOX_COLS, KT};
  const cuuint32_t element_strides[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(plane), dims, strides,
                            box, element_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline int fan_blocks(int points) { return (points + FAN_POINTS - 1) / FAN_POINTS; }

// Floats of the weight kernel's partials: d_w's, d_b's; and of a grid
// chunk's column partials (d_b's, then the fan-in's) for `shapes` shapes.
inline size_t weight_part_floats() { return static_cast<size_t>(LAYERS) * SLABS * WIDTH * WIDTH; }

inline size_t b_part_floats() { return static_cast<size_t>(LAYERS) * SLABS * CONSUMERS * WIDTH; }

inline size_t col_part_floats(int shapes, int points) {
  const size_t blocks = fan_blocks(points);
  return b_part_floats() + (2 * static_cast<size_t>(shapes) + 1) * blocks * WIDTH + blocks;
}

// The weight kernel over `rows` rows of the planes h1..h6 (h) and dz1..dz6
// (dz, one after another), then the fixed-order finishes of d_w and of d_b's
// rows 0-2 and 4-5 (row 3, the skip layer, stays 0: b5's gradient is the sum
// of zz5's), added into d_w and d_b. The partials' scratch (w_part:
// weight_part_floats(), b_part: b_part_floats()) is the caller's.
inline cudaError_t weight_passes(const HPlanes& h, const bf16* dz, long long rows, float* w_part, float* b_part,
                                 float* d_w, float* d_b, cudaStream_t stream) {
  const size_t plane = static_cast<size_t>(rows) * WIDTH;
  // The maps' key: the planes' addresses and the rows.
  static sdf90::LastOf<std::array<uintptr_t, LAYERS + 2>, Maps> plane_maps;
  static sdf90::OncePerDevice smem_limit;
  std::array<uintptr_t, LAYERS + 2> key;
  for (int l = 0; l < LAYERS; ++l) key[l] = reinterpret_cast<uintptr_t>(h.p[l]);
  key[LAYERS] = reinterpret_cast<uintptr_t>(dz);
  key[LAYERS + 1] = static_cast<uintptr_t>(rows);
  Maps maps;
  cudaError_t err = plane_maps.get(key, &maps, [&](Maps* m) {
    for (int l = 0; l < LAYERS; ++l) {
      cudaError_t e;
      if ((e = plane_map(&m->h[l], h.p[l], rows)) != cudaSuccess) return e;
      if ((e = plane_map(&m->dz[l], dz + l * plane, rows)) != cudaSuccess) return e;
    }
    return cudaSuccess;
  });
  if (err != cudaSuccess) return err;
  WeightArgs args;
  args.w_part = w_part;
  args.b_part = b_part;
  args.tiles = static_cast<int>(ceil_div(rows, KT));
  args.slab_tiles = static_cast<int>(ceil_div(args.tiles, SLABS));
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  const int smem = static_cast<int>(sizeof(Smem)) + 1024;
  err = smem_limit(device, [&] {
    return cudaFuncSetAttribute(weight_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  });
  if (err != cudaSuccess) return err;
  weight_kernel<<<std::min(ITEMS, sms), THREADS, smem, stream>>>(maps, args);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_finish_kernel<<<grid_for(LAYERS * WIDTH * WIDTH), FINISH_THREADS, 0, stream>>>(
      w_part, LAYERS, SLABS, WIDTH * WIDTH, d_w);
  const int b_parts = SLABS * CONSUMERS;
  bwd_finish_kernel<<<grid_for(3 * WIDTH), FINISH_THREADS, 0, stream>>>(b_part, 3, b_parts, WIDTH, d_b);
  bwd_finish_kernel<<<grid_for(2 * WIDTH), FINISH_THREADS, 0, stream>>>(
      b_part + static_cast<size_t>(4) * b_parts * WIDTH, 2, b_parts, WIDTH, d_b + 4 * WIDTH);
  return cudaGetLastError();
}

}  // namespace sdf90_passes
}  // namespace

namespace {

// The float32 outputs of a grid backward (B2, B5b), in the JAX package's
// layout; they accumulate over chunks.
struct GridGrads {
  float *pp1, *pp5, *zz1, *zz5, *w, *b, *w8, *b8;
};

// Zero a grid backward's outputs before its chunks accumulate into them.
inline cudaError_t zero_grid_grads(const GridGrads& out, int batch, int points, cudaStream_t stream) {
  const size_t pw = static_cast<size_t>(points) * WIDTH;
  const std::pair<float*, size_t> outputs[] = {
      {out.pp1, pw * 4}, {out.pp5, pw * 4}, {out.zz1, static_cast<size_t>(batch) * WIDTH * 4},
      {out.zz5, static_cast<size_t>(batch) * WIDTH * 4},
      {out.w, static_cast<size_t>(LAYERS) * WIDTH * WIDTH * 4}, {out.b, 8 * WIDTH * 4},
      {out.w8, WIDTH * 4}, {out.b8, 4}};
  for (const auto& o : outputs) {
    const cudaError_t err = cudaMemsetAsync(o.first, 0, o.second, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Passes 2-4 of one chunk of a grid backward (B2, B5b), after its rows pass:
// the chunk holds `shapes` whole shapes from shape s0 on, `points` rows each;
// h: its seven h planes, dz its six dz planes one after another. The
// partials' scratch (w_part: weight_part_floats(), col_part:
// col_part_floats()) is the caller's.
inline cudaError_t grid_bwd_passes(const HPlanes& h, const __nv_bfloat16* dz, const float* dx1,
                                   const float* gz, float* w_part, float* col_part, int shapes,
                                   int points, int s0, const GridGrads& out, cudaStream_t stream) {
  namespace P = sdf90_passes;
  const long long rows = static_cast<long long>(shapes) * points;
  const size_t plane = static_cast<size_t>(rows) * WIDTH;
  cudaError_t err = P::weight_passes(h, dz, rows, w_part, col_part, out.w, out.b, stream);
  if (err != cudaSuccess) return err;

  P::FanArgs fan;
  fan.dz5 = dz + SKIP_LAYER * plane;
  fan.dx1 = dx1;
  fan.h7 = h.p[LAYERS];
  fan.gz = gz;
  fan.pp1 = out.pp1;
  fan.pp5 = out.pp5;
  fan.part = col_part + P::b_part_floats();
  fan.shapes = shapes;
  fan.points = points;
  fan.blocks = P::fan_blocks(points);
  P::fan_in_kernel<<<fan.blocks, P::FAN_THREADS, 0, stream>>>(fan);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t zz = static_cast<size_t>(shapes) * fan.blocks * WIDTH;
  const dim3 per_shape(WIDTH / 32, shapes);
  P::tree_finish_kernel<<<per_shape, 1024, 0, stream>>>(fan.part, fan.blocks, WIDTH,
                                                        out.zz5 + static_cast<size_t>(s0) * WIDTH);
  P::tree_finish_kernel<<<per_shape, 1024, 0, stream>>>(fan.part + zz, fan.blocks, WIDTH,
                                                        out.zz1 + static_cast<size_t>(s0) * WIDTH);
  P::tree_finish_kernel<<<WIDTH / 32, 1024, 0, stream>>>(fan.part + 2 * zz, fan.blocks, WIDTH, out.w8);
  P::tree_finish_kernel<<<1, 1024, 0, stream>>>(fan.part + 2 * zz + static_cast<size_t>(fan.blocks) * WIDTH,
                                                fan.blocks, 1, out.b8);
  return cudaGetLastError();
}

}  // namespace
