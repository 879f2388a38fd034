// The rows pass of the recompute grid backward (B2) on the Hopper trunk of
// sdf_trunk_sm90.cuh: for a chunk of whole shapes over the point grid it
// writes the scratch that the passes after it read (sdf_grid_bwd.cu's
// Layout): the h planes h1..h7 and the dz planes (bf16), dx1 (float32) and
// gz (float32), one row each per (shape, point). The stash backward (B5b)
// keeps the mma.sync rows kernel of sdf_grid_bwd.cu.
//
// What bounds it on the H100: per row it writes 3,584 bytes of h, 3,072 of
// dz, 1,024 of dx1 and 4 of gz and reads 1,028 (pp1, pp5, g): 8,712 bytes,
// 10.9 ms at 16 x 64^3 against 6.7 ms for its twelve 256 x 256 products. The
// design keeps everything but those bytes on chip:
//
// * wgmma, activations in registers. A consumer warpgroup owns a 64-row tile
//   and runs wgmma.mma_async.m64n256k16 with the A operand in registers, as
//   B3 does: the six rebuilt layers take K-slices of w ([out, in], K-major);
//   the six products dh = dz @ W^T take K-slices of wt ([in, out]: the
//   K-major operand for N = in, K = out) through a second tensor map.
// * One ring for both directions. The producer cycles 48 slices a tile
//   (w2..w7 from the w map, then w7..w2 from the wt map) through a 4-stage
//   TMA ring under the header's full/empty mbarriers, across tiles, never
//   restarting.
// * The masks on chip. The backward of the layer whose input is h_j needs
//   [h_j > 0] (j = 1..6). In the m64n256 accumulator layout a thread holds
//   the same (row, column) positions in the epilogue that made h_j and in
//   the one that masks by it, so each forward epilogue keeps its 128 bits
//   a thread in shared memory (4 words; 24 KB for the block) and the
//   backward epilogue reads them back. Reading the h planes back from
//   device memory would re-read 3 KB a row, and a tile's planes have left
//   the 50 MB L2 by then (each SM writes ~0.5 MB a tile pair).
// * Persistent, warp-specialized blocks. One block per SM; two consumer
//   warpgroups in ping-pong (named-barrier turns, as in the header) take
//   64-row tiles in the rows pass's order (tile t: shape t % shapes, points
//   64 (t / shapes) on), one producer warp feeds the ring. zz1 and zz5 are
//   read per tile (the shape changes); pp1, pp5 and g per row. A consumer
//   whose tile runs past the chunk computes on zero rows and stores none
//   (predicated loads and stores, no branch among the products).
// * The stores through shared memory, off the products' path. Each
//   epilogue writes its bf16 tile (an h or dz plane's 64 x 256) from the
//   packed A registers into the consumer's staging tile (16 stmatrix.x4 a
//   thread, 128-byte swizzled: free of bank conflicts); each warp copies its
//   own 16 rows out to the plane with 16-byte stores, one whole 512-byte
//   row a warp store, once the next layer's products are queued (only
//   __syncwarp between, no block barrier). dx1 (float32) and gz go by
//   predicated st.global from the registers. The ring is cut to 4 stages to
//   make room for the staging. At 16 x 64^3 on the H100 this reads ~29.7 ms
//   against ~13.5 without the global stores; storing each pair from the
//   registers read 37.5, TMA stores of the staged tiles or warp copies in
//   the epilogue 29.5-29.7 (kernel_variants.py; PERF.md, section 6).
//
// Rounding points: `_bwd_kernel`'s (shapegan_tpu/ops/sdf_mlp_pallas.py), not
// B3's: h1 = relu(pp1 + zz1) summed in float32 and rounded once; a rebuilt
// layer adds its bias to the float32 product and rounds once (layer 5:
// ((acc + pp5) + zz5), rounded once); the head is tanh(h7 . w8 + b8) in
// float32 (each thread sums its 64 columns in ascending order, then the
// quad by two xor shuffles), gz = g (1 - out^2); dz7 = bf16(gz w8 [h7 > 0]);
// each dz is rounded to bf16 after its mask; dh and dx1 stay float32.
#pragma once

#include <utility>

#include "sdf_trunk_sm90.cuh"

namespace sdf90_bwd {

using sdf90::CHUNKS;
using sdf90::CHUNKS_PER_LAYER;
using sdf90::CONSUMERS;
using sdf90::K_CHUNK;
using sdf90::LAYERS;
using sdf90::ROWS;
using sdf90::SKIP_LAYER;
using sdf90::WIDTH;
using bf16 = __nv_bfloat16;

constexpr int SLICES = 2 * CHUNKS;  // a tile's: w2..w7 from w, then w7..w2 from wt
constexpr int MASK_WORDS = 4;       // 128 bits: a consumer thread's values of one plane
// The weight ring holds one layer's slices: its other two stages' 64 KB
// went to the staging tiles.
constexpr int STAGES = 4;
constexpr int BOX = 64;                                  // a staging box: 64 rows x 64 columns
constexpr int BOX_BYTES = ROWS * BOX * 2;                // 8 KB, 128-byte swizzled
static_assert(STAGES >= CHUNKS_PER_LAYER, "the ring must hold a whole layer");

// A position in this kernel's ring (the header's RingPos, over STAGES).
struct RingPos {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

struct __align__(1024) Smem {
  bf16 ring[STAGES][WIDTH * K_CHUNK];
  // Each consumer's 64 x 256 bf16 output tile on its way to a plane: four
  // boxes of 64 columns, each 64 rows of 128 bytes, 128-byte swizzled (the
  // 16-byte chunk c of row r at c ^ (r % 8)).
  bf16 stage[CONSUMERS][ROWS * WIDTH];
  float bias[LAYERS + 1][WIDTH];  // rows b2, b3, b4, <unused>, b6, b7, b8 broadcast
  float w8[WIDTH];
  // [h_j > 0] of plane j (h1..h6) for consumer thread t: bit (4 i + 2 hh + e)
  // % 32 of word i / 8 for accumulator value d[4 i + 2 hh + e].
  uint32_t mask[LAYERS][MASK_WORDS][128 * CONSUMERS];
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
  int done;
};
static_assert(sizeof(Smem) + 1024 <= 232448, "the block's shared memory");

// The chunk's operands and scratch (a __grid_constant__ parameter).
struct Args {
  const bf16* pp1;  // [P, 256]
  const bf16* pp5;
  const bf16* zz1;  // [shapes, 256]: the chunk's shapes
  const bf16* zz5;
  const bf16* bias;  // [8, 256]
  const bf16* w8;    // [256]
  const float* g;    // [shapes, P]
  bf16* h;           // 7 planes [R, 256], R = shapes x P
  bf16* dz;          // 6 planes [R, 256]; plane l: the gradient at layer l's output
  float* dx1;        // [R, 256]
  float* gz;         // [R]
  long long plane;   // R x 256
  long long tiles;   // 64-row tiles: ceil(P / 64) x shapes
  int shapes, points;
};

// ------------------------------------------------- predicated global access

__device__ __forceinline__ uint32_t load_pair(const bf16* p, bool ok) {
  uint32_t v;
  asm("{\n.reg .pred p;\nsetp.ne.u32 p, %2, 0;\nmov.b32 %0, 0;\n@p ld.global.nc.b32 %0, [%1];\n}\n"
      : "=r"(v)
      : "l"(p), "r"(static_cast<uint32_t>(ok)));
  return v;
}

__device__ __forceinline__ float load_f32(const float* p, bool ok) {
  float v;
  asm("{\n.reg .pred p;\nsetp.ne.u32 p, %2, 0;\nmov.f32 %0, 0f00000000;\n@p ld.global.nc.f32 %0, [%1];\n}\n"
      : "=f"(v)
      : "l"(p), "r"(static_cast<uint32_t>(ok)));
  return v;
}

__device__ __forceinline__ void store_f32x2(float* p, float x, float y, bool ok) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.u32 p, %3, 0;\n@p st.global.v2.f32 [%0], {%1, %2};\n}\n" ::"l"(p),
               "f"(x), "f"(y), "r"(static_cast<uint32_t>(ok)));
}

__device__ __forceinline__ void store_f32(float* p, float x, bool ok) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.u32 p, %2, 0;\n@p st.global.f32 [%0], %1;\n}\n" ::"l"(p), "f"(x),
               "r"(static_cast<uint32_t>(ok)));
}

__device__ __forceinline__ uint32_t shape_pair(const bf16* row, int col) {
  return __ldg(reinterpret_cast<const unsigned int*>(row + col));
}

// [v > 0] of the two bf16 halves of a pair (signed 16-bit compare: a bf16
// is > 0 exactly when its sign bit is clear and it is not zero): bit 0 the
// low half, bit 1 the high half.
__device__ __forceinline__ uint32_t positive_bits(uint32_t x) {
  const uint32_t r = __vsetgts2(x, 0u);
  return (r | (r >> 15)) & 3u;
}

// ----------------------------------------------------- the staged stores

// A consumer thread's row address in its staging tile for stmatrix: matrix
// m = lane / 8 of each x4 covers rows + 8 (m & 1) and columns + 8 (m >> 1)
// of a 16 x 16 block (the A-fragment registers a[j][m]). Block j lies in
// box j / 4 at the 16-byte chunk 2 (j % 4) + (m >> 1) of the row, which the
// 128-byte swizzle xors with the row's low three bits: the chunk is
// y ^ 2 (j % 4) with y = (m >> 1) ^ (row % 8), so the address is this base
// xor 32 (j % 4), plus the box's offset.
__device__ __forceinline__ uint32_t stage_base(Smem& s, int wg) {
  const int t = threadIdx.x & 127, lane = t & 31, m = lane >> 3;
  const int row = (t >> 5) * 16 + (m & 1) * 8 + (lane & 7);
  const int y = (m >> 1) ^ (lane & 7);
  return sdf90::smem_addr(s.stage[wg]) + row * 128 + (y << 4);
}

template <int J>
__device__ __forceinline__ void stage_block(uint32_t base, const uint32_t (&a)[16][4]) {
  asm volatile(
      "{\n.reg .b32 t;\nxor.b32 t, %0, %5;\n"
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [t+%6], {%1, %2, %3, %4};\n}\n" ::"r"(base),
      "r"(a[J][0]), "r"(a[J][1]), "r"(a[J][2]), "r"(a[J][3]), "n"((J % 4) << 5), "n"((J / 4) * BOX_BYTES)
      : "memory");
}

template <int... J>
__device__ __forceinline__ void stage_blocks(uint32_t base, const uint32_t (&a)[16][4],
                                             std::integer_sequence<int, J...>) {
  (stage_block<J>(base, a), ...);
}

// The packed tile a (64 x 256 bf16, the A-operand layout) into the staging
// tile at `base` (stage_base).
__device__ __forceinline__ void stage_tile(uint32_t base, const uint32_t (&a)[16][4]) {
  stage_blocks(base, a, std::make_integer_sequence<int, 16>{});
}

// ----------------------------------------------------- the ring and turns

__device__ __forceinline__ bool stopped(const Smem& s) {
  return *reinterpret_cast<const volatile int*>(&s.done) != 0;
}

// The producer's one thread: slice i of a tile is chunk i of the w map for
// i < 24, else chunk (5 - (i - 24) / 4) x 4 + (i - 24) % 4 of the wt map;
// then it waits for its last copies (a block must not exit with copies in
// flight).
__device__ __forceinline__ void produce(Smem& s, const CUtensorMap* wmap, const CUtensorMap* wtmap) {
  RingPos pos;
  int i = 0, issued = 0;
  for (;;) {
    bool stop = stopped(s);
    if (issued >= STAGES)  // both consumers have released this stage's last fill
      while (!stop && !sdf90::bar_try_wait(&s.empty[pos.stage], pos.phase ^ 1u)) stop = stopped(s);
    if (stop) break;
    const int back = i - CHUNKS;
    const int chunk =
        back < 0 ? i : (LAYERS - 1 - back / CHUNKS_PER_LAYER) * CHUNKS_PER_LAYER + back % CHUNKS_PER_LAYER;
    sdf90::bar_expect(&s.full[pos.stage], sdf90::SLICE_BYTES);
    sdf90::load_slice(s.ring[pos.stage], back < 0 ? wmap : wtmap, chunk, &s.full[pos.stage]);
    i = i + 1 == SLICES ? 0 : i + 1;
    ++issued;
    pos.next();
  }
  for (int k = 0; k < STAGES && k < issued; ++k)
    sdf90::bar_wait(&s.full[k], k < pos.stage ? pos.phase : pos.phase ^ 1u);
}

__device__ __forceinline__ void release(Smem& s, int stage) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(sdf90::smem_addr(&s.empty[stage])),
      "r"(threadIdx.x & 127)
      : "memory");
}

// One layer's products over the next four slices, in consumer warpgroup
// wg's turn: d = a @ slice^T (the header's layer_products on this Smem).
// `between` runs once the products are queued and the turn is passed on,
// before they are waited for.
template <class Between>
__device__ __forceinline__ void products(Smem& s, int wg, RingPos& pos, const uint32_t (&a)[16][4],
                                         float (&d)[128], Between between) {
  int stage[CHUNKS_PER_LAYER];
  sdf90::named_sync(sdf90::TURN_BARRIER + wg, 128 * CONSUMERS);
  sdf90::fence_operand(d);
#pragma unroll
  for (int kc = 0; kc < CHUNKS_PER_LAYER; ++kc) {
    stage[kc] = pos.stage;
    sdf90::bar_wait(&s.full[pos.stage], pos.phase);
    if (kc == 0) sdf90::wgmma_fence();
    const uint64_t desc = sdf90::slice_desc(s.ring[pos.stage]);
#pragma unroll
    for (int kk = 0; kk < K_CHUNK / 16; ++kk)
      sdf90::wgmma_m64n256k16(d, a[4 * kc + kk], desc + 2 * kk, kc | kk);
    sdf90::wgmma_commit();
    pos.next();
  }
  sdf90::named_arrive(sdf90::TURN_BARRIER + (1 - wg), 128 * CONSUMERS);
  between();
  sdf90::wgmma_wait<3>();
  release(s, stage[0]);
  sdf90::wgmma_wait<2>();
  release(s, stage[1]);
  sdf90::wgmma_wait<1>();
  release(s, stage[2]);
  sdf90::wgmma_wait<0>();
  sdf90::fence_operand(d);
  release(s, stage[3]);
}

// ------------------------------------------------------------ the tile

// A consumer thread's rows of its tile: r0 = 16 warp + lane / 4 of the
// warpgroup's 64 and r0 + 8, at columns 8 i + 2 (lane % 4) + {0, 1}.
struct Rows {
  long long row;  // chunk row of r0: shape x P + point
  int point;      // point of r0
  int shape;
  int r0;
  int count;      // rows of the tile that exist (0 past the chunk)
  __device__ __forceinline__ bool ok(int hh) const { return r0 + 8 * hh < count; }
};

// A consumer thread's constants: its warpgroup, and its two addresses in
// the warpgroup's staging tile (stage_base, copy_base).
struct Consumer {
  int wg;
  uint32_t stage;
  uint32_t copy;
};

// A lane's address for copying its warp's 16 staged rows out: box lane / 8,
// logical chunk lane % 8 (columns 8 lane .. 8 lane + 7) of the warp's first
// row; row R of the warp is this xor 16 (R % 8), plus 128 R.
__device__ __forceinline__ uint32_t copy_base(Smem& s, int wg) {
  const int lane = threadIdx.x & 31, row0 = ((threadIdx.x >> 5) & 3) * 16;
  return sdf90::smem_addr(s.stage[wg]) + (lane >> 3) * BOX_BYTES + row0 * 128 + ((lane & 7) << 4);
}

template <int R>
__device__ __forceinline__ void copy_row(uint32_t base, bf16* out, int rows) {
  uint32_t v0, v1, v2, v3;
  asm volatile("{\n.reg .b32 t;\nxor.b32 t, %4, %5;\nld.shared.v4.b32 {%0, %1, %2, %3}, [t+%6];\n}\n"
               : "=r"(v0), "=r"(v1), "=r"(v2), "=r"(v3)
               : "r"(base), "n"((R % 8) << 4), "n"(R * 128)
               : "memory");
  asm volatile(
      "{\n.reg .pred p;\nsetp.lt.s32 p, %5, %6;\n@p st.global.v4.b32 [%0], {%1, %2, %3, %4};\n}\n" ::"l"(
          out + R * WIDTH),
      "r"(v0), "r"(v1), "r"(v2), "r"(v3), "n"(R), "r"(rows)
      : "memory");
}

template <int... R>
__device__ __forceinline__ void copy_rows(uint32_t base, bf16* out, int rows,
                                          std::integer_sequence<int, R...>) {
  (copy_row<R>(base, out, rows), ...);
}

// A staged tile's way out: the lane's first element in the plane (row
// 16 warp of the tile, columns 8 lane ..) and the rows of the warp's 16 that
// exist.
struct Pending {
  bf16* out;
  int rows;
};

// The packed tile a into the staging tile (each warp writes, and later
// copies out, only its own 16 rows), bound for the tile's rows of `plane`.
__device__ __forceinline__ Pending stage(const Consumer& c, const Rows& r, const uint32_t (&a)[16][4],
                                         bf16* plane) {
  __syncwarp();  // the last copy has read the staging rows
  stage_tile(c.stage, a);
  __syncwarp();
  const int row0 = ((threadIdx.x >> 5) & 3) * 16;
  return {plane + (r.row - r.r0 + row0) * WIDTH + 8 * (threadIdx.x & 31), r.count - row0};
}

// The staged rows out to their plane: a whole 512-byte row a warp store.
__device__ __forceinline__ void copy_out(const Consumer& c, const Pending& p) {
  copy_rows(c.copy, p.out, p.rows, std::make_integer_sequence<int, 16>{});
}

__device__ __forceinline__ Rows rows_of(const Args& g, long long tile) {
  const int t = threadIdx.x & 127;
  const int r0 = (t >> 5) * 16 + ((t & 31) >> 2);
  Rows r;
  r.shape = static_cast<int>(tile % g.shapes);
  const int p0 = static_cast<int>(tile / g.shapes) * ROWS;
  r.r0 = r0;
  r.point = p0 + r0;
  r.count = tile < g.tiles ? min(ROWS, g.points - p0) : 0;
  r.row = static_cast<long long>(r.shape) * g.points + r.point;
  return r;
}

// Element (row r0 + 8 hh, column 2 (lane % 4)) of a [*, 256] array whose row
// r0 is `row`.
template <class T>
__device__ __forceinline__ T* at(T* base, long long row, int hh) {
  return base + (row + 8 * hh) * WIDTH + 2 * (threadIdx.x & 3);
}

__device__ __forceinline__ void keep_bits(Smem& s, int plane, const uint32_t (&bits)[MASK_WORDS]) {
#pragma unroll
  for (int w = 0; w < MASK_WORDS; ++w) s.mask[plane][w][threadIdx.x] = bits[w];
}

__device__ __forceinline__ void load_bits(const Smem& s, int plane, uint32_t (&bits)[MASK_WORDS]) {
#pragma unroll
  for (int w = 0; w < MASK_WORDS; ++w) bits[w] = s.mask[plane][w][threadIdx.x];
}

// Layer 1: h1 = relu(pp1 + zz1) in float32, rounded once; packed as the A
// operand of layer 2, staged to h plane 0, its mask kept.
__device__ __forceinline__ Pending layer1(Smem& s, const Args& g, const Consumer& c, const Rows& r,
                                       uint32_t (&a)[16][4]) {
  const bf16* zrow = g.zz1 + static_cast<size_t>(r.shape) * WIDTH;
  const int q2 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      a[i / 2][2 * (i % 2) + hh] = load_pair(at(g.pp1, r.point, hh) + 8 * i, r.ok(hh));
  uint32_t bits[MASK_WORDS] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float2 z = sdf90::unpack_bf16(shape_pair(zrow, 8 * i + q2));
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      uint32_t& x = a[i / 2][2 * (i % 2) + hh];
      const float2 p = sdf90::unpack_bf16(x);
      x = sdf90::pack_bf16(fmaxf(__fadd_rn(p.x, z.x), 0.f), fmaxf(__fadd_rn(p.y, z.y), 0.f));
      bits[i / 8] |= positive_bits(x) << ((4 * i + 2 * hh) % 32);
    }
  }
  keep_bits(s, 0, bits);
  return stage(c, r, a, g.h);
}

// A rebuilt layer L (0..4: w2..w6) over its product d: relu(d + bias) (layer
// 5: relu((d + pp5) + zz5)) in float32, rounded once; packed as the next A
// operand, staged to h plane L + 1, its mask kept.
template <int L>
__device__ __forceinline__ Pending rebuild(Smem& s, const Args& g, const Consumer& c, const Rows& r,
                                        const float (&d)[128], uint32_t (&a)[16][4]) {
  const int q2 = 2 * (threadIdx.x & 3);
  const bf16* zrow = g.zz5 + static_cast<size_t>(r.shape) * WIDTH;
  if (L == SKIP_LAYER) {  // pp5 into the free A registers first
#pragma unroll
    for (int i = 0; i < 32; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        a[i / 2][2 * (i % 2) + hh] = load_pair(at(g.pp5, r.point, hh) + 8 * i, r.ok(hh));
  }
  uint32_t bits[MASK_WORDS] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = 8 * i + q2;
    const float2 b = L == SKIP_LAYER ? sdf90::unpack_bf16(shape_pair(zrow, col)) : sdf90::pair(s.bias[L], col);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      uint32_t& x = a[i / 2][2 * (i % 2) + hh];
      float v0 = d[4 * i + 2 * hh], v1 = d[4 * i + 2 * hh + 1];
      if (L == SKIP_LAYER) {
        const float2 p = sdf90::unpack_bf16(x);
        v0 = __fadd_rn(v0, p.x);
        v1 = __fadd_rn(v1, p.y);
      }
      x = sdf90::pack_bf16(fmaxf(__fadd_rn(v0, b.x), 0.f), fmaxf(__fadd_rn(v1, b.y), 0.f));
      bits[i / 8] |= positive_bits(x) << ((4 * i + 2 * hh) % 32);
    }
  }
  keep_bits(s, L + 1, bits);
  return stage(c, r, a, g.h + (L + 1) * g.plane);
}

// Layer 7 and the head: h7 = relu(d + b7), rounded once, staged to h plane
// 6; out = tanh(h7 . w8 + b8); gz = g (1 - out^2) stored; dz7 = bf16(gz w8
// [h7 > 0]) packed as the A operand of the first backward product and
// staged to dz plane 5. gv: g of the thread's two rows.
__device__ __forceinline__ Pending head(Smem& s, const Args& g, const Consumer& c, const Rows& r,
                                     const float (&d)[128], uint32_t (&a)[16][4], const float (&gv)[2]) {
  const int q = threadIdx.x & 3, q2 = 2 * q;
  float acc[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = 8 * i + q2;
    const float2 b = sdf90::pair(s.bias[LAYERS - 1], col), w = sdf90::pair(s.w8, col);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      uint32_t& x = a[i / 2][2 * (i % 2) + hh];
      x = sdf90::pack_bf16(fmaxf(__fadd_rn(d[4 * i + 2 * hh], b.x), 0.f),
                           fmaxf(__fadd_rn(d[4 * i + 2 * hh + 1], b.y), 0.f));
      const float2 f = sdf90::unpack_bf16(x);
      acc[hh] = fmaf(f.x, w.x, acc[hh]);
      acc[hh] = fmaf(f.y, w.y, acc[hh]);
    }
  }
  copy_out(c, stage(c, r, a, g.h + LAYERS * g.plane));
  float gz[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    acc[hh] += __shfl_xor_sync(0xffffffffu, acc[hh], 1);
    acc[hh] += __shfl_xor_sync(0xffffffffu, acc[hh], 2);
    const float o = tanhf(acc[hh] + s.bias[LAYERS][0]);
    gz[hh] = __fmul_rn(gv[hh], __fsub_rn(1.f, __fmul_rn(o, o)));
    store_f32(g.gz + r.row + 8 * hh, gz[hh], r.ok(hh) && q == hh);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float2 w = sdf90::pair(s.w8, 8 * i + q2);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      uint32_t& x = a[i / 2][2 * (i % 2) + hh];
      const uint32_t m = positive_bits(x);
      x = sdf90::pack_bf16((m & 1u) ? __fmul_rn(gz[hh], w.x) : 0.f, (m & 2u) ? __fmul_rn(gz[hh], w.y) : 0.f);
    }
  }
  return stage(c, r, a, g.dz + (LAYERS - 1) * g.plane);
}

// The backward of trunk layer L (5..0) over its product d = dh at plane L:
// masked by [h_L > 0] (the bits layer L's input epilogue kept). L > 0: dz of
// layer L - 1, rounded to bf16, packed as the next A operand and staged to
// dz plane L - 1; L = 0: dx1, float32, stored from the registers.
template <int L>
__device__ __forceinline__ Pending backward(Smem& s, const Args& g, const Consumer& c, const Rows& r,
                                         const float (&d)[128], uint32_t (&a)[16][4]) {
  uint32_t bits[MASK_WORDS];
  load_bits(s, L, bits);
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const uint32_t m = bits[i / 8] >> ((4 * i + 2 * hh) % 32);
      const float v0 = (m & 1u) ? d[4 * i + 2 * hh] : 0.f;
      const float v1 = (m & 2u) ? d[4 * i + 2 * hh + 1] : 0.f;
      if (L > 0) {
        uint32_t& x = a[i / 2][2 * (i % 2) + hh];
        x = sdf90::pack_bf16(v0, v1);
      } else {
        store_f32x2(at(g.dx1, r.row, hh) + 8 * i, v0, v1, r.ok(hh));
      }
    }
  return L > 0 ? stage(c, r, a, g.dz + (L - 1) * g.plane) : Pending{nullptr, 0};
}

__device__ __forceinline__ void tile(Smem& s, const Args& g, const Consumer& c, RingPos& pos, long long t) {
  const Rows r = rows_of(g, t);
  const float* grow = g.g + r.row;
  const float gv[2] = {load_f32(grow, r.ok(0)), load_f32(grow + 8, r.ok(1))};
  uint32_t a[16][4];
  float d[128];
  // Each epilogue stages its plane's tile; the next products copy it out.
  Pending p = layer1(s, g, c, r, a);
  const auto copy = [&] { copy_out(c, p); };
  products(s, c.wg, pos, a, d, copy);
  p = rebuild<0>(s, g, c, r, d, a);
  products(s, c.wg, pos, a, d, copy);
  p = rebuild<1>(s, g, c, r, d, a);
  products(s, c.wg, pos, a, d, copy);
  p = rebuild<2>(s, g, c, r, d, a);
  products(s, c.wg, pos, a, d, copy);
  p = rebuild<3>(s, g, c, r, d, a);
  products(s, c.wg, pos, a, d, copy);
  p = rebuild<4>(s, g, c, r, d, a);
  products(s, c.wg, pos, a, d, copy);
  p = head(s, g, c, r, d, a, gv);
  products(s, c.wg, pos, a, d, copy);
  p = backward<5>(s, g, c, r, d, a);
  products(s, c.wg, pos, a, d, copy);
  p = backward<4>(s, g, c, r, d, a);
  products(s, c.wg, pos, a, d, copy);
  p = backward<3>(s, g, c, r, d, a);
  products(s, c.wg, pos, a, d, copy);
  p = backward<2>(s, g, c, r, d, a);
  products(s, c.wg, pos, a, d, copy);
  p = backward<1>(s, g, c, r, d, a);
  products(s, c.wg, pos, a, d, copy);
  backward<0>(s, g, c, r, d, a);
}

__global__ void __launch_bounds__(sdf90::THREADS, 1)
bwd_rows_sm90_kernel(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap wtmap,
                     const __grid_constant__ Args args) {
  extern __shared__ unsigned char smem_raw[];
  Smem& s = sdf90::aligned_smem<Smem>(smem_raw);
  for (int i = threadIdx.x; i < (LAYERS + 1) * WIDTH; i += sdf90::THREADS)
    s.bias[i / WIDTH][i % WIDTH] = __bfloat162float(args.bias[i]);
  for (int i = threadIdx.x; i < WIDTH; i += sdf90::THREADS) s.w8[i] = __bfloat162float(args.w8[i]);
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      sdf90::bar_init(&s.full[i], 1);
      sdf90::bar_init(&s.empty[i], CONSUMERS);
    }
    s.done = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&wmap)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&wtmap)) : "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    sdf90::producer_start();
    if (threadIdx.x == sdf90::PRODUCER_THREAD) produce(s, &wmap, &wtmap);
  } else {
    sdf90::consumer_start(wg);
    const Consumer c{wg, stage_base(s, wg), copy_base(s, wg)};
    RingPos pos;
    for (long long t = 2LL * blockIdx.x + wg;; t += 2LL * gridDim.x) {
      if (!sdf90::consumers_any(t < args.tiles)) break;
      tile(s, args, c, pos, t);
    }
    if (wg == 0) {  // take the second consumer's last turn signal, then stop the producer
      sdf90::named_sync(sdf90::TURN_BARRIER + 0, 128 * CONSUMERS);
      if (threadIdx.x == 0) *reinterpret_cast<volatile int*>(&s.done) = 1;
    }
  }
}

// The rows pass of one chunk: `w` [6, out, in] and `wt` [6, in, out] bf16
// stacks; args.tiles is set here.
inline cudaError_t rows_pass(const void* w, const void* wt, Args args, int device, cudaStream_t stream) {
  CUtensorMap wmap, wtmap;
  cudaError_t err = sdf90::weight_map(&wmap, w);
  if (err != cudaSuccess) return err;
  if ((err = sdf90::weight_map(&wtmap, wt)) != cudaSuccess) return err;
  const int smem = static_cast<int>(sizeof(Smem)) + 1024;
  err = cudaFuncSetAttribute(bwd_rows_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  args.tiles = (static_cast<long long>(args.points) + ROWS - 1) / ROWS * args.shapes;
  const long long pairs = (args.tiles + CONSUMERS - 1) / CONSUMERS;
  const unsigned blocks = static_cast<unsigned>(pairs < sms ? pairs : sms);
  bwd_rows_sm90_kernel<<<blocks, sdf90::THREADS, smem, stream>>>(wmap, wtmap, args);
  return cudaGetLastError();
}

}  // namespace sdf90_bwd
