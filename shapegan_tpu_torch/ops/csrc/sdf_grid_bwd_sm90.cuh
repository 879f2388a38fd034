// The rows pass of the grid and rowwise backwards on the Hopper trunk of
// sdf_trunk_sm90.cuh, a template over where its inputs come from (In, the
// first member of its Args):
// * B2, the grid recompute backward (GridInputs): for a chunk of whole
//   shapes over the point grid it writes the scratch that the passes after
//   it read (sdf_grid_bwd.cu's Layout): the h planes h1..h7 and the dz
//   planes (bf16), dx1 (float32) and gz (float32), one row each per
//   (shape, point).
// * B5b, the grid stash backward (StashInputs, sdf_grid_bwd.cu): B2's
//   inputs and a plan, the positions among h2..h7 that the stash forward
//   (B5a) wrote to planes. A stashed position is not rebuilt: no products;
//   its tile is read from the stash plane into the A registers where the
//   next layer is rebuilt from it, and its mask comes from that tile or
//   from the plane (mask_from_plane). The others are rebuilt as B2 rebuilds
//   them. The same scratch less the stashed h planes, which are never
//   written.
// * B6b, the rowwise backward (RowInputs, sdf_rowwise_bwd.cu): one "shape"
//   of N rows, each with its own point and latent terms; the same planes
//   and gz, dx1 written straight to the output dzz1.
// The figures below are B2's.
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
//   restarting. B5b's plan drops the slices of the layers it does not
//   rebuild (24 + 4 x rebuilt a tile); the plan is a launch constant, so
//   the producer and both consumers step through the same slices and the
//   consumers take the same turns.
// * The masks on chip. The backward of the layer whose input is h_j needs
//   [h_j > 0] (j = 1..6). In the m64n256 accumulator layout a thread holds
//   the same (row, column) positions in the epilogue that made h_j and in
//   the one that masks by it, so each forward epilogue keeps its 128 bits
//   a thread in shared memory (4 words; 24 KB for the block) and the
//   backward epilogue reads them back. Reading the h planes back from
//   device memory would re-read 3 KB a row, and a tile's planes have left
//   the 50 MB L2 by then (each SM writes ~0.5 MB a tile pair). B5b keeps a
//   stashed position's bits from its tile where the forward reads it in
//   anyway, else reads them from the stash plane (mask_from_plane).
// * Persistent, warp-specialized blocks. One block per SM; two consumer
//   warpgroups in ping-pong (named-barrier turns, as in the header) take
//   64-row tiles in sdf_rows_sm90.cuh's order (tile t: shape t % shapes,
//   points 64 (t / shapes) on, as B1's; B6b's one shape gives plain 64-row
//   tiles), one producer warp feeds the ring. B2 reads zz1 and zz5 per tile
//   (the shape changes), pp1, pp5 and g per row; B6b reads xyz, zz1, zz5
//   and g per row and projects xyz by w1p and w5p (read through L1) in the
//   epilogues. A consumer
//   whose tile runs past the chunk computes on zero rows and stores none
//   (predicated loads and stores, no branch among the products).
// * The stores through shared memory, off the products' path
//   (sdf_rows_sm90.cuh's staged stores, which B5a shares). Each epilogue
//   writes its bf16 tile (an h or dz plane's 64 x 256) from the packed A
//   registers into the consumer's staging tile (16 stmatrix.x4 a thread,
//   128-byte swizzled: free of bank conflicts); each warp copies its own 16
//   rows out to the plane with 16-byte stores, one whole 512-byte row a warp
//   store, once the next layer's products are queued (only __syncwarp
//   between, no block barrier). dx1 (float32) and gz go by
//   predicated st.global from the registers. The ring is cut to 4 stages to
//   make room for the staging. At 16 x 64^3 on the H100 this reads ~29.7 ms
//   against ~13.5 without the global stores; storing each pair from the
//   registers read 37.5, TMA stores of the staged tiles or warp copies in
//   the epilogue 29.5-29.7 (kernel_variants.py; PERF.md, section 6).
//
// Rounding points: `_bwd_kernel`'s (shapegan_tpu/ops/sdf_mlp_pallas.py), not
// B3's; for B5b `_stash_bwd_kernel`'s, the same with a stashed position the
// forward's own bf16 value (a rebuilt one may follow it); for B6b
// `_rowwise_bwd_kernel`'s, the same with the float32 projections xyz @ w1p
// and xyz @ w5p, not rounded, in place of pp1 and pp5: h1 = relu(pp1 + zz1) summed in float32 and rounded once; a rebuilt
// layer adds its bias to the float32 product and rounds once (layer 5:
// ((acc + pp5) + zz5), rounded once); the head is tanh(h7 . w8 + b8) in
// float32 (each thread sums its 64 columns in ascending order, then the
// quad by two xor shuffles), gz = g (1 - out^2); dz7 = bf16(gz w8 [h7 > 0]);
// each dz is rounded to bf16 after its mask; dh and dx1 stay float32.
#pragma once

#include <type_traits>

#include "sdf_rows_sm90.cuh"

namespace {  // each source that includes this has its own copy of the kernels
namespace sdf90_bwd {

using sdf90::CHUNKS;
using sdf90::CHUNKS_PER_LAYER;
using sdf90::CONSUMERS;
using sdf90::K_CHUNK;
using sdf90::LAYERS;
using sdf90::ROWS;
using sdf90::SKIP_LAYER;
using sdf90::WIDTH;
using sdf90::bf16;
using sdf90::Consumer;
using sdf90::Pending;
using sdf90::Rows;
using sdf90::at;
using sdf90::copy_out;
using sdf90::shape_pair;
using sdf90::stage;

constexpr int MASK_WORDS = 4;       // 128 bits: a consumer thread's values of one plane
// The weight ring holds one layer's slices: its other two stages' 64 KB
// went to the staging tiles.
constexpr int STAGES = 4;
static_assert(STAGES >= CHUNKS_PER_LAYER, "the ring must hold a whole layer");
using RingPos = sdf90::Ring<STAGES>;

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

// ------------------------------------------------------------ the inputs

// A column pair of a consumer thread's two rows: v[0] of row r0, v[1] of
// row r0 + 8.
struct RowPairs {
  float2 v[2];
};

// An epilogue's inputs for a tile: through a view (Terms) that gives, per
// column pair (i: its index in the accumulator layout, col: its first
// column), the point term and the latent term of both rows; the sums are
// (product + point) + latent at the skip layer and point + latent at layer
// 1, in float32. The per-row operand goes into the free A registers before
// the epilogue's loop (a tile's 64 loads a thread in flight together).

// A column pair of the per-row tile in the A registers a, both rows.
__device__ __forceinline__ RowPairs tile_pairs(const uint32_t (&a)[16][4], int i) {
  return {{sdf90::unpack_bf16(a[i / 2][2 * (i % 2)]), sdf90::unpack_bf16(a[i / 2][2 * (i % 2) + 1])}};
}

// B2's: pp1 and pp5 [P, 256] by point, zz1 and zz5 [shapes, 256] by shape.
// The point term is the pp tile; the latent term the shape's row.
struct GridInputs {
  const bf16* pp1;  // [P, 256]
  const bf16* pp5;
  const bf16* zz1;  // [shapes, 256]: the chunk's shapes
  const bf16* zz5;

  struct Terms {
    const bf16* zrow;  // the shape's row of zz1 or zz5
    __device__ __forceinline__ RowPairs point(int i, int, const uint32_t (&a)[16][4]) const {
      return tile_pairs(a, i);
    }
    __device__ __forceinline__ RowPairs latent(int, int col, const uint32_t (&)[16][4]) const {
      const float2 z = sdf90::unpack_bf16(shape_pair(zrow, col));
      return {{z, z}};
    }
  };
  __device__ __forceinline__ Terms layer1(const Rows& r, uint32_t (&a)[16][4]) const {
    sdf90::load_tile(a, pp1, r.point, r);
    return {zz1 + static_cast<size_t>(r.shape) * WIDTH};
  }
  // The skip layer's view; `skip`: this is the skip layer's epilogue (its
  // pp5 tile goes into the free A registers), else the view goes unused.
  __device__ __forceinline__ Terms layer5(const Rows& r, uint32_t (&a)[16][4], bool skip) const {
    if (skip) sdf90::load_tile(a, pp5, r.point, r);
    return {zz5 + static_cast<size_t>(r.shape) * WIDTH};
  }
};

// B5b's: B2's, and the plan (sdf_grid_bwd.cu's make_plan): the trunk
// layers rebuilt, in ascending order (layer l makes position l + 1), and
// the positions read from their stash planes instead (bit j of `stashed`,
// j = 1..6; a stashed position 0 is ignored).
struct Plan {
  int rebuilt;
  int layer[LAYERS];
  unsigned stashed;
};

// kFull: the plan stashes all of h2..h7, so the forward issues no products.
// That instance knows its plan when it is compiled; the other reads it at
// run time, and its branches on the plan bits around the products make
// ptxas serialize the kernel's wgmmas (its warning C7520). The full plan
// is the one the stash A/B of chip_smoke.py and the kernels line time.
template <bool kFull>
struct StashInputs : GridInputs {
  static constexpr bool full = kFull;
  Plan plan;
  bf16* h[LAYERS + 1];  // planes h1..h7 [R, 256]: a stashed one in the stash, the others in scratch
};
constexpr unsigned FULL_PLAN = 0x7eu;  // h2..h7

template <class In>
struct IsStash : std::false_type {};
template <bool kFull>
struct IsStash<StashInputs<kFull>> : std::true_type {};
template <class In>
constexpr bool kStash = IsStash<In>::value;

// B6b's: one "shape" of N rows. The point term is the row's xyz, rounded to
// bf16, projected by w1p or w5p (read through L1) in float32 and not
// rounded (the FMA order of sdf90::project_f32); the latent term the zz1 or
// zz5 tile, by row.
struct RowInputs {
  const float* pts;  // [N, 3]
  const bf16* w1p;   // [3, 256]
  const bf16* w5p;
  const bf16* zz1;   // [N, 256]
  const bf16* zz5;

  struct Terms {
    float3 p[2];     // the rows' points
    const bf16* wp;  // w1p or w5p
    __device__ __forceinline__ RowPairs point(int, int col, const uint32_t (&)[16][4]) const {
      const float2 w0 = sdf90::unpack_bf16(shape_pair(wp, col));
      const float2 w1 = sdf90::unpack_bf16(shape_pair(wp + WIDTH, col));
      const float2 w2 = sdf90::unpack_bf16(shape_pair(wp + 2 * WIDTH, col));
      return {{sdf90::project_f32(p[0], w0, w1, w2), sdf90::project_f32(p[1], w0, w1, w2)}};
    }
    __device__ __forceinline__ RowPairs latent(int i, int, const uint32_t (&a)[16][4]) const {
      return tile_pairs(a, i);
    }
  };
  __device__ __forceinline__ Terms terms(const Rows& r, const bf16* wp) const {
    Terms t;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float* q = pts + (r.row + 8 * hh) * 3;
      t.p[hh] = make_float3(sdf90::round_bf16(sdf90::load_f32(q, r.ok(hh))),
                            sdf90::round_bf16(sdf90::load_f32(q + 1, r.ok(hh))),
                            sdf90::round_bf16(sdf90::load_f32(q + 2, r.ok(hh))));
    }
    t.wp = wp;
    return t;
  }
  __device__ __forceinline__ Terms layer1(const Rows& r, uint32_t (&a)[16][4]) const {
    sdf90::load_tile(a, zz1, r.row, r);
    return terms(r, w1p);
  }
  __device__ __forceinline__ Terms layer5(const Rows& r, uint32_t (&a)[16][4], bool skip) const {
    if (skip) sdf90::load_tile(a, zz5, r.row, r);
    return terms(r, w5p);
  }
};

// The chunk's operands and scratch (a __grid_constant__ parameter).
template <class In>
struct Args {
  In in;             // GridInputs (B2), StashInputs<> (B5b) or RowInputs (B6b)
  const bf16* bias;  // [8, 256]
  const bf16* w8;    // [256]
  const float* g;    // [shapes, P]
  bf16* h;           // 7 planes [R, 256], R = shapes x P (B5b: its planes are in.h)
  bf16* dz;          // 6 planes [R, 256]; plane l: the gradient at layer l's output
  float* dx1;        // [R, 256] (B6b: the output dzz1)
  float* gz;         // [R]
  long long plane;   // R x 256
  long long tiles;   // 64-row tiles: ceil(P / 64) x shapes
  int shapes, points;
};

// h plane j (0..6: h1..h7).
template <class In>
__device__ __forceinline__ bf16* h_plane(const Args<In>& g, int j) {
  if constexpr (kStash<In>)
    return g.in.h[j];
  else
    return g.h + j * g.plane;
}

// [v > 0] of the two bf16 halves of a pair (signed 16-bit compare: a bf16
// is > 0 exactly when its sign bit is clear and it is not zero): bit 0 the
// low half, bit 1 the high half.
__device__ __forceinline__ uint32_t positive_bits(uint32_t x) {
  const uint32_t r = __vsetgts2(x, 0u);
  return (r | (r >> 15)) & 3u;
}

// ----------------------------------------------------- the ring

// The forward's slices of a tile: all 24 (B2, B6b), or the plan's layers'.
template <class In>
__device__ __forceinline__ int forward_slices(const In& in) {
  if constexpr (kStash<In>)
    return in.plan.rebuilt * CHUNKS_PER_LAYER;
  else
    return CHUNKS;
}

// The w map's chunk of forward slice i.
template <class In>
__device__ __forceinline__ int forward_chunk(const In& in, int i) {
  if constexpr (kStash<In>)
    return in.plan.layer[i / CHUNKS_PER_LAYER] * CHUNKS_PER_LAYER + i % CHUNKS_PER_LAYER;
  else
    return i;
}

// The producer's one thread: slice i of a tile is forward slice i of the w
// map for i < f (forward_slices), else chunk (5 - (i - f) / 4) x 4 +
// (i - f) % 4 of the wt map; then it waits for its last copies (a block
// must not exit with copies in flight).
template <class In>
__device__ __forceinline__ void produce(Smem& s, const In& in, const CUtensorMap* wmap, const CUtensorMap* wtmap) {
  const int forward = forward_slices(in), slices = forward + CHUNKS;
  RingPos pos;
  int i = 0, issued = 0;
  for (;;) {
    bool stop = sdf90::stopped(s);
    if (issued >= STAGES)  // both consumers have released this stage's last fill
      while (!stop && !sdf90::bar_try_wait(&s.empty[pos.stage], pos.phase ^ 1u)) stop = sdf90::stopped(s);
    if (stop) break;
    const int back = i - forward;
    const int chunk = back < 0 ? forward_chunk(in, i)
                               : (LAYERS - 1 - back / CHUNKS_PER_LAYER) * CHUNKS_PER_LAYER + back % CHUNKS_PER_LAYER;
    sdf90::bar_expect(&s.full[pos.stage], sdf90::SLICE_BYTES);
    sdf90::load_slice(s.ring[pos.stage], back < 0 ? wmap : wtmap, chunk, &s.full[pos.stage]);
    i = i + 1 == slices ? 0 : i + 1;
    ++issued;
    pos.next();
  }
  sdf90::drain(s, pos, issued);
}

// ------------------------------------------------------------ the tile

__device__ __forceinline__ void keep_bits(Smem& s, int plane, const uint32_t (&bits)[MASK_WORDS]) {
#pragma unroll
  for (int w = 0; w < MASK_WORDS; ++w) s.mask[plane][w][threadIdx.x] = bits[w];
}

__device__ __forceinline__ void load_bits(const Smem& s, int plane, uint32_t (&bits)[MASK_WORDS]) {
#pragma unroll
  for (int w = 0; w < MASK_WORDS; ++w) bits[w] = s.mask[plane][w][threadIdx.x];
}

// Layer 1: h1 = relu(pp1 + zz1) (B6b: relu(xyz @ w1p + zz1)) in float32,
// rounded once; packed as the A operand of layer 2, staged to h plane 0, its
// mask kept.
template <class In>
__device__ __forceinline__ Pending layer1(Smem& s, const Args<In>& g, const Consumer& c, const Rows& r,
                                       uint32_t (&a)[16][4]) {
  const int q2 = 2 * (threadIdx.x & 3);
  const auto in1 = g.in.layer1(r, a);
  uint32_t bits[MASK_WORDS] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = 8 * i + q2;
    const RowPairs p = in1.point(i, col, a);
    const RowPairs z = in1.latent(i, col, a);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      uint32_t& x = a[i / 2][2 * (i % 2) + hh];
      const float2 pv = p.v[hh], zv = z.v[hh];
      x = sdf90::pack_bf16(fmaxf(__fadd_rn(pv.x, zv.x), 0.f), fmaxf(__fadd_rn(pv.y, zv.y), 0.f));
      bits[i / 8] |= positive_bits(x) << ((4 * i + 2 * hh) % 32);
    }
  }
  keep_bits(s, 0, bits);
  return stage(c, r, a, h_plane(g, 0));
}

// A rebuilt layer L (0..4: w2..w6) over its product d: relu(d + bias) (layer
// 5: relu((d + pp5) + zz5); B6b: relu((d + xyz @ w5p) + zz5)) in float32,
// rounded once; packed as the next A operand, staged to h plane L + 1, its
// mask kept.
template <int L, class In>
__device__ __forceinline__ Pending rebuild(Smem& s, const Args<In>& g, const Consumer& c, const Rows& r,
                                        const float (&d)[128], uint32_t (&a)[16][4]) {
  const int q2 = 2 * (threadIdx.x & 3);
  const auto in5 = g.in.layer5(r, a, L == SKIP_LAYER);
  uint32_t bits[MASK_WORDS] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = 8 * i + q2;
    const float2 b = sdf90::pair(s.bias[L], col);
    RowPairs p{}, z{};
    if (L == SKIP_LAYER) {
      p = in5.point(i, col, a);
      z = in5.latent(i, col, a);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      uint32_t& x = a[i / 2][2 * (i % 2) + hh];
      float v0 = d[4 * i + 2 * hh], v1 = d[4 * i + 2 * hh + 1];
      if (L == SKIP_LAYER) {
        v0 = __fadd_rn(__fadd_rn(v0, p.v[hh].x), z.v[hh].x);
        v1 = __fadd_rn(__fadd_rn(v1, p.v[hh].y), z.v[hh].y);
      } else {
        v0 = __fadd_rn(v0, b.x);
        v1 = __fadd_rn(v1, b.y);
      }
      x = sdf90::pack_bf16(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      bits[i / 8] |= positive_bits(x) << ((4 * i + 2 * hh) % 32);
    }
  }
  keep_bits(s, L + 1, bits);
  return stage(c, r, a, h_plane(g, L + 1));
}

// B5b: where the mask of a stashed position j (bit j of the plan's
// `stashed`) comes from. When position j + 1 is stashed too, no layer is
// rebuilt from j's tile: the forward reads none, and the backward epilogue
// that masks by j reads its bits from the plane (plane_bits). Otherwise the
// forward reads the tile as the next layer's operand and keeps its bits.
// At 16 x 64^3 on the H100 (kernel_variants.py stash): every tile read in
// the forward cost the full plan ~4.5 ms, every mask read from its plane
// cost (2,4,6) ~4.5.
__device__ __forceinline__ bool mask_from_plane(unsigned stashed, int j) {
  return (stashed >> j) & (stashed >> (j + 1)) & 1u;
}

// [h > 0] of the tile's rows of a stash plane, in keep_bits's layout.
__device__ __forceinline__ void plane_bits(const bf16* plane, const Rows& r, uint32_t (&bits)[MASK_WORDS]) {
#pragma unroll
  for (int w = 0; w < MASK_WORDS; ++w) bits[w] = 0u;
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      bits[i / 8] |= positive_bits(sdf90::load_pair(at(plane, r.row, hh) + 8 * i, r.ok(hh)))
                     << ((4 * i + 2 * hh) % 32);
}

// B5b: position J (1..5) stashed. Where the next layer is rebuilt from it,
// its tile is read from the stash plane into a (that layer's A operand);
// where its mask is not read from the plane later, the bits of the tile
// are kept. It stages nothing, so the staged tile still pending (a rebuilt
// position's) goes out now, while the loads are in flight, and none is
// left pending.
template <int J, class In>
__device__ __forceinline__ void load_stashed(Smem& s, const Args<In>& g, const Consumer& c, const Rows& r,
                                             uint32_t (&a)[16][4], Pending& p, unsigned stashed) {
  const bool from_plane = mask_from_plane(stashed, J);
  if (!from_plane || !((stashed >> (J + 1)) & 1u)) sdf90::load_tile(a, h_plane(g, J), r.row, r);
  copy_out(c, p);
  p.rows = 0;
  if (from_plane) return;
  uint32_t bits[MASK_WORDS] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      bits[i / 8] |= positive_bits(a[i / 2][2 * (i % 2) + hh]) << ((4 * i + 2 * hh) % 32);
  keep_bits(s, J, bits);
}

// Layer 7 and the head: h7 = relu(d + b7), rounded once, staged to h plane
// 6 (kStashed, B5b: h7 read from its stash plane instead, the pending tile
// p sent out, nothing staged); out = tanh(h7 . w8 + b8); gz = g (1 - out^2)
// stored; dz7 = bf16(gz w8 [h7 > 0]) packed as the A operand of the first
// backward product and staged to dz plane 5. gv: g of the thread's two rows.
template <bool kStashed, class In>
__device__ __forceinline__ Pending head(Smem& s, const Args<In>& g, const Consumer& c, const Rows& r,
                                     const float (&d)[128], uint32_t (&a)[16][4], const float (&gv)[2],
                                     const Pending& p) {
  const int q = threadIdx.x & 3, q2 = 2 * q;
  if constexpr (kStashed) {
    sdf90::load_tile(a, h_plane(g, LAYERS), r.row, r);
    copy_out(c, p);
  }
  float acc[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = 8 * i + q2;
    const float2 b = sdf90::pair(s.bias[LAYERS - 1], col), w = sdf90::pair(s.w8, col);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      uint32_t& x = a[i / 2][2 * (i % 2) + hh];
      if constexpr (!kStashed)
        x = sdf90::pack_bf16(fmaxf(__fadd_rn(d[4 * i + 2 * hh], b.x), 0.f),
                             fmaxf(__fadd_rn(d[4 * i + 2 * hh + 1], b.y), 0.f));
      const float2 f = sdf90::unpack_bf16(x);
      acc[hh] = fmaf(f.x, w.x, acc[hh]);
      acc[hh] = fmaf(f.y, w.y, acc[hh]);
    }
  }
  if constexpr (!kStashed) copy_out(c, stage(c, r, a, h_plane(g, LAYERS)));
  float gz[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    acc[hh] += __shfl_xor_sync(0xffffffffu, acc[hh], 1);
    acc[hh] += __shfl_xor_sync(0xffffffffu, acc[hh], 2);
    const float o = tanhf(acc[hh] + s.bias[LAYERS][0]);
    gz[hh] = __fmul_rn(gv[hh], __fsub_rn(1.f, __fmul_rn(o, o)));
    sdf90::store_f32(g.gz + r.row + 8 * hh, gz[hh], r.ok(hh) && q == hh);
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
// masked by [h_L > 0] (the bits the forward kept; B5b: or those of the
// stash plane, mask_from_plane). L > 0: dz of layer L - 1, rounded to bf16,
// packed as the next A operand and staged to dz plane L - 1; L = 0: dx1,
// float32, stored from the registers.
template <int L, class In>
__device__ __forceinline__ Pending backward(Smem& s, const Args<In>& g, const Consumer& c, const Rows& r,
                                         const float (&d)[128], uint32_t (&a)[16][4]) {
  uint32_t bits[MASK_WORDS];
  load_bits(s, L, bits);
  // The plan bits as the launch parameter holds them, also in the full
  // instance: with this choice made when compiled, ptxas schedules the
  // plane's loads otherwise, and the full plan took 44.1 ms at 16 x 64^3,
  // not 37.0 (kernel_variants.py stash).
  if constexpr (kStash<In> && L > 0)
    if (mask_from_plane(g.in.plan.stashed, L)) plane_bits(h_plane(g, L), r, bits);
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
        sdf90::store_f32x2(at(g.dx1, r.row, hh) + 8 * i, v0, v1, r.ok(hh));
      }
    }
  return L > 0 ? stage(c, r, a, g.dz + (L - 1) * g.plane) : Pending{nullptr, 0};
}

// B5b's forward step of trunk layer L (position L + 1) by the plan's bits
// `stashed`: its products and epilogue, as B2's, or its tile from the stash
// plane.
template <int L, class In>
__device__ __forceinline__ void plan_step(Smem& s, const Args<In>& g, const Consumer& c, const Rows& r,
                                          RingPos& pos, float (&d)[128], uint32_t (&a)[16][4], Pending& p,
                                          unsigned stashed) {
  if ((stashed >> (L + 1)) & 1u) {
    load_stashed<L + 1>(s, g, c, r, a, p, stashed);
  } else {
    sdf90::layer_products(s, c.wg, pos, a, d, [&] { copy_out(c, p); });
    p = rebuild<L>(s, g, c, r, d, a);
  }
}

// A consumer's tile t. stashed: B5b's plan bits (a constant in the full
// instance); 0 otherwise.
template <class In>
__device__ __forceinline__ void tile(Smem& s, const Args<In>& g, const Consumer& c, RingPos& pos, long long t,
                                     unsigned stashed) {
  const Rows r = sdf90::rows_of(t, g.shapes, g.points, g.tiles);
  const float* grow = g.g + r.row;
  const float gv[2] = {sdf90::load_f32(grow, r.ok(0)), sdf90::load_f32(grow + 8, r.ok(1))};
  uint32_t a[16][4];
  float d[128];
  // Each epilogue stages its plane's tile; the next products copy it out.
  Pending p = layer1(s, g, c, r, a);
  const auto copy = [&] { copy_out(c, p); };
  if constexpr (kStash<In>) {
    plan_step<0>(s, g, c, r, pos, d, a, p, stashed);
    plan_step<1>(s, g, c, r, pos, d, a, p, stashed);
    plan_step<2>(s, g, c, r, pos, d, a, p, stashed);
    plan_step<3>(s, g, c, r, pos, d, a, p, stashed);
    plan_step<4>(s, g, c, r, pos, d, a, p, stashed);
    if ((stashed >> LAYERS) & 1u) {
      p = head<true>(s, g, c, r, d, a, gv, p);
    } else {
      sdf90::layer_products(s, c.wg, pos, a, d, copy);
      p = head<false>(s, g, c, r, d, a, gv, p);
    }
  } else {
    sdf90::layer_products(s, c.wg, pos, a, d, copy);
    p = rebuild<0>(s, g, c, r, d, a);
    sdf90::layer_products(s, c.wg, pos, a, d, copy);
    p = rebuild<1>(s, g, c, r, d, a);
    sdf90::layer_products(s, c.wg, pos, a, d, copy);
    p = rebuild<2>(s, g, c, r, d, a);
    sdf90::layer_products(s, c.wg, pos, a, d, copy);
    p = rebuild<3>(s, g, c, r, d, a);
    sdf90::layer_products(s, c.wg, pos, a, d, copy);
    p = rebuild<4>(s, g, c, r, d, a);
    sdf90::layer_products(s, c.wg, pos, a, d, copy);
    p = head<false>(s, g, c, r, d, a, gv, p);
  }
  sdf90::layer_products(s, c.wg, pos, a, d, copy);
  p = backward<5>(s, g, c, r, d, a);
  sdf90::layer_products(s, c.wg, pos, a, d, copy);
  p = backward<4>(s, g, c, r, d, a);
  sdf90::layer_products(s, c.wg, pos, a, d, copy);
  p = backward<3>(s, g, c, r, d, a);
  sdf90::layer_products(s, c.wg, pos, a, d, copy);
  p = backward<2>(s, g, c, r, d, a);
  sdf90::layer_products(s, c.wg, pos, a, d, copy);
  p = backward<1>(s, g, c, r, d, a);
  sdf90::layer_products(s, c.wg, pos, a, d, copy);
  backward<0>(s, g, c, r, d, a);
}

template <class In>
__global__ void __launch_bounds__(sdf90::THREADS, 1)
bwd_rows_sm90_kernel(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap wtmap,
                     const __grid_constant__ Args<In> args) {
  extern __shared__ unsigned char smem_raw[];
  Smem& s = sdf90::aligned_smem<Smem>(smem_raw);
  sdf90::to_float(s.bias[0], args.bias, (LAYERS + 1) * WIDTH);
  sdf90::to_float(s.w8, args.w8, WIDTH);
  if (threadIdx.x == 0) {
    sdf90::ring_init<STAGES>(s, &wmap);
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&wtmap)) : "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    sdf90::producer_start();
    if (threadIdx.x == sdf90::PRODUCER_THREAD) produce(s, args.in, &wmap, &wtmap);
  } else {
    sdf90::consumer_start(wg);
    const Consumer c{wg, sdf90::stage_base(s.stage[wg]), sdf90::copy_base(s.stage[wg])};
    unsigned stashed = 0;
    if constexpr (kStash<In>) stashed = In::full ? FULL_PLAN : args.in.plan.stashed;
    RingPos pos;
    for (long long t = 2LL * blockIdx.x + wg;; t += 2LL * gridDim.x) {
      if (!sdf90::consumers_any(t < args.tiles)) break;
      tile(s, args, c, pos, t, stashed);
    }
    sdf90::consumer_finish(s, wg);
  }
}

// The rows pass of one chunk: `w` [6, out, in] and `wt` [6, in, out] bf16
// stacks; args.tiles is set here.
template <class In>
inline cudaError_t rows_pass(const void* w, const void* wt, Args<In> args, int device, cudaStream_t stream) {
  struct WeightMaps {
    CUtensorMap w, wt;
  };
  static sdf90::LastOf<std::pair<const void*, const void*>, WeightMaps> weight_maps;
  static sdf90::OncePerDevice smem_limit;
  WeightMaps maps;
  cudaError_t err = weight_maps.get({w, wt}, &maps, [&](WeightMaps* m) {
    const cudaError_t e = sdf90::weight_map(&m->w, w);
    return e != cudaSuccess ? e : sdf90::weight_map(&m->wt, wt);
  });
  if (err != cudaSuccess) return err;
  const int smem = static_cast<int>(sizeof(Smem)) + 1024;
  err = smem_limit(device, [&] {
    return cudaFuncSetAttribute(bwd_rows_sm90_kernel<In>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  });
  if (err != cudaSuccess) return err;
  int sms = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  args.tiles = (static_cast<long long>(args.points) + ROWS - 1) / ROWS * args.shapes;
  const long long pairs = (args.tiles + CONSUMERS - 1) / CONSUMERS;
  const unsigned blocks = static_cast<unsigned>(pairs < sms ? pairs : sms);
  bwd_rows_sm90_kernel<In><<<blocks, sdf90::THREADS, smem, stream>>>(maps.w, maps.wt, args);
  return cudaGetLastError();
}

}  // namespace sdf90_bwd
}  // namespace
