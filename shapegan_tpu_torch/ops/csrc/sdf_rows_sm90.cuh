// The rows of a 64-row tile over the point grid, for the Hopper grid kernels
// (sdf_grid.cu: B1 and its stash instance B5a; sdf_grid_bwd_sm90.cuh: B2's
// rows pass) and the row kernels (sdf_rowwise.cu: B6a, one "shape" of N
// rows; point_gen.cu: B7's predicated loads and stores): the tile order,
// predicated access to per-row operands, and the staged stores of a bf16
// tile to a [shapes x P, 256] plane.
//
// * Tile order. Tile t is shape t % shapes over points 64 (t / shapes) on,
//   so the shapes' tiles of one point tile run back to back and their rows
//   of pp1 and pp5 come from L2. A tile past the end has no rows: its loads
//   and stores are predicated off (no branch among the products).
// * Staged stores. An epilogue writes its packed tile (the A-operand layout)
//   into the consumer's 64 x 256 staging tile in shared memory (16
//   stmatrix.x4 a thread, 128-byte swizzled: free of bank conflicts); each
//   warp later copies its own 16 rows out with 16-byte stores, one whole
//   512-byte row a warp store, once the next layer's products are queued
//   (only __syncwarp between, no block barrier).
#pragma once

#include <utility>

#include "sdf_trunk_sm90.cuh"

namespace sdf90 {

using bf16 = __nv_bfloat16;

constexpr int BOX = 64;                    // a staging box: 64 rows x 64 columns
constexpr int BOX_BYTES = ROWS * BOX * 2;  // 8 KB, 128-byte swizzled

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

// The bf16 pair of a shape's row in device memory (zz1, zz5), as
// trunk_epilogue's add.
struct ShapePair {
  const bf16* row;
  __device__ __forceinline__ float2 operator()(int c) const { return unpack_bf16(shape_pair(row, c)); }
};

// A row's pair of a tile loaded into the A registers that the epilogue's
// result replaces (load_tile below), as trunk_epilogue's per-row add or its
// skip: B1's pp5, B6a's zz5.
struct RegisterPair {
  const uint32_t (&a)[16][4];
  __device__ __forceinline__ float2 operator()(int j, int h, int) const {
    return unpack_bf16(a[j / 2][2 * (j % 2) + h]);
  }
};

// ------------------------------------------------------------ the tile

// A consumer thread's rows of its tile: r0 = 16 warp + lane / 4 of the
// warpgroup's 64 and r0 + 8, at columns 8 i + 2 (lane % 4) + {0, 1}.
struct Rows {
  long long row;  // plane row of r0: shape x P + point
  int point;      // point of r0
  int shape;
  int r0;
  int count;      // rows of the tile that exist (0 past the end)
  __device__ __forceinline__ bool ok(int hh) const { return r0 + 8 * hh < count; }
};

__device__ __forceinline__ Rows rows_of(long long tile, int shapes, int points, long long tiles) {
  const int t = threadIdx.x & 127;
  const int r0 = (t >> 5) * 16 + ((t & 31) >> 2);
  Rows r;
  r.shape = static_cast<int>(tile % shapes);
  const int p0 = static_cast<int>(tile / shapes) * ROWS;
  r.r0 = r0;
  r.point = p0 + r0;
  r.count = tile < tiles ? min(ROWS, points - p0) : 0;
  r.row = static_cast<long long>(r.shape) * points + r.point;
  return r;
}

// Element (row r0 + 8 hh, column 2 (lane % 4)) of a [*, 256] array whose row
// r0 is `row`.
template <class T>
__device__ __forceinline__ T* at(T* base, long long row, int hh) {
  return base + (row + 8 * hh) * WIDTH + 2 * (threadIdx.x & 3);
}

// The packed tile a of the rows of r: each thread's pairs of rows r0 and
// r0 + 8 from `base` ([*, 256] bf16, row r0 at `row`), zero where a row does
// not exist.
__device__ __forceinline__ void load_tile(uint32_t (&a)[16][4], const bf16* base, long long row, const Rows& r) {
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) a[i / 2][2 * (i % 2) + hh] = load_pair(at(base, row, hh) + 8 * i, r.ok(hh));
}

// ----------------------------------------------------- the staged stores

// A consumer thread's row address in a staging tile for stmatrix: matrix
// m = lane / 8 of each x4 covers rows + 8 (m & 1) and columns + 8 (m >> 1)
// of a 16 x 16 block (the A-fragment registers a[j][m]). Block j lies in
// box j / 4 at the 16-byte chunk 2 (j % 4) + (m >> 1) of the row, which the
// 128-byte swizzle xors with the row's low three bits: the chunk is
// y ^ 2 (j % 4) with y = (m >> 1) ^ (row % 8), so the address is this base
// xor 32 (j % 4), plus the box's offset.
__device__ __forceinline__ uint32_t stage_base(const void* tile) {
  const int t = threadIdx.x & 127, lane = t & 31, m = lane >> 3;
  const int row = (t >> 5) * 16 + (m & 1) * 8 + (lane & 7);
  const int y = (m >> 1) ^ (lane & 7);
  return smem_addr(tile) + row * 128 + (y << 4);
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

// A lane's address for copying its warp's 16 staged rows out: box lane / 8,
// logical chunk lane % 8 (columns 8 lane .. 8 lane + 7) of the warp's first
// row; row R of the warp is this xor 16 (R % 8), plus 128 R.
__device__ __forceinline__ uint32_t copy_base(const void* tile) {
  const int lane = threadIdx.x & 31, row0 = ((threadIdx.x >> 5) & 3) * 16;
  return smem_addr(tile) + (lane >> 3) * BOX_BYTES + row0 * 128 + ((lane & 7) << 4);
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

// A consumer thread's constants: its warpgroup, and its two addresses in
// the warpgroup's staging tile (stage_base, copy_base).
struct Consumer {
  int wg;
  uint32_t stage;
  uint32_t copy;
};

// A staged tile's way out: the lane's first element in the plane (row
// 16 warp of the tile, columns 8 lane ..) and the rows of the warp's 16 that
// exist (none: nothing is copied).
struct Pending {
  bf16* out;
  int rows;
};

// The packed tile a into the staging tile (each warp writes, and later
// copies out, only its own 16 rows), bound for the tile's rows of `plane`.
__device__ __forceinline__ Pending stage(const Consumer& c, const Rows& r, const uint32_t (&a)[16][4],
                                         bf16* plane) {
  __syncwarp();  // the last copy has read the staging rows
  stage_blocks(c.stage, a, std::make_integer_sequence<int, 16>{});
  __syncwarp();
  const int row0 = ((threadIdx.x >> 5) & 3) * 16;
  return {plane + (r.row - r.r0 + row0) * WIDTH + 8 * (threadIdx.x & 31), r.count - row0};
}

// The staged rows out to their plane: a whole 512-byte row a warp store.
__device__ __forceinline__ void copy_out(const Consumer& c, const Pending& p) {
  copy_rows(c.copy, p.out, p.rows, std::make_integer_sequence<int, 16>{});
}

}  // namespace sdf90
