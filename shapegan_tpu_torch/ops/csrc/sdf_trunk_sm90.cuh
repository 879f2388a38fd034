// The Hopper trunk of the SDF kernels: the points forward (sdf_points.cu,
// B3), the sphere trace (sdf_trace.cu, B4), the grid forward and its stash
// instance (sdf_grid.cu, B1 and B5a), the rowwise forward (sdf_rowwise.cu,
// B6a), the point-GAN generator (point_gen.cu, B7: the ring and the products,
// with a LayerNorm epilogue of its own) and the rows pass of the backwards
// B2, B5b and B6b (sdf_grid_bwd_sm90.cuh). The ring, the products and the
// epilogue below are templates over the block's shared-memory layout and
// the ring's depth, so each kernel sizes its own.
//
// What bounds it on the H100: per row, six bf16 256x256 products on the
// tensor cores (6 x 2 x 256 x 256 flops); device-memory traffic is a few
// dozen bytes a row, so the work is the products. The design, part by part:
//
// * wgmma. A consumer warpgroup owns 64 rows and runs
//   wgmma.mma_async.m64n256k16 (bf16 in, float32 accumulate: 128 accumulator
//   registers a thread). B is a weight K-slice in shared memory: w's
//   [out][in] rows are the K-major B operand, 128-byte swizzled.
// * Activations in registers. A layer's epilogue rounds each product to bf16,
//   adds the bias (layer 5: pp5, then zz5) at the rounding points below,
//   applies relu and packs the result as the register A operand of the next
//   layer's wgmma: the m64nN accumulator layout is the m64k16 A-fragment
//   layout for 16-bit types. No activation tile lives in shared memory.
// * Warp specialization. Three warpgroups: two consumers (setmaxnreg.inc to
//   240) and one producer (setmaxnreg.dec to 24). The consumers take turns
//   through two named barriers: one issues a layer's products while the
//   other runs its epilogue (ping-pong).
// * A ring that never restarts. The weights are constant for the launch. The
//   producer's one thread cycles the 24 K-slices (6 layers x 4 slices of
//   256 out x 64 in, 32 KB) through a STAGES-deep ring by TMA (a tensor map
//   over w, encoded on the host through cudaGetDriverEntryPoint, passed as a
//   __grid_constant__ parameter), under full/empty mbarriers, across layers,
//   evaluations and tiles. Both consumers read each slice; it is refilled
//   once both have released it.
// * Persistent blocks. One block per SM; the kernels loop over work inside
//   (sdf_points.cu: 64-row tiles; sdf_trace.cu: lanes refilled per slot).
//   The consumers vote once per evaluation whether either has work left;
//   when neither has, the producer stops and waits for its last copies.
// On the H100 at 700 W this runs B3 at ~0.70 and B4 at ~0.61 of their
// bounds' rates; ping-pong and the 6-stage ring were chosen by
// kernel_variants.py (PERF.md). A kernel that stages tiles on their way to
// device memory (B5a, the backwards' rows pass) cuts its ring to 4 stages.
//
// Rounding points (the Pallas kernels', shapegan_tpu/ops/sdf_mlp_pallas.py
// _points_trunk): the float32 xyz rounded to bf16; the K=3 projections as
// float32 sums of bf16 products, rounded to bf16; layer 1 relu(pp1 + zz1)
// rounded to bf16; each trunk product accumulated in float32 and rounded to
// bf16 BEFORE the bias is added (the sum rounded to bf16); layer 5 adds pp5,
// rounds, adds zz5, rounds; relu. The head is tanh(h7 . w8 + b8) in float32:
// each thread sums its 64 columns of a row in ascending column order
// (fmaf), then the 4 lanes of its quad add theirs by two xor shuffles
// (lanes 1 apart, then 2 apart), then b8 is added.
//
// Layout contract with the Python wrappers (ops/sdf_mlp_kernels.py):
//   w    [6, 256(out), 256(in)] bf16: w2, w3, w4, w5h, w6, w7, transposed
//   b    [8, 256] bf16: rows b2, b3, b4, <unused>, b6, b7, b8 broadcast, <unused>
//   w8   [256] bf16: the head weight as a row
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>
#include <type_traits>

namespace sdf90 {

constexpr int WIDTH = 256;
constexpr int K_CHUNK = 64;                        // input features per weight slice
constexpr int LAYERS = 6;                          // w2, w3, w4, w5h, w6, w7
constexpr int CHUNKS_PER_LAYER = WIDTH / K_CHUNK;
constexpr int CHUNKS = LAYERS * CHUNKS_PER_LAYER;  // slices of one evaluation
constexpr int SKIP_LAYER = 3;                      // w5h: adds pp5 + zz5 instead of a bias
constexpr int HEAD_BIAS_ROW = 6;
constexpr int STAGES = 6;                          // depth of the weight ring
constexpr int SLICE_BYTES = WIDTH * K_CHUNK * 2;   // 32 KB
constexpr int CONSUMERS = 2;                       // consumer warpgroups
constexpr int ROWS = 64;                           // rows of one consumer warpgroup
constexpr int THREADS = 128 * (CONSUMERS + 1);     // consumers first, then the producer
constexpr int PRODUCER_THREAD = 128 * CONSUMERS;
constexpr int BLOCK_ROWS = ROWS * CONSUMERS;
// A consumer waits for a layer's four slices before it releases any.
static_assert(STAGES >= CHUNKS_PER_LAYER, "the ring must hold a whole layer");
// Named barriers (0 is __syncthreads): the consumers' vote, and each
// consumer's turn to issue products.
constexpr int VOTE_BARRIER = 1;
constexpr int TURN_BARRIER = 2;  // + consumer index

struct __align__(1024) Smem {
  __nv_bfloat16 ring[STAGES][WIDTH * K_CHUNK];  // 1024-byte aligned: the swizzle atom
  float bias[8][WIDTH];
  float w1p[3][WIDTH];
  float w5p[3][WIDTH];
  float zz1[WIDTH];
  float zz5[WIDTH];
  float w8[WIDTH];
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
  int done;  // set once the consumers have voted to stop
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ bool bar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  while (!bar_try_wait(bar, parity)) {
  }
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Named barriers over `count` threads.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// True in every consumer thread if `v` is true in any (a barrier over both
// consumer warpgroups, which also orders their shared-memory accesses).
__device__ __forceinline__ bool consumers_any(bool v) {
  uint32_t r;
  asm volatile(
      "{\n"
      ".reg .pred p, q;\n"
      "setp.ne.u32 q, %1, 0;\n"
      "bar.red.or.pred p, %2, %3, q;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(r)
      : "r"(static_cast<uint32_t>(v)), "n"(VOTE_BARRIER), "n"(128 * CONSUMERS)
      : "memory");
  return r != 0;
}

// ------------------------------------------------------------------ TMA

// Slice `chunk` of w (layer chunk / 4, input features 64 (chunk % 4) ...
// + 63, all 256 outputs) into `dst`, completing on `bar`.
__device__ __forceinline__ void load_slice(void* dst, const CUtensorMap* map, int chunk, uint64_t* bar) {
  const int k0 = (chunk % CHUNKS_PER_LAYER) * K_CHUNK;
  const int row0 = (chunk / CHUNKS_PER_LAYER) * WIDTH;
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(k0), "r"(row0)
      : "memory");
}

// ---------------------------------------------------------------- wgmma

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across the points
// where the asynchronous products read or write them.
__device__ __forceinline__ void fence_operand(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a 256 x 64 bf16 K-major slice, 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1024 bytes apart (SBO), LBO unused (1). Adding 2
// advances K by 16 elements (32 bytes) inside the swizzle atom.
__device__ __forceinline__ uint64_t slice_desc(const void* slice) {
  return static_cast<uint64_t>((smem_addr(slice) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 256, float32) = A (64 x 16, bf16, registers) * B (16 x 256 from
// the descriptor) + (scale_d ? d : 0).
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], const uint32_t (&a)[4], uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// -------------------------------------------------------- host: the map

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched through the runtime (so the library needs
// no -lcuda) on the first call.
inline cudaError_t tiled_encoder(EncodeTiledFn* out) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  *out = encode;
  return cudaSuccess;
}

// The TMA map of w [6 * 256 rows, 256] bf16 in boxes of 256 rows x 64
// columns, 128-byte swizzled.
inline cudaError_t weight_map(CUtensorMap* map, const void* w) {
  EncodeTiledFn encode;
  const cudaError_t err = tiled_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {WIDTH, LAYERS * WIDTH};
  const cuuint64_t strides[1] = {WIDTH * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {K_CHUNK, WIDTH};
  const cuuint32_t element_strides[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims, strides,
                            box, element_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Host steps of a call site that need not run on every call, so that a
// kernel's launch waits on as little host work as it can.
//
// OncePerDevice: set() (a kernel's shared-memory limit, an attribute of the
// function on a device) runs until it first succeeds on a device.
class OncePerDevice {
 public:
  template <class F>
  cudaError_t operator()(int device, F&& set) {
    if (device < 0 || device >= 64) return set();
    const unsigned long long bit = 1ull << device;
    if (done_.load(std::memory_order_acquire) & bit) return cudaSuccess;
    const cudaError_t err = set();
    if (err == cudaSuccess) done_.fetch_or(bit, std::memory_order_release);
    return err;
  }

 private:
  std::atomic<unsigned long long> done_{0};
};

// LastOf: the value made for the last key. For values that are functions of
// their key alone, as a tensor map is of its address and rows: a training
// loop of equal batches gets the same blocks from PyTorch's caching
// allocator call after call, and encodes its maps once.
template <class Key, class Value>
class LastOf {
 public:
  template <class F>
  cudaError_t get(const Key& key, Value* out, F&& make) {
    {
      std::lock_guard<std::mutex> lock(mutex_);
      if (valid_ && key == key_) {
        *out = value_;
        return cudaSuccess;
      }
    }
    const cudaError_t err = make(out);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> lock(mutex_);
    key_ = key;
    value_ = *out;
    valid_ = true;
    return cudaSuccess;
  }

 private:
  std::mutex mutex_;
  bool valid_ = false;
  Key key_{};
  Value value_{};
};

// The block's shared memory from the dynamic allocation (which the host
// sizes as sizeof(T) + 1024), aligned to the swizzle atom.
template <class T>
__device__ __forceinline__ T& aligned_smem(unsigned char* raw) {
  return *reinterpret_cast<T*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
}

// ----------------------------------------------------------- the block

// One thread: the N-stage ring's barriers and the stop flag of s
// initialized, and the tensor map prefetched.
template <int N, class S>
__device__ __forceinline__ void ring_init(S& s, const CUtensorMap* map) {
  for (int i = 0; i < N; ++i) {
    bar_init(&s.full[i], 1);
    bar_init(&s.empty[i], CONSUMERS);
  }
  s.done = 0;
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// dst[i] = float(src[i]) for i < n, over the block's threads.
__device__ __forceinline__ void to_float(float* dst, const __nv_bfloat16* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n; i += THREADS) dst[i] = __bfloat162float(src[i]);
}

// Every thread: the small operands into shared memory as floats; thread 0
// initializes the ring's barriers. Ends with the block's only __syncthreads.
__device__ __forceinline__ void setup(Smem& s, const CUtensorMap* map, const __nv_bfloat16* __restrict__ bias,
                                      const __nv_bfloat16* __restrict__ w8,
                                      const __nv_bfloat16* __restrict__ w1p,
                                      const __nv_bfloat16* __restrict__ w5p,
                                      const __nv_bfloat16* __restrict__ zz1,
                                      const __nv_bfloat16* __restrict__ zz5) {
  to_float(s.bias[0], bias, 8 * WIDTH);
  to_float(s.w1p[0], w1p, 3 * WIDTH);
  to_float(s.w5p[0], w5p, 3 * WIDTH);
  to_float(s.zz1, zz1, WIDTH);
  to_float(s.zz5, zz5, WIDTH);
  to_float(s.w8, w8, WIDTH);
  if (threadIdx.x == 0) ring_init<STAGES>(s, map);
  __syncthreads();
}

template <class S>
__device__ __forceinline__ bool stopped(const S& s) {
  return *reinterpret_cast<const volatile int*>(&s.done) != 0;
}

// A position in an N-stage ring: the stage, and the parity of that stage's
// fill (the fill count's low bit), advanced one slice at a time (no
// division).
template <int N>
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == N) {
      stage = 0;
      phase ^= 1u;
    }
  }
};
using RingPos = Ring<STAGES>;

// The producer's wait for its last copies, `issued` in all, to land (the
// ring's position is the next stage it would fill).
template <int N, class S>
__device__ __forceinline__ void drain(S& s, const Ring<N>& pos, int issued) {
  for (int i = 0; i < N && i < issued; ++i)
    bar_wait(&s.full[i], i < pos.stage ? pos.phase : pos.phase ^ 1u);
}

// The producer's one thread: the slices in order through the N-stage ring
// of s, for as long as the consumers run; then it waits until its last
// copies have landed (a block must not exit with copies in flight).
template <int N = STAGES, class S>
__device__ __forceinline__ void produce(S& s, const CUtensorMap* map) {
  Ring<N> pos;
  int chunk = 0, issued = 0;
  for (;;) {
    bool stop = stopped(s);
    if (issued >= N)  // both consumers have released this stage's last fill
      while (!stop && !bar_try_wait(&s.empty[pos.stage], pos.phase ^ 1u)) stop = stopped(s);
    if (stop) break;
    bar_expect(&s.full[pos.stage], SLICE_BYTES);
    load_slice(s.ring[pos.stage], map, chunk, &s.full[pos.stage]);
    chunk = chunk + 1 == CHUNKS ? 0 : chunk + 1;
    ++issued;
    pos.next();
  }
  drain(s, pos, issued);
}

// The producer's one thread when the block's work is known at launch: the
// first `slices` slices in order through the N-stage ring, then it waits
// for its last copies. It waits only on stages that a consumer will
// release, so the block ends with its consumers. (`produce` stops on the
// consumers' flag, which it reads between waits on a stage that no consumer
// will release any more: mbarrier.try_wait may hold it there up to its
// suspend time limit first.)
template <int N = STAGES, class S>
__device__ __forceinline__ void produce_slices(S& s, const CUtensorMap* map, long long slices) {
  Ring<N> pos;
  int chunk = 0;
  for (long long i = 0; i < slices; ++i) {
    if (i >= N) bar_wait(&s.empty[pos.stage], pos.phase ^ 1u);  // both consumers released its last fill
    bar_expect(&s.full[pos.stage], SLICE_BYTES);
    load_slice(s.ring[pos.stage], map, chunk, &s.full[pos.stage]);
    chunk = chunk + 1 == CHUNKS ? 0 : chunk + 1;
    pos.next();
  }
  drain(s, pos, static_cast<int>(slices < N ? slices : N));
}

// The evaluations of this block when its consumers take tiles 2 block +
// warpgroup, then every 2 x grid, of `tiles` and vote per tile
// (consumers_any): both run every round, one past the end on an empty tile.
// Each evaluation takes CHUNKS slices.
__device__ __forceinline__ long long block_rounds(long long tiles) {
  const long long first = 2LL * blockIdx.x, step = 2LL * gridDim.x;
  return first < tiles ? (tiles - first + step - 1) / step : 0;
}

// Consumer warpgroup frees a stage (one arrival a warpgroup).
template <class S>
__device__ __forceinline__ void release(S& s, int stage) {
  // Predicated in the instruction, not branched: a divergent path among the
  // products would make ptxas serialize the wgmmas.
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(smem_addr(&s.empty[stage])),
      "r"(threadIdx.x & 127)
      : "memory");
}

// One layer's products over the next four slices of the ring, in consumer
// warpgroup wg's turn: d = a @ slice^T. The turn covers issuing the 16
// wgmmas (one commit group a slice); the other consumer may issue its own
// as soon as these are queued, while this one runs `between` (e.g. copies
// of a staged tile out to device memory), then waits for them slice by
// slice, releasing each stage, and then runs its epilogue.
template <class S, int N, class Between>
__device__ __forceinline__ void layer_products(S& s, int wg, Ring<N>& pos, const uint32_t (&a)[16][4],
                                               float (&d)[128], Between between) {
  int stage[CHUNKS_PER_LAYER];
  named_sync(TURN_BARRIER + wg, 128 * CONSUMERS);
  fence_operand(d);
#pragma unroll
  for (int kc = 0; kc < CHUNKS_PER_LAYER; ++kc) {
    stage[kc] = pos.stage;
    bar_wait(&s.full[pos.stage], pos.phase);
    if (kc == 0) wgmma_fence();
    const uint64_t desc = slice_desc(s.ring[pos.stage]);
#pragma unroll
    for (int kk = 0; kk < K_CHUNK / 16; ++kk) wgmma_m64n256k16(d, a[4 * kc + kk], desc + 2 * kk, kc | kk);
    wgmma_commit();
    pos.next();
  }
  named_arrive(TURN_BARRIER + (1 - wg), 128 * CONSUMERS);  // the other consumer's turn
  between();
  wgmma_wait<3>();
  release(s, stage[0]);
  wgmma_wait<2>();
  release(s, stage[1]);
  wgmma_wait<1>();
  release(s, stage[2]);
  wgmma_wait<0>();
  fence_operand(d);
  release(s, stage[3]);
}

template <class S, int N>
__device__ __forceinline__ void layer_products(S& s, int wg, Ring<N>& pos, const uint32_t (&a)[16][4],
                                               float (&d)[128]) {
  layer_products(s, wg, pos, a, d, [] {});
}

// The epilogues round in pairs: one cvt.rn.bf16x2 rounds two float32 values
// to nearest even and packs them (the A-operand format); unpacking is two
// integer operations, and relu is exact on the packed bf16 pair.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ uint32_t relu_bf16(uint32_t u) {
  const __nv_bfloat162 v = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&u), __float2bfloat162_rn(0.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 pair(const float* row, int col) {
  return *reinterpret_cast<const float2*>(row + col);
}

// A column pair of p @ wp, given the pair of each of wp's three rows (w0,
// w1, w2): float32 sums of the bf16 products, x first, then y and z by FMA,
// not rounded (the rowwise backward B6b and the generator B7 add them
// unrounded) ...
__device__ __forceinline__ float2 project_f32(const float3 p, const float2 w0, const float2 w1, const float2 w2) {
  float a0 = p.x * w0.x;
  float a1 = p.x * w0.y;
  a0 = fmaf(p.y, w1.x, a0);
  a1 = fmaf(p.y, w1.y, a1);
  a0 = fmaf(p.z, w2.x, a0);
  a1 = fmaf(p.z, w2.y, a1);
  return make_float2(a0, a1);
}

// ... and columns col and col + 1 of p @ wp rounded to bf16 (the forward
// kernels).
__device__ __forceinline__ float2 project(const float3 p, const float (*wp)[WIDTH], int col) {
  const float2 a = project_f32(p, pair(wp[0], col), pair(wp[1], col), pair(wp[2], col));
  return unpack_bf16(pack_bf16(a.x, a.y));
}

enum EpilogueKind { kBias, kSkip, kHead };

// A layer's epilogue over the accumulator d: each product rounded to bf16,
// (kSkip) plus the row's pp5 pair, rounded, plus the bf16 pair of `add`,
// rounded, relu. kBias and kSkip pack the result into a, the next layer's A
// operand (and kHead too when kPackHead: h7 for a stash plane); kHead
// returns tanh(h7 . w8 + b8) of both rows (the order of the sum: see the top
// of this file). add(c): the bias (or a shape's zz5) pair at columns c,
// c + 1, the same for both rows; or add(j, h, c): row r0 + 8 h's own pair
// (B6a's zz5); skip(j, h, c): the pp5 pair of row r0 + 8 h at those
// columns. A per-row add and skip are read before a[j / 2][2 (j % 2) + h]
// is written, so either may come from those registers.
template <int KIND, bool kPackHead = false, class Add, class Skip>
__device__ __forceinline__ float2 trunk_epilogue(const float (&d)[128], uint32_t (&a)[16][4], Add add,
                                                 Skip skip, const float* w8, const float* b8) {
  constexpr bool kRowAdd = std::is_invocable_v<const Add&, int, int, int>;
  const int q = threadIdx.x & 3;
  float head[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int c = 8 * j + 2 * q;
    float2 b;
    if constexpr (!kRowAdd) b = add(c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (kRowAdd) b = add(j, h, c);
      float2 v = unpack_bf16(pack_bf16(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]));
      if (KIND == kSkip) {
        const float2 pp = skip(j, h, c);
        v = unpack_bf16(pack_bf16(v.x + pp.x, v.y + pp.y));
      }
      const uint32_t x = relu_bf16(pack_bf16(v.x + b.x, v.y + b.y));
      if (KIND == kHead) {
        const float2 f = unpack_bf16(x), w = pair(w8, c);
        head[h] = fmaf(f.x, w.x, head[h]);
        head[h] = fmaf(f.y, w.y, head[h]);
      }
      if (KIND != kHead || kPackHead) a[j / 2][2 * (j % 2) + h] = x;
    }
  }
  if constexpr (KIND == kHead) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      head[h] += __shfl_xor_sync(0xffffffffu, head[h], 1);
      head[h] += __shfl_xor_sync(0xffffffffu, head[h], 2);
      head[h] = tanhf(head[h] + *b8);
    }
  }
  return make_float2(head[0], head[1]);
}

// The bias pair of a float row in shared memory, as trunk_epilogue's add.
struct RowPair {
  const float* row;
  __device__ __forceinline__ float2 operator()(int c) const { return pair(row, c); }
};

// B3's and B4's epilogue: the row `add` in shared memory, pp5 projected from
// the rows' points p0 and p1 in the kernel.
template <int KIND>
__device__ __forceinline__ float2 epilogue(const Smem& s, const float (&d)[128], uint32_t (&a)[16][4],
                                           const float* add, const float3 p0, const float3 p1) {
  return trunk_epilogue<KIND>(
      d, a, RowPair{add}, [&](int, int h, int c) { return project(h ? p1 : p0, s.w5p, c); }, s.w8,
      &s.bias[HEAD_BIAS_ROW][0]);
}

// The SDF of the two rows a consumer thread holds: row r0 = 16 warp + lane / 4
// of its warpgroup's 64 and row r0 + 8, whose bf16-rounded points are p0 and
// p1. Every consumer thread of both warpgroups calls it together; each
// thread returns both rows' values (the same in the 4 lanes of a quad).
//
// A-fragment register a[kk][2 half + h]: row r0 + 8 h, columns
// 16 kk + 8 half + 2 (lane % 4) + {0, 1}. Accumulator d[4 j + 2 h + e]: row
// r0 + 8 h, column 8 j + 2 (lane % 4) + e.
__device__ __forceinline__ float2 evaluate(Smem& s, int wg, RingPos& pos, const float3 p0, const float3 p1) {
  const int q = threadIdx.x & 3;
  uint32_t a[16][4];
#pragma unroll
  for (int kk = 0; kk < 16; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = 16 * kk + 8 * half + 2 * q;
      const float2 z = pair(s.zz1, c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 pp = project(h ? p1 : p0, s.w1p, c);
        a[kk][2 * half + h] = relu_bf16(pack_bf16(pp.x + z.x, pp.y + z.y));
      }
    }

  float d[128];
#pragma unroll
  for (int layer = 0; layer < SKIP_LAYER; ++layer) {
    layer_products(s, wg, pos, a, d);
    epilogue<kBias>(s, d, a, s.bias[layer], p0, p1);
  }
  layer_products(s, wg, pos, a, d);
  epilogue<kSkip>(s, d, a, s.zz5, p0, p1);
  layer_products(s, wg, pos, a, d);
  epilogue<kBias>(s, d, a, s.bias[SKIP_LAYER + 1], p0, p1);
  layer_products(s, wg, pos, a, d);
  return epilogue<kHead>(s, d, a, s.bias[LAYERS - 1], p0, p1);
}

// A consumer warpgroup's entry: takes its registers and, in the second
// warpgroup, opens the first turn to the first.
__device__ __forceinline__ void consumer_start(int wg) {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  if (wg == 1) named_arrive(TURN_BARRIER + 0, 128 * CONSUMERS);
}

// A consumer warpgroup's exit after the vote to stop: the first warpgroup
// takes the second's last turn signal, so no barrier is left half-arrived,
// and stops the producer.
template <class S>
__device__ __forceinline__ void consumer_finish(S& s, int wg) {
  if (wg == 0) {
    named_sync(TURN_BARRIER + 0, 128 * CONSUMERS);
    if (threadIdx.x == 0) *reinterpret_cast<volatile int*>(&s.done) = 1;
  }
}

__device__ __forceinline__ void producer_start() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
}

}  // namespace sdf90
