// What the terrain-window kernels K2 (terrain_window.cu) and K3
// (scandots.cu) share: the window origin (window_start), the grid geometry
// and the limits; and the skeleton of K2's staged design, which it runs
// where W % 4 == 0: persistent blocks that walk their envs n = blockIdx.x,
// blockIdx.x + gridDim.x, ... and stream each env's window of every surface
// through a ring of kStages stages in shared memory, each stage completing
// on its mbarrier.
//
// Layout of a block's dynamic shared memory, from a 128-byte aligned base
// (the launcher asks for kAlignPad bytes more than it uses):
//   kStages stages, each of n_f32 float32 boxes (P rows x bw floats,
//   box_bytes apart) then n_i8 int8 boxes (P rows x bw bytes, tag_bytes
//   apart; both sizes multiples of 128) | the env ring | kStages mbarriers
//
// The float32 boxes are TMA 2D tiled loads.  The int8 tag surfaces cannot
// be (a TMA row pitch must be a multiple of 16 bytes, and the course grid's
// is 1800), so their boxes are 4-byte cp.async copies, one word a thread at
// a time, arriving on the same mbarrier.  Both need W % 4 == 0 (16-byte
// float rows, 4-byte aligned tag words), every grid the paths use.  A box
// starts at column y0 & ~3 (a TMA box whose first column is not 16-byte
// aligned faults on the H100), so it is bw = P + 3 rounded up to 4 columns
// wide and the window starts y0 & 3 columns into it.
//
// The env ring holds the window origins (x0, y0) and the weights of a
// block's next envs, kRing of them, indexed by the env's place in the
// block's walk.  One warp fills 32 at a time, ahead of their use, so that no
// copy and no load waits on a centre's load and its two divides.
//
// D's "tma" route (window_dma.cu) uses the barriers, the 3-d TMA load and
// the tensor-map cache (tiled_map, any rank up to 3 and element type) with
// a ring of its own.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace window_ring {

constexpr int kStages = 3;
constexpr int kRing = 64;           // envs held; one warp refills 32 at a time
constexpr int kAlignPad = 128;      // the stages' boxes start 128-byte aligned
constexpr int kMaxSmem = 232448;    // 227 KB, the most a block can use on Hopper
constexpr int kMaxThreads = 512;
constexpr int kMaxWeights = 8;

// One env of the ring: its window origin and its weights.
struct EnvSlot {
  int x0, y0;
  float w[kMaxWeights];
};

__host__ __device__ inline int ring_bytes() { return kRing * (int)sizeof(EnvSlot) + kStages * 8; }

__host__ __device__ inline int round128(int x) { return (x + 127) & ~127; }

// Bytes of one stage's float32 box and int8 box for windows of P cells.
__host__ __device__ inline int box_bytes(int P, int bw) { return round128(P * bw * 4); }
__host__ __device__ inline int tag_bytes(int P, int bw) { return round128(P * bw); }

// Bytes of dynamic shared memory for stages of n_f32 float32 and n_i8 int8
// boxes.
__host__ __device__ inline int smem_bytes(int P, int bw, int n_f32, int n_i8) {
  return kAlignPad + kStages * (n_f32 * box_bytes(P, bw) + n_i8 * tag_bytes(P, bw)) +
         ring_bytes();
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The 128-byte aligned base of the dynamic shared memory `raw`.
__device__ __forceinline__ unsigned char* aligned_base(unsigned char* raw) {
  return raw + ((kAlignPad - (smem_addr(raw) & (kAlignPad - 1))) & (kAlignPad - 1));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// The box of `map` whose first element is (row, col) of the surface, into
// `dst` (128-byte aligned), completing on `bar`.  Columns past the
// surface's width arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int row, int col,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(smem_addr(bar))
      : "memory");
}

// The box of the 3-d `map` whose first element is (k, row, col), into `dst`
// (128-byte aligned), completing on `bar`.  Elements outside the tensor,
// negative coordinates included, arrive as zeros and count towards the
// box's bytes.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int k, int row,
                                            int col, unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(k), "r"(smem_addr(bar))
      : "memory");
}

// One 4-byte asynchronous copy.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// `bar` counts one arrival when this thread's earlier cp.async copies have
// landed.
__device__ __forceinline__ void cp_async_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Where a thread's words of an int8 (P, bw) box start, row-major over the
// box's bw / 4 words a row: word tid, then every T-th, walked without a
// divide a word.
struct TagWalk {
  int r0, w0, dr, dw;
};

__device__ __forceinline__ TagWalk tag_walk(int bw, int tid, int T) {
  const int wpr = bw / 4;
  return TagWalk{tid / wpr, tid % wpr, T / wpr, T % wpr};
}

// This thread's words of an int8 surface's (P, bw) box at (x0, c0)
// (c0 % 4 == 0, W % 4 == 0) into dst as 4-byte cp.async copies; words past
// the grid's last column are skipped.
__device__ __forceinline__ void copy_tags(unsigned char* dst, const int8_t* src, int W, int P,
                                          int bw, int x0, int c0, const TagWalk& tw) {
  const int wpr = bw / 4;
  for (int r = tw.r0, w = tw.w0; r < P;) {
    const int col = c0 + 4 * w;
    if (col < W) cp_async4(dst + r * bw + 4 * w, src + (x0 + r) * W + col);
    r += tw.dr;
    w += tw.dw;
    if (w >= wpr) {
      w -= wpr;
      ++r;
    }
  }
}

// Reads of shared memory by this thread (generic proxy) come before the
// async proxy's next writes there.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Each of `stages` barriers expects `count` arrivals a phase.
__device__ __forceinline__ void init_barriers(unsigned long long* bar, int count,
                                              int stages = kStages) {
  for (int s = 0; s < stages; ++s) mbar_init(&bar[s], count);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The window origin along one axis: the nearest node to the centre less
// P / 2, clamped into [0, max(n - P, 0)].  rintf rounds half to even like
// torch.round; the subtract and divide are explicit round-to-nearest.
__device__ __forceinline__ int window_start(float c, float o, float hs, int P, int n) {
  const int s = (int)rintf(__fdiv_rn(__fsub_rn(c, o), hs)) - P / 2;
  const int hi = n - P > 0 ? n - P : 0;
  return s < 0 ? 0 : (s > hi ? hi : s);
}

// Geometry every window kernel needs.
struct Grid {
  const float* centers;   // (N, 2) world xy of each env's window centre
  int N, H, W, P;
  float ox, oy, hs;
};

// Lane `lane` of the calling warp fills the ring slot of the block's env
// first + lane (a local index, the place in the block's walk): its origin
// and its L weights (where given); where x0_out is given, it writes the
// origin out too.
__device__ __forceinline__ void fill_envs(EnvSlot* ring, const Grid& g, int first, int lane,
                                          const float* weights, int L, int64_t* x0_out,
                                          int64_t* y0_out) {
  const int e = first + lane;
  const long long n = (long long)blockIdx.x + (long long)e * gridDim.x;
  if (n >= g.N) return;
  EnvSlot& s = ring[e % kRing];
  s.x0 = window_start(g.centers[2 * n], g.ox, g.hs, g.P, g.H);
  s.y0 = window_start(g.centers[2 * n + 1], g.oy, g.hs, g.P, g.W);
  if (weights)
    for (int l = 0; l < L; ++l) s.w[l] = weights[n * L + l];
  if (x0_out) {
    x0_out[n] = s.x0;
    y0_out[n] = s.y0;
  }
}

// Envs this block walks.
__device__ __forceinline__ int block_envs(int N) {
  return N > (int)blockIdx.x ? (N - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x : 0;
}

// Phase stamps (-DWINDOW_TRACE only), per block (the first kTraceBlocks):
// %globaltimer (ns) at entry, when its first env's copy landed and at exit,
// the ns it spent waiting for copies, folding and storing, and its envs.
constexpr int kTraceBlocks = 1024, kTraceSlots = 7;
#ifdef WINDOW_TRACE
__device__ unsigned long long trace_buf[kTraceBlocks][kTraceSlots];
__device__ __forceinline__ unsigned long long trace_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void trace_set(int slot, unsigned long long v) {
  if (threadIdx.x == 0 && blockIdx.x < kTraceBlocks) trace_buf[blockIdx.x][slot] = v;
}
#else
__device__ __forceinline__ unsigned long long trace_now() { return 0; }
__device__ __forceinline__ void trace_set(int, unsigned long long) {}
#endif

// ---- host side ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so the
// library needs no -lcuda.
inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = (EncodeTiled)p;
  }
  return fn;
}

// The tiled tensor map of the row-major tensor at `ptr` (16-byte aligned)
// with `rank` dims, dims[0] innermost (dims[0] * esz a multiple of 16), of
// `dtype` elements of esz bytes, in boxes box[0] x ... x box[rank - 1].
// Returns a cudaError.
inline int encode_tiled(CUtensorMap* map, CUtensorMapDataType dtype, int esz, const void* ptr,
                        int rank, const int* dims, const int* box) {
  const EncodeTiled fn = encode_fn();
  if (!fn || rank < 1 || rank > 3) return (int)cudaErrorInvalidValue;
  cuuint64_t gdims[3], strides[2];
  cuuint32_t boxd[3], estr[3];
  cuuint64_t pitch = (cuuint64_t)esz;
  for (int i = 0; i < rank; ++i) {
    gdims[i] = (cuuint64_t)dims[i];
    boxd[i] = (cuuint32_t)box[i];
    estr[i] = 1;
    pitch *= (cuuint64_t)dims[i];
    if (i + 1 < rank) strides[i] = pitch;
  }
  const CUresult r = fn(map, dtype, rank, const_cast<void*>(ptr), gdims, strides, boxd, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// encode_tiled, remembered by the calling host thread for its last
// kMapCache (ptr, dtype, dims, box), which are all the map depends on: a
// run's tensors stay put, so its launches encode nothing.
constexpr int kMapCache = 8;

inline int tiled_map(CUtensorMap* map, CUtensorMapDataType dtype, int esz, const void* ptr,
                     int rank, const int* dims, const int* box) {
  struct Entry {
    CUtensorMap map;
    const void* ptr;
    CUtensorMapDataType dtype;
    int rank, dims[3], box[3];
  };
  static thread_local Entry cache[kMapCache] = {};
  static thread_local int next = 0;
  auto same = [&](const Entry& e) {
    if (e.ptr != ptr || e.dtype != dtype || e.rank != rank) return false;
    for (int i = 0; i < rank; ++i)
      if (e.dims[i] != dims[i] || e.box[i] != box[i]) return false;
    return true;
  };
  for (const Entry& e : cache)
    if (same(e)) {
      *map = e.map;
      return 0;
    }
  Entry& e = cache[next];
  e.ptr = nullptr;
  const int err = encode_tiled(&e.map, dtype, esz, ptr, rank, dims, box);
  if (err != 0) return err;
  e.ptr = ptr;
  e.dtype = dtype;
  e.rank = rank;
  for (int i = 0; i < rank; ++i) {
    e.dims[i] = dims[i];
    e.box[i] = box[i];
  }
  next = (next + 1) % kMapCache;
  *map = e.map;
  return 0;
}

// The map of an (H, W) float32 surface at `ptr` (16-byte aligned, W % 4 ==
// 0) in boxes of P rows by bw columns.
inline int surface_map(CUtensorMap* map, const void* ptr, int H, int W, int P, int bw) {
  const int dims[2] = {W, H}, box[2] = {bw, P};
  return tiled_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, 2, dims, box);
}

}  // namespace window_ring
