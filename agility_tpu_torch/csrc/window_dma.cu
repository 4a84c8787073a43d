// Window DMA, D and E: the two per-env window copies of the window
// extraction A/B (agility_tpu_torch/tools/bench_windows.py).  Both are
// pure copies, generic over the element width (float32: 4 bytes,
// bfloat16: 2 bytes; the bits are moved, never converted), so they are
// bit-exact with their plain versions in kernels/window_dma.py.
//
// D replaces tools/bench_windows.py:pallas_windows (kernel :224,
// pallas_call :262): each env's (K, P, Pc) window of the K stacked
// surfaces G (K, H, W) at its exact origin (x0, y0), one async DMA an env
// on the TPU, no fold, no clamp:
//
//   out[n, k, i, j] = G[k, x0[n] + i, y0[n] + j]
//
// The TPU's DMA reads whatever lies at that offset.  Here no read leaves
// G: a cell whose row x0 + i is outside [0, H) or whose column y0 + j is
// outside [0, W) is written as zero (the plain version's rule too).
//
// E replaces tools/bench_windows.py:pallas_band_dma (kernel :169,
// pallas_call :200): each env's (P8, KB) slab of the band stack G2
// (nb, Hp, KB), with JAX's clips kept exactly (floor division):
//
//   x0a = clip((x0 // al) * al, 0, Hp - P8)
//   yb  = clip(y0 // stride, 0, nb - 1)
//   out[n] = G2[yb, x0a : x0a + P8, :]
//
// A slab is P8 whole rows of G2, so it is one contiguous run of P8 * KB
// elements; the clips keep it inside G2 whenever Hp >= P8 (the wrapper
// checks that).
//
// Bound: bytes.  Nothing is computed; every output element is written once
// and comes from one input element.  At N = 6144 the outputs are 125.8 MB
// (D, f32, K 5, P 32) and 377.5 / 251.7 / 201.3 MB (E at f32 P 32, bf16 P 56,
// bf16 P 36), 0.04-0.11 ms at 3.35 TB/s before the distinct cells read.
//
// Design.  D, where its tensor map allows it (route "tma",
// kernels/window_dma.py:per_env_config: W * esz % 16 == 0, G 16-byte
// aligned, a box of at most 256 in each dim and two stages in shared
// memory): persistent blocks, block b taking envs b, b + grid, ..., stream
// each env's window through a ring of stages in shared memory, one 3-d TMA
// box an env.  The tensor map covers G as (K, H, W), copied as 32- or
// 16-bit words (bit-exact, NaN payloads included).  A box starts at column
// y0 & ~(v - 1), v = 16 / esz elements (a TMA box whose first column is not
// 16-byte aligned faults on the H100), so it is bw = Pc + v - 1 rounded up
// to v columns wide, P rows and K surfaces deep, and the window starts
// y0 & (v - 1) columns into it (as K2's box does, window_ring.cuh).  Cells
// off the grid, whole windows too, arrive as the tensor map's zero fill: D's
// rule without a test a cell; a 3-d map (not K * H rows in 2-d) keeps a
// window's rows past H zero instead of the next surface's.  The ring has two
// stages: thread 0 keeps the next env's box in flight (its origin read one
// env ahead) while every warp drains the current stage, each thread building
// 16-byte vectors of the env's output block from two aligned 16-byte
// shared loads shifted into place (a vector that runs into the window's
// next row merges two such loads), and storing them with streaming stores
// (st.global.cs: the output is not read again, so it leaves the L2 to the
// surfaces; plain stores were 3-8% slower).  The block's own __syncthreads
// frees a stage for its next box;
// no second set of "empty" barriers was built: with 3 and 4 stages a block
// (more stages, fewer resident blocks) the H100 times each of the three
// shapes within 2% of 2 stages, 2 the fastest or tied (PERF.md,
// window_dma_sweep.py), so a block is not held by its one barrier an env.
// Direct stores, not a compacted block and one bulk store: an output block
// need not be 16-byte aligned or sized (K P Pc esz), and stores from
// registers keep no shared memory busy.  What holds the float32 shape
// near half its bound is the surfaces' reads: its five 1800 x 1800 float32
// surfaces (64.8 MB) do not fit the 50 MB L2, so the cells that several
// windows share come from device memory again; no L2 promotion or
// evict-last hint on the boxes changed that (PERF.md, window_dma_sweep.py).
// The route "rows" (every other grid, e.g. an odd width): one block per
// env, a warp a row, lanes along the row: a row whose source and
// destination are 16-byte aligned and inside G moves in 16-byte vectors,
// any other row element by element with the bounds test.
//
// E: one block per env, a simple copy (the TPU kernel's DMA engine has no
// counterpart to copy).  Its slab is 16-byte aligned (KB is a multiple of
// 128 elements), so the block copies it in 16-byte vectors when the base
// pointers are 16-byte aligned, else element by element.
#include <cstdint>

#include "window_ring.cuh"

using namespace window_ring;

namespace {

constexpr int kThreads = 256;        // the "rows" route's and E's blocks
constexpr int kStagesD = 2;          // D's ring (kernels/window_dma.py:STAGES)
constexpr int kBarBytesD = 16 * kStagesD;      // per stage: its mbarrier and its env's y0
constexpr int kMaxBox = 256;         // a TMA box's limit in each dim

__device__ __forceinline__ int floor_div(int a, int b) {   // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// D: block n copies env n's K * P rows of Pc elements.
template <typename T>
__global__ void __launch_bounds__(kThreads)
per_env_windows_kernel(const T* __restrict__ g, const int* __restrict__ x0,
                       const int* __restrict__ y0, T* __restrict__ out, int K, int H, int W,
                       int P, int Pc) {
  const int n = blockIdx.x;
  const int ex = __ldg(x0 + n), ey = __ldg(y0 + n);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kPerVec = 16 / sizeof(T);
  const bool cols_in = ey >= 0 && ey <= W - Pc;
  T* o = out + (long long)n * K * P * Pc;
  for (int row = warp; row < K * P; row += kThreads / 32) {
    const int k = row / P;
    const int x = ex + row - k * P;
    T* dst = o + (long long)row * Pc;
    if (x < 0 || x >= H) {                     // the whole row lies outside G
      for (int j = lane; j < Pc; j += 32) dst[j] = T(0);
      continue;
    }
    const T* src = g + ((long long)k * H + x) * W;
    if (cols_in && Pc % kPerVec == 0 && aligned16(src + ey) && aligned16(dst)) {
      const uint4* s4 = reinterpret_cast<const uint4*>(src + ey);
      uint4* d4 = reinterpret_cast<uint4*>(dst);
      for (int v = lane; v < Pc / kPerVec; v += 32) d4[v] = __ldg(s4 + v);
      continue;
    }
    for (int j = lane; j < Pc; j += 32) {
      const int y = ey + j;
      dst[j] = (y >= 0 && y < W) ? __ldg(src + y) : T(0);
    }
  }
}

// The 16 bytes of a stage from element m on (any m), as 4 words: the two
// aligned 16-byte words around them, shifted into place.  The second is
// read only when needed, so nothing past the element m + v - 1 is read.
template <typename T>
__device__ __forceinline__ uint4 stage_vec(const unsigned char* st, int m) {
  constexpr int v = 16 / sizeof(T);
  const int c = m & ~(v - 1), off = m & (v - 1);
  const uint4 a = *reinterpret_cast<const uint4*>(st + c * (int)sizeof(T));
  if (off == 0) return a;
  const uint4 b = *reinterpret_cast<const uint4*>(st + (c + v) * (int)sizeof(T));
  const int ow = sizeof(T) == 4 ? off : off >> 1;   // whole words to skip
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t x[6], y[5];
#pragma unroll
  for (int i = 0; i < 6; ++i) x[i] = (ow & 2) ? w[i + 2] : w[i];
#pragma unroll
  for (int i = 0; i < 5; ++i) y[i] = (ow & 1) ? x[i + 1] : x[i];
  if (sizeof(T) == 4) return make_uint4(y[0], y[1], y[2], y[3]);
  const int sh = (off & 1) * 16;                    // an odd bfloat16 offset: half a word
  return make_uint4(__funnelshift_r(y[0], y[1], sh), __funnelshift_r(y[1], y[2], sh),
                    __funnelshift_r(y[2], y[3], sh), __funnelshift_r(y[3], y[4], sh));
}

// The first `a` elements (0 < a < v) of u, the rest of t.
template <typename T>
__device__ __forceinline__ uint4 merge_vec(uint4 u, uint4 t, int a) {
  const int keep = a * (int)sizeof(T);              // bytes of u
  uint32_t m[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = keep - 4 * i;
    m[i] = k >= 4 ? 0xffffffffu : (k <= 0 ? 0u : (1u << (8 * k)) - 1u);
  }
  return make_uint4((u.x & m[0]) | (t.x & ~m[0]), (u.y & m[1]) | (t.y & ~m[1]),
                    (u.z & m[2]) | (t.z & ~m[2]), (u.w & m[3]) | (t.w & ~m[3]));
}

// D, route "tma": persistent blocks; env k of block b (n = b + k * grid)
// lands in stage k % kStagesD as one (K, P, bw) box at (0, x0, y0 & ~(v - 1)),
// then every thread writes its 16-byte vectors of the env's output block,
// element e of the block being row e / Pc, column e % Pc of the window, at
// element (e / Pc) * bw + (y0 & (v - 1)) + e % Pc of the stage.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
per_env_windows_tma_kernel(const __grid_constant__ CUtensorMap map, const int* __restrict__ x0,
                           const int* __restrict__ y0, T* __restrict__ out, int N, int K, int P,
                           int Pc, int bw, int pitch) {
  constexpr int v = 16 / sizeof(T);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned_base(smem_raw);
  constexpr int stages = kStagesD;
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(base + stages * pitch);
  int* s_y0 = reinterpret_cast<int*>(bar + stages);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nloc = block_envs(N);
  const int B = K * P * Pc;                          // elements an env
  const int tx = bw * P * K * (int)sizeof(T);
  auto env = [&](int k) { return (long long)blockIdx.x + (long long)k * gridDim.x; };
  // thread 0: env k's box into its stage
  auto issue = [&](int k, int ex, int ey) {
    const int s = k % stages;
    fence_proxy_async();   // the stage's last reads came before the block's barrier
    s_y0[s] = ey;
    mbar_expect_tx(&bar[s], tx);
    tma_load_3d(base + s * pitch, &map, 0, ex, ey & ~(v - 1), &bar[s]);
  };
  int px = 0, py = 0;      // thread 0: the origin of the next env to issue
  if (tid == 0) {
    init_barriers(bar, 1, stages);
    for (int k = 0; k < stages - 1 && k < nloc; ++k)
      issue(k, __ldg(x0 + env(k)), __ldg(y0 + env(k)));
    if (stages - 1 < nloc) {
      px = __ldg(x0 + env(stages - 1));
      py = __ldg(y0 + env(stages - 1));
    }
  }
  __syncthreads();

  // a thread's vectors advance nt * v elements: dr rows and dj columns
  const int dr = nt * v / Pc, dj = nt * v - dr * Pc;
  for (int k = 0; k < nloc; ++k) {
    if (tid == 0 && k + stages - 1 < nloc) {
      issue(k + stages - 1, px, py);
      if (k + stages < nloc) {
        px = __ldg(x0 + env(k + stages));
        py = __ldg(y0 + env(k + stages));
      }
    }
    const int s = k % stages;
    mbar_wait(&bar[s], (k / stages) & 1);
    const unsigned char* st = base + s * pitch;
    const T* se = reinterpret_cast<const T*>(st);
    const int dy = s_y0[s] & (v - 1);
    const long long n = env(k);
    T* o = out + n * B;
    // the block's elements [a0, a0 + nv * v) are whole aligned 16-byte
    // vectors; the rest (where B * esz is no multiple of 16) go one by one
    const int mis = (int)((n * B) % v);
    const int a0 = min(mis ? v - mis : 0, B);
    const int nv = (B - a0) / v;
    const int rest = B - nv * v;                     // a0 before, rest - a0 after
    if (Pc >= v) {
      int e = a0 + tid * v;
      int r = e / Pc, j = e - r * Pc;
      for (int q = tid; q < nv; q += nt) {
        uint4 val = stage_vec<T>(st, r * bw + dy + j);
        const int a = Pc - j;                        // elements left in row r
        if (a < v) val = merge_vec<T>(val, stage_vec<T>(st, (r + 1) * bw + dy - a), a);
        __stcs(reinterpret_cast<uint4*>(o + a0) + q, val);
        r += dr;
        j += dj;
        if (j >= Pc) {
          j -= Pc;
          ++r;
        }
      }
    } else {
      // windows narrower than a vector: element by element into the words
      for (int q = tid; q < nv; q += nt) {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int u = 0; u < v; ++u) {
          const int e = a0 + q * v + u;
          const uint32_t x = se[(e / Pc) * bw + dy + e % Pc];
          w[u * sizeof(T) / 4] |= x << (8 * (u * sizeof(T) % 4));
        }
        __stcs(reinterpret_cast<uint4*>(o + a0) + q, make_uint4(w[0], w[1], w[2], w[3]));
      }
    }
    for (int t = tid; t < rest; t += nt) {
      const int e = t < a0 ? t : a0 + nv * v + (t - a0);
      o[e] = se[(e / Pc) * bw + dy + e % Pc];
    }
    __syncthreads();   // stage s is read: it takes env k + stages
  }
}

// E: block n copies env n's slab, P8 * KB contiguous elements.
template <typename T>
__global__ void __launch_bounds__(kThreads)
band_windows_kernel(const T* __restrict__ g2, const int* __restrict__ x0,
                    const int* __restrict__ y0, T* __restrict__ out, int nb, int Hp, int KB,
                    int P8, int stride, int al, int vec) {
  const int n = blockIdx.x;
  const int x0a = min(max(floor_div(__ldg(x0 + n), al) * al, 0), Hp - P8);
  const int yb = min(max(floor_div(__ldg(y0 + n), stride), 0), nb - 1);
  const long long count = (long long)P8 * KB;
  const T* src = g2 + ((long long)yb * Hp + x0a) * KB;
  T* dst = out + (long long)n * count;
  if (vec) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    const long long n4 = count * sizeof(T) / 16;
    for (long long v = threadIdx.x; v < n4; v += kThreads) d4[v] = __ldg(s4 + v);
  } else {
    for (long long e = threadIdx.x; e < count; e += kThreads) dst[e] = __ldg(src + e);
  }
}

// Let D's "tma" kernel take up to kMaxSmem bytes of dynamic shared memory
// on the current device: set once a device, so a launch pays for it once.
template <typename T>
int allow_smem_d() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  int e = (int)cudaGetDevice(&dev);
  if (e != 0 || (dev < kMaxDevices && done[dev])) return e;
  e = (int)cudaFuncSetAttribute(per_env_windows_tma_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == 0 && dev < kMaxDevices) done[dev] = true;
  return e;
}

}  // namespace

// Blocks of D's "tma" route, `threads` threads and `smem` bytes, that fit
// on one SM (esz 4 or 2), or -cudaError.
extern "C" int window_dma_per_env_blocks_per_sm(int threads, int smem, int esz) {
  if (esz != 2 && esz != 4) return -(int)cudaErrorInvalidValue;
  int e = esz == 4 ? allow_smem_d<uint32_t>() : allow_smem_d<uint16_t>();
  if (e != 0) return -e;
  int blocks = 0;
  e = esz == 4 ? (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &blocks, per_env_windows_tma_kernel<uint32_t>, threads, (size_t)smem)
               : (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &blocks, per_env_windows_tma_kernel<uint16_t>, threads, (size_t)smem);
  return e != 0 ? -e : blocks;
}

// D.  esz: bytes an element (4: float32, 2: bfloat16).  route 1 ("tma")
// takes the launch parameters of kernels/window_dma.py:per_env_config and
// checks them; route 0 ("rows") one block of kThreads an env (threads,
// grid = N; bw, smem 0).  Returns a cudaError_t.
extern "C" int window_dma_per_env_launch(const void* g, const void* x0, const void* y0,
                                         void* out, int N, int K, int H, int W, int P, int Pc,
                                         int esz, int route, int threads, int bw, int smem,
                                         int grid, void* stream) {
  if (N < 1 || K < 1 || H < 1 || W < 1 || P < 1 || Pc < 1 || (esz != 2 && esz != 4))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (route == 0) {
    if (threads != kThreads || grid != N || bw != 0 || smem != 0)
      return (int)cudaErrorInvalidValue;
    if (esz == 4)
      per_env_windows_kernel<uint32_t><<<N, kThreads, 0, s>>>(
          (const uint32_t*)g, (const int*)x0, (const int*)y0, (uint32_t*)out, K, H, W, P, Pc);
    else
      per_env_windows_kernel<uint16_t><<<N, kThreads, 0, s>>>(
          (const uint16_t*)g, (const int*)x0, (const int*)y0, (uint16_t*)out, K, H, W, P, Pc);
    return (int)cudaGetLastError();
  }
  const int v = 16 / esz;
  const int pitch = round128(bw * P * K * esz);
  const bool ok = route == 1 && (long long)W * esz % 16 == 0 &&
                  ((reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(out)) & 15) == 0 &&
                  bw == (Pc + 2 * v - 2) / v * v && bw <= kMaxBox && P <= kMaxBox &&
                  K <= kMaxBox && (long long)K * P * Pc <= 0x7fffffff &&
                  smem == kAlignPad + kStagesD * pitch + kBarBytesD &&
                  smem <= kMaxSmem && threads >= 32 && threads <= kMaxThreads &&
                  threads % 32 == 0 && grid >= 1 && grid <= N;
  if (!ok) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int dims[3] = {W, H, K}, box[3] = {bw, P, K};
  int e = tiled_map(&map, esz == 4 ? CU_TENSOR_MAP_DATA_TYPE_UINT32 : CU_TENSOR_MAP_DATA_TYPE_UINT16,
                    esz, g, 3, dims, box);
  if (e != 0) return e;
  e = esz == 4 ? allow_smem_d<uint32_t>() : allow_smem_d<uint16_t>();
  if (e != 0) return e;
  if (esz == 4)
    per_env_windows_tma_kernel<uint32_t><<<grid, threads, smem, s>>>(
        map, (const int*)x0, (const int*)y0, (uint32_t*)out, N, K, P, Pc, bw, pitch);
  else
    per_env_windows_tma_kernel<uint16_t><<<grid, threads, smem, s>>>(
        map, (const int*)x0, (const int*)y0, (uint16_t*)out, N, K, P, Pc, bw, pitch);
  return (int)cudaGetLastError();
}

extern "C" int window_dma_band_launch(const void* g2, const void* x0, const void* y0, void* out,
                                      int N, int nb, int Hp, int KB, int P8, int stride, int al,
                                      int esz, void* stream) {
  if (N < 1 || nb < 1 || P8 < 1 || Hp < P8 || KB < 1 || stride < 1 || al < 1 ||
      (esz != 2 && esz != 4))
    return (int)cudaErrorInvalidValue;
  const int vec = (long long)KB * esz % 16 == 0 &&
                  ((reinterpret_cast<uintptr_t>(g2) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (esz == 4)
    band_windows_kernel<uint32_t><<<N, kThreads, 0, s>>>(
        (const uint32_t*)g2, (const int*)x0, (const int*)y0, (uint32_t*)out, nb, Hp, KB, P8,
        stride, al, vec);
  else
    band_windows_kernel<uint16_t><<<N, kThreads, 0, s>>>(
        (const uint16_t*)g2, (const int*)x0, (const int*)y0, (uint16_t*)out, nb, Hp, KB, P8,
        stride, al, vec);
  return (int)cudaGetLastError();
}
