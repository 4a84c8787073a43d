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
// Design: one block per env, a simple copy first (the TPU kernels' DMA
// engines have no counterpart to copy; TMA would need 16-byte box rows, and
// a bf16 row of D at P = 36 is 72 bytes).  E's slab is 16-byte aligned
// (KB is a multiple of 128 elements), so the block copies it in 16-byte
// vectors when the base pointers are 16-byte aligned, else element by
// element.  D walks its K * P rows a warp a row, lanes along the row: a row
// whose source and destination are 16-byte aligned and inside G moves in
// 16-byte vectors, any other row element by element with the bounds test.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

}  // namespace

// esz: bytes an element (4: float32, 2: bfloat16).  Returns a cudaError_t.
extern "C" int window_dma_per_env_launch(const void* g, const void* x0, const void* y0,
                                         void* out, int N, int K, int H, int W, int P, int Pc,
                                         int esz, void* stream) {
  if (N < 1 || K < 1 || H < 1 || W < 1 || P < 1 || Pc < 1 || (esz != 2 && esz != 4))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (esz == 4)
    per_env_windows_kernel<uint32_t><<<N, kThreads, 0, s>>>(
        (const uint32_t*)g, (const int*)x0, (const int*)y0, (uint32_t*)out, K, H, W, P, Pc);
  else
    per_env_windows_kernel<uint16_t><<<N, kThreads, 0, s>>>(
        (const uint16_t*)g, (const int*)x0, (const int*)y0, (uint16_t*)out, K, H, W, P, Pc);
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
