// Terrain window K2: each env's (P, P) window of the course surfaces at the
// clamped origin around its base, with the movable layers, the seesaw tilt
// and the ceiling folded in.
//
// Replaces agility_tpu/physics/windows.py:extract_band_batch (Pallas kernel
// at windows.py:341, pallas_call at :205, via _band_call :187, _dma_loops
// :212 and _fold_floor :237).  Its plain version is
// agility_tpu_torch/physics/patch.py:extract_batch, which it matches bit for
// bit:
//
//   x0 = clamp(rint((cx - ox) / hs) - P/2, 0, max(H - P, 0))   (y0 alike)
//   floor[i][j] = height + lever * w[L-1]            (lever and weights given)
//               + w[l] where layer_id == l + 1        (one add per layer)
//   ceil[i][j]  = ceiling + w[l] where ceiling_layer == l + 1
//
// at grid node (x0 + i, y0 + j).  rintf rounds half to even like torch.round;
// every multiply, add and divide is an explicit round-to-nearest intrinsic,
// so nvcc cannot contract h + lev * w into one FMA.  Absent surfaces and
// weights are null pointers.
//
// Bound: memory latency.  Per env it reads P*P cells of up to five surfaces
// (14 bytes a cell with every surface) and writes 4 or 8 bytes a cell: at
// N = 6144, P = 32 about 86 MB read and 50 MB written, ~40 us at 3.35 TB/s,
// and the windows of envs on the same course overlap in L2.  The TPU kernel
// DMA'd one replicated column band per env because its gather was slow; on
// Hopper the surfaces are read in place (no band stack).  Design: one block
// per env, 256 threads walking the window row-major, so a warp reads 32
// consecutive columns of one row (128-byte coalesced rows of each f32
// surface) and writes its output rows contiguously.  Each thread recomputes
// the env's origin (two divides), which is cheaper than a second pass.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ long long window_start(float c, float o, float hs, int P, int n) {
  long long s = (long long)rintf(__fdiv_rn(__fsub_rn(c, o), hs)) - P / 2;
  long long hi = n - P > 0 ? n - P : 0;
  return s < 0 ? 0 : (s > hi ? hi : s);
}

__device__ __forceinline__ float fold_layers(float v, const int8_t* tags, long long idx,
                                             const float* w, int nl) {
  const int t = tags[idx];
  for (int l = 0; l < nl; ++l) v = __fadd_rn(v, t == l + 1 ? w[l] : 0.0f);
  return v;
}

__global__ void terrain_window_kernel(
    const float* __restrict__ height, const float* __restrict__ lever,
    const int8_t* __restrict__ layer_id, const float* __restrict__ ceiling,
    const int8_t* __restrict__ ceiling_layer, const float* __restrict__ centers,
    const float* __restrict__ weights, int L, int H, int W, float ox, float oy,
    float hs, int P, float* __restrict__ values, float* __restrict__ ceil_out,
    int64_t* __restrict__ x0_out, int64_t* __restrict__ y0_out) {
  const int n = blockIdx.x;
  const long long x0 = window_start(centers[2 * n], ox, hs, P, H);
  const long long y0 = window_start(centers[2 * n + 1], oy, hs, P, W);
  if (threadIdx.x == 0) {
    x0_out[n] = x0;
    y0_out[n] = y0;
  }
  const float* w = weights ? weights + (size_t)n * L : nullptr;
  const bool tilt = w && lever;
  const int nl = w ? L - (lever ? 1 : 0) : 0;      // layer weights w[0 .. nl-1]
  const size_t out0 = (size_t)n * P * P;
  for (int c = threadIdx.x; c < P * P; c += blockDim.x) {
    const long long idx = (x0 + c / P) * W + (y0 + c % P);
    float v = height[idx];
    if (tilt) v = __fadd_rn(v, __fmul_rn(lever[idx], w[L - 1]));
    if (layer_id && nl > 0) v = fold_layers(v, layer_id, idx, w, nl);
    values[out0 + c] = v;
    if (ceiling) {
      float cv = ceiling[idx];
      if (ceiling_layer && nl > 0) cv = fold_layers(cv, ceiling_layer, idx, w, nl);
      ceil_out[out0 + c] = cv;
    }
  }
}

}  // namespace

extern "C" int terrain_window_launch(const void* height, const void* lever,
                                     const void* layer_id, const void* ceiling,
                                     const void* ceiling_layer, const void* centers,
                                     const void* weights, int N, int L, int H, int W,
                                     float ox, float oy, float hs, int P, void* values,
                                     void* ceil_out, void* x0_out, void* y0_out,
                                     void* stream) {
  terrain_window_kernel<<<N, 256, 0, (cudaStream_t)stream>>>(
      (const float*)height, (const float*)lever, (const int8_t*)layer_id,
      (const float*)ceiling, (const int8_t*)ceiling_layer, (const float*)centers,
      (const float*)weights, L, H, W, ox, oy, hs, P, (float*)values, (float*)ceil_out,
      (int64_t*)x0_out, (int64_t*)y0_out);
  return (int)cudaGetLastError();
}
