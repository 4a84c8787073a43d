// Scandots K3: the 132-point terrain scan of every env, the conservative
// floor height min(node, +x, +y) at each point's floor node, with the
// movable layers and the seesaw tilt folded in bfloat16.
//
// Replaces agility_tpu/physics/windows.py:measure_scandots_band (Pallas
// kernel at windows.py:448, pallas_call at :205 via _band_call :187; point
// sampling at :472-487).  Its plain version is agility_tpu_torch/physics/
// patch.py:measure_scandots_batch, which it matches bit for bit:
//
//   x0, y0  = the env's window origin (rint half to even, clamped), from the
//             scan centre and the window size P
//   gx      = clamp((px - ox) / hs - x0, 0, P - 1.001)    row, window-relative
//   gy      = clamp((py - oy) / hs, y0, (y0 + P) - 1.001) column, absolute
//   node    = (x0 + floor(gx), floor(gy)), and its +x and +y neighbours
//   fold    = bf16(height); v = bf16(v + bf16(bf16(lever) * bf16(w[L-1])));
//             v = bf16(v + (layer_id == l + 1 ? bf16(w[l]) : 0)) per layer
//   out     = min of the three folded nodes, as float32
//
// Each bf16 multiply or add is computed in f32 on bf16 inputs and rounded
// once (__float2bfloat16_rn), which is what torch (and XLA) do for a bf16
// op; the explicit _rn intrinsics keep nvcc from contracting into an FMA.
//
// Bound: memory latency.  Per point it reads three nodes of up to three
// surfaces (9 bytes a node) and writes 4 bytes: at N = 6144, K = 132 about
// 22 MB, under 10 us of bandwidth, and the scan windows of envs on one
// course share L2 lines.  The TPU kernel DMA'd each env's whole 34-cell
// window band, folded and min'd it in VMEM, then selected points with
// one-hot products; on Hopper no window is materialised: one thread per
// (env, point) computes the env's origin, gathers its three nodes, folds
// and takes the min.  Neighbouring threads are neighbouring points of one
// env, so their nodes fall in the same few rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWeights = 8;

__device__ __forceinline__ long long window_start(float c, float o, float hs, int P, int n) {
  long long s = (long long)rintf(__fdiv_rn(__fsub_rn(c, o), hs)) - P / 2;
  long long hi = n - P > 0 ? n - P : 0;
  return s < 0 ? 0 : (s > hi ? hi : s);
}

__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float fold_node(const float* __restrict__ height,
                                           const float* __restrict__ lever,
                                           const int8_t* __restrict__ layer_id,
                                           long long idx, bool tilt, float w_tilt,
                                           const float* wl, int nl) {
  float v = bf(height[idx]);
  if (tilt) v = bf(__fadd_rn(v, bf(__fmul_rn(bf(lever[idx]), w_tilt))));
  if (nl > 0) {
    const int t = layer_id[idx];
    for (int l = 0; l < nl; ++l) v = bf(__fadd_rn(v, t == l + 1 ? wl[l] : 0.0f));
  }
  return v;
}

__global__ void scandots_kernel(const float* __restrict__ height,
                                const float* __restrict__ lever,
                                const int8_t* __restrict__ layer_id,
                                const float* __restrict__ centers,
                                const float* __restrict__ weights,
                                const float* __restrict__ px,
                                const float* __restrict__ py, int N, int K, int L,
                                int H, int W, float ox, float oy, float hs, int P,
                                float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)N * K) return;
  const int n = (int)(t / K);
  const long long x0 = window_start(centers[2 * n], ox, hs, P, H);
  const long long y0 = window_start(centers[2 * n + 1], oy, hs, P, W);

  const float row_hi = (float)((double)P - 1.001);
  float gx = __fsub_rn(__fdiv_rn(__fsub_rn(px[t], ox), hs), (float)x0);
  gx = fminf(fmaxf(gx, 0.0f), row_hi);
  float gy = __fdiv_rn(__fsub_rn(py[t], oy), hs);
  gy = fminf(fmaxf(gy, (float)y0), __fsub_rn((float)(y0 + P), 1.001f));
  const long long r = x0 + (long long)floorf(gx);
  const long long c = (long long)floorf(gy);

  // bf16-rounded weights: the tilt multiplier w[L-1] (with a lever) and the
  // layer offsets w[0 .. nl-1]
  const float* w = weights ? weights + (size_t)n * L : nullptr;
  const bool tilt = w && lever;
  const int nl = (w && layer_id) ? L - (lever ? 1 : 0) : 0;
  const float w_tilt = tilt ? bf(w[L - 1]) : 0.0f;
  float wl[kMaxWeights];
  for (int l = 0; l < nl; ++l) wl[l] = bf(w[l]);

  const long long i0 = r * W + c;
  const float a = fold_node(height, lever, layer_id, i0, tilt, w_tilt, wl, nl);
  const float b = fold_node(height, lever, layer_id, i0 + W, tilt, w_tilt, wl, nl);
  const float d = fold_node(height, lever, layer_id, i0 + 1, tilt, w_tilt, wl, nl);
  out[t] = fminf(fminf(a, b), d);
}

}  // namespace

extern "C" int scandots_launch(const void* height, const void* lever, const void* layer_id,
                               const void* centers, const void* weights, const void* px,
                               const void* py, int N, int K, int L, int H, int W, float ox,
                               float oy, float hs, int P, void* out, void* stream) {
  if (L > kMaxWeights) return (int)cudaErrorInvalidValue;
  const long long total = (long long)N * K;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  scandots_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)height, (const float*)lever, (const int8_t*)layer_id,
      (const float*)centers, (const float*)weights, (const float*)px, (const float*)py, N,
      K, L, H, W, ox, oy, hs, P, (float*)out);
  return (int)cudaGetLastError();
}
