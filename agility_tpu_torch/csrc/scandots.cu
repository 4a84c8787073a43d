// Scandots K3: the K-point terrain scan of every env, the conservative
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
//   node    = (x0 + floor(gx), floor(gy)), and its +x and +y neighbours,
//             all three inside the window by construction
//   fold    = bf16(height); v = bf16(v + bf16(bf16(lever) * bf16(w[L-1])));
//             v = bf16(v + (layer_id == l + 1 ? bf16(w[l]) : 0)) per layer
//   out     = min of the three folded nodes, as float32
//
// Each bf16 multiply or add is computed in f32 on bf16 inputs and rounded
// once (__float2bfloat16_rn), which is what torch (and XLA) do for a bf16
// op; the explicit _rn intrinsics keep nvcc from contracting into an FMA.
//
// Bound: bytes, and in practice memory latency.  Per point it reads three
// nodes of up to three surfaces (9 bytes a node) and writes 4 bytes: at
// N = 6144, K = 132 the distinct nodes read and the output are 19.5 MB,
// 5.8 us at 3.35 TB/s.  But memory moves 32-byte sectors, and the scan's
// points, 2 cells apart, touch most sectors of the ~22-34 rows under them,
// in a scattered order.  The TPU kernel DMA'd each env's whole 34-cell
// window band.
//
// Design: one warp per env, 8 envs a block, every env of the call resident
// in about one wave.  A warp takes a group of up to 32 kGroup points (K = 132
// is one group; more groups are more blocks along y), lane l the points
// l, l + 32, ..., and issues every load of its points (px, py, then the
// three nodes of each surface) before it folds any.  Measured on an H100
// (PERF.md, kernel_bench.py), this beat staging each env's window in shared
// memory as K2 does (window_ring.cuh): a whole window, ~11 KB an env, for
// 396 nodes read, folded by a block that walks its envs one after another,
// lost more to the per-env steps than the sector gather costs.
// The wrapper computes the launch parameters (kernels/scandots.py:
// launch_config); scandots_launch checks them before it launches.
#include <cuda_bf16.h>

#include "window_ring.cuh"

using namespace window_ring;

namespace {

struct Args {
  Grid g;
  const float* height;
  const float* lever;          // given only with weights (the tilt)
  const int8_t* layer_id;      // given only when nl > 0
  const float* weights;        // (N, L) or null
  const float* px;
  const float* py;
  float* out;
  int K, L, nl;
};

__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The point's floor node (r, c), relative to the window at (x0, y0).
__device__ __forceinline__ int2 node_of(const Grid& g, float px, float py, int2 org) {
  const float row_hi = (float)((double)g.P - 1.001);
  float gx = __fsub_rn(__fdiv_rn(__fsub_rn(px, g.ox), g.hs), (float)org.x);
  gx = fminf(fmaxf(gx, 0.0f), row_hi);
  float gy = __fdiv_rn(__fsub_rn(py, g.oy), g.hs);
  gy = fminf(fmaxf(gy, (float)org.y), __fsub_rn((float)(org.y + g.P), 1.001f));
  return make_int2((int)floorf(gx), (int)floorf(gy) - org.y);
}

// The bf16 fold of one node's height, lever and tag, with the env's weights
// w: the layer offsets w[0 .. nl-1] and, with a lever, the tilt multiplier
// w_tilt = w[L-1], each rounded to bf16.
__device__ __forceinline__ float fold_node(float h, float lev, int tag, bool tilt, float w_tilt,
                                           const float* w, int nl) {
  float v = bf(h);
  if (tilt) v = bf(__fadd_rn(v, bf(__fmul_rn(bf(lev), bf(w_tilt)))));
#pragma unroll
  for (int l = 0; l < kMaxWeights; ++l)
    if (l < nl) v = bf(__fadd_rn(v, tag == l + 1 ? bf(w[l]) : 0.0f));
  return v;
}

constexpr int kEnvsPerBlock = 8;   // one warp each
constexpr int kGroup = 5;          // points a lane gathers: a warp takes 160, K = 132 in one

// Warp w of block (bx, g) takes env bx * kEnvsPerBlock + w, points
// g * 32 kGroup + lane + 32 m (m < kGroup).
__global__ void __launch_bounds__(32 * kEnvsPerBlock) scandots_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const long long n = (long long)blockIdx.x * kEnvsPerBlock + (threadIdx.x >> 5);
  if (n >= a.g.N) return;
  const int p0 = blockIdx.y * 32 * kGroup + lane;
  const int2 org = make_int2(
      window_start(a.g.centers[2 * n], a.g.ox, a.g.hs, a.g.P, a.g.H),
      window_start(a.g.centers[2 * n + 1], a.g.oy, a.g.hs, a.g.P, a.g.W));
  float px[kGroup], py[kGroup];
#pragma unroll
  for (int m = 0; m < kGroup; ++m) {
    const int p = p0 + 32 * m;
    if (p < a.K) {
      px[m] = __ldg(a.px + n * a.K + p);
      py[m] = __ldg(a.py + n * a.K + p);
    }
  }
  // the env's weights: the layer offsets and, with a lever, the tilt
  float w[kMaxWeights], w_tilt = 0.f;
  if (a.weights) {
#pragma unroll
    for (int l = 0; l < kMaxWeights; ++l)
      if (l < a.L) w[l] = __ldg(a.weights + n * a.L + l);
    if (a.lever) w_tilt = __ldg(a.weights + n * a.L + a.L - 1);
  }
  // every node load of the group before any fold
  float h[kGroup][3], lev[kGroup][3];
  int tag[kGroup][3];
#pragma unroll
  for (int m = 0; m < kGroup; ++m) {
    if (p0 + 32 * m >= a.K) continue;
    const int2 nd = node_of(a.g, px[m], py[m], org);
    const int i0 = (org.x + nd.x) * a.g.W + org.y + nd.y;
    const int idx[3] = {i0, i0 + a.g.W, i0 + 1};   // node, +x, +y
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      h[m][j] = __ldg(a.height + idx[j]);
      if (a.lever) lev[m][j] = __ldg(a.lever + idx[j]);
      if (a.layer_id) tag[m][j] = __ldg(a.layer_id + idx[j]);
    }
  }
#pragma unroll
  for (int m = 0; m < kGroup; ++m) {
    const int p = p0 + 32 * m;
    if (p >= a.K) continue;
    float f[3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      f[j] = fold_node(h[m][j], lev[m][j], tag[m][j], a.lever != nullptr, w_tilt, w,
                       a.layer_id ? a.nl : 0);
    a.out[n * a.K + p] = fminf(fminf(f[0], f[1]), f[2]);
  }
}

}  // namespace

// The launch parameters are those of kernels/scandots.py:launch_config:
// 32 kEnvsPerBlock threads, `grid` = ceil(N / kEnvsPerBlock) blocks by
// `groups` = ceil(K / (32 kGroup)) point groups, no shared memory.
extern "C" int scandots_launch(const void* height, const void* lever, const void* layer_id,
                               const void* centers, const void* weights, const void* px,
                               const void* py, int N, int K, int L, int nl, int H, int W,
                               float ox, float oy, float hs, int P, void* out, int grid,
                               int groups, void* stream) {
  const bool ok = N >= 1 && K >= 1 && P >= 2 && P <= H && P <= W &&
                  (long long)H * W <= 0x7fffffff && L >= 0 && L <= kMaxWeights &&
                  (weights ? nl == L - (lever ? 1 : 0) : nl == 0 && !lever) &&
                  (!layer_id || nl > 0) && grid == (N + kEnvsPerBlock - 1) / kEnvsPerBlock &&
                  groups == (K + 32 * kGroup - 1) / (32 * kGroup);
  if (!ok) return (int)cudaErrorInvalidValue;
  const Args a{Grid{(const float*)centers, N, H, W, P, ox, oy, hs},
               (const float*)height, (const float*)lever, (const int8_t*)layer_id,
               (const float*)weights, (const float*)px, (const float*)py, (float*)out,
               K, L, nl};
  scandots_kernel<<<dim3(grid, groups), 32 * kEnvsPerBlock, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
