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
// so nvcc cannot contract h + lev * w into one FMA.  Absent (or unused)
// surfaces and weights are null pointers.
//
// Bound: bytes, and in practice memory latency and instruction issue.  Per env it reads P*P cells
// of up to five surfaces (14 bytes a cell with every surface) and writes 4
// or 8 bytes a cell: at N = 6144, P = 32 the distinct cells read and the
// windows written are 68.5 MB, 20 us at 3.35 TB/s; the windows of envs on
// one course overlap in L2.  The TPU kernel DMA'd one replicated column band
// per env; on Hopper the surfaces are read in place.
//
// Design, chosen per grid from its width alone (kernels/terrain_window.py:
// routes):
// - W % 4 == 0 (every grid the paths use): persistent blocks
//   (window_ring.cuh).  The origins and weights of a block's coming envs are
//   gathered ahead by one warp; each env's window of every surface is staged
//   two envs ahead in a three-stage shared-memory ring, a TMA 2D tiled load a
//   float32 surface (issued by one thread) and 4-byte cp.async words for the
//   int8 tags (issued by all), on one mbarrier; the fold reads shared memory
//   only.
// - otherwise (a float32 row is then no whole number of 16-byte units, as a
//   TMA tensor map needs): one block per env; a thread computes the env's
//   origin, then issues every load of its cells and of the env's weights
//   before it folds any.
// In both, thread t folds the 4 consecutive cells 4t .. 4t + 3 of the
// row-major window and stores them as one float4 where P is even (each env's
// window is then 16-byte aligned), else as 4 floats.  On an H100 the staged
// design measured faster than the one-block-per-env design at both paths'
// shapes (PERF.md, kernel_bench.py, which times both); what holds it is the
// fold (its instructions, and a barrier an env), not the copies.
// The wrapper computes the launch parameters (kernels/terrain_window.py:
// launch_config); terrain_window_launch checks them before it launches.
#include "window_ring.cuh"

using namespace window_ring;

namespace {

constexpr int kCells = 4;         // consecutive window cells per thread
constexpr int kMaxSize = 45;      // P * P / 4 cells fit kMaxThreads threads

struct Args {
  Grid g;
  const float* height;
  const float* lever;             // given only with weights (the tilt)
  const int8_t* layer_id;         // given only when nl > 0
  const float* ceiling;
  const int8_t* ceiling_layer;    // given only with the ceiling and nl > 0
  const float* weights;           // (N, L) or null
  float* values;
  float* ceil_out;
  int64_t* x0_out;
  int64_t* y0_out;
  int L, nl, bw;
};

// v + w[l] where tag == l + 1, one rounded add per layer (adding 0.0f where
// it is not, as the plain version's torch.where does).
__device__ __forceinline__ float fold_layers(float v, int tag, const float* w, int nl) {
#pragma unroll
  for (int l = 0; l < kMaxWeights; ++l)
    if (l < nl) v = __fadd_rn(v, tag == l + 1 ? w[l] : 0.0f);
  return v;
}

// Thread tid's 4 cells of env n's window: (i, j) of each, and whether it
// is inside the window.
__device__ __forceinline__ void cells_of(int tid, int P, int* ci, int* cj, bool* ok) {
#pragma unroll
  for (int e = 0; e < kCells; ++e) {
    const int c = kCells * tid + e;
    ci[e] = c / P;
    cj[e] = c - ci[e] * P;
    ok[e] = c < P * P;
  }
}

// The 4 folded cells of env n into its windows: one float4 each where P is
// even (a thread's cells then all in or all out), else 4 floats.
__device__ __forceinline__ void store_cells(const Args& a, long long n, int tid,
                                            const float* v, const float* cv, const bool* ok) {
  const int PP = a.g.P * a.g.P;
  float* out = a.values + n * PP;
  float* cout = a.ceil_out + n * PP;
  if (a.g.P % 2 == 0) {
    if (ok[0]) {
      reinterpret_cast<float4*>(out)[tid] = make_float4(v[0], v[1], v[2], v[3]);
      if (a.ceiling)
        reinterpret_cast<float4*>(cout)[tid] = make_float4(cv[0], cv[1], cv[2], cv[3]);
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < kCells; ++e) {
    if (!ok[e]) continue;
    out[kCells * tid + e] = v[e];
    if (a.ceiling) cout[kCells * tid + e] = cv[e];
  }
}

__global__ void __launch_bounds__(kMaxThreads) terrain_window_kernel(const Args a) {
  const long long n = blockIdx.x;
  const int tid = threadIdx.x, P = a.g.P, W = a.g.W;
  const int x0 = window_start(a.g.centers[2 * n], a.g.ox, a.g.hs, P, a.g.H);
  const int y0 = window_start(a.g.centers[2 * n + 1], a.g.oy, a.g.hs, P, W);
  if (tid == 0) {
    a.x0_out[n] = x0;
    a.y0_out[n] = y0;
  }
  int ci[kCells], cj[kCells];
  bool ok[kCells];
  cells_of(tid, P, ci, cj, ok);
  // every load before any fold
  float h[kCells], lev[kCells], cl[kCells];
  int tag[kCells], ctag[kCells];
#pragma unroll
  for (int e = 0; e < kCells; ++e) {
    if (!ok[e]) continue;
    const int idx = (x0 + ci[e]) * W + y0 + cj[e];
    h[e] = __ldg(a.height + idx);
    if (a.lever) lev[e] = __ldg(a.lever + idx);
    if (a.layer_id) tag[e] = __ldg(a.layer_id + idx);
    if (a.ceiling) cl[e] = __ldg(a.ceiling + idx);
    if (a.ceiling_layer) ctag[e] = __ldg(a.ceiling_layer + idx);
  }
  float w[kMaxWeights], wt = 0.f;
  if (a.weights) {
#pragma unroll
    for (int l = 0; l < kMaxWeights; ++l)
      if (l < a.nl) w[l] = __ldg(a.weights + n * a.L + l);
    if (a.lever) wt = __ldg(a.weights + n * a.L + a.L - 1);
  }
  float v[kCells], cv[kCells];
#pragma unroll
  for (int e = 0; e < kCells; ++e) {
    if (!ok[e]) continue;
    float f = h[e];
    if (a.lever) f = __fadd_rn(f, __fmul_rn(lev[e], wt));
    if (a.layer_id) f = fold_layers(f, tag[e], w, a.nl);
    v[e] = f;
    if (a.ceiling) cv[e] = a.ceiling_layer ? fold_layers(cl[e], ctag[e], w, a.nl) : cl[e];
  }
  store_cells(a, n, tid, v, cv, ok);
}

__global__ void __launch_bounds__(kMaxThreads)
    terrain_window_staged_kernel(const Args a, const __grid_constant__ CUtensorMap m_height,
                                 const __grid_constant__ CUtensorMap m_lever,
                                 const __grid_constant__ CUtensorMap m_ceiling) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned_base(smem_raw);
  const int tid = threadIdx.x, T = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int P = a.g.P, bw = a.bw;
  // a stage: the float32 boxes (height, then the lever and the ceiling where
  // given), then the int8 boxes (layer_id, then ceiling_layer, where given)
  const int fb = box_bytes(P, bw), tb = tag_bytes(P, bw);
  const int n_f32 = 1 + (a.lever ? 1 : 0) + (a.ceiling ? 1 : 0);
  const int n_i8 = (a.layer_id ? 1 : 0) + (a.ceiling_layer ? 1 : 0);
  const int lev_off = fb, ceil_off = (a.lever ? 2 : 1) * fb;
  const int tag_off = n_f32 * fb, ctag_off = tag_off + (a.layer_id ? tb : 0);
  const int stage_bytes = n_f32 * fb + n_i8 * tb;
  EnvSlot* ring = reinterpret_cast<EnvSlot*>(base + kStages * stage_bytes);
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(ring + kRing);

  // this thread's cells, as offsets in a stage's box (in elements)
  int ci[kCells], cj[kCells], soff[kCells];
  bool ok[kCells];
  cells_of(tid, P, ci, cj, ok);
#pragma unroll
  for (int e = 0; e < kCells; ++e) soff[e] = ci[e] * bw + cj[e];

  const TagWalk tw = tag_walk(bw, tid, T);
  const int nloc = block_envs(a.g.N);
  unsigned long long t_wait = 0, t_fold = 0, t_store = 0;
  trace_set(0, trace_now());
  // a phase: thread 0's expect_tx arrival, and each thread's cp.async
  // arrival when there are tags to copy
  if (tid == 0) init_barriers(bar, n_i8 ? T + 1 : 1);
  if (warp == 0) {
    fill_envs(ring, a.g, 0, lane, a.weights, a.L, a.x0_out, a.y0_out);
    fill_envs(ring, a.g, 32, lane, a.weights, a.L, a.x0_out, a.y0_out);
  }
  __syncthreads();

  // every thread: env e's boxes into its stage
  auto issue = [&](int e) {
    unsigned char* st = base + (e % kStages) * stage_bytes;
    const int x0 = ring[e % kRing].x0, c0 = ring[e % kRing].y0 & ~3;
    unsigned long long* b = &bar[e % kStages];
    if (tid == 0) {
      fence_proxy_async();   // the stage's last reads came before the barrier
      mbar_expect_tx(b, n_f32 * P * bw * 4);
      tma_load_2d(st, &m_height, x0, c0, b);
      if (a.lever) tma_load_2d(st + lev_off, &m_lever, x0, c0, b);
      if (a.ceiling) tma_load_2d(st + ceil_off, &m_ceiling, x0, c0, b);
    }
    if (n_i8) {
      if (a.layer_id) copy_tags(st + tag_off, a.layer_id, a.g.W, P, bw, x0, c0, tw);
      if (a.ceiling_layer)
        copy_tags(st + ctag_off, a.ceiling_layer, a.g.W, P, bw, x0, c0, tw);
      cp_async_arrive(b);
    }
  };
  if (nloc > 0) issue(0);
  if (nloc > 1) issue(1);

  for (int k = 0; k < nloc; ++k) {
    const long long n = blockIdx.x + (long long)k * gridDim.x;
    if (k % 32 == 0 && k > 0 && warp == 0)
      fill_envs(ring, a.g, k + 32, lane, a.weights, a.L, a.x0_out, a.y0_out);
    if (k + 2 < nloc) issue(k + 2);

    const unsigned long long t0 = trace_now();
    mbar_wait(&bar[k % kStages], (k / kStages) & 1);
    const unsigned long long t1 = trace_now();
    if (k == 0) trace_set(1, t1);
    const EnvSlot& env = ring[k % kRing];
    // the window starts y0 & 3 columns into its boxes
    const unsigned char* st = base + (k % kStages) * stage_bytes;
    const int dy = env.y0 & 3;
    const float* s_h = reinterpret_cast<const float*>(st) + dy;
    const float* s_lev = reinterpret_cast<const float*>(st + lev_off) + dy;
    const float* s_ceil = reinterpret_cast<const float*>(st + ceil_off) + dy;
    const int8_t* s_tag = reinterpret_cast<const int8_t*>(st + tag_off) + dy;
    const int8_t* s_ctag = reinterpret_cast<const int8_t*>(st + ctag_off) + dy;
    const float wt = a.lever ? env.w[a.L - 1] : 0.f;
    float v[kCells], cv[kCells];
#pragma unroll
    for (int e = 0; e < kCells; ++e) {
      if (!ok[e]) continue;
      const int o = soff[e];
      float h = s_h[o];
      if (a.lever) h = __fadd_rn(h, __fmul_rn(s_lev[o], wt));
      if (a.layer_id) h = fold_layers(h, s_tag[o], env.w, a.nl);
      v[e] = h;
      if (a.ceiling) cv[e] = a.ceiling_layer ? fold_layers(s_ceil[o], s_ctag[o], env.w, a.nl)
                                             : s_ceil[o];
    }
    const unsigned long long t2 = trace_now();
    store_cells(a, n, tid, v, cv, ok);
    const unsigned long long t3 = trace_now();
    __syncthreads();   // stage k % kStages is read: it takes env k + 3
    t_wait += t1 - t0;
    t_fold += t2 - t1;
    t_store += t3 - t2;
  }
  trace_set(2, trace_now());
  trace_set(3, t_wait);
  trace_set(4, t_fold);
  trace_set(5, t_store);
  trace_set(6, nloc);
}

// Let the staged kernel take up to kMaxSmem bytes of dynamic shared memory
// on the current device: set once a device, so a launch pays for it once.
int allow_smem() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  int e = (int)cudaGetDevice(&dev);
  if (e != 0 || (dev < kMaxDevices && done[dev])) return e;
  e = (int)cudaFuncSetAttribute(terrain_window_staged_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == 0 && dev < kMaxDevices) done[dev] = true;
  return e;
}

}  // namespace

// Blocks of `threads` threads and `smem` bytes of the staged design that fit
// on one SM, or -cudaError.
extern "C" int terrain_window_blocks_per_sm(int threads, int smem) {
  int e = allow_smem();
  if (e != 0) return -e;
  int blocks = 0;
  e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, terrain_window_staged_kernel,
                                                         threads, (size_t)smem);
  return e != 0 ? -e : blocks;
}

#ifdef WINDOW_TRACE
// Copy the phase stamps of the staged design (kTraceBlocks x kTraceSlots
// uint64) to `host`.
extern "C" int terrain_window_trace(void* host) {
  return (int)cudaMemcpyFromSymbol(host, trace_buf, sizeof(trace_buf));
}
#endif

// The launch parameters are those of kernels/terrain_window.py:
// launch_config: a thread per kCells cells rounded up to whole warps; with
// staged, persistent blocks and the ring's shared memory (W % 4 == 0), else
// one block per env and no shared memory (bw and smem 0).
extern "C" int terrain_window_launch(const void* height, const void* lever,
                                     const void* layer_id, const void* ceiling,
                                     const void* ceiling_layer, const void* centers,
                                     const void* weights, int N, int L, int nl, int H, int W,
                                     float ox, float oy, float hs, int P, void* values,
                                     void* ceil_out, void* x0_out, void* y0_out, int threads,
                                     int bw, int smem, int grid, int staged, void* stream) {
  const int chunks = (P * P + kCells - 1) / kCells;
  const bool ok =
      N >= 1 && P >= 1 && P <= kMaxSize && P <= H && P <= W && (long long)H * W <= 0x7fffffff &&
      L >= 0 && L <= kMaxWeights && (weights ? nl == L - (lever ? 1 : 0) : nl == 0 && !lever) &&
      (layer_id || ceiling_layer ? nl > 0 : true) && (!ceiling_layer || ceiling) &&
      threads == 32 * ((chunks + 31) / 32) && threads <= kMaxThreads;
  if (!ok) return (int)cudaErrorInvalidValue;
  const Args a{Grid{(const float*)centers, N, H, W, P, ox, oy, hs},
               (const float*)height, (const float*)lever, (const int8_t*)layer_id,
               (const float*)ceiling, (const int8_t*)ceiling_layer, (const float*)weights,
               (float*)values, (float*)ceil_out, (int64_t*)x0_out, (int64_t*)y0_out,
               L, nl, bw};
  const cudaStream_t s = (cudaStream_t)stream;
  if (!staged) {
    if (grid != N || smem != 0 || bw != 0) return (int)cudaErrorInvalidValue;
    terrain_window_kernel<<<grid, threads, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  const int n_f32 = 1 + (lever ? 1 : 0) + (ceiling ? 1 : 0);
  const int n_i8 = (layer_id ? 1 : 0) + (ceiling_layer ? 1 : 0);
  const bool aligned = ((uintptr_t)height | (uintptr_t)(lever ? lever : height) |
                        (uintptr_t)(ceiling ? ceiling : height)) % 16 == 0 &&
                       ((uintptr_t)(layer_id ? layer_id : height) |
                        (uintptr_t)(ceiling_layer ? ceiling_layer : height)) % 4 == 0;
  if (!(staged == 1 && W % 4 == 0 && aligned && bw == ((P + 6) & ~3) &&
        smem == smem_bytes(P, bw, n_f32, n_i8) && smem <= kMaxSmem && grid >= 1 && grid <= N))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3] = {};
  const void* src[3] = {height, lever, ceiling};
  for (int i = 0; i < 3; ++i) {
    if (!src[i]) continue;
    const int e = surface_map(&maps[i], src[i], H, W, P, bw);
    if (e != 0) return e;
  }
  const int e = allow_smem();
  if (e != 0) return e;
  terrain_window_staged_kernel<<<grid, threads, smem, s>>>(a, maps[0], maps[1], maps[2]);
  return (int)cudaGetLastError();
}
