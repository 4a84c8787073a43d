// Contact LCP solver K1: projected block-Jacobi on the dense Delassus matrix.
//
// Replaces agility_tpu/physics/pallas_contact.py:_kernel (launched by
// `solve`, pallas_call at pallas_contact.py:85).  Same iteration, plus a
// warm-start input lam0 (the served path, agility_tpu/physics/soa.py:
// jacobi_solve, starts from project(lam0); a cold solve passes lam0 = 0,
// since project(0) = 0):
//
//   lam = project(lam0)
//   repeat iters:
//     v    = G lam + (vf - bias)
//     dlam = -Dinv_s v_s                 (per-contact 3x3 blocks)
//     lam  = project(lam + relax * dlam)
//
//   project: ln = lam.n, lt = lam - ln n, ln = clip(ln, 0, lam_max) * act,
//            lam = lt * min(1, mu ln / max(|lt|, 1e-9)) * act + ln n
//
// The tangent-norm guard is max(|t|, 1e-9) as in soa.jacobi_solve, not the
// Pallas kernel's sqrt(|t|^2 + 1e-18); the two differ only when |t| < 1e-8.
//
// Layout: env-major, contact-interleaved.  Row/column index of G and of every
// (N, 3S) vector is 3*s + a (contact s, component a).  dinv is (N, S, 9),
// row-major 3x3 per contact; act and mu are (N, S).  All float32.
//
// Bound: bytes.  Each env's G is 36 S^2 bytes and is read once; with the
// small vectors K1 moves 95 MB at N = 4096, S = 24 (28 us at 3.35 TB/s) and
// 191 MB at N = 6144, S = 28 (57 us).  The sweeps are 2 iters M^2 flops per
// env, 3 us at the float32 peak.  So the kernel must keep enough of G in
// flight to stream it at the card's memory rate, and sweep an env while the
// next ones load, in less time than they take to arrive.
//
// Design:
// - Persistent blocks.  The wrapper sizes the grid to the blocks that fit on
//   each SM (occupancy query) times the SM count; block b solves envs b,
//   b + gridDim.x, ...
// - A two-stage ring in shared memory, one mbarrier a stage.  Each stage
//   holds one env's G (rows of stride ld) and its vf, bias, n, lam0, act, mu
//   and dinv.  A block moves an env's stage into registers right after it
//   lands, so the stage is free again before the sweeps begin: the copy of
//   the env two grid steps on goes into it then, and the sweeps of env k
//   overlap the loads of the next two.  (At the start a block asks for its
//   first env alone, and for the second once the first has landed.)  The copy width is the template
//   parameter VEC.  VEC == 4 when S % 4 == 0: then ld == M and every segment
//   is a multiple of 16 bytes, so thread 0 copies an env with eight TMA bulk
//   copies (G in one) that complete on the stage's mbarrier (expect_tx).
//   VEC == 1 otherwise: every thread copies its share with 4-byte cp.async
//   and arrives on the same mbarrier when they land (cp.async.mbarrier.
//   arrive.noinc).  Bulk copies rather than 16-byte cp.async: issuing ~1,500
//   cp.async a block per env took ~1.4 us, half of an env's compute, where
//   eight bulk copies from one thread take next to nothing.
// - G in registers, 8 lanes per contact.  The 8 lanes of contact s hold its
//   3 rows of G, lane q the float4 chunks q, q + 8, q + 16 of each row (at
//   most 3 chunks: 36 registers), so a sweep reads only lam from shared
//   memory (the same chunks, float4s) and does 36 FMAs a lane; three
//   __shfl_xor_sync rounds add a row's 8 partial sums, and lane 0 of the
//   contact stores its 3 row values.  After a barrier one lane a contact
//   (warp 0; S <= 32) applies Dinv and the projection, keeping the contact's
//   constants and lam in registers, and stores lam; a second barrier ends
//   the sweep.  Threads: 8 S rounded up to whole warps, 192 at S = 24 and
//   224 at S = 28; __launch_bounds__ keeps them to 80 registers, so 4 blocks
//   fit an SM at S = 24 (3 at S = 28, by shared memory).
// - Conflict-free float4 reads.  A quarter-warp is one contact's 8 lanes;
//   reading chunk q + 8k of one row it touches 8 consecutive float4s, i.e.
//   8 disjoint bank groups, at any row stride.  lam's chunks likewise.  The
//   pad columns M .. ld - 1 (S % 4 != 0 only) are zeroed once and never
//   copied into.
// Measured on an H100 (PERF.md, kernel_bench.py): the copies land before they
// are needed; what remains is the start-up wave (every block's first env
// arrives 5-13 us in, with nothing to overlap it) and the sweeps, each two
// barriers and a serial update phase, ~0.5 us of an env's ~3.1 us per
// block.
// The wrapper computes the launch parameters (kernels/contact_lcp.py:
// launch_config); contact_lcp_launch checks them before it launches.
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 8;             // lanes per contact
constexpr int kMaxChunks = 3;         // float4 chunks of a row per lane: ceil(96 / 4 / 8)
constexpr int kMaxContacts = 32;
constexpr int kMaxThreads = kLanes * kMaxContacts;
constexpr int kMaxSmem = 232448;      // 227 KB, the most a block can use on Hopper
constexpr unsigned kFull = 0xffffffffu;

// Float offsets within one stage of the ring; every segment starts on a
// 16-byte boundary.
struct Layout {
  int M, ld, vf, bias, nrm, lam0, act, mu, dinv, stage;
};

__host__ __device__ inline int pad4(int x) { return (x + 3) & ~3; }

__host__ __device__ inline Layout make_layout(int S, int ld) {
  Layout L;
  L.M = 3 * S;
  L.ld = ld;
  L.vf = L.M * ld;
  L.bias = L.vf + pad4(L.M);
  L.nrm = L.bias + pad4(L.M);
  L.lam0 = L.nrm + pad4(L.M);
  L.act = L.lam0 + pad4(L.M);
  L.mu = L.act + pad4(S);
  L.dinv = L.mu + pad4(S);
  L.stage = L.dinv + pad4(9 * S);
  return L;
}

// Bytes of shared memory: two stages, lam and G lam (ld floats each), and
// the two stages' barriers.
__host__ __device__ inline int smem_bytes(int S, int ld) {
  return 4 * (2 * make_layout(S, ld).stage + 2 * ld) + 16;
}

__device__ __forceinline__ void project(float& lx, float& ly, float& lz,
                                        float nx, float ny, float nz,
                                        float act, float mu, float lam_max) {
  float ln = lx * nx + ly * ny + lz * nz;
  float tx = lx - ln * nx, ty = ly - ln * ny, tz = lz - ln * nz;
  ln = fminf(fmaxf(ln, 0.0f), lam_max) * act;
  // 1 / max(|t|, 1e-9) as one reciprocal square root: max(|t|^2, 1e-18) is
  // the same guard, and rsqrtf's ~2 ulp sit far inside the tolerance
  float scale = fminf(1.0f, mu * ln * rsqrtf(fmaxf(tx * tx + ty * ty + tz * tz, 1e-18f))) * act;
  lx = tx * scale + ln * nx;
  ly = ty * scale + ln * ny;
  lz = tz * scale + ln * nz;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// One 4-byte asynchronous copy (the width for S % 4 != 0).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// The barrier `bar` counts one arrival when this thread's earlier cp.async
// copies have landed.
__device__ __forceinline__ void cp_async_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// One bulk (TMA) copy of `bytes` (a multiple of 16) that completes on `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, int bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
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

// Phase stamps for kernel_bench.py --trace, compiled in only with -DK1_TRACE:
// per block (the first kTraceBlocks) the %globaltimer (ns) at entry, when
// its first env landed and at exit, the ns it spent waiting for envs to
// land, loading them into registers (and issuing the next copy), and
// sweeping, and the envs it solved.
constexpr int kTraceBlocks = 1024, kTraceSlots = 7;
#ifdef K1_TRACE
__device__ unsigned long long k1_trace[kTraceBlocks][kTraceSlots];
__device__ __forceinline__ unsigned long long trace_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void trace_set(int slot, unsigned long long v) {
  if (threadIdx.x == 0 && blockIdx.x < kTraceBlocks) k1_trace[blockIdx.x][slot] = v;
}
#else
__device__ __forceinline__ unsigned long long trace_now() { return 0; }
__device__ __forceinline__ void trace_set(int, unsigned long long) {}
#endif

// Arguments of the kernel that do not change from env to env.
struct Args {
  const float* G;
  const float* vf;
  const float* bias;
  const float* nrm;
  const float* act;
  const float* dinv;
  const float* mu;
  const float* lam0;
  float* lam_out;
  int N, S, iters;
  float relax, lam_max;
};

// Issue the asynchronous copy of env `env` into stage `st`, completing on
// `bar` (nothing when env >= N).  VEC == 4 (S % 4 == 0, so ld == M and every
// segment is a multiple of 16 bytes): thread 0 copies G and the seven
// vectors with eight bulk copies.  VEC == 1: every thread copies its share
// 4 bytes at a time, G's rows into rows of stride ld ((r, c) walks this
// thread's elements, T apart, without a divide per element), and arrives on
// `bar` when they land.
template <int VEC>
__device__ __forceinline__ void issue_env(float* st, unsigned long long* bar, const Layout& L,
                                          const Args& a, long long env, int tid, int T) {
  if (env >= a.N) return;
  const int M = L.M, S = a.S;
  const float* src[8] = {a.G + env * M * M, a.vf + env * M, a.bias + env * M,
                         a.nrm + env * M, a.lam0 + env * M, a.act + env * S,
                         a.mu + env * S, a.dinv + env * 9 * S};
  const int off[8] = {0, L.vf, L.bias, L.nrm, L.lam0, L.act, L.mu, L.dinv};
  const int len[8] = {M * M, M, M, M, M, S, S, 9 * S};
  if constexpr (VEC == 4) {
    if (tid == 0) {
      // the stage's earlier reads (generic proxy) come before these writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(bar, 4 * (M * M + 4 * M + 11 * S));
#pragma unroll
      for (int i = 0; i < 8; ++i) bulk_copy(st + off[i], src[i], 4 * len[i], bar);
    }
  } else {
    const int dr = T / M, dc = T % M;
    for (int r = tid / M, c = tid % M; r < M;) {
      cp_async4(st + r * L.ld + c, src[0] + r * M + c);
      r += dr;
      c += dc;
      if (c >= M) {
        c -= M;
        ++r;
      }
    }
#pragma unroll
    for (int i = 1; i < 8; ++i)
      for (int j = tid; j < len[i]; j += T) cp_async4(st + off[i] + j, src[i] + j);
    cp_async_arrive(bar);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kMaxThreads, 3)
    contact_lcp_kernel(const Args a, int ld) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = make_layout(a.S, ld);
  const int M = L.M, T = blockDim.x, tid = threadIdx.x;
  float* sLam = smem + 2 * L.stage;   // lam, ld floats
  float* sV = sLam + ld;              // G lam, one value a row
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(sV + ld);   // one a stage

  // the pad columns of G and of lam stay zero: clear everything once, before
  // the first copy lands
  for (int i = tid; i < (smem_bytes(a.S, ld) - 16) / 16; i += T)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid == 0) {
    mbar_init(&bar[0], VEC == 4 ? 1 : T);
    mbar_init(&bar[1], VEC == 4 ? 1 : T);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int s = tid / kLanes, q = tid % kLanes;   // row-dots: contact, lane within it
  const bool on = s < a.S;
  const int chunks = ld / 4;
  const int r0 = 3 * s;
  const bool upd = tid < a.S;                     // updates: one lane a contact, warp 0
  const int u0 = 3 * tid;

  // the first env alone, and the second once it has landed: every block's
  // first env then arrives in a wave half as large
  long long env = blockIdx.x;
  unsigned long long t_wait = 0, t_load = 0, t_sweep = 0;
  trace_set(0, trace_now());
  issue_env<VEC>(smem, &bar[0], L, a, env, tid, T);
  int k = 0;
  for (; env < a.N; ++k, env += gridDim.x) {
    float* st = smem + (k & 1) * L.stage;
    const unsigned long long t0 = trace_now();
    mbar_wait(&bar[k & 1], (k >> 1) & 1);   // the stage of env k has landed
    const unsigned long long t1 = trace_now();
    if (k == 0) {
      trace_set(1, t1);
      issue_env<VEC>(smem + L.stage, &bar[1], L, a, env + gridDim.x, tid, T);
    }

    // the stage into registers: this lane's chunks of its contact's 3 rows;
    // the update lanes take their contact's constants and projected lam0
    float4 g[3][kMaxChunks];
    if (on) {
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const float4* row = reinterpret_cast<const float4*>(st + (r0 + r) * ld);
#pragma unroll
        for (int c = 0; c < kMaxChunks; ++c)
          g[r][c] = q + kLanes * c < chunks ? row[q + kLanes * c] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    float rx = 0.f, ry = 0.f, rz = 0.f, nx = 0.f, ny = 0.f, nz = 0.f, ac = 0.f, mu = 0.f, D[9];
    float lx = 0.f, ly = 0.f, lz = 0.f;
    if (upd) {
      rx = st[L.vf + u0] - st[L.bias + u0];
      ry = st[L.vf + u0 + 1] - st[L.bias + u0 + 1];
      rz = st[L.vf + u0 + 2] - st[L.bias + u0 + 2];
      nx = st[L.nrm + u0];
      ny = st[L.nrm + u0 + 1];
      nz = st[L.nrm + u0 + 2];
      ac = st[L.act + tid];
      mu = st[L.mu + tid];
#pragma unroll
      for (int i = 0; i < 9; ++i) D[i] = st[L.dinv + 9 * tid + i];
      lx = st[L.lam0 + u0];
      ly = st[L.lam0 + u0 + 1];
      lz = st[L.lam0 + u0 + 2];
      project(lx, ly, lz, nx, ny, nz, ac, mu, a.lam_max);
      sLam[u0] = lx;
      sLam[u0 + 1] = ly;
      sLam[u0 + 2] = lz;
    }
    __syncthreads();   // lam is whole; the stage is read, so it takes env k + 2
    issue_env<VEC>(st, &bar[k & 1], L, a, env + 2LL * gridDim.x, tid, T);
    const unsigned long long t2 = trace_now();

    for (int it = 0; it < a.iters; ++it) {
      const float4* l4 = reinterpret_cast<const float4*>(sLam);
      float v[3] = {0.f, 0.f, 0.f};
      if (on) {
#pragma unroll
        for (int c = 0; c < kMaxChunks; ++c) {
          if (q + kLanes * c < chunks) {
            const float4 l = l4[q + kLanes * c];
#pragma unroll
            for (int r = 0; r < 3; ++r)
              v[r] = fmaf(g[r][c].w, l.w, fmaf(g[r][c].z, l.z,
                     fmaf(g[r][c].y, l.y, fmaf(g[r][c].x, l.x, v[r]))));
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int m = 1; m < kLanes; m <<= 1) v[r] += __shfl_xor_sync(kFull, v[r], m);
      }
      if (on && q == 0) {
        sV[r0] = v[0];
        sV[r0 + 1] = v[1];
        sV[r0 + 2] = v[2];
      }
      __syncthreads();
      if (upd) {
        const float vx = sV[u0] + rx, vy = sV[u0 + 1] + ry, vz = sV[u0 + 2] + rz;
        lx -= a.relax * (D[0] * vx + D[1] * vy + D[2] * vz);
        ly -= a.relax * (D[3] * vx + D[4] * vy + D[5] * vz);
        lz -= a.relax * (D[6] * vx + D[7] * vy + D[8] * vz);
        project(lx, ly, lz, nx, ny, nz, ac, mu, a.lam_max);
        sLam[u0] = lx;
        sLam[u0 + 1] = ly;
        sLam[u0 + 2] = lz;
      }
      __syncthreads();
    }
    if (upd) {
      float* out = a.lam_out + env * M + u0;
      out[0] = lx;
      out[1] = ly;
      out[2] = lz;
    }
    const unsigned long long t3 = trace_now();
    t_wait += t1 - t0;
    t_load += t2 - t1;
    t_sweep += t3 - t2;
  }
  trace_set(2, trace_now());
  trace_set(3, t_wait);
  trace_set(4, t_load);
  trace_set(5, t_sweep);
  trace_set(6, k);
}

template <int VEC>
int set_smem(int smem) {
  return (int)cudaFuncSetAttribute(contact_lcp_kernel<VEC>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int VEC>
int blocks_per_sm(int threads, int smem) {
  int e = set_smem<VEC>(smem);
  if (e != 0) return -e;
  int blocks = 0;
  e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, contact_lcp_kernel<VEC>,
                                                         threads, (size_t)smem);
  return e != 0 ? -e : blocks;
}

}  // namespace

// Blocks of `threads` threads and `smem` bytes that fit on one SM, or
// -cudaError.
extern "C" int contact_lcp_blocks_per_sm(int threads, int smem, int vec) {
  if (vec == 4) return blocks_per_sm<4>(threads, smem);
  if (vec == 1) return blocks_per_sm<1>(threads, smem);
  return -(int)cudaErrorInvalidValue;
}

#ifdef K1_TRACE
// Copy the phase stamps (kTraceBlocks x kTraceSlots uint64) to `host`.
extern "C" int contact_lcp_trace(void* host) {
  return (int)cudaMemcpyFromSymbol(host, k1_trace, sizeof(k1_trace));
}
#endif

extern "C" int contact_lcp_launch(const void* G, const void* vf, const void* bias,
                                  const void* nrm, const void* act, const void* dinv,
                                  const void* mu, const void* lam0, void* lam_out,
                                  int N, int S, int iters, float relax, float lam_max,
                                  int threads, int ld, int smem, int grid, int vec,
                                  void* stream) {
  const int M = 3 * S;
  const bool ok = N >= 1 && S >= 1 && S <= kMaxContacts && iters >= 0 && ld >= M &&
                  ld % 4 == 0 && (ld / 4 + kLanes - 1) / kLanes <= kMaxChunks &&
                  threads % 32 == 0 && threads <= kMaxThreads && threads >= kLanes * S &&
                  grid >= 1 && grid <= N && (vec == 1 || (vec == 4 && S % 4 == 0 && ld == M)) &&
                  smem == smem_bytes(S, ld) && smem <= kMaxSmem;
  if (!ok) return (int)cudaErrorInvalidValue;
  const Args a{(const float*)G, (const float*)vf, (const float*)bias, (const float*)nrm,
               (const float*)act, (const float*)dinv, (const float*)mu, (const float*)lam0,
               (float*)lam_out, N, S, iters, relax, lam_max};
  const int e = vec == 4 ? set_smem<4>(smem) : set_smem<1>(smem);
  if (e != 0) return e;
  if (vec == 4)
    contact_lcp_kernel<4><<<grid, threads, smem, (cudaStream_t)stream>>>(a, ld);
  else
    contact_lcp_kernel<1><<<grid, threads, smem, (cudaStream_t)stream>>>(a, ld);
  return (int)cudaGetLastError();
}
