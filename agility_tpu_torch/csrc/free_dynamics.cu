// Free dynamics of the SoA substep: physics/soa.py:pre_contact, one env a
// thread, in one launch.
//
// Replaces no TPU kernel: agility_tpu/physics/soa.py (the JAX counterpart of
// pre_contact) is plain jnp that XLA fuses.  In PyTorch the same scalar
// program runs as ~13,550 kernels a substep, each one pass over (N,) or
// (S, N) tensors; replayed from a CUDA graph each still costs the card
// ~1.1 us of node overhead for almost no arithmetic.  This kernel computes,
// per env, what pre_contact returns:
//   - fk_vel (positions, orientations, angular velocities, joint axes) and
//     link_coms, com_shift on the base;
//   - the PD torques tau_org and tau_j (clamped to the effort limits);
//   - mass_factors: the composite-rigid-body mass matrix about the base
//     origin (added_mass on the base), per-leg Dinv, B, BDinv and the base
//     Schur complement's inverse Sinv (inv3, inv6: adjugate and 3x3 block
//     Schur algebra);
//   - bias_forces and solve: u_free = u + dt M^-1 (tau - C);
//   - sphere_geometry: the centres, r = centre - base and the lever table;
//   - the terrain sample (patch_sample_hn) of every sphere: its 4 taps give
//     the dense einsum's sums (the weights of every other cell are 0), with
//     the clamp to P - 1.001, the bilinear weights and the dhat rule at
//     whole cells as soa.patch_sample_hn has them; division by a scalar
//     as PyTorch's CUDA kernels do it (times the float reciprocal);
//   - phi and the normals, and with a ceiling window the first n_ceil
//     (base-link) spheres' rows against the ceiling appended.
// Float32 throughout, the same formulas in the same order as the plain
// torch functions, each product and sum rounded apart as PyTorch's
// elementwise kernels round them (kernels/build.py compiles this file with
// --fmad=false: no contraction), so that the kernel gives plain
// pre_contact's bits on the card.  That matters: the window's bilinear
// surface has its normal jump at every cell edge, so a sphere centre that
// rounds across an edge takes the other cell's slope, and a contact then
// moves its env by O(1) in a step.
//
// Bound: neither bytes nor flops.  An env reads ~150 floats of state and 4
// window taps a sphere, writes 258 + 43 S' floats (~5.8 KB at S' = 28:
// ~40 MB at N = 6144, 12 us at 3.35 TB/s) and does a few thousand dependent
// flops of 13-link tree algebra (under 1 us at the float32 peak).  The work
// is latency: long dependent chains in one thread, and too few envs to
// fill the card with one thread each (N = 4096 is 128 warps on 132 SMs).
// So:
// - Two parts of an env run in parallel: a block holds 32 envs, its warp 0
//   computes their dynamics, warps 1 and 2 their spheres (every other
//   sphere each).  The sphere warps compute the link poses again (the same
//   link_pose as warp 0) rather than wait for warp 0: no barrier, and an env
//   takes the longer of the two parts, not their sum.
// - The tree is fixed at compile time (13 links, 4 legs of 3 dofs, each leg
//   a chain off the base; the wrapper refuses any other), every tree loop
//   unrolled, intermediates in registers.  The dynamics warp takes the legs
//   one at a time (forward kinematics, then the leg's composite inertias,
//   bias forces, D, B and the leg's part of the solve), so only one leg's
//   links are live at once.
// - A sphere warp keeps each link's position, orientation and joint axis in
//   shared memory (a column per thread, conflict-free), for the sphere loop,
//   which indexes links at run time.
// - Outputs env-minor (row k of env n at out[k N + n]): a warp stores 128
//   contiguous bytes a row.  Inputs are read through their strides, so the
//   wrapper copies nothing (the window is a permuted view).
// Measured on an H100 (PERF.md, chip_smoke.py): 43-64 us a launch at N =
// 4096, S' = 24 and 94-99 us at N = 6144, S' = 28 (ten launches replayed
// warm); with FMA contraction 34-56 and 62-78 us, and one thread an env 60-66
// and 100-104 us, both off plain torch's bits.  ptxas: 255 registers, 168
// bytes of spills.  Keeping each leg's factors out of registers (read back
// from the output) spilled 620 bytes and ran slower.
#include <cuda_runtime.h>

// The launch parameters, mirrored by kernels/free_dynamics.py's ctypes
// structs (outside the anonymous namespace: the C interface names them).
// Every field is 8 bytes wide, so both lay them out alike.  A View is a
// strided view, its strides in elements.
struct View {
  const void* data;
  long long s0, s1, sn;   // first axis, second axis (windows only), env
};

struct Window {
  View values, x0, y0;    // values (P, P, N) float; x0, y0 (N,) int64
  double ox, oy, hscale, gmax;
  long long P;
};

struct Params {
  View bp, bq, q, u, target, kp, kd, kp_scale, kd_scale, added_mass, shift_x, shift_y, shift_z;
  Window floor, ceil;
  const float* consts;
  float* out;
  long long N, S, rows, has_mass, has_shift;
  double dt, gx, gy, gz;
};

namespace {

constexpr int kLinks = 13;
constexpr int kDofs = 12;
constexpr int kLegs = 4;
constexpr int kSphereWarps = 2;
constexpr int kSphereThreads = 32 * kSphereWarps;
constexpr int kThreads = 32 + kSphereThreads;     // a block: a dynamics warp, the sphere warps

// The constant table, as kernels/free_dynamics.py:pack_consts lays it out
// (float offsets).
constexpr int kJointPos = 0;                          // (13, 3)
constexpr int kJointQuat = kJointPos + 3 * kLinks;    // (13, 4) xyzw
constexpr int kJointAxis = kJointQuat + 4 * kLinks;   // (13, 3)
constexpr int kLinkMass = kJointAxis + 3 * kLinks;    // (13,)
constexpr int kLinkCom = kLinkMass + kLinks;          // (13, 3)
constexpr int kLinkInertia = kLinkCom + 3 * kLinks;   // (13, 3, 3)
constexpr int kEffort = kLinkInertia + 9 * kLinks;    // (12,)
constexpr int kChainMass = kEffort + kDofs;           // (12,) each dof's subtree mass
constexpr int kTreeMass = kChainMass + kDofs;         // (1,) the whole tree's
constexpr int kSpheres = kTreeMass + 1;               // (S, 17): link, offset, radius, mask
constexpr int kSphereStride = 5 + kDofs;

// Output rows (each N floats), as kernels/free_dynamics.py:row_layout.
constexpr int kDinv = 0;        // [leg][3][3]
constexpr int kB = 36;          // [leg][6][3]
constexpr int kBDinv = 108;     // [leg][6][3]
constexpr int kSinv = 180;      // [6][6]
constexpr int kUFree = 216;     // (18,)
constexpr int kTauJ = 234;      // (12,)
constexpr int kTauOrg = 246;    // (12,)
constexpr int kPhi = 258;       // (S',), then n (3, S'), r (3, S'), lever (12, 3, S')

// Shared columns: position (3) and orientation (4) of each link, axis (3)
// of each dof.
constexpr int kShPos = 0;
constexpr int kShQuat = kShPos + 3 * kLinks;
constexpr int kShAxis = kShQuat + 4 * kLinks;
constexpr int kShared = kShAxis + 3 * kDofs;

struct V3 {
  float x, y, z;
};
struct Q4 {
  float x, y, z, w;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ Q4 qmul(Q4 a, Q4 b) {
  return {a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w,
          a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z};
}

// soa.q_rot: v + (t w + u x t), t = 2 (u x v)
__device__ __forceinline__ V3 qrot(Q4 q, V3 v) {
  V3 u = {q.x, q.y, q.z};
  V3 t = scale(cross(u, v), 2.0f);
  return add(v, add(scale(t, q.w), cross(u, t)));
}

struct M3 {
  float a[3][3];
};

__device__ __forceinline__ M3 rotmat(Q4 q) {
  float xx = q.x * q.x, yy = q.y * q.y, zz = q.z * q.z;
  float xy = q.x * q.y, xz = q.x * q.z, yz = q.y * q.z;
  float wx = q.w * q.x, wy = q.w * q.y, wz = q.w * q.z;
  return {{{1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)},
           {2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)},
           {2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)}}};
}

__device__ __forceinline__ V3 matvec(const M3& m, V3 v) {
  return {m.a[0][0] * v.x + m.a[0][1] * v.y + m.a[0][2] * v.z,
          m.a[1][0] * v.x + m.a[1][1] * v.y + m.a[1][2] * v.z,
          m.a[2][0] * v.x + m.a[2][1] * v.y + m.a[2][2] * v.z};
}

__device__ __forceinline__ M3 madd(const M3& a, const M3& b) {
  M3 c;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) c.a[i][j] = a.a[i][j] + b.a[i][j];
  return c;
}

// c = a b (R x K times K x C), sums in column order as soa.mat_mul
template <int R, int K, int C>
__device__ __forceinline__ void matmul(const float (&a)[R][K], const float (&b)[K][C],
                                       float (&c)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) {
      float s = a[i][0] * b[0][j];
#pragma unroll
      for (int k = 1; k < K; ++k) s += a[i][k] * b[k][j];
      c[i][j] = s;
    }
}

// c = a b^T (R x K times (C x K)^T)
template <int R, int K, int C>
__device__ __forceinline__ void matmul_t(const float (&a)[R][K], const float (&b)[C][K],
                                         float (&c)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) {
      float s = a[i][0] * b[j][0];
#pragma unroll
      for (int k = 1; k < K; ++k) s += a[i][k] * b[j][k];
      c[i][j] = s;
    }
}

// soa.inv3: the adjugate over the determinant's reciprocal
__device__ __forceinline__ void inv3(const float (&m)[3][3], float (&o)[3][3]) {
  float a = m[0][0], b = m[0][1], c = m[0][2];
  float d = m[1][0], e = m[1][1], f = m[1][2];
  float g = m[2][0], h = m[2][1], i = m[2][2];
  float A11 = e * i - f * h, A21 = f * g - d * i, A31 = d * h - e * g;
  float r = 1.0f / (a * A11 + b * A21 + c * A31);
  o[0][0] = A11 * r; o[0][1] = (c * h - b * i) * r; o[0][2] = (b * f - c * e) * r;
  o[1][0] = A21 * r; o[1][1] = (a * i - c * g) * r; o[1][2] = (c * d - a * f) * r;
  o[2][0] = A31 * r; o[2][1] = (b * g - a * h) * r; o[2][2] = (a * e - b * d) * r;
}

// soa.inv6: the 6x6 SPD inverse by its 3x3 block Schur complement
__device__ __forceinline__ void inv6(const float (&m)[6][6], float (&o)[6][6]) {
  float P[3][3], Q[3][3], Qt[3][3], S[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      P[i][j] = m[i][j];
      Q[i][j] = m[i][3 + j];
      Qt[j][i] = m[i][3 + j];
      S[i][j] = m[3 + i][3 + j];
    }
  float Pinv[3][3], QtPinv[3][3], QtPinvQ[3][3], Sc[3][3], Scinv[3][3], PinvQ[3][3];
  float PinvQScinv[3][3], TL2[3][3];
  inv3(P, Pinv);
  matmul(Qt, Pinv, QtPinv);
  matmul(QtPinv, Q, QtPinvQ);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) Sc[i][j] = S[i][j] - QtPinvQ[i][j];
  inv3(Sc, Scinv);
  matmul(Pinv, Q, PinvQ);
  matmul(PinvQ, Scinv, PinvQScinv);
  matmul(PinvQScinv, QtPinv, TL2);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      o[i][j] = Pinv[i][j] + TL2[i][j];
      o[i][3 + j] = -PinvQScinv[i][j];
      o[3 + j][i] = -PinvQScinv[i][j];
      o[3 + i][3 + j] = Scinv[i][j];
    }
}

// torch.maximum / torch.minimum against a bound that is never NaN: NaN in x
// stays NaN
__device__ __forceinline__ float max_nan(float x, float lo) { return (x != x || x > lo) ? x : lo; }
__device__ __forceinline__ float min_nan(float x, float hi) { return (x != x || x < hi) ? x : hi; }
// torch.clamp(x, lo, hi): NaN stays NaN
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float read(const View& v, int row, long long n) {
  return __ldg(static_cast<const float*>(v.data) + row * v.s0 + n * v.sn);
}

__device__ __forceinline__ V3 ld3(const float* a) { return {__ldg(a), __ldg(a + 1), __ldg(a + 2)}; }

// Link l's pose from its parent's (pp, pq), as fk_vel forms it: its
// position, its orientation (the joint's rotation by q_d / 2 about its
// axis) and its dof's axis in the world.  Both warps of an env call it, so
// the dynamics and the spheres see the same bits.
__device__ __forceinline__ void link_pose(const float* __restrict__ K, const Params& p,
                                          long long n, int l, V3 pp, Q4 pq, V3& pos, Q4& quat,
                                          V3& axis) {
  const V3 ax = ld3(K + kJointAxis + 3 * l);
  const float half = 0.5f * read(p.q, l - 1, n);
  const float s = sinf(half);
  const Q4 jq = {__ldg(K + kJointQuat + 4 * l), __ldg(K + kJointQuat + 4 * l + 1),
                 __ldg(K + kJointQuat + 4 * l + 2), __ldg(K + kJointQuat + 4 * l + 3)};
  quat = qmul(pq, qmul(jq, Q4{ax.x * s, ax.y * s, ax.z * s, cosf(half)}));
  pos = add(pp, qrot(pq, ld3(K + kJointPos + 3 * l)));
  axis = qrot(quat, ax);
}

// A window as one env samples it: its values and the clamp's scalars, in
// float as PyTorch's CUDA kernels use them (a tensor divided by a Python
// scalar is multiplied by the scalar's float reciprocal).
struct Tap {
  const float* v;
  long long s0, s1;
  float ox, oy, inv_hs, gmax, x0, y0;
  int P;
};

__device__ __forceinline__ Tap tap_of(const Window& w, long long n) {
  Tap t;
  t.v = static_cast<const float*>(w.values.data) + n * w.values.sn;
  t.s0 = w.values.s0;
  t.s1 = w.values.s1;
  t.ox = static_cast<float>(w.ox);
  t.oy = static_cast<float>(w.oy);
  t.inv_hs = 1.0f / static_cast<float>(w.hscale);
  t.gmax = static_cast<float>(w.gmax);
  t.x0 = static_cast<float>(__ldg(static_cast<const long long*>(w.x0.data) + n * w.x0.sn));
  t.y0 = static_cast<float>(__ldg(static_cast<const long long*>(w.y0.data) + n * w.y0.sn));
  t.P = static_cast<int>(w.P);
  return t;
}

// soa.patch_sample_hn at (x, y): the height, and the floor-style normal's
// components (-dhdx inv, -dhdy inv, inv) as (dhdx, dhdy, inv)
__device__ __forceinline__ void sample(const Tap& w, float x, float y, float& h, float& dhdx,
                                       float& dhdy, float& inv) {
  const float gx = clamp_nan((x - w.ox) * w.inv_hs - w.x0, 0.0f, w.gmax);
  const float gy = clamp_nan((y - w.oy) * w.inv_hs - w.y0, 0.0f, w.gmax);
  // cells i, i + 1 (x) and j, j + 1 (y) hold every nonzero weight
  const float fx = floorf(gx), fy = floorf(gy);
  const int i = (fx >= 0.0f && fx <= static_cast<float>(w.P - 2)) ? static_cast<int>(fx) : 0;
  const int j = (fy >= 0.0f && fy <= static_cast<float>(w.P - 2)) ? static_cast<int>(fy) : 0;
  float vv[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) vv[a][b] = __ldg(w.v + (i + a) * w.s0 + (j + b) * w.s1);
  float wx[2], wy[2], hx[2], hy[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float dx = gx - static_cast<float>(i + k), dy = gy - static_cast<float>(j + k);
    wx[k] = 1.0f - fabsf(dx);
    wy[k] = 1.0f - fabsf(dy);
    wx[k] = wx[k] < 0.0f ? 0.0f : wx[k];     // torch.clamp(min=0): NaN stays NaN
    wy[k] = wy[k] < 0.0f ? 0.0f : wy[k];
    hx[k] = ((dx > 0.0f && dx < 1.0f) ? -1.0f : 0.0f) + ((dx <= 0.0f && dx > -1.0f) ? 1.0f : 0.0f);
    hy[k] = ((dy > 0.0f && dy < 1.0f) ? -1.0f : 0.0f) + ((dy <= 0.0f && dy > -1.0f) ? 1.0f : 0.0f);
  }
  // the einsums over the window's cells, as cuBLAS accumulates them (fused
  // multiply-adds in the order of the cells, from zero); dhat's products
  // are exact, so drows is the same either way
  float rows[2], drows[2];
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    rows[b] = __fmaf_rn(wx[1], vv[1][b], wx[0] * vv[0][b]);
    drows[b] = __fmaf_rn(hx[1], vv[1][b], hx[0] * vv[0][b]);
  }
  h = rows[0] * wy[0] + rows[1] * wy[1];
  dhdx = (drows[0] * wy[0] + drows[1] * wy[1]) * w.inv_hs;
  dhdy = (rows[0] * hy[0] + rows[1] * hy[1]) * w.inv_hs;
  inv = 1.0f / sqrtf(dhdx * dhdx + dhdy * dhdy + 1.0f);
}

// Env n's dynamics: the PD torques, fk_vel, link_coms, mass_factors,
// bias_forces and solve, written as the rows kDinv .. kTauOrg.
__device__ __forceinline__ void dynamics(const Params& p, long long n) {
  const float* __restrict__ K = p.consts;
  float* __restrict__ out = p.out + n;
  const long long N = p.N;
  auto put = [&](int row, float v) { out[row * N] = v; };
  auto c3 = [&](int at) { return ld3(K + at); };

  const V3 x0 = {read(p.bp, 0, n), read(p.bp, 1, n), read(p.bp, 2, n)};
  const Q4 bq = {read(p.bq, 0, n), read(p.bq, 1, n), read(p.bq, 2, n), read(p.bq, 3, n)};
  const float dt = static_cast<float>(p.dt);
  float u[18];
#pragma unroll
  for (int i = 0; i < 18; ++i) u[i] = read(p.u, i, n);

  // PD torques (pre_contact): tau_org = kp_scale kp (target - q) - kd_scale kd qd
  float tau_j[kDofs];
#pragma unroll
  for (int d = 0; d < kDofs; ++d) {
    const float tau = read(p.kp_scale, d, n) * read(p.kp, d, n) * (read(p.target, d, n) - read(p.q, d, n)) -
                      read(p.kd_scale, d, n) * read(p.kd, d, n) * u[6 + d];
    const float eff = __ldg(K + kEffort + d);
    tau_j[d] = min_nan(max_nan(tau, -eff), eff);
    put(kTauOrg + d, tau);
    put(kTauJ + d, tau_j[d]);
  }

  // ---- the base link
  const float am = p.has_mass ? read(p.added_mass, 0, n) : 0.0f;
  const float m0 = p.has_mass ? __ldg(K + kLinkMass) + am : __ldg(K + kLinkMass);
  V3 off0 = c3(kLinkCom);
  if (p.has_shift) off0 = add(off0, V3{read(p.shift_x, 0, n), read(p.shift_y, 0, n), read(p.shift_z, 0, n)});
  const V3 w0 = {u[3], u[4], u[5]};
  const V3 alpha0 = {0.0f, 0.0f, 0.0f};
  const V3 afr0 = {0.0f - static_cast<float>(p.gx), 0.0f - static_cast<float>(p.gy),
                   0.0f - static_cast<float>(p.gz)};

  // a link's world inertia R I_body R^T, its spatial parameters about the
  // base origin (soa._spatial_params) and its bias force and torque
  // (soa.bias_forces' per-link terms)
  auto link_terms = [&](int l, V3 pos, Q4 quat, V3 com, V3 omega, V3 alpha, V3 afr, float m,
                        V3& h, M3& I, V3& f, V3& tau) {
    const M3 R = rotmat(quat);
    float RIb[3][3], Iw[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        RIb[i][j] = R.a[i][0] * __ldg(K + kLinkInertia + 9 * l + j) +
                    R.a[i][1] * __ldg(K + kLinkInertia + 9 * l + 3 + j) +
                    R.a[i][2] * __ldg(K + kLinkInertia + 9 * l + 6 + j);
    matmul_t(RIb, R.a, Iw);
    const V3 r = sub(com, x0);
    const float rr = dot(r, r);
    const float rv[3] = {r.x, r.y, r.z};
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        I.a[a][b] = (Iw[a][b] + (a == b ? m * rr : 0.0f)) - m * rv[a] * rv[b];
    h = scale(r, m);
    const V3 coff = sub(com, pos);
    const V3 a_com = add(afr, add(cross(alpha, coff), cross(omega, cross(omega, coff))));
    f = scale(a_com, m);
    M3 Iwm;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) Iwm.a[i][j] = Iw[i][j];
    const V3 nn = add(matvec(Iwm, alpha), cross(omega, matvec(Iwm, omega)));
    tau = add(nn, cross(sub(com, x0), f));
  };

  const V3 com0 = add(x0, qrot(bq, off0));
  V3 h_t, f_tot, tau_tot;
  M3 I_t;
  link_terms(0, x0, bq, com0, w0, alpha0, afr0, m0, h_t, I_t, f_tot, tau_tot);
  // m_t: mass_factors sums the legs' subtree masses onto the base's in
  // double where the base's mass is a constant
  float m_t = p.has_mass ? m0 : __ldg(K + kTreeMass);

  // per leg, kept for the solve and the Schur complement
  float Dinv[kLegs][3][3], B[kLegs][6][3], BDinv[kLegs][6][3], y[kLegs][3], tk[kLegs][6];

#pragma unroll
  for (int k = 0; k < kLegs; ++k) {
    // forward: links 3k + 1 .. 3k + 3, dofs 3k .. 3k + 2, the first one's parent the base
    V3 pos[4], omega[4], alpha[4], afr[4], axis[3], h[3], f[3], tau[3];
    Q4 quat[4];
    M3 I[3];
    pos[0] = x0; quat[0] = bq; omega[0] = w0; alpha[0] = alpha0; afr[0] = afr0;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int l = 3 * k + 1 + i, d = l - 1;
      link_pose(K, p, n, l, pos[i], quat[i], pos[i + 1], quat[i + 1], axis[i]);
      omega[i + 1] = add(omega[i], scale(axis[i], u[6 + d]));
      const V3 r = sub(pos[i + 1], pos[i]);
      const V3 wp = omega[i];
      afr[i + 1] = add(afr[i], add(cross(alpha[i], r), cross(wp, cross(wp, r))));
      alpha[i + 1] = add(alpha[i], scale(cross(wp, axis[i]), u[6 + d]));
      const V3 com = add(pos[i + 1], qrot(quat[i + 1], c3(kLinkCom + 3 * l)));
      link_terms(l, pos[i + 1], quat[i + 1], com, omega[i + 1], alpha[i + 1], afr[i + 1],
                 __ldg(K + kLinkMass + l), h[i], I[i], f[i], tau[i]);
    }
    // backward: subtree sums (mass_factors' composites, bias_forces' f_c
    // and tau_c), rho, f_d, n_d and the bias C of each dof
    V3 hc[3], rho[3], fd[3], nd[3], fc, tc;
    M3 Ic[3];
    float C[3];
#pragma unroll
    for (int i = 2; i >= 0; --i) {
      if (i == 2) {
        hc[i] = h[i]; Ic[i] = I[i]; fc = f[i]; tc = tau[i];
      } else {
        hc[i] = add(h[i], hc[i + 1]); Ic[i] = madd(I[i], Ic[i + 1]);
        fc = add(fc, f[i]); tc = add(tc, tau[i]);
      }
      const V3 a = axis[i];
      rho[i] = cross(sub(pos[i + 1], x0), a);
      C[i] = dot(a, tc) + dot(rho[i], fc);
    }
    const int root = 3 * k;
    if (p.has_mass) m_t = m_t + __ldg(K + kChainMass + root);
    h_t = add(h_t, hc[0]);
    I_t = madd(I_t, Ic[0]);
    f_tot = add(f_tot, fc);
    tau_tot = add(tau_tot, tc);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const V3 a = axis[i];
      fd[i] = sub(scale(rho[i], __ldg(K + kChainMass + root + i)), cross(hc[i], a));
      nd[i] = add(matvec(Ic[i], a), cross(hc[i], rho[i]));
    }
    float D[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = i; j < 3; ++j) {
        const float val = dot(axis[i], nd[j]) + dot(rho[i], fd[j]);
        D[i][j] = val;
        D[j][i] = val;
      }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      B[k][0][i] = fd[i].x; B[k][1][i] = fd[i].y; B[k][2][i] = fd[i].z;
      B[k][3][i] = nd[i].x; B[k][4][i] = nd[i].y; B[k][5][i] = nd[i].z;
    }
    inv3(D, Dinv[k]);
    matmul(B[k], Dinv[k], BDinv[k]);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) put(kDinv + 9 * k + 3 * i + j, Dinv[k][i][j]);
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        put(kB + 18 * k + 3 * r + i, B[k][r][i]);
        put(kBDinv + 18 * k + 3 * r + i, BDinv[k][r][i]);
      }
    // the leg's part of solve: rl = tau_j - C, y = Dinv rl, t = BDinv rl
    float rl[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) rl[i] = tau_j[root + i] - C[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) y[k][i] = Dinv[k][i][0] * rl[0] + Dinv[k][i][1] * rl[1] + Dinv[k][i][2] * rl[2];
#pragma unroll
    for (int r = 0; r < 6; ++r) tk[k][r] = BDinv[k][r][0] * rl[0] + BDinv[k][r][1] * rl[1] + BDinv[k][r][2] * rl[2];
  }

  // the base block A and its Schur complement S = A - sum_k BDinv_k B_k^T
  float S6[6][6];
  {
    const float hx = h_t.x, hy = h_t.y, hz = h_t.z;
    const float nh[3][3] = {{0.0f, hz, -hy}, {-hz, 0.0f, hx}, {hy, -hx, 0.0f}};
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        S6[i][j] = i == j ? m_t : 0.0f;
        S6[i][3 + j] = nh[i][j];
        S6[3 + i][j] = nh[j][i];
        S6[3 + i][3 + j] = I_t.a[i][j];
      }
  }
#pragma unroll
  for (int k = 0; k < kLegs; ++k) {
    float X[6][6];
    matmul_t(BDinv[k], B[k], X);
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j) S6[i][j] = S6[i][j] - X[i][j];
  }
  float Sinv[6][6];
  inv6(S6, Sinv);
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) put(kSinv + 6 * i + j, Sinv[i][j]);

  // solve's base rows, then the legs' back substitution
  float acc[6] = {-f_tot.x, -f_tot.y, -f_tot.z, -tau_tot.x, -tau_tot.y, -tau_tot.z};
#pragma unroll
  for (int k = 0; k < kLegs; ++k)
#pragma unroll
    for (int i = 0; i < 6; ++i) acc[i] = acc[i] - tk[k][i];
  float du[18];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = Sinv[i][0] * acc[0];
#pragma unroll
    for (int j = 1; j < 6; ++j) s += Sinv[i][j] * acc[j];
    du[i] = s;
  }
#pragma unroll
  for (int k = 0; k < kLegs; ++k) {
    float bt[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float s = B[k][0][i] * du[0];
#pragma unroll
      for (int r = 1; r < 6; ++r) s += B[k][r][i] * du[r];
      bt[i] = s;
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
      du[6 + 3 * k + i] = y[k][i] - (Dinv[k][i][0] * bt[0] + Dinv[k][i][1] * bt[1] + Dinv[k][i][2] * bt[2]);
  }
#pragma unroll
  for (int i = 0; i < 18; ++i) put(kUFree + i, u[i] + dt * du[i]);
}

// Env n's sphere rows s = first, first + kSphereWarps, ... < S, and their
// ceiling rows: each link's pose (link_pose) into this thread's shared
// column `c`, then sphere_geometry, the terrain (and ceiling) sample and phi,
// written as the rows from kPhi on.
__device__ __forceinline__ void spheres(const Params& p, long long n, int first,
                                        float (*sh)[kSphereThreads], int c) {
  const float* __restrict__ K = p.consts;
  float* __restrict__ out = p.out + n;
  const long long N = p.N;
  auto put = [&](int row, float v) { out[row * N] = v; };
  auto keep = [&](int at, V3 v) { sh[at][c] = v.x; sh[at + 1][c] = v.y; sh[at + 2][c] = v.z; };
  auto keep_q = [&](int at, Q4 q) {
    sh[at][c] = q.x; sh[at + 1][c] = q.y; sh[at + 2][c] = q.z; sh[at + 3][c] = q.w;
  };

  const V3 x0 = {read(p.bp, 0, n), read(p.bp, 1, n), read(p.bp, 2, n)};
  const Q4 bq = {read(p.bq, 0, n), read(p.bq, 1, n), read(p.bq, 2, n), read(p.bq, 3, n)};
  keep(kShPos, x0);
  keep_q(kShQuat, bq);
#pragma unroll
  for (int k = 0; k < kLegs; ++k) {
    V3 pp = x0;
    Q4 pq = bq;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int l = 3 * k + 1 + i;
      V3 pl, al;
      Q4 ql;
      link_pose(K, p, n, l, pp, pq, pl, ql, al);
      keep(kShPos + 3 * l, pl);
      keep_q(kShQuat + 4 * l, ql);
      keep(kShAxis + 3 * (l - 1), al);
      pp = pl;
      pq = ql;
    }
  }

  const int S = static_cast<int>(p.S), rows = static_cast<int>(p.rows);
  const int n_ceil = rows - S;
  const int at_n = kPhi + rows, at_r = at_n + 3 * rows, at_lever = at_r + 3 * rows;
  const Tap floor_tap = tap_of(p.floor, n);
  const Tap ceil_tap = n_ceil > 0 ? tap_of(p.ceil, n) : floor_tap;
#pragma unroll 1
  for (int s = first; s < S; s += kSphereWarps) {
    const float* rec = K + kSpheres + kSphereStride * s;
    const int l = static_cast<int>(__ldg(rec));
    const V3 P = {sh[kShPos + 3 * l][c], sh[kShPos + 3 * l + 1][c], sh[kShPos + 3 * l + 2][c]};
    const Q4 Q = {sh[kShQuat + 4 * l][c], sh[kShQuat + 4 * l + 1][c], sh[kShQuat + 4 * l + 2][c],
                  sh[kShQuat + 4 * l + 3][c]};
    const V3 cen = add(P, qrot(Q, V3{__ldg(rec + 1), __ldg(rec + 2), __ldg(rec + 3)}));
    const float radius = __ldg(rec + 4);
    const V3 r = sub(cen, x0);
    const bool ceil_row = s < n_ceil;
    float h, dhdx, dhdy, inv;
    sample(floor_tap, cen.x, cen.y, h, dhdx, dhdy, inv);
    put(kPhi + s, (cen.z - h) * inv - radius);
    put(at_n + s, -dhdx * inv);
    put(at_n + rows + s, -dhdy * inv);
    put(at_n + 2 * rows + s, inv);
    if (ceil_row) {
      sample(ceil_tap, cen.x, cen.y, h, dhdx, dhdy, inv);
      // the ceiling's normal points down: the floor-style normal negated;
      // phi is the gap below the surface
      put(kPhi + S + s, (h - cen.z) * inv - radius);
      put(at_n + S + s, dhdx * inv);
      put(at_n + rows + S + s, dhdy * inv);
      put(at_n + 2 * rows + S + s, -inv);
    }
    const float rv[3] = {r.x, r.y, r.z};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      put(at_r + a * rows + s, rv[a]);
      if (ceil_row) put(at_r + a * rows + S + s, rv[a]);
    }
    // levers: a_d x (c - p_d), masked to the dofs between the base and the
    // sphere's link
#pragma unroll
    for (int d = 0; d < kDofs; ++d) {
      const float m = __ldg(rec + 5 + d);
      const V3 a = {sh[kShAxis + 3 * d][c], sh[kShAxis + 3 * d + 1][c], sh[kShAxis + 3 * d + 2][c]};
      const V3 pd = {sh[kShPos + 3 * (d + 1)][c], sh[kShPos + 3 * (d + 1) + 1][c],
                     sh[kShPos + 3 * (d + 1) + 2][c]};
      const float dx = cen.x - pd.x, dy = cen.y - pd.y, dz = cen.z - pd.z;
      const float lv[3] = {(a.y * dz - a.z * dy) * m, (a.z * dx - a.x * dz) * m,
                           (a.x * dy - a.y * dx) * m};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        put(at_lever + (3 * d + k) * rows + s, lv[k]);
        if (ceil_row) put(at_lever + (3 * d + k) * rows + S + s, lv[k]);
      }
    }
  }
}

// One block: 32 envs, warp 0 their dynamics, warps 1 and 2 their spheres,
// each warp every other sphere.  The two parts share nothing
// but the inputs (the sphere warps compute the link poses again), so an
// env's time is the longer of the two, not their sum.
__global__ void __launch_bounds__(kThreads) free_dynamics_kernel(const Params p) {
  __shared__ float sh[kShared][kSphereThreads];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long n = static_cast<long long>(blockIdx.x) * 32 + lane;
  if (n >= p.N) return;
  if (warp == 0)
    dynamics(p, n);
  else
    spheres(p, n, warp - 1, sh, threadIdx.x - 32);
}

}  // namespace

extern "C" int free_dynamics_params_bytes() { return static_cast<int>(sizeof(Params)); }

extern "C" int free_dynamics_launch(const Params* p, void* stream) {
  if (p->S <= 0 || p->rows < p->S || p->rows > 2 * p->S) return cudaErrorInvalidValue;
  const long long blocks = (p->N + 31) / 32;
  if (blocks <= 0) return cudaSuccess;
  free_dynamics_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(*p);
  return static_cast<int>(cudaGetLastError());
}
