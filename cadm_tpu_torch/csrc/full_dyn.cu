// Fused smooth-dynamics step (kernel K2) and the FK-velocity walk (kernel K3).
//
// K2 replaces the Pallas TPU kernel cadm_tpu/ops/fk_kernel.py::_full_dyn_kernel
// (wrapper full_dyn_pallas; FK walk _fk_kernel). Computes, per env, the whole
// smooth stage of one physics substep: the FK tree walk with body angular
// velocity, COM velocity and the zero-q̈ bias accelerations; dof axes and
// anchors; world inertias × mass_scale; the tree-sparse joint-space mass
// matrix + armature + dt·damping·scale; the bias projection; actuation (clip,
// gear, act_mask); joint springs and limit penalties; Cholesky → L⁻¹ → M⁻¹;
// and v_pred = qvel + dt·M⁻¹τ.
//
// It also writes each body's rotation matrix and its unscaled world inertia
// (the FKVel fields body_rot and inertia_w), from the quaternions it holds in
// double, so the wrapper returns views of the row and derives nothing.
//
// Table-driven: the Pallas kernel is generated per System with every
// constant an immediate, so its code size grows steeply with nv; here one
// source serves every System: the wrapper packs the System into a SysTable
// (must match ops/fk_kernel.py::SysTable field for field), each block copies
// it into shared memory, and the loops run over bodies, joints and dofs, in
// double precision (see Real).
//
// What bounds it on the card: latency, not bytes or flops. The tree walk is
// a serial chain over the bodies, and the factorisation a chain over the
// columns. Design: a group of G lanes per env (16 for nv ≤ 16, else 32),
// 64-thread blocks, so 2048 envs are 512 (cheetah) or 1024 (humanoid) blocks
// over the 132 SMs. One lane runs the walk and leaves its per-body and
// per-dof state in the env's shared memory: the walk indexes that state by
// the parent body at run time, so per-lane copies would sit in local memory
// (3.6 KB a lane), while one shared copy serves every later stage directly.
// The group then splits the independent work: the output rows, inertias and
// bias forces per body; the linear Jacobian column of each (dof, body) pair,
// which τ and the mass matrix share; τ per dof; the nv(nv+1)/2 mass-matrix
// entries; the Cholesky column updates below each pivot (right-looking,
// which subtracts the terms of each entry in the same order as the
// left-looking form, one __syncwarp a column); the columns of L⁻¹; the M⁻¹
// entries and the v_pred dots. The walk state, M (then M⁻¹), L, L⁻¹, the
// Jacobian columns and τ live in shared memory per env, the matrices at an
// odd stride.
//
// K3 replaces the Pallas TPU kernel cadm_tpu/ops/fk_kernel.py::fk_vel_pallas
// (body _fk_kernel_merged): the FK + velocity / bias-acceleration walk alone,
// the first nine fields of K2's row (22·nb + 6·nv floats per env). Both
// kernels run every body through the same non-inlined device functions
// (fk_body_step, fk_body_row, fk_dof_row), so K3's fields are bit-for-bit
// K2's. What bounds it is latency too: each body's step is a chain of FP64
// operations that needs its parent's result. Design: a group of
// CADM_FK_LANES lanes per env in 64-thread blocks (2048 envs are 256 or 512
// blocks over the 132 SMs); the walk goes by tree level, the lanes of a
// group taking the bodies of one level at once (the System's level order is
// packed into the table on the host), one __syncwarp a level: 4 dependent
// body steps for cheetah, hopper and ant, 6 for the humanoid, where a serial
// walk takes nb − 1. The walk state sits in shared memory, one Walk per env;
// the block reads its envs' qpos/qvel into shared memory and the group
// writes its row there, then the block stores its rows, one contiguous span
// of the output, in 16-byte vectors, consecutive lanes on consecutive words.
#include <cuda_runtime.h>

#include "launch_once.cuh"

#include <cstdint>

namespace {

constexpr int NB_MAX = 16;
constexpr int NJ_MAX = 24;
constexpr int NV_MAX = 24;
constexpr int NU_MAX = 24;
constexpr int kDynThreads = 64;   // K2: a group of G lanes per env
constexpr int kFkThreads = 64;    // K3: a group of CADM_FK_LANES lanes per env
// K3's lanes per env (4, 8 or 16), chosen with scripts/probe_fk_vel.py
#ifndef CADM_FK_LANES
#define CADM_FK_LANES 8
#endif
constexpr int FREE = 0, SLIDE = 2, HINGE = 3;  // cadm_tpu.physics.rigid.system

struct SysTable {
  int nb, nj, nq, nv, nu;
  int n_levels;                // tree levels below the world body
  int body_parent[NB_MAX];
  int body_jnt_start[NB_MAX];
  int body_jnt_num[NB_MAX];
  int level_start[NB_MAX];     // level l: level_body[level_start[l] ...
  int level_body[NB_MAX];      // ... level_start[l + 1]), bodies 1..nb-1
  int jnt_type[NJ_MAX];
  int jnt_qposadr[NJ_MAX];
  int jnt_dofadr[NJ_MAX];
  int jnt_limited[NJ_MAX];
  int dof_is_rot[NV_MAX];
  unsigned int dof_bodies[NV_MAX];  // bit b set: dof moves body b
  int act_dof[NU_MAX];
  float body_pos[NB_MAX][3];
  float body_quat[NB_MAX][4];
  float body_ipos[NB_MAX][3];
  float body_iquat[NB_MAX][4];
  float body_inertia[NB_MAX][3];
  float body_mass[NB_MAX];
  float jnt_axis[NJ_MAX][3];
  float jnt_pos[NJ_MAX][3];
  float jnt_range[NJ_MAX][2];
  float jnt_stiffness[NJ_MAX];
  float jnt_qpos0[NJ_MAX];
  float jnt_qpos_spring[NJ_MAX];
  float dof_damping[NV_MAX];
  float dof_armature[NV_MAX];
  float act_gear[NU_MAX];
  float act_lo[NU_MAX];
  float act_hi[NU_MAX];
  float gravity[3];
  float dt, limit_stiffness, limit_damping;
};

// All arithmetic runs in double: float32 loses up to 3.5e-4 of M⁻¹ on
// slim_humanoid (cond(M) ≈ 3e3), the H100 has FP64 units at half the FP32
// rate, and these kernels are bound by latency, not flops.
using Real = double;
constexpr Real kInvTwoPi = 0.15915494309189535;  // 1 / (2π)

struct V3 {
  Real x, y, z;
};

__device__ __forceinline__ V3 v3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 scale(V3 a, Real s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ Real dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

struct Q4 {
  Real w, x, y, z;
};

__device__ __forceinline__ Q4 q4(const float* p) { return {p[0], p[1], p[2], p[3]}; }
__device__ __forceinline__ Q4 qmul(Q4 p, Q4 q) {
  return {p.w * q.w - p.x * q.x - p.y * q.y - p.z * q.z,
          p.w * q.x + p.x * q.w + p.y * q.z - p.z * q.y,
          p.w * q.y - p.x * q.z + p.y * q.w + p.z * q.x,
          p.w * q.z + p.x * q.y - p.y * q.x + p.z * q.w};
}
// rotate v by q (local → world)
__device__ __forceinline__ V3 qrot(Q4 q, V3 v) {
  const V3 u = {q.x, q.y, q.z};
  const Real s = q.w * q.w - dot(u, u);
  return add(add(scale(v, s), scale(u, 2.0 * dot(u, v))),
             scale(cross(u, v), 2.0 * q.w));
}

// symmetric 3x3 as (xx, xy, xz, yy, yz, zz)
__device__ __forceinline__ V3 sym_mul(const Real* I, V3 v) {
  return {I[0] * v.x + I[1] * v.y + I[2] * v.z,
          I[1] * v.x + I[3] * v.y + I[4] * v.z,
          I[2] * v.x + I[4] * v.y + I[5] * v.z};
}

__device__ __forceinline__ void put3(float* o, V3 v) {
  o[0] = (float)v.x;
  o[1] = (float)v.y;
  o[2] = (float)v.z;
}

// Copy the System table into the block's shared memory (all threads, 16
// bytes a load; the wrapper's device copy is 256-byte aligned).
static_assert(sizeof(SysTable) % 16 == 0, "SysTable is copied as int4");
__device__ __forceinline__ void load_table(const SysTable* __restrict__ gsys,
                                           SysTable& S) {
  const int4* src = reinterpret_cast<const int4*>(gsys);
  int4* dst = reinterpret_cast<int4*>(&S);
  for (int i = threadIdx.x; i < (int)(sizeof(SysTable) / 16); i += blockDim.x)
    dst[i] = src[i];
  __syncthreads();
}

// Per-body frame state and per-dof (axis, anchor) after the tree walk.
struct Walk {
  V3 pos[NB_MAX], w[NB_MAX], vx[NB_MAX], al[NB_MAX], ax[NB_MAX];
  Q4 quat[NB_MAX];
  V3 axis[NV_MAX], anchor[NV_MAX];
};

// The world body's state, where every walk starts.
__device__ __forceinline__ void fk_root(Walk& k) {
  const V3 z3 = {0.0, 0.0, 0.0};
  k.pos[0] = k.w[0] = k.vx[0] = k.al[0] = k.ax[0] = z3;
  k.quat[0] = {1.0, 0.0, 0.0, 0.0};
}

// FK + velocity / bias-acceleration step of body b ≥ 1 of one env: reads
// its parent's state and writes its own and its dofs' (axis, anchor). Not
// inlined, like the row writers below: K2 and K3 run the same machine code
// for every body, so their fields agree bit for bit.
__device__ __noinline__ void fk_body_step(const SysTable& S, const float* qp,
                                          const float* qv, Walk& k, int b) {
  V3* pos = k.pos;
  V3* w = k.w;
  V3* vx = k.vx;
  V3* al = k.al;
  V3* ax = k.ax;
  Q4* quat = k.quat;
  V3* axis = k.axis;
  V3* anchor = k.anchor;
  const V3 z3 = {0.0, 0.0, 0.0};
  const int p = S.body_parent[b];
  Q4 q = qmul(quat[p], q4(S.body_quat[b]));
  const V3 off = qrot(quat[p], v3(S.body_pos[b]));
  V3 x = add(pos[p], off);
  V3 om = w[p], alp = al[p];
  V3 v = add(vx[p], cross(om, off));
  V3 a = add(add(ax[p], cross(alp, off)), cross(om, cross(om, off)));

  const int j_end = S.body_jnt_start[b] + S.body_jnt_num[b];
  for (int j = S.body_jnt_start[b]; j < j_end; ++j) {
    const int qa = S.jnt_qposadr[j], da = S.jnt_dofadr[j];
    const int jt = S.jnt_type[j];
    if (jt == FREE) {
      x = v3(qp + qa);
      const Q4 qr = q4(qp + qa + 3);
      const Real qn =
          rsqrt(qr.w * qr.w + qr.x * qr.x + qr.y * qr.y + qr.z * qr.z);
      q = {qr.w * qn, qr.x * qn, qr.y * qn, qr.z * qn};
      v = v3(qv + da);
      om = qrot(q, v3(qv + da + 3));
      alp = z3;  // Σ q̇ᵢ (ω × aᵢ) = ω × ω = 0
      a = z3;
      const V3 e[3] = {{1.0, 0.0, 0.0}, {0.0, 1.0, 0.0}, {0.0, 0.0, 1.0}};
      for (int i = 0; i < 3; ++i) {
        axis[da + i] = e[i];
        anchor[da + i] = z3;
        axis[da + 3 + i] = qrot(q, e[i]);
        anchor[da + 3 + i] = x;
      }
    } else if (jt == SLIDE) {
      const V3 aw = qrot(q, v3(S.jnt_axis[j]));
      const Real s = (Real)qp[qa] - S.jnt_qpos0[j];
      const Real sd = qv[da];
      x = add(x, scale(aw, s));
      // axis is fixed in the pre-joint frame: ȧ = ω × a
      const V3 wxa = cross(om, aw);
      v = add(v, add(scale(wxa, s), scale(aw, sd)));
      a = add(a, add(add(scale(cross(alp, aw), s), scale(cross(om, wxa), s)),
                     scale(wxa, 2.0 * sd)));
      axis[da] = aw;
      anchor[da] = x;
    } else {  // HINGE
      const V3 aw = qrot(q, v3(S.jnt_axis[j]));
      const V3 ow = add(x, qrot(q, v3(S.jnt_pos[j])));
      const Real th = (Real)qp[qa] - S.jnt_qpos0[j];
      const Real thd = qv[da];
      // sin and cos of th / 2 by sincospi: double sincos's slow path for
      // huge arguments keeps a 40-byte array in local memory in every
      // kernel that reaches it, while sincospi reduces its argument exactly
      Real sh, ch;
      sincospi(th * kInvTwoPi, &sh, &ch);
      const Q4 dq = {ch, aw.x * sh, aw.y * sh, aw.z * sh};
      q = qmul(dq, q);
      // anchor point kinematics (material point of the pre-joint frame)
      const V3 rel_o = sub(ow, x);
      const V3 v_o = add(v, cross(om, rel_o));
      const V3 a_o = add(add(a, cross(alp, rel_o)), cross(om, cross(om, rel_o)));
      x = add(ow, qrot(dq, sub(x, ow)));
      const V3 om_new = add(om, scale(aw, thd));
      const V3 alp_new = add(alp, scale(cross(om, aw), thd));
      // new origin is a material point of the post-joint body
      const V3 rel_n = sub(x, ow);
      v = add(v_o, cross(om_new, rel_n));
      a = add(add(a_o, cross(alp_new, rel_n)),
              cross(om_new, cross(om_new, rel_n)));
      om = om_new;
      alp = alp_new;
      axis[da] = aw;
      anchor[da] = ow;
    }
  }
  pos[b] = x;
  quat[b] = q;
  w[b] = om;
  vx[b] = v;
  al[b] = alp;
  ax[b] = a;
}

// The walk of one env over the bodies in tree order (parents first), in one
// lane: K2's.
__device__ __noinline__ void fk_walk(const SysTable& S, const float* qp,
                                     const float* qv, Walk& k) {
  fk_root(k);
  for (int b = 1; b < S.nb; ++b) fk_body_step(S, qp, qv, k, b);
}


// Write body b's seven FK fields of one env's row (layout of
// ops/fk_kernel.py::row_layout: pos, quat, com, omega, v_com, alpha0, a_com0)
// starting at o; keeps the body's COM in c[b] and its zero-q̈ COM
// acceleration in c[nb + b].
__device__ __noinline__ void fk_body_row(const SysTable& S, const Walk& k,
                                         int b, float* o, V3* c) {
  const int nb = S.nb;
  const V3 rc = qrot(k.quat[b], v3(S.body_ipos[b]));
  const V3 com = add(k.pos[b], rc);
  const V3 vcom = add(k.vx[b], cross(k.w[b], rc));
  const V3 acom =
      add(add(k.ax[b], cross(k.al[b], rc)), cross(k.w[b], cross(k.w[b], rc)));
  c[b] = com;
  c[nb + b] = acom;
  put3(o + 3 * b, k.pos[b]);
  float* o_quat = o + 3 * nb + 4 * b;
  o_quat[0] = (float)k.quat[b].w;
  o_quat[1] = (float)k.quat[b].x;
  o_quat[2] = (float)k.quat[b].y;
  o_quat[3] = (float)k.quat[b].z;
  put3(o + 7 * nb + 3 * b, com);
  put3(o + 10 * nb + 3 * b, k.w[b]);
  put3(o + 13 * nb + 3 * b, vcom);
  put3(o + 16 * nb + 3 * b, k.al[b]);
  put3(o + 19 * nb + 3 * b, acom);
}

// Write dof d's axis and anchor (the row's dof_axis and dof_anchor fields).
__device__ __noinline__ void fk_dof_row(const SysTable& S, const Walk& k,
                                        int d, float* o) {
  put3(o + 22 * S.nb + 3 * d, k.axis[d]);
  put3(o + 22 * S.nb + 3 * S.nv + 3 * d, k.anchor[d]);
}

// rotation matrix of a quaternion (math3d.quat_to_mat)
__device__ __forceinline__ void quat_mat(Q4 q, Real R[3][3]) {
  R[0][0] = 1.0 - 2.0 * (q.y * q.y + q.z * q.z);
  R[0][1] = 2.0 * (q.x * q.y - q.w * q.z);
  R[0][2] = 2.0 * (q.x * q.z + q.w * q.y);
  R[1][0] = 2.0 * (q.x * q.y + q.w * q.z);
  R[1][1] = 1.0 - 2.0 * (q.x * q.x + q.z * q.z);
  R[1][2] = 2.0 * (q.y * q.z - q.w * q.x);
  R[2][0] = 2.0 * (q.x * q.z - q.w * q.y);
  R[2][1] = 2.0 * (q.y * q.z + q.w * q.x);
  R[2][2] = 1.0 - 2.0 * (q.x * q.x + q.y * q.y);
}

// row i and column c ≤ i of entry q of a lower triangle stored row by row
__device__ __forceinline__ void tri_index(int q, int& i, int& c) {
  int r = (int)((sqrtf(8.f * q + 1.f) - 1.f) * 0.5f);
  while ((r + 1) * (r + 2) / 2 <= q) ++r;
  while (r * (r + 1) / 2 > q) --r;
  i = r;
  c = q - r * (r + 1) / 2;
}

// doubles of one env's shared scratch in K2: the walk state, COM, COM
// acceleration, bias force and torque (V3 per body), the scaled world
// inertia (6 per body), τ, 1/diag(L), then M (worked down by the Cholesky,
// later M⁻¹; nv rows at stride nv | 1), then one space that first holds the
// linear Jacobian column of each (dof, body) pair (V3, nv × nb) and, once
// the mass matrix is built, L and L⁻¹ (at the same stride)
__host__ __device__ __forceinline__ int dyn_scratch_doubles(int nb, int nv) {
  const int ld = nv | 1;
  const int jac = 3 * nv * nb, factors = 2 * nv * ld;
  return (int)(sizeof(Walk) / sizeof(Real)) + 18 * nb + 2 * nv + nv * ld +
         (jac > factors ? jac : factors);
}

template <int G>
__global__ void __launch_bounds__(kDynThreads)
full_dyn_kernel(const SysTable* __restrict__ gsys,
                const float* __restrict__ qpos, const float* __restrict__ qvel,
                const float* __restrict__ ctrl,
                const float* __restrict__ mass_scale,
                const float* __restrict__ damping_scale,
                const float* __restrict__ act_mask, float* __restrict__ out,
                int E, int out_stride, int scratch) {
  __shared__ __align__(16) SysTable S;
  extern __shared__ Real dsm[];
  load_table(gsys, S);
  constexpr int kGroups = kDynThreads / G;
  const int grp = threadIdx.x / G, lane = threadIdx.x % G;
  const int gbase = (threadIdx.x % 32) & ~(G - 1);
  const unsigned gmask =
      (G == 32 ? 0xffffffffu : ((1u << G) - 1u)) << gbase;
  const long long env = (long long)blockIdx.x * kGroups + grp;
  if (env >= E) return;  // a whole group leaves; only group syncs follow

  const int nb = S.nb, nv = S.nv, nu = S.nu, ld = nv | 1;
  const float* qp = qpos + env * S.nq;
  const float* qv = qvel + env * nv;
  const float* u = ctrl + env * nu;
  const float* am = act_mask + env * nu;
  const Real ms = mass_scale[env];
  const Real ds = damping_scale[env];

  Real* base = dsm + (size_t)grp * scratch;
  Walk& k = *reinterpret_cast<Walk*>(base);
  V3* com = reinterpret_cast<V3*>(base + sizeof(Walk) / sizeof(Real));
  V3* acom = com + nb;
  V3* fb = acom + nb;
  V3* tb = fb + nb;
  Real* Iw = reinterpret_cast<Real*>(tb + nb);  // (xx, xy, xz, yy, yz, zz) × ms
  Real* tau = Iw + 6 * nb;
  Real* invd = tau + nv;  // 1 / L[i][i]
  Real* W = invd + nv;    // M, worked down by the Cholesky, then M⁻¹
  V3* J = reinterpret_cast<V3*>(W + nv * ld);  // [d * nb + b], until M is built
  Real* L = W + nv * ld;                        // then L and L⁻¹ in its place
  Real* Li = L + nv * ld;

  float* o = out + env * out_stride;
  float* o_rot = o + 22 * nb + 6 * nv;
  float* o_inertia = o_rot + 9 * nb;
  float* o_minv = o_inertia + 9 * nb;
  float* o_vpred = o_minv + nv * nv;

  // ---- FK walk in one lane; then per body and per dof across the group:
  // the FK row fields, body_rot, the unscaled world inertia, bias force and
  // torque
  if (lane == 0) fk_walk(S, qp, qv, k);
  __syncwarp(gmask);
  for (int b = lane; b < nb; b += G) {
    fk_body_row(S, k, b, o, com);
    const Q4 qb = k.quat[b];
    Real R[3][3], Ri[3][3], I[3][3];
    quat_mat(qb, R);
    quat_mat(qmul(qb, q4(S.body_iquat[b])), Ri);
    const float* Id = S.body_inertia[b];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        I[i][j] = Ri[i][0] * Id[0] * Ri[j][0] + Ri[i][1] * Id[1] * Ri[j][1] +
                  Ri[i][2] * Id[2] * Ri[j][2];
        o_rot[9 * b + 3 * i + j] = (float)R[i][j];
        o_inertia[9 * b + 3 * i + j] = (float)I[i][j];
      }
    Real* Iwb = Iw + 6 * b;
    for (int i = 0, q = 0; i < 3; ++i)
      for (int j = i; j < 3; ++j, ++q) Iwb[q] = I[i][j] * ms;
    fb[b] = scale(sub(acom[b], v3(S.gravity)), S.body_mass[b] * ms);
    tb[b] = add(sym_mul(Iwb, k.al[b]), cross(k.w[b], sym_mul(Iwb, k.w[b])));
  }
  for (int d = lane; d < nv; d += G) fk_dof_row(S, k, d, o);
  __syncwarp(gmask);
  // the linear Jacobian column of each (dof, body) pair the dof moves
  for (int q = lane; q < nv * nb; q += G) {
    const int d = q / nb, b = q - d * nb;
    if (S.dof_bodies[d] >> b & 1u)
      J[q] = S.dof_is_rot[d] ? cross(k.axis[d], sub(com[b], k.anchor[d]))
                             : k.axis[d];
  }
  __syncwarp(gmask);

  // ---- generalized force per dof: τ = actuation + passive − c − B·qvel ---
  for (int d = lane; d < nv; d += G) {
    const bool rot = S.dof_is_rot[d];
    const V3 ad = k.axis[d];
    Real c = 0.0;
    for (unsigned int bits = S.dof_bodies[d]; bits; bits &= bits - 1) {
      const int b = __ffs(bits) - 1;
      c += dot(J[d * nb + b], fb[b]);
      if (rot) c += dot(ad, tb[b]);
    }
    Real t = -c - S.dof_damping[d] * ds * qv[d];
    for (int a = 0; a < nu; ++a) {
      if (S.act_dof[a] != d) continue;
      const Real uc = fminf(fmaxf(u[a], S.act_lo[a]), S.act_hi[a]);
      t += uc * S.act_gear[a] * am[a];
    }
    for (int j = 0; j < S.nj; ++j) {
      const int jt = S.jnt_type[j];
      if ((jt != HINGE && jt != SLIDE) || S.jnt_dofadr[j] != d) continue;
      const Real qj = qp[S.jnt_qposadr[j]];
      t -= S.jnt_stiffness[j] * (qj - S.jnt_qpos_spring[j]);
      if (S.jnt_limited[j]) {
        const Real vh = fmax(qj - S.jnt_range[j][1], 0.0);
        const Real vl = fmax(S.jnt_range[j][0] - qj, 0.0);
        const Real active = (vh > 0.0 || vl > 0.0) ? 1.0 : 0.0;
        t -= S.limit_stiffness * (vh - vl) + S.limit_damping * qv[d] * active;
      }
    }
    tau[d] = t;
  }

  // ---- mass matrix (lower triangle) + armature + dt·B, one entry a lane --
  const int ntri = nv * (nv + 1) / 2;
  for (int q = lane; q < ntri; q += G) {
    int d, e;
    tri_index(q, d, e);
    const bool rot_d = S.dof_is_rot[d], rot_e = S.dof_is_rot[e];
    const V3 ad = k.axis[d], ae = k.axis[e];
    Real acc = 0.0;
    for (unsigned int bits = S.dof_bodies[d] & S.dof_bodies[e]; bits;
         bits &= bits - 1) {
      const int b = __ffs(bits) - 1;
      acc += S.body_mass[b] * ms * dot(J[d * nb + b], J[e * nb + b]);
      if (rot_d && rot_e) acc += dot(ad, sym_mul(Iw + 6 * b, ae));
    }
    if (d == e) acc += S.dof_armature[d] + S.dt * (S.dof_damping[d] * ds);
    W[d * ld + e] = acc;
  }
  __syncwarp(gmask);

  // ---- Cholesky, right-looking (pivot clamped at 1e-12 like the
  // reference), one __syncwarp a column: every lane takes the pivot itself,
  // writes its rows of L's column, and updates its entries of the trailing
  // lower triangle of W from W's unscaled column, which no lane writes
  for (int j = 0; j < nv; ++j) {
    const Real piv = sqrt(fmax(W[j * ld + j], 1e-12));
    const Real inv_jj = 1.0 / piv;
    if (lane == 0) L[j * ld + j] = piv;
    for (int i = j + 1 + lane; i < nv; i += G)
      L[i * ld + j] = W[i * ld + j] * inv_jj;
    const int t = nv - j - 1;
    for (int q = lane; q < t * (t + 1) / 2; q += G) {
      int ii, cc;
      tri_index(q, ii, cc);
      const int i = j + 1 + ii, c = j + 1 + cc;
      W[i * ld + c] -= (W[i * ld + j] * inv_jj) * (W[c * ld + j] * inv_jj);
    }
    __syncwarp(gmask);
  }

  // ---- L⁻¹, one column a lane (the columns are independent) -------------
  for (int i = lane; i < nv; i += G) invd[i] = 1.0 / L[i * ld + i];
  __syncwarp(gmask);
  for (int c = lane; c < nv; c += G) {
    Li[c * ld + c] = invd[c];
    for (int i = c + 1; i < nv; ++i) {
      Real s = 0.0;
      for (int kk = c; kk < i; ++kk) s -= L[i * ld + kk] * Li[kk * ld + c];
      Li[i * ld + c] = s * invd[i];
    }
  }
  __syncwarp(gmask);

  // ---- M⁻¹ = L⁻ᵀL⁻¹ into W, then v_pred = qvel + dt·M⁻¹τ ------------------
  for (int q = lane; q < ntri; q += G) {
    int bb, a;
    tri_index(q, bb, a);
    Real s = 0.0;
    for (int kk = bb; kk < nv; ++kk) s += Li[kk * ld + a] * Li[kk * ld + bb];
    W[a * ld + bb] = s;
    W[bb * ld + a] = s;
  }
  __syncwarp(gmask);
  for (int p = lane; p < nv * nv; p += G) {
    const int a = p / nv;
    o_minv[p] = (float)W[a * ld + p - a * nv];
  }
  for (int d = lane; d < nv; d += G) {
    Real s = 0.0;
    for (int e = 0; e < nv; ++e) s += W[d * ld + e] * tau[e];
    o_vpred[d] = (float)(qv[d] + S.dt * s);
  }
}

// bytes of one env's shared scratch in K3: its Walk, then its COM and COM
// acceleration (V3 per body), then its row, qpos and qvel (floats); the
// block keeps each part for all its envs together, in that order
__host__ __device__ __forceinline__ size_t fk_vel_env_bytes(int nb, int nq,
                                                            int nv) {
  return sizeof(Walk) + 2 * nb * sizeof(V3) +
         sizeof(float) * (22 * nb + 6 * nv + nq + nv);
}

template <int G>
__global__ void __launch_bounds__(kFkThreads)
fk_vel_kernel(const SysTable* __restrict__ gsys,
              const float* __restrict__ qpos, const float* __restrict__ qvel,
              float* __restrict__ out, int E) {
  // a block's first env is a multiple of 4, so at any row width its span
  // of the output starts on 16 bytes (the wrapper's output is aligned)
  constexpr int kGroups = kFkThreads / G;
  static_assert(G <= 16 && kGroups % 4 == 0, "4, 8 or 16 lanes per env");
  __shared__ __align__(16) SysTable S;
  extern __shared__ __align__(16) Real fsm[];
  load_table(gsys, S);
  const int grp = threadIdx.x / G, lane = threadIdx.x % G;
  const unsigned gmask = ((1u << G) - 1u) << ((threadIdx.x % 32) & ~(G - 1));
  const int nb = S.nb, nq = S.nq, nv = S.nv, width = 22 * nb + 6 * nv;
  const long long env0 = (long long)blockIdx.x * kGroups;
  const int n_env = (int)min((long long)kGroups, E - env0);

  Walk* walks = reinterpret_cast<Walk*>(fsm);
  V3* com = reinterpret_cast<V3*>(walks + kGroups);  // [grp][COM nb, acc nb]
  float* rows = reinterpret_cast<float*>(com + 2 * nb * kGroups);
  float* qp = rows + kGroups * width;
  float* qv = qp + kGroups * nq;

  // the block's qpos and qvel, consecutive lanes on consecutive words
  for (int i = threadIdx.x; i < n_env * nq; i += kFkThreads)
    qp[i] = qpos[env0 * nq + i];
  for (int i = threadIdx.x; i < n_env * nv; i += kFkThreads)
    qv[i] = qvel[env0 * nv + i];
  __syncthreads();

  // a group past E idles, but stays for the block's barriers
  if (grp < n_env) {
    Walk& k = walks[grp];
    const float* q = qp + grp * nq;
    const float* v = qv + grp * nv;
    if (lane == 0) fk_root(k);
    __syncwarp(gmask);
    // level by level: a body's step reads only its parent's state
    for (int l = 0; l < S.n_levels; ++l) {
      for (int i = S.level_start[l] + lane; i < S.level_start[l + 1]; i += G)
        fk_body_step(S, q, v, k, S.level_body[i]);
      __syncwarp(gmask);
    }
    float* row = rows + grp * width;
    V3* c = com + 2 * nb * grp;
    for (int b = lane; b < nb; b += G) fk_body_row(S, k, b, row, c);
    for (int d = lane; d < nv; d += G) fk_dof_row(S, k, d, row);
  }
  __syncthreads();

  // the block's rows are one span of the output: 16-byte stores, then the
  // tail word by word
  float* o = out + env0 * width;
  const int total = n_env * width, n4 = total / 4;
  for (int i = threadIdx.x; i < n4; i += kFkThreads)
    reinterpret_cast<float4*>(o)[i] = reinterpret_cast<const float4*>(rows)[i];
  for (int i = 4 * n4 + threadIdx.x; i < total; i += kFkThreads)
    o[i] = rows[i];
}

template <int G>
int launch_full_dyn(const void* table, const float* qpos, const float* qvel,
                    const float* ctrl, const float* mass_scale,
                    const float* damping_scale, const float* act_mask,
                    float* out, int E, int out_stride, int scratch,
                    cudaStream_t stream) {
  constexpr int kGroups = kDynThreads / G;
  const size_t smem = (size_t)kGroups * scratch * sizeof(Real);
  static bool opted[cadm::kMaxDevices];  // this instantiation's opt-in
  const cudaError_t e = cadm::opt_in_smem(
      reinterpret_cast<const void*>(&full_dyn_kernel<G>), opted);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (E + kGroups - 1) / kGroups;
  full_dyn_kernel<G><<<blocks, kDynThreads, smem, stream>>>(
      static_cast<const SysTable*>(table), qpos, qvel, ctrl, mass_scale,
      damping_scale, act_mask, out, E, out_stride, scratch);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cadm_full_dyn(const void* table, const float* qpos,
                             const float* qvel, const float* ctrl,
                             const float* mass_scale,
                             const float* damping_scale, const float* act_mask,
                             float* out, int E, int out_stride, int nb, int nv,
                             void* stream) {
  if (E <= 0) return 0;
  if (nb < 1 || nb > NB_MAX || nv < 1 || nv > NV_MAX)
    return (int)cudaErrorInvalidValue;
  const int scratch = dyn_scratch_doubles(nb, nv);
  const cudaStream_t s = (cudaStream_t)stream;
  if (nv <= 16)
    return launch_full_dyn<16>(table, qpos, qvel, ctrl, mass_scale,
                               damping_scale, act_mask, out, E, out_stride,
                               scratch, s);
  return launch_full_dyn<32>(table, qpos, qvel, ctrl, mass_scale,
                             damping_scale, act_mask, out, E, out_stride,
                             scratch, s);
}

// out: E contiguous rows of 22·nb + 6·nv floats, 16-byte aligned
extern "C" int cadm_fk_vel(const void* table, const float* qpos,
                           const float* qvel, float* out, int E, int nb,
                           int nq, int nv, void* stream) {
  if (E <= 0) return 0;
  if (nb < 1 || nb > NB_MAX || nv < 1 || nv > NV_MAX || nq < 1)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  constexpr int G = CADM_FK_LANES, kGroups = kFkThreads / G;
  const size_t smem = kGroups * fk_vel_env_bytes(nb, nq, nv);
  static bool opted[cadm::kMaxDevices];  // this instantiation's opt-in
  const cudaError_t e = cadm::opt_in_smem(
      reinterpret_cast<const void*>(&fk_vel_kernel<G>), opted);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (E + kGroups - 1) / kGroups;
  fk_vel_kernel<G><<<blocks, kFkThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const SysTable*>(table), qpos, qvel, out, E);
  return (int)cudaGetLastError();
}

extern "C" int cadm_sys_table_bytes() { return (int)sizeof(SysTable); }
