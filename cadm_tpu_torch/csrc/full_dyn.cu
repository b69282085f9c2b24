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
// Design: one thread per env, table-driven. The Pallas kernel is generated
// per System with every constant an immediate, so its code size grows
// steeply with nv; here one source serves every System: the wrapper packs the
// System into a SysTable (must match ops/fk_kernel.py::SysTable field for
// field), each block copies it into shared memory, and the thread loops over
// bodies, joints and dofs with per-thread arrays sized by the compile-time
// maxima below, in double precision (see Real). What bounds it on the card:
// per-thread work is O(nv²·nb) flops and O(nv²) words of local memory for
// the Cholesky factors, so it is latency/local-memory bound; the outputs
// (22·nb + 6·nv + nv² + nv floats per env) are its only device-memory
// traffic besides the inputs.
//
// K3 replaces the Pallas TPU kernel cadm_tpu/ops/fk_kernel.py::fk_vel_pallas
// (body _fk_kernel_merged): the FK + velocity / bias-acceleration walk alone,
// the first nine fields of K2's row (22·nb + 6·nv floats per env). Both
// kernels run the same device functions (load_table, fk_walk, fk_rows), so
// K3's fields are bit-for-bit K2's. Its bound is the serial walk over the
// bodies per thread (latency); its device-memory traffic is qpos/qvel in and
// the rows out.
#include <cuda_runtime.h>

namespace {

constexpr int NB_MAX = 16;
constexpr int NJ_MAX = 24;
constexpr int NV_MAX = 24;
constexpr int NU_MAX = 24;
constexpr int kThreads = 128;
constexpr int FREE = 0, SLIDE = 2, HINGE = 3;  // cadm_tpu.physics.rigid.system

struct SysTable {
  int nb, nj, nq, nv, nu, pad_;
  int body_parent[NB_MAX];
  int body_jnt_start[NB_MAX];
  int body_jnt_num[NB_MAX];
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
// rate, and this kernel is bound by latency and local memory, not flops.
using Real = double;

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

// Copy the System table into the block's shared memory (all threads).
__device__ __forceinline__ void load_table(const SysTable* __restrict__ gsys,
                                           SysTable& S) {
  const int* src = reinterpret_cast<const int*>(gsys);
  int* dst = reinterpret_cast<int*>(&S);
  for (int i = threadIdx.x; i < (int)(sizeof(SysTable) / 4); i += blockDim.x)
    dst[i] = src[i];
  __syncthreads();
}

// Per-body frame state and per-dof (axis, anchor) after the tree walk.
struct Walk {
  V3 pos[NB_MAX], w[NB_MAX], vx[NB_MAX], al[NB_MAX], ax[NB_MAX];
  Q4 quat[NB_MAX];
  V3 axis[NV_MAX], anchor[NV_MAX];
};

// FK + velocity / bias-acceleration walk of one env over the bodies in
// tree order (parents first).
__device__ __forceinline__ void fk_walk(const SysTable& S, const float* qp,
                                        const float* qv, Walk& k) {
  const int nb = S.nb;
  V3* pos = k.pos;
  V3* w = k.w;
  V3* vx = k.vx;
  V3* al = k.al;
  V3* ax = k.ax;
  Q4* quat = k.quat;
  V3* axis = k.axis;
  V3* anchor = k.anchor;
  const V3 z3 = {0.0, 0.0, 0.0};
  pos[0] = w[0] = vx[0] = al[0] = ax[0] = z3;
  quat[0] = {1.0, 0.0, 0.0, 0.0};

  for (int b = 1; b < nb; ++b) {
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
        Real sh, ch;
        sincos(0.5 * th, &sh, &ch);
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
}

// Write the nine FK fields of one env's row (layout of
// ops/fk_kernel.py::row_layout: pos, quat, com, omega, v_com, alpha0,
// a_com0, dof_axis, dof_anchor) starting at o; returns each body's COM and
// zero-q̈ COM acceleration for K2.
__device__ __forceinline__ void fk_rows(const SysTable& S, const Walk& k,
                                        float* o, V3* com, V3* acom) {
  const int nb = S.nb, nv = S.nv;
  float* o_pos = o;
  float* o_quat = o_pos + 3 * nb;
  float* o_com = o_quat + 4 * nb;
  float* o_omega = o_com + 3 * nb;
  float* o_vcom = o_omega + 3 * nb;
  float* o_alpha = o_vcom + 3 * nb;
  float* o_acom = o_alpha + 3 * nb;
  float* o_axis = o_acom + 3 * nb;
  float* o_anchor = o_axis + 3 * nv;
  for (int b = 0; b < nb; ++b) {
    const V3 rc = qrot(k.quat[b], v3(S.body_ipos[b]));
    com[b] = add(k.pos[b], rc);
    const V3 vcom = add(k.vx[b], cross(k.w[b], rc));
    acom[b] = add(add(k.ax[b], cross(k.al[b], rc)),
                  cross(k.w[b], cross(k.w[b], rc)));
    put3(o_pos + 3 * b, k.pos[b]);
    o_quat[4 * b + 0] = (float)k.quat[b].w;
    o_quat[4 * b + 1] = (float)k.quat[b].x;
    o_quat[4 * b + 2] = (float)k.quat[b].y;
    o_quat[4 * b + 3] = (float)k.quat[b].z;
    put3(o_com + 3 * b, com[b]);
    put3(o_omega + 3 * b, k.w[b]);
    put3(o_vcom + 3 * b, vcom);
    put3(o_alpha + 3 * b, k.al[b]);
    put3(o_acom + 3 * b, acom[b]);
  }
  for (int d = 0; d < nv; ++d) {
    put3(o_axis + 3 * d, k.axis[d]);
    put3(o_anchor + 3 * d, k.anchor[d]);
  }
}

__global__ void __launch_bounds__(kThreads)
full_dyn_kernel(const SysTable* __restrict__ gsys,
                const float* __restrict__ qpos, const float* __restrict__ qvel,
                const float* __restrict__ ctrl,
                const float* __restrict__ mass_scale,
                const float* __restrict__ damping_scale,
                const float* __restrict__ act_mask, float* __restrict__ out,
                int E, int out_stride) {
  __shared__ SysTable S;
  load_table(gsys, S);
  const long long env = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= E) return;

  const int nb = S.nb, nv = S.nv, nu = S.nu;
  const float* qp = qpos + env * S.nq;
  const float* qv = qvel + env * nv;
  const float* u = ctrl + env * nu;
  const float* am = act_mask + env * nu;
  const Real ms = mass_scale[env];
  const Real ds = damping_scale[env];

  Walk k;
  fk_walk(S, qp, qv, k);
  const V3* w = k.w;
  const V3* al = k.al;
  const Q4* quat = k.quat;
  const V3* axis = k.axis;
  const V3* anchor = k.anchor;

  float* o_row = out + env * out_stride;
  float* o_minv = o_row + 22 * nb + 6 * nv;
  float* o_vpred = o_minv + nv * nv;

  // per body: COM, world inertia × mass_scale, bias force and torque
  V3 com[NB_MAX], acom[NB_MAX], fb[NB_MAX], tb[NB_MAX];
  Real Iw[NB_MAX][6];
  fk_rows(S, k, o_row, com, acom);
  for (int b = 0; b < nb; ++b) {
    const Q4 qi = qmul(quat[b], q4(S.body_iquat[b]));
    const Real R[3][3] = {
        {1.0 - 2.0 * (qi.y * qi.y + qi.z * qi.z), 2.0 * (qi.x * qi.y - qi.w * qi.z),
         2.0 * (qi.x * qi.z + qi.w * qi.y)},
        {2.0 * (qi.x * qi.y + qi.w * qi.z), 1.0 - 2.0 * (qi.x * qi.x + qi.z * qi.z),
         2.0 * (qi.y * qi.z - qi.w * qi.x)},
        {2.0 * (qi.x * qi.z - qi.w * qi.y), 2.0 * (qi.y * qi.z + qi.w * qi.x),
         1.0 - 2.0 * (qi.x * qi.x + qi.y * qi.y)}};
    const float* Id = S.body_inertia[b];
    int k = 0;
    for (int i = 0; i < 3; ++i)
      for (int jj = i; jj < 3; ++jj, ++k)
        Iw[b][k] = (R[i][0] * Id[0] * R[jj][0] + R[i][1] * Id[1] * R[jj][1] +
                    R[i][2] * Id[2] * R[jj][2]) * ms;
    fb[b] = scale(sub(acom[b], v3(S.gravity)), S.body_mass[b] * ms);
    tb[b] = add(sym_mul(Iw[b], al[b]), cross(w[b], sym_mul(Iw[b], w[b])));
  }

  // ---- generalized force τ = actuation + passive − c − B·qvel ------------
  Real tau[NV_MAX];
  for (int d = 0; d < nv; ++d) {
    const bool rot = S.dof_is_rot[d];
    Real c = 0.0;
    for (unsigned int bits = S.dof_bodies[d]; bits; bits &= bits - 1) {
      const int b = __ffs(bits) - 1;
      const V3 col = rot ? cross(axis[d], sub(com[b], anchor[d])) : axis[d];
      c += dot(col, fb[b]);
      if (rot) c += dot(axis[d], tb[b]);
    }
    tau[d] = -c - S.dof_damping[d] * ds * qv[d];
  }
  for (int a = 0; a < nu; ++a) {
    const Real uc = fminf(fmaxf(u[a], S.act_lo[a]), S.act_hi[a]);
    tau[S.act_dof[a]] += uc * S.act_gear[a] * am[a];
  }
  for (int j = 0; j < S.nj; ++j) {
    const int jt = S.jnt_type[j];
    if (jt != HINGE && jt != SLIDE) continue;
    const int da = S.jnt_dofadr[j];
    const Real qj = qp[S.jnt_qposadr[j]];
    tau[da] -= S.jnt_stiffness[j] * (qj - S.jnt_qpos_spring[j]);
    if (S.jnt_limited[j]) {
      const Real vh = fmax(qj - S.jnt_range[j][1], 0.0);
      const Real vl = fmax(S.jnt_range[j][0] - qj, 0.0);
      const Real active = (vh > 0.0 || vl > 0.0) ? 1.0 : 0.0;
      tau[da] -= S.limit_stiffness * (vh - vl) + S.limit_damping * qv[da] * active;
    }
  }

  // ---- mass matrix (lower triangle) + armature + dt·B --------------------
  Real L[NV_MAX][NV_MAX];
  for (int d = 0; d < nv; ++d) {
    const bool rot_d = S.dof_is_rot[d];
    for (int e = 0; e <= d; ++e) {
      const bool rot_e = S.dof_is_rot[e];
      Real acc = 0.0;
      for (unsigned int bits = S.dof_bodies[d] & S.dof_bodies[e]; bits;
           bits &= bits - 1) {
        const int b = __ffs(bits) - 1;
        const V3 cd = rot_d ? cross(axis[d], sub(com[b], anchor[d])) : axis[d];
        const V3 ce = rot_e ? cross(axis[e], sub(com[b], anchor[e])) : axis[e];
        acc += S.body_mass[b] * ms * dot(cd, ce);
        if (rot_d && rot_e) acc += dot(axis[d], sym_mul(Iw[b], axis[e]));
      }
      if (d == e) acc += S.dof_armature[d] + S.dt * (S.dof_damping[d] * ds);
      L[d][e] = acc;
    }
  }

  // ---- Cholesky (pivot clamped at 1e-12 like the reference) → L⁻¹ --------
  for (int j = 0; j < nv; ++j) {
    Real s = L[j][j];
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    L[j][j] = sqrt(fmax(s, 1e-12));
    const Real inv_jj = 1.0 / L[j][j];
    for (int i = j + 1; i < nv; ++i) {
      Real t = L[i][j];
      for (int k = 0; k < j; ++k) t -= L[i][k] * L[j][k];
      L[i][j] = t * inv_jj;
    }
  }
  Real Li[NV_MAX][NV_MAX];  // lower-triangular L⁻¹
  for (int j = 0; j < nv; ++j) {
    Li[j][j] = 1.0 / L[j][j];
    for (int i = j + 1; i < nv; ++i) {
      Real s = 0.0;
      for (int k = j; k < i; ++k) s -= L[i][k] * Li[k][j];
      Li[i][j] = s / L[i][i];
    }
  }

  // ---- M⁻¹ = L⁻ᵀL⁻¹ and v_pred = qvel + dt·M⁻¹τ ---------------------------
  Real vp[NV_MAX];
  for (int d = 0; d < nv; ++d) vp[d] = 0.0;
  for (int a = 0; a < nv; ++a) {
    for (int b = a; b < nv; ++b) {
      Real s = 0.0;
      for (int k = b; k < nv; ++k) s += Li[k][a] * Li[k][b];
      o_minv[a * nv + b] = (float)s;
      o_minv[b * nv + a] = (float)s;
      vp[a] += s * tau[b];
      if (b != a) vp[b] += s * tau[a];
    }
  }
  for (int d = 0; d < nv; ++d) o_vpred[d] = (float)(qv[d] + S.dt * vp[d]);
}

__global__ void __launch_bounds__(kThreads)
fk_vel_kernel(const SysTable* __restrict__ gsys,
              const float* __restrict__ qpos, const float* __restrict__ qvel,
              float* __restrict__ out, int E, int out_stride) {
  __shared__ SysTable S;
  load_table(gsys, S);
  const long long env = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= E) return;
  Walk k;
  fk_walk(S, qpos + env * S.nq, qvel + env * S.nv, k);
  V3 com[NB_MAX], acom[NB_MAX];
  fk_rows(S, k, out + env * out_stride, com, acom);
}

}  // namespace

extern "C" int cadm_full_dyn(const void* table, const float* qpos,
                             const float* qvel, const float* ctrl,
                             const float* mass_scale,
                             const float* damping_scale, const float* act_mask,
                             float* out, int E, int out_stride, void* stream) {
  if (E <= 0) return 0;
  const int blocks = (E + kThreads - 1) / kThreads;
  full_dyn_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const SysTable*>(table), qpos, qvel, ctrl, mass_scale,
      damping_scale, act_mask, out, E, out_stride);
  return (int)cudaGetLastError();
}

extern "C" int cadm_fk_vel(const void* table, const float* qpos,
                           const float* qvel, float* out, int E,
                           int out_stride, void* stream) {
  if (E <= 0) return 0;
  const int blocks = (E + kThreads - 1) / kThreads;
  fk_vel_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const SysTable*>(table), qpos, qvel, out, E, out_stride);
  return (int)cudaGetLastError();
}

extern "C" int cadm_sys_table_bytes() { return (int)sizeof(SysTable); }
