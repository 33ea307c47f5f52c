// Whole-rollout kernel for the predictive-sampling planner, for sm_90a.
//
// Replaces the TPU kernel mujoco_mpc_tpu/ops/megarollout.py::
// MegaRollout.returns (the pl.pallas_call at megarollout.py:339, body
// _rollout_body -> physics/tilestep.py::step_tb -> task residual ->
// cost_value_t). It computes the same thing: the mean per-step cost of each
// of N open-loop candidates over T physics steps from one shared start
// state, carrying the APGD warm-start duals from step to step; a
// non-finite total becomes MAX_RETURN (1e6). The plain PyTorch version it
// is held against is mujoco_mpc_torch/ops/megarollout.py::_rollout_body.
//
// Design: one thread per candidate, blocks of 64 threads. Each thread keeps
// its whole state in local arrays with compile-time maximum sizes (qpos,
// qvel, the duals, the constraint Jacobian J[nrow][nv], the nv x nv
// Cholesky factor, the APGD vectors) and runs the T-step loop itself. The
// model is a POD struct (MRModel) packed once per MegaRollout; each block
// copies it into shared memory.
//
// What bounds it on this card: latency, not bytes or FLOPs. A Walker step
// is ~30 kFLOP of dependent scalar arithmetic per candidate, most of it in
// the 21 matrix-free Delassus products of the constraint solve, and the
// ~19 KB per-thread working set lives in local memory (L1/L2). 1024
// candidates fill only 1024 threads: 16 blocks of 64 on 132 SMs, two warps
// per busy SM. That occupancy is a known limit, left to later performance
// work (e.g. one warp per candidate with rows spread over the lanes).
//
// Not built with --use_fast_math: it could fold away the isfinite guard and
// changes expf/sqrtf/log1pf against the plain version.

#include <cstddef>
#include <cuda_runtime.h>

#define MR_MAX_NV 16      // nq == nv for hinge/slide models
#define MR_MAX_BODY 16
#define MR_MAX_JNT 16
#define MR_MAX_NU 16
#define MR_MAX_CON 20     // contact points
#define MR_MAX_LIM 16     // limited joints (two rows each)
#define MR_MAX_ROW 64     // constraint rows
#define MR_MAX_DENSE 32   // largest nrow solved with a materialized Delassus
#define MR_MAX_TERM 16
#define MR_MAX_RES 32     // residual entries
#define MR_MAX_RES_INT 8

#define MR_ITERATIONS 12
#define MR_POWER_ITERS 8
#define MR_MAX_RETURN 1e6f

#define MR_SLIDE 2
#define MR_HINGE 3

#define MR_RES_WALKER 1

// Every field is 4 bytes wide, so the layout has no padding; the wrapper
// (ops/megarollout.py::_MRModel) mirrors it and checks it against
// mr_model_layout().
#define MR_MODEL_FIELDS(X)                                                   \
  X(int, nq, )                                                               \
  X(int, nv, )                                                               \
  X(int, nu, )                                                               \
  X(int, nbody, )                                                            \
  X(int, njnt, )                                                             \
  X(int, ncon, )                                                             \
  X(int, nlim, )                                                             \
  X(int, nrow, )                                                             \
  X(int, dense, )                                                            \
  X(int, nterm, )                                                            \
  X(int, nres, )                                                             \
  X(int, res_id, )                                                           \
  X(int, res_int, [MR_MAX_RES_INT])                                          \
  X(float, timestep, )                                                       \
  X(float, gravity, [3])                                                     \
  X(int, body_parentid, [MR_MAX_BODY])                                       \
  X(int, body_jntadr, [MR_MAX_BODY])                                         \
  X(int, body_jntnum, [MR_MAX_BODY])                                         \
  X(float, body_pos, [MR_MAX_BODY][3])                                       \
  X(float, body_quat, [MR_MAX_BODY][4])                                      \
  X(float, body_ipos, [MR_MAX_BODY][3])                                      \
  X(float, body_iquat, [MR_MAX_BODY][4])                                     \
  X(float, body_mass, [MR_MAX_BODY])                                         \
  X(float, body_inertia, [MR_MAX_BODY][3])                                   \
  X(int, jnt_type, [MR_MAX_JNT])                                             \
  X(int, jnt_qposadr, [MR_MAX_JNT])                                          \
  X(int, jnt_dofadr, [MR_MAX_JNT])                                           \
  X(float, jnt_pos, [MR_MAX_JNT][3])                                         \
  X(float, jnt_axis, [MR_MAX_JNT][3])                                        \
  X(float, jnt_stiffness, [MR_MAX_JNT])                                      \
  X(float, qpos0, [MR_MAX_NV])                                               \
  X(float, qpos_spring, [MR_MAX_NV])                                         \
  X(float, dof_damping, [MR_MAX_NV])                                         \
  X(float, dof_armature, [MR_MAX_NV])                                        \
  X(float, dof_frictionloss, [MR_MAX_NV])                                    \
  X(int, dof_body, [MR_MAX_NV])                                              \
  X(int, dof_body_mask, [MR_MAX_NV][MR_MAX_BODY])                            \
  X(int, dof_ancestor_mask, [MR_MAX_NV][MR_MAX_NV])                          \
  X(int, cdofdot_vel_mask, [MR_MAX_NV][MR_MAX_NV])                           \
  X(int, act_vadr, [MR_MAX_NU])                                              \
  X(int, act_qadr, [MR_MAX_NU])                                              \
  X(int, act_gain_fixed, [MR_MAX_NU])                                        \
  X(int, act_bias_fixed, [MR_MAX_NU])                                        \
  X(int, ctrl_limited, [MR_MAX_NU])                                          \
  X(int, force_limited, [MR_MAX_NU])                                         \
  X(float, act_gear, [MR_MAX_NU])                                            \
  X(float, act_gainprm, [MR_MAX_NU][3])                                      \
  X(float, act_biasprm, [MR_MAX_NU][3])                                      \
  X(float, ctrl_lo, [MR_MAX_NU])                                             \
  X(float, ctrl_hi, [MR_MAX_NU])                                             \
  X(float, force_lo, [MR_MAX_NU])                                            \
  X(float, force_hi, [MR_MAX_NU])                                            \
  X(int, con_gbody, [MR_MAX_CON])                                            \
  X(float, con_gpos, [MR_MAX_CON][3])                                        \
  X(float, con_gquat, [MR_MAX_CON][4])                                       \
  X(float, con_end, [MR_MAX_CON])                                            \
  X(float, con_r, [MR_MAX_CON])                                              \
  X(float, con_margin, [MR_MAX_CON])                                         \
  X(float, con_mu, [MR_MAX_CON])                                             \
  X(float, con_frame, [MR_MAX_CON][3][3])                                    \
  X(float, con_ppos, [MR_MAX_CON][3])                                        \
  X(float, con_sgn, [MR_MAX_CON][MR_MAX_NV])                                 \
  X(float, con_imp, [MR_MAX_CON][5])                                         \
  X(float, con_k, [MR_MAX_CON])                                              \
  X(float, con_b, [MR_MAX_CON])                                              \
  X(int, lim_qadr, [MR_MAX_LIM])                                             \
  X(int, lim_vadr, [MR_MAX_LIM])                                             \
  X(float, lim_lo, [MR_MAX_LIM])                                             \
  X(float, lim_hi, [MR_MAX_LIM])                                             \
  X(float, lim_margin, [MR_MAX_LIM])                                         \
  X(float, lim_k, [MR_MAX_LIM])                                              \
  X(float, lim_b, [MR_MAX_LIM])                                              \
  X(float, lim_imp, [5])                                                     \
  X(int, term_dim, [MR_MAX_TERM])                                            \
  X(int, term_norm, [MR_MAX_TERM])

struct MRModel {
#define MR_DECLARE(type, name, dims) type name dims;
  MR_MODEL_FIELDS(MR_DECLARE)
#undef MR_DECLARE
};

// ---------------------------------------------------------------------------
// small vector math (row-major 3x3 matrices, quaternions w, x, y, z)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void quat_mul(const float* a, const float* b,
                                         float* o) {
  float w = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  float x = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  float y = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  float z = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
  o[0] = w; o[1] = x; o[2] = y; o[3] = z;
}

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* o) {
  float x = a[1] * b[2] - a[2] * b[1];
  float y = a[2] * b[0] - a[0] * b[2];
  float z = a[0] * b[1] - a[1] * b[0];
  o[0] = x; o[1] = y; o[2] = z;
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void quat_rot(const float* q, const float* v,
                                         float* o) {
  float uv[3], uuv[3];
  cross3(q + 1, v, uv);
  cross3(q + 1, uv, uuv);
  for (int k = 0; k < 3; ++k) o[k] = v[k] + 2.0f * (q[0] * uv[k] + uuv[k]);
}

__device__ __forceinline__ void quat_to_mat(const float* q, float* m) {
  float w = q[0], x = q[1], y = q[2], z = q[3];
  m[0] = 1 - 2 * (y * y + z * z); m[1] = 2 * (x * y - w * z);
  m[2] = 2 * (x * z + w * y);
  m[3] = 2 * (x * y + w * z); m[4] = 1 - 2 * (x * x + z * z);
  m[5] = 2 * (y * z - w * x);
  m[6] = 2 * (x * z - w * y); m[7] = 2 * (y * z + w * x);
  m[8] = 1 - 2 * (x * x + y * y);
}

// spatial inertia about the world origin times motion [va; vl]
__device__ __forceinline__ void inert_mul(const float* Iw, const float* com,
                                          float mass, const float* va,
                                          const float* vl, float* fa,
                                          float* fl) {
  float t1[3], t2[3], t3[3];
  cross3(com, va, t1);
  cross3(com, t1, t2);
  cross3(com, vl, t3);
  for (int i = 0; i < 3; ++i) {
    float s = 0.0f;
    for (int k = 0; k < 3; ++k) s += Iw[3 * i + k] * va[k];
    fa[i] = s - mass * t2[i] + mass * t3[i];
    fl[i] = -mass * t1[i] + mass * vl[i];
  }
}

__device__ __forceinline__ float impedance(float pos, const float* c) {
  // c = d0, d1, width, mid, power (already clamped on the host)
  float x = fminf(fmaxf(fabsf(pos) / c[2], 0.0f), 1.0f);
  float mid = c[3], power = c[4];
  float y = x < mid ? powf(x / mid, power) * mid
                    : 1.0f - powf((1 - x) / (1 - mid), power) * (1 - mid);
  return fminf(fmaxf(c[0] + y * (c[1] - c[0]), 1e-4f), 0.9999f);
}

// L L^T x = b with L lower-triangular, stored in l[MR_MAX_NV][MR_MAX_NV]
__device__ __forceinline__ void chol_solve(const float (*l)[MR_MAX_NV],
                                           const float* b, float* x, int n) {
  float y[MR_MAX_NV];
  for (int i = 0; i < n; ++i) {
    float acc = b[i];
    for (int k = 0; k < i; ++k) acc -= l[i][k] * y[k];
    y[i] = acc / l[i][i];
  }
  for (int i = n - 1; i >= 0; --i) {
    float acc = y[i];
    for (int k = i + 1; k < n; ++k) acc -= l[k][i] * x[k];
    x[i] = acc / l[i][i];
  }
}

// ---------------------------------------------------------------------------
// constraint solve helpers
// ---------------------------------------------------------------------------

struct Rows {
  float J[MR_MAX_ROW][MR_MAX_NV];
  float s_pre[MR_MAX_ROW];
  float reg[MR_MAX_ROW];
  int active[MR_MAX_ROW];
  float mu_t[MR_MAX_CON];
  float amat[MR_MAX_DENSE * MR_MAX_DENSE];  // only when m.dense
};

// out = A v with A = J M^-1 J^T (dense: the materialized matrix)
__device__ void amul(const MRModel& m, const Rows& R,
                     const float (*l)[MR_MAX_NV], const float* v,
                     float* out) {
  const int nrow = m.nrow, nv = m.nv;
  if (m.dense) {
    for (int r = 0; r < nrow; ++r) {
      float s = 0.0f;
      for (int c = 0; c < nrow; ++c) s += R.amat[r * nrow + c] * v[c];
      out[r] = s;
    }
    return;
  }
  float jtv[MR_MAX_NV], x[MR_MAX_NV];
  for (int k = 0; k < nv; ++k) {
    float s = 0.0f;
    for (int r = 0; r < nrow; ++r) s += R.J[r][k] * v[r];
    jtv[k] = s;
  }
  chol_solve(l, jtv, x, nv);
  for (int r = 0; r < nrow; ++r) {
    float s = 0.0f;
    for (int k = 0; k < nv; ++k) s += R.J[r][k] * x[k];
    out[r] = s;
  }
}

// friction-cone / orthant projection, then the active mask
__device__ void project(const MRModel& m, const Rows& R, float* g) {
  for (int ci = 0; ci < m.ncon; ++ci) {
    float* gc = g + 3 * ci;
    float gn = fmaxf(gc[0], 0.0f);
    float tsq = gc[1] * gc[1] + gc[2] * gc[2];
    float tnorm = tsq < 1e-24f ? 0.0f : sqrtf(tsq);
    float cap = R.mu_t[ci] * gn;
    float sc = tnorm > cap ? cap / fmaxf(tnorm, 1e-12f) : 1.0f;
    gc[0] = gn;
    gc[1] *= sc;
    gc[2] *= sc;
  }
  for (int r = 3 * m.ncon; r < m.nrow; ++r) g[r] = fmaxf(g[r], 0.0f);
  for (int r = 0; r < m.nrow; ++r)
    if (!R.active[r]) g[r] = 0.0f;
}

__device__ void opmul(const MRModel& m, const Rows& R,
                      const float (*l)[MR_MAX_NV], const float* v,
                      float* out) {
  float sv[MR_MAX_ROW], av[MR_MAX_ROW];
  for (int r = 0; r < m.nrow; ++r)
    sv[r] = R.active[r] ? R.s_pre[r] * v[r] : 0.0f;
  amul(m, R, l, sv, av);
  for (int r = 0; r < m.nrow; ++r)
    out[r] = R.active[r] ? R.s_pre[r] * (av[r] + R.reg[r] * sv[r]) : 0.0f;
}

// ---------------------------------------------------------------------------
// one physics step (physics/tilestep.py::step_tb)
// ---------------------------------------------------------------------------

// Advances qpos/qvel in place and replaces lam with the converged duals.
// xpos/xmat receive the PRE-step body frames the residual reads.
__device__ void tile_step(const MRModel& m, float* qpos, float* qvel,
                          const float* ctrl, float* lam,
                          float (*xpos)[3], float (*xmat)[9]) {
  const int nv = m.nv, nbody = m.nbody;
  const float h = m.timestep;

  // ---- forward kinematics
  float xquat[MR_MAX_BODY][4];
  float xanchor[MR_MAX_JNT][3], xaxis[MR_MAX_JNT][3];
  for (int i = 0; i < 3; ++i) xpos[0][i] = 0.0f;
  xquat[0][0] = 1.0f; xquat[0][1] = xquat[0][2] = xquat[0][3] = 0.0f;
  for (int bd = 1; bd < nbody; ++bd) {
    const int p = m.body_parentid[bd];
    float quat[4], pos[3], tmp[3];
    quat_mul(xquat[p], m.body_quat[bd], quat);
    quat_rot(xquat[p], m.body_pos[bd], tmp);
    for (int i = 0; i < 3; ++i) pos[i] = xpos[p][i] + tmp[i];
    const int j0 = m.body_jntadr[bd], j1 = j0 + m.body_jntnum[bd];
    for (int j = j0; j < j1; ++j) {
      const int qadr = m.jnt_qposadr[j];
      const float* ax = m.jnt_axis[j];
      const float* jp = m.jnt_pos[j];
      float anchor[3];
      quat_rot(quat, jp, tmp);
      for (int i = 0; i < 3; ++i) anchor[i] = pos[i] + tmp[i];
      float d = qpos[qadr] - m.qpos0[qadr];
      if (m.jnt_type[j] == MR_SLIDE) {
        quat_rot(quat, ax, tmp);
        for (int i = 0; i < 3; ++i) pos[i] = pos[i] + tmp[i] * d;
      } else {  // hinge
        float half = 0.5f * d, s = sinf(half);
        float aq[4] = {cosf(half), ax[0] * s, ax[1] * s, ax[2] * s};
        float q2[4];
        quat_mul(quat, aq, q2);
        for (int i = 0; i < 4; ++i) quat[i] = q2[i];
        quat_rot(quat, jp, tmp);
        for (int i = 0; i < 3; ++i) pos[i] = anchor[i] - tmp[i];
      }
      for (int i = 0; i < 3; ++i) xanchor[j][i] = anchor[i];
      quat_rot(quat, ax, xaxis[j]);
    }
    for (int i = 0; i < 3; ++i) xpos[bd][i] = pos[i];
    for (int i = 0; i < 4; ++i) xquat[bd][i] = quat[i];
  }
  float xipos[MR_MAX_BODY][3], ximat[MR_MAX_BODY][9];
  for (int bd = 0; bd < nbody; ++bd) {
    float tmp[3], q[4];
    quat_to_mat(xquat[bd], xmat[bd]);
    quat_rot(xquat[bd], m.body_ipos[bd], tmp);
    for (int i = 0; i < 3; ++i) xipos[bd][i] = xpos[bd][i] + tmp[i];
    quat_mul(xquat[bd], m.body_iquat[bd], q);
    quat_to_mat(q, ximat[bd]);
  }

  // ---- cdof [ang; lin] per dof
  float cdof[MR_MAX_NV][6];
  for (int j = 0; j < m.njnt; ++j) {
    const int k = m.jnt_dofadr[j];
    if (m.jnt_type[j] == MR_SLIDE) {
      for (int i = 0; i < 3; ++i) { cdof[k][i] = 0.0f; cdof[k][3 + i] = xaxis[j][i]; }
    } else {
      for (int i = 0; i < 3; ++i) cdof[k][i] = xaxis[j][i];
      cross3(xanchor[j], xaxis[j], cdof[k] + 3);
    }
  }

  // ---- body velocities + cdof_dot (static masks)
  float cvel[MR_MAX_BODY][6];
  for (int bd = 0; bd < nbody; ++bd) {
    for (int i = 0; i < 6; ++i) cvel[bd][i] = 0.0f;
    for (int k = 0; k < nv; ++k)
      if (m.dof_body_mask[k][bd])
        for (int i = 0; i < 6; ++i) cvel[bd][i] += cdof[k][i] * qvel[k];
  }
  float cdofdot[MR_MAX_NV][6];
  for (int k = 0; k < nv; ++k) {
    float v[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < nv; ++i)
      if (m.cdofdot_vel_mask[k][i])
        for (int c = 0; c < 6; ++c) v[c] += cdof[i][c] * qvel[i];
    float t1[3], t2[3];
    cross3(v, cdof[k], cdofdot[k]);
    cross3(v, cdof[k] + 3, t1);
    cross3(v + 3, cdof[k], t2);
    for (int i = 0; i < 3; ++i) cdofdot[k][3 + i] = t1[i] + t2[i];
  }

  // ---- spatial inertias and composite (CRB) inertias
  float Iw[MR_MAX_BODY][9], compTL[MR_MAX_BODY][9];
  float compMC[MR_MAX_BODY][3], compM[MR_MAX_BODY];
  for (int bd = 0; bd < nbody; ++bd) {
    const float* R = ximat[bd];
    const float* I = m.body_inertia[bd];
    const float mass = m.body_mass[bd];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        float s = 0.0f;
        for (int k = 0; k < 3; ++k) s += R[3 * i + k] * I[k] * R[3 * j + k];
        Iw[bd][3 * i + j] = s;
      }
    const float cx = xipos[bd][0], cy = xipos[bd][1], cz = xipos[bd][2];
    const float cc[9] = {cy * cy + cz * cz, -cx * cy, -cx * cz,
                         -cx * cy, cx * cx + cz * cz, -cy * cz,
                         -cx * cz, -cy * cz, cx * cx + cy * cy};
    for (int i = 0; i < 9; ++i) compTL[bd][i] = Iw[bd][i] + mass * cc[i];
    for (int i = 0; i < 3; ++i) compMC[bd][i] = mass * xipos[bd][i];
    compM[bd] = mass;
  }
  for (int bd = nbody - 1; bd > 0; --bd) {
    const int p = m.body_parentid[bd];
    if (p > 0) {
      for (int i = 0; i < 9; ++i) compTL[p][i] += compTL[bd][i];
      for (int i = 0; i < 3; ++i) compMC[p][i] += compMC[bd][i];
      compM[p] += compM[bd];
    }
  }

  // ---- joint-space inertia (ancestor sparsity) + implicit damping
  float L[MR_MAX_NV][MR_MAX_NV];
  for (int i = 0; i < nv; ++i)
    for (int j = 0; j < nv; ++j) L[i][j] = 0.0f;
  for (int j = 0; j < nv; ++j) {
    const int bd = m.dof_body[j];
    const float* va = cdof[j];
    const float* vl = cdof[j] + 3;
    float fa[3], fl[3], t[3];
    cross3(compMC[bd], vl, t);
    for (int i = 0; i < 3; ++i) {
      float s = 0.0f;
      for (int k = 0; k < 3; ++k) s += compTL[bd][3 * i + k] * va[k];
      fa[i] = s + t[i];
    }
    cross3(compMC[bd], va, t);
    for (int i = 0; i < 3; ++i) fl[i] = -t[i] + compM[bd] * vl[i];
    for (int i = 0; i <= j; ++i)
      if (m.dof_ancestor_mask[i][j]) {
        float v = dot3(cdof[i], fa) + dot3(cdof[i] + 3, fl);
        L[i][j] = v;
        L[j][i] = v;
      }
  }
  for (int k = 0; k < nv; ++k)
    L[k][k] = L[k][k] + m.dof_armature[k] + h * m.dof_damping[k];
  // in-place Cholesky (lower triangle), pivots clamped at 1e-12
  for (int j = 0; j < nv; ++j) {
    float s = L[j][j];
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    const float ljj = sqrtf(fmaxf(s, 1e-12f));
    const float inv = 1.0f / ljj;
    L[j][j] = ljj;
    for (int i = j + 1; i < nv; ++i) {
      float r = L[i][j];
      for (int k = 0; k < j; ++k) r -= L[i][k] * L[j][k];
      L[i][j] = r * inv;
    }
  }

  // ---- RNE bias (qacc = 0, base acceleration = -gravity)
  float cacc[MR_MAX_BODY][6], cfrc[MR_MAX_BODY][6];
  for (int i = 0; i < 3; ++i) { cacc[0][i] = 0.0f; cacc[0][3 + i] = 0.0f - m.gravity[i]; }
  for (int bd = 1; bd < nbody; ++bd) {
    const int p = m.body_parentid[bd];
    for (int i = 0; i < 6; ++i) cacc[bd][i] = cacc[p][i];
    for (int k = 0; k < nv; ++k)
      if (m.dof_body[k] == bd)
        for (int i = 0; i < 6; ++i) cacc[bd][i] += cdofdot[k][i] * qvel[k];
  }
  for (int bd = 0; bd < nbody; ++bd) {
    float fav[3], flv[3], faa[3], fla[3], t1[3], t2[3], t3[3];
    const float* va = cvel[bd];
    const float* vl = cvel[bd] + 3;
    inert_mul(Iw[bd], xipos[bd], m.body_mass[bd], va, vl, fav, flv);
    inert_mul(Iw[bd], xipos[bd], m.body_mass[bd], cacc[bd], cacc[bd] + 3,
              faa, fla);
    cross3(va, fav, t1);
    cross3(vl, flv, t2);
    cross3(va, flv, t3);
    for (int i = 0; i < 3; ++i) {
      cfrc[bd][i] = faa[i] + t1[i] + t2[i];
      cfrc[bd][3 + i] = fla[i] + t3[i];
    }
  }
  for (int bd = nbody - 1; bd > 0; --bd) {
    const int p = m.body_parentid[bd];
    for (int i = 0; i < 6; ++i) cfrc[p][i] += cfrc[bd][i];
  }

  // ---- passive + actuation -> smooth force and acceleration
  float qfrc[MR_MAX_NV], qacc_smooth[MR_MAX_NV];
  float qact[MR_MAX_NV];
  for (int k = 0; k < nv; ++k) {
    float f = -m.dof_damping[k] * qvel[k];
    if (m.dof_frictionloss[k] != 0.0f)
      f = f - m.dof_frictionloss[k] * tanhf(qvel[k] / 0.01f);
    qfrc[k] = f;
    qact[k] = 0.0f;
  }
  for (int j = 0; j < m.njnt; ++j) {
    const float ks = m.jnt_stiffness[j];
    if (ks != 0.0f) {
      const int qadr = m.jnt_qposadr[j], vadr = m.jnt_dofadr[j];
      qfrc[vadr] = qfrc[vadr] - ks * (qpos[qadr] - m.qpos_spring[qadr]);
    }
  }
  for (int u = 0; u < m.nu; ++u) {
    float c = ctrl[u];
    if (m.ctrl_limited[u]) c = fminf(fmaxf(c, m.ctrl_lo[u]), m.ctrl_hi[u]);
    const float gear = m.act_gear[u];
    const float length = gear * qpos[m.act_qadr[u]];
    const float velocity = gear * qvel[m.act_vadr[u]];
    const float* gp = m.act_gainprm[u];
    const float* bp = m.act_biasprm[u];
    const float gain = m.act_gain_fixed[u]
        ? gp[0] : gp[0] + gp[1] * length + gp[2] * velocity;
    const float bias = m.act_bias_fixed[u]
        ? 0.0f : bp[0] + bp[1] * length + bp[2] * velocity;
    float force = gain * c + bias;
    if (m.force_limited[u])
      force = fminf(fmaxf(force, m.force_lo[u]), m.force_hi[u]);
    qact[m.act_vadr[u]] += gear * force;
  }
  for (int k = 0; k < nv; ++k) {
    const int bd = m.dof_body[k];
    const float bias = dot3(cdof[k], cfrc[bd]) + dot3(cdof[k] + 3, cfrc[bd] + 3);
    qfrc[k] = qfrc[k] + qact[k] - bias;
  }
  chol_solve(L, qfrc, qacc_smooth, nv);

  // ---- constraint rows: contact points (n, t1, t2), then limits (lo, hi)
  const int nrow = m.nrow;
  float qfrc_c[MR_MAX_NV];
  for (int k = 0; k < nv; ++k) qfrc_c[k] = 0.0f;
  if (nrow > 0) {
    Rows R;
    float aref[MR_MAX_ROW], raw_diag[MR_MAX_ROW], a0[MR_MAX_ROW];
    float imp[MR_MAX_ROW];
    int r = 0;
    for (int ci = 0; ci < m.ncon; ++ci) {
      const int bg = m.con_gbody[ci];
      float gpos[3], gq[4], gm[9], tmp[3], end[3], cpos[3];
      quat_rot(xquat[bg], m.con_gpos[ci], tmp);
      for (int i = 0; i < 3; ++i) gpos[i] = xpos[bg][i] + tmp[i];
      quat_mul(xquat[bg], m.con_gquat[ci], gq);
      quat_to_mat(gq, gm);
      const float axis[3] = {gm[2], gm[5], gm[8]};
      for (int i = 0; i < 3; ++i) end[i] = gpos[i] + m.con_end[ci] * axis[i];
      const float* n = m.con_frame[ci][0];
      const float* pp = m.con_ppos[ci];
      const float rad = m.con_r[ci];
      float dist = (n[0] * (end[0] - pp[0]) + n[1] * (end[1] - pp[1]) +
                    n[2] * (end[2] - pp[2])) - rad;
      const float scale = rad + 0.5f * dist;
      for (int i = 0; i < 3; ++i) cpos[i] = end[i] - n[i] * scale;
      dist = dist - m.con_margin[ci];
      const float im = impedance(dist, m.con_imp[ci]);
      for (int row = 0; row < 3; ++row, ++r) {
        const float* fr = m.con_frame[ci][row];
        for (int k = 0; k < nv; ++k) {
          const float sg = m.con_sgn[ci][k];
          if (sg != 0.0f) {
            float jp[3];
            cross3(cdof[k], cpos, tmp);
            for (int i = 0; i < 3; ++i) jp[i] = cdof[k][3 + i] + tmp[i];
            R.J[r][k] = sg * dot3(fr, jp);
          } else {
            R.J[r][k] = 0.0f;
          }
        }
        const float pos = row == 0 ? fminf(dist, 0.0f) : 0.0f;
        R.active[r] = dist < 0.0f;
        imp[r] = im;
        float vel = 0.0f;
        for (int k = 0; k < nv; ++k) vel += R.J[r][k] * qvel[k];
        aref[r] = -im * (m.con_k[ci] * pos + m.con_b[ci] * vel);
      }
    }
    for (int li = 0; li < m.nlim; ++li) {
      const float q = qpos[m.lim_qadr[li]];
      for (int side = 0; side < 2; ++side, ++r) {
        const float posv = side == 0 ? q - m.lim_lo[li] - m.lim_margin[li]
                                     : m.lim_hi[li] - q - m.lim_margin[li];
        const float sgn = side == 0 ? 1.0f : -1.0f;
        for (int k = 0; k < nv; ++k) R.J[r][k] = 0.0f;
        R.J[r][m.lim_vadr[li]] = sgn;
        R.active[r] = posv < 0.0f;
        imp[r] = impedance(posv, m.lim_imp);
        const float vel = sgn * qvel[m.lim_vadr[li]];
        aref[r] = -imp[r] * (m.lim_k[li] * fminf(posv, 0.0f) +
                             m.lim_b[li] * vel);
      }
    }

    // ---- Delassus diagonal (and matrix when dense), free acceleration
    for (int s = 0; s < nrow; ++s) {
      float x[MR_MAX_NV];
      chol_solve(L, R.J[s], x, nv);
      if (m.dense) {
        for (int rr = 0; rr < nrow; ++rr) {
          float a = 0.0f;
          for (int k = 0; k < nv; ++k) a += R.J[rr][k] * x[k];
          R.amat[rr * nrow + s] = a;
        }
        raw_diag[s] = R.amat[s * nrow + s];
      } else {
        float a = 0.0f;
        for (int k = 0; k < nv; ++k) a += R.J[s][k] * x[k];
        raw_diag[s] = a;
      }
    }
    float maxd = raw_diag[0];
    for (int rr = 1; rr < nrow; ++rr) maxd = fmaxf(maxd, raw_diag[rr]);
    float dr[MR_MAX_ROW], diag[MR_MAX_ROW];
    for (int rr = 0; rr < nrow; ++rr) {
      float a = 0.0f;
      for (int k = 0; k < nv; ++k) a += R.J[rr][k] * qacc_smooth[k];
      a0[rr] = a;
      diag[rr] = fmaxf(raw_diag[rr], 1e-10f);
      R.reg[rr] = (1.0f - imp[rr]) / imp[rr] * diag[rr];
      // degenerate rows (A_rr ~ 0 against the largest) are deactivated
      R.active[rr] = R.active[rr] && (raw_diag[rr] > 1e-8f * maxd);
      dr[rr] = diag[rr] + R.reg[rr];
    }

    // ---- Jacobi preconditioning, tangent scales tied inside a point
    for (int ci = 0; ci < m.ncon; ++ci) {
      const float mt = 0.5f * (dr[3 * ci + 1] + dr[3 * ci + 2]);
      dr[3 * ci + 1] = mt;
      dr[3 * ci + 2] = mt;
    }
    for (int rr = 0; rr < nrow; ++rr)
      R.s_pre[rr] = 1.0f / sqrtf(fmaxf(dr[rr], 1e-12f));
    for (int ci = 0; ci < m.ncon; ++ci)
      R.mu_t[ci] = m.con_mu[ci] * R.s_pre[3 * ci] / R.s_pre[3 * ci + 1];

    // ---- initial iterate: cold start, or the previous step's duals
    float g[MR_MAX_ROW], y[MR_MAX_ROW], gn[MR_MAX_ROW], b_vec[MR_MAX_ROW];
    float lam_abs = 0.0f;
    for (int rr = 0; rr < nrow; ++rr) lam_abs += fabsf(lam[rr]);
    const bool cold = lam_abs == 0.0f;
    for (int rr = 0; rr < nrow; ++rr) {
      const float dinv = 1.0f / (diag[rr] + R.reg[rr]);
      g[rr] = (aref[rr] - a0[rr]) * dinv / R.s_pre[rr];
    }
    project(m, R, g);
    if (!cold)
      for (int rr = 0; rr < nrow; ++rr) g[rr] = lam[rr] / R.s_pre[rr];
    project(m, R, g);
    for (int rr = 0; rr < nrow; ++rr) b_vec[rr] = a0[rr] - aref[rr];

    // ---- step size: Gershgorin (dense) or power iteration (matrix-free),
    //      denominators floored at 1
    float step;
    if (m.dense) {
      float mx = 0.0f;
      for (int rr = 0; rr < nrow; ++rr) {
        float s = 0.0f;
        for (int c = 0; c < nrow; ++c)
          s += fabsf(R.amat[rr * nrow + c]) * R.s_pre[c];
        const float rs = R.s_pre[rr] * s + R.s_pre[rr] * R.s_pre[rr] * R.reg[rr];
        mx = fmaxf(mx, R.active[rr] ? rs : 0.0f);
      }
      step = 1.0f / fmaxf(mx, 1.0f);
    } else {
      float v[MR_MAX_ROW], w[MR_MAX_ROW];
      for (int rr = 0; rr < nrow; ++rr) v[rr] = R.active[rr] ? 1.0f : 0.0f;
      for (int it = 0; it < MR_POWER_ITERS; ++it) {
        opmul(m, R, L, v, w);
        float ss = 0.0f;
        for (int rr = 0; rr < nrow; ++rr) ss += w[rr] * w[rr];
        const float nrm = sqrtf(fmaxf(ss, 1e-30f));
        for (int rr = 0; rr < nrow; ++rr) v[rr] = w[rr] / nrm;
      }
      opmul(m, R, L, v, w);
      float lmax = 0.0f;
      for (int rr = 0; rr < nrow; ++rr) lmax += v[rr] * w[rr];
      step = 1.0f / fmaxf(1.25f * lmax, 1.0f);
    }

    // ---- APGD with adaptive restart, in g = f / s coordinates
    for (int rr = 0; rr < nrow; ++rr) y[rr] = g[rr];
    float t = 1.0f;
    for (int it = 0; it < MR_ITERATIONS; ++it) {
      float f[MR_MAX_ROW], af[MR_MAX_ROW];
      for (int rr = 0; rr < nrow; ++rr) f[rr] = R.s_pre[rr] * y[rr];
      amul(m, R, L, f, af);
      for (int rr = 0; rr < nrow; ++rr) {
        const float gr = R.s_pre[rr] * (af[rr] + R.reg[rr] * f[rr] + b_vec[rr]);
        gn[rr] = y[rr] - step * gr;
      }
      project(m, R, gn);
      const float t_new = 0.5f * (1.0f + sqrtf(1.0f + 4.0f * t * t));
      const float beta = (t - 1.0f) / t_new;
      float dot = 0.0f;
      for (int rr = 0; rr < nrow; ++rr) dot += (gn[rr] - g[rr]) * (y[rr] - gn[rr]);
      const bool reverse = dot > 0.0f;
      for (int rr = 0; rr < nrow; ++rr) {
        const float dg = gn[rr] - g[rr];
        y[rr] = reverse ? gn[rr] : gn[rr] + beta * dg;
        g[rr] = gn[rr];
      }
      t = reverse ? 1.0f : t_new;
    }
    for (int rr = 0; rr < nrow; ++rr) lam[rr] = R.s_pre[rr] * g[rr];
    for (int k = 0; k < nv; ++k) {
      float s = 0.0f;
      for (int rr = 0; rr < nrow; ++rr) s += R.J[rr][k] * lam[rr];
      qfrc_c[k] = s;
    }
  }

  // ---- integrate (semi-implicit Euler, implicit damping in the factor)
  float qacc[MR_MAX_NV];
  for (int k = 0; k < nv; ++k) qfrc[k] = qfrc[k] + qfrc_c[k];
  chol_solve(L, qfrc, qacc, nv);
  for (int k = 0; k < nv; ++k) qvel[k] = qvel[k] + h * qacc[k];
  for (int k = 0; k < nv; ++k) qpos[k] = qpos[k] + h * qvel[k];
}

// ---------------------------------------------------------------------------
// task residuals (tasks/*.py::residual) and the cost (cost_value_t)
// ---------------------------------------------------------------------------

// Residuals read pre-step frames, post-step qvel, the step's ctrl and the
// post-step time t0 + (i+1)*dt (megarollout.py::_rollout_body).
// tasks/walker.py::residual; res_int = (torso body, rootx dof); no time
__device__ void residual_walker(const MRModel& m, const float (*xpos)[3],
                                const float (*xmat)[9], const float* qvel,
                                const float* ctrl, float /*time*/,
                                const float* rp, float* res) {
  const int torso = m.res_int[0], vx = m.res_int[1];
  res[0] = xpos[torso][2] - rp[1];
  res[1] = xmat[torso][8] - 1.0f;
  res[2] = qvel[vx] - rp[0];
  for (int i = 0; i < 6; ++i) res[3 + i] = ctrl[i];
}

__device__ float norm_value(int type, const float* x, int n, float p,
                            float q) {
  float s = 0.0f;
  switch (type) {
    case -1:  // NULL
      return x[0];
    case 0:  // QUADRATIC
      for (int i = 0; i < n; ++i) s += x[i] * x[i];
      return 0.5f * s;
    case 1:  // L22
      for (int i = 0; i < n; ++i) s += x[i] * x[i];
      return powf(powf(s, q / 2) + powf(p, q), 1.0f / q) - p;
    case 2:  // L2
      for (int i = 0; i < n; ++i) s += x[i] * x[i];
      return sqrtf(s + p * p) - p;
    case 3:  // COSH
      for (int i = 0; i < n; ++i) s += p * p * (coshf(x[i] / p) - 1.0f);
      return s;
    case 5:  // POWER_LOSS
      for (int i = 0; i < n; ++i) s += powf(fabsf(x[i]), p);
      return s;
    case 6:  // SMOOTH_ABS
      for (int i = 0; i < n; ++i) s += sqrtf(x[i] * x[i] + p * p) - p;
      return s;
    case 7:  // SMOOTH_ABS2
      for (int i = 0; i < n; ++i)
        s += powf(powf(fabsf(x[i]), q) + powf(p, q), 1.0f / q) - p;
      return s;
    case 8: {  // RECTIFY: softplus when p > 0, relu otherwise
      if (p > 0.0f) {
        const float sp = fmaxf(p, 1e-10f);
        for (int i = 0; i < n; ++i) s += sp * log1pf(expf(x[i] / sp));
      } else {
        for (int i = 0; i < n; ++i) s += fmaxf(x[i], 0.0f);
      }
      return s;
    }
  }
  return __int_as_float(0x7fc00000);  // unknown norm: NaN
}

__device__ float cost_value(const MRModel& m, const float* res,
                            const float* weights, const float* norm_params,
                            float risk) {
  float total = 0.0f;
  int shift = 0;
  for (int k = 0; k < m.nterm; ++k) {
    const float v = norm_value(m.term_norm[k], res + shift, m.term_dim[k],
                               norm_params[2 * k], norm_params[2 * k + 1]);
    total += weights[k] * v;
    shift += m.term_dim[k];
  }
  const bool small = fabsf(risk) < 1e-6f;
  const float risky = (expf(risk * total) - 1.0f) / (small ? 1.0f : risk);
  return small ? total : risky;
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

__device__ void load_model(const MRModel* __restrict__ src, MRModel* dst) {
  const int* s = reinterpret_cast<const int*>(src);
  int* d = reinterpret_cast<int*>(dst);
  for (int i = threadIdx.x; i < (int)(sizeof(MRModel) / 4); i += blockDim.x)
    d[i] = s[i];
  __syncthreads();
}

__global__ void __launch_bounds__(64) mr_returns_kernel(
    const MRModel* __restrict__ model, const float* __restrict__ qpos0,
    const float* __restrict__ qvel0, const float* __restrict__ actions,
    const float* __restrict__ weights, const float* __restrict__ norm_params,
    const float* __restrict__ risk, const float* __restrict__ res_params,
    const float* __restrict__ t0, float* __restrict__ out, int n,
    int horizon) {
  __shared__ MRModel sm;
  load_model(model, &sm);
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;  // ragged edge
  const MRModel& m = sm;
  float qpos[MR_MAX_NV], qvel[MR_MAX_NV], lam[MR_MAX_ROW];
  float xpos[MR_MAX_BODY][3], xmat[MR_MAX_BODY][9], res[MR_MAX_RES];
  for (int k = 0; k < m.nv; ++k) { qpos[k] = qpos0[k]; qvel[k] = qvel0[k]; }
  for (int r = 0; r < MR_MAX_ROW; ++r) lam[r] = 0.0f;  // first step is cold
  const float rk = *risk, time0 = *t0;
  float total = 0.0f;
  for (int i = 0; i < horizon; ++i) {
    const float* u = actions + ((size_t)c * horizon + i) * m.nu;
    tile_step(m, qpos, qvel, u, lam, xpos, xmat);
    const float time = time0 + (float)(i + 1) * m.timestep;
    if (m.res_id == MR_RES_WALKER)
      residual_walker(m, xpos, xmat, qvel, u, time, res_params, res);
    total += cost_value(m, res, weights, norm_params, rk);
  }
  total = total / horizon;
  out[c] = isfinite(total) ? total : MR_MAX_RETURN;
}

__global__ void __launch_bounds__(64) mr_step_kernel(
    const MRModel* __restrict__ model, const float* __restrict__ qpos_in,
    const float* __restrict__ qvel_in, const float* __restrict__ ctrl,
    const float* __restrict__ lam_in, float* __restrict__ qpos_out,
    float* __restrict__ qvel_out, float* __restrict__ lam_out, int b) {
  __shared__ MRModel sm;
  load_model(model, &sm);
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= b) return;
  const MRModel& m = sm;
  float qpos[MR_MAX_NV], qvel[MR_MAX_NV], lam[MR_MAX_ROW];
  float xpos[MR_MAX_BODY][3], xmat[MR_MAX_BODY][9];
  for (int k = 0; k < m.nv; ++k) {
    qpos[k] = qpos_in[c * m.nq + k];
    qvel[k] = qvel_in[c * m.nv + k];
  }
  for (int r = 0; r < m.nrow; ++r) lam[r] = lam_in[c * m.nrow + r];
  tile_step(m, qpos, qvel, ctrl + c * m.nu, lam, xpos, xmat);
  for (int k = 0; k < m.nv; ++k) {
    qpos_out[c * m.nq + k] = qpos[k];
    qvel_out[c * m.nv + k] = qvel[k];
  }
  for (int r = 0; r < m.nrow; ++r) lam_out[c * m.nrow + r] = lam[r];
}

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes): pointers are device pointers, the
// stream is PyTorch's current stream; each entry returns cudaGetLastError()
// ---------------------------------------------------------------------------

extern "C" int mr_model_layout(long long* offsets, int capacity) {
  int i = 0;
#define MR_OFFSET(type, name, dims) \
  if (i < capacity) offsets[i] = (long long)offsetof(MRModel, name); ++i;
  MR_MODEL_FIELDS(MR_OFFSET)
#undef MR_OFFSET
  return i;
}

extern "C" long long mr_model_size() { return (long long)sizeof(MRModel); }

extern "C" int mr_returns(const void* model, const void* qpos0,
                          const void* qvel0, const void* actions,
                          const void* weights, const void* norm_params,
                          const void* risk, const void* res_params,
                          const void* t0, void* out, int n, int horizon,
                          void* stream) {
  if (n > 0) {
    mr_returns_kernel<<<(n + 63) / 64, 64, 0, (cudaStream_t)stream>>>(
        (const MRModel*)model, (const float*)qpos0, (const float*)qvel0,
        (const float*)actions, (const float*)weights,
        (const float*)norm_params, (const float*)risk,
        (const float*)res_params, (const float*)t0, (float*)out, n,
        horizon);
  }
  return (int)cudaGetLastError();
}

extern "C" int mr_step(const void* model, const void* qpos,
                       const void* qvel, const void* ctrl, const void* lam,
                       void* qpos_out, void* qvel_out, void* lam_out, int b,
                       void* stream) {
  if (b > 0) {
    mr_step_kernel<<<(b + 63) / 64, 64, 0, (cudaStream_t)stream>>>(
        (const MRModel*)model, (const float*)qpos, (const float*)qvel,
        (const float*)ctrl, (const float*)lam, (float*)qpos_out,
        (float*)qvel_out, (float*)lam_out, b);
  }
  return (int)cudaGetLastError();
}
