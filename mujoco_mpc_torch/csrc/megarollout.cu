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
// Design: one warp per candidate. The 32 lanes of a warp run one
// candidate's whole T-step rollout together; a block holds W warps, W
// chosen at launch (mr_geometry): 2 where the model copy and two
// candidates' working sets fit the block's shared memory and the launch
// has at least two candidates per SM, else 1, so 256 candidates cover 128
// of the 132 SMs. Each candidate's working set lives in its warp's slice
// of the block's dynamic shared memory, carved at launch from the model's
// own sizes (carve): qpos, qvel and the duals, the frames the residual
// reads (StepOut), the tree recursions' per-body arrays, the constraint
// Jacobian J (nrow x nv), the Cholesky factor (nv x nv), the dense
// Delassus matrix where nrow <= 32, the row vectors of the solve. The
// model (MRModelT, a POD struct packed once per MegaRollout) is copied
// once per block into the same shared memory: read in place from global
// memory through the read-only path instead, it let more blocks reside
// per SM but ran a few per cent slower at Walker, Humanoid and Allegro
// (PERF.md), where the launches fit in one wave either way.
// __launch_bounds__(64, 8) caps a thread at 128 registers: the float
// instances fit without spilling, and a higher cap ran no faster. The
// maxima that size the model's per-point fields come from a size tier
// (MRSmall, MRLarge), a template parameter: the ops wrapper picks the
// smallest tier that holds the model.
//
// The lanes take the work that is independent across rows, contact
// points, dofs, joints or bodies:
//   - over points and rows: the narrowphase and each point's, limit's and
//     equality's rows (J, aref, impedance); the Delassus diagonal, each
//     lane solving its own rows with the serial chol_solve; a0, the
//     regularizer and the preconditioner; project per contact point; the
//     APGD updates; J x;
//   - over dofs: J^T v, qfrc_c = J^T lambda, the mass matrix's columns,
//     cdof_dot, the bias and passive forces, the velocity update;
//   - over bodies and joints: the frames, cdof, cvel, the spatial and
//     composite inertias, the RNE forces, the position update;
//   - the Cholesky factorization and the forward substitution go column
//     by column, each pivot broadcast from its lane by a shuffle; the back
//     substitution runs on lane 0 in the serial order (chol_solve_lanes);
//   - the tree recursions (forward kinematics, the composite-inertia and
//     RNE accumulations), the tendon and actuator forces, the residual and
//     the cost stay on lane 0, each followed by a __syncwarp().
// Summation order: an output one lane computes sums in the serial order
// (over nv for J x, over rows for J^T v, over columns for the factor).
// Only true scalar reductions cross lanes (lane_sum: the APGD restart dot
// product, the power iteration's norm and Rayleigh quotient, and the sum
// of |lambda|, which only meets a test against 0; lane_max, exact: the
// largest Delassus diagonal and the dense step size's row bound).
// Every warp primitive goes through lane_id, lane_sync, lane_bcast,
// lane_sum and lane_max, and the lane count L is a template parameter:
// the card's instances use 32 (MR_LANES); the host build of
// tests/test_torch_kernel_host.py instantiates 1, where the helpers are
// identities, and 4, whose lanes are threads.
//
// Precision: everything is a template on the scalar type T. The planner
// runs T = float. T = double (the libraries built with -DMR_DOUBLE=1) is
// there to hold the code against the plain version run in float64: long
// humanoid rollouts amplify float rounding until two float orderings
// disagree on some candidates, while two double orderings still agree to
// far below any tolerance, so each candidate can be checked at the
// planner's full shape. The model's constants are float values in both
// precisions (the plain version rounds them to float32 in every dtype);
// literals that a float cannot hold exactly are written T(...), as the
// plain version's Python constants are rounded to its dtype.
//
// The model class, the whole of the TPU kernel's: hinge, slide, ball and
// free joints (a quaternion joint's quaternion normalized in forward
// kinematics and after the exact exponential-map integration; a ball
// joint's rotations about its anchor), actuators on scalar joints or fixed
// tendons, joint springs, friction loss, fixed tendons with limits, springs
// and dampers, mocap bodies (their poses are rollout-constant operands,
// like the task's userdata; each block keeps them in shared memory),
// contacts of a world plane against sphere and capsule ends and box
// corners, of sphere against sphere, capsule and box, of capsule against
// capsule,
// of capsule ends against a box and (large tier) of box against box, with
// condim 1, 3, 4 or 6 (a torsional row per condim>=4 point, two rolling
// rows per condim-6 point), joint limits, joint, connect and weld equality
// rows (bilateral), and the dense or matrix-free solve. Task residuals (and
// a task's state-dependent cost weights) are __device__ functions selected
// by MRModelT::res_id; they read the step's pre-step frames, site frames
// and contact distances and normals (StepOut).
//
// What bounds it on this card: latency, not bytes or FLOPs. A step is a
// long chain of dependent arithmetic per candidate (Walker ~90 k
// operations, Humanoid ~600 k). The lanes take its independent work,
// every operand of the chain is a shared-memory load, and one warp per
// candidate puts 256 candidates on 128 SMs. What stays serial is the tree
// recursions and the solves' chains (nv pivots each): the 21 Delassus
// products of the step size and APGD, two triangular solves each, take
// about two thirds of a step's cycles and the Delassus diagonal a tenth
// to a sixth (chip_smoke.py phase P).
//
// Not built with --use_fast_math: it could fold away the isfinite guard and
// changes expf/sqrtf/log1pf against the plain version.

#include <cfloat>
#include <cstddef>
#include <mutex>
#include <cuda_runtime.h>

// Maxima, sized for the dm_control humanoid (nq 28, nv 27, nbody 17,
// njnt 22, nu 21, 21 limited joints, 2 limited tendons), the quadruped (28
// residual constants, 5 residual sites, one mocap body, 24 userdata), the
// Shadow hand (nq 31, nv 30, nbody 20, njnt 25, 4 tendons driven by
// actuators, 24 limited joints, 77 residual entries) and the bimanual
// handover (2 joint equalities, 9 residual indices); the contact points and
// constraint rows are the size tier's (MRSmall, MRLarge below)
#define MR_MAX_NQ 32
#define MR_MAX_NV 30
#define MR_MAX_BODY 20    // <= 32: residuals take body sets as bitmasks
#define MR_MAX_JNT 25
#define MR_MAX_NU 24
#define MR_MAX_LIM 24     // limited joints (two rows each)
#define MR_MAX_TEN 4      // fixed tendons (limited ones: two rows each)
#define MR_MAX_WRAP 4     // joints a fixed tendon wraps
#define MR_MAX_TERM 16
#define MR_MAX_RES 80     // residual entries
#define MR_MAX_RES_INT 12
#define MR_MAX_RES_FLOAT 32
#define MR_MAX_SITE 8     // world points a residual reads
#define MR_MAX_MOCAP 4
#define MR_MAX_USERDATA 32
#define MR_MAX_EQ 4       // equality constraints (a weld has 6 rows)

// Size tiers: the kernel is a template on one of these, which sizes the
// model struct's per-point fields (CON contact points) and bounds the rows
// (ROW) a model may have; a candidate's arrays in shared memory are sized
// from the model itself (carve). The small tier holds every model without
// a box pair, the handover's 130 rows the most, and compiles no box-box
// code; the large tier holds the box-box group: Allegro (40
// points, 144 rows), OP3 (45, 159), Pick (40, 179), PickAndPlace (64, 206),
// Humanoid Interact (71, 219) and Bimanual Reorient (72, 250). A library
// is built per tier and precision (-DMR_TIER, -DMR_DOUBLE, below).
// BBCON sizes the box-box pair's own per-point fields: 1 where the tier
// has no box-box code.
struct MRSmall {
  static constexpr int ROW = 130, CON = 40, BBCON = 1;
  static constexpr bool BOXBOX = false;
};
struct MRLarge {
  static constexpr int ROW = 250, CON = 72, BBCON = 72;
  static constexpr bool BOXBOX = true;
};

#define MR_ITERATIONS 12
#define MR_POWER_ITERS 8
#define MR_COINCIDE 64.0 // tilestep.COINCIDE
#define MR_MAX_RETURN 1e6f

#define MR_FREE 0
#define MR_BALL 1
#define MR_SLIDE 2
#define MR_HINGE 3

#define MR_CON_PLANE 0      // world plane vs sphere / capsule end
#define MR_CON_CAPCAP 1     // capsule vs capsule
#define MR_CON_BOXCORNER 2  // world plane vs a box corner
#define MR_CON_SPHERE 3     // sphere vs sphere
#define MR_CON_SPHEREBOX 4  // sphere vs box
#define MR_CON_CAPBOX 5     // capsule end vs box
#define MR_CON_BOXBOX 6     // a box's corner vs the other box's slab
#define MR_CON_SPHERECAP 7  // sphere vs capsule

#define MR_RES_WALKER 1
#define MR_RES_HUMANOID 2
#define MR_RES_QUADRUPED 3
#define MR_RES_REORIENT 4   // Shadow and Allegro
#define MR_RES_STATE 5      // (qpos, qvel): the small class models' residual
#define MR_RES_HANDOVER 6
#define MR_RES_CARTPOLE 7
#define MR_RES_ACROBOT 8
#define MR_RES_PARTICLE 9   // Particle and ParticleFixed
#define MR_RES_FINGERS 10
#define MR_RES_ARM_REACH 11
#define MR_RES_PUSH 12
#define MR_RES_RUBIK_FACES 13
#define MR_RES_OP3 14
#define MR_RES_PICK 15
#define MR_RES_PICK_AND_PLACE 16
#define MR_RES_BIMANUAL_REORIENT 17
#define MR_RES_HUMANOID_INTERACT 18
#define MR_MODE_SLOT 15  // tasks/base.py MODE_SLOT: the requested mode

#define MR_EQ_CONNECT 0
#define MR_EQ_WELD 1
#define MR_EQ_JOINT 2

// Phase counters, compiled in only with -DMR_PROFILE=1 (a profiling build):
// clock64() cycles per phase of a step on each candidate's lane 0, summed
// over every candidate and step into mr_phase_cycles and read back through
// mr_profile(). The phases, in order (ops/megarollout.py PHASES): forward
// kinematics, CRB and the mass matrix, Cholesky, RNE and the smooth
// forces, the narrowphase and the constraint rows, the Delassus diagonal,
// the step size, APGD, integration, the residual and the cost.
#define MR_NPHASE 10
#if defined(MR_PROFILE) && MR_PROFILE
__device__ unsigned long long mr_phase_cycles[MR_NPHASE];
struct MRProf {
  unsigned long long cyc[MR_NPHASE];
  long long t;
  __device__ void start() {
    for (int p = 0; p < MR_NPHASE; ++p) cyc[p] = 0;
    t = clock64();
  }
  __device__ void mark(int p) {
    const long long now = clock64();
    cyc[p] += (unsigned long long)(now - t);
    t = now;
  }
  __device__ void flush() {
    for (int p = 0; p < MR_NPHASE; ++p) atomicAdd(&mr_phase_cycles[p], cyc[p]);
  }
};
#else
struct MRProf {
  __device__ void start() {}
  __device__ void mark(int) {}
  __device__ void flush() {}
};
#endif

// Fields are int or T. The wrapper (ops/megarollout.py::_model_struct)
// mirrors every instantiation with ctypes, which pads as C does, and
// checks each against its library's mr_model_layout().
#define MR_MODEL_FIELDS(X)                                                   \
  X(int, nq, )                                                               \
  X(int, nv, )                                                               \
  X(int, nu, )                                                               \
  X(int, nbody, )                                                            \
  X(int, njnt, )                                                             \
  X(int, ncon, )                                                             \
  X(int, nfric, )                                                            \
  X(int, ntor, )                                                             \
  X(int, nroll, )                                                            \
  X(int, neq, )                                                              \
  X(int, neqrow, )                                                           \
  X(int, nlim, )                                                             \
  X(int, nten, )                                                             \
  X(int, ntenlim, )                                                          \
  X(int, nrow, )                                                             \
  X(int, dense, )                                                            \
  X(int, nterm, )                                                            \
  X(int, nres, )                                                             \
  X(int, res_id, )                                                           \
  X(int, nmocap, )                                                           \
  X(int, nuserdata, )                                                        \
  X(int, nsite, )                                                            \
  X(int, res_int, [MR_MAX_RES_INT])                                          \
  X(T, res_float, [MR_MAX_RES_FLOAT])                                        \
  X(int, site_body, [MR_MAX_SITE])                                           \
  X(T, site_pos, [MR_MAX_SITE][3])                                           \
  X(T, site_quat, [MR_MAX_SITE][4])                                          \
  X(T, timestep, )                                                           \
  X(T, gravity, [3])                                                         \
  X(int, body_parentid, [MR_MAX_BODY])                                       \
  X(int, body_jntadr, [MR_MAX_BODY])                                         \
  X(int, body_jntnum, [MR_MAX_BODY])                                         \
  X(int, body_mocapid, [MR_MAX_BODY])                                        \
  X(T, body_pos, [MR_MAX_BODY][3])                                           \
  X(T, body_quat, [MR_MAX_BODY][4])                                          \
  X(T, body_ipos, [MR_MAX_BODY][3])                                          \
  X(T, body_iquat, [MR_MAX_BODY][4])                                         \
  X(T, body_mass, [MR_MAX_BODY])                                             \
  X(T, body_inertia, [MR_MAX_BODY][3])                                       \
  X(int, jnt_type, [MR_MAX_JNT])                                             \
  X(int, jnt_qposadr, [MR_MAX_JNT])                                          \
  X(int, jnt_dofadr, [MR_MAX_JNT])                                           \
  X(int, jnt_bodyid, [MR_MAX_JNT])                                           \
  X(T, jnt_pos, [MR_MAX_JNT][3])                                             \
  X(T, jnt_axis, [MR_MAX_JNT][3])                                            \
  X(T, jnt_stiffness, [MR_MAX_JNT])                                          \
  X(T, qpos0, [MR_MAX_NQ])                                                   \
  X(T, qpos_spring, [MR_MAX_NQ])                                             \
  X(T, dof_damping, [MR_MAX_NV])                                             \
  X(T, dof_armature, [MR_MAX_NV])                                            \
  X(T, dof_frictionloss, [MR_MAX_NV])                                        \
  X(int, dof_body, [MR_MAX_NV])                                              \
  X(int, dof_body_mask, [MR_MAX_NV][MR_MAX_BODY])                            \
  X(int, dof_ancestor_mask, [MR_MAX_NV][MR_MAX_NV])                          \
  X(int, cdofdot_vel_mask, [MR_MAX_NV][MR_MAX_NV])                           \
  X(int, act_vadr, [MR_MAX_NU])                                              \
  X(int, act_qadr, [MR_MAX_NU])                                              \
  X(int, act_tendon, [MR_MAX_NU])                                            \
  X(int, act_gain_fixed, [MR_MAX_NU])                                        \
  X(int, act_bias_fixed, [MR_MAX_NU])                                        \
  X(int, ctrl_limited, [MR_MAX_NU])                                          \
  X(int, force_limited, [MR_MAX_NU])                                         \
  X(T, act_gear, [MR_MAX_NU])                                                \
  X(T, act_gainprm, [MR_MAX_NU][3])                                          \
  X(T, act_biasprm, [MR_MAX_NU][3])                                          \
  X(T, ctrl_lo, [MR_MAX_NU])                                                 \
  X(T, ctrl_hi, [MR_MAX_NU])                                                 \
  X(T, force_lo, [MR_MAX_NU])                                                \
  X(T, force_hi, [MR_MAX_NU])                                                \
  X(int, con_kind, [S::CON])                                                 \
  X(int, con_gbody, [S::CON][2])                                             \
  X(T, con_gpos, [S::CON][2][3])                                             \
  X(T, con_gquat, [S::CON][2][4])                                            \
  X(T, con_half, [S::CON][2])                                                \
  X(T, con_r, [S::CON][2])                                                   \
  X(T, con_end, [S::CON])                                                    \
  X(T, con_margin, [S::CON])                                                 \
  X(T, con_mu, [S::CON])                                                     \
  X(int, con_tor, [S::CON])                                                  \
  X(T, con_mu_tor, [S::CON])                                                 \
  X(int, con_roll, [S::CON])                                                 \
  X(T, con_mu_roll, [S::CON])                                                \
  X(int, con_id, [S::CON])                                                   \
  X(T, con_frame, [S::CON][3][3])                                            \
  X(T, con_ppos, [S::CON][3])                                                \
  X(T, con_box, [S::CON][3])                                                 \
  X(int, con_owner, [S::BBCON])                                              \
  X(T, con_size, [S::BBCON][2][3])                                           \
  X(T, con_guard, [S::BBCON][2])                                             \
  X(T, con_sgn, [S::CON][MR_MAX_NV])                                         \
  X(T, con_imp, [S::CON][5])                                                 \
  X(T, con_k, [S::CON])                                                      \
  X(T, con_b, [S::CON])                                                      \
  X(int, lim_qadr, [MR_MAX_LIM])                                             \
  X(int, lim_vadr, [MR_MAX_LIM])                                             \
  X(T, lim_lo, [MR_MAX_LIM])                                                 \
  X(T, lim_hi, [MR_MAX_LIM])                                                 \
  X(T, lim_margin, [MR_MAX_LIM])                                             \
  X(T, lim_k, [MR_MAX_LIM])                                                  \
  X(T, lim_b, [MR_MAX_LIM])                                                  \
  X(T, lim_imp, [5])                                                         \
  X(int, ten_nwrap, [MR_MAX_TEN])                                            \
  X(int, ten_qadr, [MR_MAX_TEN][MR_MAX_WRAP])                                \
  X(int, ten_vadr, [MR_MAX_TEN][MR_MAX_WRAP])                                \
  X(T, ten_coef, [MR_MAX_TEN][MR_MAX_WRAP])                                  \
  X(T, ten_stiffness, [MR_MAX_TEN])                                          \
  X(T, ten_damping, [MR_MAX_TEN])                                            \
  X(T, ten_lengthspring, [MR_MAX_TEN][2])                                    \
  X(int, ten_lim_id, [MR_MAX_TEN])                                           \
  X(T, ten_lo, [MR_MAX_TEN])                                                 \
  X(T, ten_hi, [MR_MAX_TEN])                                                 \
  X(T, ten_margin, [MR_MAX_TEN])                                             \
  X(T, ten_k, [MR_MAX_TEN])                                                  \
  X(T, ten_b, [MR_MAX_TEN])                                                  \
  X(int, eq_kind, [MR_MAX_EQ])                                               \
  X(int, eq_ob1, [MR_MAX_EQ])                                                \
  X(int, eq_ob2, [MR_MAX_EQ])                                                \
  X(T, eq_data, [MR_MAX_EQ][11])                                             \
  X(T, eq_k, [MR_MAX_EQ])                                                    \
  X(T, eq_b, [MR_MAX_EQ])                                                    \
  X(T, eq_imp, [MR_MAX_EQ][5])                                               \
  X(T, eq_da, [MR_MAX_EQ][6])                                                \
  X(int, term_dim, [MR_MAX_TERM])                                            \
  X(int, term_norm, [MR_MAX_TERM])

template <class T, class S>
struct MRModelT {
#define MR_DECLARE(type, name, dims) type name dims;
  MR_MODEL_FIELDS(MR_DECLARE)
#undef MR_DECLARE
};

// ---------------------------------------------------------------------------
// scalar math in both precisions (the float functions for T = float)
// ---------------------------------------------------------------------------

template <class T> struct Same { typedef T type; };

#define MR_UNARY(name, f32, f64)                                             \
  __device__ __forceinline__ float name(float x) { return f32(x); }          \
  __device__ __forceinline__ double name(double x) { return f64(x); }
MR_UNARY(r_sqrt, sqrtf, sqrt)
MR_UNARY(r_abs, fabsf, fabs)
MR_UNARY(r_sin, sinf, sin)
MR_UNARY(r_cos, cosf, cos)
MR_UNARY(r_exp, expf, exp)
MR_UNARY(r_log1p, log1pf, log1p)
MR_UNARY(r_log10, log10f, log10)
MR_UNARY(r_tanh, tanhf, tanh)
MR_UNARY(r_cosh, coshf, cosh)
#undef MR_UNARY

// two-argument functions take their type from the first argument
#define MR_BINARY(name, f32, f64)                                            \
  __device__ __forceinline__ float name##_(float a, float b) {               \
    return f32(a, b);                                                        \
  }                                                                          \
  __device__ __forceinline__ double name##_(double a, double b) {            \
    return f64(a, b);                                                        \
  }                                                                          \
  template <class T>                                                         \
  __device__ __forceinline__ T name(T a, typename Same<T>::type b) {         \
    return name##_(a, b);                                                    \
  }
MR_BINARY(r_max, fmaxf, fmax)
MR_BINARY(r_min, fminf, fmin)
MR_BINARY(r_pow, powf, pow)
MR_BINARY(r_fmod, fmodf, fmod)
#undef MR_BINARY

// ---------------------------------------------------------------------------
// small vector math (row-major 3x3 matrices, quaternions w, x, y, z)
// ---------------------------------------------------------------------------

template <class T>
__device__ __forceinline__ void quat_mul(const T* a, const T* b,
                                         T* o) {
  T w = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  T x = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  T y = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  T z = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
  o[0] = w; o[1] = x; o[2] = y; o[3] = z;
}

template <class T>
__device__ __forceinline__ void cross3(const T* a, const T* b,
                                       T* o) {
  T x = a[1] * b[2] - a[2] * b[1];
  T y = a[2] * b[0] - a[0] * b[2];
  T z = a[0] * b[1] - a[1] * b[0];
  o[0] = x; o[1] = y; o[2] = z;
}

template <class T>
__device__ __forceinline__ T dot3(const T* a, const T* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

template <class T>
__device__ __forceinline__ void quat_rot(const T* q, const T* v,
                                         T* o) {
  T uv[3], uuv[3];
  cross3(q + 1, v, uv);
  cross3(q + 1, uv, uuv);
  for (int k = 0; k < 3; ++k) o[k] = v[k] + 2.0f * (q[0] * uv[k] + uuv[k]);
}

template <class T>
__device__ __forceinline__ void quat_to_mat(const T* q, T* m) {
  T w = q[0], x = q[1], y = q[2], z = q[3];
  m[0] = 1 - 2 * (y * y + z * z); m[1] = 2 * (x * y - w * z);
  m[2] = 2 * (x * z + w * y);
  m[3] = 2 * (x * y + w * z); m[4] = 1 - 2 * (x * x + z * z);
  m[5] = 2 * (y * z - w * x);
  m[6] = 2 * (x * z - w * y); m[7] = 2 * (y * z + w * x);
  m[8] = 1 - 2 * (x * x + y * y);
}

// spatial inertia about the world origin times motion [va; vl]
template <class T>
__device__ __forceinline__ void inert_mul(const T* Iw, const T* com,
                                          T mass, const T* va,
                                          const T* vl, T* fa,
                                          T* fl) {
  T t1[3], t2[3], t3[3];
  cross3(com, va, t1);
  cross3(com, t1, t2);
  cross3(com, vl, t3);
  for (int i = 0; i < 3; ++i) {
    T s = 0.0f;
    for (int k = 0; k < 3; ++k) s += Iw[3 * i + k] * va[k];
    fa[i] = s - mass * t2[i] + mass * t3[i];
    fl[i] = -mass * t1[i] + mass * vl[i];
  }
}

template <class T>
__device__ __forceinline__ void quat_normalize(T* q) {
  const T inv = 1.0f / r_sqrt(r_max(
      q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3], T(1e-24)));
  for (int i = 0; i < 4; ++i) q[i] *= inv;
}

// q advanced by the exact exponential of the body-frame angular velocity w
// over dt, NaN-free at w = 0, then normalized (tilestep._quat_integrate)
template <class T>
__device__ __forceinline__ void quat_integrate(T* q, const T* w,
                                               T dt) {
  const T sq = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = sq < T(1e-24);
  const T theta = r_sqrt(small ? 1.0f : sq);
  const T inv = 1.0f / theta;
  const T half = 0.5f * theta * dt;
  const T s = r_sin(half) * inv;
  const T dq[4] = {small ? 1.0f : r_cos(half), small ? 0.0f : w[0] * s,
                       small ? 0.0f : w[1] * s, small ? 0.0f : w[2] * s};
  T o[4];
  quat_mul(q, dq, o);
  quat_normalize(o);
  for (int i = 0; i < 4; ++i) q[i] = o[i];
}

// contact frame rows (n, t1, t2) from a unit normal
// (collision._frame_from_normal)
template <class T>
__device__ __forceinline__ void frame_from_normal(const T* n,
                                                  T (*fr)[3]) {
  const bool use_x = r_abs(n[0]) < 0.5f;
  const T ref[3] = {use_x ? 1.0f : 0.0f, use_x ? 0.0f : 1.0f, 0.0f};
  T t1[3];
  cross3(n, ref, t1);
  const T nrm = r_sqrt(r_max(dot3(t1, t1), T(1e-24)));
  for (int i = 0; i < 3; ++i) { fr[0][i] = n[i]; fr[1][i] = t1[i] / nrm; }
  cross3(n, fr[1], fr[2]);
}

template <class T>
__device__ __forceinline__ T impedance(T pos, const T* c) {
  // c = d0, d1, width, mid, power (already clamped on the host)
  T x = r_min(r_max(r_abs(pos) / c[2], 0.0f), 1.0f);
  T mid = c[3], power = c[4];
  T y = x < mid ? r_pow(x / mid, power) * mid
                    : 1.0f - r_pow((1 - x) / (1 - mid), power) * (1 - mid);
  return r_min(r_max(c[0] + y * (c[1] - c[0]), T(1e-4)), T(0.9999));
}

// ---------------------------------------------------------------------------
// lanes: the L lanes of a warp share one candidate. Every warp primitive
// goes through these helpers; with L = 1 they are identities.
// ---------------------------------------------------------------------------

#ifndef MR_LANES
#define MR_LANES 32  // the card's instances
#endif
#define MR_FULL_MASK 0xffffffffu

template <int L>
__device__ __forceinline__ int lane_id() {
  return L == 1 ? 0 : (int)(threadIdx.x % L);
}

template <int L>
__device__ __forceinline__ void lane_sync() {
  if constexpr (L > 1) __syncwarp();
}

// x as lane src holds it, on every lane
template <int L, class V>
__device__ __forceinline__ V lane_bcast(V x, int src) {
  if constexpr (L == 1) return x;
  else return __shfl_sync(MR_FULL_MASK, x, src, L);
}

// the sum of x over the lanes, the same on every lane (an xor butterfly:
// the two lanes of a pair add the same two values)
template <int L, class V>
__device__ __forceinline__ V lane_sum(V x) {
  if constexpr (L > 1)
    for (int o = L / 2; o > 0; o >>= 1)
      x += __shfl_xor_sync(MR_FULL_MASK, x, o, L);
  return x;
}

// the largest x over the lanes (fmax: a NaN is ignored, as in a serial
// r_max fold)
template <int L, class V>
__device__ __forceinline__ V lane_max(V x) {
  if constexpr (L > 1)
    for (int o = L / 2; o > 0; o >>= 1)
      x = r_max(x, __shfl_xor_sync(MR_FULL_MASK, x, o, L));
  return x;
}

// a quiet NaN of T: the identity of an fmax fold
template <class T>
__device__ __forceinline__ T mr_nan() {
  if constexpr (sizeof(T) == 4) return __int_as_float(0x7fc00000);
  else return __longlong_as_double(0x7ff8000000000000ll);
}

// L L^T x = b with L lower-triangular (row stride ldl), on one lane
template <class T>
__device__ __forceinline__ void chol_solve(const T* l, int ldl, const T* b,
                                           T* x, int n) {
  T y[MR_MAX_NV];
  for (int i = 0; i < n; ++i) {
    T acc = b[i];
    for (int k = 0; k < i; ++k) acc -= l[i * ldl + k] * y[k];
    y[i] = acc / l[i * ldl + i];
  }
  for (int i = n - 1; i >= 0; --i) {
    T acc = y[i];
    for (int k = i + 1; k < n; ++k) acc -= l[k * ldl + i] * x[k];
    x[i] = acc / l[i * ldl + i];
  }
}

// The same solve by the L lanes. The forward substitution goes column by
// column: the lane of row r (r % L) keeps row r's running sum in a
// register, and each y_i is broadcast from its row's lane; it subtracts
// in chol_solve's order (ascending columns). The back substitution runs on
// lane 0 in chol_solve's order too: done column by column it would
// subtract in descending order, which moved a Walker rollout's return
// 0.34 % from the plain version's (PERF.md, Findings); unrolled into
// registers on every lane it was slower. b and x must not alias; the
// caller syncs the lanes before reading x.
template <class T, int L>
__device__ void chol_solve_lanes(const T* __restrict__ l, int ldl,
                                 const T* __restrict__ b, T* __restrict__ x,
                                 int n) {
  constexpr int PER = (MR_MAX_NV + L - 1) / L;  // rows per lane
  const int lane = lane_id<L>();
  T acc[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int r = lane + p * L;
    acc[p] = r < n ? b[r] : T(0);
  }
  for (int i = 0; i < n; ++i) {
    const T yi = lane_bcast<L>(acc[PER == 1 ? 0 : i / L] / l[i * ldl + i],
                               i % L);
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int r = lane + p * L;
      if (r > i && r < n) acc[p] -= l[r * ldl + i] * yi;
      if (r == i) acc[p] = yi;
    }
  }
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int r = lane + p * L;
    if (r < n) x[r] = acc[p];
  }
  lane_sync<L>();
  if (lane == 0)
    for (int i = n - 1; i >= 0; --i) {
      T a = x[i];
#pragma unroll 4
      for (int k = i + 1; k < n; ++k) a -= l[k * ldl + i] * x[k];
      x[i] = a / l[i * ldl + i];
    }
}

// ---------------------------------------------------------------------------
// a candidate's working set, in its warp's slice of shared memory
// ---------------------------------------------------------------------------

// What a residual reads after a step: PRE-step frames (the state the step
// started from), as in tilestep.StepView, and the actuator forces of the
// step's clamped ctrl; views into the candidate's working set
template <class T, class S>
struct StepOut {
  T (*xpos)[3];
  T (*xquat)[4];
  T (*xmat)[9];
  T (*xipos)[3];
  T (*ximat)[9];
  T (*cvel)[6];
  T (*subtree_com)[3];
  T (*site_xpos)[3];
  T (*site_xmat)[9];
  T* act_force;
  // the contact points in the model's order (con_id): dist (the margin
  // taken off) and normal (frame row 0), from the step's narrowphase
  T* con_dist;
  T (*con_normal)[3];
  // the step's converged constraint forces, in row order (the candidate's
  // lam)
  const T* efc;
};

// The views of one candidate's working set, kept at the start of its
// slice (carve). The vectors of the step size and of APGD take the place
// of four that only the rows' set-up reads (aref, raw_diag, a0, imp), and
// APGD's y and gn that of diag and dr.
template <class T, class S>
struct Cand {
  StepOut<T, S> out;
  T *qpos, *qvel, *lam, *res;
  T (*xanchor)[3], (*xaxis)[3], (*cdof)[6], (*cdofdot)[6], (*Iw)[9];
  T (*compTL)[9], (*compMC)[3], *compM;
  T (*cacc)[6], (*cfrc)[6];  // over compTL and compMC, dead by RNE
  T *qfrc, *qact, *qacc_s, *qacc, *qfrc_c, *jtv, *xv, *ten_len, *ten_vel;
  T* L;     // the joint-space inertia, then its Cholesky factor (stride ldl)
  T* J;     // the constraint Jacobian, nrow x nv (stride ldj)
  T* amat;  // the Delassus matrix, nrow x nrow (stride lda; dense only)
  int ldl, ldj, lda;
  int* active;
  T *s_pre, *reg, *g, *y, *gn, *bvec, *mu_t, *mu_tor, *mu_roll, *eq_da;
  T *aref, *raw_diag, *a0, *imp;  // the rows' set-up, then
  T *v, *w, *sv, *av;             // the step size's and APGD's
  T *diag, *dr;                   // (y and gn)
};

template <class E>
__host__ __device__ inline void take(unsigned char* base, size_t& off, E*& p,
                                     long count) {
  p = base ? reinterpret_cast<E*>(base + off) : nullptr;
  off += ((size_t)count * sizeof(E) + 15) & ~(size_t)15;
}

// Lays out a candidate's working set from base (nullptr: only counts),
// every array sized from the model, the views in w; returns its bytes,
// the Cand included. Row strides are odd, so that lanes walking rows of J,
// L or amat hit distinct shared-memory banks.
template <class T, class S>
__host__ __device__ size_t carve(const MRModelT<T, S>& m, unsigned char* base,
                                 Cand<T, S>& w) {
  size_t off = (sizeof(Cand<T, S>) + 15) & ~(size_t)15;
  const int nv = m.nv, nb = m.nbody, nrow = m.nrow;
  w.ldl = nv | 1;
  w.ldj = nv | 1;
  w.lda = m.dense ? (nrow | 1) : 0;
  take(base, off, w.qpos, m.nq);
  take(base, off, w.qvel, nv);
  take(base, off, w.lam, nrow);
  take(base, off, w.res, m.nres);
  StepOut<T, S>& o = w.out;
  o.efc = w.lam;
  take(base, off, o.xpos, nb);
  take(base, off, o.xquat, nb);
  take(base, off, o.xmat, nb);
  take(base, off, o.xipos, nb);
  take(base, off, o.ximat, nb);
  take(base, off, o.cvel, nb);
  take(base, off, o.subtree_com, nb);
  take(base, off, o.site_xpos, m.nsite);
  take(base, off, o.site_xmat, m.nsite);
  take(base, off, o.act_force, m.nu);
  take(base, off, o.con_dist, m.ncon);
  take(base, off, o.con_normal, m.ncon);
  take(base, off, w.xanchor, m.njnt);
  take(base, off, w.xaxis, m.njnt);
  take(base, off, w.cdof, nv);
  take(base, off, w.cdofdot, nv);
  take(base, off, w.Iw, nb);
  T* comp;  // compTL, compMC, compM (13 per body), then cacc, cfrc (12)
  take(base, off, comp, 13 * nb);
  if (base) {
    w.compTL = reinterpret_cast<T (*)[9]>(comp);
    w.compMC = reinterpret_cast<T (*)[3]>(comp + 9 * nb);
    w.compM = comp + 12 * nb;
    w.cacc = reinterpret_cast<T (*)[6]>(comp);
    w.cfrc = reinterpret_cast<T (*)[6]>(comp + 6 * nb);
  }
  take(base, off, w.qfrc, nv);
  take(base, off, w.qact, nv);
  take(base, off, w.qacc_s, nv);
  take(base, off, w.qacc, nv);
  take(base, off, w.qfrc_c, nv);
  take(base, off, w.jtv, nv);
  take(base, off, w.xv, nv);
  take(base, off, w.ten_len, m.nten);
  take(base, off, w.ten_vel, m.nten);
  take(base, off, w.L, nv * w.ldl);
  take(base, off, w.J, nrow * w.ldj);
  take(base, off, w.amat, nrow * w.lda);
  take(base, off, w.active, nrow);
  take(base, off, w.s_pre, nrow);
  take(base, off, w.reg, nrow);
  take(base, off, w.g, nrow);
  take(base, off, w.y, nrow);
  take(base, off, w.gn, nrow);
  take(base, off, w.bvec, nrow);
  take(base, off, w.aref, nrow);
  take(base, off, w.raw_diag, nrow);
  take(base, off, w.a0, nrow);
  take(base, off, w.imp, nrow);
  take(base, off, w.mu_t, m.nfric);
  take(base, off, w.mu_tor, m.ntor);
  take(base, off, w.mu_roll, m.nroll);
  take(base, off, w.eq_da, m.neqrow);
  w.v = w.aref;
  w.w = w.raw_diag;
  w.sv = w.a0;
  w.av = w.imp;
  w.diag = w.y;
  w.dr = w.gn;
  return off;
}

// ---------------------------------------------------------------------------
// constraint solve helpers, by the lanes of one candidate
// ---------------------------------------------------------------------------

// first torsional row: after the condim>=3 points' three rows each and the
// condim-1 points' one
template <class T, class S>
__device__ __forceinline__ int tor_row0(const MRModelT<T, S>& m) {
  return 3 * m.nfric + (m.ncon - m.nfric);
}

// first rolling row: a condim-6 point's rows are roll0 + i (about the first
// tangent) and roll0 + nroll + i (about the second)
template <class T, class S>
__device__ __forceinline__ int roll_row0(const MRModelT<T, S>& m) {
  return tor_row0(m) + m.ntor;
}

// first joint-limit row; the tendon limits follow, then from
// nrow - neqrow the equality rows
template <class T, class S>
__device__ __forceinline__ int lim_row0(const MRModelT<T, S>& m) {
  return roll_row0(m) + 2 * m.nroll;
}

// the rows of an equality of kind k
__device__ __forceinline__ int eq_nrows(int kind) {
  return kind == MR_EQ_JOINT ? 1 : (kind == MR_EQ_CONNECT ? 3 : 6);
}

// out = A v with A = J M^-1 J^T (dense: the materialized matrix); v is
// complete on every lane (the caller synced); returns synced
template <class T, class S, int L>
__device__ void amul(const MRModelT<T, S>& m, const Cand<T, S>& w,
                     const T* v, T* out) {
  const int lane = lane_id<L>();
  const int nrow = m.nrow, nv = m.nv;
  const T* J = w.J;
  const int ldj = w.ldj;
  if (m.dense) {
    for (int r = lane; r < nrow; r += L) {
      T s = 0.0f;
      for (int c = 0; c < nrow; ++c) s += w.amat[r * w.lda + c] * v[c];
      out[r] = s;
    }
    lane_sync<L>();
    return;
  }
  for (int k = lane; k < nv; k += L) {
    T s = 0.0f;
    for (int r = 0; r < nrow; ++r) s += J[r * ldj + k] * v[r];
    w.jtv[k] = s;
  }
  lane_sync<L>();
  chol_solve_lanes<T, L>(w.L, w.ldl, w.jtv, w.xv, nv);
  lane_sync<L>();
  for (int r = lane; r < nrow; r += L) {
    T s = 0.0f;
    for (int k = 0; k < nv; ++k) s += J[r * ldj + k] * w.xv[k];
    out[r] = s;
  }
  lane_sync<L>();
}

// friction cone on the condim>=3 points, an interval on each torsional row
// and a disc on each pair of rolling rows, capped by the point's projected
// normal iterate (not a coupled elliptic cone: the JAX package's
// approximation), the nonnegative orthant on condim-1 normals and joint
// and tendon limits, nothing on the bilateral equality rows, then the
// active mask; a lane per contact point, then a lane per other row
template <class T, class S, int L>
__device__ void project(const MRModelT<T, S>& m, const Cand<T, S>& w, T* g) {
  const int lane = lane_id<L>();
  const int tor0 = tor_row0(m), roll0 = roll_row0(m), lim0 = lim_row0(m);
  const int eq0 = m.nrow - m.neqrow;
  const int* active = w.active;
  for (int ci = lane; ci < m.nfric; ci += L) {
    T* gc = g + 3 * ci;
    T gn = r_max(gc[0], 0.0f);
    T tsq = gc[1] * gc[1] + gc[2] * gc[2];
    T tnorm = tsq < T(1e-24) ? 0.0f : r_sqrt(tsq);
    T cap = w.mu_t[ci] * gn;
    T sc = tnorm > cap ? cap / r_max(tnorm, T(1e-12)) : 1.0f;
    gc[0] = gn;
    gc[1] *= sc;
    gc[2] *= sc;
    for (int i = 0; i < 3; ++i)
      if (!active[3 * ci + i]) gc[i] = 0.0f;
    const int ti = m.con_tor[ci];
    if (ti >= 0) {
      const int r = tor0 + ti;
      const T tcap = w.mu_tor[ti] * gn;
      g[r] = active[r] ? r_min(r_max(g[r], -tcap), tcap) : T(0);
    }
    const int ri = m.con_roll[ci];
    if (ri >= 0) {
      const int ra = roll0 + ri, rb = roll0 + m.nroll + ri;
      const T rsq = g[ra] * g[ra] + g[rb] * g[rb];
      const T rnorm = rsq < T(1e-24) ? 0.0f : r_sqrt(rsq);
      const T rcap = w.mu_roll[ri] * gn;
      const T rs = rnorm > rcap ? rcap / r_max(rnorm, T(1e-12)) : 1.0f;
      g[ra] = active[ra] ? g[ra] * rs : T(0);
      g[rb] = active[rb] ? g[rb] * rs : T(0);
    }
  }
  for (int r = 3 * m.nfric + lane; r < tor0; r += L)
    g[r] = active[r] ? r_max(g[r], 0.0f) : T(0);
  for (int r = lim0 + lane; r < m.nrow; r += L)
    g[r] = active[r] ? (r < eq0 ? r_max(g[r], 0.0f) : g[r]) : T(0);
  lane_sync<L>();
}

template <class T, class S, int L>
__device__ void opmul(const MRModelT<T, S>& m, const Cand<T, S>& w,
                      const T* v, T* out) {
  const int lane = lane_id<L>();
  for (int r = lane; r < m.nrow; r += L)
    w.sv[r] = w.active[r] ? w.s_pre[r] * v[r] : 0.0f;
  lane_sync<L>();
  amul<T, S, L>(m, w, w.sv, w.av);
  for (int r = lane; r < m.nrow; r += L)
    out[r] = w.active[r] ? w.s_pre[r] * (w.av[r] + w.reg[r] * w.sv[r])
                         : 0.0f;
  lane_sync<L>();
}

// ---------------------------------------------------------------------------
// one physics step (physics/tilestep.py::step_tb)
// ---------------------------------------------------------------------------

// world position and rotation matrix of geom side s (0 = g1, 1 = g2) of
// contact point ci
template <class T, class S>
__device__ __forceinline__ void geom_pose(const MRModelT<T, S>& m,
                                          const T (*xpos)[3],
                                          const T (*xquat)[4], int ci,
                                          int s, T* gpos, T* gm) {
  const int bg = m.con_gbody[ci][s];
  T tmp[3], gq[4];
  quat_rot(xquat[bg], m.con_gpos[ci][s], tmp);
  for (int i = 0; i < 3; ++i) gpos[i] = xpos[bg][i] + tmp[i];
  quat_mul(xquat[bg], m.con_gquat[ci][s], gq);
  quat_to_mat(gq, gm);
}

// m v for a row-major 3x3 m, summed in index order
template <class T>
__device__ __forceinline__ void mat_vec(const T* m, const T* v, T* o) {
  for (int i = 0; i < 3; ++i)
    o[i] = m[3 * i] * v[0] + m[3 * i + 1] * v[1] + m[3 * i + 2] * v[2];
}

// m^T v for a row-major 3x3 m, summed in index order
template <class T>
__device__ __forceinline__ void mat_tvec(const T* m, const T* v, T* o) {
  for (int i = 0; i < 3; ++i)
    o[i] = m[i] * v[0] + m[3 + i] * v[1] + m[6 + i] * v[2];
}

// the machine epsilon of T
template <class T>
__device__ __forceinline__ T mr_eps() {
  return sizeof(T) == 4 ? T(FLT_EPSILON) : T(DBL_EPSILON);
}

// sphere (centre c, radius) against a box of half-sizes s at (bp, bm):
// returns dist and writes the contact position and the normal from the
// sphere into the box (collision._sphere_box_point; the argmin of the face
// distances as a first-min select)
template <class T>
__device__ T sphere_box_point(const T* c, T radius, const T* bp,
                              const T* bm, const T* s, T* pos, T* n) {
  T rel[3], local[3], absl[3], fd[3], sgn[3], surf[3], world[3], delta[3];
  for (int i = 0; i < 3; ++i) rel[i] = c[i] - bp[i];
  for (int i = 0; i < 3; ++i)
    local[i] = bm[i] * rel[0] + bm[3 + i] * rel[1] + bm[6 + i] * rel[2];
  bool inside = true;
  for (int i = 0; i < 3; ++i) {
    absl[i] = r_abs(local[i]);
    inside = inside && absl[i] < s[i];
    fd[i] = s[i] - absl[i];
    sgn[i] = local[i] > 0.0f ? T(1) : (local[i] < 0.0f ? T(-1) : T(0));
  }
  const bool is0 = fd[0] <= fd[1] && fd[0] <= fd[2];
  const bool is1 = !is0 && fd[1] <= fd[2];
  const bool is_k[3] = {is0, is1, !(is0 || is1)};
  for (int i = 0; i < 3; ++i)
    surf[i] = inside ? (is_k[i] ? sgn[i] * s[i] : local[i])
                     : r_min(r_max(local[i], -s[i]), s[i]);
  mat_vec(bm, surf, world);
  for (int i = 0; i < 3; ++i) {
    world[i] = bp[i] + world[i];
    delta[i] = c[i] - world[i];
  }
  const T dn = r_sqrt(r_max(dot3(delta, delta), T(0)));
  const T inv = 1.0f / r_max(dn, T(1e-12));
  // a centre within rounding of the mid-plane across the chosen face axis
  // has no side to be pushed out of (tilestep.COINCIDE): no normal
  const T tol = T(MR_COINCIDE) * mr_eps<T>();
  const T tol2 = tol * tol * (1.0f + dot3(c, c));
  T push[3], n_in[3];
  for (int i = 0; i < 3; ++i)
    push[i] = is_k[i] && local[i] * local[i] > tol2 ? -sgn[i] : T(0);
  mat_vec(bm, push, n_in);
  for (int i = 0; i < 3; ++i) n[i] = inside ? n_in[i] : -delta[i] * inv;
  const T dist = inside ? -dn - radius : dn - radius;
  for (int i = 0; i < 3; ++i) pos[i] = world[i] - 0.5f * dist * n[i];
  return dist;
}

// a box's extent along unit axis ax: sum_i |ax . column i of bm| s[i]
template <class T>
__device__ __forceinline__ T box_support(const T* ax, const T* bm,
                                         const T* s) {
  T r[3];
  for (int i = 0; i < 3; ++i) {
    const T col[3] = {bm[i], bm[3 + i], bm[6 + i]};
    r[i] = r_abs(dot3(ax, col)) * s[i];
  }
  return r[0] + r[1] + r[2];
}

// the face-SAT of a box pair at (p1, m1) and (p2, m2), half-sizes s1 and
// s2 (collision._box_box): over the 6 face axes of both boxes the one of
// largest separation, first-max as jnp.argmax ties, signed from box 1 to
// box 2 (jnp.sign: a zero projection gives a zero normal); writes the
// normal and the two boxes' support radii along it
template <class T>
__device__ void boxbox_sat(const T* p1, const T* m1, const T* p2,
                           const T* m2, const T* s1, const T* s2, T* n,
                           T* sup) {
  T t[3], best_ax[3], best_sep = 0.0f, best_proj = 0.0f;
  for (int i = 0; i < 3; ++i) t[i] = p2[i] - p1[i];
  for (int a = 0; a < 6; ++a) {
    const T* bm = a < 3 ? m1 : m2;
    const T ax[3] = {bm[a % 3], bm[3 + a % 3], bm[6 + a % 3]};
    const T r_sum = box_support(ax, m1, s1) + box_support(ax, m2, s2);
    const T proj = dot3(ax, t);
    const T sep = r_abs(proj) - r_sum;
    if (a == 0 || sep > best_sep) {
      for (int i = 0; i < 3; ++i) best_ax[i] = ax[i];
      best_proj = proj;
    }
    best_sep = a == 0 ? sep : r_max(best_sep, sep);
  }
  const T sg = best_proj > 0.0f ? T(1) : (best_proj < 0.0f ? T(-1) : T(0));
  for (int i = 0; i < 3; ++i) n[i] = best_ax[i] * sg;
  sup[0] = box_support(n, m1, s1);
  sup[1] = box_support(n, m2, s2);
}

// boxbox_corner point ci: its owner's corner (con_box, the offset in the
// owner's frame) against the other box's slab along the pair's SAT normal,
// with the lateral-overhang guard (con_guard: big, slack) of
// collision._box_box corner_points; the SAT is recomputed per point.
// Returns dist (margin taken off), writes the frame and the position.
template <class T, class S>
__device__ T boxbox_corner(const MRModelT<T, S>& m, int ci, const T* p1,
                           const T* m1, const T* p2, const T* m2,
                           T (*frame)[3], T* cpos) {
  T n[3], sup[2];
  boxbox_sat(p1, m1, p2, m2, m.con_size[ci][0], m.con_size[ci][1], n, sup);
  // owner 2: box 2's corner against box 1's slab, along +n; owner 1: box
  // 1's corner against box 2's, along -n
  const bool two = m.con_owner[ci] == 2;
  const T* pc = two ? p2 : p1;
  const T* mc = two ? m2 : m1;
  const T* po = two ? p1 : p2;
  const T* mo = two ? m1 : m2;
  const T* so = m.con_size[ci][two ? 0 : 1];
  const T sup_o = two ? sup[0] : sup[1];
  const T sgn = two ? T(1) : T(-1);
  T c[3], rel[3], local[3], n_loc[3], over[3];
  mat_vec(mc, m.con_box[ci], c);
  for (int i = 0; i < 3; ++i) {
    c[i] = pc[i] + c[i];
    rel[i] = c[i] - po[i];
  }
  T dist = sgn * dot3(rel, n) - sup_o;
  mat_tvec(mo, rel, local);
  mat_tvec(mo, n, n_loc);
  const T big = m.con_guard[ci][0], slack = m.con_guard[ci][1];
  for (int i = 0; i < 3; ++i)
    over[i] = r_abs(local[i]) - so[i] - big * r_abs(n_loc[i]);
  dist = r_max(dist, r_max(r_max(over[0], over[1]), over[2]) - slack);
  for (int i = 0; i < 3; ++i) cpos[i] = c[i] - 0.5f * dist * sgn * n[i];
  frame_from_normal(n, frame);
  return dist - m.con_margin[ci];
}

// narrowphase of contact point ci: dist (margin taken off), frame rows
// (n, t1, t2), contact position
template <class T, class S>
__device__ T contact_geometry(const MRModelT<T, S>& m, const T (*xpos)[3],
                              const T (*xquat)[4], int ci,
                              T (*frame)[3], T* cpos) {
  const int kind = m.con_kind[ci];
  T dist;
  if (kind == MR_CON_PLANE || kind == MR_CON_BOXCORNER) {
    T gpos[3], gm[9], end[3], rad;
    geom_pose(m, xpos, xquat, ci, 1, gpos, gm);
    if (kind == MR_CON_BOXCORNER) {  // con_box: the corner's offset
      mat_vec(gm, m.con_box[ci], end);
      for (int i = 0; i < 3; ++i) end[i] = gpos[i] + end[i];
      rad = 0.0f;
    } else {  // a sphere, or a capsule end at con_end along its axis
      for (int i = 0; i < 3; ++i)
        end[i] = gpos[i] + m.con_end[ci] * gm[3 * i + 2];
      rad = m.con_r[ci][1];
    }
    const T* n = m.con_frame[ci][0];
    const T* pp = m.con_ppos[ci];
    dist = (n[0] * (end[0] - pp[0]) + n[1] * (end[1] - pp[1]) +
            n[2] * (end[2] - pp[2])) - rad;
    const T scale = rad + 0.5f * dist;
    for (int i = 0; i < 3; ++i) cpos[i] = end[i] - n[i] * scale;
    for (int r = 0; r < 3; ++r)
      for (int i = 0; i < 3; ++i) frame[r][i] = m.con_frame[ci][r][i];
    return dist - m.con_margin[ci];
  }
  T p1[3], m1[9], p2[3], m2[9], n[3];
  geom_pose(m, xpos, xquat, ci, 0, p1, m1);
  geom_pose(m, xpos, xquat, ci, 1, p2, m2);
  if constexpr (S::BOXBOX) {
    if (kind == MR_CON_BOXBOX)
      return boxbox_corner(m, ci, p1, m1, p2, m2, frame, cpos);
  }
  const T r1 = m.con_r[ci][0], r2 = m.con_r[ci][1];
  if (kind == MR_CON_SPHEREBOX || kind == MR_CON_CAPBOX) {
    // con_box: the box's half-sizes; a capsule end at con_end along g1's
    // axis is the sphere
    if (kind == MR_CON_CAPBOX)
      for (int i = 0; i < 3; ++i) p1[i] = p1[i] + m.con_end[ci] * m1[3 * i + 2];
    dist = sphere_box_point(p1, r1, p2, m2, m.con_box[ci], cpos, n);
    frame_from_normal(n, frame);
    return dist - m.con_margin[ci];
  }
  T c1[3], c2[3], d[3];
  if (kind == MR_CON_SPHERE) {
    for (int i = 0; i < 3; ++i) { c1[i] = p1[i]; c2[i] = p2[i]; }
  } else if (kind == MR_CON_SPHERECAP) {
    // the point of g2's segment nearest the sphere's centre
    T u2[3], w[3];
    for (int i = 0; i < 3; ++i) { u2[i] = m2[3 * i + 2]; w[i] = p1[i] - p2[i]; }
    const T h2 = m.con_half[ci][1];
    const T t2 = r_min(r_max(dot3(w, u2), -h2), h2);
    for (int i = 0; i < 3; ++i) { c1[i] = p1[i]; c2[i] = p2[i] + t2 * u2[i]; }
  } else {  // capsule-capsule: smooth clamped closest points
    T u1[3], u2[3], rvec[3], w[3];
    for (int i = 0; i < 3; ++i) { u1[i] = m1[3 * i + 2]; u2[i] = m2[3 * i + 2]; }
    const T h1 = m.con_half[ci][0], h2 = m.con_half[ci][1];
    for (int i = 0; i < 3; ++i) rvec[i] = p2[i] - p1[i];
    const T uu = dot3(u1, u2);
    const T ru1 = dot3(rvec, u1), ru2 = dot3(rvec, u2);
    const T det = r_max(1.0f - uu * uu, T(1e-9));
    T t1 = r_min(r_max((ru1 - uu * ru2) / det, -h1), h1);
    for (int i = 0; i < 3; ++i) w[i] = p1[i] + t1 * u1[i] - p2[i];
    const T t2 = r_min(r_max(dot3(w, u2), -h2), h2);
    for (int i = 0; i < 3; ++i) w[i] = p2[i] + t2 * u2[i] - p1[i];
    t1 = r_min(r_max(dot3(w, u1), -h1), h1);
    for (int i = 0; i < 3; ++i) {
      c1[i] = p1[i] + t1 * u1[i];
      c2[i] = p2[i] + t2 * u2[i];
    }
  }
  for (int i = 0; i < 3; ++i) d[i] = c2[i] - c1[i];
  // closest points that coincide to within rounding have no normal: the
  // residue's direction is rounding (tilestep.COINCIDE)
  const T tol = T(MR_COINCIDE) * mr_eps<T>();
  T dd = dot3(d, d);
  if (dd <= tol * tol * (1.0f + dot3(c1, c1))) {
    for (int i = 0; i < 3; ++i) d[i] = 0.0f;
    dd = 0.0f;
  }
  const T dn = r_sqrt(r_max(dd, T(1e-24)));
  for (int i = 0; i < 3; ++i) n[i] = d[i] / dn;
  dist = dn - (r1 + r2);
  const T scale = r1 + 0.5f * dist;
  for (int i = 0; i < 3; ++i) cpos[i] = c1[i] + n[i] * scale;
  frame_from_normal(n, frame);
  return dist - m.con_margin[ci];
}

// Advances the candidate's qpos/qvel in place and replaces its duals with
// the converged ones, by the L lanes of its warp; w.out receives the
// PRE-step quantities the residual reads. mocap_pos (nmocap, 3) and
// mocap_quat (nmocap, 4) are the mocap bodies' poses. Returns with the
// lanes synced.
template <class T, class S, int L>
__device__ void tile_step(const MRModelT<T, S>& m, const Cand<T, S>& w,
                          const T* ctrl, const T* mocap_pos,
                          const T* mocap_quat, MRProf& prof) {
  const int lane = lane_id<L>();
  const int nv = m.nv, nbody = m.nbody;
  const T h = m.timestep;
  T* qpos = w.qpos;
  T* qvel = w.qvel;
  T* lam = w.lam;
  const StepOut<T, S>& out = w.out;
  T (*xpos)[3] = out.xpos;
  T (*xquat)[4] = out.xquat;
  T (*xmat)[9] = out.xmat;
  T (*xipos)[3] = out.xipos;
  T (*ximat)[9] = out.ximat;
  T (*xanchor)[3] = w.xanchor;
  T (*xaxis)[3] = w.xaxis;
  T (*cdof)[6] = w.cdof;
  T* Lm = w.L;
  const int ldl = w.ldl;

  // ---- forward kinematics: the tree walk on lane 0
  if (lane == 0) {
    for (int i = 0; i < 3; ++i) xpos[0][i] = 0.0f;
    xquat[0][0] = 1.0f; xquat[0][1] = xquat[0][2] = xquat[0][3] = 0.0f;
    for (int bd = 1; bd < nbody; ++bd) {
      const int p = m.body_parentid[bd];
      T quat[4], pos[3], tmp[3];
      quat_mul(xquat[p], m.body_quat[bd], quat);
      quat_rot(xquat[p], m.body_pos[bd], tmp);
      for (int i = 0; i < 3; ++i) pos[i] = xpos[p][i] + tmp[i];
      const int mid = m.body_mocapid[bd];
      if (mid >= 0) {  // the mocap pose overrides (rollout-constant)
        for (int i = 0; i < 3; ++i) pos[i] = mocap_pos[3 * mid + i];
        for (int i = 0; i < 4; ++i) quat[i] = mocap_quat[4 * mid + i];
      }
      const int j0 = m.body_jntadr[bd], j1 = j0 + m.body_jntnum[bd];
      for (int j = j0; j < j1; ++j) {
        const int qadr = m.jnt_qposadr[j];
        const T* ax = m.jnt_axis[j];
        const T* jp = m.jnt_pos[j];
        if (m.jnt_type[j] == MR_FREE) {
          for (int i = 0; i < 3; ++i) pos[i] = qpos[qadr + i];
          for (int i = 0; i < 4; ++i) quat[i] = qpos[qadr + 3 + i];
          quat_normalize(quat);
          for (int i = 0; i < 3; ++i) xanchor[j][i] = pos[i];
          quat_rot(quat, ax, xaxis[j]);
          continue;
        }
        T anchor[3];
        quat_rot(quat, jp, tmp);
        for (int i = 0; i < 3; ++i) anchor[i] = pos[i] + tmp[i];
        T d = qpos[qadr] - m.qpos0[qadr];
        if (m.jnt_type[j] == MR_BALL) {
          // the local rotation normalized; no qpos0 offset, unlike a hinge
          T ql[4], q2[4];
          for (int i = 0; i < 4; ++i) ql[i] = qpos[qadr + i];
          quat_normalize(ql);
          quat_mul(quat, ql, q2);
          for (int i = 0; i < 4; ++i) quat[i] = q2[i];
          quat_rot(quat, jp, tmp);
          for (int i = 0; i < 3; ++i) pos[i] = anchor[i] - tmp[i];
        } else if (m.jnt_type[j] == MR_SLIDE) {
          quat_rot(quat, ax, tmp);
          for (int i = 0; i < 3; ++i) pos[i] = pos[i] + tmp[i] * d;
        } else {  // hinge
          T half = 0.5f * d, s = r_sin(half);
          T aq[4] = {r_cos(half), ax[0] * s, ax[1] * s, ax[2] * s};
          T q2[4];
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
  }
  lane_sync<L>();
  // per body: the rotation matrices and inertial frames; per site
  for (int bd = lane; bd < nbody; bd += L) {
    T tmp[3], q[4];
    quat_to_mat(xquat[bd], xmat[bd]);
    quat_rot(xquat[bd], m.body_ipos[bd], tmp);
    for (int i = 0; i < 3; ++i) xipos[bd][i] = xpos[bd][i] + tmp[i];
    quat_mul(xquat[bd], m.body_iquat[bd], q);
    quat_to_mat(q, ximat[bd]);
  }
  // the frames the residual reads (sites, geom centres)
  for (int st = lane; st < m.nsite; st += L) {
    const int bd = m.site_body[st];
    T tmp[3], q[4];
    quat_rot(xquat[bd], m.site_pos[st], tmp);
    for (int i = 0; i < 3; ++i) out.site_xpos[st][i] = xpos[bd][i] + tmp[i];
    quat_mul(xquat[bd], m.site_quat[st], q);
    quat_to_mat(q, out.site_xmat[st]);
  }
  lane_sync<L>();

  // ---- cdof [ang; lin] per dof, a lane per joint; a free joint's
  //      translations are the world axes, its rotations the body axes
  //      (xmat columns) about xpos; a ball joint's rotations the body axes
  //      about its anchor
  for (int j = lane; j < m.njnt; j += L) {
    const int k = m.jnt_dofadr[j];
    if (m.jnt_type[j] == MR_SLIDE) {
      for (int i = 0; i < 3; ++i) { cdof[k][i] = 0.0f; cdof[k][3 + i] = xaxis[j][i]; }
    } else if (m.jnt_type[j] == MR_HINGE) {
      for (int i = 0; i < 3; ++i) cdof[k][i] = xaxis[j][i];
      cross3(xanchor[j], xaxis[j], cdof[k] + 3);
    } else {  // ball, free
      const int bd = m.jnt_bodyid[j];
      const bool free = m.jnt_type[j] == MR_FREE;
      const int rot0 = free ? k + 3 : k;
      const T* origin = free ? xpos[bd] : xanchor[j];
      for (int a = 0; a < 3; ++a) {
        for (int i = 0; i < 3; ++i) {
          if (free) {
            cdof[k + a][i] = 0.0f;
            cdof[k + a][3 + i] = i == a ? 1.0f : 0.0f;
          }
          cdof[rot0 + a][i] = xmat[bd][3 * i + a];
        }
        cross3(origin, cdof[rot0 + a], cdof[rot0 + a] + 3);
      }
    }
  }
  lane_sync<L>();

  // ---- body velocities (a lane per body) + cdof_dot (a lane per dof;
  //      static masks)
  T (*cvel)[6] = out.cvel;
  for (int bd = lane; bd < nbody; bd += L) {
    for (int i = 0; i < 6; ++i) cvel[bd][i] = 0.0f;
    for (int k = 0; k < nv; ++k)
      if (m.dof_body_mask[k][bd])
        for (int i = 0; i < 6; ++i) cvel[bd][i] += cdof[k][i] * qvel[k];
  }
  T (*cdofdot)[6] = w.cdofdot;
  for (int k = lane; k < nv; k += L) {
    T v[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < nv; ++i)
      if (m.cdofdot_vel_mask[k][i])
        for (int c = 0; c < 6; ++c) v[c] += cdof[i][c] * qvel[i];
    T t1[3], t2[3];
    cross3(v, cdof[k], cdofdot[k]);
    cross3(v, cdof[k] + 3, t1);
    cross3(v + 3, cdof[k], t2);
    for (int i = 0; i < 3; ++i) cdofdot[k][3 + i] = t1[i] + t2[i];
  }
  lane_sync<L>();
  prof.mark(0);

  // ---- spatial inertias and composite (CRB) inertias: a lane per body,
  //      the accumulation up the tree on lane 0
  T (*Iw)[9] = w.Iw;
  T (*compTL)[9] = w.compTL;
  T (*compMC)[3] = w.compMC;
  T* compM = w.compM;
  for (int bd = lane; bd < nbody; bd += L) {
    const T* R = ximat[bd];
    const T* I = m.body_inertia[bd];
    const T mass = m.body_mass[bd];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        T s = 0.0f;
        for (int k = 0; k < 3; ++k) s += R[3 * i + k] * I[k] * R[3 * j + k];
        Iw[bd][3 * i + j] = s;
      }
    const T cx = xipos[bd][0], cy = xipos[bd][1], cz = xipos[bd][2];
    const T cc[9] = {cy * cy + cz * cz, -cx * cy, -cx * cz,
                     -cx * cy, cx * cx + cz * cz, -cy * cz,
                     -cx * cz, -cy * cz, cx * cx + cy * cy};
    for (int i = 0; i < 9; ++i) compTL[bd][i] = Iw[bd][i] + mass * cc[i];
    for (int i = 0; i < 3; ++i) compMC[bd][i] = mass * xipos[bd][i];
    compM[bd] = mass;
  }
  lane_sync<L>();
  if (lane == 0)
    for (int bd = nbody - 1; bd > 0; --bd) {
      const int p = m.body_parentid[bd];
      if (p > 0) {
        for (int i = 0; i < 9; ++i) compTL[p][i] += compTL[bd][i];
        for (int i = 0; i < 3; ++i) compMC[p][i] += compMC[bd][i];
        compM[p] += compM[bd];
      }
    }
  lane_sync<L>();
  // subtree CoM: the composite sums per body; body 0 is the whole system
  for (int bd = lane; bd < nbody; bd += L) {
    if (bd == 0) {
      T mc[3] = {compMC[0][0], compMC[0][1], compMC[0][2]};
      T mm = compM[0];
      for (int b = 1; b < nbody; ++b)
        if (m.body_parentid[b] == 0) {
          for (int i = 0; i < 3; ++i) mc[i] += compMC[b][i];
          mm += compM[b];
        }
      for (int i = 0; i < 3; ++i)
        out.subtree_com[0][i] = mc[i] / r_max(mm, T(1e-12));
    } else {
      for (int i = 0; i < 3; ++i)
        out.subtree_com[bd][i] = compMC[bd][i] / r_max(compM[bd], T(1e-12));
    }
  }
  // ---- joint-space inertia (ancestor sparsity) + implicit damping: the
  //      lane of dof j writes column j above the diagonal and row j below
  for (int j = lane; j < nv; j += L) {
    const int bd = m.dof_body[j];
    const T* va = cdof[j];
    const T* vl = cdof[j] + 3;
    T fa[3], fl[3], t[3];
    cross3(compMC[bd], vl, t);
    for (int i = 0; i < 3; ++i) {
      T s = 0.0f;
      for (int k = 0; k < 3; ++k) s += compTL[bd][3 * i + k] * va[k];
      fa[i] = s + t[i];
    }
    cross3(compMC[bd], va, t);
    for (int i = 0; i < 3; ++i) fl[i] = -t[i] + compM[bd] * vl[i];
    for (int i = 0; i <= j; ++i) {
      T v = 0.0f;
      if (m.dof_ancestor_mask[i][j])
        v = dot3(cdof[i], fa) + dot3(cdof[i] + 3, fl);
      Lm[i * ldl + j] = v;
      Lm[j * ldl + i] = v;
    }
    Lm[j * ldl + j] = Lm[j * ldl + j] + m.dof_armature[j] + h * m.dof_damping[j];
  }
  lane_sync<L>();
  prof.mark(1);

  // ---- in-place Cholesky (lower triangle), pivots clamped at 1e-12,
  //      column by column: the pivot on lane 0, broadcast; the column
  //      below it a row per lane
  for (int j = 0; j < nv; ++j) {
    T ljj = 0.0f;
    if (lane == 0) {
      T s = Lm[j * ldl + j];
      for (int k = 0; k < j; ++k) s -= Lm[j * ldl + k] * Lm[j * ldl + k];
      ljj = r_sqrt(r_max(s, T(1e-12)));
      Lm[j * ldl + j] = ljj;
    }
    ljj = lane_bcast<L>(ljj, 0);
    const T inv = 1.0f / ljj;
    for (int i = j + 1 + lane; i < nv; i += L) {
      T r = Lm[i * ldl + j];
      for (int k = 0; k < j; ++k) r -= Lm[i * ldl + k] * Lm[j * ldl + k];
      Lm[i * ldl + j] = r * inv;
    }
    lane_sync<L>();
  }
  prof.mark(2);

  // ---- RNE bias (qacc = 0, base acceleration = -gravity): the tree walks
  //      on lane 0, the body forces a lane per body
  T (*cacc)[6] = w.cacc;  // compTL and compMC are dead from here on
  T (*cfrc)[6] = w.cfrc;
  if (lane == 0) {
    for (int i = 0; i < 3; ++i) { cacc[0][i] = 0.0f; cacc[0][3 + i] = 0.0f - m.gravity[i]; }
    for (int bd = 1; bd < nbody; ++bd) {
      const int p = m.body_parentid[bd];
      for (int i = 0; i < 6; ++i) cacc[bd][i] = cacc[p][i];
      for (int k = 0; k < nv; ++k)
        if (m.dof_body[k] == bd)
          for (int i = 0; i < 6; ++i) cacc[bd][i] += cdofdot[k][i] * qvel[k];
    }
  }
  lane_sync<L>();
  for (int bd = lane; bd < nbody; bd += L) {
    T fav[3], flv[3], faa[3], fla[3], t1[3], t2[3], t3[3];
    const T* va = cvel[bd];
    const T* vl = cvel[bd] + 3;
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

  // ---- passive + actuation -> smooth force and acceleration: damping and
  //      friction loss a lane per dof; springs, tendons and actuators on
  //      lane 0
  T* qfrc = w.qfrc;
  T* qact = w.qact;
  for (int k = lane; k < nv; k += L) {
    T f = -m.dof_damping[k] * qvel[k];
    if (m.dof_frictionloss[k] != 0.0f)
      f = f - m.dof_frictionloss[k] * r_tanh(qvel[k] / T(0.01));
    qfrc[k] = f;
    qact[k] = 0.0f;
  }
  lane_sync<L>();
  if (lane == 0) {
    for (int bd = nbody - 1; bd > 0; --bd) {
      const int p = m.body_parentid[bd];
      for (int i = 0; i < 6; ++i) cfrc[p][i] += cfrc[bd][i];
    }
    for (int j = 0; j < m.njnt; ++j) {
      const T ks = m.jnt_stiffness[j];
      if (ks != 0.0f && m.jnt_type[j] != MR_FREE) {
        const int qadr = m.jnt_qposadr[j], vadr = m.jnt_dofadr[j];
        qfrc[vadr] = qfrc[vadr] - ks * (qpos[qadr] - m.qpos_spring[qadr]);
      }
    }
    // fixed tendons: length and velocity (limits, springs, actuators read
    // them); a spring with a deadband about lengthspring and a damper,
    // through the tendon's constant Jacobian
    for (int t = 0; t < m.nten; ++t) {
      T ln = 0.0f, vl = 0.0f;
      for (int wr = 0; wr < m.ten_nwrap[t]; ++wr) {
        const T lt = m.ten_coef[t][wr] * qpos[m.ten_qadr[t][wr]];
        const T vt = m.ten_coef[t][wr] * qvel[m.ten_vadr[t][wr]];
        ln = wr == 0 ? lt : ln + lt;
        vl = wr == 0 ? vt : vl + vt;
      }
      w.ten_len[t] = ln;
      w.ten_vel[t] = vl;
      const T kt = m.ten_stiffness[t], ct = m.ten_damping[t];
      if (kt != 0.0f || ct != 0.0f) {
        const T lo = m.ten_lengthspring[t][0], hi = m.ten_lengthspring[t][1];
        const T stretch = ln > hi ? ln - hi : (ln < lo ? ln - lo : T(0));
        const T f = -kt * stretch - ct * vl;
        for (int wr = 0; wr < m.ten_nwrap[t]; ++wr) {
          const int vadr = m.ten_vadr[t][wr];
          qfrc[vadr] = qfrc[vadr] + m.ten_coef[t][wr] * f;
        }
      }
    }
    for (int u = 0; u < m.nu; ++u) {
      T c = ctrl[u];
      if (m.ctrl_limited[u]) c = r_min(r_max(c, m.ctrl_lo[u]), m.ctrl_hi[u]);
      const T gear = m.act_gear[u];
      const int tid = m.act_tendon[u];  // a fixed-tendon transmission, or -1
      const T length = tid >= 0 ? gear * w.ten_len[tid]
                                : gear * qpos[m.act_qadr[u]];
      const T velocity = tid >= 0 ? gear * w.ten_vel[tid]
                                  : gear * qvel[m.act_vadr[u]];
      const T* gp = m.act_gainprm[u];
      const T* bp = m.act_biasprm[u];
      const T gain = m.act_gain_fixed[u]
          ? gp[0] : gp[0] + gp[1] * length + gp[2] * velocity;
      const T bias = m.act_bias_fixed[u]
          ? 0.0f : bp[0] + bp[1] * length + bp[2] * velocity;
      T force = gain * c + bias;
      if (m.force_limited[u])
        force = r_min(r_max(force, m.force_lo[u]), m.force_hi[u]);
      out.act_force[u] = force;
      if (tid >= 0) {  // moment: gear times the tendon's coefficients
        for (int wr = 0; wr < m.ten_nwrap[tid]; ++wr) {
          const int vadr = m.ten_vadr[tid][wr];
          qact[vadr] = qact[vadr] + gear * m.ten_coef[tid][wr] * force;
        }
      } else {
        qact[m.act_vadr[u]] += gear * force;
      }
    }
  }
  lane_sync<L>();
  for (int k = lane; k < nv; k += L) {
    const int bd = m.dof_body[k];
    const T bias = dot3(cdof[k], cfrc[bd]) + dot3(cdof[k] + 3, cfrc[bd] + 3);
    qfrc[k] = qfrc[k] + qact[k] - bias;
  }
  lane_sync<L>();
  chol_solve_lanes<T, L>(Lm, ldl, qfrc, w.qacc_s, nv);
  lane_sync<L>();
  prof.mark(3);

  // ---- constraint rows: condim>=3 points (n, t1, t2), condim-1 points (n),
  //      torsional rows of the condim>=4 points, rolling rows of the
  //      condim-6 points (every point's first-tangent row, then every
  //      point's second), joint limits (lo, hi), tendon limits (lo, hi),
  //      equality rows
  const int nrow = m.nrow;
  const int tor0 = tor_row0(m), roll0 = roll_row0(m), lim0 = lim_row0(m);
  const int eq0 = nrow - m.neqrow;
  T* qfrc_c = w.qfrc_c;
  if (nrow > 0) {
    T* J = w.J;
    const int ldj = w.ldj;
    int* active = w.active;
    T* aref = w.aref;
    T* imp = w.imp;
    // a lane per contact point: its narrowphase and its rows
    for (int ci = lane; ci < m.ncon; ci += L) {
      T frame[3][3], cpos[3];
      const T dist = contact_geometry(m, xpos, xquat, ci, frame, cpos);
      const T im = impedance(dist, m.con_imp[ci]);
      const int cid = m.con_id[ci];
      out.con_dist[cid] = dist;
      for (int i = 0; i < 3; ++i) out.con_normal[cid][i] = frame[0][i];
      const bool fric = ci < m.nfric;
      const int r0 = fric ? 3 * ci : 3 * m.nfric + (ci - m.nfric);
      for (int row = 0; row < (fric ? 3 : 1); ++row) {
        const int r = r0 + row;
        T* Jr = J + r * ldj;
        for (int k = 0; k < nv; ++k) {
          const T sg = m.con_sgn[ci][k];
          if (sg != 0.0f) {
            T jp[3], tmp[3];
            cross3(cdof[k], cpos, tmp);
            for (int i = 0; i < 3; ++i) jp[i] = cdof[k][3 + i] + tmp[i];
            Jr[k] = sg * dot3(frame[row], jp);
          } else {
            Jr[k] = 0.0f;
          }
        }
        const T pos = row == 0 ? r_min(dist, 0.0f) : 0.0f;
        active[r] = dist < 0.0f;
        imp[r] = im;
        T vel = 0.0f;
        for (int k = 0; k < nv; ++k) vel += Jr[k] * qvel[k];
        aref[r] = -im * (m.con_k[ci] * pos + m.con_b[ci] * vel);
      }
      // torsional row: the relative angular velocity about the normal, no
      // positional error, the point's impedance, solref and activity
      const int ti = fric ? m.con_tor[ci] : -1;
      if (ti >= 0) {
        const int r = tor0 + ti;
        T* Jr = J + r * ldj;
        for (int k = 0; k < nv; ++k) {
          const T sg = m.con_sgn[ci][k];
          Jr[k] = sg != 0.0f ? sg * dot3(frame[0], cdof[k]) : T(0);
        }
        active[r] = dist < 0.0f;
        imp[r] = im;
        T vel = 0.0f;
        for (int k = 0; k < nv; ++k) vel += Jr[k] * qvel[k];
        aref[r] = -im * (m.con_k[ci] * T(0) + m.con_b[ci] * vel);
      }
      // rolling rows: the relative angular velocity about each tangent,
      // otherwise as the torsional row
      const int ri = fric ? m.con_roll[ci] : -1;
      for (int ax = 1; ri >= 0 && ax <= 2; ++ax) {
        const int r = roll0 + (ax - 1) * m.nroll + ri;
        T* Jr = J + r * ldj;
        for (int k = 0; k < nv; ++k) {
          const T sg = m.con_sgn[ci][k];
          Jr[k] = sg != 0.0f ? sg * dot3(frame[ax], cdof[k]) : T(0);
        }
        active[r] = dist < 0.0f;
        imp[r] = im;
        T vel = 0.0f;
        for (int k = 0; k < nv; ++k) vel += Jr[k] * qvel[k];
        aref[r] = -im * (m.con_k[ci] * T(0) + m.con_b[ci] * vel);
      }
    }
    // a lane per limited joint, then per limited tendon
    for (int li = lane; li < m.nlim; li += L) {
      const T q = qpos[m.lim_qadr[li]];
      for (int side = 0; side < 2; ++side) {
        const int r = lim0 + 2 * li + side;
        T* Jr = J + r * ldj;
        const T posv = side == 0 ? q - m.lim_lo[li] - m.lim_margin[li]
                                 : m.lim_hi[li] - q - m.lim_margin[li];
        const T sgn = side == 0 ? 1.0f : -1.0f;
        for (int k = 0; k < nv; ++k) Jr[k] = 0.0f;
        Jr[m.lim_vadr[li]] = sgn;
        active[r] = posv < 0.0f;
        imp[r] = impedance(posv, m.lim_imp);
        const T vel = sgn * qvel[m.lim_vadr[li]];
        aref[r] = -imp[r] * (m.lim_k[li] * r_min(posv, 0.0f) +
                             m.lim_b[li] * vel);
      }
    }
    for (int ti = lane; ti < m.ntenlim; ti += L) {
      const int t = m.ten_lim_id[ti];
      const T len = w.ten_len[t];
      for (int side = 0; side < 2; ++side) {
        const int r = lim0 + 2 * m.nlim + 2 * ti + side;
        T* Jr = J + r * ldj;
        const T posv = side == 0
            ? len - m.ten_lo[ti] - m.ten_margin[ti]
            : m.ten_hi[ti] - len - m.ten_margin[ti];
        const T sgn = side == 0 ? 1.0f : -1.0f;
        for (int k = 0; k < nv; ++k) Jr[k] = 0.0f;
        for (int wr = 0; wr < m.ten_nwrap[t]; ++wr)
          Jr[m.ten_vadr[t][wr]] += sgn * m.ten_coef[t][wr];
        active[r] = posv < 0.0f;
        imp[r] = impedance(posv, m.lim_imp);
        T vel = 0.0f;
        for (int k = 0; k < nv; ++k) vel += Jr[k] * qvel[k];
        aref[r] = -imp[r] * (m.ten_k[ti] * r_min(posv, 0.0f) +
                             m.ten_b[ti] * vel);
      }
    }
    // equality rows, a lane per equality: bilateral (a signed position
    // error, always active); their softness scale is the model's
    // diagApprox
    for (int e = lane; e < m.neq; e += L) {
      const T* d = m.eq_data[e];
      int r = eq0;
      for (int e2 = 0; e2 < e; ++e2) r += eq_nrows(m.eq_kind[e2]);
      const int r_first = r;
      T pos[6];
      if (m.eq_kind[e] == MR_EQ_JOINT) {
        // q1 - qpos0_1 = poly(q2 - qpos0_2), the derivative in q2's column
        const int qa1 = m.jnt_qposadr[m.eq_ob1[e]];
        T* Jr = J + r * ldj;
        for (int k = 0; k < nv; ++k) Jr[k] = 0.0f;
        Jr[m.jnt_dofadr[m.eq_ob1[e]]] = 1.0f;
        const T q1 = qpos[qa1] - m.qpos0[qa1];
        if (m.eq_ob2[e] >= 0) {
          const int qa2 = m.jnt_qposadr[m.eq_ob2[e]];
          const T dq = qpos[qa2] - m.qpos0[qa2];
          const T dq2 = dq * dq, dq3 = dq2 * dq;
          const T poly = d[0] + d[1] * dq + d[2] * dq2 + d[3] * dq3 +
                         d[4] * (dq2 * dq2);
          const T dpoly = d[1] + (T(2) * d[2]) * dq + (T(3) * d[3]) * dq2 +
                          (T(4) * d[4]) * dq3;
          Jr[m.jnt_dofadr[m.eq_ob2[e]]] -= dpoly;
          pos[0] = q1 - poly;
        } else {
          pos[0] = q1 - d[0];
        }
        ++r;
      } else {
        // connect: the two anchors coincide (a weld's anchors swapped);
        // each row a difference of point-translation Jacobians
        const bool weld = m.eq_kind[e] == MR_EQ_WELD;
        const int b1 = m.eq_ob1[e], b2 = m.eq_ob2[e];
        T p1[3], p2[3], tmp[3];
        quat_rot(xquat[b1], weld ? d + 3 : d, tmp);
        for (int i = 0; i < 3; ++i) p1[i] = xpos[b1][i] + tmp[i];
        quat_rot(xquat[b2], weld ? d : d + 3, tmp);
        for (int i = 0; i < 3; ++i) p2[i] = xpos[b2][i] + tmp[i];
        for (int i = 0; i < 3; ++i, ++r) {
          T* Jr = J + r * ldj;
          for (int k = 0; k < nv; ++k) {
            const bool m1 = m.dof_body_mask[k][b1], m2 = m.dof_body_mask[k][b2];
            T c1[3], c2[3];
            cross3(cdof[k], p1, c1);
            cross3(cdof[k], p2, c2);
            const T j1 = cdof[k][3 + i] + c1[i], j2 = cdof[k][3 + i] + c2[i];
            Jr[k] = m1 ? (m2 ? j1 - j2 : j1) : (m2 ? -j2 : T(0));
          }
          pos[i] = p1[i] - p2[i];
        }
        if (weld) {
          // orientation: torquescale times the sin-weighted error
          // 2 sign(w) vec(q2^-1 q1 relpose) (JAX's _quat_sub_tb)
          const T tq = r_max(d[10], T(1e-8));
          T q1r[4], dq[4];
          quat_mul(xquat[b1], d + 6, q1r);
          const T c2[4] = {xquat[b2][0], -xquat[b2][1], -xquat[b2][2],
                           -xquat[b2][3]};
          quat_mul(c2, q1r, dq);
          const T sg = dq[0] < 0.0f ? T(-2) : T(2);
          for (int i = 0; i < 3; ++i, ++r) {
            T* Jr = J + r * ldj;
            for (int k = 0; k < nv; ++k) {
              const T wt = T(m.dof_body_mask[k][b1] ? 1 : 0) -
                           T(m.dof_body_mask[k][b2] ? 1 : 0);
              Jr[k] = wt != 0.0f ? (tq * wt) * cdof[k][i] : T(0);
            }
            pos[3 + i] = tq * (dq[1 + i] * sg);
          }
        }
      }
      for (int rr = r_first; rr < r; ++rr) {
        const T posv = pos[rr - r_first];
        active[rr] = 1;
        imp[rr] = impedance(posv, m.eq_imp[e]);
        w.eq_da[rr - eq0] = m.eq_da[e][rr - r_first];
        T vel = 0.0f;
        for (int k = 0; k < nv; ++k) vel += J[rr * ldj + k] * qvel[k];
        aref[rr] = -imp[rr] * (m.eq_k[e] * posv + m.eq_b[e] * vel);
      }
    }
    lane_sync<L>();
    prof.mark(4);

    // ---- Delassus diagonal (and matrix when dense), a lane per row, each
    //      solving its own rows; the largest diagonal across the lanes
    T* raw_diag = w.raw_diag;
    T mx = mr_nan<T>();
    for (int s = lane; s < nrow; s += L) {
      T x[MR_MAX_NV];
      const T* Js = J + s * ldj;
      chol_solve(Lm, ldl, Js, x, nv);
      if (m.dense) {
        for (int rr = 0; rr < nrow; ++rr) {
          T a = 0.0f;
          for (int k = 0; k < nv; ++k) a += J[rr * ldj + k] * x[k];
          w.amat[rr * w.lda + s] = a;
        }
        raw_diag[s] = w.amat[s * w.lda + s];
      } else {
        T a = 0.0f;
        for (int k = 0; k < nv; ++k) a += Js[k] * x[k];
        raw_diag[s] = a;
      }
      mx = r_max(mx, raw_diag[s]);
    }
    const T maxd = lane_max<L>(mx);
    // free acceleration, softness, degenerate rows: a lane per row
    T* a0 = w.a0;
    T* diag = w.diag;
    T* reg = w.reg;
    T* dr = w.dr;
    for (int rr = lane; rr < nrow; rr += L) {
      T a = 0.0f;
      for (int k = 0; k < nv; ++k) a += J[rr * ldj + k] * w.qacc_s[k];
      a0[rr] = a;
      diag[rr] = r_max(raw_diag[rr], T(1e-10));
      const bool eq = rr >= eq0;
      reg[rr] = (1.0f - imp[rr]) / imp[rr] * (eq ? w.eq_da[rr - eq0]
                                                 : diag[rr]);
      // degenerate rows (A_rr ~ 0 against the largest) are deactivated,
      // except the equality rows, whose softness keeps the dual bounded
      active[rr] = active[rr] && (eq || raw_diag[rr] > T(1e-8) * maxd);
      dr[rr] = diag[rr] + reg[rr];
    }
    lane_sync<L>();

    // ---- Jacobi preconditioning, tangent scales tied inside a point and
    //      the scales of a point's two rolling rows tied
    for (int ci = lane; ci < m.nfric; ci += L) {
      const T mt = 0.5f * (dr[3 * ci + 1] + dr[3 * ci + 2]);
      dr[3 * ci + 1] = mt;
      dr[3 * ci + 2] = mt;
    }
    for (int i = lane; i < m.nroll; i += L) {
      const T mr = 0.5f * (dr[roll0 + i] + dr[roll0 + m.nroll + i]);
      dr[roll0 + i] = mr;
      dr[roll0 + m.nroll + i] = mr;
    }
    lane_sync<L>();
    T* s_pre = w.s_pre;
    for (int rr = lane; rr < nrow; rr += L)
      s_pre[rr] = 1.0f / r_sqrt(r_max(dr[rr], T(1e-12)));
    lane_sync<L>();
    for (int ci = lane; ci < m.nfric; ci += L) {
      w.mu_t[ci] = m.con_mu[ci] * s_pre[3 * ci] / s_pre[3 * ci + 1];
      const int ti = m.con_tor[ci];
      if (ti >= 0)  // the torsional cap against the normal's scale
        w.mu_tor[ti] = m.con_mu_tor[ci] * s_pre[3 * ci] / s_pre[tor0 + ti];
      const int ri = m.con_roll[ci];
      if (ri >= 0)  // the rolling cap likewise
        w.mu_roll[ri] =
            m.con_mu_roll[ci] * s_pre[3 * ci] / s_pre[roll0 + ri];
    }
    // ---- initial iterate: cold start, or the previous step's duals; the
    //      angular (torsional, rolling) and equality rows always start
    //      cold (their duals can be non-unique, and warm-starting them
    //      integrates drift)
    T* g = w.g;
    T lam_abs = 0.0f;
    for (int rr = lane; rr < nrow; rr += L) lam_abs += r_abs(lam[rr]);
    const bool cold = lane_sum<L>(lam_abs) == 0.0f;
    for (int rr = lane; rr < nrow; rr += L) {
      const T dinv = 1.0f / (diag[rr] + reg[rr]);
      g[rr] = (aref[rr] - a0[rr]) * dinv / s_pre[rr];
    }
    lane_sync<L>();
    project<T, S, L>(m, w, g);
    if (!cold) {
      for (int rr = lane; rr < nrow; rr += L)
        if (rr < tor0 || (rr >= lim0 && rr < eq0))
          g[rr] = lam[rr] / s_pre[rr];
      lane_sync<L>();
    }
    project<T, S, L>(m, w, g);
    T* bvec = w.bvec;
    for (int rr = lane; rr < nrow; rr += L) bvec[rr] = a0[rr] - aref[rr];
    lane_sync<L>();
    prof.mark(5);

    // ---- step size: Gershgorin (dense) or power iteration (matrix-free),
    //      denominators floored at 1
    T step;
    if (m.dense) {
      T bound = 0.0f;
      for (int rr = lane; rr < nrow; rr += L) {
        T s = 0.0f;
        for (int c = 0; c < nrow; ++c)
          s += r_abs(w.amat[rr * w.lda + c]) * s_pre[c];
        const T rs = s_pre[rr] * s + s_pre[rr] * s_pre[rr] * reg[rr];
        bound = r_max(bound, active[rr] ? rs : 0.0f);
      }
      step = 1.0f / r_max(lane_max<L>(bound), 1.0f);
    } else {
      T* v = w.v;
      T* wv = w.w;
      for (int rr = lane; rr < nrow; rr += L) v[rr] = active[rr] ? 1.0f : 0.0f;
      lane_sync<L>();
      for (int it = 0; it < MR_POWER_ITERS; ++it) {
        opmul<T, S, L>(m, w, v, wv);
        T ss = 0.0f;
        for (int rr = lane; rr < nrow; rr += L) ss += wv[rr] * wv[rr];
        ss = lane_sum<L>(ss);
        const T nrm = r_sqrt(r_max(ss, T(1e-30)));
        for (int rr = lane; rr < nrow; rr += L) v[rr] = wv[rr] / nrm;
        lane_sync<L>();
      }
      opmul<T, S, L>(m, w, v, wv);
      T lm = 0.0f;
      for (int rr = lane; rr < nrow; rr += L) lm += v[rr] * wv[rr];
      lm = lane_sum<L>(lm);
      step = 1.0f / r_max(1.25f * lm, 1.0f);
    }
    prof.mark(6);

    // ---- APGD with adaptive restart, in g = f / s coordinates
    T* y = w.y;
    T* gn = w.gn;
    T* f = w.v;
    T* af = w.w;
    for (int rr = lane; rr < nrow; rr += L) y[rr] = g[rr];
    T t = 1.0f;
    for (int it = 0; it < MR_ITERATIONS; ++it) {
      for (int rr = lane; rr < nrow; rr += L) f[rr] = s_pre[rr] * y[rr];
      lane_sync<L>();
      amul<T, S, L>(m, w, f, af);
      for (int rr = lane; rr < nrow; rr += L) {
        const T gr = s_pre[rr] * (af[rr] + reg[rr] * f[rr] + bvec[rr]);
        gn[rr] = y[rr] - step * gr;
      }
      lane_sync<L>();
      project<T, S, L>(m, w, gn);
      const T t_new = 0.5f * (1.0f + r_sqrt(1.0f + 4.0f * t * t));
      const T beta = (t - 1.0f) / t_new;
      T dot = 0.0f;
      for (int rr = lane; rr < nrow; rr += L)
        dot += (gn[rr] - g[rr]) * (y[rr] - gn[rr]);
      dot = lane_sum<L>(dot);
      const bool reverse = dot > 0.0f;
      for (int rr = lane; rr < nrow; rr += L) {
        const T dg = gn[rr] - g[rr];
        y[rr] = reverse ? gn[rr] : gn[rr] + beta * dg;
        g[rr] = gn[rr];
      }
      t = reverse ? 1.0f : t_new;
    }
    for (int rr = lane; rr < nrow; rr += L) lam[rr] = s_pre[rr] * g[rr];
    lane_sync<L>();
    for (int k = lane; k < nv; k += L) {
      T s = 0.0f;
      for (int rr = 0; rr < nrow; ++rr) s += J[rr * ldj + k] * lam[rr];
      qfrc_c[k] = s;
    }
  } else {
    for (int k = lane; k < nv; k += L) qfrc_c[k] = 0.0f;
  }
  lane_sync<L>();
  prof.mark(7);

  // ---- integrate (semi-implicit Euler, implicit damping in the factor);
  //      a free or ball joint's quaternion by the exact exponential map
  for (int k = lane; k < nv; k += L) qfrc[k] = qfrc[k] + qfrc_c[k];
  lane_sync<L>();
  chol_solve_lanes<T, L>(Lm, ldl, qfrc, w.qacc, nv);
  lane_sync<L>();
  for (int k = lane; k < nv; k += L) qvel[k] = qvel[k] + h * w.qacc[k];
  lane_sync<L>();
  for (int j = lane; j < m.njnt; j += L) {
    const int qadr = m.jnt_qposadr[j], vadr = m.jnt_dofadr[j];
    if (m.jnt_type[j] == MR_FREE) {
      for (int i = 0; i < 3; ++i) qpos[qadr + i] += h * qvel[vadr + i];
      quat_integrate(qpos + qadr + 3, qvel + vadr + 3, h);
    } else if (m.jnt_type[j] == MR_BALL) {
      quat_integrate(qpos + qadr, qvel + vadr, h);
    } else {
      qpos[qadr] = qpos[qadr] + h * qvel[vadr];
    }
  }
  lane_sync<L>();
  prof.mark(8);
}


// ---------------------------------------------------------------------------
// task residuals (tasks/*.py::residual) and the cost (cost_value_t)
// ---------------------------------------------------------------------------

// Residuals read pre-step frames (StepOut), post-step qpos/qvel, the
// step's ctrl and the post-step time t0 + (i+1)*dt
// (megarollout.py::_rollout_body).
// tasks/walker.py::residual; res_int = (torso body, rootx dof); no time
template <class T, class S>
__device__ void residual_walker(const MRModelT<T, S>& m, const StepOut<T, S>& o,
                                const T* /*qpos*/, const T* qvel,
                                const T* ctrl, T /*time*/,
                                const T* rp, T* res) {
  const int torso = m.res_int[0], vx = m.res_int[1];
  res[0] = o.xpos[torso][2] - rp[1];
  res[1] = o.xmat[torso][8] - 1.0f;
  res[2] = qvel[vx] - rp[0];
  for (int i = 0; i < 6; ++i) res[3 + i] = ctrl[i];
}

// world velocity of body b's centre of mass (cvel about the world origin)
template <class T, class S>
__device__ __forceinline__ void com_vel(const StepOut<T, S>& o, int b, T* v) {
  T t[3];
  cross3(o.cvel[b], o.xipos[b], t);
  for (int i = 0; i < 3; ++i) v[i] = o.cvel[b][3 + i] + t[i];
}

// physics/sensors.py::subtree_linvel over the bodies in bitmask `set`
template <class T, class S>
__device__ void subtree_linvel(const MRModelT<T, S>& m, const StepOut<T, S>& o,
                               int set, T mass, T* v) {
  T mom[3] = {0.0f, 0.0f, 0.0f};
  for (int b = 0; b < m.nbody; ++b)
    if (set & (1 << b)) {
      T vb[3];
      com_vel(o, b, vb);
      for (int i = 0; i < 3; ++i) mom[i] += m.body_mass[b] * vb[i];
    }
  for (int i = 0; i < 3; ++i) v[i] = mom[i] / r_max(mass, T(1e-12));
}

// tasks/humanoid.py::residual (36 + (nq - 7) + nu entries, 57 for the
// dm_control humanoid); res_int = (torso, pelvis,
// lower_waist, right_foot, left_foot, torso subtree mask, lower_waist
// subtree mask), res_float = (torso, lower_waist subtree masses);
// rp = (Height, Speed, Balance); no time
template <class T, class S>
__device__ void residual_humanoid(const MRModelT<T, S>& m,
                                  const StepOut<T, S>& o,
                                  const T* qpos, const T* /*qvel*/,
                                  const T* ctrl, T /*time*/,
                                  const T* rp, T* res) {
  const int torso = m.res_int[0], pelvis = m.res_int[1];
  const int rfoot = m.res_int[3], lfoot = m.res_int[4];
  const T* fr = o.xpos[rfoot];
  const T* fl = o.xpos[lfoot];
  // torso height, pelvis / feet, the standing gate
  const T torso_h = o.xpos[torso][2];
  res[0] = torso_h - rp[0];
  res[1] = 0.5f * (fl[2] + fr[2]) - o.xpos[pelvis][2] - T(0.2);
  const T standing =
      torso_h / r_sqrt(torso_h * torso_h + T(0.45 * 0.45)) - T(0.4);
  // balance: capture point onto the inter-foot segment
  T subvel[3];
  subtree_linvel(m, o, m.res_int[5], m.res_float[0], subvel);
  T capture[2], axis[2], center[2];
  for (int i = 0; i < 2; ++i) {
    capture[i] = o.subtree_com[torso][i] + rp[2] * subvel[i];
    axis[i] = fr[i] - fl[i];
    center[i] = 0.5f * (fr[i] + fl[i]);
  }
  const T anorm = r_sqrt(axis[0] * axis[0] + axis[1] * axis[1]);
  const T length = 0.5f * anorm - T(0.05);
  for (int i = 0; i < 2; ++i) axis[i] = axis[i] / r_max(anorm, T(1e-9));
  T t = (capture[0] - center[0]) * axis[0] +
            (capture[1] - center[1]) * axis[1];
  t = r_min(r_max(t, -length), length);
  for (int i = 0; i < 2; ++i)
    res[2 + i] = standing * (capture[i] - (center[i] + t * axis[i]));
  // upright: torso, pelvis, both feet
  res[4] = o.xmat[torso][8] - 1.0f;
  res[5] = T(0.3) * (o.xmat[pelvis][8] - 1.0f);
  const T sf = T(0.1) * standing;
  for (int i = 0; i < 3; ++i) {
    res[6 + i] = sf * (o.xmat[rfoot][3 * i + 2] - (i == 2 ? 1.0f : 0.0f));
    res[9 + i] = sf * (o.xmat[lfoot][3 * i + 2] - (i == 2 ? 1.0f : 0.0f));
  }
  // posture: the joint angles after the step (qpos past the free joint)
  const int nposture = m.nq - 7;
  for (int i = 0; i < nposture; ++i) res[12 + i] = qpos[7 + i];
  T* tail = res + 12 + nposture;
  // walk forward, move feet
  T fwd[2];
  for (int i = 0; i < 2; ++i)
    fwd[i] = o.xmat[torso][3 * i] + o.xmat[pelvis][3 * i] +
             o.xmat[rfoot][3 * i] + o.xmat[lfoot][3 * i];
  const T fnorm = r_max(r_sqrt(fwd[0] * fwd[0] + fwd[1] * fwd[1]), T(1e-9));
  T waist_vel[3], torso_vel[3], rvel[3], lvel[3], cv[2];
  subtree_linvel(m, o, m.res_int[6], m.res_float[1], waist_vel);
  com_vel(o, torso, torso_vel);
  com_vel(o, rfoot, rvel);
  com_vel(o, lfoot, lvel);
  for (int i = 0; i < 2; ++i) cv[i] = 0.5f * (waist_vel[i] + torso_vel[i]);
  tail[0] = standing * (cv[0] * (fwd[0] / fnorm) + cv[1] * (fwd[1] / fnorm)
                        - rp[1]);
  for (int i = 0; i < 2; ++i)
    tail[1 + i] = standing * (cv[i] - 0.5f * rvel[i] - 0.5f * lvel[i]);
  // control: the raw commands
  for (int i = 0; i < m.nu; ++i) tail[3 + i] = ctrl[i];
}

// physics/sensors.py::subtree_angmom: angular momentum about the subtree
// CoM of body `root`, over the bodies in bitmask `set`
template <class T, class S>
__device__ void subtree_angmom(const MRModelT<T, S>& m, const StepOut<T, S>& o,
                               int set, int root, T* h) {
  const T* com = o.subtree_com[root];
  for (int i = 0; i < 3; ++i) h[i] = 0.0f;
  for (int b = 0; b < m.nbody; ++b)
    if (set & (1 << b)) {
      const T* omega = o.cvel[b];
      const T* rot = o.ximat[b];
      T vcom[3], loc[3], spin[3], d[3], orbit[3];
      com_vel(o, b, vcom);
      for (int i = 0; i < 3; ++i)
        loc[i] = m.body_inertia[b][i] * (rot[i] * omega[0] +
                                         rot[3 + i] * omega[1] +
                                         rot[6 + i] * omega[2]);
      mat_vec(rot, loc, spin);
      for (int i = 0; i < 3; ++i) d[i] = o.xipos[b][i] - com[i];
      cross3(d, vcom, orbit);
      for (int i = 0; i < 3; ++i)
        h[i] += spin[i] + m.body_mass[b] * orbit[i];
    }
}

// tasks/quadruped.py: the gait tables (foot order FL, FR, RL, RR), 0 for a
// gait outside them
__constant__ float kGaitPhase[5][4] = {{0.00f, 0.00f, 0.00f, 0.00f},
                                       {0.00f, 0.50f, 0.75f, 0.25f},
                                       {0.00f, 0.50f, 0.50f, 0.00f},
                                       {0.00f, 0.33f, 0.33f, 0.66f},
                                       {0.00f, 0.05f, 0.40f, 0.35f}};
// duty ratio, cadence, amplitude, balance, upright and height weights
__constant__ float kGaitParam[5][6] = {{1.00f, 1.0f, 0.00f, 0.00f, 1.0f, 1.0f},
                                       {0.75f, 1.0f, 0.03f, 0.00f, 1.0f, 1.0f},
                                       {0.45f, 2.0f, 0.03f, 0.20f, 1.0f, 1.0f},
                                       {0.40f, 4.0f, 0.05f, 0.03f, 0.5f, 0.2f},
                                       {0.30f, 3.5f, 0.10f, 0.03f, 0.2f, 0.1f}};
#define MR_PI 3.141592653589793
enum { kQuadruped = 0, kBiped = 1, kWalk = 2, kScramble = 3, kFlip = 4 };

// a userdata entry as an index, truncated toward zero as astype(int32)
// does; -1 (no table row, no mode) out of range
template <class T>
__device__ __forceinline__ int ud_index(T x) {
  return x > T(-1e9) && x < T(1e9) ? (int)x : -1;
}

template <class T>
__device__ __forceinline__ T gait_param(int gait, int col) {
  return gait >= 0 && gait < 5 ? T(kGaitParam[gait][col]) : T(0);
}

// the active gait: a biped always trots (quadruped.cc:652-656)
template <class T>
__device__ __forceinline__ int quadruped_gait(const T* ud) {
  return ud_index(ud[16]) == kBiped ? 2 : ud_index(ud[0]);
}

// tasks/quadruped.py::_step_height; jnp.mod is a floor mod: the fmod
// remainder shifted to the sign of 2 pi
template <class T>
__device__ T step_height(T phase, T footphase, T duty) {
  const T two_pi = T(2 * MR_PI);
  T angle = r_fmod(phase + T(MR_PI) - footphase, two_pi);
  if (angle != 0.0f && angle < 0.0f) angle = angle + two_pi;
  angle = angle - T(MR_PI);
  angle = angle * 0.5f / r_max(1.0f - duty, T(1e-6));
  T value = r_cos(r_min(r_max(angle, T(-MR_PI / 2)), T(MR_PI / 2)));
  value = duty < 1.0f ? value : T(0);
  return r_abs(value) < T(1e-6) ? T(0) : value;
}

// tasks/quadruped.py::weight_mod: the per-term cost weight multipliers;
// they depend on userdata alone, so once per rollout
template <class T>
__device__ void weight_mod_quadruped(const T* ud, T* scale) {
  const int gait = quadruped_gait(ud);
  for (int k = 0; k < 9; ++k) scale[k] = 1.0f;
  scale[4] = gait_param<T>(gait, 3);  // balance
  scale[0] = gait_param<T>(gait, 4);  // upright
  scale[1] = gait_param<T>(gait, 5);  // height
  if (ud_index(ud[16]) == kFlip) {
    const T flip[9] = {T(0.2), T(5.0), T(0), T(0), T(0), T(0.005 / 0.03),
                       T(0.1 / 0.02), T(1), T(1)};
    for (int k = 0; k < 9; ++k) scale[k] = flip[k];
  }
}

// tasks/quadruped.py::residual (42 entries): Upright(3), Height,
// Position(3), Gait(4), Balance(2), Effort(nu), Posture(12),
// Orientation(2), Angmom(3). res_int = (trunk, trunk subtree mask);
// res_float = (trunk subtree mass, the home keyframe's 12 joint angles,
// the flip constants in quadruped._DEVICE_FLIP order); sites = (feet FL,
// FR, RL, RR, head); rp = (gait, gait switch, walk speed, walk turn, biped
// type, heading, arm posture, flip direction). The Flip branch tracks the
// choreographed height and pitch from its entry time ud[8], torso
// quaternion ud[17:21] and ground height ud[21].
template <class T, class S>
__device__ void residual_quadruped(const MRModelT<T, S>& m,
                                   const StepOut<T, S>& o,
                                   const T* qpos, T time, const T* rp,
                                   const T* ud, const T* mocap_pos, T* res) {
  const int trunk = m.res_int[0];
  const T* home = m.res_float + 1;
  const T* fc = m.res_float + 13;
  const int mode = ud_index(ud[16]);
  const bool biped = mode == kBiped, flip = mode == kFlip;
  const bool scramble = mode == kScramble;
  const bool handstand_type = rp[4] > 0.5f;
  const T* xm = o.xmat[trunk];
  const T* head = o.site_xpos[4];
  const T* goal = mocap_pos;  // mocap body 0
  T avg[3];
  for (int i = 0; i < 3; ++i)
    avg[i] = (((o.site_xpos[0][i] + o.site_xpos[1][i]) + o.site_xpos[2][i])
              + o.site_xpos[3][i]) / T(4);
  const T handstand = handstand_type ? T(-1) : T(1);
  const T ft = time - ud[8];  // time into the flip
  // ---- Upright
  if (flip) {
    // pitch target fc: crouch vel, jump acc/2, jump time, leap height,
    // jump vel, g/2, flight time, land acc/2, jump + flight time, flip
    // time, crouch time, jump rot acc/2, jump rot vel, flight rot vel,
    // land rot acc/2
    const T tc = ft - fc[10], tf = ft - fc[2], tl = ft - fc[2] - fc[6];
    T angle;
    if (ft >= fc[9]) angle = T(2 * MR_PI);
    else if (ft < fc[2]) angle = ft < fc[10] ? T(0)
                                             : fc[11] * tc * tc + fc[12] * tc;
    else if (ft < fc[8]) angle = T(0.5 * MR_PI) + fc[13] * tf;
    else angle = T(1.75 * MR_PI) + fc[13] * tl - fc[14] * tl * tl;
    const T half = 0.5f * angle;
    const T dir = rp[7] > 0.5f ? T(1) : T(-1);
    const T dq[4] = {r_cos(half), T(0), dir * r_sin(half), T(0)};
    T target[4], qbc[4], err[4];
    quat_mul(ud + 17, dq, target);
    qbc[0] = target[0];
    for (int i = 1; i < 4; ++i) qbc[i] = -target[i];
    quat_mul(qbc, o.xquat[trunk], err);
    const T sg = err[0] < 0.0f ? T(-2) : T(2);
    for (int i = 0; i < 3; ++i) res[i] = err[1 + i] * sg;
  } else {
    res[0] = biped ? xm[6] - handstand : xm[8] - 1.0f;
    res[1] = 0.0f;
    res[2] = 0.0f;
  }
  // ---- Height
  const T height_goal = biped ? T(0.5) : T(0.3);
  if (flip) {
    T hgt;
    if (ft >= fc[9]) {
      hgt = T(0.3);
    } else if (ft < fc[2]) {
      hgt = T(0.3) + ft * fc[0] + fc[1] * ft * ft;
    } else {
      const T tf = ft - fc[2], tl = ft - fc[2] - fc[6];
      hgt = ft < fc[8] ? fc[3] + fc[4] * tf - fc[5] * tf * tf
                       : fc[3] - fc[4] * tl + fc[7] * tl * tl;
    }
    res[3] = o.xipos[trunk][2] - (ud[21] + hgt);
  } else {
    res[3] = scramble ? T(0) : (o.xipos[trunk][2] - avg[2]) - height_goal;
  }
  // ---- Position: the head to the goal
  res[4] = head[0] - goal[0];
  res[5] = head[1] - goal[1];
  res[6] = scramble ? 2.0f * (head[2] - goal[2]) : T(0);
  // ---- Gait: foot heights against the gait's step profile
  const int gait = quadruped_gait(ud);
  const T duty = gait_param<T>(gait, 0);
  const T amplitude = gait_param<T>(gait, 2);
  const T phase = ud[1] + (time - ud[2]) * ud[3];
  for (int f = 0; f < 4; ++f) {
    const T fphase = T(2 * MR_PI) * (gait >= 0 && gait < 5
                                         ? T(kGaitPhase[gait][f]) : T(0));
    const T step = amplitude * step_height(phase, fphase, duty);
    T hdiff = o.site_xpos[f][2] - (T(0.02) + step);  // flat ground
    if (scramble) hdiff = r_min(hdiff, T(0));
    const bool front = f < 2;
    const bool hand = handstand_type ? !front : front;
    res[7 + f] = (biped && hand) || step == 0.0f ? T(0) : hdiff;
  }
  // ---- Balance: the capture point over the mean foot
  T comvel[3];
  subtree_linvel(m, o, m.res_int[1], m.res_float[0], comvel);
  const T fall_time = r_sqrt(2.0f * height_goal / T(9.81));
  for (int i = 0; i < 2; ++i)
    res[11 + i] = (o.subtree_com[trunk][i] + fall_time * comvel[i]) - avg[i];
  // ---- Effort
  for (int u = 0; u < m.nu; ++u) res[13 + u] = T(2e-2) * o.act_force[u];
  // ---- Posture: abduction weighted 2; a biped's arms by rp[6]
  T* posture = res + 13 + m.nu;
  for (int i = 0; i < 12; ++i) {
    const T p = (qpos[7 + i] - home[i]) * (i % 3 == 0 ? T(2) : T(1));
    const bool front = i < 6;
    const bool arm = handstand_type ? !front : front;
    posture[i] = biped && arm ? p * rp[6] : p;
  }
  // ---- Orientation: the heading against rp[5]
  T hd[2];
  if (biped) {
    hd[0] = handstand * xm[2];
    hd[1] = handstand * xm[5];
  } else {
    hd[0] = xm[0];
    hd[1] = xm[3];
  }
  const T hn = r_max(r_sqrt(hd[0] * hd[0] + hd[1] * hd[1]), T(1e-9));
  posture[12] = hd[0] / hn - r_cos(rp[5]);
  posture[13] = hd[1] / hn - r_sin(rp[5]);
  // ---- Angular momentum of the trunk's subtree
  subtree_angmom(m, o, m.res_int[1], trunk, posture + 14);
}

// tasks/hand_reorient.py::reorient_residual (Shadow's 77 entries,
// Allegro's 45): the cube against a site and a hold offset, the goal
// (mocap body 0's quaternion, normalized with the norm clamped at 1e-24
// inside the root) against the cube's orientation as 2 sign(w)
// vec(qcube^-1 qgoal), the cube's linear velocity, the actuator forces, the
// hand's nhand angles (first in qpos) against home and their velocities.
// res_int = (cube qpos address, cube dof address, nhand); sites = (the
// site); res_float = (the hold offset (3), the home keyframe's hand angles)
template <class T, class S>
__device__ void residual_reorient(const MRModelT<T, S>& m,
                                  const StepOut<T, S>& o, const T* qpos,
                                  const T* qvel, const T* mocap_quat,
                                  T* res) {
  const T* cube = qpos + m.res_int[0];
  const T* cube_vel = qvel + m.res_int[1];
  const int nhand = m.res_int[2];
  const T* hold = m.res_float;
  const T* home = m.res_float + 3;
  for (int i = 0; i < 3; ++i)
    res[i] = (cube[i] - o.site_xpos[0][i]) - hold[i];
  T ss = 0.0f;
  for (int i = 0; i < 4; ++i) ss += mocap_quat[i] * mocap_quat[i];
  const T nrm = r_sqrt(r_max(ss, T(1e-24)));
  T goal[4], dq[4];
  for (int i = 0; i < 4; ++i) goal[i] = mocap_quat[i] / nrm;
  const T conj[4] = {cube[3], -cube[4], -cube[5], -cube[6]};
  quat_mul(conj, goal, dq);
  const T sg = dq[0] < 0.0f ? T(-2) : T(2);  // shortest path
  for (int i = 0; i < 3; ++i) res[3 + i] = dq[1 + i] * sg;
  for (int i = 0; i < 3; ++i) res[6 + i] = cube_vel[i];
  for (int u = 0; u < m.nu; ++u) res[9 + u] = o.act_force[u];
  T* hand = res + 9 + m.nu;
  for (int i = 0; i < nhand; ++i) hand[i] = qpos[i] - home[i];
  for (int i = 0; i < nhand; ++i) hand[nhand + i] = qvel[i];
}

// tasks/bimanual.py::_finger_normal: the mean normal finger -> box over
// the slot's contact points within 2 cm of touching (sign: the pair's
// stored order), normalized with the norm clamped at 1e-24 inside the root
// and floored at 1e-9; false where there is none
template <class T, class S>
__device__ bool finger_normal(const StepOut<T, S>& o, int start, int count,
                              T sign, T* n) {
  T avg[3] = {0.0f, 0.0f, 0.0f};
  for (int j = start; j < start + count; ++j) {
    const T on = o.con_dist[j] < T(0.02) ? T(1) : T(0);
    for (int i = 0; i < 3; ++i) avg[i] += (o.con_normal[j][i] * sign) * on;
  }
  const T nrm = r_sqrt(r_max(dot3(avg, avg), T(1e-24)));
  for (int i = 0; i < 3; ++i) n[i] = avg[i] / r_max(nrm, T(1e-9));
  return nrm > T(1e-9);
}

// tasks/bimanual.py::residual (26 entries): the box in each gripper site's
// frame with y and z doubled, the grasp quality (the geometric mean over
// hands of 0.5 (n_L . n_R + 1), 1 for a hand without contact on both
// fingers), box - target (mocap body 0), the 16 arm joint velocities.
// res_int = (box body, the four finger-box slots' first contact points,
// their point counts); res_float = their signs; sites = (left gripper,
// right gripper)
template <class T, class S>
__device__ void residual_handover(const MRModelT<T, S>& m,
                                  const StepOut<T, S>& o,
                                  const T* qvel, const T* mocap_pos,
                                  T* res) {
  const T* box = o.xpos[m.res_int[0]];
  for (int s = 0; s < 2; ++s) {
    const T* mat = o.site_xmat[s];
    T rel[3];
    for (int i = 0; i < 3; ++i) rel[i] = box[i] - o.site_xpos[s][i];
    for (int i = 0; i < 3; ++i) {
      T acc = 0.0f;
      for (int k = 0; k < 3; ++k) acc += mat[3 * k + i] * rel[k];
      res[3 * s + i] = i == 0 ? acc : 2.0f * acc;
    }
  }
  T quality = 1.0f;
  for (int side = 0; side < 2; ++side) {
    T n[2][3];
    bool has[2];
    for (int f = 0; f < 2; ++f) {
      const int slot = 2 * side + f;
      has[f] = finger_normal(o, m.res_int[1 + slot], m.res_int[5 + slot],
                             m.res_float[slot], n[f]);
    }
    const T hand = has[0] && has[1] ? 0.5f * (dot3(n[0], n[1]) + 1.0f)
                                    : T(1);
    quality = side == 0 ? hand : quality * hand;
  }
  res[6] = r_sqrt(r_max(quality, T(0)));
  for (int i = 0; i < 3; ++i) res[7 + i] = box[i] - mocap_pos[i];
  for (int i = 0; i < 16; ++i) res[10 + i] = qvel[i];
}

// the state itself, (qpos, qvel): the residual of small test models
template <class T, class S>
__device__ void residual_state(const MRModelT<T, S>& m, const T* qpos,
                               const T* qvel, T* res) {
  for (int i = 0; i < m.nq; ++i) res[i] = qpos[i];
  for (int i = 0; i < m.nv; ++i) res[m.nq + i] = qvel[i];
}

// tasks/cartpole.py::residual (4 entries): cos(pole) - 1, cart - goal
// (rp[0], 0 where the task has none: the operand is then a zero), the
// pole's velocity, the control
template <class T>
__device__ void residual_cartpole(const T* qpos, const T* qvel,
                                  const T* ctrl, const T* rp, T* res) {
  res[0] = r_cos(qpos[1]) - 1.0f;
  res[1] = qpos[0] - rp[0];
  res[2] = qvel[1];
  res[3] = ctrl[0];
}

// tasks/acrobot.py::residual (4 entries): |tip - target| (sites 0 and 1),
// qvel[:2], ctrl[:1]
template <class T, class S>
__device__ void residual_acrobot(const StepOut<T, S>& o, const T* qvel,
                                 const T* ctrl, T* res) {
  T d[3];
  for (int i = 0; i < 3; ++i) d[i] = o.site_xpos[0][i] - o.site_xpos[1][i];
  res[0] = r_sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
  res[1] = qvel[0];
  res[2] = qvel[1];
  res[3] = ctrl[0];
}

// tasks/particle.py::residual (6 entries): the tip (site 0) less the goal
// (mocap body 0) in x and y, qvel[:2], ctrl[:2]
template <class T, class S>
__device__ void residual_particle(const StepOut<T, S>& o, const T* qvel,
                                  const T* ctrl, const T* mocap_pos,
                                  T* res) {
  for (int i = 0; i < 2; ++i) {
    res[i] = o.site_xpos[0][i] - mocap_pos[i];
    res[2 + i] = qvel[i];
    res[4 + i] = ctrl[i];
  }
}

// tasks/fingers.py::residual (7 entries): the spin rate less SpinGoal
// (rp[0]), each fingertip's planar distance to the paddle less 0.12, the
// controls. res_int = (spin dof, spinner body, f1_tip body, f2_tip body)
template <class T, class S>
__device__ void residual_fingers(const MRModelT<T, S>& m,
                                 const StepOut<T, S>& o, const T* qvel,
                                 const T* ctrl, const T* rp, T* res) {
  const T* paddle = o.xpos[m.res_int[1]];
  res[0] = qvel[m.res_int[0]] - rp[0];
  for (int f = 0; f < 2; ++f) {
    const T* tip = o.xpos[m.res_int[2 + f]];
    const T dx = tip[0] - paddle[0], dy = tip[1] - paddle[1];
    res[1 + f] = r_sqrt(dx * dx + dy * dy) - T(0.12);
  }
  for (int u = 0; u < m.nu; ++u) res[3 + u] = ctrl[u];
}

// tasks/arm_reach.py::residual (3 + nv + nu entries): the end effector
// (site 0) less the goal (mocap body 0), qvel, ctrl less the home
// keyframe's (res_float)
template <class T, class S>
__device__ void residual_arm_reach(const MRModelT<T, S>& m,
                                   const StepOut<T, S>& o, const T* qvel,
                                   const T* ctrl, const T* mocap_pos,
                                   T* res) {
  for (int i = 0; i < 3; ++i) res[i] = o.site_xpos[0][i] - mocap_pos[i];
  for (int k = 0; k < m.nv; ++k) res[3 + k] = qvel[k];
  for (int u = 0; u < m.nu; ++u) res[3 + m.nv + u] = ctrl[u] - m.res_float[u];
}

// tasks/push.py::residual (9 + nu entries): the box (res_int[0]) less the
// target (mocap body 0) in x and y, the end effector (site 0) less the
// box, qvel[:4], ctrl less the home keyframe's (res_float)
template <class T, class S>
__device__ void residual_push(const MRModelT<T, S>& m,
                              const StepOut<T, S>& o, const T* qvel,
                              const T* ctrl, const T* mocap_pos, T* res) {
  const T* box = o.xpos[m.res_int[0]];
  for (int i = 0; i < 2; ++i) res[i] = box[i] - mocap_pos[i];
  for (int i = 0; i < 3; ++i) res[2 + i] = o.site_xpos[0][i] - box[i];
  for (int k = 0; k < 4; ++k) res[5 + k] = qvel[k];
  for (int u = 0; u < m.nu; ++u) res[9 + u] = ctrl[u] - m.res_float[u];
}

// tasks/rubik.py::_faces_residual (18 entries): the six face angles less
// their targets (userdata[2:8]), the six face velocities, the controls
template <class T, class S>
__device__ void residual_rubik_faces(const MRModelT<T, S>& m, const T* qpos,
                                     const T* qvel, const T* ctrl,
                                     const T* ud, T* res) {
  for (int i = 0; i < 6; ++i) {
    res[i] = qpos[i] - ud[2 + i];
    res[6 + i] = qvel[i];
  }
  for (int u = 0; u < m.nu; ++u) res[12 + u] = ctrl[u];
}

// the norm of a planar vector
template <class T>
__device__ __forceinline__ T mr_norm2(T x, T y) {
  return r_sqrt(x * x + y * y);
}

// tasks/op3.py::residual (4 + nu + 7 + (nv - 6) entries): head over feet
// (Stand) or feet over hands (Handstand, userdata[MODE_SLOT] 1) less the
// goal (rp[0]); the planar distance of the torso subtree's centre of mass
// from the feet (hands); its planar velocity; ctrl less home; the torso's
// z axis (up, or down) and both feet's; the joint velocities past the free
// joint. res_int = (torso, right foot, left foot, right hand, left hand,
// torso subtree mask); res_float = (its mass, the home ctrl); sites =
// (head)
template <class T, class S>
__device__ void residual_op3(const MRModelT<T, S>& m, const StepOut<T, S>& o,
                             const T* qvel, const T* ctrl, const T* rp,
                             const T* ud, T* res) {
  const bool hand = ud_index(ud[MR_MODE_SLOT]) == 1;
  const int torso = m.res_int[0];
  const T* fr = o.xpos[m.res_int[1]];
  const T* fl = o.xpos[m.res_int[2]];
  const T* hr = o.xpos[m.res_int[3]];
  const T* hl = o.xpos[m.res_int[4]];
  T feet[3], hands[3];
  for (int i = 0; i < 3; ++i) {
    feet[i] = 0.5f * (fr[i] + fl[i]);
    hands[i] = 0.5f * (hr[i] + hl[i]);
  }
  res[0] = hand ? (feet[2] - hands[2]) - rp[0]
                : (o.site_xpos[0][2] - feet[2]) - rp[0];
  const T* com = o.subtree_com[torso];
  const T* sup = hand ? hands : feet;
  res[1] = mr_norm2(com[0] - sup[0], com[1] - sup[1]);
  T v[3];
  subtree_linvel(m, o, m.res_int[5], m.res_float[0], v);
  res[2] = v[0];
  res[3] = v[1];
  for (int u = 0; u < m.nu; ++u) res[4 + u] = ctrl[u] - m.res_float[1 + u];
  T* up = res + 4 + m.nu;
  const T sign = hand ? T(-1) : T(1);
  up[0] = o.xmat[torso][8] - sign;
  for (int f = 0; f < 2; ++f) {
    const T* mat = o.xmat[m.res_int[1 + f]];
    up[1 + 3 * f] = mat[2];
    up[2 + 3 * f] = mat[5];
    up[3 + 3 * f] = mat[8] - sign;
  }
  for (int k = 6; k < m.nv; ++k) up[7 + k - 6] = qvel[k];
}

// tasks/pick.py::residual (9 entries): the end effector less the box, box1
// less target1 and box2 less target2 (the target sites ride mocap body 0).
// res_int = (box body); sites = (eeff, box1, box2, target1, target2)
template <class T, class S>
__device__ void residual_pick(const MRModelT<T, S>& m, const StepOut<T, S>& o,
                              T* res) {
  const T* box = o.xpos[m.res_int[0]];
  for (int i = 0; i < 3; ++i) {
    res[i] = o.site_xpos[0][i] - box[i];
    res[3 + i] = o.site_xpos[1][i] - o.site_xpos[3][i];
    res[6 + i] = o.site_xpos[2][i] - o.site_xpos[4][i];
  }
}

// a box corner's world position: pos + mat (sign * half sizes), corner k
// of tasks/bring.py::_CORNERS (x outermost)
template <class T>
__device__ __forceinline__ void box_corner(const T* pos, const T* mat,
                                           const T* half, int k, T* c) {
  const T off[3] = {(k & 4 ? T(1) : T(-1)) * half[0],
                    (k & 2 ? T(1) : T(-1)) * half[1],
                    (k & 1 ? T(1) : T(-1)) * half[2]};
  for (int i = 0; i < 3; ++i)
    c[i] = pos[i] + ((mat[3 * i] * off[0] + mat[3 * i + 1] * off[1]) +
                     mat[3 * i + 2] * off[2]);
}

// tasks/bring.py::residual (20 entries): the gripper's centre (the two
// finger geoms' mean) less the box; each box corner's distance to the
// target's (a box of the object's size at mocap body 0); log10(1 + the sum
// of the palm-table points' force norms, from the step's converged rows);
// min(0, the gripper's height - 0.25); qvel[:7]. res_int = (object,
// target, the palm-table points' first row, their number, rows per point);
// res_float = (the object's half sizes); sites = (the finger geoms'
// centres)
template <class T, class S>
__device__ void residual_pick_and_place(const MRModelT<T, S>& m,
                                        const StepOut<T, S>& o,
                                        const T* qvel, T* res) {
  const int obj = m.res_int[0], tgt = m.res_int[1];
  T hand[3];
  for (int i = 0; i < 3; ++i) {
    hand[i] = 0.5f * (o.site_xpos[0][i] + o.site_xpos[1][i]);
    res[i] = hand[i] - o.xpos[obj][i];
  }
  for (int k = 0; k < 8; ++k) {
    T a[3], b[3];
    box_corner(o.xpos[obj], o.xmat[obj], m.res_float, k, a);
    box_corner(o.xpos[tgt], o.xmat[tgt], m.res_float, k, b);
    const T d0 = a[0] - b[0], d1 = a[1] - b[1], d2 = a[2] - b[2];
    res[3 + k] = r_sqrt((d0 * d0 + d1 * d1) + d2 * d2);
  }
  const int row0 = m.res_int[2], npt = m.res_int[3], nr = m.res_int[4];
  T total = 0.0f;
  for (int p = 0; p < npt; ++p) {
    const T* f = o.efc + row0 + nr * p;
    T ss = f[0] * f[0];
    for (int r = 1; r < nr; ++r) ss += f[r] * f[r];
    total += r_sqrt(ss);
  }
  res[11] = r_log10(total + 1.0f);
  res[12] = r_min(hand[2] - T(0.25), T(0));
  for (int k = 0; k < 7; ++k) res[13 + k] = qvel[k];
}

// tasks/bimanual_insert.py::reorient_residual (28 entries): the box in each
// gripper site's frame with y and z doubled, the goal (mocap body 0's
// quaternion, normalized with the norm clamped at 1e-24 inside the root)
// against the box's orientation as 2 sign(w) vec(qbox^-1 qgoal), box -
// goal position, the 16 arm joint velocities. res_int = (box body); sites
// = (left gripper, right gripper)
template <class T, class S>
__device__ void residual_bimanual_reorient(const MRModelT<T, S>& m,
                                           const StepOut<T, S>& o,
                                           const T* qvel,
                                           const T* mocap_pos,
                                           const T* mocap_quat, T* res) {
  const int box_body = m.res_int[0];
  const T* box = o.xpos[box_body];
  for (int s = 0; s < 2; ++s) {
    const T* mat = o.site_xmat[s];
    T rel[3];
    for (int i = 0; i < 3; ++i) rel[i] = box[i] - o.site_xpos[s][i];
    for (int i = 0; i < 3; ++i) {
      T acc = 0.0f;
      for (int k = 0; k < 3; ++k) acc += mat[3 * k + i] * rel[k];
      res[3 * s + i] = i == 0 ? acc : 2.0f * acc;
    }
  }
  T ss = 0.0f;
  for (int i = 0; i < 4; ++i) ss += mocap_quat[i] * mocap_quat[i];
  const T nrm = r_sqrt(r_max(ss, T(1e-24)));
  T goal[4], dq[4];
  for (int i = 0; i < 4; ++i) goal[i] = mocap_quat[i] / nrm;
  const T* q = o.xquat[box_body];
  const T conj[4] = {q[0], -q[1], -q[2], -q[3]};
  quat_mul(conj, goal, dq);
  const T sg = dq[0] < 0.0f ? T(-2) : T(2);
  for (int i = 0; i < 3; ++i) {
    res[6 + i] = dq[1 + i] * sg;
    res[9 + i] = box[i] - mocap_pos[i];
  }
  for (int k = 0; k < 16; ++k) res[12 + k] = qvel[k];
}

// tasks/humanoid_interact.py::residual (13 + nu entries): |z_zz - 1| of
// torso, pelvis (0 in Sit, userdata[MODE_SLOT] 0), right and left foot;
// |head height - the mode's (rp[0] Sit, rp[1] Stand)|; the planar distance
// of the knees' and of the torso subtree's centre of mass from the feet's;
// the torso's planar heading against the direction to the chair; the
// subtree's planar velocity; pelvis - seat site - 0.08 z; ctrl less home.
// res_int = (torso, pelvis, right foot, left foot, right shin, left shin,
// chair, torso subtree mask); res_float = (its mass, the home ctrl); sites
// = (head, seat)
template <class T, class S>
__device__ void residual_humanoid_interact(const MRModelT<T, S>& m,
                                           const StepOut<T, S>& o,
                                           const T* ctrl, const T* rp,
                                           const T* ud, T* res) {
  const bool sit = ud_index(ud[MR_MODE_SLOT]) == 0;
  const int torso = m.res_int[0], pelvis = m.res_int[1];
  const T* fr = o.xpos[m.res_int[2]];
  const T* fl = o.xpos[m.res_int[3]];
  const T* kr = o.xpos[m.res_int[4]];
  const T* kl = o.xpos[m.res_int[5]];
  res[0] = r_abs(o.xmat[torso][8] - 1.0f);
  res[1] = sit ? T(0) : r_abs(o.xmat[pelvis][8] - 1.0f);
  res[2] = r_abs(o.xmat[m.res_int[2]][8] - 1.0f);
  res[3] = r_abs(o.xmat[m.res_int[3]][8] - 1.0f);
  res[4] = r_abs(o.site_xpos[0][2] - (sit ? rp[0] : rp[1]));
  T feet[2], knees[2];
  for (int i = 0; i < 2; ++i) {
    knees[i] = 0.5f * (kr[i] + kl[i]);
    feet[i] = 0.5f * (fr[i] + fl[i]);
  }
  res[5] = mr_norm2(knees[0] - feet[0], knees[1] - feet[1]);
  const T* com = o.subtree_com[torso];
  res[6] = mr_norm2(com[0] - feet[0], com[1] - feet[1]);
  const T* mat = o.xmat[torso];
  const T fn = r_max(mr_norm2(mat[0], mat[3]), T(1e-9));
  const T* chair = o.xpos[m.res_int[6]];
  const T c0 = chair[0] - o.xpos[torso][0], c1 = chair[1] - o.xpos[torso][1];
  const T cn = r_max(mr_norm2(c0, c1), T(1e-9));
  res[7] = mr_norm2(mat[0] / fn - c0 / cn, mat[3] / fn - c1 / cn);
  T v[3];
  subtree_linvel(m, o, m.res_int[7], m.res_float[0], v);
  res[8] = v[0];
  res[9] = v[1];
  for (int i = 0; i < 3; ++i)
    res[10 + i] = (o.xpos[pelvis][i] - o.site_xpos[1][i]) -
                  (i == 2 ? T(0.08) : T(0));
  for (int u = 0; u < m.nu; ++u) res[13 + u] = ctrl[u] - m.res_float[1 + u];
}

template <class T, class S>
__device__ __forceinline__ void residual(const MRModelT<T, S>& m,
                                         const StepOut<T, S>& o, const T* qpos,
                                         const T* qvel, const T* ctrl,
                                         T time, const T* rp, const T* ud,
                                         const T* mocap_pos,
                                         const T* mocap_quat, T* res) {
  if (m.res_id == MR_RES_WALKER)
    residual_walker(m, o, qpos, qvel, ctrl, time, rp, res);
  else if (m.res_id == MR_RES_HUMANOID)
    residual_humanoid(m, o, qpos, qvel, ctrl, time, rp, res);
  else if (m.res_id == MR_RES_QUADRUPED)
    residual_quadruped(m, o, qpos, time, rp, ud, mocap_pos, res);
  else if (m.res_id == MR_RES_REORIENT)
    residual_reorient(m, o, qpos, qvel, mocap_quat, res);
  else if (m.res_id == MR_RES_STATE)
    residual_state(m, qpos, qvel, res);
  else if (m.res_id == MR_RES_HANDOVER)
    residual_handover(m, o, qvel, mocap_pos, res);
  else if (m.res_id == MR_RES_CARTPOLE)
    residual_cartpole(qpos, qvel, ctrl, rp, res);
  else if (m.res_id == MR_RES_ACROBOT)
    residual_acrobot(o, qvel, ctrl, res);
  else if (m.res_id == MR_RES_PARTICLE)
    residual_particle(o, qvel, ctrl, mocap_pos, res);
  else if (m.res_id == MR_RES_FINGERS)
    residual_fingers(m, o, qvel, ctrl, rp, res);
  else if (m.res_id == MR_RES_ARM_REACH)
    residual_arm_reach(m, o, qvel, ctrl, mocap_pos, res);
  else if (m.res_id == MR_RES_PUSH)
    residual_push(m, o, qvel, ctrl, mocap_pos, res);
  else if (m.res_id == MR_RES_RUBIK_FACES)
    residual_rubik_faces(m, qpos, qvel, ctrl, ud, res);
  else if (m.res_id == MR_RES_OP3)
    residual_op3(m, o, qvel, ctrl, rp, ud, res);
  else if (m.res_id == MR_RES_PICK)
    residual_pick(m, o, res);
  else if (m.res_id == MR_RES_PICK_AND_PLACE)
    residual_pick_and_place(m, o, qvel, res);
  else if (m.res_id == MR_RES_BIMANUAL_REORIENT)
    residual_bimanual_reorient(m, o, qvel, mocap_pos, mocap_quat, res);
  else if (m.res_id == MR_RES_HUMANOID_INTERACT)
    residual_humanoid_interact(m, o, ctrl, rp, ud, res);
}

// the task's state-dependent cost weight multipliers (Task.weight_mod);
// false for a task without them
template <class T, class S>
__device__ __forceinline__ bool weight_mod(const MRModelT<T, S>& m,
                                           const T* ud, T* scale) {
  if (m.res_id == MR_RES_QUADRUPED) {
    weight_mod_quadruped(ud, scale);
    return true;
  }
  if (m.res_id != MR_RES_PICK_AND_PLACE &&
      m.res_id != MR_RES_HUMANOID_INTERACT)
    return false;
  for (int k = 0; k < m.nterm; ++k) scale[k] = 1.0f;
  if (m.res_id == MR_RES_PICK_AND_PLACE) {
    // tasks/bring.py::weight_mod: Reach 1 - phase, Away phase (userdata[0])
    scale[0] = 1.0f - ud[0];
    scale[3] = ud[0];
  } else {
    // tasks/humanoid_interact.py::weight_mod: in Sit the seat term on and
    // the feet-placement terms off, in Stand the other way
    const T sit = ud_index(ud[MR_MODE_SLOT]) == 0 ? T(1) : T(0);
    scale[9] = sit;
    scale[5] = 1.0f - sit;
    scale[6] = 1.0f - sit;
  }
  return true;
}

template <class T>
__device__ T norm_value(int type, const T* x, int n, T p,
                        T q) {
  T s = 0.0f;
  switch (type) {
    case -1:  // NULL
      return x[0];
    case 0:  // QUADRATIC
      for (int i = 0; i < n; ++i) s += x[i] * x[i];
      return 0.5f * s;
    case 1:  // L22
      for (int i = 0; i < n; ++i) s += x[i] * x[i];
      return r_pow(r_pow(s, q / 2) + r_pow(p, q), 1.0f / q) - p;
    case 2:  // L2
      for (int i = 0; i < n; ++i) s += x[i] * x[i];
      return r_sqrt(s + p * p) - p;
    case 3:  // COSH
      for (int i = 0; i < n; ++i) s += p * p * (r_cosh(x[i] / p) - 1.0f);
      return s;
    case 5:  // POWER_LOSS
      for (int i = 0; i < n; ++i) s += r_pow(r_abs(x[i]), p);
      return s;
    case 6:  // SMOOTH_ABS
      for (int i = 0; i < n; ++i) s += r_sqrt(x[i] * x[i] + p * p) - p;
      return s;
    case 7:  // SMOOTH_ABS2
      for (int i = 0; i < n; ++i)
        s += r_pow(r_pow(r_abs(x[i]), q) + r_pow(p, q), 1.0f / q) - p;
      return s;
    case 8: {  // RECTIFY: softplus when p > 0, relu otherwise
      if (p > 0.0f) {
        const T sp = r_max(p, T(1e-10));
        for (int i = 0; i < n; ++i) s += sp * r_log1p(r_exp(x[i] / sp));
      } else {
        for (int i = 0; i < n; ++i) s += r_max(x[i], 0.0f);
      }
      return s;
    }
  }
  return __int_as_float(0x7fc00000);  // unknown norm: NaN
}

// scale: the task's per-term weight multipliers, or nullptr
template <class T, class S>
__device__ T cost_value(const MRModelT<T, S>& m, const T* res,
                        const T* weights, const T* norm_params,
                        T risk, const T* scale) {
  T total = 0.0f;
  int shift = 0;
  for (int k = 0; k < m.nterm; ++k) {
    const T v = norm_value(m.term_norm[k], res + shift, m.term_dim[k],
                           norm_params[2 * k], norm_params[2 * k + 1]);
    T term = weights[k] * v;
    if (scale) term = term * scale[k];
    total += term;
    shift += m.term_dim[k];
  }
  const bool small = r_abs(risk) < T(1e-6);
  const T risky = (r_exp(risk * total) - 1.0f) / (small ? 1.0f : risk);
  return small ? total : risky;
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

// the rollout-constant operands, copied into the block's shared memory
template <class T>
struct Aux {
  T mocap_pos[MR_MAX_MOCAP * 3];
  T mocap_quat[MR_MAX_MOCAP * 4];
  T userdata[MR_MAX_USERDATA];
};

// A block's dynamic shared memory: the rollout-constant operands, the
// model's copy, then one slice of cand_bytes per warp for its
// candidate's working set (carve). A host build may define
// MR_DYNAMIC_SHARED as a static buffer.
#ifndef MR_DYNAMIC_SHARED
#define MR_DYNAMIC_SHARED(name) \
  extern __shared__ __align__(16) unsigned char name[]
#endif

template <class T, class S>
__host__ __device__ constexpr size_t head_bytes() {
  return (sizeof(Aux<T>) + sizeof(MRModelT<T, S>) + 15) & ~(size_t)15;
}

// the block's model, copied by all its threads first, then the operands
// (both end in __syncthreads)
template <class T, class S>
__device__ const MRModelT<T, S>& block_setup(
    const MRModelT<T, S>* __restrict__ model, unsigned char* smem,
    const T* __restrict__ mocap_pos, const T* __restrict__ mocap_quat,
    const T* __restrict__ userdata) {
  MRModelT<T, S>* copy =
      reinterpret_cast<MRModelT<T, S>*>(smem + sizeof(Aux<T>));
  const int* s = reinterpret_cast<const int*>(model);
  int* d = reinterpret_cast<int*>(copy);
  for (int i = threadIdx.x; i < (int)(sizeof(MRModelT<T, S>) / 4);
       i += blockDim.x)
    d[i] = s[i];
  __syncthreads();
  const MRModelT<T, S>& m = *copy;
  Aux<T>* aux = reinterpret_cast<Aux<T>*>(smem);
  for (int i = threadIdx.x; i < 3 * m.nmocap; i += blockDim.x)
    aux->mocap_pos[i] = mocap_pos[i];
  for (int i = threadIdx.x; i < 4 * m.nmocap; i += blockDim.x)
    aux->mocap_quat[i] = mocap_quat[i];
  for (int i = threadIdx.x; i < m.nuserdata; i += blockDim.x)
    aux->userdata[i] = userdata[i];
  __syncthreads();
  return m;
}

// the views of the candidate of this thread's warp, laid out by its lane 0
template <class T, class S, int L>
__device__ const Cand<T, S>& warp_cand(const MRModelT<T, S>& m,
                                       unsigned char* smem, int cand_bytes) {
  unsigned char* slice = smem + head_bytes<T, S>() +
                         (size_t)(threadIdx.x / L) * cand_bytes;
  Cand<T, S>& w = *reinterpret_cast<Cand<T, S>*>(slice);
  if (lane_id<L>() == 0) carve(m, slice, w);
  lane_sync<L>();
  return w;
}

// blocks of at most MR_MAX_WARPS warps; MR_MIN_BLOCKS of them per SM keep
// the registers at or below 128 a thread
#define MR_MAX_WARPS 2
#define MR_MIN_BLOCKS 8

template <class T, class S, int L>
__global__ void __launch_bounds__(MR_MAX_WARPS * 32, MR_MIN_BLOCKS)
mr_returns_kernel(
    const MRModelT<T, S>* __restrict__ model, const T* __restrict__ qpos0,
    const T* __restrict__ qvel0, const T* __restrict__ actions,
    const T* __restrict__ weights, const T* __restrict__ norm_params,
    const T* __restrict__ risk, const T* __restrict__ res_params,
    const T* __restrict__ t0, const T* __restrict__ mocap_pos,
    const T* __restrict__ mocap_quat, const T* __restrict__ userdata,
    T* __restrict__ out, int n, int horizon, int cand_bytes) {
  MR_DYNAMIC_SHARED(smem);
  const MRModelT<T, S>& m =
      block_setup(model, smem, mocap_pos, mocap_quat, userdata);
  const Aux<T>& aux = *reinterpret_cast<const Aux<T>*>(smem);
  const int lane = lane_id<L>();
  const int c = blockIdx.x * (blockDim.x / L) + threadIdx.x / L;
  if (c >= n) return;  // ragged edge: the whole warp
  const Cand<T, S>& w = warp_cand<T, S, L>(m, smem, cand_bytes);
  for (int k = lane; k < m.nq; k += L) w.qpos[k] = qpos0[k];
  for (int k = lane; k < m.nv; k += L) w.qvel[k] = qvel0[k];
  for (int r = lane; r < m.nrow; r += L) w.lam[r] = 0.0f;  // cold first step
  lane_sync<L>();
  const T rk = *risk, time0 = *t0;
  // state-dependent weights read userdata alone: once per rollout, on the
  // lane that scores
  T scale[MR_MAX_TERM];
  const bool scaled = lane == 0 && weight_mod(m, aux.userdata, scale);
  T total = 0.0f;
  MRProf prof;
  prof.start();
  for (int i = 0; i < horizon; ++i) {
    const T* u = actions + ((size_t)c * horizon + i) * m.nu;
    tile_step<T, S, L>(m, w, u, aux.mocap_pos, aux.mocap_quat, prof);
    if (lane == 0) {
      const T time = time0 + (T)(i + 1) * m.timestep;
      residual(m, w.out, w.qpos, w.qvel, u, time, res_params, aux.userdata,
               aux.mocap_pos, aux.mocap_quat, w.res);
      total += cost_value(m, w.res, weights, norm_params, rk,
                          scaled ? scale : nullptr);
    }
    prof.mark(9);
  }
  if (lane == 0) {
    total = total / horizon;
    out[c] = isfinite(total) ? total : MR_MAX_RETURN;
    prof.flush();
  }
}

template <class T, class S, int L>
__global__ void __launch_bounds__(MR_MAX_WARPS * 32, MR_MIN_BLOCKS)
mr_step_kernel(
    const MRModelT<T, S>* __restrict__ model, const T* __restrict__ qpos_in,
    const T* __restrict__ qvel_in, const T* __restrict__ ctrl,
    const T* __restrict__ lam_in, const T* __restrict__ mocap_pos,
    const T* __restrict__ mocap_quat, const T* __restrict__ userdata,
    T* __restrict__ qpos_out, T* __restrict__ qvel_out,
    T* __restrict__ lam_out, int b, int cand_bytes) {
  MR_DYNAMIC_SHARED(smem);
  const MRModelT<T, S>& m =
      block_setup(model, smem, mocap_pos, mocap_quat, userdata);
  const Aux<T>& aux = *reinterpret_cast<const Aux<T>*>(smem);
  const int lane = lane_id<L>();
  const int c = blockIdx.x * (blockDim.x / L) + threadIdx.x / L;
  if (c >= b) return;
  const Cand<T, S>& w = warp_cand<T, S, L>(m, smem, cand_bytes);
  for (int k = lane; k < m.nq; k += L) w.qpos[k] = qpos_in[c * m.nq + k];
  for (int k = lane; k < m.nv; k += L) w.qvel[k] = qvel_in[c * m.nv + k];
  for (int r = lane; r < m.nrow; r += L) w.lam[r] = lam_in[c * m.nrow + r];
  lane_sync<L>();
  MRProf prof;
  prof.start();
  tile_step<T, S, L>(m, w, ctrl + c * m.nu, aux.mocap_pos, aux.mocap_quat,
                     prof);
  for (int k = lane; k < m.nq; k += L) qpos_out[c * m.nq + k] = w.qpos[k];
  for (int k = lane; k < m.nv; k += L) qvel_out[c * m.nv + k] = w.qvel[k];
  for (int r = lane; r < m.nrow; r += L) lam_out[c * m.nrow + r] = w.lam[r];
}

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes): pointers are device pointers but
// model_host, the packed model's copy in host memory that sizes the launch;
// the stream is PyTorch's current stream; each entry returns a CUDA error
// code (the set-up's, else cudaGetLastError()). A library holds one tier
// and one precision: -DMR_TIER=0 the small tier, 1 the large; -DMR_DOUBLE=1
// double operands and MRModelT<double, tier>, else float.
// ---------------------------------------------------------------------------

// the largest dynamic shared memory a block may have on sm_90
#define MR_SMEM_MAX 232448

// A launch's shape: warps per block, blocks, bytes of a candidate's
// working set and of a block's shared memory
struct MRShape {
  int warps, blocks, cand_bytes, smem;
};

#define MR_MAX_DEVICES 64

// the current device and its SM count, read from the runtime once per
// device
static cudaError_t device_sms(int* dev, int* sms) {
  static int known[MR_MAX_DEVICES];
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev < 0 || *dev >= MR_MAX_DEVICES) return cudaErrorInvalidValue;
  if (known[*dev] == 0) {
    err = cudaDeviceGetAttribute(&known[*dev],
                                 cudaDevAttrMultiProcessorCount, *dev);
    if (err != cudaSuccess) return err;
  }
  *sms = known[*dev];
  return cudaSuccess;
}

// the dynamic shared bytes each device allows mr_returns_kernel (0) and
// mr_step_kernel (1) so far: the attribute is raised only for a block
// larger than any before
static int mr_smem_allowed[2][MR_MAX_DEVICES];
static std::mutex mr_smem_mutex;

// W = 2 where the model copy and two candidates' working sets fit a block
// and the launch has two candidates per SM (a block then carries one model
// copy for two), else 1
template <class T, class S, class K>
static cudaError_t launch_shape(K kernel, int which, const void* model_host,
                                int n, MRShape* g, int* sms) {
  Cand<T, S> views;
  const size_t cand =
      carve(*static_cast<const MRModelT<T, S>*>(model_host), nullptr, views);
  const size_t head = head_bytes<T, S>();
  if (head + cand > MR_SMEM_MAX) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = device_sms(&dev, sms);
  if (err != cudaSuccess) return err;
  const bool two = head + 2 * cand <= MR_SMEM_MAX && n >= 2 * *sms;
  g->warps = two ? 2 : 1;
  g->cand_bytes = (int)cand;
  g->smem = (int)(head + g->warps * cand);
  g->blocks = (n + g->warps - 1) / g->warps;
  std::lock_guard<std::mutex> hold(mr_smem_mutex);
  int& allowed = mr_smem_allowed[which][dev];
  if (g->smem > allowed) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g->smem);
    if (err == cudaSuccess) allowed = g->smem;
  }
  return err;
}

template <class T, class S>
static int model_layout(long long* offsets, int capacity) {
  typedef MRModelT<T, S> M;
  int i = 0;
#define MR_OFFSET(type, name, dims) \
  if (i < capacity) offsets[i] = (long long)offsetof(M, name); ++i;
  MR_MODEL_FIELDS(MR_OFFSET)
#undef MR_OFFSET
  return i;
}

template <class T, class S>
static int launch_returns(const void* model, const void* model_host,
                          const void* qpos0, const void* qvel0,
                          const void* actions, const void* weights,
                          const void* norm_params, const void* risk,
                          const void* res_params, const void* t0,
                          const void* mocap_pos, const void* mocap_quat,
                          const void* userdata, void* out, int n,
                          int horizon, void* stream) {
  if (n > 0) {
    MRShape g;
    int sms;
    const cudaError_t err = launch_shape<T, S>(
        mr_returns_kernel<T, S, MR_LANES>, 0, model_host, n, &g, &sms);
    if (err != cudaSuccess) return (int)err;
    mr_returns_kernel<T, S, MR_LANES>
        <<<g.blocks, 32 * g.warps, g.smem, (cudaStream_t)stream>>>(
        (const MRModelT<T, S>*)model, (const T*)qpos0, (const T*)qvel0,
        (const T*)actions, (const T*)weights, (const T*)norm_params,
        (const T*)risk, (const T*)res_params, (const T*)t0,
        (const T*)mocap_pos, (const T*)mocap_quat, (const T*)userdata,
        (T*)out, n, horizon, g.cand_bytes);
  }
  return (int)cudaGetLastError();
}

template <class T, class S>
static int launch_step(const void* model, const void* model_host,
                       const void* qpos, const void* qvel, const void* ctrl,
                       const void* lam, const void* mocap_pos,
                       const void* mocap_quat, const void* userdata,
                       void* qpos_out, void* qvel_out, void* lam_out, int b,
                       void* stream) {
  if (b > 0) {
    MRShape g;
    int sms;
    const cudaError_t err = launch_shape<T, S>(
        mr_step_kernel<T, S, MR_LANES>, 1, model_host, b, &g, &sms);
    if (err != cudaSuccess) return (int)err;
    mr_step_kernel<T, S, MR_LANES>
        <<<g.blocks, 32 * g.warps, g.smem, (cudaStream_t)stream>>>(
        (const MRModelT<T, S>*)model, (const T*)qpos, (const T*)qvel,
        (const T*)ctrl, (const T*)lam, (const T*)mocap_pos,
        (const T*)mocap_quat, (const T*)userdata, (T*)qpos_out,
        (T*)qvel_out, (T*)lam_out, b, g.cand_bytes);
  }
  return (int)cudaGetLastError();
}

#ifndef MR_TIER
#define MR_TIER 0
#endif
#if MR_TIER == 0
typedef MRSmall MRTier;
#else
typedef MRLarge MRTier;
#endif
#if defined(MR_DOUBLE) && MR_DOUBLE
typedef double MRScalar;
#else
typedef float MRScalar;
#endif

extern "C" int mr_model_layout(long long* offsets, int capacity) {
  return model_layout<MRScalar, MRTier>(offsets, capacity);
}

// the phase counters of a profiling build (MR_NPHASE, copied to out, then
// zeroed if reset); 0 in any other build, a negative CUDA error on failure
extern "C" int mr_profile(unsigned long long* out, int reset) {
#if defined(MR_PROFILE) && MR_PROFILE
  cudaError_t err = cudaMemcpyFromSymbol(out, mr_phase_cycles,
                                         sizeof(mr_phase_cycles));
  if (err == cudaSuccess && reset) {
    unsigned long long zero[MR_NPHASE] = {};
    err = cudaMemcpyToSymbol(mr_phase_cycles, zero, sizeof(zero));
  }
  return err == cudaSuccess ? MR_NPHASE : -(int)err;
#else
  (void)out; (void)reset;
  return 0;
#endif
}

extern "C" long long mr_model_size() {
  return (long long)sizeof(MRModelT<MRScalar, MRTier>);
}

// the geometry of mr_returns (step 0) or mr_step (1) for n candidates:
// out = warps per block, blocks, candidate bytes, block shared bytes,
// blocks resident per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// SMs in use (computed from the launch: min(blocks, SMs)); a report, off
// the launch path
template <class T, class S, class K>
static int geometry(K kernel, int which, const void* model_host, int n,
                    int* out) {
  MRShape g = {};
  int sms = 0, resident = 0;
  cudaError_t err = launch_shape<T, S>(kernel, which, model_host, n, &g,
                                       &sms);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, kernel, 32 * g.warps, g.smem);
  const int v[6] = {g.warps, g.blocks, g.cand_bytes, g.smem, resident,
                    g.blocks < sms ? g.blocks : sms};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return (int)err;
}

extern "C" int mr_geometry(const void* model_host, int n, int step,
                           int* out) {
  return step ? geometry<MRScalar, MRTier>(
                    mr_step_kernel<MRScalar, MRTier, MR_LANES>, 1,
                    model_host, n, out)
              : geometry<MRScalar, MRTier>(
                    mr_returns_kernel<MRScalar, MRTier, MR_LANES>, 0,
                    model_host, n, out);
}

extern "C" int mr_returns(
    const void* model, const void* model_host, const void* qpos0,
    const void* qvel0, const void* actions, const void* weights,
    const void* norm_params, const void* risk, const void* res_params,
    const void* t0, const void* mocap_pos, const void* mocap_quat,
    const void* userdata, void* out, int n, int horizon, void* stream) {
  return launch_returns<MRScalar, MRTier>(
      model, model_host, qpos0, qvel0, actions, weights, norm_params, risk,
      res_params, t0, mocap_pos, mocap_quat, userdata, out, n, horizon,
      stream);
}

extern "C" int mr_step(const void* model, const void* model_host,
                       const void* qpos, const void* qvel, const void* ctrl,
                       const void* lam, const void* mocap_pos,
                       const void* mocap_quat, const void* userdata,
                       void* qpos_out, void* qvel_out, void* lam_out, int b,
                       void* stream) {
  return launch_step<MRScalar, MRTier>(model, model_host, qpos, qvel, ctrl,
                                       lam, mocap_pos, mocap_quat, userdata,
                                       qpos_out, qvel_out, lam_out, b,
                                       stream);
}
