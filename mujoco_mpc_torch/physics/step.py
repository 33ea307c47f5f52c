"""The general physics pipeline: forward dynamics, integration, inverse
dynamics.

Counterpart of mujoco_mpc_tpu/physics/step.py (mj_forward, mj_step and
mj_inverse of the reference's rollout loop). It runs any model the engine
supports, one state or a batch in the leading dimensions, on the device
of its tensors. Every shape and branch comes from the model's static
structure: a step reads nothing back to the host (no .item(), no boolean
masks, no branch on a tensor's value), so the same launches run for any
state.

`step` returns a Data whose derived fields (kinematics, forces, contacts)
belong to the state the step started from, and whose qpos, qvel, act and
time are the next state's, as in the JAX package: a task's transition
reads the previous step's kinematics, and a residual reads the step's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mujoco_mpc_torch.ops import linalg
from mujoco_mpc_torch.physics import collision, dynamics, kinematics
from mujoco_mpc_torch.physics import math, sensors
from mujoco_mpc_torch.physics import solver as solver_mod
from mujoco_mpc_torch.physics.types import Data, JointType, Model


def _chol(m: Model, d: Data) -> torch.Tensor:
  """Cholesky factor of the implicit-damping inertia M + h diag(damping)
  (MuJoCo Euler's implicit damping at one factorization a step): one
  cholesky_ex launch and no error check (a host sync). JAX's factor
  floors each pivot at 1e-12 (ops/linalg.py::chol_factor); on these
  inertias the floor does not bind, the smallest pivot of every
  registered model's being at least 1e6 times it
  (tests/test_torch_linalg.py::test_inertia_pivots_stay_above_the_floor)."""
  dtype = d.qpos.dtype
  h = m.opt.timestep.to(dtype)
  return torch.linalg.cholesky_ex(
      d.qM + h * torch.diag(m.dof_damping.to(dtype)), check_errors=False).L


def _smooth(m: Model, d: Data, actuate: bool) -> Data:
  d = kinematics.kinematics(m, d)
  d = dynamics.com_pos(m, d)
  d, cdof_dot = dynamics.com_vel(m, d)
  ibody = dynamics.body_inertias(m, d)  # shared by CRB and RNE
  d = dynamics.crb(m, d, ibody)
  d = dynamics.rne(m, d, cdof_dot, ibody)
  d = dynamics.passive(m, d)
  return dynamics.actuation(m, d) if actuate else d


def forward(m: Model, d: Data, compute_sensors: bool = True) -> Data:
  """Position, velocity and acceleration stages: qacc, the contact set and
  forces, and (compute_sensors) sensordata."""
  d = _smooth(m, d, actuate=True)
  return _forward_acc(m, collision.collide(m, d), _chol(m, d),
                      dynamics.xfrc_accumulate(m, d), compute_sensors)


def _forward_acc(m: Model, d: Data, factor, xfrc,
                 compute_sensors: bool = True) -> Data:
  """forward's acceleration stage on actuated, collided data."""
  qfrc_smooth = (d.qfrc_passive + d.qfrc_actuator + d.qfrc_applied +
                 xfrc - d.qfrc_bias)
  d = d.replace(qLD=factor)
  qacc_smooth = linalg.chol_solve(factor, qfrc_smooth)
  d = solver_mod.solve(m, d, qacc_smooth, factor)
  d = d.replace(qacc=linalg.chol_solve(factor,
                                       qfrc_smooth + d.qfrc_constraint))
  return sensors.sensors(m, d) if compute_sensors else d


def _segments(m: Model):
  """The joints in qpos order, or None where a joint's coordinates are
  not contiguous from 0 (every MuJoCo model has them so)."""
  adr = 0
  for j in range(m.njnt):
    if m.jnt_qposadr[j] != adr:
      return None
    adr += {JointType.FREE: 7, JointType.BALL: 4}.get(m.jnt_type[j], 1)
  return tuple(range(m.njnt)) if adr == m.nq else None


def integrate_pos(m: Model, qpos: torch.Tensor, qvel: torch.Tensor,
                  dt) -> torch.Tensor:
  """qpos (+) qvel dt on the joints' manifolds (mj_integratePos): scalar
  joints add, quaternions take the exact exponential map."""
  if (all(jt in (JointType.HINGE, JointType.SLIDE) for jt in m.jnt_type)
      and m.nq == m.nv):
    return qpos + dt * qvel
  order = m.const("qpos_segments", lambda: _segments(m))
  if order is None:
    raise NotImplementedError("joints whose qpos addresses are not in "
                              "joint order")
  out = []
  for j in order:
    qadr, vadr = m.jnt_qposadr[j], m.jnt_dofadr[j]
    jt = m.jnt_type[j]
    if jt == JointType.FREE:
      out.append(qpos[..., qadr:qadr + 3] + dt * qvel[..., vadr:vadr + 3])
      out.append(math.quat_integrate(qpos[..., qadr + 3:qadr + 7],
                                     qvel[..., vadr + 3:vadr + 6], dt))
    elif jt == JointType.BALL:
      out.append(math.quat_integrate(qpos[..., qadr:qadr + 4],
                                     qvel[..., vadr:vadr + 3], dt))
    else:
      out.append(qpos[..., qadr:qadr + 1] + dt * qvel[..., vadr:vadr + 1])
  return torch.cat(out, dim=-1)


def step(m: Model, d: Data) -> Data:
  """One physics step: semi-implicit Euler with implicit joint damping,
  or classic RK4 where the model selects it (integrator 1). Sensors are
  not evaluated (forward does that)."""
  if m.opt.integrator == 1:
    return _step_rk4(m, d)
  d = forward(m, d, compute_sensors=False)
  h = m.opt.timestep.to(d.qpos.dtype)
  qvel = d.qvel + h * d.qacc
  act = d.act + h * d.act_dot if m.na else d.act
  qpos = integrate_pos(m, d.qpos, qvel, h)
  return d.replace(qpos=qpos, qvel=qvel, act=act, time=d.time + h)


def _step_rk4(m: Model, d: Data) -> Data:
  """Classic fourth-order Runge-Kutta on (qpos, qvel, act), positions
  through integrate_pos (mj_RungeKutta)."""
  h = m.opt.timestep.to(d.qpos.dtype)
  half = 0.5 * h

  def deriv(qpos, qvel, act, t):
    dd = forward(m, d.replace(qpos=qpos, qvel=qvel, act=act, time=t),
                 compute_sensors=False)
    return dd.qacc, dd.act_dot, dd

  def act_at(k, ad):
    return d.act + k * ad if m.na else d.act

  a1, ad1, d1 = deriv(d.qpos, d.qvel, d.act, d.time)
  q2 = integrate_pos(m, d.qpos, d.qvel, half)
  a2, ad2, _ = deriv(q2, d.qvel + half * a1, act_at(half, ad1),
                     d.time + half)
  q3 = integrate_pos(m, d.qpos, d.qvel + half * a1, half)
  a3, ad3, _ = deriv(q3, d.qvel + half * a2, act_at(half, ad2),
                     d.time + half)
  q4 = integrate_pos(m, d.qpos, d.qvel + half * a2, h)
  a4, ad4, _ = deriv(q4, d.qvel + h * a3, act_at(h, ad3), d.time + h)
  v_avg = (d.qvel + 2 * (d.qvel + half * a1) + 2 * (d.qvel + half * a2) +
           (d.qvel + h * a3)) / 6.0
  a_avg = (a1 + 2 * a2 + 2 * a3 + a4) / 6.0
  qpos = integrate_pos(m, d.qpos, v_avg, h)
  act = (d.act + h * (ad1 + 2 * ad2 + 2 * ad3 + ad4) / 6.0
         if m.na else d.act)
  # the derived fields of the step's start state
  return d1.replace(qpos=qpos, qvel=d.qvel + h * a_avg, act=act,
                    time=d.time + h)


def inverse(m: Model, d: Data) -> torch.Tensor:
  """Inverse dynamics: the applied force consistent with (qpos, qvel,
  qacc), M qacc + bias - passive - constraint (the direct optimizer's
  residual)."""
  qacc = d.qacc
  d = _smooth(m, d, actuate=False)
  return _inverse_force(m, collision.collide(m, d), qacc, _chol(m, d),
                        dynamics.xfrc_accumulate(m, d))


def _inverse_force(m: Model, d: Data, qacc, factor, xfrc) -> torch.Tensor:
  """inverse's force on smoothed (unactuated), collided data."""
  qfrc_smooth = d.qfrc_passive + d.qfrc_applied + xfrc - d.qfrc_bias
  qacc_smooth = linalg.chol_solve(factor, qfrc_smooth)
  d = solver_mod.solve(m, d, qacc_smooth, factor)
  return (torch.matmul(d.qM, qacc[..., None])[..., 0] + d.qfrc_bias -
          d.qfrc_passive - d.qfrc_constraint)


def forward_inverse(m: Model, d: Data) -> Tuple[Data, torch.Tensor]:
  """(forward(m, d), inverse(m, d)) with the stages they share computed
  once: the smooth dynamics (actuation last), the factor and the contact
  set; the two constraint solves (inverse's without actuation) apart."""
  qacc = d.qacc
  d = collision.collide(m, _smooth(m, d, actuate=False))
  factor = _chol(m, d)
  xfrc = dynamics.xfrc_accumulate(m, d)
  force = _inverse_force(m, d, qacc, factor, xfrc)
  return _forward_acc(m, dynamics.actuation(m, d), factor, xfrc), force
