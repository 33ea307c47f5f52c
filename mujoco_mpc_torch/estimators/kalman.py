"""Extended Kalman filter with forward-mode Jacobians.

Counterpart of mujoco_mpc_tpu/estimators/kalman.py (reference
mjpc/estimators/kalman.{h,cc}; algorithm docs/ESTIMATORS.md:18-60): a
measurement update with the sensor Jacobian C (kalman.cc:212), then a
prediction through the physics step with the transition Jacobian A
(kalman.cc:292), the covariance dense in the tangent space of the
configuration manifold (estimators/base.py). The reference takes both
Jacobians by finite differences and JAX by jacfwd; here each is one
forward-mode pass (torch.autograd.forward_ad) of the general engine over
nt = 2 nv + na states in the engine's leading batch, row j carrying the
unit tangent e_j, whose row 0 (dx = 0) is also the undisturbed pass: the
predicted measurement and the next mean state. An update reads nothing
back to the host.

The JAX package's retraction has no derivative at a zero rotation (its
quaternion integration is the identity there), so its C and A lose the
rotation columns of free and ball joints; the port's keeps them
(physics/math.py::quat_integrate), and its filter sees orientation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.autograd.forward_ad as fwAD

from mujoco_mpc_torch.estimators import base
from mujoco_mpc_torch.physics import io as phys_io
from mujoco_mpc_torch.physics import step as phys_step
from mujoco_mpc_torch.physics.types import Data, Model


@dataclasses.dataclass
class KalmanState:
  data: Data  # the mean state (qpos, qvel, act inside)
  cov: torch.Tensor  # (nt, nt) tangent-space covariance
  noise_process: torch.Tensor  # (nt,) process noise diagonal
  noise_sensor: torch.Tensor  # (ns,) measurement noise diagonal

  def replace(self, **kw) -> "KalmanState":
    return dataclasses.replace(self, **kw)


def inv_or_nan(a: torch.Tensor) -> torch.Tensor:
  """a^-1, NaN where a is singular (jnp.linalg.inv's answer is inf or
  NaN), without inv's host-synced error check."""
  out, info = torch.linalg.inv_ex(a, check_errors=False)
  return torch.where((info == 0)[..., None, None], out,
                     torch.full_like(out, float("nan")))


class Kalman:
  """EKF over (qpos, qvel, act) with sensordata measurements."""

  def __init__(self, model: Model, sensor_start: int = 0,
               nsensordata: Optional[int] = None):
    self.model = model
    self.sensor_start = sensor_start
    self.ns = (nsensordata if nsensordata is not None
               else model.nsensordata - sensor_start)

  def init(self, data: Optional[Data] = None, p0: float = 1e-2,
           q_process: float = 1e-4, r_sensor: float = 1e-3) -> KalmanState:
    m = self.model
    nt = base.tangent_dim(m)
    d = data if data is not None else phys_io.make_data(m)
    kw = {"dtype": d.qpos.dtype, "device": d.qpos.device}
    return KalmanState(
        data=d, cov=torch.eye(nt, **kw) * p0,
        noise_process=torch.full((nt,), q_process, **kw),
        noise_sensor=torch.full((self.ns,), r_sensor, **kw))

  # ------------------------------------------------------------ Jacobians
  def measurement_jacobian(self, d: Data):
    """(the predicted measurement (ns,), C (ns, nt)): the sensor slice of
    forward(d (+) dx) and its Jacobian in dx at dx = 0."""
    m = self.model
    a, b = self.sensor_start, self.sensor_start + self.ns
    with base.dual_level():
      dx = base.unit_tangents(base.tangent_dim(m), d.qpos)
      y = phys_step.forward(m, base.perturbed(m, d, dx)).sensordata[:, a:b]
      return fwAD.unpack_dual(y).primal[0], base.tangent_of(y).T

  def transition_jacobian(self, d: Data, ctrl: torch.Tensor):
    """(the next mean state: step(d) under ctrl, A (nt, nt)): the step of
    d (+) dx, taken back to the tangent about the undisturbed next state,
    and its Jacobian in dx at dx = 0."""
    m = self.model
    with base.dual_level():
      dx = base.unit_tangents(base.tangent_dim(m), d.qpos)
      d2 = phys_step.step(m, base.perturbed(m, d, dx, ctrl=ctrl))
      ref = base.primal_row(d2)
      parts = [base.local_diff(m, d2.qpos, ref.qpos), d2.qvel - ref.qvel]
      if m.na:
        parts.append(d2.act - ref.act)
      return ref, base.tangent_of(torch.cat(parts, dim=-1)).T

  # ------------------------------------------------------------------- API
  def update(self, state: KalmanState, ctrl: torch.Tensor,
             sensor: torch.Tensor) -> KalmanState:
    """The measurement update at the current time, then the prediction
    (UpdateMeasurement and UpdatePrediction, kalman.cc:212,292)."""
    m = self.model
    d = state.data
    nt = base.tangent_dim(m)
    # ---- measurement update
    y_pred, cmat = self.measurement_jacobian(d)
    s = cmat @ state.cov @ cmat.T + torch.diag(state.noise_sensor)
    innov = base.measured(sensor, m, self.sensor_start, self.ns) - y_pred
    gain = state.cov @ cmat.T @ inv_or_nan(s)
    qpos, qvel, act = base.pack_state(m, d.qpos, d.qvel, d.act,
                                      gain @ innov)
    d = d.replace(qpos=qpos, qvel=qvel, act=act)
    eye = torch.eye(nt, dtype=d.qpos.dtype, device=d.qpos.device)
    cov = (eye - gain @ cmat) @ state.cov
    cov = 0.5 * (cov + cov.T)
    # ---- prediction, from the updated mean
    ref_next, amat = self.transition_jacobian(d, ctrl)
    cov = amat @ cov @ amat.T + torch.diag(state.noise_process)
    cov = 0.5 * (cov + cov.T)
    return state.replace(data=ref_next, cov=cov)

  def state(self, s: KalmanState) -> Tuple[torch.Tensor, ...]:
    return s.data.qpos, s.data.qvel, s.data.act
