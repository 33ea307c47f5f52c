"""Unscented Kalman filter with sigma points in the tangent space.

Counterpart of mujoco_mpc_tpu/estimators/unscented.py (reference
mjpc/estimators/unscented.cc): sigma points from the Cholesky factor of
the covariance (:293), a quaternion-aware state mean (:578) and the joint
measurement and prediction update (:484). The 2 nt + 1 sigma points are
retractions x (+) delta of the mean; they go through the physics step and
then forward (their sensors) as one batch of the general engine, and the
mean is the weighted tangent average about the central propagated point.
The reference evaluates the sigma points in a thread loop, JAX under vmap.
With the defaults alpha = 1 and beta = 2, lambda = 0: the central point
weighs 0 in the mean and 2 in the covariance. An update reads nothing back
to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from mujoco_mpc_torch.estimators import base
from mujoco_mpc_torch.estimators.kalman import inv_or_nan
from mujoco_mpc_torch.ops.band import cholesky_or_nan
from mujoco_mpc_torch.physics import io as phys_io
from mujoco_mpc_torch.physics import step as phys_step
from mujoco_mpc_torch.physics.types import Data, Model


@dataclasses.dataclass
class UnscentedState:
  data: Data
  cov: torch.Tensor  # (nt, nt)
  noise_process: torch.Tensor  # (nt,)
  noise_sensor: torch.Tensor  # (ns,)

  def replace(self, **kw) -> "UnscentedState":
    return dataclasses.replace(self, **kw)


class Unscented:
  def __init__(self, model: Model, sensor_start: int = 0,
               nsensordata: Optional[int] = None, alpha: float = 1.0,
               beta: float = 2.0):
    self.model = model
    self.sensor_start = sensor_start
    self.ns = (nsensordata if nsensordata is not None
               else model.nsensordata - sensor_start)
    self.alpha = alpha
    self.beta = beta

  def init(self, data: Optional[Data] = None, p0: float = 1e-2,
           q_process: float = 1e-4, r_sensor: float = 1e-3
           ) -> UnscentedState:
    m = self.model
    nt = base.tangent_dim(m)
    d = data if data is not None else phys_io.make_data(m)
    kw = {"dtype": d.qpos.dtype, "device": d.qpos.device}
    return UnscentedState(
        data=d, cov=torch.eye(nt, **kw) * p0,
        noise_process=torch.full((nt,), q_process, **kw),
        noise_sensor=torch.full((self.ns,), r_sensor, **kw))

  def _weights(self, nt: int, like: torch.Tensor):
    """(mean weights (2nt+1,), covariance weights (2nt+1,), lambda)."""
    lam = self.alpha ** 2 * nt - nt
    wm0 = lam / (nt + lam)
    wc0 = wm0 + (1 - self.alpha ** 2 + self.beta)
    wi = 1.0 / (2 * (nt + lam))
    rest = torch.full((2 * nt,), wi, dtype=like.dtype, device=like.device)
    wm = torch.cat([torch.full_like(rest[:1], wm0), rest])
    wc = torch.cat([torch.full_like(rest[:1], wc0), rest])
    return wm, wc, lam

  def update(self, state: UnscentedState, ctrl: torch.Tensor,
             sensor: torch.Tensor) -> UnscentedState:
    m = self.model
    d = state.data
    nt = base.tangent_dim(m)
    dtype, dev = d.qpos.dtype, d.qpos.device
    wm, wc, lam = self._weights(nt, d.qpos)
    # sigma displacements: 0 and the +- columns of chol((nt + lambda) P)
    scale = max(nt + lam, 1e-8) ** 0.5
    chol = cholesky_or_nan(
        state.cov + 1e-10 * torch.eye(nt, dtype=dtype, device=dev)) * scale
    deltas = torch.cat([torch.zeros((1, nt), dtype=dtype, device=dev),
                        chol.T, -chol.T])  # (2nt+1, nt)
    d2 = phys_step.step(m, base.perturbed(m, d, deltas, ctrl=ctrl))
    a, b = self.sensor_start, self.sensor_start + self.ns
    ys = phys_step.forward(m, d2).sensordata[:, a:b]
    qs, vs, accs = d2.qpos, d2.qvel, d2.act
    # the manifold mean about the central propagated point
    q0, v0, a0 = qs[0], vs[0], accs[0]
    parts = [base.local_diff(m, qs, q0), vs - v0]
    if m.na:
      parts.append(accs - a0)
    tx = torch.cat(parts, dim=-1)  # (2nt+1, nt)
    mean_t = torch.einsum("i,ij->j", wm, tx)
    qpos_m, qvel_m, act_m = base.pack_state(m, q0, v0, a0, mean_t)

    dxs = tx - mean_t[None]
    cov_x = (torch.einsum("i,ij,ik->jk", wc, dxs, dxs) +
             torch.diag(state.noise_process))
    y_mean = torch.einsum("i,ij->j", wm, ys)
    dys = ys - y_mean[None]
    cov_y = (torch.einsum("i,ij,ik->jk", wc, dys, dys) +
             torch.diag(state.noise_sensor))
    cov_xy = torch.einsum("i,ij,ik->jk", wc, dxs, dys)

    z = base.measured(sensor, m, self.sensor_start, self.ns)
    gain = cov_xy @ inv_or_nan(cov_y)
    qpos_f, qvel_f, act_f = base.pack_state(m, qpos_m, qvel_m, act_m,
                                            gain @ (z - y_mean))
    cov = cov_x - gain @ cov_y @ gain.T
    cov = 0.5 * (cov + cov.T)
    d_next = state.data.replace(qpos=qpos_f, qvel=qvel_f, act=act_f,
                                time=d.time + m.opt.timestep.to(dtype))
    return state.replace(data=d_next, cov=cov)

  def state(self, s: UnscentedState) -> Tuple[torch.Tensor, ...]:
    return s.data.qpos, s.data.qvel, s.data.act
