"""The port's iLQG pieces held against the JAX package in float64 on the
CPU: boxQP, the tangent-space maps, the transition Jacobians and whole
optimize calls (the norms' derivatives: tests/test_torch_norms.py).

Inputs are made from numpy seeds. Tolerances, with the errors measured
when they were set:
  boxqp on random PSD problems with active bounds: atol 1e-10 (measured
    8e-17), the free masks exactly;
  local_diff and retract on Humanoid Walk probe states: atol 1e-12
    (measured 1.1e-16);
  the Walker's A and B along a nominal against JAX jacfwd (jitted once:
    eager, its first call takes 40 s here): atol 1e-10 of each matrix's
    max (measured 2.7e-16 of it);
  the Humanoid's against central differences of the port's own step
    (eps 1e-6): 1e-5 of each Jacobian's max (measured 2e-7). JAX's
    Humanoid jacfwd is kept out of this file: compiling it takes minutes.
    Central differences also see what JAX's cannot: JAX's quaternion
    exponential map is the constant identity at a zero angle, so its
    Jacobians have no rotation columns there (the port's is the
    first-order map, physics/math.py::quat_integrate);
  ILQGPlanner.optimize on Particle at horizon 10 from qpos (0.2, -0.2)
    (tests/test_planners.py's start), 2 iterations: xs, us, gains, reg and
    the line-search returns at rtol 1e-9, atol 1e-12 (measured 3e-16), the
    same winner; the action (linear and zero-order feedback) at 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mujoco_mpc_torch.estimators import base as tbase
from mujoco_mpc_torch.physics import io as tio
from mujoco_mpc_torch.physics import step as tstep
from mujoco_mpc_torch.planners import ilqg as til
from mujoco_mpc_torch.tasks import humanoid as thum
from mujoco_mpc_tpu.estimators import base as jest
from mujoco_mpc_tpu.physics import io as jio
from mujoco_mpc_tpu.planners import ilqg as jil
from tests import torch_engine_cases as cases
from tests.torch_cases import one_torch_thread
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

F64 = torch.float64

def test_boxqp_matches_jax():
  rng = np.random.RandomState(7)
  n, b = 5, 16
  a = rng.randn(b, n, n)
  quu = a @ a.transpose(0, 2, 1) + 0.1 * np.eye(n)
  qu = 3.0 * rng.randn(b, n)
  lo = -rng.uniform(0.05, 0.5, (b, n))
  hi = rng.uniform(0.05, 0.5, (b, n))
  want = jax.jit(jax.vmap(jil.boxqp))(*map(jnp.asarray, (quu, qu, lo, hi)))
  got = til.boxqp(*map(torch.tensor, (quu, qu, lo, hi)))
  np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-10)
  np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
  # the bounds bind: some controls are clamped, some free
  assert 0 < int((got[1] == 0).sum()) < n * b


def test_local_diff_and_retract_match_jax():
  t, j = cases.pair("Humanoid Walk")
  m = t.model
  qp, qv, _ = thum.probe_states(m, 4)
  qa = qp.T.astype(np.float64)
  rng = np.random.RandomState(3)
  dq = rng.uniform(-0.4, 0.4, (4, m.nv))
  qb = np.stack([np.asarray(jest.retract(j.model, jnp.asarray(q),
                                         jnp.asarray(d)))
                 for q, d in zip(qa, dq)])
  got_b = tbase.retract(m, torch.tensor(qa), torch.tensor(dq))
  np.testing.assert_allclose(got_b.numpy(), qb, atol=1e-12)
  want = np.stack([np.asarray(jest.local_diff(j.model, jnp.asarray(x),
                                              jnp.asarray(y)))
                   for x, y in zip(qb, qa)])
  got = tbase.local_diff(m, torch.tensor(qb), torch.tensor(qa))
  np.testing.assert_allclose(got.numpy(), want, atol=1e-12)
  np.testing.assert_allclose(got.numpy(), dq, atol=1e-9)  # inverse maps
  assert tbase.tangent_dim(m) == jest.tangent_dim(j.model)


def _nominal(task, horizon, seed):
  """A nominal (xs (T+1, nq+nv), us (T, nu), ts (T,)) from home under
  random controls, through the port's step, and the start Data."""
  m = task.model
  q, v, _ = m.keyframe("home")
  d = tio.make_data(m).replace(qpos=torch.tensor(q, dtype=F64),
                               qvel=torch.tensor(v, dtype=F64))
  lo, hi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
  us = lo + (hi - lo) * torch.tensor(
      np.random.RandomState(seed).uniform(0.1, 0.9, (horizon, m.nu)))
  xs, dd = [torch.cat([d.qpos, d.qvel])], d
  for i in range(horizon):
    dd = tstep.step(m, dd.replace(ctrl=us[i]))
    xs.append(torch.cat([dd.qpos, dd.qvel]))
  ts = d.time + m.opt.timestep * torch.arange(horizon, dtype=F64)
  return torch.stack(xs), us, ts, d


def test_walker_jacobians_match_jax():
  t, j = cases.pair("Walker")
  m, jm = t.model, j.model
  nx = 2 * m.nv
  xs, us, ts, d = _nominal(t, 2, 0)
  with one_torch_thread():
    a, b = til.ILQGPlanner(til.ILQGConfig(horizon=2)).jacobians(t, d, xs, us,
                                                                ts)
  jp = jil.ILQGPlanner(jil.ILQGConfig(horizon=2))
  jd = jio.make_data(jm)

  def f(dxu, x, x_next, u, tt):
    xf = jp._apply_tangent(jm, x, dxu[:nx])
    return jp._tangent(jm, jp._step_xu(j, jd, xf, u + dxu[nx:], tt), x_next)

  jac = jax.jit(jax.jacfwd(f))  # compiled once, called at each state
  got = torch.cat([a, b], dim=-1).numpy()
  for k in range(2):
    want = np.asarray(jac(jnp.zeros(nx + jm.nu), *(
        jnp.asarray(v.numpy()) for v in (xs[k], xs[k + 1], us[k], ts[k]))))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got[k], want, atol=1e-10 * scale)


@one_torch_thread()
def test_humanoid_jacobians_match_central_differences():
  t = cases.pair("Humanoid Walk")[0]
  m = t.model
  nx, eps = 2 * m.nv, 1e-6
  xs, us, ts, d = _nominal(t, 2, 1)
  a, b = til.ILQGPlanner(til.ILQGConfig(horizon=2)).jacobians(t, d, xs, us,
                                                              ts)
  got = torch.cat([a, b], dim=-1)
  for k in range(2):
    def f(dxu):
      xf = til.apply_tangent(m, xs[k], dxu[:nx])
      dd = tstep.step(m, d.replace(qpos=xf[:m.nq], qvel=xf[m.nq:],
                                   ctrl=us[k] + dxu[nx:], time=ts[k]))
      return til.tangent(m, torch.cat([dd.qpos, dd.qvel]), xs[k + 1])

    e = eps * torch.eye(nx + m.nu, dtype=F64)
    cd = torch.stack([(f(e[i]) - f(-e[i])) / (2 * eps)
                      for i in range(nx + m.nu)], dim=-1)
    scale = float(got[k].abs().max())
    assert float((cd - got[k]).abs().max()) <= 1e-5 * scale
    # the root's rotation columns carry the derivative
    assert float(got[k][:, 3:6].abs().max()) > 1e-3 * scale


@one_torch_thread()
def test_ilqg_optimize_and_action_match_jax():
  t, j = cases.pair("Particle")
  start = [0.2, -0.2]
  td = tio.make_data(t.model).replace(qpos=torch.tensor(start, dtype=F64))
  jd = jio.make_data(j.model).replace(qpos=jnp.asarray(start))
  for interp in ("linear", "zero"):
    cfg = dict(horizon=10, interp=interp)
    tp, jp = til.ILQGPlanner(til.ILQGConfig(**cfg)), jil.ILQGPlanner(
        jil.ILQGConfig(**cfg))
    tpol, jpol = tp.init(t), jp.init(j)
    if interp == "linear":
      opt = jax.jit(jp.optimize)
      for _ in range(2):
        tpol, ti = tp.optimize(t, tpol, td, None)
        jpol, ji = opt(j, jpol, jd, jax.random.PRNGKey(0))
        for f in ("xs", "us", "gains", "reg"):
          np.testing.assert_allclose(getattr(tpol, f).numpy(),
                                     np.asarray(getattr(jpol, f)), rtol=1e-9,
                                     atol=1e-12, err_msg=f)
        np.testing.assert_allclose(ti.costs.numpy(), np.asarray(ji.costs),
                                   rtol=1e-9, atol=1e-12)
        assert int(ti.winner) == int(ji.winner)
      assert float(tpol.gains.abs().max()) > 0
      linear = (tpol, jpol)
    else:  # the zero-order hold on the same feedback policy
      tpol = linear[0]
      jpol = linear[1]
    for time, qpos in ((0.013, [0.21, -0.18]), (0.05, [0.15, -0.1])):
      dd = td.replace(time=torch.tensor(time, dtype=F64),
                      qpos=torch.tensor(qpos, dtype=F64))
      jdd = jd.replace(time=jnp.asarray(time), qpos=jnp.asarray(qpos))
      np.testing.assert_allclose(tp.action(t, tpol, dd).numpy(),
                                 np.asarray(jp.action(j, jpol, jdd)),
                                 rtol=1e-12, atol=1e-12)
