"""The Agent's estimator API on the CPU: attach_estimator, step's inline
updates, estimated_state, planner_step(from_estimate=True), and the
estimation thread (start_estimation, stop_estimation), held against the
JAX Agent in float64 where JAX has the same call.

The Agents run Cartpole with MuJoCo's parent filter applied in both
packages (torch_cases.mujoco_filtered: the reference keeps a contact pair
between the pole and its cart whose force JAX takes from a rounding
residue), under the sampling planner, its standard normals drawn from
JAX's key and injected. The registered Cartpole measures only USER sensor
slots (cost-term placeholders, zero after forward): its Kalman filter's C
is zero and it runs on the prediction alone.

Tolerances, with the errors measured when they were set:
  estimated_state after 4 steps against the JAX Agent's: rtol 1e-9,
    atol 1e-12 (measured 0 in qpos, 1.4e-17 in qvel);
  the plan from the estimate: the same winner, the policy's values rtol
    1e-9, atol 1e-12 (measured 0), best_return rtol 1e-7 (measured
    4.3e-9: the port scores the candidates through the rollout kernel's
    plain version, the tile step, JAX through its general rollout, two
    engines that agree to that over the 20 steps);
  the estimation thread: its estimate against the same updates made in
    the test's thread, atol 1e-12 (measured 0).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_torch.agent.agent import Agent
from mujoco_mpc_torch.estimators import base as est_base
from mujoco_mpc_torch.estimators import get_estimator, kalman
from mujoco_mpc_torch.physics import io as phys_io
from mujoco_mpc_torch.physics import step as phys_step
from mujoco_mpc_torch.tasks import registry
from mujoco_mpc_tpu.agent.agent import Agent as JaxAgent
from mujoco_mpc_tpu.planners import sampling as jsampling
from tests import torch_engine_cases as cases
from tests.torch_cases import mujoco_filtered, one_torch_thread
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

HORIZON = 20


def _agents():
  """The port's and JAX's sampling Agents on the filtered Cartpole in
  float64, at qpos [0.2, 0.3], a Kalman filter attached to each."""
  t, j = cases.pair("Cartpole")
  t = t.replace(model=mujoco_filtered(t.model))
  j = j.replace(model=mujoco_filtered(j.model))
  ours = Agent(t, planner="sampling", device="cpu", horizon_steps=HORIZON)
  theirs = JaxAgent(j, planner="sampling", horizon_steps=HORIZON)
  for a in (ours, theirs):
    a.set_state(qpos=[0.2, 0.3])
    a.attach_estimator("kalman")
  return ours, theirs


@one_torch_thread()
def test_agent_estimate_and_plan_from_it_match_jax():
  ours, theirs = _agents()
  assert ours._estimator.ns == theirs._estimator.ns == 4
  for _ in range(4):
    ours.step()
    theirs.step()
  got, want = ours.estimated_state(), theirs.estimated_state()
  for k in ("qpos", "qvel", "act"):
    np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-12,
                               err_msg=k)
  # the measurement updates saw nothing: the estimate is the sim state
  np.testing.assert_allclose(got["qpos"], ours.data.qpos.numpy(),
                             rtol=1e-9, atol=1e-12)
  # a plan from the estimate, JAX's draws injected into the port's
  key = jax.random.split(theirs._rng)[1]
  rng_n, rng_b = jax.random.split(key)
  cfg = ours.planner.config
  n, k, nu = cfg.num_trajectories, cfg.spline_points, 1
  noise = np.asarray(jax.random.normal(rng_n, (n - 1, k, nu),
                                       dtype=jnp.float64))
  use2 = np.asarray(jax.random.bernoulli(rng_b, jsampling._STD2_PROPORTION,
                                         (n - 1,)))
  ours.set_state(qpos=[0.25, 0.3])  # the estimate no longer the sim's
  theirs.set_state(qpos=[0.25, 0.3])
  info = ours.planner_step(from_estimate=True, noise=torch.tensor(noise),
                           use2=torch.tensor(use2))
  jinfo = theirs.planner_step(from_estimate=True)
  assert int(info.winner) == int(jinfo.winner)
  np.testing.assert_allclose(float(info.best_return),
                             float(jinfo.best_return), rtol=1e-7)
  np.testing.assert_allclose(ours.policy.values.numpy(),
                             np.asarray(theirs.policy.values), rtol=1e-9,
                             atol=1e-12)
  # planning from the sim state instead gives another plan
  base_info = ours.planner_step(noise=torch.tensor(noise),
                                use2=torch.tensor(use2))
  assert float(base_info.best_return) != float(info.best_return)


def _wait_updates(agent, n, timeout=30.0):
  deadline = time.time() + timeout
  while agent.estimator_updates < n and time.time() < deadline:
    time.sleep(1e-3)
  assert agent.estimator_updates == n


@one_torch_thread()
def test_estimation_thread_tracks_and_stops():
  """The thread takes up each published state once (the latest wins:
  states published meanwhile are skipped, so here each is taken up before
  the next step), the state it starts from included; its estimate equals
  the same updates made in the test's thread."""
  agent = Agent("Cartpole", planner="sampling", device="cpu",
                horizon_steps=HORIZON)
  with pytest.raises(RuntimeError, match="no estimator attached"):
    agent.planner_step(from_estimate=True)
  with pytest.raises(RuntimeError, match="no estimator attached"):
    agent.start_estimation()
  agent.set_state(qpos=[0.2, 0.3])
  agent.attach_estimator("kalman")
  agent.planner_step()
  est, m = agent._estimator, agent.sim_task.model

  def update(state, d):
    return est.update(state, d.ctrl, phys_step.forward(m, d).sensordata)

  want = update(est.init(agent.data), agent.data)
  agent.start_estimation()
  try:
    _wait_updates(agent, 1)
    for k in range(4):
      d = agent.step()
      want = update(want, d)
      _wait_updates(agent, k + 2)
    assert agent._est_thread.is_alive()
    got = agent.estimated_state()
    for i, f in enumerate(("qpos", "qvel")):
      np.testing.assert_allclose(got[f], est.state(want)[i].numpy(),
                                 rtol=0, atol=1e-12)
    assert np.abs(got["qpos"] - agent.data.qpos.numpy()).max() < 0.05
  finally:
    agent.stop_estimation()
  assert agent._est_thread is None
  # step() feeds the estimator inline again
  agent.step()
  assert agent.estimator_updates == 6
  assert np.isfinite(float(agent.planner_step(from_estimate=True)
                           .best_return))


@one_torch_thread()
def test_estimation_thread_error_surfaces():
  """An update that raises ends the thread; its error comes back at
  estimated_state or stop_estimation, once."""
  agent = Agent("Cartpole", planner="sampling", device="cpu",
                horizon_steps=HORIZON)
  agent.attach_estimator("kalman")

  def broken(state, ctrl, sensor):
    raise ValueError("broken update")

  agent._estimator.update = broken
  agent.start_estimation()
  agent.set_state(qpos=[0.1, 0.0])  # a new state for the thread
  agent._est_thread.join(timeout=30.0)
  assert not agent._est_thread.is_alive()
  with pytest.raises(RuntimeError, match="estimation thread failed") as e:
    agent.estimated_state()
  assert isinstance(e.value.__cause__, ValueError)
  agent.stop_estimation()  # raised once already


@pytest.mark.parametrize("name", ["ground_truth", "unscented", "batch"])
@one_torch_thread()
def test_every_registered_estimator_attaches(name):
  """Every registered estimator through attach_estimator, two steps and a
  plan from its estimate (the JAX Agent's ground_truth raises a
  TypeError: its GroundTruth takes no measurement slice)."""
  agent = Agent("Cartpole", planner="sampling", device="cpu",
                horizon_steps=HORIZON)
  agent.set_state(qpos=[0.2, 0.3])
  agent.attach_estimator(name)
  agent.steps(2)
  est = agent.estimated_state()
  assert all(np.all(np.isfinite(v)) for v in est.values())
  assert est["qpos"].shape == (2,) and est["act"].shape == (0,)
  assert np.isfinite(float(agent.planner_step(from_estimate=True)
                           .best_return))
  with pytest.raises(KeyError, match="unknown estimator 'mhe'"):
    agent.attach_estimator("mhe")


@one_torch_thread()
def test_service_inputs_measure_nothing():
  """The inputs of the JAX filter service's roundtrip test (its seed
  failure: the estimate 0.298 from the sim in Cartpole's qpos[0] after 40
  steps) through the port's Kalman in float32: the registered Cartpole's
  measurement is its four USER slots, zero after forward, so C is zero,
  the gain is zero and the filter runs open loop from make_data's qpos0,
  exactly as the ground-truth estimator does. The fault lies in the
  measurement the model offers, not in the service."""
  m = registry.get_task("Cartpole", device="cpu").model
  start, dim = est_base.measurement_slice(m)
  assert (start, dim) == (0, 4)
  filt = kalman.Kalman(m, sensor_start=start, nsensordata=dim)
  truth = get_estimator("ground_truth", m)
  st, gt = filt.init(), truth.init()
  d = phys_io.make_data(m).replace(qpos=torch.tensor([0.3, 0.2]))
  u = torch.tensor([0.1])
  for _ in range(5):
    d = phys_step.step(m, d.replace(ctrl=u))
    z = phys_step.forward(m, d).sensordata
    assert not z.any()
    _, cmat = filt.measurement_jacobian(st.data)
    assert not cmat.any()
    st, gt = filt.update(st, u, z), truth.update(gt, u, z)
    for f in ("qpos", "qvel"):
      np.testing.assert_array_equal(getattr(st.data, f).numpy(),
                                    getattr(gt.data, f).numpy())
  # open loop from qpos0, not the sim's start
  assert float(st.data.qpos[0]) != float(d.qpos[0])
