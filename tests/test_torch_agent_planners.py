"""The Agent with every planner on the CPU: all seven names build and plan,
Agent("Cartpole") plans with its own default (the gradient planner),
action(nominal=) against the JAX Agent, and the async plan loop.

Tolerances: the iLQG Agent's actions, with and without the feedback terms,
against the JAX Agent's on the same policy and state: rtol 1e-12, atol
1e-12 (measured 0).
"""

import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_torch.agent.agent import Agent
from mujoco_mpc_tpu.agent.agent import Agent as JaxAgent
from tests import torch_engine_cases as cases
from tests.torch_cases import one_torch_thread
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

PLANNERS = ("sampling", "gradient", "ilqg", "ilqs", "robust",
            "cross_entropy", "sample_gradient")
# the planners whose candidates go through MegaRollout
KERNEL_ROUTE = ("sampling", "ilqs", "robust", "cross_entropy",
                "sample_gradient")


@one_torch_thread()
def test_agent_plans_with_every_planner():
  for name in PLANNERS:
    agent = Agent("Walker", planner=name, device="cpu", horizon_steps=8)
    agent.reset("home")
    assert agent.planner_name == name
    assert (agent.planner.mega is not None) == (name in KERNEL_ROUTE), name
    info = agent.planner_step()
    assert np.isfinite(float(info.best_return)), name
    u = agent.action()
    lo, hi = agent.task.model.actuator_ctrlrange.numpy().T
    assert u.shape == (6,) and np.all(u >= lo) and np.all(u <= hi), name
    d = agent.step()
    assert bool(torch.all(torch.isfinite(d.qpos))), name


@one_torch_thread()
def test_cartpole_plans_with_its_default_planner():
  agent = Agent("Cartpole", device="cpu", horizon_steps=20)
  assert agent.planner_name == "gradient"  # its MJCF's agent_planner
  agent.reset("home")
  before = agent.best_trajectory()["total_return"]
  returns = [float(agent.planner_step().best_return) for _ in range(3)]
  assert all(np.isfinite(returns)) and returns[-1] <= before
  with pytest.raises(ValueError, match="unknown planner"):
    Agent("Cartpole", planner="mppi", device="cpu")


@one_torch_thread()
def test_action_nominal_matches_jax():
  t, j = cases.pair("Particle")
  ours = Agent(t, planner="ilqg", device="cpu", horizon_steps=6)
  theirs = JaxAgent(j, planner="ilqg", horizon_steps=6)
  rng = np.random.RandomState(5)
  gains = rng.uniform(-2, 2, tuple(ours.policy.gains.shape))
  us = rng.uniform(-0.5, 0.5, tuple(ours.policy.us.shape))
  ours.policy = ours.policy.replace(gains=torch.tensor(gains),
                                    us=torch.tensor(us))
  theirs.policy = theirs.policy.replace(gains=jnp.asarray(gains),
                                        us=jnp.asarray(us))
  for a in (ours, theirs):
    a.set_state(qpos=[0.1, -0.05], qvel=[0.2, 0.0], time=0.013)
  for nominal in (False, True):
    np.testing.assert_allclose(ours.action(nominal=nominal),
                               theirs.action(nominal=nominal), rtol=1e-12,
                               atol=1e-12)
  assert not np.allclose(ours.action(), ours.action(nominal=True))
  # a spline policy has no feedback terms: nominal changes nothing
  spline = Agent(t, device="cpu", horizon_steps=6)
  np.testing.assert_array_equal(spline.action(nominal=True), spline.action())


@one_torch_thread()
def test_start_and_stop_planning():
  """The plan thread publishes policies while the caller steps, with the
  interpreter switching threads every microsecond: no step is lost (the
  clock advances by exactly one timestep a step), and stop_planning ends
  the thread within its timeout."""
  agent = Agent("Particle", device="cpu", horizon_steps=10)
  agent.reset()
  dt = float(agent.sim_task.model.opt.timestep)
  interval = sys.getswitchinterval()
  sys.setswitchinterval(1e-6)
  try:
    agent.start_planning(rate_limit_hz=200.0)
    thread = agent._plan_thread
    assert thread is not None and thread.is_alive()
    first = agent.policy  # the plan made before the thread started
    for _ in range(20):
      agent.step()
    deadline = time.monotonic() + 60.0
    while agent.policy is first and time.monotonic() < deadline:
      thread.join(0.01)  # the loop publishes new policies
    assert agent.policy is not first
  finally:
    agent.stop_planning()
    sys.setswitchinterval(interval)
  thread.join(10.0)
  assert agent._plan_thread is None and not thread.is_alive()
  np.testing.assert_allclose(float(agent.data.time), 20 * dt, rtol=1e-6)
  agent.stop_planning()  # a second stop is a no-op
