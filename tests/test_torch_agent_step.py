"""The closed loop: the Agent's step, steps, total_cost, cost_terms and
best_trajectory, held against the JAX package in float64 on the CPU (the
tasks' transitions that step runs: tests/test_torch_transitions.py).

The Agent runs Particle (its goal transition) in both packages under the
same spline policy. The Ornstein-Uhlenbeck control noise of Agent.step is
held against numpy on injected standard normals (the packages' random
generators differ).

Tolerances, with the errors measured when they were set:
  Agent.step and steps(n) states, total_cost, cost_terms, best_trajectory:
    rtol 1e-9, atol 1e-10 (measured 3e-16);
  the control noise against numpy: atol 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.agent.agent import Agent as JaxAgent
from mujoco_mpc_torch.agent.agent import Agent
from tests import torch_engine_cases as cases
from tests.torch_engine_cases import release_jax_executables  # noqa: F401


@pytest.fixture(scope="module")
def agents():
  """The port's and JAX's Agent on Particle in float64, under the same
  random spline policy and state."""
  t, j = cases.pair("Particle")
  ours = Agent(t, device="cpu", horizon_steps=8)
  theirs = JaxAgent(j, horizon_steps=8)
  rng = np.random.RandomState(4)
  values = rng.uniform(-1, 1, tuple(ours.policy.values.shape))
  ours.policy = ours.policy.replace(
      times=torch.tensor(np.asarray(theirs.policy.times)),
      values=torch.tensor(values))
  theirs.policy = theirs.policy.replace(values=jnp.asarray(values))
  for a in (ours, theirs):
    a.set_state(qpos=[0.1, -0.05], qvel=[0.2, 0.0], time=0.7)
  return ours, theirs


def test_agent_step_and_steps_match_jax(agents):
  ours, theirs = agents
  for n in (1, 1, 3):
    if n == 1:
      d, jd = ours.step(), theirs.step()
    else:  # JAX's steps(n) is n step() calls fused into one dispatch
      d = ours.steps(n)
      for _ in range(n):
        jd = theirs.step()
    for f in ("qpos", "qvel", "time", "ctrl", "mocap_pos", "efc_lambda"):
      np.testing.assert_allclose(getattr(d, f).numpy(),
                                 np.asarray(getattr(jd, f)), rtol=1e-9,
                                 atol=1e-10, err_msg=f)
  assert float(d.time) > 0.7
  np.testing.assert_allclose(ours.total_cost(), theirs.total_cost(),
                             rtol=1e-9, atol=1e-10)
  got, want = ours.cost_terms(), theirs.cost_terms()
  assert list(got) == list(want)
  for k in got:
    np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-10)
  got, want = ours.best_trajectory(6), theirs.best_trajectory(6)
  for k in ("qpos", "costs", "total_return"):
    np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-10,
                               err_msg=k)


def test_agent_control_noise_and_previous_policy():
  """The OU recursion of Agent.step against numpy on injected normals;
  action(use_previous=True) reads the policy before the last plan."""
  t, _ = cases.pair("Particle")
  agent = Agent(t, device="cpu", horizon_steps=4)
  agent.reset()
  m = agent.sim_task.model
  scale = 0.5 * (m.actuator_ctrlrange[:, 1] -
                 m.actuator_ctrlrange[:, 0]).numpy()
  rng = np.random.RandomState(7)
  ou = np.zeros(m.nu)
  std, rate = 0.2, 0.3
  for _ in range(3):
    eps = rng.randn(m.nu)
    u = agent.action()
    d = agent.step(std, rate, eps=torch.tensor(eps))
    ou = (1 - rate) * ou + np.sqrt(rate * (2 - rate)) * std * scale * eps
    np.testing.assert_allclose(d.ctrl.numpy(), u + ou, atol=1e-12)
  before = agent.action()
  agent.planner_step()
  np.testing.assert_allclose(agent.action(use_previous=True), before,
                             atol=1e-12)
