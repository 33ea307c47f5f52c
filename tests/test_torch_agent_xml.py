"""The rest of the Agent's constructor on the CPU: `dtype=` for a named
task, and `model_xml=` (a task on the model, cost spec and parameters of
an MJCF string, built with `mujoco`) in the Agent and in the agent
service's Init, held against the JAX Agent; where `mujoco` does not
import, model_xml is refused loudly, never planned on the registered
model.

The MJCF is Particle's registered model (tasks/dm_suite.py's spec,
written out) with its Position weight changed from 5 to 2.5. jax.random
and torch.Generator draw different numbers, so the port's first plan is
given JAX's candidate normals. Both score the candidates through the
general rollout, the JAX planner's route on the CPU.

Tolerances, with the errors measured when they were set: the first
plan's candidate returns and new policy against JAX's, rtol 1e-10, atol
1e-12 (measured 2.2e-16).
"""

import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_torch.agent.agent import Agent
from mujoco_mpc_torch.planners import sampling as tsa
from mujoco_mpc_torch.service import agent_service
from mujoco_mpc_torch.service import client as tclient
from mujoco_mpc_torch.tasks import dm_suite, registry
from mujoco_mpc_tpu.agent.agent import Agent as JaxAgent
from tests.torch_cases import one_torch_thread
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

H = 10  # planning horizon (steps)
WEIGHT = 2.5  # the Position term's weight in the MJCF (5 registered)


def _particle_xml(monkeypatch):
  """Particle's registered model as MJCF, its Position weight WEIGHT."""
  specs = []
  with monkeypatch.context() as m:
    m.setattr(dm_suite, "compile_model", specs.append)
    dm_suite.build_particle()
  xml, n = re.subn(r'(name="Position" user="2 )5 ',
                   rf"\g<1>{WEIGHT} ", specs[0].to_xml())
  assert n == 1
  return xml


@one_torch_thread()
def test_model_xml_first_plan_matches_jax(monkeypatch):
  xml = _particle_xml(monkeypatch)
  ours = Agent("Particle", horizon_steps=H, dtype=torch.float64,
               model_xml=xml, device="cpu")
  theirs = JaxAgent("Particle", horizon_steps=H, dtype=jnp.float64,
                    model_xml=xml)
  assert float(ours.task.params.weights[0]) == WEIGHT
  assert ours.task.model.dtype == torch.float64
  # JAX's route on the CPU: the general rollout (the kernel's route rounds
  # the model's constants to float32, 8.6e-10 from JAX here)
  ours.planner = tsa.SamplingPlanner(ours.planner.config,
                                     use_megakernel=False)
  ours.policy = ours.planner.init(ours.task)
  for a in (ours, theirs):
    a.set_state(qpos=[0.2, -0.1], qvel=[0.05, 0.0], mocap_pos=[[0.1, 0.1,
                                                                0.01]])
  # the JAX Agent's first key and its sampling planner's normals
  key = jax.random.split(jax.random.PRNGKey(0))[1]
  rng_n = jax.random.split(key)[0]
  n, k = ours.planner.config.num_trajectories, 5
  noise = np.asarray(jax.random.normal(rng_n, (n - 1, k, 2),
                                       dtype=jnp.float64))
  got = ours.planner_step(noise=torch.tensor(noise),
                          use2=torch.zeros(n - 1, dtype=torch.bool))
  want = theirs.planner_step()
  np.testing.assert_allclose(got.costs.numpy(), np.asarray(want.costs),
                             rtol=1e-10, atol=1e-12)
  assert int(got.winner) == int(want.winner)
  for f in ("times", "values"):
    np.testing.assert_allclose(getattr(ours.policy, f).numpy(),
                               np.asarray(getattr(theirs.policy, f)),
                               rtol=1e-10, atol=1e-12, err_msg=f)
  # the registered model's weight would plan otherwise
  assert float(Agent("Particle", device="cpu").task.params.weights[0]) == 5


@one_torch_thread()
def test_dtype_sets_a_named_tasks_precision():
  for dtype in (torch.float32, torch.float64):
    agent = Agent("Particle", horizon_steps=H, dtype=dtype, device="cpu")
    assert agent.task.model.dtype == dtype
    assert agent.policy.values.dtype == dtype
    info = agent.planner_step()
    assert info.costs.dtype == dtype
    assert np.isfinite(float(info.best_return))


@one_torch_thread()
def test_service_init_takes_model_xml(monkeypatch):
  xml = _particle_xml(monkeypatch)
  servicer = agent_service.AgentServicer(device="cpu")
  server, port = agent_service.make_server(0, max_workers=1,
                                           servicer=servicer)
  try:
    with tclient.AgentClient("Particle", horizon_steps=H, port=port,
                             model_xml=xml) as c:
      assert np.isfinite(c.planner_step())
      assert float(servicer.agent.task.params.weights[0]) == WEIGHT
      assert c.get_cost_term_values()  # the spec's three terms
  finally:
    server.stop(None)


def test_model_xml_without_mujoco_is_refused(monkeypatch):
  """The Agent raises (the service's refusal: tests/test_torch_service.py)
  and never builds the registered model in its place."""
  xml = _particle_xml(monkeypatch)
  monkeypatch.setitem(sys.modules, "mujoco", None)  # import fails
  built = []
  monkeypatch.setattr(registry, "load_task_model",
                      lambda *a, **k: built.append(a))
  with pytest.raises(registry.ModelXmlRefused, match="snapshot"):
    Agent("Particle", model_xml=xml, device="cpu")
  assert built == []
