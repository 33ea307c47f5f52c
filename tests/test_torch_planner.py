"""The port's sampling planner and agent.

SamplingPlanner.optimize with injected numpy noise is held against the same
composition on the JAX side (spline.resample, noise, clamp,
spline.sample_many, MegaRollout.returns_xla, argmin): returns at rtol 2e-3
(the repo's tolerance between two implementations), the winner and its
spline values at atol 1e-6. jax.random and torch.Generator draw different
numbers, so parity is never held on seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_torch.agent.agent import Agent
from mujoco_mpc_torch.ops import megarollout
from mujoco_mpc_torch.ops import spline as tspline
from mujoco_mpc_torch.physics import io as tio
from mujoco_mpc_torch.planners import sampling as tsampling
from mujoco_mpc_torch.tasks import registry as treg
from mujoco_mpc_tpu.ops import megarollout as jmr
from mujoco_mpc_tpu.ops import spline as jspline
from mujoco_mpc_tpu.tasks import registry as jreg
from tests.torch_cases import one_torch_thread

T, N, K = 10, 8, 6


@pytest.fixture(scope="module")
def setup():
  t = treg.get_task("Walker", device="cpu")
  j = jreg.get_task("Walker", dtype=jnp.float32)
  jf = jax.jit(jmr.MegaRollout(j, T).returns_xla)
  return t, j, jf


@pytest.mark.parametrize("interp", list(tspline.Interp))
def test_optimize_matches_jax_composition(setup, interp):
  t, j, jf = setup
  rng = np.random.RandomState(int(interp))
  home = np.asarray(t.model.keyframe("home")[0], np.float32)
  time0 = np.float32(0.013)
  times = np.linspace(0.0, 0.03, K).astype(np.float32)
  values = rng.uniform(-0.5, 0.5, (K, 6)).astype(np.float32)
  noise = rng.randn(N - 1, K, 6).astype(np.float32)
  expl = np.float32(0.35)

  planner = tsampling.SamplingPlanner(tsampling.SamplingConfig(
      num_trajectories=N, spline_points=K, horizon=T, interp=interp))
  planner.init(t)
  data = tio.make_data(t.model).replace(qpos=torch.tensor(home),
                                        time=torch.tensor(time0))
  policy = tsampling.SamplingPolicy(
      times=torch.tensor(times), values=torch.tensor(values),
      exploration=torch.tensor(expl), exploration2=torch.tensor(0.0))
  new_policy, info = planner.optimize(
      t, policy, data, None, noise=torch.tensor(noise),
      use2=torch.zeros(N - 1, dtype=torch.bool))

  # the same iteration composed from the JAX package's parts
  m = j.model
  dt = m.opt.timestep
  ji = jspline.Interp(int(interp))
  denom = K if interp == tspline.Interp.ZERO else K - 1
  new_times = time0 + jnp.arange(K, dtype=jnp.float32) * (
      (T - 1) * dt / denom)
  nominal = jspline.resample(jnp.asarray(times), jnp.asarray(values),
                             new_times, ji)
  scale = 0.5 * (m.actuator_ctrlrange[:, 1] - m.actuator_ctrlrange[:, 0])
  cands = jnp.concatenate([nominal[None],
                           nominal[None] + noise * expl * scale])
  cands = jnp.clip(cands, m.actuator_ctrlrange[:, 0],
                   m.actuator_ctrlrange[:, 1])
  ts = time0 + jnp.arange(T, dtype=jnp.float32) * dt
  actions = jax.vmap(lambda v: jspline.sample_many(new_times, v, ts, ji))(
      cands)
  want = np.asarray(jf(jnp.asarray(home), jnp.zeros(9, jnp.float32),
                       actions, j.params, time0))

  np.testing.assert_allclose(info.costs.numpy(), want, rtol=2e-3)
  assert int(info.winner) == int(np.argmin(want))
  np.testing.assert_allclose(new_policy.times.numpy(),
                             np.asarray(new_times), atol=1e-6)
  np.testing.assert_allclose(new_policy.values.numpy(),
                             np.asarray(cands[int(np.argmin(want))]),
                             atol=1e-6)


def test_agent_walker_defaults():
  """The Agent plans the Walker at its XML defaults: 128 candidates over
  0.8 s at agent_timestep 0.01, i.e. 80 steps. Builds no rollout."""
  agent = Agent("Walker", device="cpu")
  assert agent.planner.config.num_trajectories == 128
  assert agent.planner.config.horizon == 80
  assert float(agent.task.model.opt.timestep) == pytest.approx(0.01)


@one_torch_thread()
def test_agent_cpu_best_return_does_not_increase():
  """Three plan iterations at a fixed state, over a horizon of 4 steps:
  candidate 0 is the previous winner, so the best return cannot rise."""
  agent = Agent("Walker", device="cpu", horizon_steps=4)
  agent.reset("home")
  assert agent.planner.config.num_trajectories == 128
  assert agent.planner.config.horizon == 4
  assert float(agent.task.model.opt.timestep) == pytest.approx(0.01)
  best = []
  for _ in range(3):
    info = agent.planner_step()
    assert info.costs.shape == (128,)
    assert bool(torch.all(torch.isfinite(info.costs)))
    best.append(float(info.best_return))
  assert best[1] <= best[0] and best[2] <= best[1]
  u = agent.action()
  assert u.shape == (6,) and np.all(np.isfinite(u))
  lo, hi = (agent.task.model.actuator_ctrlrange[:, i].numpy()
            for i in (0, 1))
  assert np.all(u >= lo) and np.all(u <= hi)
  assert agent.planner.mega.launches == 0  # CPU tensors: the plain version


def test_agent_cuda_without_card_raises():
  if torch.cuda.is_available():
    pytest.skip("this host has a CUDA device")
  with pytest.raises(RuntimeError, match="cuda"):
    Agent("Walker", device="cuda")


@pytest.mark.parametrize("entry", ["Agent", "get_task", "MegaRollout",
                                   "load_snapshot"])
def test_default_device_is_the_card(entry):
  """With no device given, the entry points run on the card: a host
  without one raises instead of planning on the CPU."""
  if torch.cuda.is_available():
    pytest.skip("this host has a CUDA device")
  calls = {
      "Agent": lambda: Agent("Walker"),
      "get_task": lambda: treg.get_task("Walker"),
      "MegaRollout": lambda: megarollout.MegaRollout(
          treg.get_task("Walker", device="cpu"), 4),
      "load_snapshot": lambda: tio.load_snapshot(
          treg.snapshot_path("walker")),
  }
  with pytest.raises(RuntimeError, match="cuda"):
    calls[entry]()


def test_other_planners_are_not_ported():
  with pytest.raises(NotImplementedError, match="ROADMAP"):
    Agent("Walker", planner="ilqg", device="cpu")
