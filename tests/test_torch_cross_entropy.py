"""The port's cross-entropy (CEM) planner held against the JAX package.

CrossEntropyPlanner's candidates, from the same standard normals (drawn
with jax.random.normal and injected as `noise`), against JAX
_gen_candidates: atol 1e-6 (measured 0). The elite update from the same
returns against JAX's top_k / mean / variance / std_min: the elite indices
exactly, mean and std atol 1e-6 (measured 0). A full optimize on the
Walker against the JAX composition (its _gen_candidates, the rollout that
returns_xla runs, taken eagerly, and the elite update): returns rtol 2e-3
(the repo's tolerance between two implementations; measured 8.2e-8), the
winner exactly, the new policy atol 1e-5 (measured 0). Returns without
near-ties where the order matters: tie order in top_k is not a parity
target.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_torch.agent.agent import Agent
from mujoco_mpc_torch.physics import io as tio
from mujoco_mpc_torch.planners import cross_entropy as tcem
from mujoco_mpc_torch.tasks import registry as treg
from mujoco_mpc_tpu.ops import spline as jspline
from mujoco_mpc_tpu.physics import io as jio
from mujoco_mpc_tpu.physics import tilestep as jts
from mujoco_mpc_tpu.planners import cross_entropy as jcem
from mujoco_mpc_tpu.tasks import registry as jreg
from tests.test_torch_tilestep_classes import jax_returns
from tests.torch_cases import one_torch_thread

N, K, T, ELITE = 16, 5, 4, 4


@pytest.fixture(scope="module")
def setup():
  t = treg.get_task("Walker", device="cpu")
  j = jreg.get_task("Walker", dtype=jnp.float32)
  cfg = dict(num_trajectories=N, n_elite=ELITE, spline_points=K, horizon=T,
             std_min=0.05, std_initial=0.3)
  tp = tcem.CrossEntropyPlanner(tcem.CEMConfig(**cfg))
  tp.init(t)
  jp = jcem.CrossEntropyPlanner(jcem.CEMConfig(**cfg), use_megakernel=False)
  return t, j, tp, jp


def _state(t, j, seed):
  """The same policy (times, values, std) and state in both packages, and
  the JAX key whose standard normals both use."""
  rng = np.random.RandomState(seed)
  home = np.asarray(t.model.keyframe("home")[0], np.float32)
  time0 = np.float32(0.021)
  times = np.linspace(0.0, 0.04, K).astype(np.float32)
  values = rng.uniform(-0.5, 0.5, (K, 6)).astype(np.float32)
  std = rng.uniform(0.05, 0.4, (K, 6)).astype(np.float32)
  tpol = tcem.CEMPolicy(torch.tensor(times), torch.tensor(values),
                        torch.tensor(std))
  jpol = jcem.CEMPolicy(jnp.asarray(times), jnp.asarray(values),
                        jnp.asarray(std))
  tdata = tio.make_data(t.model).replace(qpos=torch.tensor(home),
                                         time=torch.tensor(time0))
  jdata = jio.make_data(j.model).replace(qpos=jnp.asarray(home),
                                         time=jnp.float32(time0))
  return tpol, jpol, tdata, jdata, jax.random.PRNGKey(seed)


def _jax_noise(key):
  return np.asarray(jax.random.normal(key, (N - 1, K, 6), dtype=jnp.float32))


def test_cem_init_matches_jax(setup):
  t, j, tp, jp = setup
  ours, theirs = tp.init(t), jp.init(j)
  for f in ("times", "values", "std"):
    np.testing.assert_allclose(getattr(ours, f).numpy(),
                               np.asarray(getattr(theirs, f)), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_cem_candidates_match_jax(setup, seed):
  t, j, tp, jp = setup
  tpol, jpol, tdata, jdata, key = _state(t, j, seed)
  got = tp._gen_candidates(t, tpol, tdata, None,
                           noise=torch.tensor(_jax_noise(key)))
  want = jp._gen_candidates(j, jpol, jdata, key)
  for name, a, b in zip(("new_times", "nominal", "candidates"), got, want):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                               err_msg=name)


def test_cem_elite_update_matches_jax():
  rng = np.random.RandomState(7)
  cands = rng.randn(N, K, 6).astype(np.float32)
  returns = rng.permutation(N).astype(np.float32) * 0.5 + 1.0  # no ties
  idx, mean, std = tcem.elite_update(torch.tensor(cands),
                                     torch.tensor(returns), ELITE, 0.3)
  _, jidx = jax.lax.top_k(-jnp.asarray(returns), ELITE)
  elites = jnp.asarray(cands)[jidx]
  jmean = jnp.mean(elites, axis=0)
  jvar = jnp.sum((elites - jmean[None]) ** 2, axis=0) / max(ELITE - 1, 1)
  jstd = jnp.maximum(jnp.sqrt(jvar), 0.3)
  np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
  np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-6)
  np.testing.assert_allclose(std.numpy(), np.asarray(jstd), atol=1e-6)
  assert float(std.min()) >= 0.3  # the floor binds somewhere
  assert float(std.min()) == pytest.approx(0.3)


def test_cem_optimize_matches_jax_composition(setup):
  """One CEM iteration on the Walker: candidates, returns, elite update."""
  t, j, tp, jp = setup
  tpol, jpol, tdata, jdata, key = _state(t, j, 3)
  new_policy, info = tp.optimize(t, tpol, tdata, None,
                                 noise=torch.tensor(_jax_noise(key)))
  new_times, _, cands = jp._gen_candidates(j, jpol, jdata, key)
  ts = jdata.time + jnp.arange(T, dtype=jnp.float32) * j.model.opt.timestep
  actions = jax.vmap(lambda v: jspline.sample_many(
      new_times, v, ts, jp.config.interp))(cands)
  want = jax_returns(j, jts.extract(j.model), np.asarray(jdata.qpos),
                     np.asarray(jdata.qvel), np.asarray(actions),
                     float(jdata.time))
  _, jidx = jax.lax.top_k(-jnp.asarray(want), ELITE)
  elites = cands[jidx]
  jmean = jnp.mean(elites, axis=0)
  jstd = jnp.maximum(jnp.sqrt(jnp.sum((elites - jmean[None]) ** 2, axis=0)
                              / (ELITE - 1)), jp.config.std_min)
  np.testing.assert_allclose(info.costs.numpy(), want, rtol=2e-3)
  # no near-tie where the order matters: the winner, and the last elite
  order = np.sort(want)
  assert order[1] - order[0] > 1e-4 * order[0]
  assert order[ELITE] - order[ELITE - 1] > 1e-4 * order[ELITE]
  assert int(info.winner) == int(jidx[0])
  np.testing.assert_allclose(new_policy.times.numpy(), np.asarray(new_times),
                             atol=1e-6)
  np.testing.assert_allclose(new_policy.values.numpy(), np.asarray(jmean),
                             atol=1e-5)
  np.testing.assert_allclose(new_policy.std.numpy(), np.asarray(jstd),
                             atol=1e-5)


@one_torch_thread()
def test_agent_cross_entropy_plans_on_cpu():
  """Agent(planner="cross_entropy") at the Walker's candidate count, over 4
  steps: finite costs, the std at or above std_min, the plain version on
  CPU tensors."""
  agent = Agent("Walker", planner="cross_entropy", device="cpu",
                horizon_steps=4)
  assert isinstance(agent.planner, tcem.CrossEntropyPlanner)
  cfg = agent.planner.config
  assert (cfg.num_trajectories, cfg.n_elite) == (128, 12)
  agent.reset("home")
  for _ in range(2):
    info = agent.planner_step()
    assert info.costs.shape == (128,)
    assert bool(torch.all(torch.isfinite(info.costs)))
    assert float(info.best_return) == float(info.costs.min())
  assert float(agent.policy.std.min()) >= cfg.std_min
  u = agent.action()
  assert u.shape == (6,) and np.all(np.isfinite(u))
  assert agent.planner.mega.launches == 0  # CPU tensors: the plain version
