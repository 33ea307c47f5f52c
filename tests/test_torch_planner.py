"""The port's sampling and cross-entropy planners, the agent, and the CPU
MegaRollout.returns, on the Walker, held against the JAX package.

Every JAX rollout here is the Walker's MegaRollout.returns_xla at T = 10
steps over N = 8 candidates (which tests/test_megarollout.py pins to the
interpret-mode Pallas kernel), jitted once a session: compiling it takes
about half a minute on a CPU, so one worker computes every JAX return the
tests compare with, on their fixed inputs, and the session's workers
share them (jax_refs; tests/torch_engine_cases.py::session_result).

SamplingPlanner.optimize with injected numpy noise is held against the same
composition on the JAX side (spline.resample, noise, clamp,
spline.sample_many, MegaRollout.returns_xla, argmin): returns at rtol 2e-3
(the repo's tolerance between two implementations), the winner and its
spline values at atol 1e-6. jax.random and torch.Generator draw different
numbers, so parity is never held on seeds.

The port's CPU MegaRollout.returns against returns_xla on the same float32
inputs: rtol 2e-3, measured 2.4e-7 at T=10, n=8.

CrossEntropyPlanner's candidates, from the same standard normals (drawn
with jax.random.normal and injected as `noise`), against JAX
_gen_candidates: atol 1e-6 (measured 0). The elite update from the same
returns against JAX's top_k / mean / variance / std_min: the elite indices
exactly, mean and std atol 1e-6 (measured 0). A full optimize on the
Walker against the JAX composition (its _gen_candidates, returns_xla and
the elite update): returns rtol 2e-3 (measured 8.2e-8), the winner
exactly, the new policy atol 1e-5 (measured 0). Returns without
near-ties where the order matters: tie order in top_k is not a parity
target.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_torch.agent.agent import Agent
from mujoco_mpc_torch.ops import megarollout
from mujoco_mpc_torch.ops import megarollout as tmr
from mujoco_mpc_torch.ops import spline as tspline
from mujoco_mpc_torch.physics import io as tio
from mujoco_mpc_torch.planners import cross_entropy as tcem
from mujoco_mpc_torch.planners import sampling as tsampling
from mujoco_mpc_torch.tasks import registry as treg
from mujoco_mpc_tpu.ops import megarollout as jmr
from mujoco_mpc_tpu.ops import spline as jspline
from mujoco_mpc_tpu.physics import io as jio
from mujoco_mpc_tpu.planners import cross_entropy as jcem
from mujoco_mpc_tpu.tasks import registry as jreg
from tests.torch_cases import one_torch_thread
from tests.torch_engine_cases import release_jax_executables  # noqa: F401
from tests.torch_engine_cases import session_result

T, N, K = 10, 8, 6


@pytest.fixture(scope="module")
def setup():
  return (treg.get_task("Walker", device="cpu"),
          jreg.get_task("Walker", dtype=jnp.float32))


def _acts():
  """The returns checks' N candidates' actions (N, T, 6)."""
  return (0.4 * np.random.RandomState(0).randn(N, T, 6)).astype(np.float32)


def _jax_references():
  """Every JAX result the module's returns and optimize checks compare
  with, on their fixed inputs, from one jitted returns_xla: the returns of
  _acts (with the Walker's parameters, with Speed 2.0, and with
  candidate 0 exploding), and for each spline interpolation the sampling
  iteration's composition (_sampling_composition), and the CEM
  iteration's (_cem_composition); numpy throughout."""
  j = jreg.get_task("Walker", dtype=jnp.float32)
  jf = jax.jit(jmr.MegaRollout(j, T).returns_xla)
  home = jnp.asarray(np.asarray(j.model.keyframe("home")[0], np.float32))
  zero, acts = jnp.zeros(9, jnp.float32), _acts()
  bad = acts.copy()
  bad[0] = 1e30

  def returns(actions, params, qpos=home, qvel=zero, t0=np.float32(0.0)):
    return np.asarray(jf(qpos, qvel, jnp.asarray(actions), params, t0))

  refs = {"returns": returns(acts, j.params),
          "divergence": returns(bad, j.params),
          "speed": returns(acts, j.set_parameter("Speed", 2.0).params)}
  for interp in tspline.Interp:
    new_times, cands, actions, time0 = _sampling_composition(j, interp)
    refs[f"sampling_{int(interp)}"] = (
        np.asarray(new_times), np.asarray(cands),
        returns(actions, j.params, t0=time0))
  new_times, cands, actions, jdata = _cem_composition(j)
  refs["cem"] = (np.asarray(new_times), np.asarray(cands),
                 returns(actions, j.params, jdata.qpos, jdata.qvel,
                         jdata.time))
  return refs


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
  return session_result(tmp_path_factory, "planner_walker",
                        _jax_references)


# ------------------------------------------------ CPU MegaRollout.returns


@pytest.fixture(scope="module")
def rollouts(setup):
  t, j = setup
  home = np.asarray(t.model.keyframe("home")[0], np.float32)

  def torch_returns(actions, params):
    return tmr.MegaRollout(t, T, device="cpu").returns(
        torch.tensor(home), torch.zeros(9), torch.tensor(actions), params,
        torch.tensor(0.0)).numpy()

  return t, _acts(), torch_returns


def test_returns_match_jax_returns_xla(rollouts, jax_refs):
  t, acts, torch_returns = rollouts
  got = torch_returns(acts, t.params)
  np.testing.assert_allclose(got, jax_refs["returns"], rtol=2e-3)
  assert np.all(np.isfinite(got)) and np.all(got < tmr.MAX_RETURN)


def test_divergence_guard(rollouts, jax_refs):
  """Exploding actions -> MAX_RETURN in both packages, not nan."""
  t, acts, torch_returns = rollouts
  bad = acts.copy()
  bad[0] = 1e30
  got = torch_returns(bad, t.params)
  want = jax_refs["divergence"]
  assert got[0] == tmr.MAX_RETURN == want[0]
  np.testing.assert_allclose(got, want, rtol=2e-3)


def test_params_are_runtime_tunable(rollouts, jax_refs):
  """Changing weights and residual params changes returns, no rebuild."""
  t, acts, torch_returns = rollouts
  mr = tmr.MegaRollout(t, T, device="cpu")
  args = (torch.tensor(np.asarray(t.model.keyframe("home")[0], np.float32)),
          torch.zeros(9), torch.tensor(acts))
  r1 = mr.returns(*args, t.params, 0.0).numpy()
  heavier = t.params.replace(weights=t.params.weights * 3.0)
  r2 = mr.returns(*args, heavier, 0.0).numpy()
  np.testing.assert_allclose(r2, 3.0 * r1, rtol=1e-5)
  faster = t.set_parameter("Speed", 2.0).params
  r3 = mr.returns(*args, faster, 0.0).numpy()
  assert not np.allclose(r1, r3)
  np.testing.assert_allclose(r3, jax_refs["speed"], rtol=2e-3)


# ----------------------------------------------------- the sampling planner


def _sampling_inputs(interp):
  """The sampling iteration's start: (home, time0, the policy's times and
  values, the noise, the exploration) for the interpolation `interp`."""
  rng = np.random.RandomState(int(interp))
  home = np.asarray(tio.load_snapshot(treg.snapshot_path("walker"),
                                      device="cpu")[0].keyframe("home")[0],
                    np.float32)
  times = np.linspace(0.0, 0.03, K).astype(np.float32)
  values = rng.uniform(-0.5, 0.5, (K, 6)).astype(np.float32)
  noise = rng.randn(N - 1, K, 6).astype(np.float32)
  return home, np.float32(0.013), times, values, noise, np.float32(0.35)


def _sampling_composition(j, interp):
  """The sampling iteration on _sampling_inputs composed from the JAX
  package's parts (spline.resample, noise, clamp, spline.sample_many):
  (new_times, candidates, their actions, time0)."""
  _, time0, times, values, noise, expl = _sampling_inputs(interp)
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
  return new_times, cands, actions, time0


@pytest.mark.parametrize("interp", list(tspline.Interp))
def test_optimize_matches_jax_composition(setup, jax_refs, interp):
  t, _ = setup
  home, time0, times, values, noise, expl = _sampling_inputs(interp)
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
  new_times, cands, want = jax_refs[f"sampling_{int(interp)}"]
  np.testing.assert_allclose(info.costs.numpy(), want, rtol=2e-3)
  assert int(info.winner) == int(np.argmin(want))
  np.testing.assert_allclose(new_policy.times.numpy(), new_times,
                             atol=1e-6)
  np.testing.assert_allclose(new_policy.values.numpy(),
                             cands[int(np.argmin(want))], atol=1e-6)


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
  """Every planner of the JAX package is ported: all seven names build an
  Agent, and a name that is none of them raises."""
  for name in ("sampling", "gradient", "ilqg", "ilqs", "robust",
               "cross_entropy", "sample_gradient"):
    assert Agent("Walker", planner=name, device="cpu").planner_name == name
  with pytest.raises(ValueError, match="unknown planner"):
    Agent("Walker", planner="ilqr", device="cpu")


# -------------------------------------------------- the cross-entropy planner
# its candidates and returns over the module's N and T, so that one
# returns_xla serves both planners' checks
K_CEM, ELITE = 5, 4
_CEM = dict(num_trajectories=N, n_elite=ELITE, spline_points=K_CEM,
            horizon=T, std_min=0.05, std_initial=0.3)


def _jax_cem():
  return jcem.CrossEntropyPlanner(jcem.CEMConfig(**_CEM),
                                  use_megakernel=False)


@pytest.fixture(scope="module")
def cem_setup():
  t = treg.get_task("Walker", device="cpu")
  j = jreg.get_task("Walker", dtype=jnp.float32)
  tp = tcem.CrossEntropyPlanner(tcem.CEMConfig(**_CEM))
  tp.init(t)
  return t, j, tp, _jax_cem()


def _state(t, j, seed):
  """The same policy (times, values, std) and state in both packages, and
  the JAX key whose standard normals both use."""
  rng = np.random.RandomState(seed)
  home = np.asarray(t.model.keyframe("home")[0], np.float32)
  time0 = np.float32(0.021)
  times = np.linspace(0.0, 0.04, K_CEM).astype(np.float32)
  values = rng.uniform(-0.5, 0.5, (K_CEM, 6)).astype(np.float32)
  std = rng.uniform(0.05, 0.4, (K_CEM, 6)).astype(np.float32)
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
  return np.asarray(jax.random.normal(key, (N - 1, K_CEM, 6),
                                      dtype=jnp.float32))


def test_cem_init_matches_jax(cem_setup):
  t, j, tp, jp = cem_setup
  ours, theirs = tp.init(t), jp.init(j)
  for f in ("times", "values", "std"):
    np.testing.assert_allclose(getattr(ours, f).numpy(),
                               np.asarray(getattr(theirs, f)), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_cem_candidates_match_jax(cem_setup, seed):
  t, j, tp, jp = cem_setup
  tpol, jpol, tdata, jdata, key = _state(t, j, seed)
  got = tp._gen_candidates(t, tpol, tdata, None,
                           noise=torch.tensor(_jax_noise(key)))
  want = jp._gen_candidates(j, jpol, jdata, key)
  for name, a, b in zip(("new_times", "nominal", "candidates"), got, want):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                               err_msg=name)


def test_cem_elite_update_matches_jax():
  rng = np.random.RandomState(7)
  cands = rng.randn(N, K_CEM, 6).astype(np.float32)
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


def _cem_composition(j):
  """One CEM iteration from _state(seed 4) composed from the JAX package's
  parts (its _gen_candidates, spline.sample_many): (new_times,
  candidates, their actions, the JAX Data)."""
  jp = _jax_cem()
  _, jpol, _, jdata, key = _state(treg.get_task("Walker", device="cpu"), j,
                                  4)
  new_times, _, cands = jp._gen_candidates(j, jpol, jdata, key)
  ts = jdata.time + jnp.arange(T, dtype=jnp.float32) * j.model.opt.timestep
  actions = jax.vmap(lambda v: jspline.sample_many(
      new_times, v, ts, jp.config.interp))(cands)
  return new_times, cands, actions, jdata


def test_cem_optimize_matches_jax_composition(cem_setup, jax_refs):
  """One CEM iteration on the Walker: candidates, returns (returns_xla),
  elite update."""
  t, j, tp, jp = cem_setup
  tpol, _, tdata, _, key = _state(t, j, 4)
  new_policy, info = tp.optimize(t, tpol, tdata, None,
                                 noise=torch.tensor(_jax_noise(key)))
  new_times, cands, want = jax_refs["cem"]
  _, jidx = jax.lax.top_k(-jnp.asarray(want), ELITE)
  elites = jnp.asarray(cands)[jidx]
  jmean = jnp.mean(elites, axis=0)
  jstd = jnp.maximum(jnp.sqrt(jnp.sum((elites - jmean[None]) ** 2, axis=0)
                              / (ELITE - 1)), jp.config.std_min)
  np.testing.assert_allclose(info.costs.numpy(), want, rtol=2e-3)
  # no near-tie where the order matters: the winner, and the last elite
  order = np.sort(want)
  assert order[1] - order[0] > 1e-4 * order[0]
  assert order[ELITE] - order[ELITE - 1] > 1e-4 * order[ELITE]
  assert int(info.winner) == int(jidx[0])
  np.testing.assert_allclose(new_policy.times.numpy(), new_times,
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
