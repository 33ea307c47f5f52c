"""The general batched rollout (ops/rollout.py) and the planners' route
through it, held against the JAX package in float64 on the CPU, and
against the kernel's plain version (MegaRollout.returns_plain).

JAX vmaps one rollout over candidates; the port steps all candidates at
once in a leading batch dimension. The same injected actions (or spline
candidates) go to both: JAX's random draws (the planners' noise, the
noisy rollout's normals) are made with JAX and handed to the port.

Tolerances, with the errors measured when they were set:
  rollout, rollout_return, noisy_rollout and the transition rollout
    against JAX (returns, per-step costs, qpos, residuals): rtol 1e-8,
    atol 1e-9 (measured 4e-13);
  the sampling and CEM planners through the general rollout
    (use_megakernel=False) against JAX's general path on JAX's
    candidates: returns rtol 1e-8 (measured 1e-14), the same winner, the
    new policy atol 1e-12;
  the general returns against the kernel's plain version (the tile step),
    both in float64 on the float32-rounded model constants that the
    kernel packs: rtol 2e-3, atol 1e-4, as the JAX package holds its two
    paths (measured 4e-8).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.ops import rollout as jrollout
from mujoco_mpc_tpu.planners import sampling as jsampling
from mujoco_mpc_torch.ops import megarollout as tmr
from mujoco_mpc_torch.ops import rollout as trollout
from mujoco_mpc_torch.ops import spline as tspline
from mujoco_mpc_torch.physics import io as tio
from mujoco_mpc_torch.physics import tilestep as tts
from mujoco_mpc_torch.planners import cross_entropy as tcem
from mujoco_mpc_torch.planners import sampling as tsampling
from mujoco_mpc_torch.tasks import quadruped as tquad
from mujoco_mpc_torch.tasks import registry as treg
from tests import torch_engine_cases as cases
from tests.torch_cases import one_torch_thread
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

jio = importlib.import_module("mujoco_mpc_tpu.physics.io")

N, T = 4, 10


def _step_policy(actions, dt):
  """The port's policy: each candidate's action (actions (N, T, nu)) of
  the step its clock is at (the JAX side indexes one candidate's the same
  way)."""
  acts = torch.tensor(actions)

  def policy(t, d):
    i = torch.clamp(torch.round(t / dt).long(), 0, T - 1)
    return acts[torch.arange(acts.shape[0]), i]

  return policy


def _start(t, j, qpos):
  jd = jio.make_data(j.model).replace(qpos=jnp.asarray(qpos))
  td = tio.make_data(t.model).replace(qpos=torch.tensor(qpos))
  return jd, td


@pytest.fixture(scope="module")
def walker():
  t, j = cases.pair("Walker")
  home = np.asarray(t.model.keyframe("home")[0])
  home[1] -= 0.02  # the feet into the floor: contact rows from step 1
  return t, j, home


def test_rollout_matches_jax(walker):
  t, j, home = walker
  jd, td = _start(t, j, home)
  actions = 0.4 * np.random.RandomState(0).randn(N, T, t.model.nu)
  dt = float(t.model.opt.timestep)
  tpf = _step_policy(actions, dt)

  def one(acts):
    pf = lambda tt, d: acts[jnp.clip(jnp.round(tt / dt).astype(jnp.int32),
                                     0, T - 1)]
    r = jrollout.rollout(j, jd, pf, T)
    return r.total_return, r.costs, r.qpos, r.residuals

  want = cases.np_tree(jax.jit(jax.vmap(one))(jnp.asarray(actions)))
  got = trollout.rollout(t, trollout.broadcast(td, (N,)), tpf, T)
  for ours, theirs, what in zip(
      (got.total_return, got.costs, got.qpos, got.residuals), want,
      ("return", "costs", "qpos", "residuals")):
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-8, atol=1e-9,
                               err_msg=what)
  np.testing.assert_allclose(
      trollout.rollout_return(t, trollout.broadcast(td, (N,)), tpf,
                              T).numpy(), want[0], rtol=1e-8, atol=1e-9)


def test_transition_and_noisy_rollouts_match_jax():
  t, j = cases.pair("Particle")
  qpos = np.asarray([0.1, -0.05])
  jd, td = _start(t, j, qpos)
  actions = np.random.RandomState(1).uniform(-1, 1, (N, T, t.model.nu))
  dt = float(t.model.opt.timestep)
  tpf = _step_policy(actions, dt)

  def one(acts, key):
    pf = lambda tt, d: acts[jnp.clip(jnp.round(tt / dt).astype(jnp.int32),
                                     0, T - 1)]
    r = jrollout.rollout(j, jd, pf, T, transition=True)
    noisy = jrollout.noisy_rollout(j, jd, pf, T, key, xfrc_std=0.3)
    return r.total_return, r.costs, r.residuals, noisy

  keys = jax.random.split(jax.random.PRNGKey(3), N)
  want = cases.np_tree(jax.jit(jax.vmap(one))(jnp.asarray(actions), keys))
  # the noisy rollout's standard normals, as jax draws them per candidate
  eps = np.stack([np.stack([np.asarray(jax.random.normal(
      k, (t.model.nbody, 6), dtype=jnp.float64))
      for k in jax.random.split(key, T)]) for key in keys], axis=1)
  d0 = trollout.broadcast(td, (N,))
  got = trollout.rollout(t, d0, tpf, T, transition=True)
  for ours, theirs, what in zip(
      (got.total_return, got.costs, got.residuals), want[:3],
      ("return", "costs", "residuals")):
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-8, atol=1e-9,
                               err_msg=what)
  # the goal moved with the clock
  assert not np.allclose(got.final.mocap_pos.numpy(), td.mocap_pos.numpy())
  noisy = trollout.noisy_rollout(t, d0, tpf, T, xfrc_std=0.3,
                                 eps=torch.tensor(eps))
  np.testing.assert_allclose(noisy.numpy(), want[3], rtol=1e-8, atol=1e-9)


@one_torch_thread()
def test_planner_general_route_matches_jax():
  """use_megakernel=False: the sampling and CEM planners score JAX's
  candidates through the general rollout as JAX's general path does
  (SamplingPlanner._returns off the TPU; CEM's is the same rollout), and
  the sampling planner's optimize on JAX's draws keeps JAX's winner."""
  t, j = cases.pair("Particle")
  n, k, horizon = 8, 4, 12
  jp = jsampling.SamplingPlanner(jsampling.SamplingConfig(
      num_trajectories=n, spline_points=k, horizon=horizon),
                                 use_megakernel=False)
  jpol = jp.init(j)
  jd, td = _start(t, j, np.asarray([0.12, -0.07]))
  key = jax.random.PRNGKey(5)
  new_times, _, cands = jax.jit(jp._gen_candidates)(j, jpol, jd, key)
  want = np.asarray(jax.jit(jp._returns, static_argnums=4)(
      j, jd, new_times, cands, None))
  times, values = (torch.tensor(np.asarray(x)) for x in (new_times, cands))
  sampling = tsampling.SamplingPlanner(tsampling.SamplingConfig(
      num_trajectories=n, spline_points=k, horizon=horizon),
                                       use_megakernel=False)
  cem = tcem.CrossEntropyPlanner(tcem.CEMConfig(
      num_trajectories=n, n_elite=3, spline_points=k, horizon=horizon),
                                 use_megakernel=False)
  policy = sampling.init(t)
  cem.init(t)
  assert sampling.mega is None and cem.mega is None
  assert sampling.general_reason == cem.general_reason == \
      "use_megakernel=False"
  for planner in (sampling, cem):
    np.testing.assert_allclose(
        planner._returns(t, td, times, values, None).numpy(), want,
        rtol=1e-8)
  rng_n, rng_b = jax.random.split(key)
  noise = np.asarray(jax.random.normal(rng_n, (n - 1, k, t.model.nu),
                                       dtype=jnp.float64))
  use2 = np.asarray(jax.random.bernoulli(rng_b, 0.2, (n - 1,)))
  policy = policy.replace(times=torch.tensor(np.asarray(jpol.times)))
  new_t, info = sampling.optimize(t, policy, td, None,
                                  noise=torch.tensor(noise),
                                  use2=torch.tensor(use2))
  winner = int(np.argmin(want))
  assert int(info.winner) == winner
  np.testing.assert_allclose(new_t.values.numpy(),
                             np.asarray(cands)[winner], atol=1e-12)


def test_planner_route_follows_the_task():
  """Every registered task with a CUDA residual plans through the kernel
  by default, and the six without one (Quadrotor, Swimmer, Rubik,
  Humanoid Track, Bimanual Insert, Quadruped Hill) through the general
  rollout, saying so; a task with no
  CUDA residual plans through the general rollout and says so; a task
  with one whose model the kernel refuses raises."""
  cfg = tsampling.SamplingConfig(num_trajectories=4, spline_points=3,
                                 horizon=4)
  general = set()
  for name in treg.task_names():
    t = treg.get_task(name, device="cpu")
    for planner in (tsampling.SamplingPlanner(cfg),
                    tcem.CrossEntropyPlanner(tcem.CEMConfig(
                        num_trajectories=4, n_elite=2, spline_points=3,
                        horizon=4))):
      if t.device_residual is None:
        general.add(name)
        with pytest.warns(UserWarning, match="has no CUDA residual"):
          planner.init(t)
        assert planner.mega is None, name
        continue
      planner.init(t)
      assert planner.general_reason is None, name
      assert isinstance(planner.mega, tmr.MegaRollout), name
  assert general == {"Quadrotor", "Swimmer", "Rubik", "Humanoid Track",
                     "Bimanual Insert", "Quadruped Hill"}
  t = treg.get_task("Particle", device="cpu")
  planner = tsampling.SamplingPlanner(cfg)
  with pytest.warns(UserWarning, match="has no CUDA residual"):
    planner.init(t.replace(device_residual=None))
  assert planner.mega is None and "no CUDA residual" in planner.general_reason
  fluid = t.replace(model=t.model.replace(
      opt=t.model.opt.replace(has_fluid=True)))
  with pytest.raises(tts.UnsupportedModel, match="fluid forces"):
    tsampling.SamplingPlanner(cfg).init(fluid)


def _rounded64(t32):
  """A float32 task in float64 with the same, float32-rounded, model
  constants and parameters: what the kernel's plain version of t32 holds
  (tilestep.extract of the float32 model)."""
  def cast(obj):
    return dataclasses.replace(obj, **{
        f.name: v.double() for f in dataclasses.fields(obj)
        for v in (getattr(obj, f.name),)
        if isinstance(v, torch.Tensor) and v.is_floating_point()})
  t = treg.get_task(t32.name, dtype=torch.float64, device="cpu")
  return t.replace(model=cast(t32.model).replace(opt=cast(t32.model.opt)),
                   params=t32.params.to(dtype=torch.float64))


@one_torch_thread()
@pytest.mark.parametrize("name", ["Walker", "Quadruped Flat"])
def test_general_returns_match_returns_plain(name):
  """The general route against the kernel's plain version on the same
  candidates (Quadruped's with its trot userdata and a goal), both in
  float64 on the kernel's float32-rounded constants."""
  t32 = treg.get_task(name, device="cpu")
  t = _rounded64(t32)
  # knots 3.75 steps apart: none falls on a step's time, where the general
  # route (the spline at the rollout's summed clock, as JAX's general path
  # samples it) and the kernel (at t0 + i dt) may hold different segments
  n, k, horizon = 8, 4, 16
  cfg = tsampling.SamplingConfig(num_trajectories=n, spline_points=k,
                                 horizon=horizon)
  general = tsampling.SamplingPlanner(cfg, use_megakernel=False)
  kernel = tsampling.SamplingPlanner(cfg)
  policy = general.init(t)
  kernel.init(t32)
  assert general.mega is None and isinstance(kernel.mega, tmr.MegaRollout)
  assert general.general_reason == "use_megakernel=False"
  assert kernel.general_reason is None
  data = tio.make_data(t.model).replace(qpos=torch.tensor(
      t.model.keyframe("home")[0], dtype=torch.float64))
  if name == "Quadruped Flat":
    data = data.replace(
        mocap_pos=torch.tensor([[1.0, 0.3, 0.3]], dtype=torch.float64),
        userdata=torch.tensor(tquad.fsm_userdata(t.model.nuserdata)))
  gen = torch.Generator().manual_seed(0)
  new_times, _, cands = general._gen_candidates(t, policy, data, gen)
  got = general._returns(t, data, new_times, cands, None)
  want = kernel._returns(t, data, new_times, cands, None)
  assert got.dtype == want.dtype == torch.float64
  assert torch.all(torch.isfinite(got))
  np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3,
                             atol=1e-4)
  assert cfg.interp == tspline.Interp.ZERO
