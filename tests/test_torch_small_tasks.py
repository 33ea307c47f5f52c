"""The eight small tasks in the port held against the JAX package.

Cartpole, Acrobot, Particle, ParticleFixed, Fingers, Arm Reach, Push and
Rubik Faces need no kernel change: each is a residual (a Python one and a
CUDA one), a snapshot and an Agent at its defaults. Every check runs on the
Agent's planning model (the model at its agent_timestep). One JAX rollout
per task, eager (tests/test_torch_tilestep_classes.py::
jax_probe_and_returns), serves the one-step checks on the task's probe
states and the returns of the Agent's own candidates, injected as the same
standard normals in both packages (the first K of them: candidates are
independent); every task has the same column count (B + K), so tasks run
in one worker share the eager JAX primitives. The per-task tests run over
five tasks here and three in test_torch_small_tasks_b.py. Four JAX residuals are
written for one candidate, not for the tile view (candidates trailing):
Acrobot's and Fingers' jnp.linalg.norm runs over every axis, one norm over
all candidates, and Arm Reach's and Push's home ctrl (nu,) does not
broadcast against ctrl (nu, M); on the tile view they fail. They are
evaluated one candidate at a time here (`per_candidate`), as the JAX
general path runs them.

Tolerances, with the errors measured when they were set (the one-step
holds again on a CPU host, each with a margin of 4 or more):
  snapshot: exact; the MJCF copies: the same text; extract: exact, and the
    contact kinds, row counts and residual sizes of the JAX extract;
  residual on the same (JAX) view: atol 1e-5 (measured 1.2e-7);
  one step, cold and warm, against the JAX step: qpos atol 1e-6 (measured
    2.4e-7, Push), qvel atol 1e-4 (2.3e-5, Push), duals atol 1e-5 *
    max|duals| (2.4e-6 relative, Arm Reach);
  the Agent's candidate returns over 3 steps against JAX's: rtol 2e-3
    (measured 2.4e-7).
Acrobot and Cartpole are held, in both packages, with MuJoCo's parent
filter applied (tests/torch_cases.py::mujoco_filtered): the reference
keeps a parent-child pair on each, whose closest points or box offset
coincide, and takes a normal from the rounding residue there, which the
port does not (tilestep.COINCIDE); test_reference_keeps_parent_child_pairs
pins that pair, and test_registered_model_step_matches_jax_off_the_pair
holds the registered models where the reference's pair carries no force.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_torch.agent.agent import Agent
from mujoco_mpc_torch.ops import megarollout as tmr
from mujoco_mpc_torch.physics import tilestep as tts
from mujoco_mpc_torch.planners import sampling as tsampling
from mujoco_mpc_torch.tasks import base as tbase
from mujoco_mpc_torch.tasks import registry as treg
from mujoco_mpc_torch.tasks import rubik as trubik
from mujoco_mpc_tpu.agent.agent import Agent as JaxAgent
from mujoco_mpc_tpu.physics import tilestep as jts
from mujoco_mpc_tpu.tasks import registry as jreg
from tests.test_torch_model import REPO, _same
from tests.test_torch_tilestep_classes import jax_probe_and_returns
from tests.torch_cases import (ILL_CONDITIONED, RUBIK_TARGETS, SMALL_TASKS,
                               mujoco_filtered, one_torch_thread, port_steps,
                               small_task_states)
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

B, K, T = 4, 12, 3
# task: (snapshot stem, the Agent's candidates and horizon steps, nrow,
# contact kinds of the JAX extract, residual entries)
_TABLE = {
    "Cartpole": ("cartpole", 128, 100, 56,
                 {"plane_boxcorner": 8, "cap_box": 6, "plane_capend": 2,
                  "cap_cap": 2}, 4),
    "Acrobot": ("acrobot", 128, 150, 21, {"plane_capend": 6, "cap_cap": 1},
                4),
    "Particle": ("particle", 64, 50, 19, {"plane_sphere": 5}, 6),
    "ParticleFixed": ("particle", 64, 50, 19, {"plane_sphere": 5}, 6),
    "Fingers": ("fingers", 256, 50, 17, {"cap_cap": 3}, 7),
    "Arm Reach": ("arm_reach", 128, 80, 14, {}, 17),
    "Push": ("push", 256, 70, 38,
             {"plane_boxcorner": 8, "plane_sphere": 1, "sphere_box": 1}, 13),
    "Rubik Faces": ("rubik_faces", 256, 50, 0, {}, 18),
}
# the goal of the tasks with a mocap body
_GOAL = {"Particle": [[0.1, -0.15, 0.01]],
         "ParticleFixed": [[0.1, -0.15, 0.01]],
         "Arm Reach": [[0.35, 0.25, 0.45]], "Push": [[0.55, -0.2, 0.035]]}


def per_candidate(residual):
  """A JAX residual on a tile view, mapped over the candidates with
  jax.vmap: each array with a trailing axis of M candidates is taken one
  column at a time, the rollout constants (a trailing axis of 1) at their
  one column."""

  def f(model, view, params):
    m = view.qpos.shape[-1]
    arrays = {k: x for k, x in vars(view).items()
              if hasattr(x, "shape") and x.ndim and x.shape[-1] in (m, 1)}
    rest = {k: x for k, x in vars(view).items() if k not in arrays}
    batched = {k: x for k, x in arrays.items() if x.shape[-1] == m}
    fixed = {k: x[..., 0] for k, x in arrays.items() if k not in batched}

    def one(cols):
      return residual(model, types.SimpleNamespace(**cols, **fixed, **rest),
                      params)
    return jax.vmap(one, in_axes=-1, out_axes=-1)(batched)
  return f


def jax_task(name, timestep):
  """The JAX task at the planning timestep, its residual per candidate
  where the JAX one is not written for the tile view."""
  j = jreg.get_task(name, dtype=jnp.float32)
  j = j.replace(model=j.model.replace(opt=j.model.opt.replace(
      timestep=jnp.float32(timestep))))
  if name in ("Acrobot", "Arm Reach", "Fingers", "Push"):
    j = j.replace(residual=per_candidate(j.residual))
  if name in ILL_CONDITIONED:
    j = j.replace(model=mujoco_filtered(j.model))
  return j


def operands(name, model):
  """(mocap_pos, userdata) numpy of a task's plan: its goal, Rubik Faces'
  targets."""
  ud = np.zeros(model.nuserdata, np.float32)
  if name == "Rubik Faces":
    ud = trubik.faces_userdata(model.nuserdata, RUBIK_TARGETS)
  mp = np.asarray(_GOAL.get(name, np.zeros((model.nmocap, 3))), np.float32)
  return mp, ud


def case_fixture(names):
  """A module fixture over `names`: (name, the port's Agent on its probe
  state 1 with the task's operands, the JAX planning task, both
  TileModels, the probe states, the Agent's injected noise) of one
  task."""

  @pytest.fixture(scope="module", params=names)
  def case(request):
    return _case(request.param)
  return case


def _case(name):
  task = treg.get_task(name, device="cpu")
  if name in ILL_CONDITIONED:
    task = task.replace(model=mujoco_filtered(task.model))
  agent = Agent(task, device="cpu", horizon_steps=T, planner="sampling")
  t = agent.task
  j = jax_task(name, float(t.model.opt.timestep))
  probe = small_task_states(name)(t.model, B)
  mp, ud = operands(name, t.model)
  agent.set_state(qpos=probe[0][:, 1], qvel=probe[1][:, 1], time=0.02,
                  mocap_pos=mp if t.model.nmocap else None, userdata=ud)
  cfg = agent.planner.config
  noise = np.random.RandomState(2).randn(
      cfg.num_trajectories - 1, cfg.spline_points, t.model.nu
  ).astype(np.float32)
  return (name, agent, j, tts.extract(t.model), jts.extract(j.model), probe,
          noise)


HALF_A = ("Acrobot", "Cartpole", "Particle", "ParticleFixed", "Rubik Faces")
case = case_fixture(HALF_A)


def _candidates(agent, noise):
  """The Agent's candidate actions (N, T, nu) on the injected noise."""
  p, data = agent.planner, agent.data
  use2 = torch.zeros(noise.shape[0], dtype=torch.bool)
  new_times, _, cands = p._gen_candidates(agent.task, agent.policy, data,
                                          None, torch.tensor(noise), use2)
  return p._actions(agent.task, data, new_times, cands)


_JAX_RUNS = {}


@pytest.fixture(scope="module")
def jax_run(case):
  """One JAX rollout: the probe states (holding their ctrl) and the
  Agent's injected candidates from its state; Particle's serves
  ParticleFixed, the same model, residual and inputs."""
  name, agent, j, _, jtm, probe, noise = case
  stem = _TABLE[name][0]
  if stem not in _JAX_RUNS:
    _JAX_RUNS[stem] = _jax_run(agent, j, jtm, probe, noise)
  return _JAX_RUNS[stem]


def _jax_run(agent, j, jtm, probe, noise):
  d = agent.data
  ops = (d.mocap_pos.numpy()[..., None], d.mocap_quat.numpy()[..., None],
         d.userdata.numpy()[:, None])
  return jax_probe_and_returns(
      j, jtm, probe, d.qpos.numpy(), d.qvel.numpy(),
      _candidates(agent, noise)[:K].numpy(), float(d.time), ops)


@pytest.mark.parametrize("name", SMALL_TASKS)
def test_small_task_snapshot_matches_fresh_build(name):
  stem = _TABLE[name][0]
  builder = treg._SNAPSHOTS[name][1]
  fresh, spec, params, names = treg.load_task_model_from_builder(
      builder, dtype=torch.float64, device="cpu")
  snap, sspec, sparams, snames = treg.load_task_model(
      stem, dtype=torch.float64, device="cpu")
  for f in dataclasses.fields(fresh):
    if f.name == "opt":
      for g in dataclasses.fields(fresh.opt):
        _same(g.name, getattr(fresh.opt, g.name), getattr(snap.opt, g.name),
              0.0)
    else:
      _same(f.name, getattr(fresh, f.name), getattr(snap, f.name), 0.0)
  assert (spec, names) == (sspec, snames)
  for f in dataclasses.fields(params):
    _same(f.name, getattr(params, f.name), getattr(sparams, f.name), 0.0)


@pytest.mark.parametrize("xml", ["arm_reach.xml", "fingers.xml", "push.xml",
                                 "rubik.xml"])
def test_small_task_mjcf_is_the_jax_packages(xml):
  """The port's copy of a task's MJCF is the JAX package's text."""
  with open(f"{REPO}/mujoco_mpc_torch/tasks/models/{xml}") as ours, open(
      f"{REPO}/mujoco_mpc_tpu/tasks/models/{xml}") as theirs:
    assert ours.read() == theirs.read()


def test_small_task_matches_jax_task(case):
  """The task at its planning timestep, with the reference's contact
  pairs, against the JAX task."""
  name, agent, j, _, _, _, _ = case
  t = agent.task
  ref = treg.get_task(name, device="cpu").model
  ours = tts.extract(ref.replace(opt=t.model.opt))
  theirs = jts.extract(jreg.get_task(name, dtype=jnp.float32).model)
  assert (t.spec.names, t.spec.norm_types, t.spec.dims, t.param_names) == (
      j.spec.names, j.spec.norm_types, j.spec.dims, j.param_names)
  for f in ("weights", "norm_params", "risk", "residual_params"):
    _same(f, getattr(t.params, f), np.asarray(getattr(j.params, f)), 0.0)
  _, n, horizon, nrow, kinds, nres = _TABLE[name]
  cfg = tsampling.SamplingConfig.from_task(t)
  assert (cfg.num_trajectories, cfg.horizon) == (n, horizon)
  assert float(t.model.opt.timestep) == pytest.approx(0.01)
  assert t.spec.nresidual == nres and ours.nrow == theirs.nrow == nrow
  got = {}
  for cp in ours.con_points:
    got[cp.kind] = got.get(cp.kind, 0) + 1
  assert got == kinds
  assert [(c.kind, c.g1, c.g2, c.sign) for c in ours.con_points] == [
      (c.kind, c.g1, c.g2, c.sign) for c in theirs.con_points]
  for f in ("nq", "nv", "nu", "nbody", "njnt", "lim_jnt", "jnt_qposadr",
            "jnt_dofadr", "dof_body", "nmocap", "nuserdata"):
    assert getattr(ours, f) == getattr(theirs, f), f
  assert tmr.select_tier(ours, t).name == "small"


def test_small_task_residual_matches_jax(case, jax_run):
  """The port's residual on a StepView carried across from the JAX view
  after the warm step."""
  name, agent, j, _, _, _, _ = case
  t = agent.task
  jview = jax_run[0][1][2]
  fields = {f.name: torch.tensor(np.asarray(getattr(jview, f.name)))
            for f in dataclasses.fields(tts.StepView) if f.name != "time"}
  view = tts.StepView(**fields, time=torch.tensor(0.3))
  ours = t.residual(t.model, view, t.params.residual_params)
  theirs = j.residual(j.model, jview, j.params.residual_params)
  assert ours.shape == (_TABLE[name][5], B)
  np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-5)


def test_small_task_step_matches_jax(case, jax_run):
  """Cold, then warm-started, on the task's probe states; in the tasks
  with constraint rows, rows carry force (Rubik Faces has none)."""
  name, agent, _, tm, _, probe, _ = case
  d = agent.data
  ops = (d.mocap_pos.numpy()[..., None], d.mocap_quat.numpy()[..., None],
         d.userdata.numpy()[:, None])
  for view, (jq, jv, jview) in zip(port_steps(tm, probe, ops=ops),
                                   jax_run[0]):
    lam = view.efc_lambda.numpy()
    assert tm.nrow == 0 or np.abs(lam).max() > 0
    np.testing.assert_allclose(view.qpos.numpy(), jq, atol=1e-6)
    np.testing.assert_allclose(view.qvel.numpy(), jv, atol=1e-4)
    if tm.nrow:
      np.testing.assert_allclose(
          lam, np.asarray(jview.efc_lambda),
          atol=1e-5 * max(float(np.abs(lam).max()), 1.0))


def test_small_task_agent_plans_on_cpu(case, jax_run):
  """Two plan iterations from the probe state (the best return does not
  rise: candidate 0 is the previous winner), then the Agent's injected
  candidate set scored by its MegaRollout, the first K against JAX's
  returns of the same actions, per candidate."""
  name, agent, _, _, _, _, noise = case
  with one_torch_thread():
    best = []
    for _ in range(2):
      info = agent.planner_step()
      assert bool(torch.all(torch.isfinite(info.costs)))
      best.append(float(info.best_return))
    assert best[1] <= best[0]
    u = agent.action()
    assert u.shape == (agent.task.model.nu,) and np.all(np.isfinite(u))
    actions = _candidates_at(agent, noise)
    d = agent.data
    args = (d.qpos, d.qvel, actions, agent.task.params, d.time)
    aux = dict(mocap_pos=d.mocap_pos, mocap_quat=d.mocap_quat,
               userdata=d.userdata)
    got = agent.planner.mega.returns(*args, **aux).numpy()
  assert got.shape == (agent.planner.config.num_trajectories,)
  assert agent.planner.mega.launches == 0  # CPU tensors: the plain version
  got = got[:K]
  assert np.all(np.isfinite(got)) and np.all(got < tmr.MAX_RETURN)
  np.testing.assert_allclose(got, jax_run[1], rtol=2e-3)


@pytest.mark.parametrize("name", ILL_CONDITIONED)
def test_reference_keeps_parent_child_pairs(name):
  """The known fault the tests above step around: the reference's
  broadphase (and the port's copy of it, pair for pair) keeps one
  parent-child pair here that MuJoCo's filterparent drops, because the
  parent's own parent is the world; mujoco_filtered drops it."""
  ours = treg.get_task(name, device="cpu").model
  theirs = jreg.get_task(name, dtype=jnp.float32).model
  assert ours.collision_pairs == theirs.collision_pairs
  kept = set(ours.collision_pairs) - set(
      mujoco_filtered(ours).collision_pairs)
  assert len(kept) == 1
  (g1, g2), = kept
  child, parent = sorted((ours.geom_bodyid[g1], ours.geom_bodyid[g2]),
                         key=lambda b: ours.body_parentid[b] == 0)
  assert ours.body_parentid[child] == parent != 0
  assert ours.body_parentid[parent] == 0


@pytest.mark.parametrize("name", ILL_CONDITIONED)
def test_registered_model_step_matches_jax_off_the_pair(name):
  """The registered model, the reference's parent-child pair kept, one
  cold step of 16 probe states against the JAX step, on the states where
  JAX's rows of that pair carry no force (Acrobot 2 of 16, Cartpole 8):
  qpos atol 1e-6 (measured 3.0e-8), qvel atol 1e-4 (9.5e-7), the duals off
  the pair atol 1e-5 * max|duals| (9.3e-8 relative). The port's rows of
  that pair carry no force on any state: Acrobot's capsules' closest
  points coincide and Cartpole's pole end lies on its cart box's
  mid-plane, so the port takes no normal there (tilestep.COINCIDE), where
  JAX's float32 step takes one from the rounding residue (qvel up to 33.8
  and 6.7 apart)."""
  task = treg.get_task(name, device="cpu")
  j = jreg.get_task(name, dtype=jnp.float32)
  tm, jtm = tts.extract(task.model), jts.extract(j.model)
  kept, = set(task.model.collision_pairs) - set(
      mujoco_filtered(task.model).collision_pairs)
  fric = tts.row_points(tm)[0]
  pair = [3 * k + r for k, cp in enumerate(fric)
          if (cp.g1, cp.g2) == kept for r in range(3)]
  assert pair and jtm.nrow == tm.nrow
  probe = small_task_states(name)(task.model, B + K)
  jq, jv, jview = jts.step_tb(jtm, *map(jnp.asarray, probe))
  pq, pv, view = tts.step_tb(tm, *map(torch.tensor, probe))
  jlam = np.asarray(jview.efc_lambda)
  free = np.all(jlam[pair] == 0.0, axis=0)
  assert free.sum() >= 2
  assert not view.efc_lambda.numpy()[pair].any()  # COINCIDE: no normal
  np.testing.assert_allclose(pq.numpy()[:, free], np.asarray(jq)[:, free],
                             atol=1e-6)
  np.testing.assert_allclose(pv.numpy()[:, free], np.asarray(jv)[:, free],
                             atol=1e-4)
  off = np.setdiff1d(np.arange(tm.nrow), pair)
  lam = view.efc_lambda.numpy()[off][:, free]
  np.testing.assert_allclose(lam, jlam[off][:, free],
                             atol=1e-5 * max(float(np.abs(lam).max()), 1.0))


def _candidates_at(agent, noise):
  """_candidates from the Agent's state before its two plan steps: the
  policy the fixture's JAX rollout saw is the initial one."""
  policy = agent.planner.init(agent.task)
  saved, agent.policy = agent.policy, policy
  try:
    return _candidates(agent, noise)
  finally:
    agent.policy = saved


def test_agent_task_knobs_match_jax():
  """set_cost_weights, set_task_parameter and set_mode change the next
  plan's kernel operands (weights, residual parameters, userdata) as
  JAX's change the JAX Agent's task and state."""
  ours = Agent("Fingers", device="cpu", horizon_steps=2)
  theirs = JaxAgent("Fingers", horizon_steps=2)
  for a in (ours, theirs):
    a.set_cost_weights({"SpinRate": 3.5, "Control": 0.25})
    a.set_task_parameter("SpinGoal", -2.0)
    a.set_mode(3)
  assert ours.mode_names == theirs.mode_names == ("default",)
  assert ours.get_mode() == theirs.get_mode() == "3"
  want = theirs.get_cost_weights()
  got = ours.get_cost_weights()
  assert list(got) == list(want)
  np.testing.assert_allclose(list(got.values()), list(want.values()))
  _same("residual_params", ours.task.params.residual_params,
        np.asarray(theirs.task.params.residual_params), 0.0)
  _same("userdata", ours.data.userdata, np.asarray(theirs.data.userdata),
        0.0)
  seen = {}
  mega = ours.planner.mega
  plain = mega.returns

  def spy(qpos0, qvel0, actions, params, t0, **aux):
    seen.update(params=params, **aux)
    return plain(qpos0, qvel0, actions, params, t0, **aux)

  mega.returns = spy
  with one_torch_thread():
    ours.planner_step()
  _same("weights", seen["params"].weights,
        np.asarray(theirs.task.params.weights), 0.0)
  _same("residual_params", seen["params"].residual_params,
        np.asarray(theirs.task.params.residual_params), 0.0)
  assert float(seen["userdata"][tbase.MODE_SLOT]) == 3.0
