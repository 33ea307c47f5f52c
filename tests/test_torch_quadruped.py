"""Quadruped Flat in the port held against the JAX package.

The same float32 inputs, made with numpy from a seed, go through both
packages, with the goal mocap body at (1.0, 0.3, 0.3) and a trot's FSM
state in userdata. The states are quadruped.probe_states: every constraint
row class (plane-sphere, plane-box corner, sphere-sphere, sphere-box, joint
limit) carries force in at least one of them. The JAX reference runs
eagerly, without jax.jit (compiling its quadruped tile path takes minutes
on a CPU), and each JAX result is computed once per module.

Tolerances, with the errors measured on a CPU host:
  snapshot: integers exact, floats 1e-6 (measured 0);
  task and extract: integers exact, floats 1e-6 (measured 0);
  one step, cold and warm, two float32 steps, the tolerances of
    test_megarollout.py:113-114 between two f32 paths: each field per
    state within max(its atol, 8 times that state's distance of JAX's
    float32 step from the port's float64 one) (torch_cases.
    within_rounding; parity with JAX is tests/test_torch_tilestep64.py's
    float64 hold): qpos atol 2e-5 (measured 2.4e-7), qvel atol 2e-4
    (1.0e-5), the view fields the residual reads atol 2e-4 (9.5e-6, the
    actuator forces after the warm step); duals atol 1e-4 * max|duals|
    (1.8e-3 of 1.03e3);
  residual and weight_mod on the same view, per mode: atol 1e-5
    (measured 1.2e-7, Flip);
  returns at n = 8, T = 4: rtol 2e-3 (measured 1.3e-7).
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_torch.agent.agent import Agent
from mujoco_mpc_torch.ops import megarollout as tmr
from mujoco_mpc_torch.physics import tilestep as tts
from mujoco_mpc_torch.planners import sampling as tsampling
from mujoco_mpc_torch.tasks import quadruped as tquad
from mujoco_mpc_torch.tasks import registry as treg
from mujoco_mpc_tpu.physics import tilestep as jts
from mujoco_mpc_tpu.tasks import registry as jreg
from tests.torch_cases import (QUADRUPED_GOAL, QUADRUPED_MODES,
                               one_torch_thread, port_steps, quadruped_mode,
                               step_operands, within_rounding)
from tests.test_torch_model import _same
from tests.test_torch_tilestep_classes import shared_probe_and_returns
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

B, N, T = 8, 8, 4
_KINDS = ("plane_boxcorner", "plane_sphere", "sphere_box", "sphere_sphere",
          "joint_limit")
GOAL = np.asarray(QUADRUPED_GOAL, np.float32)


@pytest.fixture(scope="module")
def tasks():
  return (treg.get_task("Quadruped Flat", device="cpu"),
          jreg.get_task("Quadruped Flat", dtype=jnp.float32))


@pytest.fixture(scope="module")
def tile_models(tasks):
  t, j = tasks
  return tts.extract(t.model), jts.extract(j.model)


def test_quadruped_snapshot_matches_fresh_build():
  fresh, spec, params, names = treg.load_task_model_from_builder(
      tquad.build_quadruped, dtype=torch.float64, device="cpu")
  snap, sspec, sparams, snames = treg.load_task_model(
      "quadruped", dtype=torch.float64, device="cpu")
  for f in dataclasses.fields(fresh):
    if f.name == "opt":
      for g in dataclasses.fields(fresh.opt):
        _same(g.name, getattr(fresh.opt, g.name), getattr(snap.opt, g.name),
              1e-6)
    else:
      _same(f.name, getattr(fresh, f.name), getattr(snap, f.name), 1e-6)
  assert (spec, names) == (sspec, snames)
  for f in dataclasses.fields(params):
    _same(f.name, getattr(params, f.name), getattr(sparams, f.name), 1e-6)
  assert (snap.nmocap, snap.nuserdata) == (1, 24)
  assert snap.keyframe("home")[2] == fresh.keyframe("home")[2]


def test_quadruped_task_matches_jax_task(tasks):
  t, j = tasks
  assert (t.spec.names, t.spec.norm_types, t.spec.dims) == (
      j.spec.names, j.spec.norm_types, j.spec.dims)
  assert t.param_names == j.param_names
  assert t.mode_names == j.mode_names
  for f in ("weights", "norm_params", "risk", "residual_params"):
    _same(f, getattr(t.params, f), np.asarray(getattr(j.params, f)), 1e-6)
  _same("default_ctrl", t.default_ctrl(), np.asarray(j.default_ctrl()), 1e-6)


def test_quadruped_extract_matches_jax(tile_models):
  ours, theirs = tile_models
  assert (ours.nq, ours.nv, ours.nu, ours.nbody, ours.njnt) == (
      19, 18, 12, 15, 13)
  assert (ours.ncon, ours.nlim, ours.nrow, ours.nmocap, ours.nuserdata) == (
      theirs.ncon, theirs.nlim, theirs.nrow, theirs.nmocap,
      theirs.nuserdata) == (22, 24, 90, 1, 24)
  for f in dataclasses.fields(ours):
    if f.name != "con_points":
      _same(f.name, getattr(ours, f.name), getattr(theirs, f.name), 1e-6)
  assert len(ours.con_points) == len(theirs.con_points)
  for i, (a, b) in enumerate(zip(ours.con_points, theirs.con_points)):
    for f in dataclasses.fields(a):
      _same(f"con_points[{i}].{f.name}", getattr(a, f.name),
            getattr(b, f.name), 1e-6)
  kinds = tts.row_kinds(ours)
  assert [kinds.count(k) for k in _KINDS] == [24, 12, 12, 18, 24]


@pytest.fixture(scope="module")
def jax_run(tasks, tile_models, tmp_path_factory):
  """One JAX rollout for the one-step checks and the returns check
  (tests/test_torch_tilestep_classes.py::jax_probe_and_returns), once a
  session."""
  t, j = tasks
  _, jtm = tile_models
  return shared_probe_and_returns(
      tmp_path_factory, "quadruped", j, jtm, tquad.probe_states(t.model, B),
      *_returns_inputs(t), 0.1, step_operands(t))


@pytest.fixture(scope="module")
def two_steps(tasks, tile_models, jax_run):
  """A cold step, then a warm-started one, in both packages, and the
  port's in float64 (the rounding witness)."""
  t, _ = tasks
  ttm, _ = tile_models
  probe, ops = tquad.probe_states(t.model, B), step_operands(t)
  return [(v.qpos, v.qvel, v, jq, jv, jview, v64)
          for v, v64, (jq, jv, jview) in zip(
              port_steps(ttm, probe, ops=ops),
              port_steps(ttm, probe, torch.float64, ops), jax_run[0])]


@pytest.mark.parametrize("which", ["cold", "warm"])
def test_quadruped_step_matches_jax(tile_models, two_steps, which):
  ttm, _ = tile_models
  tq, tv, tview, jq, jv, jview, view64 = two_steps[
      ("cold", "warm").index(which)]
  jl = np.asarray(jview.efc_lambda)
  kinds = np.asarray(tts.row_kinds(ttm))
  for kind in _KINDS:  # every row class carries force in some state
    assert np.abs(tview.efc_lambda.numpy()[kinds == kind]).max() > 0, kind
  scale = float(np.abs(jl).max())
  within_rounding(tq, jq, view64.qpos, 2e-5, "qpos")
  within_rounding(tv, jv, view64.qvel, 2e-4, "qvel")
  np.testing.assert_allclose(tview.efc_lambda.numpy(), jl,
                             atol=1e-4 * scale)
  for name in ("xpos", "xquat", "xmat", "xipos", "ximat", "cvel",
               "subtree_com", "site_xpos", "geom_xpos", "actuator_force",
               "mocap_pos", "userdata"):
    within_rounding(getattr(tview, name), getattr(jview, name),
                    getattr(view64, name), 2e-4, name)
  # the mocap pose overrides the goal body's kinematics
  goal = ttm.body_mocapid.index(0)
  np.testing.assert_array_equal(tview.xpos[goal].numpy(),
                                np.repeat(GOAL.T, B, 1))


@pytest.mark.parametrize("case", sorted(QUADRUPED_MODES))
def test_quadruped_residual_matches_jax(tasks, two_steps, case):
  """The port's residual and weight_mod on a StepView carried across from
  the JAX view, with each mode's userdata and parameters in both."""
  t, j = tasks
  u, params = quadruped_mode(t, case)
  jp = jnp.asarray(params.residual_params.numpy())
  jview = types.SimpleNamespace(**vars(two_steps[0][5]))
  jview.userdata = jnp.asarray(u[:, None])
  jview.time = jnp.float32(0.3)
  fields = {f.name: torch.tensor(np.asarray(getattr(jview, f.name)))
            for f in dataclasses.fields(tts.StepView)}
  view = tts.StepView(**fields)
  ours = tquad.residual(t.model, view, params.residual_params)
  theirs = j.residual(j.model, jview, jp)
  assert ours.shape == (42, B)
  np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-5)
  np.testing.assert_allclose(
      tquad.weight_mod(t.model, view, params.residual_params).numpy(),
      np.asarray(j.weight_mod(j.model, jview, jp)), atol=1e-5)


def _returns_inputs(t):
  """The returns check's start state, velocities and N candidates."""
  rng = np.random.RandomState(3)
  home = np.asarray(t.model.keyframe("home")[0], np.float32)
  qvel0 = rng.uniform(-0.2, 0.2, 18).astype(np.float32)
  acts = (np.asarray(t.default_ctrl()) + 0.2 * rng.randn(N, T, 12)
          ).astype(np.float32)
  return home, qvel0, acts


def test_quadruped_returns_match_jax(tasks, jax_run):
  """The port's CPU MegaRollout against the JAX composition (step_tb with
  the mocap and userdata operands, the quadruped residual, weight_mod and
  cost_value_t per step)."""
  t, _ = tasks
  home, qvel0, acts = _returns_inputs(t)
  got = tmr.MegaRollout(t, T, device="cpu").returns(
      torch.tensor(home), torch.tensor(qvel0), torch.tensor(acts), t.params,
      0.1, *(torch.tensor(x[..., 0]) for x in step_operands(t))
  ).numpy()
  want = jax_run[1]
  assert np.all(np.isfinite(got)) and np.all(got < tmr.MAX_RETURN)
  np.testing.assert_allclose(got, want, rtol=2e-3)


@one_torch_thread()
def test_quadruped_agent_plans_on_cpu():
  """Two plan iterations at a fixed state with the goal and a trot set
  through set_state: finite, and the best return does not rise (candidate
  0 is the previous winner). The Agent's defaults are 128 x 35 at
  agent_timestep 0.01."""
  agent = Agent("Quadruped Flat", device="cpu", horizon_steps=4)
  assert float(agent.task.model.opt.timestep) == pytest.approx(0.01)
  cfg = tsampling.SamplingConfig.from_task(agent.task)
  assert (cfg.num_trajectories, cfg.horizon) == (128, 35)
  agent.reset("home")
  agent.set_state(mocap_pos=GOAL, userdata=tquad.fsm_userdata(24))
  state = agent.get_state()
  np.testing.assert_array_equal(state["mocap_pos"], GOAL)
  assert state["userdata"][0] == tquad.GAIT_TROT
  best = []
  for _ in range(2):
    info = agent.planner_step()
    assert info.costs.shape == (128,)
    assert bool(torch.all(torch.isfinite(info.costs)))
    best.append(float(info.best_return))
  assert best[1] <= best[0]
  u = agent.action()
  assert u.shape == (12,) and np.all(np.isfinite(u))
  assert agent.planner.mega.launches == 0  # CPU tensors: the plain version
