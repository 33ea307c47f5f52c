"""Allegro (in-hand cube reorientation) in the port held against the JAX
package.

The same float32 inputs, made with numpy from a seed, go through both
packages, with the goal as an unnormalized mocap quaternion. The states
are allegro.probe_states: every constraint row class (box-box corners of
both boxes, capsule-box, plane-box corner, joint limit) carries force in at
least one of them. The JAX reference runs eagerly, without jax.jit
(compiling its tile path takes minutes on a CPU); its returns are the
composition MegaRollout.returns_xla runs (tests/test_torch_tilestep_classes
.py::jax_returns).

Tolerances, with the errors measured on a CPU host (the snapshot is
held equal to a fresh build in tests/test_torch_model.py):
  task and extract: integers exact, floats 1e-6 (measured 0);
  box-box corners against collision._box_box on the same geom frames:
    distances, positions and normals atol 1e-6 (float32; measured 0,
    3.7e-9 and 0: the two sum in other orders);
  one step, cold and warm, two float32 steps: each field per state
    within max(its atol, 8 times that state's distance of JAX's float32
    step from the port's float64 one) (torch_cases.within_rounding;
    parity with JAX is tests/test_torch_tilestep64.py's float64 hold):
    qpos atol 1e-5 (measured 1.2e-7), qvel atol 1e-3 (6.2e-6), the view
    fields the residual reads atol 2e-4 (2.4e-7, the actuator forces);
    duals per row class atol 1e-4 * max|duals| (3.8e-6 of 28.2);
  residual on the same view: atol 1e-5;
  returns at n = 8, T = 4: rtol 2e-3 (measured 0).
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
from mujoco_mpc_torch.tasks import allegro as tall
from mujoco_mpc_torch.tasks import registry as treg
from mujoco_mpc_tpu.physics import collision as jcol
from mujoco_mpc_tpu.physics import tilestep as jts
from mujoco_mpc_tpu.tasks import registry as jreg
from tests.test_torch_model import _same
from tests.test_torch_tilestep_classes import shared_probe_and_returns
from tests.torch_cases import (SHADOW_GOAL, one_torch_thread, port_steps,
                               step_operands, within_rounding)
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

B, N, T = 8, 8, 4
_KINDS = ("boxbox_corner", "cap_box", "plane_boxcorner", "joint_limit")
GOAL = np.asarray(SHADOW_GOAL, np.float32)


@pytest.fixture(scope="module")
def tasks():
  return (treg.get_task("Allegro", device="cpu"),
          jreg.get_task("Allegro", dtype=jnp.float32))


@pytest.fixture(scope="module")
def tile_models(tasks):
  t, j = tasks
  return tts.extract(t.model), jts.extract(j.model)


def test_allegro_task_matches_jax_task(tasks):
  t, j = tasks
  assert (t.spec.names, t.spec.norm_types, t.spec.dims) == (
      j.spec.names, j.spec.norm_types, j.spec.dims)
  assert t.spec.nresidual == 45
  assert t.param_names == j.param_names
  for f in ("weights", "norm_params", "risk", "residual_params"):
    _same(f, getattr(t.params, f), np.asarray(getattr(j.params, f)), 1e-6)
  _same("default_ctrl", t.default_ctrl(), np.asarray(j.default_ctrl()), 1e-6)


def test_allegro_extract_matches_jax(tile_models):
  """Kinds, owners, corners, sizes and the row layout: 16 box-box corners
  (the cube's, then the palm's), 16 capsule-box and 8 plane-box corner
  points, nrow 144 = 120 translational + 24 joint-limit rows."""
  ours, theirs = tile_models
  assert (ours.nq, ours.nv, ours.nu, ours.nbody, ours.njnt) == (
      19, 18, 12, 11, 13)
  assert (ours.ncon, ours.nrow, ours.nmocap) == (
      theirs.ncon, theirs.nrow, theirs.nmocap) == (40, 144, 1)
  for f in dataclasses.fields(ours):
    if f.name != "con_points":
      _same(f.name, getattr(ours, f.name), getattr(theirs, f.name), 1e-6)
  for i, (a, b) in enumerate(zip(ours.con_points, theirs.con_points)):
    for f in dataclasses.fields(a):
      _same(f"con_points[{i}].{f.name}", getattr(a, f.name),
            getattr(b, f.name), 1e-6)
  boxbox = [cp for cp in ours.con_points if cp.kind == "boxbox_corner"]
  assert [cp.owner for cp in boxbox] == [2] * 8 + [1] * 8
  assert [tuple(cp.corner) for cp in boxbox[:8]] == [
      (sx, sy, sz) for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
  np.testing.assert_array_equal(
      boxbox[0].size1, np.float32([0.065, 0.05, 0.012]))  # the palm
  np.testing.assert_array_equal(boxbox[0].size2, np.float32([0.03] * 3))
  assert {cp.condim for cp in ours.con_points} == {3}
  kinds = tts.row_kinds(ours)
  assert [kinds.count(k) for k in _KINDS] == [48, 48, 24, 24]


@pytest.fixture(scope="module")
def jax_run(tasks, tile_models, tmp_path_factory):
  """One JAX rollout for the one-step checks and the returns check
  (tests/test_torch_tilestep_classes.py::jax_probe_and_returns), once a
  session."""
  t, j = tasks
  _, jtm = tile_models
  return shared_probe_and_returns(
      tmp_path_factory, "allegro", j, jtm, tall.probe_states(t.model, B),
      *_returns_inputs(t), 0.1, step_operands(t))


@pytest.fixture(scope="module")
def two_steps(tasks, tile_models, jax_run):
  """A cold step, then a warm-started one, in both packages, and the
  port's in float64 (the rounding witness)."""
  t, _ = tasks
  ttm, _ = tile_models
  probe, ops = tall.probe_states(t.model, B), step_operands(t)
  return [(v.qpos, v.qvel, v, jq, jv, jview, v64)
          for v, v64, (jq, jv, jview) in zip(
              port_steps(ttm, probe, ops=ops),
              port_steps(ttm, probe, torch.float64, ops), jax_run[0])]


@pytest.mark.parametrize("which", ["cold", "warm"])
def test_allegro_step_matches_jax(tile_models, two_steps, which):
  ttm, _ = tile_models
  tq, tv, tview, jq, jv, jview, view64 = two_steps[
      ("cold", "warm").index(which)]
  jl = np.asarray(jview.efc_lambda)
  lam = tview.efc_lambda.numpy()
  kinds = np.asarray(tts.row_kinds(ttm))
  scale = float(np.abs(jl).max())
  for kind in _KINDS:
    np.testing.assert_allclose(lam[kinds == kind], jl[kinds == kind],
                               atol=1e-4 * scale, err_msg=kind)
  within_rounding(tq, jq, view64.qpos, 1e-5, "qpos")
  within_rounding(tv, jv, view64.qvel, 1e-3, "qvel")
  for name in ("xpos", "xquat", "xmat", "site_xpos", "actuator_force",
               "mocap_quat"):
    within_rounding(getattr(tview, name), getattr(jview, name),
                    getattr(view64, name), 2e-4, name)


def test_allegro_every_row_class_carries_force(tile_models, two_steps):
  """On the cold step every row class carries force on some probe state,
  the box-box corners of both boxes among them: the cube's on the palm,
  the palm's in the cube's bottom face."""
  ttm, _ = tile_models
  lam = np.abs(two_steps[0][2].efc_lambda.numpy())
  kinds = np.asarray(tts.row_kinds(ttm))
  for kind in _KINDS:
    assert lam[kinds == kind].max() > 0, kind
  fric = tts.row_points(ttm)[0]
  for owner in (1, 2):
    rows = [3 * i for i, cp in enumerate(fric)
            if cp.kind == "boxbox_corner" and cp.owner == owner]
    assert lam[rows].max() > 0, owner


def test_allegro_boxbox_geometry_matches_jax(tile_models, two_steps):
  """The 16 box-box corners of the palm-cube pair (distance, position,
  normal) against collision._box_box on the same geom frames, at every
  probe state's pre-step pose."""
  ttm, _ = tile_models
  view = two_steps[0][2]
  boxbox = [cp for cp in ttm.con_points if cp.kind == "boxbox_corner"]
  g1, g2 = boxbox[0].g1, boxbox[0].g2

  def geom_frame(g):
    bg = ttm.geom_bodyid[g]
    return (view.xpos[bg] + tts._quat_rot(view.xquat[bg],
                                          tts._c(ttm.geom_pos[g])),
            tts._quat_mul(view.xquat[bg], tts._c(ttm.geom_quat[g])))

  memo = {}
  ours = [tts._contact_geometry(ttm, cp, geom_frame, None, memo)
          for cp in boxbox]
  (p1, q1), (p2, q2) = geom_frame(g1), geom_frame(g2)
  m1, m2 = tts._quat_to_mat(q1).numpy(), tts._quat_to_mat(q2).numpy()
  for b in range(B):
    theirs = jcol._box_box(
        jnp.asarray(p1[:, b].numpy()), jnp.asarray(m1[..., b]),
        jnp.asarray(p2[:, b].numpy()), jnp.asarray(m2[..., b]),
        jnp.asarray(boxbox[0].size1), jnp.asarray(boxbox[0].size2))
    for i, (dist, pos, n) in enumerate(theirs):
      d, frame, cpos = ours[i]
      np.testing.assert_allclose(float(d[b]), float(dist), atol=1e-6)
      np.testing.assert_allclose(cpos[:, b].numpy(), np.asarray(pos),
                                 atol=1e-6)
      np.testing.assert_allclose(frame[0, :, b].numpy(), np.asarray(n),
                                 atol=1e-6)
  active = np.asarray([d.numpy() < 0 for d, _, _ in ours])
  assert active[:8].any() and active[8:].any()  # both boxes' corners


def test_allegro_residual_matches_jax(tasks, two_steps):
  """The port's residual on a StepView carried across from the JAX view."""
  t, j = tasks
  jview = types.SimpleNamespace(**vars(two_steps[1][5]))
  jview.time = jnp.float32(0.3)
  fields = {f.name: torch.tensor(np.asarray(getattr(jview, f.name)))
            for f in dataclasses.fields(tts.StepView)}
  view = tts.StepView(**fields)
  ours = tall.residual(t.model, view, t.params.residual_params)
  theirs = j.residual(j.model, jview, j.params.residual_params)
  assert ours.shape == (45, B)
  np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-5)


def _returns_inputs(t):
  """The returns check's start state (the cube over a palm corner, probe
  state 1), velocities and N candidates."""
  rng = np.random.RandomState(3)
  start = tall.probe_states(t.model, 2)[0][:, 1]
  qvel0 = rng.uniform(-0.2, 0.2, 18).astype(np.float32)
  acts = (np.asarray(t.default_ctrl()) + 0.2 * rng.randn(N, T, 12)
          ).astype(np.float32)
  return start, qvel0, acts


def test_allegro_returns_match_jax(tasks, jax_run):
  """The port's CPU MegaRollout against the JAX composition, with the
  goal, from the cube over a palm corner."""
  t, _ = tasks
  start, qvel0, acts = _returns_inputs(t)
  got = tmr.MegaRollout(t, T, device="cpu").returns(
      torch.tensor(start), torch.tensor(qvel0), torch.tensor(acts),
      t.params, 0.1,
      *(torch.tensor(x[..., 0]) for x in step_operands(t))).numpy()
  want = jax_run[1]
  assert np.all(np.isfinite(got)) and np.all(got < tmr.MAX_RETURN)
  np.testing.assert_allclose(got, want, rtol=2e-3)


@one_torch_thread()
def test_allegro_agent_plans_on_cpu():
  """Two plan iterations at a fixed state with the goal set through
  set_state: finite, and the best return does not rise (candidate 0 is the
  previous winner). The Agent's defaults are 256 x 40 at agent_timestep
  0.01."""
  agent = Agent("Allegro", device="cpu", horizon_steps=4)
  assert float(agent.task.model.opt.timestep) == pytest.approx(0.01)
  cfg = tsampling.SamplingConfig.from_task(agent.task)
  assert (cfg.num_trajectories, cfg.horizon) == (256, 40)
  agent.reset("home")
  agent.set_state(mocap_quat=GOAL)
  best = []
  for _ in range(2):
    info = agent.planner_step()
    assert info.costs.shape == (256,)
    assert bool(torch.all(torch.isfinite(info.costs)))
    best.append(float(info.best_return))
  assert best[1] <= best[0]
  u = agent.action()
  assert u.shape == (12,) and np.all(np.isfinite(u))
  assert agent.planner.mega.launches == 0  # CPU tensors: the plain version
