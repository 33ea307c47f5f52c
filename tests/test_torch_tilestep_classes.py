"""The kernel's widened class in the port, held against the JAX tile path.

Small models exercise the class's row kinds in isolation
(mujoco_mpc_torch/tasks/class_models.py, whose MJCF are the JAX tests'
models, tests/test_tilestep_classes.py, built here through `mujoco`): a
fixed tendon with a limit, a spring (deadband) and a damper (:99-105); a
motor on a fixed tendon (:108-113); a joint equality with a quadratic
coupling (:116-122); a connect and a weld equality between two bodies
(:151-161); the condim-4 and condim-6 versions of its ball model
(:164-196: plane-sphere and sphere-sphere with a torsional row each, and at
condim 6 two rolling rows each); a capsule pressing a box (capsule-box and
plane-capsule points at condim 4, plane-box corners at condim 3); and the
port's own ball chain (a ball joint mid-chain with a limited hinge after
it; sphere-capsule, plane-sphere and plane-capsule points). Their residual
is the state (qpos, qvel), the JAX test's, which the kernel computes as
residual_state.

The same float32 inputs, made with numpy from a seed, go through both
packages; the JAX tile step runs eagerly, as in
tests/test_torch_quadruped.py. Tolerances, with the errors measured on a
CPU host: one step, cold then warm, qpos atol 1e-6 (measured 1.2e-7, the
ball and capsule-box models), qvel atol 1e-4 (1.4e-6, the joint
equality), duals atol 1e-5 * max(max|duals|, 1) (4.8e-6 of 5.9, the
joint equality; 1.5e-6 of 1, the tendon spring), except the ball chain's
qpos atol 1e-5 (measured 1.9e-6), qvel 1e-3 (3.1e-4) and duals 1e-4 *
max (0.33 of 1.38e4 cold; 0.052 of 931 warm, a margin under 2, so its
duals take the rounding witness, tests/torch_cases.py::within_rounding:
per state within max(that atol, 8 times JAX's float32 distance from the
port's float64 step, 0.035 there, a margin of 5.4)): its tip pressing
the floor through the chain is ill-conditioned in float32, where the
port's own float32 step is 3.5e-6 (qpos) and 4.4e-4 (qvel) from its
float64 step, and JAX's 2.6e-4 (qvel); actuator forces atol 1e-5 (0);
returns at n = 8, T = 8 rtol 2e-3 (measured 2.5e-7). A snapshot equals a fresh build exactly.
"""

import dataclasses
import types

import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_mpc_torch.ops import megarollout as tmr
from mujoco_mpc_torch.physics import io as tio
from mujoco_mpc_torch.physics import tilestep as tts
from mujoco_mpc_torch.tasks import class_models
from mujoco_mpc_tpu.ops import megarollout as jmr
from mujoco_mpc_tpu.physics import tilestep as jts
from tests import test_tilestep_classes as jtests
from tests.test_torch_model import _same
from tests.torch_cases import port_steps, within_rounding
from tests.torch_engine_cases import release_jax_executables  # noqa: F401
from tests.torch_engine_cases import session_result

B, N, T = 8, 8, 8
# name: ClassModel (MJCF, start qpos, qvel scale, row classes that must
# carry force in the step test)
CLASS_MODELS = class_models.MODELS
# (qpos, qvel, duals / max|duals|) atol of the one-step check (the module
# docstring)
_STEP_TOL = {"ball_chain": (1e-5, 1e-3, 1e-4)}
# the models whose float32 duals take the rounding witness
# (torch_cases.within_rounding): their measured margin is under 2x
_DUALS_WITNESS = ("ball_chain",)


def class_task(name, device="cpu"):
  """The port's Task of CLASS_MODELS[name], its model built through
  mujoco: one QUADRATIC term on (qpos, qvel), residual_state on the
  card."""
  m = tio.from_mjmodel(class_models.build(name), dtype=torch.float32,
                       device=device)
  return class_models.task(name, device=device, model=m)


def jax_rollout(j, jtm, qpos, qvel, ctrl, t0=0.0, ops=None):
  """The composition the JAX kernel's _rollout_body runs, eagerly, on the
  columns qpos (nq, M), qvel (nv, M) with controls ctrl (T, nu, M):
  step_tb (with the mocap and userdata operands `ops`, shaped (nmocap, 3,
  1), (nmocap, 4, 1), (nuserdata, 1)), the residual, the task's
  weight_mod and cost_value_t per step, then the divergence guard. Each
  column is computed alone. Returns each step's (qpos, qvel, view) and the
  returns (M,)."""
  aux = {} if ops is None else dict(zip(
      ("mocap_pos", "mocap_quat", "userdata"), map(jnp.asarray, ops)))
  qpos, qvel = jnp.asarray(qpos), jnp.asarray(qvel)
  m = qpos.shape[1]
  lam = jnp.zeros((max(jtm.nrow, 1), m), jnp.float32)
  total = jnp.zeros((m,), jnp.float32)
  p = j.params
  steps = []
  for i in range(ctrl.shape[0]):
    qpos, qvel, view = jts.step_tb(jtm, qpos, qvel, jnp.asarray(ctrl[i]),
                                   efc_lambda=lam, **aux)
    view.time = t0 + (i + 1) * jtm.timestep
    res = j.residual(j.model, view, p.residual_params)
    scale = (j.weight_mod(j.model, view, p.residual_params)
             if j.weight_mod is not None else None)
    total = total + jmr.cost_value_t(j.spec, p.weights, p.norm_params, p.risk,
                                     res, scale)
    lam = view.efc_lambda
    steps.append((qpos, qvel, view))
  total = np.asarray(total / ctrl.shape[0])
  return steps, np.where(np.isfinite(total), total, jmr.MAX_RETURN)


def jax_returns(j, jtm, qpos0, qvel0, actions, t0=0.0, ops=None):
  """jax_rollout's returns of actions (N, T, nu) from (qpos0, qvel0)."""
  n = actions.shape[0]
  return jax_rollout(j, jtm, np.repeat(qpos0[:, None], n, 1),
                     np.repeat(qvel0[:, None], n, 1),
                     np.transpose(actions, (1, 2, 0)), t0, ops)[1]


class _FirstColumns:
  """The first b columns of a lazy view's arrays, taken when read (the
  JAX step's contact view)."""

  def __init__(self, inner, b):
    self._inner, self._b = inner, b

  def __getattr__(self, name):
    return getattr(self._inner, name)[..., :self._b]


def _first_columns(view, b):
  """The JAX step's view of the first b columns (the rollout-constant
  operands and the time as they are)."""
  out = types.SimpleNamespace()
  for k, x in vars(view).items():
    if k == "contact":
      x = _FirstColumns(x, b)
    elif k not in ("mocap_pos", "mocap_quat", "userdata", "time") and \
        x is not None:
      x = x[..., :b]
    setattr(out, k, x)
  return out


def jax_probe_and_returns(j, jtm, probe, qpos0, qvel0, actions, t0=0.0,
                          ops=None):
  """One JAX rollout serves a module's one-step checks and its returns
  check: the probe states (qpos (nq, B), qvel (nv, B), ctrl (nu, B)) and
  the N candidates of jax_returns go through jax_rollout as B + N columns,
  the probe states holding their ctrl. Returns the probe columns' (qpos,
  qvel, view) after the first (cold) and the second (warm) step, and the
  candidates' returns."""
  qp, qv, ct = probe
  b, (n, t) = qp.shape[1], actions.shape[:2]
  steps, returns = jax_rollout(
      j, jtm, np.concatenate([qp, np.repeat(qpos0[:, None], n, 1)], 1),
      np.concatenate([qv, np.repeat(qvel0[:, None], n, 1)], 1),
      np.concatenate([np.repeat(ct[None], t, 0),
                      np.transpose(actions, (1, 2, 0))], 2), t0, ops)
  return ([(np.asarray(q)[:, :b], np.asarray(v)[:, :b],
            _first_columns(view, b)) for q, v, view in steps[:2]],
          returns[b:])


def _numpy_contact(contact):
  """The contact view's dist and frame as numpy, each where JAX can read
  it (a model without contact points has no frame to read)."""
  out = types.SimpleNamespace()
  for k in ("dist", "frame"):
    try:
      setattr(out, k, np.asarray(getattr(contact, k)))
    except (TypeError, ValueError):
      pass
  return out


def _numpy_view(view):
  """A JAX step's view as numpy arrays (its contact view read), which
  pickles."""
  out = types.SimpleNamespace()
  for k, x in vars(view).items():
    if k == "contact":
      x = _numpy_contact(x)
    elif x is not None and not isinstance(x, float):
      x = np.asarray(x)
    setattr(out, k, x)
  return out


def shared_probe_and_returns(tmp_path_factory, name, *args, **kwargs):
  """jax_probe_and_returns(*args, **kwargs), once a session for `name`
  (torch_engine_cases.session_result), with its views as numpy."""
  def compute():
    steps, returns = jax_probe_and_returns(*args, **kwargs)
    return [(q, v, _numpy_view(view)) for q, v, view in steps], returns
  return session_result(tmp_path_factory, f"probe_{name}", compute)


def models_fixture(names):
  """A module fixture over `names`: (name, the port's Task, the JAX Task,
  both TileModels). The per-model tests below run over the chain models
  here (the ball chain among them) and the three JAX contact models in
  test_torch_tilestep_classes_b.py, so that the test workers share them
  out, each module's models sharing most of their eager JAX primitives."""

  @pytest.fixture(scope="module", params=names)
  def models(request):
    name = request.param
    t = class_task(name)
    j = jtests._make_task(CLASS_MODELS[name].xml)
    return name, t, j, tts.extract(t.model), jts.extract(j.model)
  return models


HALF_A = ("ball_chain", "connect", "joint_equality", "tendon_actuator",
          "tendon_spring", "weld")
models = models_fixture(HALF_A)


def test_class_models_are_the_jax_tests_models():
  """The port's copies of the JAX tests' MJCF are the same text."""
  for ours, theirs in ((class_models.TENDON_XML, jtests._TENDON_XML),
                       (class_models.CHAIN_XML, jtests._CHAIN_XML),
                       (class_models.BALL_XML, jtests._BALL_XML),
                       (class_models.MOTOR_J1, jtests._MOTOR_J1)):
    assert ours == theirs


@pytest.mark.parametrize("name", sorted(CLASS_MODELS))
def test_class_model_snapshot_matches_fresh_build(name):
  """The committed snapshot (what the card's host loads) is exactly what
  from_mjmodel builds now."""
  fresh = tio.from_mjmodel(class_models.build(name), dtype=torch.float64,
                           device="cpu")
  snap = class_models.task(name, torch.float64, "cpu").model
  for f in dataclasses.fields(fresh):
    if f.name == "opt":
      for g in dataclasses.fields(fresh.opt):
        _same(g.name, getattr(fresh.opt, g.name), getattr(snap.opt, g.name),
              0.0)
    else:
      _same(f.name, getattr(fresh, f.name), getattr(snap, f.name), 0.0)


def test_class_model_extract_matches_jax(models):
  name, _, _, ours, theirs = models
  assert (ours.nrow, ours.ntor, ours.nroll, ours.neq_rows,
          ours.act_tendon) == (theirs.nrow, len(theirs.tor_pts),
                               len(theirs.roll_pts), theirs.neq_rows,
                               theirs.act_tendon)
  assert [(c.kind, c.condim, c.sign) for c in ours.con_points] == [
      (c.kind, c.condim, c.sign) for c in theirs.con_points]
  for f in ("mu_tor", "mu_roll"):
    np.testing.assert_allclose([getattr(c, f) for c in ours.con_points],
                               [getattr(c, f) for c in theirs.con_points])
  assert len(ours.eq_rows) == len(theirs.eq_rows)
  for a, b in zip(ours.eq_rows, theirs.eq_rows):
    assert (a.kind, a.ob1, a.ob2, a.nrows) == (b.kind, b.ob1, b.ob2, b.nrows)
    for f in ("data", "solref", "solimp", "diagapprox"):
      np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=1e-7,
                                 err_msg=f)
  # the port holds the coefficients at float32, as the kernel does
  assert [[w[:2] for w in ws] for ws in ours.ten_wraps] == [
      [w[:2] for w in ws] for ws in theirs.ten_wraps]
  np.testing.assert_allclose(
      [w[2] for ws in ours.ten_wraps for w in ws],
      [w[2] for ws in theirs.ten_wraps for w in ws], rtol=1e-7)
  for f in ("ten_stiffness", "ten_damping", "ten_lengthspring"):
    np.testing.assert_allclose(getattr(ours, f), getattr(theirs, f))
  if name == "tendon_actuator":
    assert ours.act_tendon == (0,) and ours.nrow == 0
  if name == "tendon_spring":
    assert float(ours.ten_stiffness[0]) == 3.0 and ours.ten_lim == (0,)
  if name == "capsule_box":
    assert tts.row_kinds(ours).count("cap_box") == 6  # 2 points x 3 rows
  if name == "condim6_ball":
    assert tts.row_kinds(ours).count("rolling") == 2 * ours.ncon
  if name in ("joint_equality", "connect", "weld"):
    assert ours.neq_rows == {"joint_equality": 1, "connect": 3,
                             "weld": 6}[name]
  if name == "ball_chain":  # the ball's 4 qpos and 3 dofs mid-chain
    assert (ours.jnt_qposadr, ours.jnt_dofadr) == ((0, 1, 5, 6), (0, 1, 4, 5))
    assert ours.dof_body == theirs.dof_body == (1, 2, 2, 2, 3, 4)
    assert tts.row_kinds(ours).count("sphere_cap") == 3



def _returns_inputs(name, t):
  """The returns check's start state (the model's first state), zero
  velocities and N candidates."""
  qp, _, _ = class_models.states(name, t.model, 1)
  acts = (0.4 * np.random.RandomState(5).randn(N, T, t.model.nu)
          ).astype(np.float32)
  return qp[:, 0], np.zeros(t.model.nv, np.float32), acts


@pytest.fixture(scope="module")
def jax_run(models, tmp_path_factory):
  """One JAX rollout for the one-step check and the returns check
  (jax_probe_and_returns), once a session."""
  name, t, j, _, jtm = models
  return shared_probe_and_returns(
      tmp_path_factory, f"class_{name}", j, jtm,
      class_models.states(name, t.model, B), *_returns_inputs(name, t))


def test_class_model_step_matches_jax(models, jax_run):
  """A cold step, then a warm-started one; the port's float64 steps are
  the rounding witness of _DUALS_WITNESS's duals."""
  name, t, _, ttm, _ = models
  probe = class_models.states(name, t.model, B)
  kinds = np.asarray(tts.row_kinds(ttm))
  for view, view64, (jq, jv, jview) in zip(
      port_steps(ttm, probe), port_steps(ttm, probe, torch.float64),
      jax_run[0]):
    jl = jview.efc_lambda
    lam = view.efc_lambda.numpy()
    for kind in CLASS_MODELS[name].kinds:
      assert np.abs(lam[kinds == kind]).max() > 0, kind
    tol_q, tol_v, tol_l = _STEP_TOL.get(name, (1e-6, 1e-4, 1e-5))
    np.testing.assert_allclose(view.qpos.numpy(), np.asarray(jq), atol=tol_q)
    np.testing.assert_allclose(view.qvel.numpy(), np.asarray(jv), atol=tol_v)
    tol_l *= max(float(np.abs(lam).max()), 1.0)
    if name in _DUALS_WITNESS:
      within_rounding(lam, jl, view64.efc_lambda, tol_l, "duals")
    else:
      np.testing.assert_allclose(lam, np.asarray(jl), atol=tol_l)
    np.testing.assert_allclose(view.actuator_force.numpy(),
                               np.asarray(jview.actuator_force), atol=1e-5)


def test_class_model_returns_match_jax(models, jax_run):
  """The port's CPU MegaRollout against the JAX composition
  (jax_rollout)."""
  name, t, _, _, _ = models
  q0, v0, acts = _returns_inputs(name, t)
  got = tmr.MegaRollout(t, T, device="cpu").returns(
      torch.tensor(q0), torch.tensor(v0), torch.tensor(acts), t.params,
      0.0).numpy()
  want = jax_run[1]
  assert np.all(np.isfinite(got)) and np.all(got < tmr.MAX_RETURN)
  np.testing.assert_allclose(got, want, rtol=2e-3)


def test_condim6_and_equality_stay_outside_the_class():
  """Condim 6 and the equality rows are in the class now (the models
  above), and so are the box-box pair (16 points, here at condim 6: a
  torsional and two rolling rows each), the sphere-capsule pair and ball
  joints: the JAX kernel's whole class. What stays outside is what the
  JAX extract refuses, as tests/test_torch_model.py::
  test_quaternion_joint_refusals_match_jax holds."""
  box_box = ("<mujoco><worldbody>" + "".join(
      f"<body pos='0 0 {i}'><freejoint/><geom type='box' size='.1 .1 .1' "
      "condim='6'/></body>" for i in range(2)) + "</worldbody></mujoco>")
  tm = tts.extract(tio.from_mjmodel(mujoco.MjModel.from_xml_string(box_box),
                                    dtype=torch.float32, device="cpu"))
  assert (tm.ncon, tm.ntor, tm.nroll, tm.nrow) == (16, 16, 16, 96)
  ball = class_models.CHAIN_XML.format(eq="").replace(
      '<joint name="j3" type="hinge"', '<joint name="j3" type="ball"')
  sphere_cap = jtests._BALL_XML.format(condim=6).replace(
      'type="sphere" size="0.08"', 'type="capsule" size="0.08 0.05"')
  for xml, kind in ((sphere_cap, "sphere_cap"), (ball, None)):
    tm = tts.extract(tio.from_mjmodel(mujoco.MjModel.from_xml_string(xml),
                                      dtype=torch.float32, device="cpu"))
    if kind:
      assert [cp.kind for cp in tm.con_points].count(kind) == 1
    else:
      assert tm.nv == 5 and tm.dof_body[2:] == (3, 3, 3)
