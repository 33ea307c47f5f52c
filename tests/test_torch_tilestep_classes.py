"""The kernel's widened class in the port, held against the JAX tile path.

Small models built here through `mujoco` exercise what the Shadow hand
added to the class, each in isolation: a fixed tendon with a limit, a
spring (deadband) and a damper (tests/test_tilestep_classes.py:99-105); a
motor on a fixed tendon (:108-113); the condim-4 version of its ball model
(:164-184: plane-sphere and sphere-sphere with a torsional row each); and a
capsule pressing a box (capsule-box and plane-capsule points at condim 4,
plane-box corners at condim 3). Their residual is the state (qpos, qvel),
the JAX test's, which the kernel computes as residual_state.

The same float32 inputs, made with numpy from a seed, go through both
packages; the JAX tile step runs eagerly, as in
tests/test_torch_quadruped.py. Tolerances, with the errors measured when
they were set: one step, cold then warm, qpos atol 1e-6 (measured 6.0e-8),
qvel atol 1e-4 (4.8e-7), duals atol 1e-5 * max(max|duals|, 1) (4.8e-6 of
12.9), actuator forces atol 1e-5 (0); returns at n = 8, T = 8 rtol 2e-3
(measured 2.5e-7).
"""

import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_mpc_torch.ops import megarollout as tmr
from mujoco_mpc_torch.physics import io as tio
from mujoco_mpc_torch.physics import tilestep as tts
from mujoco_mpc_torch.tasks import base as tbase
from mujoco_mpc_tpu.ops import megarollout as jmr
from mujoco_mpc_tpu.physics import tilestep as jts
from tests.test_tilestep_classes import (_BALL_XML, _MOTOR_J1, _TENDON_XML,
                                         _make_task)

B, N, T = 8, 8, 8
# csrc/megarollout.cu residual_state: the residual (qpos, qvel)
STATE_RESIDUAL_ID = 5

_CAPBOX_XML = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.005"/>
  <worldbody>
    <geom name="floor" type="plane" size="2 2 0.1"/>
    <body name="arm" pos="0 0 0.2">
      <joint name="lift" type="slide" axis="0 0 1" damping="2"/>
      <joint name="tilt" type="hinge" axis="0 1 0" damping="0.5"/>
      <geom type="capsule" size="0.02" fromto="-0.08 0 0 0.08 0 0"
            mass="0.5" condim="4" friction="1 0.02 0.001"/>
    </body>
    <body name="box" pos="0 0 0.05">
      <freejoint/>
      <geom type="box" size="0.1 0.08 0.05" mass="1"/>
    </body>
  </worldbody>
  <actuator>
    <motor joint="lift" gear="10" ctrlrange="-1 1" ctrllimited="true"/>
    <motor joint="tilt" gear="1" ctrlrange="-1 1" ctrllimited="true"/>
  </actuator>
</mujoco>
"""

# name: (MJCF, start qpos (numpy), qvel noise, row classes that must carry
# force in the step test)
CLASS_MODELS = {
    "tendon_spring": (
        _TENDON_XML.format(
            attr='limited="true" range="-0.25 0.25" stiffness="3" '
                 'damping="0.5" springlength="0 0.05"',
            act=_MOTOR_J1, extra=""),
        [0.35, 0.1], 1.0, ("tendon_limit",)),
    "tendon_actuator": (
        _TENDON_XML.format(
            attr="", act='<motor tendon="t1" gear="1.5" ctrlrange="-1 1" '
                         'ctrllimited="true"/>', extra=""),
        [0.3, -0.2], 1.0, ()),
    "condim4_ball": (
        _BALL_XML.format(condim=4),
        # the ball 2 mm into the floor, the pusher into the ball
        [0.0, 0.0, 0.098, 1.0, 0.0, 0.0, 0.0, -0.33], 0.3,
        ("plane_sphere", "sphere_sphere", "torsional")),
    "capsule_box": (
        _CAPBOX_XML,
        # the capsule 5 mm into the box's top, the box 1 mm into the floor
        [-0.085, 0.05, 0.0, 0.0, 0.049, 1.0, 0.0, 0.0, 0.0], 0.3,
        ("cap_box", "plane_boxcorner", "torsional")),
}


def class_task(name, device="cpu"):
  """The port's Task of CLASS_MODELS[name]: the model, one QUADRATIC term
  on (qpos, qvel), and residual_state on the card."""
  mj = mujoco.MjModel.from_xml_string(CLASS_MODELS[name][0])
  m = tio.from_mjmodel(mj, dtype=torch.float32, device=device)
  spec = tbase.CostSpec(("State",), (0,), (m.nq + m.nv,))

  def f(x):
    return torch.tensor(x, dtype=torch.float32, device=device)

  params = tbase.TaskParams(weights=f([1.0]), norm_params=f([[0.0, 0.0]]),
                            risk=f(0.0), residual_params=f([]))
  return tbase.Task(
      model=m, params=params, name=name, spec=spec,
      residual=lambda model, data, p: torch.cat([data.qpos, data.qvel]),
      device_residual=tbase.DeviceResidual(STATE_RESIDUAL_ID))


def class_states(name, model, b, seed=0):
  """(qpos (nq, b), qvel (nv, b), ctrl (nu, b)) float32 numpy: the model's
  start state with noise; with a spin about the vertical on the free
  bodies, so the torsional rows carry force."""
  _, q0, vscale, _ = CLASS_MODELS[name]
  rng = np.random.RandomState(seed)
  qp = np.asarray(q0, np.float32)[:, None] + rng.uniform(
      -0.002, 0.002, (model.nq, b)).astype(np.float32)
  qv = vscale * rng.uniform(-1.0, 1.0, (model.nv, b))
  for j in range(model.njnt):
    if model.jnt_type[j] == 0:  # free joint: spin about z
      qv[model.jnt_dofadr[j] + 5] = rng.uniform(2.0, 4.0, b)
  ct = rng.uniform(-1.0, 1.0, (model.nu, b))
  return qp, qv.astype(np.float32), ct.astype(np.float32)


def jax_returns(j, jtm, qpos0, qvel0, actions, t0=0.0, ops=None):
  """The composition the JAX kernel's _rollout_body runs, eagerly: step_tb
  (with the mocap and userdata operands `ops`, shaped (nmocap, 3, 1),
  (nmocap, 4, 1), (nuserdata, 1)), the residual and cost_value_t per step,
  then the divergence guard."""
  n, horizon = actions.shape[:2]
  aux = {} if ops is None else dict(zip(
      ("mocap_pos", "mocap_quat", "userdata"), map(jnp.asarray, ops)))
  qpos = jnp.asarray(np.repeat(qpos0[:, None], n, 1))
  qvel = jnp.asarray(np.repeat(qvel0[:, None], n, 1))
  lam = jnp.zeros((max(jtm.nrow, 1), n), jnp.float32)
  total = jnp.zeros((n,), jnp.float32)
  p = j.params
  for i in range(horizon):
    qpos, qvel, view = jts.step_tb(jtm, qpos, qvel, jnp.asarray(actions[:, i].T),
                                   efc_lambda=lam, **aux)
    view.time = t0 + (i + 1) * jtm.timestep
    res = j.residual(j.model, view, p.residual_params)
    total = total + jmr.cost_value_t(j.spec, p.weights, p.norm_params, p.risk,
                                     res)
    lam = view.efc_lambda
  total = np.asarray(total / horizon)
  return np.where(np.isfinite(total), total, jmr.MAX_RETURN)


@pytest.fixture(scope="module", params=sorted(CLASS_MODELS))
def models(request):
  name = request.param
  t = class_task(name)
  j = _make_task(CLASS_MODELS[name][0])
  return name, t, j, tts.extract(t.model), jts.extract(j.model)


def test_class_model_extract_matches_jax(models):
  name, _, _, ours, theirs = models
  assert (ours.nrow, ours.ntor, ours.act_tendon) == (
      theirs.nrow, len(theirs.tor_pts), theirs.act_tendon)
  assert [(c.kind, c.condim, c.sign) for c in ours.con_points] == [
      (c.kind, c.condim, c.sign) for c in theirs.con_points]
  np.testing.assert_allclose([c.mu_tor for c in ours.con_points],
                             [c.mu_tor for c in theirs.con_points])
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


def test_class_model_step_matches_jax(models):
  """A cold step, then a warm-started one."""
  name, t, _, ttm, jtm = models
  qp, qv, ct = class_states(name, t.model, B)
  kinds = np.asarray(tts.row_kinds(ttm))
  tq, tv, tl = torch.tensor(qp), torch.tensor(qv), None
  jq, jv = jnp.asarray(qp), jnp.asarray(qv)
  jl = jnp.zeros((max(ttm.nrow, 1), B), jnp.float32)
  for _ in range(2):
    tq, tv, view = tts.step_tb(ttm, tq, tv, torch.tensor(ct), tl)
    tl = view.efc_lambda
    jq, jv, jview = jts.step_tb(jtm, jq, jv, jnp.asarray(ct), efc_lambda=jl)
    jl = jview.efc_lambda
    lam = tl.numpy()
    for kind in CLASS_MODELS[name][3]:
      assert np.abs(lam[kinds == kind]).max() > 0, kind
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)
    np.testing.assert_allclose(
        lam, np.asarray(jl), atol=1e-5 * max(float(np.abs(lam).max()), 1.0))
    np.testing.assert_allclose(view.actuator_force.numpy(),
                               np.asarray(jview.actuator_force), atol=1e-5)


def test_class_model_returns_match_jax(models):
  """The port's CPU MegaRollout against the JAX composition
  (jax_returns)."""
  name, t, j, _, jtm = models
  qp, _, _ = class_states(name, t.model, 1)
  q0 = qp[:, 0]
  v0 = np.zeros(t.model.nv, np.float32)
  acts = (0.4 * np.random.RandomState(5).randn(N, T, t.model.nu)
          ).astype(np.float32)
  got = tmr.MegaRollout(t, T, device="cpu").returns(
      torch.tensor(q0), torch.tensor(v0), torch.tensor(acts), t.params,
      0.0).numpy()
  want = jax_returns(j, jtm, q0, v0, acts)
  assert np.all(np.isfinite(got)) and np.all(got < tmr.MAX_RETURN)
  np.testing.assert_allclose(got, want, rtol=2e-3)


def test_condim6_and_equality_stay_outside_the_class():
  """Condim 6 and equality rows raise UnsupportedModel naming the Handover
  slice; they are not taken on a plain path."""
  for xml in (_BALL_XML.format(condim=6),
              _TENDON_XML.format(attr="", act=_MOTOR_J1,
                                 extra='<equality><joint joint1="j1" '
                                       'joint2="j2"/></equality>')):
    m = tio.from_mjmodel(mujoco.MjModel.from_xml_string(xml),
                         dtype=torch.float32, device="cpu")
    with pytest.raises(tts.UnsupportedModel, match="Handover slice"):
      tts.extract(m)
