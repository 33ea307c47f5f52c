"""mujoco_mpc_torch model loading held against the JAX package.

The same MjModel goes through both packages' from_mjmodel; the JAX Model is
carried across with mujoco_mpc_torch.convert and compared field by field
(integers and booleans exactly, floats to 1e-6). The port's tile extraction
is compared with mujoco_mpc_tpu.physics.tilestep.extract the same way.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_torch import convert
from mujoco_mpc_torch.agent.agent import Agent
from mujoco_mpc_torch.ops import megarollout as tmr
from mujoco_mpc_torch.physics import io as tio
from mujoco_mpc_torch.physics import tilestep as tts
from mujoco_mpc_torch.planners import sampling as tsampling
from mujoco_mpc_torch.tasks import allegro as tallegro
from mujoco_mpc_torch.tasks import class_models
from mujoco_mpc_torch.tasks import dm_suite
from mujoco_mpc_torch.tasks import registry as treg
from mujoco_mpc_tpu.physics import io as jio
from mujoco_mpc_tpu.physics import tilestep as jts
from mujoco_mpc_tpu.tasks import registry as jreg
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(name, a, b, atol):
  """Field equality: tensors/arrays by value, dataclasses (a Data's
  Contact) field by field, everything else by ==."""
  if dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b):
    for f in dataclasses.fields(a):
      _same(f"{name}.{f.name}", getattr(a, f.name), getattr(b, f.name), atol)
    return
  if isinstance(a, torch.Tensor):
    a = a.cpu().numpy()
  if isinstance(b, torch.Tensor):
    b = b.cpu().numpy()
  if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, name
    if np.issubdtype(a.dtype, np.floating):
      np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=name)
    else:
      np.testing.assert_array_equal(a, b, err_msg=name)
  else:
    assert a == b, name


@pytest.fixture(scope="module")
def walker_mj():
  return dm_suite.build_walker()


def test_from_mjmodel_matches_jax_model(walker_mj):
  ours = tio.from_mjmodel(walker_mj, dtype=torch.float32, device="cpu")
  jm = jio.from_mjmodel(walker_mj, dtype=jnp.float32)
  theirs = convert.model(jax.tree_util.tree_map(np.asarray, jm), "cpu")
  for f in dataclasses.fields(ours):
    if f.name == "opt":
      for g in dataclasses.fields(ours.opt):
        _same(f"opt.{g.name}", getattr(ours.opt, g.name),
              getattr(theirs.opt, g.name), 1e-6)
    else:
      _same(f.name, getattr(ours, f.name), getattr(theirs, f.name), 1e-6)
  assert ours.body("torso") == jm.body("torso")
  assert ours.custom("agent_timestep") == jm.custom("agent_timestep")
  assert ours.keyframe("home") == jm.keyframe("home")


def _snapshot_matches_fresh_build(builder, stem):
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
  return snap


def test_walker_snapshot_matches_fresh_build():
  """The committed snapshot is exactly what from_mjmodel builds now."""
  _snapshot_matches_fresh_build(dm_suite.build_walker, "walker")


def test_allegro_snapshot_matches_fresh_build():
  """The Allegro snapshot likewise (tasks/models/allegro.npz, from the
  XML copy beside it)."""
  snap = _snapshot_matches_fresh_build(tallegro.build_allegro, "allegro")
  assert (snap.nq, snap.nv, snap.nu, snap.nmocap, snap.nsite) == (
      19, 18, 12, 1, 1)


# the nine flat-ground tasks of ROADMAP queue 1 items 11a and 11b
_FLAT_TASKS = ("OP3", "Pick", "PickAndPlace", "Bimanual Reorient",
               "Humanoid Interact", "Quadrotor", "Swimmer", "Rubik",
               "Humanoid Track")
# and the two whose models have mesh and heightfield pairs (item 11c)
_MESH_TASKS = ("Bimanual Insert", "Quadruped Hill")


@pytest.mark.parametrize("name", _FLAT_TASKS + _MESH_TASKS)
def test_flat_task_snapshot_matches_fresh_build(name):
  """Each flat-ground task's snapshot is exactly what from_mjmodel builds
  now from its builder (an MJCF copy or a dm_suite builder), and the task
  equals the JAX package's: cost spec, parameters, sizes, and for the
  mesh and heightfield tasks the hulls and the field."""
  stem, builder = treg._SNAPSHOTS[name]
  snap = _snapshot_matches_fresh_build(builder, stem)
  t = treg.get_task(name, dtype=torch.float64, device="cpu")
  j = jreg.get_task(name, dtype=jnp.float64)
  assert (t.spec.names, t.spec.norm_types, t.spec.dims, t.param_names) == (
      j.spec.names, j.spec.norm_types, j.spec.dims, j.param_names)
  assert t.mode_names == j.mode_names
  for f in ("weights", "norm_params", "risk", "residual_params"):
    _same(f, getattr(t.params, f), np.asarray(getattr(j.params, f)), 0.0)
  for f in ("nq", "nv", "nu", "nbody", "nmocap", "nuserdata"):
    assert getattr(snap, f) == getattr(j.model, f), f
  if name in _MESH_TASKS:
    for f in ("mesh_hullvert", "mesh_facenorm", "hfield_data",
              "hfield_size"):
      ours, theirs = getattr(snap, f), getattr(j.model, f)
      assert (ours is None) == (theirs is None), f
      if ours is not None:
        _same(f, ours, np.asarray(theirs), 0.0)


def test_flat_task_files_are_the_jax_packages():
  """The port's copies of the flat-ground tasks' MJCF and of Humanoid
  Track's recorded clips are the JAX package's bytes."""
  files = ["op3.xml", "panda_pick.xml", "panda_bring.xml",
           "bimanual_reorient.xml", "quadrotor.xml", "rubik_hand.xml",
           "bimanual_insert.xml", "quadruped_hill.xml"] + [
               f"assets/clips/{c}.npz" for c in ("balance", "jog",
                                                 "strider")] + [
               f"assets/connector/{f}" for f in (
                   "mcX_m_collision_mcX_m_MESH.stl",
                   "mcX_f_collision_mcX_f_MESH.stl", "README.md")]
  for name in files:
    with open(f"{REPO}/mujoco_mpc_torch/tasks/models/{name}", "rb") as a, \
        open(f"{REPO}/mujoco_mpc_tpu/tasks/models/{name}", "rb") as b:
      assert a.read() == b.read(), name


def test_task_matches_jax_task():
  ours = treg.get_task("Walker", device="cpu")
  theirs = jreg.get_task("Walker", dtype=jnp.float32)
  assert tuple(ours.spec.names) == tuple(theirs.spec.names)
  assert tuple(ours.spec.norm_types) == tuple(theirs.spec.norm_types)
  assert tuple(ours.spec.dims) == tuple(theirs.spec.dims)
  assert ours.param_names == theirs.param_names
  p = convert.task_params(jax.tree_util.tree_map(np.asarray, theirs.params),
                          "cpu")
  for f in dataclasses.fields(p):
    _same(f.name, getattr(ours.params, f.name), getattr(p, f.name), 1e-6)
  _same("default_ctrl", ours.default_ctrl(),
        np.asarray(theirs.default_ctrl()), 1e-6)


def _same_extract(ours, theirs):
  """Two TileModels field by field, the contact points too."""
  for f in dataclasses.fields(ours):
    if f.name == "con_points":
      continue
    _same(f.name, getattr(ours, f.name), getattr(theirs, f.name), 1e-6)
  assert len(ours.con_points) == len(theirs.con_points)
  for i, (a, b) in enumerate(zip(ours.con_points, theirs.con_points)):
    for f in dataclasses.fields(a):
      _same(f"con_points[{i}].{f.name}", getattr(a, f.name),
            getattr(b, f.name), 1e-6)


def test_extract_matches_jax_extract():
  ours = tts.extract(treg.get_task("Walker", device="cpu").model)
  theirs = jts.extract(jreg.get_task("Walker", dtype=jnp.float32).model)
  assert (ours.ncon, ours.nlim, ours.nrow) == (
      theirs.ncon, theirs.nlim, theirs.nrow) == (14, 12, 54)
  _same_extract(ours, theirs)


def test_import_leaves_jax_out():
  # the edge modules first: the card's host has neither mujoco nor
  # matplotlib, so they import neither (nor orbax) at import time
  code = ("import sys\n"
          "import mujoco_mpc_torch.agent.interface\n"
          "import mujoco_mpc_torch.utils.checkpoint\n"
          "import mujoco_mpc_torch.utils.profiling\n"
          "import mujoco_mpc_torch.tools.testspeed\n"
          "import mujoco_mpc_torch.tools.drive\n"
          "import mujoco_mpc_torch.tools.trace\n"
          "import mujoco_mpc_torch.tools.plots\n"
          "import mujoco_mpc_torch.tools.record_clip\n"
          "import mujoco_mpc_torch.ui.server\n"
          "import mujoco_mpc_torch.native.build\n"
          "import mujoco_mpc_torch.__main__\n"
          "heavy = [m for m in sys.modules if m.split('.')[0] in "
          "('mujoco', 'matplotlib', 'orbax')]\n"
          "assert not heavy, heavy\n"
          "import mujoco_mpc_torch.agent.agent, mujoco_mpc_torch.convert\n"
          "import mujoco_mpc_torch.ops.megarollout\n"
          "import mujoco_mpc_torch.tasks.humanoid\n"
          "import mujoco_mpc_torch.tasks.quadruped\n"
          "import mujoco_mpc_torch.physics.sensors\n"
          "bad = [m for m in sys.modules if m.split('.')[0] in "
          "('jax', 'jaxlib', 'flax', 'mujoco_mpc_tpu')]\n"
          "assert not bad, bad\n")
  proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                        capture_output=True, text=True, timeout=120)
  assert proc.returncode == 0, proc.stderr


_BODY = "<body><joint name='a' type='hinge'/><geom size='.1'/></body>"


def _bodies(*geoms, condim=3):
  """A world of free bodies, one per geom (type, size)."""
  return ("<mujoco><worldbody>" + "".join(
      f"<body pos='0 0 {i}'><freejoint/><geom type='{t}' size='{s}' "
      f"condim='{condim}'/></body>" for i, (t, s) in enumerate(geoms))
      + "</worldbody></mujoco>")


# case: (MJCF, the ROADMAP item the error names)
_OUT_OF_CLASS = {
    # ball joints are in the class; a limited one is not, as in JAX
    "ball": ("<mujoco><worldbody><body><joint type='ball' limited='true' "
             "range='0 1'/><geom size='.1'/></body></worldbody></mujoco>",
             "limit on quaternion joint.*general engine"),
    # a tendon actuator with activation dynamics (stateful)
    "tendon_actuator": ("<mujoco><worldbody>" + _BODY + "</worldbody><tendon>"
                        "<fixed name='t'><joint joint='a' coef='1'/></fixed>"
                        "</tendon><actuator><general tendon='t' "
                        "dyntype='filter'/></actuator></mujoco>",
                        "general engine"),
    "colliding_mocap": ("<mujoco><worldbody><body mocap='true' pos='0 0 1'>"
                        "<geom size='.1'/></body>" + _BODY +
                        "</worldbody></mujoco>", "general engine"),
    # capsule-box contacts with rolling friction (condim 6) and ball
    # joints are in the class; a spring on the ball joint is not
    "capsule_box": (_bodies(("capsule", ".05 .1"), ("box", ".1 .1 .1"),
                            condim=6).replace(
                                "<freejoint/>",
                                "<joint type='ball' stiffness='2'/>", 1),
                    "spring on quaternion joint.*general engine"),
    # the sphere-capsule pair is in the class; a motor on a free joint
    # is not
    "sphere_capsule": (_bodies(("sphere", ".1"), ("capsule", ".05 .1"))
                       .replace("<freejoint/>", "<freejoint name='f'/>", 1)
                       .replace("</worldbody>", "</worldbody><actuator>"
                                "<motor joint='f' gear='1 0 0 0 0 0'/>"
                                "</actuator>"),
                       "actuator on quaternion joint.*general engine"),
}

# a ball or free joint `q` beside a hinge chain, with each quaternion-joint
# feature the JAX extract refuses; a joint equality on a quaternion joint
# and a free joint's limit do not compile, so they are set on the Model
_QUAT_JOINT_XML = """<mujoco><worldbody>
<body name="b1" pos="0 0 1"><joint name="h" type="hinge"/><geom size=".1"/>
<body name="b2" pos="0 0 -.3"><joint name="h2" type="hinge"/>
<geom size=".1"/></body></body>
<body name="b3" pos="1 0 1"><joint name="q" type="{jt}" {attr}/>
<geom size=".1"/></body></worldbody>{extra}</mujoco>"""
_QUAT_JOINT_REFUSALS = {
    "limit": ("limited='true' range='0 1'", "", "limit on quaternion joint"),
    "spring": ("stiffness='2'", "", "spring on quaternion joint"),
    "actuator": ("", "<actuator><motor joint='q' gear='1 0 0 0 0 0'/>"
                     "</actuator>", "actuator on quaternion joint"),
    "tendon": ("", "<tendon><fixed name='t'><joint joint='q' coef='1'/>"
                   "<joint joint='h' coef='1'/></fixed></tendon>",
               "tendon wrapping a quaternion joint"),
    "joint_equality": ("", "<equality><joint joint1='h2' joint2='h'/>"
                           "</equality>",
                       "joint equality on quaternion joint"),
}


@pytest.mark.parametrize("jt", ["ball", "free"])
@pytest.mark.parametrize("case", sorted(_QUAT_JOINT_REFUSALS))
def test_quaternion_joint_refusals_match_jax(case, jt):
  """What the JAX extract refuses on a quaternion joint, the port's
  refuses too, for ball and free joints alike, with JAX's reason; the
  same model with the feature on a hinge instead is in the class."""
  attr, extra, reason = _QUAT_JOINT_REFUSALS[case]
  xml = _QUAT_JOINT_XML.format(jt=jt, attr=attr, extra=extra)
  ours, theirs = tio.load_model(xml, device="cpu"), jio.load_model(xml)
  if case == "joint_equality":  # its first joint moved onto q
    q = ours.joint("q")
    ours = ours.replace(eq_obj1id=(q,))
    theirs = theirs.replace(eq_obj1id=(q,))
  if case == "limit" and jt == "free":  # MuJoCo drops a free joint's
    lim = tuple(j == ours.joint("q") for j in range(ours.njnt))
    ours, theirs = ours.replace(jnt_limited=lim), theirs.replace(
        jnt_limited=lim)
  assert case != "limit" or ours.jnt_limited[ours.joint("q")]
  with pytest.raises(tts.UnsupportedModel, match=reason):
    tts.extract(ours)
  with pytest.raises(jts.UnsupportedModel, match=reason):
    jts.extract(theirs)
  hinge = tio.load_model(_QUAT_JOINT_XML.format(jt="hinge", attr=attr,
                                                extra=extra), device="cpu")
  tts.extract(hinge)

# models whose box-box pairs are in the class: two free boxes, the Allegro
# hand's palm and cube
_BOX_BOX = {
    "box_box": _bodies(("box", ".1 .1 .1"), ("box", ".1 .2 .05")),
    "allegro": os.path.join(REPO, "mujoco_mpc_tpu", "tasks", "models",
                            "allegro.xml"),
}


@pytest.mark.parametrize("case", sorted(_BOX_BOX))
def test_box_box_models_match_jax_extract(case):
  """The box-box pair is in the class: 16 points per pair, box 2's corners
  first, each box's in sx, sy, sz order, both boxes' sizes, as the JAX
  extract gives them."""
  ours = tts.extract(tio.load_model(_BOX_BOX[case], device="cpu"))
  theirs = jts.extract(jio.load_model(_BOX_BOX[case]))
  boxbox = [cp for cp in ours.con_points if cp.kind == "boxbox_corner"]
  assert len(boxbox) == 16
  assert [cp.owner for cp in boxbox] == [2] * 8 + [1] * 8
  assert (ours.ncon, ours.nrow) == (theirs.ncon, theirs.nrow) == {
      "box_box": (16, 48), "allegro": (40, 144)}[case]
  _same_extract(ours, theirs)
  assert tts.row_kinds(ours).count("boxbox_corner") == 48


@pytest.mark.parametrize("case", sorted(_OUT_OF_CLASS)
                         + ["jointed_mocap", "beyond_large_tier"])
def test_out_of_class_models_raise(case):
  """Ball and free joints, fixed tendons (limits, springs, actuators),
  mocap bodies, condim 4 and 6, equality constraints and the
  plane-sphere, plane-box, sphere-sphere, sphere-capsule, sphere-box,
  capsule-capsule, capsule-box and box-box contacts are in the class: the
  JAX kernel's whole class. These stay out, naming the ROADMAP item that
  ports them, the general engine: what the JAX kernel leaves to it, a
  limit, a spring or an actuator on a quaternion joint, stateful actuators
  and a mocap body with a joint or a colliding geom. A model in the class
  but beyond the kernel's largest size tier (four free boxes: 96 box-box
  points, 288 rows) packs into no struct."""
  if case == "beyond_large_tier":
    model = tio.load_model(_bodies(*[("box", ".1 .1 .1")] * 4),
                           device="cpu")
    tm = tts.extract(model)
    assert (tm.ncon, tm.nrow) == (96, 288)
    task = class_models.task("boxes", model=model, device="cpu")
    with pytest.raises(tts.UnsupportedModel,
                       match="contact points 96 exceed the kernel's "
                       "maximum 72"):
      tmr.pack_model(tm, task)
    return
  if case == "jointed_mocap":  # MJCF refuses it: the Walker's torso
    walker = treg.get_task("Walker", device="cpu").model
    torso = walker.body("torso")
    model, item = walker.replace(nmocap=1, body_mocapid=tuple(
        0 if b == torso else -1 for b in range(walker.nbody))), \
        "general engine"
  else:
    xml, item = _OUT_OF_CLASS[case]
    model = tio.load_model(xml, device="cpu")
  with pytest.raises(tts.UnsupportedModel, match=item):
    tts.extract(model)
  # a heightfield model builds, and plans through the general rollout
  hill = treg.get_task("Quadruped Hill", device="cpu")
  assert hill.device_residual is None
  with pytest.warns(UserWarning, match="general rollout"):
    mega, reason = tsampling.build_rollout(hill, 4)
  assert mega is None and "no CUDA residual" in reason


def test_make_data_matches_jax():
  ours = tio.make_data(treg.get_task("Walker", device="cpu").model)
  theirs = convert.data(jax.tree_util.tree_map(
      np.asarray, jio.make_data(jreg.get_task("Walker",
                                              dtype=jnp.float32).model)),
      "cpu")
  for f in dataclasses.fields(ours):
    _same(f.name, getattr(ours, f.name), getattr(theirs, f.name), 0.0)


def test_agent_step_is_not_ported():
  """Agent.step was the one Agent call that raised until the general
  engine came; it now advances the world by the model's timestep (its
  parity with JAX: tests/test_torch_agent_step.py)."""
  agent = Agent("Walker", device="cpu", horizon_steps=2)
  agent.reset("home")
  d = agent.step()
  assert float(d.time) == pytest.approx(
      float(agent.sim_task.model.opt.timestep))
  assert bool(torch.all(torch.isfinite(d.qpos)))
  assert d.xpos is not None and d.contact.pairs
