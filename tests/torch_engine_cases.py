"""Models and reference runs shared by the general engine's parity tests
(tests/test_torch_engine*.py, test_torch_collision_solver.py,
test_torch_step.py, test_torch_transitions.py, test_torch_agent_step.py,
test_torch_rollout.py), split into files of at most six tests each so
that pytest-xdist's loadfile queue runs them after the largest JAX files.

Engine cases: each model is built through `mujoco` and loaded by both
packages' own loaders (physics.from_mjmodel,
mujoco_mpc_torch.physics.io.from_mjmodel); one jitted JAX forward per
model serves every check of it. Models: the JAX oracle tests' cartpole,
the Walker and Humanoid tasks' MJCF, the class models with fixed tendons
(springs, limits, a tendon actuator) and with a weld equality (connect
rows and orientation rows; the connect and joint equalities are in
test_torch_collision_solver.py and the handover's chip phase), and the
JAX package's swimmer.xml (fluid forces), two of its motors made stateful
(a filter and an integrator activation).

Tolerances of the engine cases, with the errors measured when they were
set:
  forward against JAX, every derived field (kinematics, cdof, cvel, qM,
    the Cholesky factor, bias, passive and actuator forces, act_dot,
    contacts, the solve, qacc, sensors): rtol 1e-9, atol 1e-9 (measured
    5e-12 on Humanoid's qacc);
  smooth quantities against MuJoCo C (as tests/test_physics_oracle.py):
    qM, qfrc_bias, qfrc_actuator, act_dot, body and geom positions, subtree
    CoMs atol 1e-9, qfrc_passive atol 1e-9 where MuJoCo's passive force is
    the engine's: no friction loss (which MuJoCo solves as a constraint)
    and no fluid. The JAX package's inertia-box fluid force is 2.1e-4
    (4.9e-3 relative) from MuJoCo C's on the swimmer, a difference of the
    reference (ROADMAP queue 3); the port holds it against JAX above.
"""

import fcntl
import functools
import gc
import importlib
import os
import pickle

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu import physics as jphys
from mujoco_mpc_tpu.tasks import registry as jreg
from mujoco_mpc_torch import convert
from mujoco_mpc_torch.physics import io as tio
from mujoco_mpc_torch.physics import solver as tsolver
from mujoco_mpc_torch.physics import step as tstep
from mujoco_mpc_torch.physics.types import GeomType
from mujoco_mpc_torch.tasks import class_models, dm_suite
from mujoco_mpc_torch.tasks import registry as treg
from tests import models as oracle_models
from tests.torch_cases import one_torch_thread

jstep = importlib.import_module("mujoco_mpc_tpu.physics.step")


def np_tree(x):
  return jax.tree_util.tree_map(np.asarray, x)


@pytest.fixture(autouse=True, scope="module")
def release_jax_executables():
  """Drops every executable JAX holds in its caches (jax.clear_caches)
  before a port test module runs: autouse in each module that imports
  it. XLA maps each CPU executable into memory as about four regions,
  and a test worker keeps every executable it compiled: in the full
  suite at `-n 6` one worker held 53,925 mappings of the kernel's 65,530
  (vm.max_map_count) before half the run, and a compile past the limit
  fails to map its code and kills the worker (a segfault in XLA's
  compile; the ball chain's jitted step at the limit: "allocateMappedMemory
  failed"). A later call of a jitted function compiles again.

  The module's PyTorch then runs on one CPU thread, its fixtures
  included (torch_cases.one_torch_thread says why)."""
  jax.clear_caches()
  gc.collect()
  with one_torch_thread():
    yield


_SESSION_RESULTS = {}


def session_dir(tmp_path_factory):
  """The pytest session's temporary directory, which its pytest-xdist
  workers share (the parent of each worker's), a new one each session."""
  base = tmp_path_factory.getbasetemp()
  return base.parent if "PYTEST_XDIST_WORKER" in os.environ else base


def session_result(tmp_path_factory, name, compute):
  """compute()'s result (picklable: numpy arrays, tuples, lists, dicts,
  SimpleNamespaces, paths), computed once in this pytest session. The
  first test worker that asks computes it, under a lock the others wait
  on, and pickles it into session_dir, where the session's other modules
  and workers load it: a JAX reference or a build that several workers'
  tests read runs once a session instead of once a worker and module
  visit. `name` names the result within the session."""
  if name not in _SESSION_RESULTS:
    d = session_dir(tmp_path_factory)
    path = d / f"session_result_{name}.pkl"
    with open(d / f"session_result_{name}.lock", "w") as lock:
      fcntl.flock(lock, fcntl.LOCK_EX)
      if not path.exists():
        part = path.with_suffix(".part")
        with open(part, "wb") as f:
          pickle.dump(compute(), f)
        os.replace(part, path)
      with open(path, "rb") as f:
        _SESSION_RESULTS[name] = pickle.load(f)
  return _SESSION_RESULTS[name]


@functools.lru_cache(maxsize=None)
def pair(name):
  """(port task, JAX task) in float64, the port's model and parameters
  carried over from the JAX task's; made once per process (both are
  immutable)."""
  j = jreg.get_task(name, dtype=jnp.float64)
  t = treg.get_task(name, dtype=torch.float64, device="cpu")
  return t.replace(model=convert.model(np_tree(j.model), "cpu"),
                   params=convert.task_params(np_tree(j.params), "cpu")), j


# ------------------------------------------------------------ engine cases
_SWIMMER = os.path.join(os.path.dirname(jphys.__file__), os.pardir, "tasks",
                        "models", "swimmer.xml")


def _swimmer():
  """swimmer.xml with motor m1 on a filter activation and m2 on an
  integrator."""
  with open(_SWIMMER) as f:
    xml = f.read()
  xml = xml.replace('<motor name="m1" joint="j1"/>',
                    '<general name="m1" joint="j1" dyntype="filter" '
                    'dynprm="0.05" gainprm="0.15"/>')
  xml = xml.replace('<motor name="m2" joint="j2"/>',
                    '<general name="m2" joint="j2" dyntype="integrator" '
                    'gainprm="0.15" actlimited="true" actrange="-1 1"/>')
  assert xml.count("dyntype") == 2
  return mujoco.MjModel.from_xml_string(xml)


ENGINE_MODELS = {
    "cartpole": lambda: mujoco.MjModel.from_xml_string(
        oracle_models.CARTPOLE),
    "walker": dm_suite.build_walker,
    "humanoid": dm_suite.build_humanoid,
    "tendon_spring": lambda: class_models.build("tendon_spring"),
    "tendon_actuator": lambda: class_models.build("tendon_actuator"),
    "weld": lambda: class_models.build("weld"),
    "swimmer": _swimmer,
}

# every derived field of the forward pass
FIELDS = ("xpos", "xquat", "xmat", "xipos", "ximat", "xanchor", "xaxis",
          "geom_xpos", "geom_xmat", "site_xpos", "site_xmat", "subtree_com",
          "cdof", "cvel", "qM", "qLD", "qfrc_bias", "qfrc_passive",
          "qfrc_actuator", "actuator_force", "act_dot", "qacc",
          "qfrc_constraint", "sensordata", "efc_lambda")


def _state(mj, seed=0):
  """(qpos, qvel, ctrl, act): the first keyframe or qpos0, hinges and
  slides moved by up to 0.2, velocities up to 0.5, controls over their
  ranges."""
  rng = np.random.RandomState(seed)
  qpos = (mj.key_qpos[0] if mj.nkey else mj.qpos0).copy()
  for j in range(mj.njnt):
    if mj.jnt_type[j] in (mujoco.mjtJoint.mjJNT_HINGE,
                          mujoco.mjtJoint.mjJNT_SLIDE):
      qpos[mj.jnt_qposadr[j]] += rng.uniform(-0.2, 0.2)
  qvel = rng.uniform(-0.5, 0.5, mj.nv)
  lo, hi = mj.actuator_ctrlrange.T if mj.nu else (np.zeros(0),) * 2
  ctrl = rng.uniform(np.where(lo < hi, lo, -1), np.where(lo < hi, hi, 1))
  act = rng.uniform(-0.5, 0.5, mj.na)
  return qpos, qvel, ctrl, act


def engine_case(name):
  """(name, mujoco model and data after mj_forward, the port's forward
  Data, the JAX forward Data as numpy)."""
  mj = ENGINE_MODELS[name]()
  qpos, qvel, ctrl, act = _state(mj)
  jm = jphys.from_mjmodel(mj, dtype=jnp.float64)
  jd = jphys.make_data(jm).replace(
      qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
      ctrl=jnp.asarray(ctrl), act=jnp.asarray(act))
  jd = np_tree(jax.jit(jstep.forward)(jm, jd))
  tm = tio.from_mjmodel(mj, dtype=torch.float64, device="cpu")
  td = tio.make_data(tm).replace(
      qpos=torch.tensor(qpos), qvel=torch.tensor(qvel),
      ctrl=torch.tensor(ctrl), act=torch.tensor(act))
  td = tstep.forward(tm, td)
  md = mujoco.MjData(mj)
  md.qpos[:], md.qvel[:], md.ctrl[:], md.act[:] = qpos, qvel, ctrl, act
  mujoco.mj_forward(mj, md)
  return name, mj, md, td, jd


def check_forward(case):
  """Every derived field and contact field of the port's forward against
  JAX's."""
  name, _, _, td, jd = case
  for f in FIELDS:
    np.testing.assert_allclose(getattr(td, f).numpy(), getattr(jd, f),
                               rtol=1e-9, atol=1e-9, err_msg=f"{name} {f}")
  for f in ("dist", "pos", "frame", "friction", "solref", "solimp", "force"):
    np.testing.assert_allclose(getattr(td.contact, f).numpy(),
                               getattr(jd.contact, f), rtol=1e-9, atol=1e-9,
                               err_msg=f"{name} contact.{f}")


def check_smooth(case):
  """The port's smooth quantities against MuJoCo C's."""
  name, mj, md, td, _ = case
  full = np.zeros((mj.nv, mj.nv))
  mujoco.mj_fullM(mj, md, full)
  np.testing.assert_allclose(td.qM.numpy(), full, atol=1e-9, err_msg=name)
  for ours, theirs in ((td.qfrc_bias, md.qfrc_bias),
                       (td.qfrc_actuator, md.qfrc_actuator),
                       (td.act_dot, md.act_dot), (td.xpos, md.xpos),
                       (td.xipos, md.xipos), (td.geom_xpos, md.geom_xpos),
                       (td.subtree_com, md.subtree_com)):
    np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-9,
                               err_msg=name)
  if not np.any(mj.dof_frictionloss) and not (mj.opt.viscosity or
                                               mj.opt.density):
    np.testing.assert_allclose(td.qfrc_passive.numpy(), md.qfrc_passive,
                               atol=1e-9, err_msg=name)


# --------------------------------------------------------- collision cases
# free bodies of every primitive geom type on a plane and into each other,
# the contype and conaffinity bits choosing 13 candidate pairs that cover
# every primitive pair kind of physics/collision.py (KINDS), with condim 1,
# 3, 4 and 6 geoms, a limited hinge and a connect equality: its 100-odd
# rows take the matrix-free solve
PAIRS_XML = """
<mujoco>
  <option timestep="0.005"/>
  <worldbody>
    <geom name="floor" type="plane" size="3 3 0.1" condim="3" contype="1"
          conaffinity="434"/>
    <body name="ball" pos="0 0 0.09"><freejoint/>
      <geom type="sphere" size="0.1" condim="4" contype="2"
            conaffinity="53"/></body>
    <body name="ball2" pos="0.15 0 0.12"><freejoint/>
      <geom type="sphere" size="0.08" condim="1" contype="4"
            conaffinity="8"/></body>
    <body name="ball3" pos="0.17 0 0.27"><freejoint/>
      <geom type="sphere" size="0.08" condim="1" contype="8"
            conaffinity="0"/></body>
    <body name="cap" pos="0.3 0.05 0.06" euler="0 1.4 0.2"><freejoint/>
      <geom type="capsule" size="0.05 0.15" condim="6" contype="16"
            conaffinity="1600"/></body>
    <body name="box" pos="-0.2 0.05 0.09" euler="0.1 0.05 0.3"><freejoint/>
      <geom type="box" size="0.1 0.08 0.1" contype="32" conaffinity="64"/>
    </body>
    <body name="box2" pos="-0.25 0.12 0.26" euler="0.05 0.1 0.2"><freejoint/>
      <geom type="box" size="0.07 0.07 0.07" condim="4" contype="64"
            conaffinity="0"/></body>
    <body name="ell" pos="0.6 0 0.08" euler="0.2 0 0"><freejoint/>
      <geom type="ellipsoid" size="0.1 0.06 0.09" contype="128"
            conaffinity="0"/></body>
    <body name="cyl" pos="-0.6 0 0.1" euler="0 1.5 0"><freejoint/>
      <geom type="cylinder" size="0.05 0.1" contype="256" conaffinity="0"/>
    </body>
    <body name="arm" pos="0.1 0.2 0.1">
      <joint name="hinge" type="hinge" axis="0 0 1" limited="true"
             range="-0.1 0.1"/>
      <geom type="capsule" size="0.04 0.1" euler="0 1.57 0" contype="512"
            conaffinity="0"/>
      <body name="tip" pos="0.15 0 0"><joint type="hinge" axis="0 1 0"/>
        <geom type="sphere" size="0.03" contype="1024" conaffinity="0"/>
      </body>
    </body>
  </worldbody>
  <equality><connect body1="tip" body2="box2" anchor="0 0 0"/></equality>
</mujoco>
"""

KINDS = {
    (GeomType.PLANE, GeomType.SPHERE), (GeomType.PLANE, GeomType.CAPSULE),
    (GeomType.PLANE, GeomType.BOX), (GeomType.PLANE, GeomType.ELLIPSOID),
    (GeomType.PLANE, GeomType.CYLINDER), (GeomType.SPHERE, GeomType.SPHERE),
    (GeomType.SPHERE, GeomType.CAPSULE), (GeomType.SPHERE, GeomType.BOX),
    (GeomType.CAPSULE, GeomType.CAPSULE), (GeomType.CAPSULE, GeomType.BOX),
    (GeomType.BOX, GeomType.BOX)}

# the pairs model (matrix-free) and the oracle tests' box on a plane (24
# rows, the dense solve)
COLLISION_MODELS = {"pairs": PAIRS_XML,
                    "box_on_plane": oracle_models.BOX_ON_PLANE}


def row_classes(m) -> np.ndarray:
  """The row class of each row of the general layout."""
  lay = tsolver._Layout(m)
  rows = np.full(lay.ncrow, "friction", dtype=object)
  rows[lay.nrm] = "normal"
  out = list(rows) + ["torsional"] * len(lay.tor) + [
      "rolling"] * (2 * len(lay.roll))
  neq = sum({0: 3, 1: 6, 2: 1}[int(k)] for k in m.eq_type)
  out += ["limit"] * (tsolver.nrow_static(m) - len(out) - neq)
  return np.asarray(out + ["equality"] * neq)


# -------------------------------------------------------------- step cases
# the oracle tests' pendulum under the RK4 integrator, their box on a plane
# (a free joint landing on its corners), and the class model ball_chain (a
# ball joint mid-chain with a limit, the sphere-capsule pair)
STEP_MODELS = {
    "pendulum_rk4": lambda: mujoco.MjModel.from_xml_string(
        oracle_models.PENDULUM.replace("<option ",
                                       '<option integrator="RK4" ', 1)),
    "box_on_plane": lambda: mujoco.MjModel.from_xml_string(
        oracle_models.BOX_ON_PLANE),
    "ball_chain": lambda: class_models.build("ball_chain"),
}
