"""The port's tile step (physics/tilestep.py::step_tb, the plain version of
the kernel's step) held against the JAX package's in float64, on the five
task models whose float32 step tests hold fixed tolerances: Humanoid Walk,
Bimanual Handover, Quadruped Flat, Shadow and Allegro.

The float32 step tests (tests/test_torch_humanoid.py and the others) hold
two float32 steps to each other, where rounding alone fills a fixed atol;
this hold is the one that carries parity with JAX. Both packages step the
same probe states (each task module's probe_states, 8 columns, with the
float32 step tests' operands, torch_cases.step_operands), cold and then
warm from their own cold step's duals, in float64 on the same constants:
the port's TileModel of its float32 model, and JAX's TileModel of the JAX
task's float32 model cast to float64 (tests/test_torch_rollout.py::
_rounded64 for the general engine), which extracts every field as the
port's holds it. Every array JAX's step returns is float64, and the two
steps agree to rounding, so no float32 intermediate of JAX's reaches them.

Tolerances, with the errors measured on a CPU host:
  qpos and qvel atol 1e-9 (measured 5.9e-16 and 2.3e-13, the handover's
    warm step); duals atol 1e-9 * max|duals| (4.0e-15 of the max, the
    humanoid's warm step); the frames, velocities, actuator forces and
    contact distances and frames that the residuals read atol 1e-9
    (5.7e-14, the handover's warm actuator forces);
  the constants: every field equal.
Two faults of the port's float64 step were found this way. Where it
rounded the constants it derives from the model to float32 (a row's
stiffness, damping and impedance, the box-box guard), the steps differed
by up to 5.8e-7 in qvel (the quadruped's warm step), 4.0e-9 in qpos and
5.1e-8 of the duals' max (the humanoid's cold step), JAX given the port's
pair parameters. Where it mixed a contact pair's solref and solimp in
float32 (tilestep.py::extract; pair_params now rounds them for a float32
step only), the humanoid's steps differed by 4.2e-9 in qpos, 4.8e-7 in
qvel and 5.4e-8 of the duals' max.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_torch.physics import tilestep as tts
from mujoco_mpc_torch.tasks import registry as treg
from mujoco_mpc_tpu.physics import tilestep as jts
from mujoco_mpc_tpu.tasks import registry as jreg
from tests.torch_cases import port_steps, step_operands
from tests.torch_engine_cases import release_jax_executables  # noqa: F401
from tests.torch_engine_cases import session_result

B = 8
TOL = 1e-9
# task: the port's task module, whose probe_states the step tests take
MODELS = {
    "Humanoid Walk": "humanoid",
    "Bimanual Handover": "bimanual",
    "Quadruped Flat": "quadruped",
    "Shadow": "hand_reorient",
    "Allegro": "allegro",
}
# the view arrays the task residuals read (frames pre-step)
FIELDS = ("xpos", "xquat", "xmat", "xipos", "ximat", "cvel", "subtree_com",
          "site_xpos", "site_xmat", "geom_xpos", "actuator_force")


def _inputs(name):
  """(the port's TileModel of its float32 task, the probe states (qpos,
  qvel, ctrl) as float32 numpy, the operands (mocap_pos, mocap_quat,
  userdata) as float32 numpy shaped for step_tb, or None)."""
  t = treg.get_task(name, device="cpu")
  probe = importlib.import_module(
      f"mujoco_mpc_torch.tasks.{MODELS[name]}").probe_states(t.model, B)
  return tts.extract(t.model), probe, step_operands(t)


def _cast64(model):
  """A JAX Model with every floating array cast to float64 (the float32
  values kept)."""
  def cast(x):
    if isinstance(x, (np.ndarray, jax.Array)) and jnp.issubdtype(
        x.dtype, jnp.floating):
      return jnp.asarray(x, jnp.float64)
    return x
  return jax.tree_util.tree_map(cast, model)


def _equal(x, y):
  if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
    return np.array_equal(np.asarray(x), np.asarray(y))
  return x == y


def _jax_tile_model(name):
  """JAX's TileModel of its float32 task cast to float64."""
  return jts.extract(_cast64(jreg.get_task(name, dtype=jnp.float32).model))


def _numpy_step(view):
  """The JAX view's arrays as numpy, and the dtype of every array it
  returns (its contact view's included)."""
  out, dtypes = {}, {}
  for k, x in vars(view).items():
    if k == "contact":
      for c in ("dist", "frame"):
        arr = getattr(x, c)
        dtypes[f"contact.{c}"] = str(arr.dtype)
        out[f"contact.{c}"] = np.asarray(arr)
    elif hasattr(x, "dtype"):
      dtypes[k] = str(x.dtype)
      out[k] = np.asarray(x)
  return out, dtypes


def _jax_steps(name):
  """JAX's float64 cold and warm steps of the probe states, eagerly at B
  columns: a list of two (arrays, dtypes)."""
  _, probe, ops = _inputs(name)
  jtm = _jax_tile_model(name)
  aux = {} if ops is None else dict(zip(
      ("mocap_pos", "mocap_quat", "userdata"),
      (jnp.asarray(x, jnp.float64) for x in ops)))
  q, v, c = (jnp.asarray(x, jnp.float64) for x in probe)
  lam = jnp.zeros((jtm.nrow, B), jnp.float64)
  out = []
  for _ in range(2):
    q, v, view = jts.step_tb(jtm, q, v, c, efc_lambda=lam, **aux)
    lam = view.efc_lambda
    out.append(_numpy_step(view))
  return out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_jax_tile_model64_holds_the_ports_constants(name):
  """The two steps start from the same constants: JAX's float32 model
  cast to float64 extracts every field as the port's TileModel of its
  float32 model holds it, the per-point ones (the humanoid's solref and
  solimp, mixed from two geoms at 17 of its 37 points) included."""
  ttm, _, _ = _inputs(name)
  own = _jax_tile_model(name)
  for f in dataclasses.fields(ttm):
    ours, theirs = getattr(ttm, f.name), getattr(own, f.name)
    if f.name in ("con_points", "eq_rows"):
      assert len(ours) == len(theirs)
      for a, b in zip(ours, theirs):
        for g in dataclasses.fields(a):
          assert _equal(getattr(a, g.name), getattr(b, g.name)), (
              f"{f.name}.{g.name}")
    else:
      assert _equal(ours, theirs), f.name


@pytest.mark.parametrize("which", ["cold", "warm"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_tile_step64_matches_jax(name, which, tmp_path_factory):
  """One float64 step (the cold one, or the warm one after it), port
  against JAX, at the module docstring's tolerances."""
  stem = MODELS[name]
  ref = session_result(tmp_path_factory, f"tilestep64_{stem}",
                       lambda: _jax_steps(name))
  i = ("cold", "warm").index(which)
  want, dtypes = ref[i]
  assert set(dtypes.values()) == {"float64"}, dtypes
  ttm, probe, ops = _inputs(name)
  view = port_steps(ttm, probe, torch.float64, ops)[i]
  lam = view.efc_lambda.numpy()
  scale = float(np.abs(want["efc_lambda"]).max())
  assert scale > 0
  np.testing.assert_allclose(view.qpos.numpy(), want["qpos"], rtol=0,
                             atol=TOL, err_msg="qpos")
  np.testing.assert_allclose(view.qvel.numpy(), want["qvel"], rtol=0,
                             atol=TOL, err_msg="qvel")
  np.testing.assert_allclose(lam, want["efc_lambda"], rtol=0,
                             atol=TOL * scale, err_msg="duals")
  for f in FIELDS:
    np.testing.assert_allclose(getattr(view, f).numpy(), want[f], rtol=0,
                               atol=TOL, err_msg=f)
  for f in ("dist", "frame"):
    np.testing.assert_allclose(getattr(view.contact, f).numpy(),
                               want[f"contact.{f}"], rtol=0, atol=TOL,
                               err_msg=f"contact.{f}")
