"""Inputs shared by the port's kernel tests, importable without JAX or
mujoco (the card's host has neither): the Quadruped's residual branches,
the Shadow goal, the handover's target and the quadruped's goal;
one_torch_thread for the tests that plan on the CPU; and step_operands,
port_steps and within_rounding for the float32 step holds against JAX."""

import contextlib

import numpy as np
import torch

from mujoco_mpc_torch.physics import tilestep as tts
from mujoco_mpc_torch.tasks import quadruped as tquad


@contextlib.contextmanager
def one_torch_thread():
  """PyTorch on one CPU thread, as a context or a test decorator. An
  Agent planning on the CPU with 60 to 256 candidates has ops large
  enough for PyTorch to split over threads, and test workers that share
  the host's cores leave those threads waiting on each other: two Allegro
  plan steps took 96.6 s on eight threads beside three busy processes on
  an 8-core host, 1.6 s on one."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  try:
    yield
  finally:
    torch.set_num_threads(n)


def port_steps(tm, probe, dtype=torch.float32, ops=None):
  """The port's cold and warm tile steps (physics/tilestep.py::step_tb) of
  the probe states (qpos, qvel, ctrl as numpy) in dtype, the warm one from
  the cold one's duals, with the rollout-constant operands `ops`
  ((mocap_pos, mocap_quat, userdata) as numpy shaped for step_tb, or
  None): the two steps' views (each with its post-step qpos and qvel)."""
  qp, qv, ct = (torch.tensor(x).to(dtype) for x in probe)
  aux = {} if ops is None else dict(zip(
      ("mocap_pos", "mocap_quat", "userdata"),
      (torch.tensor(x).to(dtype) for x in ops)))
  lam, views = None, []
  for _ in range(2):
    qp, qv, view = tts.step_tb(tm, qp, qv, ct, lam, **aux)
    lam = view.efc_lambda
    views.append(view)
  return views


# the rounding witness of a float32 step hold: a state's miss may reach
# this many times the port's own float32 distance from float64 there
WITNESS = 8.0


def within_rounding(got, want, got64, atol, what):
  """Holds the port's float32 step result `got` to JAX's float32 `want`
  per state (the last axis, a column of the tile step): each state's
  largest miss within max(atol, WITNESS times that state's largest
  distance of `want` from `got64`, the port's float64 step from the same
  float32 inputs). The witness comes from the reference: the port's
  float64 step is held to JAX's at 1e-9 (tests/test_torch_tilestep64.py,
  which carries parity with JAX), so `want - got64` is JAX's own float32
  rounding, and a fault of the port's float32 path alone cannot widen the
  bound it is held to. A miss beyond atol passes only on that witness.
  The rule of chip_smoke.py::noise_bound and tests/
  test_torch_kernel_host_flat.py, which hold the kernel to the plain
  version per state (per candidate), the witness taken from the plain
  version."""
  got, want, got64 = (np.asarray(x, np.float64) for x in (got, want, got64))
  b = got.shape[-1]
  miss = np.abs(got - want).reshape(-1, b).max(0)
  noise = np.abs(want - got64).reshape(-1, b).max(0)
  bound = np.maximum(atol, WITNESS * noise)
  assert np.all(miss <= bound), (
      f"{what}: per-state miss {miss} beyond max({atol}, {WITNESS} x "
      f"{noise})")


# Shadow's goal: an unnormalized quaternion (the residual normalizes it)
SHADOW_GOAL = [[0.8, 0.2, 0.4, 0.3]]

# the handover's target: across the table from the box, as the task's
# transition places it (x +-(0.3..0.4), y +-(0.2..0.3), z 0.25..0.7)
HANDOVER_TARGET = [[0.35, -0.25, 0.3]]

# the quadruped's goal
QUADRUPED_GOAL = [[1.0, 0.3, 0.3]]


def step_operands(task):
  """A task's rollout-constant operands in its float32 step and returns
  holds against JAX: (mocap_pos, mocap_quat, userdata) as numpy float32
  shaped (1, 3, 1), (1, 4, 1), (nuserdata, 1), or None for a task without
  a mocap body (Humanoid Walk). The handover's target, the quadruped's
  goal and its FSM's initial userdata, the hands' goal quaternion; the
  identity quaternion and zero userdata elsewhere."""
  def col(x):
    return np.asarray(x, np.float32)[..., None]
  ident = col([[1.0, 0.0, 0.0, 0.0]])
  zeros = np.zeros((task.model.nuserdata, 1), np.float32)
  if task.name == "Bimanual Handover":
    return col(HANDOVER_TARGET), ident, zeros
  if task.name == "Quadruped Flat":
    return (col(QUADRUPED_GOAL), ident,
            tquad.fsm_userdata(task.model.nuserdata)[:, None])
  if task.name in ("Shadow", "Allegro"):
    return col([[0.25, 0.0, 0.3]]), col(SHADOW_GOAL), zeros
  return None

# the tasks that need no kernel change: hinge, slide and free joints and
# contact pairs the kernel had, each with its own residual
SMALL_TASKS = ("Acrobot", "Arm Reach", "Cartpole", "Fingers", "Particle",
               "ParticleFixed", "Push", "Rubik Faces")

# the small tasks whose reference steps rounding decides: the reference's
# broadphase keeps a parent-child pair that MuJoCo filters, the acrobot's
# links at the elbow and the cartpole's pole inside its cart, whose contact
# sits on the joint, where the JAX step takes a normal from a rounding
# residue (its float32 step lands 0.34 (qpos) and 33.8 (qvel) from the
# port's). The port drops those rows (tilestep.COINCIDE; its float32 step
# there lands 1.6e-6 and 1.6e-4 from float64), so the port is held against
# JAX on these two with MuJoCo's filter applied (mujoco_filtered), and
# against itself (the host kernel) on the registered models.
ILL_CONDITIONED = ("Acrobot", "Cartpole")


def mujoco_filtered(model):
  """The model without the contact pairs MuJoCo's filterparent drops: a
  body and its parent, neither the world. The same for a JAX Model."""
  par, gb = model.body_parentid, model.geom_bodyid
  return model.replace(collision_pairs=tuple(
      (g1, g2) for g1, g2 in model.collision_pairs
      if gb[g1] == 0 or gb[g2] == 0
      or (par[gb[g1]] != gb[g2] and par[gb[g2]] != gb[g1])))


def small_task_states(name):
  """The one-step probe states of a small task: its module's
  probe_states, or tasks.base.probe_states."""
  from mujoco_mpc_torch.tasks import acrobot, base
  return acrobot.probe_states if name == "Acrobot" else base.probe_states


# Rubik Faces' face targets (userdata[2:8]): two faces a quarter turn out
RUBIK_TARGETS = [1.5707963, 0.0, -1.5707963, 0.0, 0.0, 0.0]

# every branch of residual_quadruped and weight_mod_quadruped: the mode in
# userdata and the Biped type parameter; Flip entered 0, 0.4, 0.8 and 1.1 s
# before the rollout's t0 of 0.25 s puts its 30 steps of 5 ms in the jump,
# the flight, the landing and after the flip
QUADRUPED_MODES = {
    "quadruped": (tquad.MODE_QUADRUPED, 0.0, 0),
    "biped": (tquad.MODE_BIPED, 0.0, 0),
    "handstand": (tquad.MODE_BIPED, 0.0, 1),
    "walk": (tquad.MODE_WALK, 0.0, 0),
    "scramble": (tquad.MODE_SCRAMBLE, 0.0, 0),
    "flip_jump": (tquad.MODE_FLIP, 0.0, 0),
    "flip_flight": (tquad.MODE_FLIP, -0.4, 0),
    "flip_landing": (tquad.MODE_FLIP, -0.8, 0),
    "flip_done": (tquad.MODE_FLIP, -1.1, 0),
}


def quadruped_mode(task, case):
  """(userdata, TaskParams) of a QUADRUPED_MODES case."""
  mode, start, biped_type = QUADRUPED_MODES[case]
  u = tquad.fsm_userdata(task.model.nuserdata, mode, time=start)
  return u, task.set_parameter("select_Biped type", biped_type).params
