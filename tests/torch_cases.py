"""Inputs shared by the port's kernel tests, importable without JAX or
mujoco (the card's host has neither): the Quadruped's residual branches,
the Shadow goal and the handover's target; and one_torch_thread for the
tests that plan on the CPU."""

import contextlib

import torch

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

# Shadow's goal: an unnormalized quaternion (the residual normalizes it)
SHADOW_GOAL = [[0.8, 0.2, 0.4, 0.3]]

# the handover's target: across the table from the box, as the task's
# transition places it (x +-(0.3..0.4), y +-(0.2..0.3), z 0.25..0.7)
HANDOVER_TARGET = [[0.35, -0.25, 0.3]]

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
