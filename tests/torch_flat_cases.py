"""Inputs the tests of the nine flat-ground tasks share (OP3, Pick,
PickAndPlace, Bimanual Reorient, Humanoid Interact through the CUDA
kernel; Quadrotor, Swimmer, Rubik, Humanoid Track on the general route):
the task lists, each task's goal and mode operands, its probe states and
a batch of general-engine states. Importable without JAX or `mujoco`
(chip_smoke.py reads it on the card's host)."""

import numpy as np
import torch

from mujoco_mpc_torch.ops import rollout as trollout
from mujoco_mpc_torch.physics import io as tio
from mujoco_mpc_torch.physics import step as tstep
from mujoco_mpc_torch.tasks import base as tbase
from mujoco_mpc_torch.tasks import rubik as trubik
from tests.torch_cases import one_torch_thread

# through the CUDA kernel (ROADMAP queue 1 item 11a)
KERNEL_TASKS = ("OP3", "Pick", "PickAndPlace", "Bimanual Reorient",
                "Humanoid Interact")
# on the general route (item 11b)
GENERAL_TASKS = ("Quadrotor", "Swimmer", "Rubik", "Humanoid Track")
# the kernel rows of each task: the `kernels` line's names
KERNEL_ROWS = {"OP3": "op3", "Pick": "pick", "PickAndPlace": "pick_and_place",
               "Bimanual Reorient": "bimanual_reorient",
               "Humanoid Interact": "humanoid_interact"}

# the goal of each task with a mocap body: (mocap_pos, mocap_quat)
GOALS = {
    "Pick": ([[0.15, -0.15, 0.25]], [[0.92, 0.2, 0.3, 0.1]]),
    "PickAndPlace": ([[0.1, -0.15, 0.15]], [[0.9, 0.1, 0.3, 0.2]]),
    "Bimanual Reorient": ([[-0.15, 0.0, 0.02]], [[0.8, 0.2, 0.4, 0.3]]),
    "Swimmer": ([[0.3, 0.3, 0.05]], [[1.0, 0.0, 0.0, 0.0]]),
    "Rubik": ([[0.25, 0.0, 0.3]], [[0.7, 0.3, 0.5, 0.4]]),
}
# userdata entries set in a task's plan: OP3's Handstand, PickAndPlace's
# away phase, Humanoid Interact's Sit, Rubik's solve at stage 3, Humanoid
# Track's Jog clip started at 0.1 s
USERDATA = {
    "OP3": {tbase.MODE_SLOT: 1.0},
    "PickAndPlace": {0: 1.0, 1: 2.0},
    "Humanoid Interact": {tbase.MODE_SLOT: 0.0},
    "Rubik": {0: float(trubik.MODE_SOLVE), 1: 3.0},
    "Humanoid Track": {0: 0.1, tbase.MODE_SLOT: 3.0},
}


def operands(name, model):
  """(mocap_pos (nmocap, 3), mocap_quat (nmocap, 4), userdata
  (nuserdata,)) float32 numpy of a task's plan."""
  mp, mq = GOALS.get(name, (np.zeros((model.nmocap, 3)),
                            np.tile([1.0, 0.0, 0.0, 0.0],
                                    (model.nmocap, 1))))
  ud = np.zeros(model.nuserdata, np.float32)
  for k, v in USERDATA.get(name, {}).items():
    ud[k] = v
  return (np.asarray(mp, np.float32).reshape(model.nmocap, 3),
          np.asarray(mq, np.float32).reshape(model.nmocap, 4), ud)


def states(name, model, b, seed=0):
  """(qpos (nq, b), qvel (nv, b), ctrl (nu, b)) float32 numpy probe
  states: for a kernel task tasks.base.covering_states (every row kind
  the search reaches carries force in one step), searched on one PyTorch
  thread (its ops are small: on eight threads the five tasks' searches
  took 15 times as long), else tasks.base.probe_states."""
  if name in KERNEL_TASKS:
    with one_torch_thread():
      return tbase.covering_states(model, b, seed)[0]
  return tbase.probe_states(model, b, seed)


def general_batch(task, probe, ops, time=0.3):
  """A batch of the probe states (qpos, qvel, ctrl) as a general Data in
  the task model's dtype with the operands (mocap_pos, mocap_quat,
  userdata) and the time, stepped once: the Data a general rollout scores
  (its contact forces are the step's)."""
  m = task.model
  b = probe[0].shape[1]
  d = trollout.broadcast(tio.make_data(m), (b,))

  def t(x):
    return torch.as_tensor(np.asarray(x, np.float64), dtype=m.dtype)

  mp, mq, ud = ops
  d = d.replace(qpos=t(probe[0].T), qvel=t(probe[1].T), ctrl=t(probe[2].T),
                mocap_pos=t(np.repeat(mp[None], b, 0)),
                mocap_quat=t(np.repeat(mq[None], b, 0)),
                userdata=t(np.repeat(ud[None], b, 0)),
                time=t(np.full(b, time)))
  return tstep.step(m, d)
