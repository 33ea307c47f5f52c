"""Task registry: name -> Task factory (reference GetTasks,
mjpc/tasks/tasks.cc:46-75).

Each ported task loads its model from a snapshot under tasks/models/, made
on a host with `mujoco` and `dm_control` by `write_snapshots()`:

    python -c "from mujoco_mpc_torch.tasks import registry; \\
               registry.write_snapshots()"

A snapshot holds the Model that physics/io.py::from_mjmodel builds (in
f64), the cost spec and the default TaskParams. tests/test_torch_model.py
holds each snapshot equal to a fresh build.
"""

from __future__ import annotations

import contextvars
import json
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.physics import io as phys_io
from mujoco_mpc_torch.tasks import base

_MODEL_DIR = os.path.join(os.path.dirname(__file__), "models")

_FACTORIES: Dict[str, Callable[..., base.Task]] = {}
# task name -> (snapshot stem, mujoco builder returning an MjModel)
_SNAPSHOTS: Dict[str, Tuple[str, Callable]] = {}
# what load_task_model returns while get_task builds a task on a model
# given as MJCF (None otherwise)
_XML_MODEL = contextvars.ContextVar("xml_model", default=None)


class ModelXmlRefused(RuntimeError):
  """A model given as MJCF on a host without `mujoco`."""

  def __init__(self):
    super().__init__(
        "model_xml needs `mujoco` to build the model, and this host has "
        "none: pass a registered task name, whose model loads from its "
        "snapshot (mujoco_mpc_torch/tasks/models/*.npz, written by "
        "tasks.registry.write_snapshots on a host with mujoco)")


def register(name: str, snapshot: str, builder: Callable):
  def wrap(fn):
    _FACTORIES[name] = fn
    _SNAPSHOTS[name] = (snapshot, builder)
    return fn
  return wrap


def task_names():
  return sorted(_FACTORIES)


def get_task(name: str, dtype=torch.float32, device=devices.DEFAULT,
             model_xml: Optional[str] = None) -> base.Task:
  """Task `name` on its registered model, or with model_xml on that MJCF's
  model, cost spec and parameters (reference Init with a custom model,
  grpc/agent.proto:21-30): the task's factory runs on it, so that its
  residual, CUDA residual included, reads the given model. model_xml
  needs `mujoco` (ModelXmlRefused where it does not import)."""
  device = devices.resolve(device)
  if name not in _FACTORIES:
    raise KeyError(f"unknown task {name!r}; available: {task_names()}")
  if model_xml is None:
    return _FACTORIES[name](dtype=dtype, device=device)
  try:
    import mujoco
  except ImportError:
    raise ModelXmlRefused() from None
  token = _XML_MODEL.set(load_task_model_from_builder(
      lambda: mujoco.MjModel.from_xml_string(model_xml), dtype, device))
  try:
    return _FACTORIES[name](dtype=dtype, device=device)
  finally:
    _XML_MODEL.reset(token)


def get_mj_model(name: str):
  """The mujoco.MjModel task `name`'s snapshot is built from (rendering and
  viewer use only: the port's engine never reads it; needs mujoco, and
  dm_control for the dm_control suite's tasks)."""
  if name not in _SNAPSHOTS:
    raise KeyError(f"unknown task {name!r}; available: {task_names()}")
  return _SNAPSHOTS[name][1]()


def snapshot_path(stem: str) -> str:
  return os.path.join(_MODEL_DIR, f"{stem}.npz")


def load_task_model_from_builder(builder, dtype=torch.float32,
                                 device=devices.DEFAULT):
  """(Model, CostSpec, TaskParams, param_names) from a mujoco builder."""
  mj = builder()
  model = phys_io.from_mjmodel(mj, dtype=dtype, device=device)
  spec, params, names = base.parse_cost_spec_mj(mj, model, dtype=dtype,
                                                device=device)
  return model, spec, params, names


def write_snapshots(stems=None) -> None:
  """Rebuild the registered tasks' snapshots, all of them or those named in
  `stems` (needs mujoco, dm_control)."""
  os.makedirs(_MODEL_DIR, exist_ok=True)
  for stem, builder in dict(_SNAPSHOTS.values()).items():
    if stems is not None and stem not in stems:
      continue
    model, spec, params, names = load_task_model_from_builder(
        builder, torch.float64, device="cpu")
    meta = {"names": spec.names, "norm_types": spec.norm_types,
            "dims": spec.dims, "param_names": names}
    phys_io.save_snapshot(
        snapshot_path(stem), model,
        **{"task.spec": np.asarray(json.dumps(meta)),
           "task.weights": params.weights.numpy(),
           "task.norm_params": params.norm_params.numpy(),
           "task.risk": params.risk.numpy(),
           "task.residual_params": params.residual_params.numpy()})


def load_task_model(stem: str, dtype=torch.float32,
                    device=devices.DEFAULT):
  """(Model, CostSpec, TaskParams, param_names) from a snapshot, or from
  the MJCF get_task was given."""
  given = _XML_MODEL.get()
  if given is not None:
    return given
  model, extra = phys_io.load_snapshot(snapshot_path(stem), dtype, device)
  meta = json.loads(str(extra["task.spec"]))
  spec = base.CostSpec(tuple(meta["names"]), tuple(meta["norm_types"]),
                       tuple(meta["dims"]))

  def t(key):
    return torch.as_tensor(extra[key], device=device).to(dtype)

  params = base.TaskParams(weights=t("task.weights"),
                           norm_params=t("task.norm_params"),
                           risk=t("task.risk"),
                           residual_params=t("task.residual_params"))
  return model, spec, params, tuple(meta["param_names"])


def _register_all():
  from mujoco_mpc_torch.tasks import (  # noqa: F401
      acrobot, allegro, arm_reach, bimanual, bimanual_insert, bring,
      cartpole, fingers, hand_reorient, humanoid, humanoid_interact,
      humanoid_track, op3, particle, pick, push, quadrotor, quadruped,
      rubik, swimmer, walker)


_register_all()
