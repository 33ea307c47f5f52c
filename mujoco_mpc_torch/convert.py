"""Carry parameters and state from the JAX package into this one.

The JAX objects are given as numpy trees (on the JAX side:
`jax.tree_util.tree_map(np.asarray, obj)`), so this module never imports
JAX. Fields are matched by name: the port keeps the JAX field names. Array
dtypes are kept (f32 stays f32, bool stays bool).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mujoco_mpc_torch.estimators import batch, kalman, unscented
from mujoco_mpc_torch.physics import types
from mujoco_mpc_torch.tasks import base


def _value(v, device):
  if isinstance(v, np.ndarray) or isinstance(v, np.generic):
    return torch.as_tensor(np.array(v), device=device)  # own a copy
  return v


def _fields(cls, src, device, **override):
  kw = {}
  for f in dataclasses.fields(cls):
    if f.name in override:
      kw[f.name] = override[f.name]
    elif hasattr(src, f.name):
      kw[f.name] = _value(getattr(src, f.name), device)
  return cls(**kw)


def model(jax_model_np, device) -> types.Model:
  """JAX Model (numpy leaves) -> Model on `device`."""
  opt = _fields(types.Option, jax_model_np.opt, device)
  return _fields(types.Model, jax_model_np, device, opt=opt)


def task_params(jax_params_np, device) -> base.TaskParams:
  """JAX TaskParams (numpy leaves) -> TaskParams on `device`."""
  return _fields(base.TaskParams, jax_params_np, device)


def data(jax_data_np, device) -> types.Data:
  """JAX Data (numpy leaves) -> Data on `device`, derived fields and the
  contact set included (the contact's static `pairs` stay empty)."""
  contact = getattr(jax_data_np, "contact", None)
  if contact is not None:
    contact = _fields(types.Contact, contact, device)
  return _fields(types.Data, jax_data_np, device, contact=contact)


def kalman_state(jax_state_np, device) -> kalman.KalmanState:
  """JAX KalmanState (numpy leaves) -> KalmanState on `device`."""
  return _fields(kalman.KalmanState, jax_state_np, device,
                 data=data(jax_state_np.data, device))


def unscented_state(jax_state_np, device) -> unscented.UnscentedState:
  """JAX UnscentedState (numpy leaves) -> UnscentedState on `device`."""
  return _fields(unscented.UnscentedState, jax_state_np, device,
                 data=data(jax_state_np.data, device))


def batch_state(jax_state_np, device) -> batch.BatchState:
  """JAX BatchState (numpy leaves) -> BatchState on `device`."""
  return _fields(batch.BatchState, jax_state_np, device)
