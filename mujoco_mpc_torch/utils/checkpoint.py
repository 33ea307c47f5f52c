"""Checkpoint and resume of an Agent's control session.

Counterpart of mujoco_mpc_tpu/utils/checkpoint.py (the reference has no
checkpointing; the JAX package saves through orbax). torch.save writes what
the Agent's next plan and step read: the policy and the previous policy,
the Data (the state, the derived fields and the solver's warm start), the
planning task's parameters (cost weights, norm parameters, risk, residual
parameters), the generator's state and the Ornstein-Uhlenbeck control
noise. Each structure is saved as its tensor leaves by field path; the
Agent being restored is the template, so the leaves must match its own in
path, shape and dtype, or restore raises ValueError. A checkpoint holds
only tensors, numbers and strings (torch.load(weights_only=True) reads it),
and loads on another device with map_location.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict

import torch


def _leaves(obj, prefix: str = "") -> Dict[str, torch.Tensor]:
  """The tensor leaves of a (nested) dataclass by field path; None fields
  are not leaves, as in a JAX pytree."""
  out = {}
  for f in dataclasses.fields(obj):
    v = getattr(obj, f.name)
    path = f"{prefix}{f.name}"
    if dataclasses.is_dataclass(v):
      out.update(_leaves(v, path + "."))
    elif isinstance(v, torch.Tensor):
      out[path] = v
  return out


def _rebuilt(template, flat: Dict[str, torch.Tensor], what: str,
             prefix: str = ""):
  """template with each leaf replaced by flat's (on the template leaf's
  device); flat must have exactly the template's leaves."""
  if not prefix:
    want = _leaves(template)
    if set(flat) != set(want):
      raise ValueError(
          f"the checkpoint's {what} has {len(flat)} leaves, the agent's "
          f"{len(want)} (missing {sorted(set(want) - set(flat))[:4]}, extra "
          f"{sorted(set(flat) - set(want))[:4]}): was the agent built with "
          "a different task or planner?")
    for path, t in want.items():
      got = flat[path]
      if got.shape != t.shape or got.dtype != t.dtype:
        raise ValueError(
            f"the checkpoint's {what} leaf {path} is {tuple(got.shape)} "
            f"{got.dtype}, the agent's {tuple(t.shape)} {t.dtype}: its "
            "leaves do not fit (a different task or planner?)")
  kw = {}
  for f in dataclasses.fields(template):
    v = getattr(template, f.name)
    path = f"{prefix}{f.name}"
    if dataclasses.is_dataclass(v):
      kw[f.name] = _rebuilt(v, flat, what, path + ".")
    elif isinstance(v, torch.Tensor):
      kw[f.name] = flat[path].to(v.device)
  return dataclasses.replace(template, **kw)


def save(path: str, agent) -> str:
  """Write an Agent's resumable state to the file `path`; returns its
  absolute path."""
  path = os.path.abspath(path)
  with agent._lock:
    state = {
        "task": agent.task.name,
        "planner": agent.planner_name,
        "policy": _leaves(agent.policy),
        "previous_policy": _leaves(agent.previous_policy),
        "data": _leaves(agent.data),
        "task_params": _leaves(agent.task.params),
        "generator": agent.generator.get_state(),
        "ou_noise": agent._ou_noise,
    }
  os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
  torch.save(state, path)
  return path


def load(path: str, map_location=None) -> dict:
  """A checkpoint's contents (tensors, numbers and strings only)."""
  return torch.load(os.path.abspath(path), map_location=map_location,
                    weights_only=True)


def restore(path: str, agent) -> None:
  """Restore a saved session into an Agent built the same way (task,
  planner and sizes); raises ValueError where its leaves do not fit."""
  state = load(path, map_location=agent.device)
  with agent._lock:
    policy = _rebuilt(agent.policy, state["policy"], "policy")
    previous = _rebuilt(agent.previous_policy, state["previous_policy"],
                        "previous policy")
    data = _rebuilt(agent.data, state["data"], "data")
    params = _rebuilt(agent.task.params, state["task_params"],
                      "task parameters")
    ou = state["ou_noise"]
    if ou.shape != agent._ou_noise.shape:
      raise ValueError(f"the checkpoint's control noise is {tuple(ou.shape)}"
                       f", the agent's {tuple(agent._ou_noise.shape)}: its "
                       "leaves do not fit (a different task?)")
    agent.generator.set_state(state["generator"].cpu())
    agent.policy, agent.previous_policy, agent.data = policy, previous, data
    agent.task = agent.task.replace(params=params)
    agent._ou_noise = ou.to(agent._ou_noise.device)
    agent._data_version += 1
