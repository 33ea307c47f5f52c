"""Agent: the host-side shell around the planner's plan and act calls.

Counterpart of mujoco_mpc_tpu/agent/agent.py (reference mjpc/agent.h:
45-256) in synchronous form: callers interleave planner_step() and
action(). The planning model runs at the task's `agent_timestep`
(reference agent.cc:288-293). The task knobs (cost weights, task
parameters, the mode) take effect at the next plan. The async plan loop,
the estimator thread and stepping the world (`step`, which needs the
general engine) are not ported yet; see ROADMAP queue 1 items 3 and 8.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.physics import io as phys_io
from mujoco_mpc_torch.planners import cross_entropy
from mujoco_mpc_torch.planners import sampling
from mujoco_mpc_torch.tasks import base as task_base
from mujoco_mpc_torch.tasks import registry

# reference planner enum order (mjpc/planners/include.h:26-34)
_PLANNER_INDEX = ("sampling", "gradient", "ilqg", "ilqs", "robust",
                  "cross_entropy", "sample_gradient")
# the ported planners: (planner class, its config)
_PLANNERS = {
    "sampling": (sampling.SamplingPlanner, sampling.SamplingConfig),
    "cross_entropy": (cross_entropy.CrossEntropyPlanner,
                      cross_entropy.CEMConfig),
}
# the ROADMAP queue 1 item that ports each other planner
_PLANNER_ITEM = {"robust": 9, "sample_gradient": 9, "gradient": 10,
                 "ilqg": 10, "ilqs": 10}


class Agent:
  """Predictive-control agent: owns task, planner, policy and state."""

  def __init__(self, task: str | task_base.Task,
               planner: Optional[str] = None,
               horizon_steps: Optional[int] = None, seed: int = 0,
               device=devices.DEFAULT):
    device = devices.resolve(device)
    if isinstance(task, str):
      task = registry.get_task(task, device=device)
    if planner is None:
      idx = int(task.model.custom("agent_planner", 0))
      planner = _PLANNER_INDEX[idx] if idx < len(_PLANNER_INDEX) \
          else "sampling"
    if planner not in _PLANNERS:
      item = _PLANNER_ITEM.get(planner)
      raise NotImplementedError(
          f"planner {planner!r} is not ported yet"
          + (f" (ROADMAP queue 1 item {item})" if item else "")
          + f"; this package has {sorted(_PLANNERS)}")
    self.device = device
    self.sim_task = task  # model at the XML timestep
    # planning model runs at agent_timestep (reference agent.cc:288-293)
    agent_dt = task.model.custom("agent_timestep", None)
    plan_model = task.model
    if agent_dt is not None:
      plan_model = task.model.replace(opt=task.model.opt.replace(
          timestep=torch.tensor(agent_dt, dtype=task.model.dtype,
                                device=device)))
    self.task = task.replace(model=plan_model)

    self.planner_name = planner
    planner_cls, config_cls = _PLANNERS[planner]
    self.planner = planner_cls(config_cls.from_task(self.task,
                                                    horizon_steps))
    self.policy = self.planner.init(self.task)
    self.data = phys_io.make_data(task.model)
    self.generator = torch.Generator(device=device).manual_seed(seed)
    self.last_info = None

  # ------------------------------------------------------------- state API
  def set_state(self, qpos=None, qvel=None, time=None, act=None,
                mocap_pos=None, mocap_quat=None, userdata=None):
    d = self.data
    kw = {}
    for name, val in (("qpos", qpos), ("qvel", qvel), ("time", time),
                      ("act", act), ("mocap_pos", mocap_pos),
                      ("mocap_quat", mocap_quat), ("userdata", userdata)):
      if val is not None:
        kw[name] = torch.as_tensor(np.asarray(val), dtype=d.qpos.dtype,
                                   device=self.device)
    self.data = d.replace(**kw)

  def get_state(self):
    d = self.data
    return {
        "time": float(d.time), "qpos": d.qpos.cpu().numpy(),
        "qvel": d.qvel.cpu().numpy(), "act": d.act.cpu().numpy(),
        "mocap_pos": d.mocap_pos.cpu().numpy(),
        "mocap_quat": d.mocap_quat.cpu().numpy(),
        "userdata": d.userdata.cpu().numpy(),
    }

  def reset(self, keyframe: Optional[str] = None):
    self.data = phys_io.make_data(self.sim_task.model)
    if keyframe is not None:
      qpos, qvel, _ = self.task.model.keyframe(keyframe)
      self.set_state(qpos=qpos, qvel=qvel)
    self.policy = self.planner.init(self.task)

  # ------------------------------------------------------------ task modes
  @property
  def mode_names(self):
    return self.task.mode_names

  def set_mode(self, mode):
    """Select the task mode by name or index (reference Agent SetMode): the
    index lands in userdata[MODE_SLOT], which the next plan passes to the
    kernel."""
    idx = (self.task.mode_names.index(mode) if isinstance(mode, str)
           else int(mode))
    ud = self.data.userdata.clone()
    ud[task_base.MODE_SLOT] = idx
    self.data = self.data.replace(userdata=ud)

  def get_mode(self) -> str:
    idx = int(self.data.userdata[task_base.MODE_SLOT])
    names = self.task.mode_names
    return names[idx] if 0 <= idx < len(names) else str(idx)

  # ------------------------------------------------------------ task knobs
  def set_cost_weights(self, weights: dict):
    """SetCostWeights by term name; the next plan's kernel weights."""
    task = self.task
    for name, val in weights.items():
      task = task.set_weight(name, val)
    self.task = task

  def set_task_parameter(self, name: str, value: float):
    """SetTaskParameters by residual_* name; the next plan's kernel
    residual parameters."""
    self.task = self.task.set_parameter(name, value)

  def get_cost_weights(self):
    return dict(zip(self.task.spec.names,
                    self.task.params.weights.cpu().numpy()))

  # -------------------------------------------------------------- planning
  def planner_step(self):
    """One planning iteration against the current state (PlanIteration,
    agent.cc:283-357)."""
    self.policy, info = self.planner.optimize(self.task, self.policy,
                                              self.data, self.generator)
    self.last_info = info
    return info

  def action(self, time: Optional[float] = None) -> np.ndarray:
    """ActionFromPolicy at the given (default current) time."""
    d = self.data
    if time is not None:
      d = d.replace(time=torch.tensor(time, dtype=d.qpos.dtype,
                                      device=self.device))
    return self.planner.action(self.task, self.policy, d).cpu().numpy()

  def step(self, *args, **kwargs):
    """Advancing the world needs the general physics engine
    (physics/step.py), which is not ported yet."""
    raise NotImplementedError(
        "Agent.step needs the general physics engine: ROADMAP queue 1 "
        "item 3 (smooth dynamics, step.py) and item 4 (contacts)")
