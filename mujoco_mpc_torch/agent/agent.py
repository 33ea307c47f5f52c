"""Agent: the host-side shell around the planner's plan and act calls.

Counterpart of mujoco_mpc_tpu/agent/agent.py (reference mjpc/agent.h:
45-256) in synchronous form, the closed loop of the reference's headless
agent service (grpc/agent_service.cc:212-246): callers interleave
planner_step() and step() (transition, action, physics), and read
total_cost(), cost_terms() and best_trajectory(). The planning model runs
at the task's `agent_timestep` (reference agent.cc:288-293), the world at
the model's timestep through the general engine (physics/step.py). The
task knobs (cost weights, task parameters, the mode) take effect at the
next plan. The async plan loop and the estimators are not ported yet
(ROADMAP queue 1 items 8 and 12).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.ops import rollout as rollout_mod
from mujoco_mpc_torch.physics import io as phys_io
from mujoco_mpc_torch.physics import step as phys_step
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
    self.previous_policy = self.policy
    self.data = phys_io.make_data(task.model)
    self.generator = torch.Generator(device=device).manual_seed(seed)
    self.last_info = None
    # the Ornstein-Uhlenbeck control noise of step (reference app.cc:
    # 292-304)
    self._ou_noise = torch.zeros_like(self.data.ctrl)

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
    self.previous_policy = self.policy
    self._ou_noise = torch.zeros_like(self.data.ctrl)

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
    new_policy, info = self.planner.optimize(self.task, self.policy,
                                             self.data, self.generator)
    self.previous_policy = self.policy
    self.policy = new_policy
    self.last_info = info
    return info

  def action(self, time: Optional[float] = None,
             use_previous: bool = False) -> np.ndarray:
    """ActionFromPolicy at the given (default current) time, of the
    policy before the last plan with use_previous. The ported planners'
    spline policies have no feedback terms, so there is no nominal_action
    option (reference GetAction) until a feedback planner is ported
    (ROADMAP queue 1 item 10)."""
    policy = self.previous_policy if use_previous else self.policy
    d = self.data
    if time is not None:
      d = d.replace(time=torch.tensor(time, dtype=d.qpos.dtype,
                                      device=self.device))
    return self.planner.action(self.task, policy, d).cpu().numpy()

  def step(self, ctrl_noise_std: float = 0.0, ctrl_noise_rate: float = 0.1,
           eps: Optional[torch.Tensor] = None):
    """One synchronous world step (AgentService::Step, grpc/
    agent_service.cc:224-246): the task's transition, the policy's action
    at the state's time, the general physics step of the simulation model.
    ctrl_noise_std > 0 adds Ornstein-Uhlenbeck noise to the action, scaled
    by half the control range (reference app.cc:292-304), its standard
    normals drawn from the agent's generator or given as eps (nu,).
    Returns the new Data."""
    task, policy = self.task, self.policy
    d = task.run_transition(self.data)
    u = self.planner.action(task, policy, d)
    if ctrl_noise_std > 0:
      m = self.sim_task.model
      scale = 0.5 * (m.actuator_ctrlrange[:, 1] - m.actuator_ctrlrange[:, 0])
      if eps is None:
        eps = torch.randn(m.nu, generator=self.generator, dtype=u.dtype,
                          device=u.device)
      self._ou_noise = (
          (1.0 - ctrl_noise_rate) * self._ou_noise +
          (ctrl_noise_rate * (2 - ctrl_noise_rate)) ** 0.5 *
          ctrl_noise_std * scale.to(u.dtype) * eps)
      u = u + self._ou_noise
    self.data = phys_step.step(self.sim_task.model, d.replace(ctrl=u))
    return self.data

  def steps(self, n: int, ctrl_noise_std: float = 0.0,
            ctrl_noise_rate: float = 0.1):
    """n calls of step; returns the last Data."""
    d = self.data
    for _ in range(n):
      d = self.step(ctrl_noise_std, ctrl_noise_rate)
    return d

  # ------------------------------------------------------------ costs
  def _forward(self):
    return phys_step.forward(self.sim_task.model, self.data)

  def total_cost(self) -> float:
    """The task's cost at the current state."""
    return float(self.task.cost(self._forward()))

  def cost_terms(self) -> dict:
    """Each cost term's weighted value at the current state."""
    d = self._forward()
    r = self.task.residual(self.task.model, d,
                           self.task.params.residual_params)
    terms = task_base.cost_terms(self.task.spec, self.task.params, r)
    return dict(zip(self.task.spec.names, terms.cpu().numpy()))

  def best_trajectory(self, horizon: Optional[int] = None) -> dict:
    """The current policy rolled from the current state through the
    general rollout (reference GetBestTrajectory, agent.proto:142-146):
    qpos (T, nq), costs (T,) and the total return."""
    task, policy = self.task, self.policy
    hor = horizon or self.planner.config.horizon
    res = rollout_mod.rollout(
        task, self.data,
        lambda t, dd: self.planner.action(task, policy, dd), hor)
    return {"qpos": res.qpos.cpu().numpy(),
            "costs": res.costs.cpu().numpy(),
            "total_return": float(res.total_return)}
