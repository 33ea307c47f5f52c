"""Agent: the host-side shell around the planner's plan and act calls.

Counterpart of mujoco_mpc_tpu/agent/agent.py (reference mjpc/agent.h:
45-256). Sync mode is the closed loop of the reference's headless agent
service (grpc/agent_service.cc:212-246): callers interleave planner_step()
and step() (transition, action, physics), and read total_cost(),
cost_terms() and best_trajectory(). Async mode is the GUI's
plan-while-acting loop (agent.cc:360-371): start_planning() runs
planner_step in a background thread against the latest state, and
action() and step() read the latest finished policy; a lock guards the
task, state, policy and estimate the threads share. The planning model
runs at the task's `agent_timestep` (reference agent.cc:288-293), the
world at the model's timestep through the general engine
(physics/step.py). The task knobs (cost weights, task parameters, the
mode) take effect at the next plan.

A state estimator (estimators/) runs beside the world (reference
EstimatorLoop, app.cc:151-206): attach_estimator() builds one on the
simulation model, step() feeds it the new state's sensors, or
start_estimation() moves its updates to a thread of their own that
follows the latest published state, and planner_step(from_estimate=True)
plans from its estimate. An error in that thread is raised again at
stop_estimation() and estimated_state().
"""

from __future__ import annotations

import threading
import time as time_mod
from typing import Optional

import numpy as np
import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.ops import rollout as rollout_mod
from mujoco_mpc_torch.physics import io as phys_io
from mujoco_mpc_torch.physics import step as phys_step
from mujoco_mpc_torch.planners import (cross_entropy, gradient, ilqg, ilqs,
                                       robust, sample_gradient, sampling)
from mujoco_mpc_torch.tasks import base as task_base
from mujoco_mpc_torch.tasks import registry

# reference planner enum order (mjpc/planners/include.h:26-34)
_PLANNER_INDEX = ("sampling", "gradient", "ilqg", "ilqs", "robust",
                  "cross_entropy", "sample_gradient")
# each planner's factory, (planning task, horizon_steps) -> planner, in
# the reference order
_PLANNERS = {
    "sampling": lambda task, horizon: sampling.SamplingPlanner(
        sampling.SamplingConfig.from_task(task, horizon)),
    "gradient": lambda task, horizon: gradient.GradientPlanner(
        gradient.GradientConfig.from_task(task, horizon)),
    "ilqg": lambda task, horizon: ilqg.ILQGPlanner(
        ilqg.ILQGConfig.from_task(task, horizon)),
    "ilqs": lambda task, horizon: ilqs.ILQSPlanner(
        ilqs.ILQSConfig.from_task(task, horizon)),
    "robust": lambda task, horizon: robust.RobustPlanner(
        sampling.SamplingPlanner(
            sampling.SamplingConfig.from_task(task, horizon)),
        robust.RobustConfig()),
    "cross_entropy": lambda task, horizon: cross_entropy.CrossEntropyPlanner(
        cross_entropy.CEMConfig.from_task(task, horizon)),
    "sample_gradient": lambda task, horizon:
        sample_gradient.SampleGradientPlanner(
            sample_gradient.SGConfig.from_task(task, horizon)),
}


def register_planner(name: str, factory):
  """Add a planner under `name` beside the seven (reference planner
  registry, mjpc/planners/include.h): factory(planning task,
  horizon_steps) returns the planner, an object with a `config` that
  implements planners/base.py::Planner, as a _PLANNERS entry does, and
  Agent(task, planner=name) builds it. The task MJCF's agent_planner
  index still names only the seven (_PLANNER_INDEX)."""
  _PLANNERS[name] = factory


class Agent:
  """Predictive-control agent: owns task, planner, policy and state."""

  def __init__(self, task: str | task_base.Task,
               planner: Optional[str] = None,
               horizon_steps: Optional[int] = None, seed: int = 0,
               dtype=torch.float32, model_xml: Optional[str] = None,
               device=devices.DEFAULT):
    """`dtype` is the precision of a task named by string; `model_xml`
    gives the task (named, or the registered task of a Task's name) the
    model, cost spec and parameters of that MJCF, in `dtype`, built with
    `mujoco` (registry.get_task; registry.ModelXmlRefused where `mujoco`
    does not import)."""
    device = devices.resolve(device)
    if isinstance(task, str) or model_xml is not None:
      task = registry.get_task(task if isinstance(task, str) else task.name,
                               dtype=dtype, device=device,
                               model_xml=model_xml)
    if planner is None:
      idx = int(task.model.custom("agent_planner", 0))
      planner = _PLANNER_INDEX[idx] if idx < len(_PLANNER_INDEX) \
          else "sampling"
    if planner not in _PLANNERS:
      raise ValueError(f"unknown planner {planner!r}; the planners are "
                       f"{list(_PLANNERS)}")
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
    self.planner = _PLANNERS[planner](self.task, horizon_steps)
    self.policy = self.planner.init(self.task)
    self.previous_policy = self.policy
    self.data = phys_io.make_data(task.model)
    self.generator = torch.Generator(device=device).manual_seed(seed)
    self.last_info = None
    # the Ornstein-Uhlenbeck control noise of step (reference app.cc:
    # 292-304)
    self._ou_noise = torch.zeros_like(self.data.ctrl)
    # the async plan loop's lock (task, data, policy, estimate), thread and
    # stop flag
    self._lock = threading.Lock()
    self._plan_thread: Optional[threading.Thread] = None
    self._exit = threading.Event()
    self._plan_error: Optional[BaseException] = None
    # the count of published world states (set_state, step), the one the
    # last plan started from, and the count of finished plans
    self._data_version = 0
    self.plan_version = 0
    self.plans = 0
    # the attached estimator, its state, its thread, stop flag, error and
    # count of updates
    self._estimator = None
    self._est_state = None
    self._est_thread: Optional[threading.Thread] = None
    self._est_exit = threading.Event()
    self._est_error: Optional[BaseException] = None
    self.estimator_updates = 0

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
    with self._lock:
      self.data = self.data.replace(**kw)
      self._data_version += 1

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
    with self._lock:
      self.data = self.task.set_mode(self.data, idx)

  def get_mode(self) -> str:
    idx = int(self.task.get_mode(self.data))
    names = self.task.mode_names
    return names[idx] if 0 <= idx < len(names) else str(idx)

  # ------------------------------------------------------------ task knobs
  def set_cost_weights(self, weights: dict):
    """SetCostWeights by term name; the next plan's kernel weights."""
    with self._lock:
      task = self.task
      for name, val in weights.items():
        task = task.set_weight(name, val)
      self.task = task

  def set_task_parameter(self, name: str, value: float):
    """SetTaskParameters by residual_* name; the next plan's kernel
    residual parameters."""
    with self._lock:
      self.task = self.task.set_parameter(name, value)

  def get_cost_weights(self):
    return dict(zip(self.task.spec.names,
                    self.task.params.weights.cpu().numpy()))

  # -------------------------------------------------------------- planning
  def planner_step(self, from_estimate: bool = False, **inputs):
    """One planning iteration against the current state (PlanIteration,
    agent.cc:283-357), or, with from_estimate, against the attached
    estimator's estimate of it (the reference's estimator_enabled path).
    `inputs` are the planner's random draws where they are injected
    (noise=, use2=, eps=)."""
    with self._lock:
      task, data, policy = self.task, self.data, self.policy
      version, est = self._data_version, self._est_state
    if from_estimate:
      if self._estimator is None:
        raise RuntimeError("no estimator attached")
      qpos, qvel, act = self._estimator.state(est)
      data = data.replace(qpos=qpos, qvel=qvel, act=act)
    new_policy, info = self.planner.optimize(task, policy, data,
                                             self.generator, **inputs)
    with self._lock:
      self.previous_policy = self.policy
      self.policy = new_policy
      self.last_info = info
      self.plan_version = version
      self.plans += 1
    return info

  def action(self, time: Optional[float] = None,
             use_previous: bool = False,
             nominal: bool = False) -> np.ndarray:
    """ActionFromPolicy at the given (default current) time, of the
    policy before the last plan with use_previous. nominal=True leaves
    out the feedback terms (reference GetAction nominal_action,
    agent.proto:106-111): a feedback policy (iLQG's) has its gains
    zeroed; the spline policies are nominal already."""
    with self._lock:
      policy = self.previous_policy if use_previous else self.policy
      d = self.data
    if nominal and hasattr(policy, "feedback_scale"):
      policy = policy.replace(
          feedback_scale=torch.zeros_like(policy.feedback_scale))
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
    normals drawn from the agent's generator or given as eps (nu,). An
    attached estimator is then updated with the new state's sensors,
    unless its own thread runs (start_estimation). Returns the new
    Data."""
    with self._lock:
      task, policy, d = self.task, self.policy, self.data
    d = task.run_transition(d)
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
    d = phys_step.step(self.sim_task.model, d.replace(ctrl=u))
    with self._lock:
      self.data = d
      self._data_version += 1
    if self._estimator is not None and self._est_thread is None:
      est = self._estimate(self._est_state, d)
      with self._lock:
        self._est_state = est
        self.estimator_updates += 1
    return d

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
    with self._lock:
      task, policy, data = self.task, self.policy, self.data
    hor = horizon or getattr(self.planner.config, "horizon", 100)
    res = rollout_mod.rollout(
        task, data, lambda t, dd: self.planner.action(task, policy, dd), hor)
    return {"qpos": res.qpos.cpu().numpy(),
            "costs": res.costs.cpu().numpy(),
            "total_return": float(res.total_return)}

  # ----------------------------------------------------------- estimation
  def attach_estimator(self, name: str = "kalman", **kwargs):
    """Build the estimator `name` (estimators.ESTIMATORS) on the
    simulation model, measuring its estimators.base.measurement_slice
    unless kwargs say otherwise, and start it from the current state."""
    from mujoco_mpc_torch.estimators import base as est_base
    from mujoco_mpc_torch.estimators import get_estimator
    start, dim = est_base.measurement_slice(self.sim_task.model)
    kwargs.setdefault("sensor_start", start)
    kwargs.setdefault("nsensordata", dim)
    self._estimator = get_estimator(name, self.sim_task.model, **kwargs)
    with self._lock:
      self._est_state = self._estimator.init(self.data)

  def _estimate(self, est, d):
    """est updated with the state d: its control and the sensors of
    forward(d)."""
    df = phys_step.forward(self.sim_task.model, d)
    return self._estimator.update(est, d.ctrl, df.sensordata)

  def start_estimation(self, rate_limit_hz: Optional[float] = None):
    """Run the estimator's updates in a thread of their own until
    stop_estimation (the reference's estimator thread, app.cc:151-206):
    each update takes the latest published world state (the latest wins;
    states published meanwhile are skipped) and publishes its estimate, at
    most rate_limit_hz a second where given. step() then leaves the
    estimator to the thread."""
    if self._estimator is None:
      raise RuntimeError("no estimator attached")
    if self._est_thread is not None:
      return
    self._est_exit.clear()
    self._est_error = None

    def loop():
      last_seen = -1
      try:
        while not self._est_exit.is_set():
          with self._lock:
            version, d, est = self._data_version, self.data, self._est_state
          if version == last_seen:
            self._est_exit.wait(1e-4)
            continue
          t0 = time_mod.perf_counter()
          est = self._estimate(est, d)
          devices.wait(self.device)
          with self._lock:
            self._est_state = est
            self.estimator_updates += 1
          last_seen = version
          if rate_limit_hz:
            wait = 1.0 / rate_limit_hz - (time_mod.perf_counter() - t0)
            if wait > 0:
              self._est_exit.wait(wait)
      except BaseException as e:  # raised again in the caller's thread
        self._est_error = e

    self._est_thread = threading.Thread(target=loop, daemon=True)
    self._est_thread.start()

  def _raise_estimation_error(self):
    if self._est_error is not None:
      err, self._est_error = self._est_error, None
      raise RuntimeError("the estimation thread failed") from err

  def stop_estimation(self):
    """Stop the estimation thread and wait for it (its last update ends
    first); raises the error that ended it, if one did."""
    self._est_exit.set()
    if self._est_thread is not None:
      self._est_thread.join()
      self._est_thread = None
    self._raise_estimation_error()

  def estimated_state(self) -> dict:
    """The estimator's latest estimate: qpos, qvel and act (numpy)."""
    if self._estimator is None:
      raise RuntimeError("no estimator attached")
    self._raise_estimation_error()
    with self._lock:
      est = self._est_state
    qpos, qvel, act = self._estimator.state(est)
    return {"qpos": qpos.cpu().numpy(), "qvel": qvel.cpu().numpy(),
            "act": act.cpu().numpy()}

  # ------------------------------------------------------------ async API
  def start_planning(self, rate_limit_hz: Optional[float] = None):
    """Run planner_step in a background thread until stop_planning
    (Agent::Plan, agent.cc:360-371), at most rate_limit_hz plans a
    second where given. One plan runs before the thread starts, so a
    policy of this state is in place when this returns. The thread waits
    for each plan's work on the card before the next, as the estimation
    thread does for each update. An error ends the thread, and is raised
    again at stop_planning() and raise_planning_error()."""
    if self._plan_thread is not None:
      return
    self._exit.clear()
    self._plan_error = None
    self.planner_step()

    def loop():
      try:
        while not self._exit.is_set():
          t0 = time_mod.perf_counter()
          self.planner_step()
          devices.wait(self.device)
          if rate_limit_hz:
            wait = 1.0 / rate_limit_hz - (time_mod.perf_counter() - t0)
            if wait > 0:
              self._exit.wait(wait)
      except BaseException as e:  # raised again in the caller's thread
        self._plan_error = e

    self._plan_thread = threading.Thread(target=loop, daemon=True)
    self._plan_thread.start()

  def raise_planning_error(self):
    """Raise the error that ended the plan thread, if one did: at every
    call until stop_planning() joins the thread."""
    if self._plan_error is not None:
      raise RuntimeError("the plan thread failed") from self._plan_error

  def stop_planning(self):
    """Stop the plan loop and wait for its thread (its last plan ends
    first); raises the error that ended it, if one did, and forgets it."""
    self._exit.set()
    if self._plan_thread is not None:
      self._plan_thread.join()
      self._plan_thread = None
    err, self._plan_error = self._plan_error, None
    if err is not None:
      raise RuntimeError("the plan thread failed") from err
