"""Python client for the Agent service.

Counterpart of mujoco_mpc_tpu/service/client.py; its API follows the
reference's Python package (python/mujoco_mpc/agent.py:68-392): a context
manager that spawns the port's agent server as a subprocess on a free port
(or connects to a running one, of either package: the wire is the same)
and exposes set_state / get_state / get_action / planner_step / step /
set_task_parameter(s) / set_cost_weights / get_total_cost / ... methods.
A spawned server runs its Agent on `device` (the card by default).
"""

from __future__ import annotations

import atexit
import os
import socket
import subprocess
import sys
from typing import Optional

import grpc
import numpy as np

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.service import agent_pb2 as pb

_SERVICE = "mjpc_tpu.Agent"


def _find_free_port() -> int:
  with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
    s.bind(("localhost", 0))
    return s.getsockname()[1]


class AgentClient:
  """Context-manager client; spawns an agent server unless given a port."""

  def __init__(self, task_id: str, planner: str = "sampling",
               horizon_steps: int = 0, port: Optional[int] = None,
               server_timeout: float = 600.0, device=devices.DEFAULT,
               model_xml: str = ""):
    self._proc = None
    # every RPC gets this deadline: Init builds the kernel and runs each
    # path once on the server, and an unbounded default deadline turns a
    # wedged server into a hung caller
    self._timeout = server_timeout
    if port is None:
      port = _find_free_port()
      env = dict(os.environ)
      cmd = [sys.executable, "-m", "mujoco_mpc_torch.service.agent_service",
             f"--port={port}", f"--device={device}"]
      self._proc = subprocess.Popen(
          cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
      atexit.register(self.close)
    self._channel = grpc.insecure_channel(f"localhost:{port}")
    grpc.channel_ready_future(self._channel).result(timeout=server_timeout)

    def rpc(name, req_cls, resp_cls):
      call = self._channel.unary_unary(
          f"/{_SERVICE}/{name}",
          request_serializer=req_cls.SerializeToString,
          response_deserializer=resp_cls.FromString)

      def call_with_deadline(req, timeout=None, _call=call):
        return _call(req, timeout=self._timeout if timeout is None
                     else timeout)

      return call_with_deadline

    self._init = rpc("Init", pb.InitRequest, pb.InitResponse)
    self._set_state = rpc("SetState", pb.SetStateRequest, pb.SetStateResponse)
    self._get_state = rpc("GetState", pb.GetStateRequest, pb.GetStateResponse)
    self._get_action = rpc("GetAction", pb.GetActionRequest,
                           pb.GetActionResponse)
    self._planner_step = rpc("PlannerStep", pb.PlannerStepRequest,
                             pb.PlannerStepResponse)
    self._step = rpc("Step", pb.StepRequest, pb.StepResponse)
    self._reset = rpc("Reset", pb.ResetRequest, pb.ResetResponse)
    self._set_params = rpc("SetTaskParameters", pb.SetTaskParametersRequest,
                           pb.SetTaskParametersResponse)
    self._get_params = rpc("GetTaskParameters", pb.GetTaskParametersRequest,
                           pb.GetTaskParametersResponse)
    self._set_weights = rpc("SetCostWeights", pb.SetCostWeightsRequest,
                            pb.SetCostWeightsResponse)
    self._get_costs = rpc("GetCostValuesAndWeights",
                          pb.GetCostValuesAndWeightsRequest,
                          pb.GetCostValuesAndWeightsResponse)
    self._get_residuals = rpc("GetResiduals", pb.GetResidualsRequest,
                              pb.GetResidualsResponse)
    self._get_best = rpc("GetBestTrajectory", pb.GetBestTrajectoryRequest,
                         pb.GetBestTrajectoryResponse)
    self._start_planning = rpc("StartPlanning", pb.StartPlanningRequest,
                               pb.StartPlanningResponse)
    self._stop_planning = rpc("StopPlanning", pb.StopPlanningRequest,
                              pb.StopPlanningResponse)
    self._set_mode = rpc("SetMode", pb.SetModeRequest, pb.SetModeResponse)
    self._get_mode = rpc("GetMode", pb.GetModeRequest, pb.GetModeResponse)
    self._get_all_modes = rpc("GetAllModes", pb.GetAllModesRequest,
                              pb.GetAllModesResponse)
    self._set_anything = rpc("SetAnything", pb.SetAnythingRequest,
                             pb.SetAnythingResponse)

    self._init(pb.InitRequest(task_id=task_id, planner=planner,
                              horizon_steps=horizon_steps,
                              model_xml=model_xml),
               timeout=server_timeout)

  # ------------------------------------------------------------------- API
  def set_state(self, qpos=None, qvel=None, time=None, act=None,
                mocap_pos=None, mocap_quat=None, userdata=None):
    s = pb.State()
    if time is not None:
      s.time = time
    for field, val in (("qpos", qpos), ("qvel", qvel), ("act", act),
                       ("userdata", userdata)):
      if val is not None:
        getattr(s, field).extend(np.asarray(val).ravel().tolist())
    if mocap_pos is not None:
      s.mocap_pos.extend(np.asarray(mocap_pos).ravel().tolist())
    if mocap_quat is not None:
      s.mocap_quat.extend(np.asarray(mocap_quat).ravel().tolist())
    self._set_state(pb.SetStateRequest(state=s))

  def get_state(self) -> dict:
    st = self._get_state(pb.GetStateRequest()).state
    return {"time": st.time, "qpos": np.asarray(st.qpos),
            "qvel": np.asarray(st.qvel), "act": np.asarray(st.act),
            "mocap_pos": np.asarray(st.mocap_pos).reshape(-1, 3),
            "mocap_quat": np.asarray(st.mocap_quat).reshape(-1, 4),
            "userdata": np.asarray(st.userdata)}

  def get_action(self, time: float = -1.0, averaging_duration: float = 0.0,
                 use_previous_policy: bool = False,
                 nominal_action: bool = False) -> np.ndarray:
    resp = self._get_action(pb.GetActionRequest(
        time=time, averaging_duration=averaging_duration,
        use_previous_policy=use_previous_policy,
        nominal_action=nominal_action))
    return np.asarray(resp.action)

  def set_mode(self, mode: str):
    self._set_mode(pb.SetModeRequest(mode=mode))

  def get_mode(self) -> str:
    return self._get_mode(pb.GetModeRequest()).mode

  def get_all_modes(self) -> list:
    return list(self._get_all_modes(pb.GetAllModesRequest()).mode_names)

  def set_anything(self, qpos=None, qvel=None, time=None, mocap_pos=None,
                   cost_weights=None, parameters=None, mode: str = "",
                   ctrl=None):
    """One-call mutation (reference SetAnything, grpc_agent_util.cc)."""
    req = pb.SetAnythingRequest(mode=mode)
    if any(v is not None for v in (qpos, qvel, time, mocap_pos)):
      s = pb.State()
      if time is not None:
        s.time = time
      for field, val in (("qpos", qpos), ("qvel", qvel)):
        if val is not None:
          getattr(s, field).extend(np.asarray(val).ravel().tolist())
      if mocap_pos is not None:
        s.mocap_pos.extend(np.asarray(mocap_pos).ravel().tolist())
      req.state.CopyFrom(s)
    for name, w in (cost_weights or {}).items():
      req.cost_weights.append(pb.CostWeight(name=name, weight=w))
    for name, v in (parameters or {}).items():
      req.parameters.append(pb.TaskParameter(name=name, value=v))
    if ctrl is not None:
      req.ctrl.extend(np.asarray(ctrl).ravel().tolist())
    self._set_anything(req)

  def planner_step(self) -> float:
    return self._planner_step(pb.PlannerStepRequest()).best_return

  def step(self) -> dict:
    st = self._step(pb.StepRequest()).state
    return {"time": st.time, "qpos": np.asarray(st.qpos),
            "qvel": np.asarray(st.qvel)}

  def reset(self, keyframe: str = ""):
    self._reset(pb.ResetRequest(keyframe=keyframe))

  def set_task_parameter(self, name: str, value: float):
    self.set_task_parameters({name: value})

  def set_task_parameters(self, params: dict):
    req = pb.SetTaskParametersRequest()
    for k, v in params.items():
      req.parameters.append(pb.TaskParameter(name=k, value=v))
    self._set_params(req)

  def get_task_parameters(self) -> dict:
    resp = self._get_params(pb.GetTaskParametersRequest())
    return {p.name: p.value for p in resp.parameters}

  def set_cost_weights(self, weights: dict):
    req = pb.SetCostWeightsRequest()
    for k, v in weights.items():
      req.weights.append(pb.CostWeight(name=k, weight=v))
    self._set_weights(req)

  def get_cost_term_values(self) -> dict:
    resp = self._get_costs(pb.GetCostValuesAndWeightsRequest())
    return {t.name: t.value for t in resp.terms}

  def get_total_cost(self) -> float:
    return self._get_costs(pb.GetCostValuesAndWeightsRequest()).total_cost

  def get_residuals(self) -> np.ndarray:
    return np.asarray(
        self._get_residuals(pb.GetResidualsRequest()).residuals)

  def get_best_trajectory(self) -> dict:
    resp = self._get_best(pb.GetBestTrajectoryRequest())
    return {"best_return": resp.best_return, "winner": resp.winner,
            "candidate_returns": np.asarray(resp.candidate_returns)}

  def start_planning(self, rate_limit_hz: float = 0.0):
    """Launch background planning on the server (ui_agent semantics)."""
    self._start_planning(pb.StartPlanningRequest(rate_limit_hz=rate_limit_hz),
                         timeout=300)

  def stop_planning(self):
    self._stop_planning(pb.StopPlanningRequest())

  # --------------------------------------------------------------- cleanup
  def close(self):
    if self._channel is not None:
      self._channel.close()
      self._channel = None
    if self._proc is not None:
      self._proc.terminate()
      try:
        self._proc.wait(timeout=5)
      except subprocess.TimeoutExpired:
        self._proc.kill()
      self._proc = None

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()
