"""gRPC Agent service: the reference's agent service over the port's Agent.

Counterpart of mujoco_mpc_tpu/service/agent_service.py (reference
mjpc/grpc/agent_service.{h,cc}): a headless synchronous agent behind gRPC.
Step is transition, action from the policy, physics step
(agent_service.cc:224-246); PlannerStep is one plan iteration (:212-221).
The wire is the JAX package's: the same messages (agent.proto, copied with
its generated module) under the same service name, so that a client of
either package talks to a server of either. The methods are registered
through grpc's generic handlers, as there.

The server's Agent runs on the device it is given (the card unless the
caller asks for the CPU). Init with `model_xml` builds the task on that
MJCF where `mujoco` imports, and is refused (UNIMPLEMENTED) where it does
not, as on a card's host without it: there the tasks load their
snapshots (tasks/models/*.npz).

    python -m mujoco_mpc_torch.service.agent_service --port 10000
    python -m mujoco_mpc_torch.service.agent_service --device cpu
"""

from __future__ import annotations

from concurrent import futures
from typing import Optional

import grpc
import numpy as np
import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.agent.agent import Agent
from mujoco_mpc_torch.physics import step as phys_step
from mujoco_mpc_torch.service import agent_pb2 as pb
from mujoco_mpc_torch.tasks import registry

_SERVICE = "mjpc_tpu.Agent"


class AgentServicer:
  """Method implementations; one Agent per server, on `device`."""

  def __init__(self, device=devices.DEFAULT):
    self.device = device
    self.agent: Optional[Agent] = None

  # each handler: request proto -> response proto
  def Init(self, req: pb.InitRequest, ctx) -> pb.InitResponse:
    try:
      self.agent = Agent(req.task_id, planner=req.planner or "sampling",
                         horizon_steps=req.horizon_steps or None,
                         model_xml=req.model_xml or None,
                         device=self.device)
    except registry.ModelXmlRefused as e:
      ctx.abort(grpc.StatusCode.UNIMPLEMENTED, str(e))
    # warm-up: builds the kernel and runs each path once (plan, step,
    # cost) under Init's long client deadline, so that later RPCs answer
    # at steady-state latency
    self.agent.planner_step()
    self.agent.step()
    self.agent.total_cost()
    self.agent.reset()
    return pb.InitResponse()

  def _require(self) -> Agent:
    if self.agent is None:
      raise RuntimeError("call Init first")
    return self.agent

  def SetState(self, req: pb.SetStateRequest, ctx) -> pb.SetStateResponse:
    a = self._require()
    s = req.state
    kw = {}
    for name in ("qpos", "qvel", "act", "userdata"):
      if getattr(s, name):
        kw[name] = np.asarray(getattr(s, name))
    if s.mocap_pos:
      kw["mocap_pos"] = np.asarray(s.mocap_pos).reshape(-1, 3)
    if s.mocap_quat:
      kw["mocap_quat"] = np.asarray(s.mocap_quat).reshape(-1, 4)
    if s.time:
      kw["time"] = s.time
    a.set_state(**kw)
    return pb.SetStateResponse()

  def _state_msg(self, a: Agent) -> pb.State:
    st = a.get_state()
    return pb.State(
        time=st["time"], qpos=st["qpos"].tolist(),
        qvel=st["qvel"].tolist(), act=st["act"].tolist(),
        mocap_pos=st["mocap_pos"].ravel().tolist(),
        mocap_quat=st["mocap_quat"].ravel().tolist(),
        userdata=st["userdata"].tolist())

  def GetState(self, req, ctx) -> pb.GetStateResponse:
    return pb.GetStateResponse(state=self._state_msg(self._require()))

  def GetAction(self, req: pb.GetActionRequest, ctx) -> pb.GetActionResponse:
    a = self._require()
    t = req.time if req.time >= 0 else None
    if req.averaging_duration > 0:
      # the reference's rollout averaging (grpc_agent_util.cc GetAction):
      # the physics runs on over the window under the policy and the
      # executed actions are averaged, then the state is put back
      m = a.sim_task.model
      n = max(1, int(round(req.averaging_duration /
                           float(m.opt.timestep))))
      saved = a.data
      dtype = saved.qpos.dtype
      if t is not None:
        a.data = a.data.replace(time=torch.tensor(t, dtype=dtype,
                                                  device=a.device))
      actions = []
      for _ in range(n):
        u = a.action(use_previous=req.use_previous_policy,
                     nominal=req.nominal_action)
        actions.append(u)
        a.data = phys_step.step(m, a.data.replace(
            ctrl=torch.as_tensor(u, dtype=dtype, device=a.device)))
      act = np.stack(actions).mean(axis=0)
      a.data = saved
    else:
      act = a.action(time=t, use_previous=req.use_previous_policy,
                     nominal=req.nominal_action)
    return pb.GetActionResponse(action=act.tolist())

  def PlannerStep(self, req, ctx) -> pb.PlannerStepResponse:
    info = self._require().planner_step()
    return pb.PlannerStepResponse(best_return=float(info.best_return))

  def Step(self, req: pb.StepRequest, ctx) -> pb.StepResponse:
    a = self._require()
    a.step()
    return pb.StepResponse(state=self._state_msg(a))

  def Reset(self, req: pb.ResetRequest, ctx) -> pb.ResetResponse:
    self._require().reset(keyframe=req.keyframe or None)
    return pb.ResetResponse()

  def SetTaskParameters(self, req, ctx):
    a = self._require()
    for p in req.parameters:
      a.set_task_parameter(p.name, p.value)
    return pb.SetTaskParametersResponse()

  def GetTaskParameters(self, req, ctx):
    a = self._require()
    out = pb.GetTaskParametersResponse()
    vals = a.task.params.residual_params.cpu().numpy()
    for name, val in zip(a.task.param_names, vals):
      out.parameters.append(pb.TaskParameter(name=name, value=float(val)))
    return out

  def SetCostWeights(self, req, ctx):
    self._require().set_cost_weights(
        {w.name: w.weight for w in req.weights})
    return pb.SetCostWeightsResponse()

  def GetCostValuesAndWeights(self, req, ctx):
    a = self._require()
    terms = a.cost_terms()
    weights = a.get_cost_weights()
    out = pb.GetCostValuesAndWeightsResponse(total_cost=a.total_cost())
    for name in terms:
      out.terms.append(pb.CostTerm(name=name, value=float(terms[name]),
                                   weight=float(weights[name])))
    return out

  def GetResiduals(self, req, ctx):
    a = self._require()
    r = a.task.residual(a.task.model, a._forward(),
                        a.task.params.residual_params)
    return pb.GetResidualsResponse(residuals=r.cpu().numpy().tolist())

  def StartPlanning(self, req: pb.StartPlanningRequest, ctx):
    self._require().start_planning(rate_limit_hz=req.rate_limit_hz or None)
    return pb.StartPlanningResponse()

  def StopPlanning(self, req, ctx):
    self._require().stop_planning()
    return pb.StopPlanningResponse()

  def SetMode(self, req: pb.SetModeRequest, ctx):
    self._require().set_mode(req.mode)
    return pb.SetModeResponse()

  def GetMode(self, req, ctx):
    return pb.GetModeResponse(mode=self._require().get_mode())

  def GetAllModes(self, req, ctx):
    return pb.GetAllModesResponse(
        mode_names=list(self._require().mode_names))

  def SetAnything(self, req: pb.SetAnythingRequest, ctx):
    """State, weights, parameters, mode and ctrl in one call (reference
    SetAnything, grpc_agent_util.cc)."""
    a = self._require()
    if req.HasField("state"):
      self.SetState(pb.SetStateRequest(state=req.state), ctx)
    if req.cost_weights:
      a.set_cost_weights({w.name: w.weight for w in req.cost_weights})
    for p in req.parameters:
      a.set_task_parameter(p.name, p.value)
    if req.mode:
      a.set_mode(req.mode)
    if req.ctrl:
      a.data = a.data.replace(ctrl=torch.as_tensor(
          np.asarray(req.ctrl), dtype=a.data.ctrl.dtype, device=a.device))
    return pb.SetAnythingResponse()

  def GetBestTrajectory(self, req, ctx):
    info = self._require().last_info
    if info is None:
      return pb.GetBestTrajectoryResponse()
    return pb.GetBestTrajectoryResponse(
        best_return=float(info.best_return),
        candidate_returns=info.costs.cpu().numpy().tolist(),
        winner=int(info.winner))


RPCS = [
    ("Init", pb.InitRequest, pb.InitResponse),
    ("StartPlanning", pb.StartPlanningRequest, pb.StartPlanningResponse),
    ("StopPlanning", pb.StopPlanningRequest, pb.StopPlanningResponse),
    ("SetState", pb.SetStateRequest, pb.SetStateResponse),
    ("GetState", pb.GetStateRequest, pb.GetStateResponse),
    ("GetAction", pb.GetActionRequest, pb.GetActionResponse),
    ("PlannerStep", pb.PlannerStepRequest, pb.PlannerStepResponse),
    ("Step", pb.StepRequest, pb.StepResponse),
    ("Reset", pb.ResetRequest, pb.ResetResponse),
    ("SetTaskParameters", pb.SetTaskParametersRequest,
     pb.SetTaskParametersResponse),
    ("GetTaskParameters", pb.GetTaskParametersRequest,
     pb.GetTaskParametersResponse),
    ("SetCostWeights", pb.SetCostWeightsRequest, pb.SetCostWeightsResponse),
    ("GetCostValuesAndWeights", pb.GetCostValuesAndWeightsRequest,
     pb.GetCostValuesAndWeightsResponse),
    ("GetResiduals", pb.GetResidualsRequest, pb.GetResidualsResponse),
    ("GetBestTrajectory", pb.GetBestTrajectoryRequest,
     pb.GetBestTrajectoryResponse),
    ("SetMode", pb.SetModeRequest, pb.SetModeResponse),
    ("GetMode", pb.GetModeRequest, pb.GetModeResponse),
    ("GetAllModes", pb.GetAllModesRequest, pb.GetAllModesResponse),
    ("SetAnything", pb.SetAnythingRequest, pb.SetAnythingResponse),
]


def serve(service: str, servicer, rpcs, port: int = 0,
          max_workers: int = 4) -> tuple[grpc.Server, int]:
  """A started server on localhost:port (0: a free one) with servicer's
  methods registered under `service`; returns (server, bound port)."""
  handlers = {}
  for name, req_cls, resp_cls in rpcs:
    method = getattr(servicer, name)
    handlers[name] = grpc.unary_unary_rpc_method_handler(
        lambda req, ctx, _m=method: _m(req, ctx),
        request_deserializer=req_cls.FromString,
        response_serializer=resp_cls.SerializeToString)
  server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
  server.add_generic_rpc_handlers(
      (grpc.method_handlers_generic_handler(service, handlers),))
  bound = server.add_insecure_port(f"localhost:{port}")
  server.start()
  return server, bound


def connect(channel, service, rpcs):
  """{name: callable(request, timeout=None)} of the service's methods on
  a channel."""
  return {name: channel.unary_unary(
      f"/{service}/{name}", request_serializer=req_cls.SerializeToString,
      response_deserializer=resp_cls.FromString)
          for name, req_cls, resp_cls in rpcs}


def make_server(port: int = 0, max_workers: int = 4,
                device=devices.DEFAULT,
                servicer: Optional[AgentServicer] = None
                ) -> tuple[grpc.Server, int]:
  """Build and start the agent server (its Agent on `device`, or the
  given servicer's); returns (server, bound port)."""
  return serve(_SERVICE, servicer or AgentServicer(device), RPCS, port,
               max_workers)


def main():
  import argparse

  parser = argparse.ArgumentParser(description="mujoco_mpc_torch agent "
                                   "server")
  parser.add_argument("--port", type=int, default=10000)
  parser.add_argument("--device", default=devices.DEFAULT,
                      help="where the Agent runs: cuda (default) or cpu")
  args = parser.parse_args()
  devices.resolve(args.device)
  server, port = make_server(args.port, device=args.device)
  print(f"mujoco_mpc_torch agent server listening on {port}", flush=True)
  server.wait_for_termination()


if __name__ == "__main__":
  main()
