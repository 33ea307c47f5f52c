"""gRPC StateEstimation service and client over the port's estimators.

Counterpart of mujoco_mpc_tpu/service/filter_service.py (reference
filter_service.cc, python/mujoco_mpc/filter.py), on its wire (filter.proto
and its generated module, copied; service "mjpc_tpu.StateEstimation").
Init builds a registered task's estimator (ground_truth, kalman,
unscented or batch) measuring estimators.base.measurement_slice of its
model, on the server's device; Update takes one control and sensor
vector, State, Covariance and Noise read it.
"""

from __future__ import annotations

from typing import Optional

import grpc
import numpy as np
import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.service import filter_pb2 as pb
from mujoco_mpc_torch.service.agent_service import connect, serve

_SERVICE = "mjpc_tpu.StateEstimation"


class FilterServicer:
  def __init__(self, device=devices.DEFAULT):
    self.device = device
    self.model = None
    self.filter = None
    self.state = None

  def Init(self, req: pb.FilterInitRequest, ctx):
    from mujoco_mpc_torch.estimators import base as est_base
    from mujoco_mpc_torch.estimators import get_estimator
    from mujoco_mpc_torch.tasks import registry

    task = registry.get_task(req.task_id, device=self.device)
    self.model = task.model
    start, dim = est_base.measurement_slice(task.model)
    self.filter = get_estimator(req.filter or "kalman", task.model,
                                sensor_start=start, nsensordata=dim)
    self.state = self.filter.init()
    return pb.FilterInitResponse()

  def Reset(self, req, ctx):
    self.state = self.filter.init()
    return pb.FilterResetResponse()

  def _tensor(self, values):
    return torch.as_tensor(np.asarray(list(values)), dtype=self.model.dtype,
                           device=self.model.device)

  def Update(self, req: pb.FilterUpdateRequest, ctx):
    self.state = self.filter.update(self.state, self._tensor(req.ctrl),
                                    self._tensor(req.sensor))
    return pb.FilterUpdateResponse()

  def State(self, req, ctx):
    qpos, qvel, act = self.filter.state(self.state)
    time = (self.state.data.time if hasattr(self.state, "data")
            else self.state.time)
    return pb.FilterStateResponse(
        qpos=qpos.cpu().numpy().tolist(), qvel=qvel.cpu().numpy().tolist(),
        act=act.cpu().numpy().tolist(), time=float(time))

  def Covariance(self, req, ctx):
    cov = getattr(self.state, "cov", None)
    if cov is None:
      return pb.FilterCovarianceResponse(dim=0)
    c = cov.cpu().numpy()
    return pb.FilterCovarianceResponse(covariance=c.ravel().tolist(),
                                       dim=c.shape[0])

  def Noise(self, req: pb.FilterNoiseRequest, ctx):
    """Sets the process and sensor noise diagonals where given (a filter
    with none keeps none), and reads them back."""
    kw = {}
    if req.process:
      kw["noise_process"] = self._tensor(req.process)
    if req.sensor:
      kw["noise_sensor"] = self._tensor(req.sensor)
    if kw and hasattr(self.state, "noise_process"):
      self.state = self.state.replace(**kw)
    empty = torch.zeros(0)
    return pb.FilterNoiseResponse(
        process=getattr(self.state, "noise_process", empty).cpu().numpy()
        .tolist(),
        sensor=getattr(self.state, "noise_sensor", empty).cpu().numpy()
        .tolist())


RPCS = [
    ("Init", pb.FilterInitRequest, pb.FilterInitResponse),
    ("Reset", pb.FilterResetRequest, pb.FilterResetResponse),
    ("Update", pb.FilterUpdateRequest, pb.FilterUpdateResponse),
    ("State", pb.FilterStateRequest, pb.FilterStateResponse),
    ("Covariance", pb.FilterCovarianceRequest, pb.FilterCovarianceResponse),
    ("Noise", pb.FilterNoiseRequest, pb.FilterNoiseResponse),
]


def make_server(port: int = 0, max_workers: int = 4,
                device=devices.DEFAULT,
                servicer: Optional[FilterServicer] = None):
  """Build and start the estimation server; (server, bound port)."""
  return serve(_SERVICE, servicer or FilterServicer(device), RPCS, port,
               max_workers)


class FilterClient:
  """The reference's python/mujoco_mpc/filter.py surface, against a
  server on `port`, or an in-process one on `device` if none is given."""

  def __init__(self, task_id: str, filter: str = "kalman",
               port: Optional[int] = None, device=devices.DEFAULT):
    self._server = None
    if port is None:
      self._server, port = make_server(0, device=device)
    self._channel = grpc.insecure_channel(f"localhost:{port}")
    grpc.channel_ready_future(self._channel).result(timeout=60)
    self._rpcs = connect(self._channel, _SERVICE, RPCS)
    self._rpcs["Init"](pb.FilterInitRequest(task_id=task_id, filter=filter),
                       timeout=300)

  def update(self, ctrl, sensor):
    self._rpcs["Update"](pb.FilterUpdateRequest(
        ctrl=np.asarray(ctrl).tolist(), sensor=np.asarray(sensor).tolist()))

  def state(self) -> dict:
    r = self._rpcs["State"](pb.FilterStateRequest())
    return {"qpos": np.asarray(r.qpos), "qvel": np.asarray(r.qvel),
            "act": np.asarray(r.act), "time": r.time}

  def covariance(self) -> np.ndarray:
    r = self._rpcs["Covariance"](pb.FilterCovarianceRequest())
    return np.asarray(r.covariance).reshape(r.dim, r.dim)

  def noise(self, process=None, sensor=None) -> dict:
    r = self._rpcs["Noise"](pb.FilterNoiseRequest(
        process=list(process) if process is not None else [],
        sensor=list(sensor) if sensor is not None else []))
    return {"process": np.asarray(r.process), "sensor": np.asarray(r.sensor)}

  def reset(self):
    self._rpcs["Reset"](pb.FilterResetRequest())

  def close(self):
    self._channel.close()
    if self._server is not None:
      self._server.stop(None)

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()
