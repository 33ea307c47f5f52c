"""gRPC Direct-optimizer service and client over the port's Direct.

Counterpart of mujoco_mpc_tpu/service/direct_service.py (reference
direct_service.cc, python/mujoco_mpc/direct.py), on its wire (direct.proto
and its generated module, copied; service "mjpc_tpu.Direct"). Init builds
a registered task's Direct over a window of `horizon` configurations
measuring estimators.base.measurement_slice, on the server's device; Data
fills one time step of the window (configuration, measurement, control),
Optimize smooths it, Cost, Status, Noise and SensorInfo read it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import grpc
import numpy as np
import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.service import direct_pb2 as pb
from mujoco_mpc_torch.service.agent_service import connect, serve

_SERVICE = "mjpc_tpu.Direct"


class DirectServicer:
  def __init__(self, device=devices.DEFAULT):
    self.device = device
    self.direct = None
    self.task = None
    self.qpos = self.sensors = self.ctrls = None
    self.optimized = False

  def Init(self, req: pb.DirectInitRequest, ctx):
    from mujoco_mpc_torch.estimators import base as est_base
    from mujoco_mpc_torch.estimators.direct import Direct, DirectConfig
    from mujoco_mpc_torch.physics import io as phys_io
    from mujoco_mpc_torch.tasks import registry

    self.task = registry.get_task(req.task_id, device=self.device)
    m = self.task.model
    horizon = req.horizon or 16
    start, dim = est_base.measurement_slice(m)
    self.direct = Direct(m, DirectConfig(horizon=horizon),
                         sensor_start=start, nsensordata=dim)
    kw = {"dtype": m.dtype, "device": m.device}
    self.qpos = phys_io.make_data(m).qpos.repeat(horizon, 1)
    self.sensors = torch.zeros((horizon, self.direct.ns), **kw)
    self.ctrls = torch.zeros((horizon, m.nu), **kw)
    self.optimized = False
    return pb.DirectInitResponse()

  def _tensor(self, values):
    m = self.task.model
    return torch.as_tensor(np.asarray(list(values)), dtype=m.dtype,
                           device=m.device)

  def Data(self, req: pb.DirectDataRequest, ctx):
    i = req.index
    for field, values in (("qpos", req.qpos), ("sensors", req.sensor),
                          ("ctrls", req.ctrl)):
      if values:
        rows = getattr(self, field).clone()
        rows[i] = self._tensor(values)
        setattr(self, field, rows)
    return pb.DirectDataResponse(qpos=self.qpos[i].cpu().numpy().tolist())

  def Settings(self, req: pb.DirectSettingsRequest, ctx):
    changes = {}
    if req.max_iterations > 0:
      changes["max_iterations"] = req.max_iterations
    if req.sensor_weight > 0:
      changes["sensor_weight"] = req.sensor_weight
    if req.force_weight > 0:
      changes["force_weight"] = req.force_weight
    if changes:
      self.direct.config = dataclasses.replace(self.direct.config, **changes)
    return pb.DirectSettingsResponse()

  def Optimize(self, req, ctx):
    result = self.direct.optimize(self.qpos, self.sensors, self.ctrls)
    self.qpos = result.qpos
    self.optimized = True
    return pb.DirectOptimizeResponse(cost_initial=float(result.cost_initial),
                                     cost_final=float(result.cost),
                                     iterations=int(result.iterations))

  def Cost(self, req, ctx):
    d = self.direct
    return pb.DirectCostResponse(cost=float(d._total_cost(
        self.qpos, d.default_parameters(), self.sensors, self.ctrls)))

  def Status(self, req, ctx):
    return pb.DirectStatusResponse(horizon=self.direct.config.horizon,
                                   optimized=self.optimized)

  def Noise(self, req: pb.DirectNoiseRequest, ctx):
    """Gets and sets the process (per-dof force), sensor and
    parameter-prior weights (reference direct.proto Noise; direct.h
    noise_process, noise_sensor); empty fields read back the current
    values."""
    d = self.direct
    if req.process:
      d.config = dataclasses.replace(d.config,
                                     force_weight=self._tensor(req.process))
    if req.sensor:
      d.set_sensor_weights(self._tensor(req.sensor))
    if req.parameter and d.ntheta:
      # the prior weights live on the parameter blocks (reference
      # model_parameters.h): each block takes its slice's mean
      pw, off, specs = list(req.parameter), 0, []
      for spec in d.parameters:
        w = pw[off:off + spec.dim]
        specs.append(dataclasses.replace(
            spec, prior_weight=float(np.mean(w)) if w else
            spec.prior_weight))
        off += spec.dim
      d.parameters = tuple(specs)
    fw = np.asarray(torch.as_tensor(d.config.force_weight).cpu(),
                    np.float64).ravel()
    if fw.size == 1:
      fw = np.full((int(self.task.model.nv),), fw[0])
    resp = pb.DirectNoiseResponse(
        process=fw.tolist(),
        sensor=d.sensor_weights.cpu().numpy().astype(np.float64).tolist())
    for spec in d.parameters:
      resp.parameter.extend([float(spec.prior_weight)] * spec.dim)
    return resp

  def SensorInfo(self, req, ctx):
    """The measurement layout (reference direct.proto SensorInfo)."""
    d = self.direct
    return pb.DirectSensorInfoResponse(start_index=int(d.sensor_start),
                                       num_measurements=int(d.ns),
                                       dim_measurements=int(d.ns))


RPCS = [
    ("Init", pb.DirectInitRequest, pb.DirectInitResponse),
    ("Data", pb.DirectDataRequest, pb.DirectDataResponse),
    ("Settings", pb.DirectSettingsRequest, pb.DirectSettingsResponse),
    ("Optimize", pb.DirectOptimizeRequest, pb.DirectOptimizeResponse),
    ("Cost", pb.DirectCostRequest, pb.DirectCostResponse),
    ("Status", pb.DirectStatusRequest, pb.DirectStatusResponse),
    ("Noise", pb.DirectNoiseRequest, pb.DirectNoiseResponse),
    ("SensorInfo", pb.DirectSensorInfoRequest, pb.DirectSensorInfoResponse),
]


def make_server(port: int = 0, max_workers: int = 4,
                device=devices.DEFAULT,
                servicer: Optional[DirectServicer] = None):
  """Build and start the direct server; (server, bound port)."""
  return serve(_SERVICE, servicer or DirectServicer(device), RPCS, port,
               max_workers)


class DirectClient:
  """The reference's python/mujoco_mpc/direct.py surface, against a
  server on `port`, or an in-process one on `device` if none is given."""

  def __init__(self, task_id: str, horizon: int = 16,
               port: Optional[int] = None, device=devices.DEFAULT):
    self._server = None
    if port is None:
      self._server, port = make_server(0, device=device)
    self._channel = grpc.insecure_channel(f"localhost:{port}")
    grpc.channel_ready_future(self._channel).result(timeout=60)
    self._rpcs = connect(self._channel, _SERVICE, RPCS)
    self._rpcs["Init"](pb.DirectInitRequest(task_id=task_id,
                                            horizon=horizon), timeout=300)

  def data(self, index: int, qpos=None, sensor=None, ctrl=None):
    req = pb.DirectDataRequest(index=index)
    for field, val in (("qpos", qpos), ("sensor", sensor), ("ctrl", ctrl)):
      if val is not None:
        getattr(req, field).extend(np.asarray(val).tolist())
    return np.asarray(self._rpcs["Data"](req).qpos)

  def settings(self, max_iterations=0, sensor_weight=0.0, force_weight=0.0):
    self._rpcs["Settings"](pb.DirectSettingsRequest(
        max_iterations=max_iterations, sensor_weight=sensor_weight,
        force_weight=force_weight))

  def optimize(self) -> dict:
    r = self._rpcs["Optimize"](pb.DirectOptimizeRequest(), timeout=600)
    return {"cost_initial": r.cost_initial, "cost_final": r.cost_final,
            "iterations": r.iterations}

  def cost(self) -> float:
    return self._rpcs["Cost"](pb.DirectCostRequest()).cost

  def status(self) -> dict:
    r = self._rpcs["Status"](pb.DirectStatusRequest())
    return {"horizon": r.horizon, "optimized": r.optimized}

  def noise(self, process=None, sensor=None, parameter=None) -> dict:
    req = pb.DirectNoiseRequest()
    for field, val in (("process", process), ("sensor", sensor),
                       ("parameter", parameter)):
      if val is not None:
        getattr(req, field).extend(np.asarray(val).tolist())
    r = self._rpcs["Noise"](req)
    return {"process": np.asarray(r.process),
            "sensor": np.asarray(r.sensor),
            "parameter": np.asarray(r.parameter)}

  def sensor_info(self) -> dict:
    r = self._rpcs["SensorInfo"](pb.DirectSensorInfoRequest())
    return {"start_index": r.start_index,
            "num_measurements": r.num_measurements,
            "dim_measurements": r.dim_measurements}

  def close(self):
    self._channel.close()
    if self._server is not None:
      self._server.stop(None)

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()
