"""Candidate rollouts split over devices: the sharded sampling, CEM and
robust planners.

Counterpart of mujoco_mpc_tpu/parallel/mesh.py, whose planners run the
candidate axis under shard_map over a mesh of TPU chips (the reference's
fan-out is a thread pool, mjpc/threadpool.h:32). Here a Mesh is an ordered
tuple of torch devices, one per shard. A device may repeat, and its shards
then share it: a host with one card splits its candidates into launches
that overlap on CUDA streams of their own, and the tests mirror JAX's
8-device CPU mesh with Mesh((cpu,) * 8).

The candidates come from the unsharded planner's own generation on the
mesh's first device, so the draws are the same. Their actions (N, T, nu)
are split into len(mesh) contiguous shards. Each shard is scored on its
device by that device's MegaRollout: one launch of csrc/megarollout.cu a
shard on a card, the plain version on the CPU. On the general route (a
task with no CUDA residual, or use_megakernel=False) each shard runs the
general batched rollout on its device instead. The returns are gathered in
order on the first device, where the inherited optimize keeps the winner's
argmin and CEM's elite refit. The robust planner splits its
(ncandidates x nrepetitions) grid of disturbed re-scorings over
candidates, each shard drawing from a generator of its own.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.ops import megarollout
from mujoco_mpc_torch.physics.types import Data
from mujoco_mpc_torch.planners import robust, sampling
from mujoco_mpc_torch.planners.cross_entropy import CrossEntropyPlanner
from mujoco_mpc_torch.tasks.base import Task, TaskParams

AXIS = "candidates"


class Mesh:
  """An ordered tuple of devices, one per shard of the candidates axis.
  A device may repeat: its shards then share it."""

  def __init__(self, devs):
    self.devices: Tuple[torch.device, ...] = tuple(
        devices.resolve(d) for d in devs)
    if not self.devices:
      raise ValueError("a Mesh needs at least one device")

  def __len__(self) -> int:
    return len(self.devices)

  @property
  def distinct(self) -> Tuple[torch.device, ...]:
    """The mesh's devices, each once, in order."""
    return tuple(dict.fromkeys(self.devices))

  def __repr__(self) -> str:
    return f"Mesh({', '.join(str(d) for d in self.devices)})"


def make_mesh(n_devices: Optional[int] = None,
              device=devices.DEFAULT) -> Mesh:
  """The first n_devices CUDA devices (all of them when None); raises
  where there is no card or fewer than asked. With device="cpu",
  n_devices shards (default 1) of the CPU."""
  dev = devices.resolve(device)
  if dev.type != "cuda":
    return Mesh((dev,) * (n_devices or 1))
  count = torch.cuda.device_count()
  n = count if n_devices is None else n_devices
  if not 1 <= n <= count:
    raise ValueError(f"make_mesh({n_devices}): this host has {count} CUDA "
                     "devices")
  return Mesh(torch.device("cuda", i) for i in range(n))


def _check_divisible(n: int, mesh: Mesh, what: str):
  if n % len(mesh):
    raise ValueError(
        f"{what}={n} must be divisible by mesh size {len(mesh)}")


def _stream(stream):
  return (torch.cuda.stream(stream) if stream is not None
          else contextlib.nullcontext())


def _sharded_returns(planner, mesh: Mesh, task: Task, cfg, data: Data,
                     new_times: torch.Tensor, cands: torch.Tensor,
                     params: Optional[TaskParams]) -> torch.Tensor:
  """Candidate returns (N,) with the candidates axis split over `mesh`,
  gathered in order on the first device. On the kernel route each shard
  is one MegaRollout.returns call on its device, on its own stream, which
  waits for the first device's stream before it starts and which the
  first device's stream waits for before the gather."""
  per = cands.shape[0] // len(mesh)
  p = params if params is not None else task.params
  home = cands.device
  if planner.mega is None:
    return torch.cat([
        sampling.general_returns(
            task.to(dev), data.to(dev), new_times.to(dev), shard.to(dev),
            cfg.horizon, cfg.interp, p.to(device=dev)).to(home)
        for dev, shard in zip(mesh.devices, cands.split(per))])
  actions = sampling.candidate_actions(task, data, new_times, cands,
                                       cfg.horizon, cfg.interp)
  home_stream = (torch.cuda.current_stream(home) if home.type == "cuda"
                 else None)
  outs = []
  for dev, stream, acts in zip(mesh.devices, planner.streams,
                               actions.split(per)):
    with _stream(stream):
      if stream is not None:
        stream.wait_stream(home_stream)
      r = planner.megas[dev].returns(
          data.qpos.to(dev), data.qvel.to(dev), acts.to(dev),
          p.to(device=dev), data.time.to(dev),
          mocap_pos=data.mocap_pos.to(dev),
          mocap_quat=data.mocap_quat.to(dev),
          userdata=data.userdata.to(dev))
      outs.append(r.to(home))
  for stream, r in zip(planner.streams, outs):
    if stream is not None:
      home_stream.wait_stream(stream)
      r.record_stream(home_stream)
  return torch.cat(outs)


class _ShardedScoring:
  """What the sharded sampling and CEM planners add to the planner they
  derive from: the mesh (num_trajectories must divide by its size), each
  device's MegaRollout in `megas` (empty on the general route; their
  launches sum to the shard count a plan), a stream a shard on a card,
  and _returns through _sharded_returns."""

  def __init__(self, config, mesh: Mesh, use_megakernel: bool = True):
    super().__init__(config, use_megakernel=use_megakernel)
    self.mesh = mesh
    _check_divisible(config.num_trajectories, mesh, "num_trajectories")
    self.megas = {}
    self.streams = None

  def init(self, task: Task):
    """The planner's init on the mesh's first device; on the first call
    also the MegaRollout of each of the mesh's devices (the planner's own
    on the first), built from the task moved there, and a CUDA stream for
    each shard on a card."""
    home = self.mesh.devices[0]
    if task.model.device != home:
      raise ValueError(f"the task is on {task.model.device}; the mesh's "
                       f"first device is {home}")
    policy = super().init(task)
    if self.mega is not None and not self.megas:
      self.megas = {
          d: self.mega if d == home else megarollout.MegaRollout(
              task.to(d), self.config.horizon, device=d)
          for d in self.mesh.distinct}
    if self.streams is None:
      self.streams = tuple(
          torch.cuda.Stream(device=d) if d.type == "cuda" else None
          for d in self.mesh.devices)
    return policy

  def _returns(self, task: Task, data: Data, new_times: torch.Tensor,
               cands: torch.Tensor,
               params: Optional[TaskParams]) -> torch.Tensor:
    return _sharded_returns(self, self.mesh, task, self.config, data,
                            new_times, cands, params)


class ShardedSamplingPlanner(_ShardedScoring, sampling.SamplingPlanner):
  """Predictive sampling with the candidates axis split over a mesh: the
  SamplingPlanner's noise model and winner; only the placement differs."""


class ShardedCrossEntropyPlanner(_ShardedScoring, CrossEntropyPlanner):
  """CEM with the candidates axis split over a mesh; the elite top-k and
  the mean and std refit stay in the inherited optimize, on the gathered
  returns (reference cross_entropy/planner.cc:168-260)."""


class ShardedRobustPlanner(robust.RobustPlanner):
  """Robust re-scoring with the candidates axis of the (ncandidates x
  nrepetitions) grid split over a mesh (reference
  robust/robust_planner.cc:91): the delegate's candidates are scored on
  the first device, the disturbed re-scorings shard by shard on the
  general route. Each shard draws from a generator on its device, seeded
  from one draw of the caller's generator and the shard's index; eps
  (T, ncandidates, nrepetitions, nbody, 6), shard after shard along the
  candidates axis, replaces those draws."""

  def __init__(self, delegate: sampling.SamplingPlanner,
               config: robust.RobustConfig, mesh: Mesh):
    super().__init__(delegate, config)
    self.mesh = mesh
    _check_divisible(config.ncandidates, mesh, "ncandidates")

  def _scores(self, task: Task, data: Data, times: torch.Tensor,
              top: torch.Tensor, generator: Optional[torch.Generator],
              params: Optional[TaskParams],
              eps: Optional[torch.Tensor]) -> torch.Tensor:
    per = top.shape[0] // len(self.mesh)
    home = top.device
    if eps is None:
      seed = int(torch.randint(
          0, 2 ** 62, (), generator=generator,
          device=generator.device if generator is not None else "cpu"))
    scores = []
    for i, (dev, shard) in enumerate(zip(self.mesh.devices,
                                         top.split(per))):
      if eps is None:
        gen, e = torch.Generator(device=dev).manual_seed(seed + i), None
      else:
        gen, e = None, eps[:, i * per:(i + 1) * per].to(dev)
      scores.append(super()._scores(
          task.to(dev), data.to(dev), times.to(dev), shard.to(dev), gen,
          params.to(device=dev) if params is not None else None, e).to(home))
    return torch.cat(scores)
