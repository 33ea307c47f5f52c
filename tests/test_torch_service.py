"""The port's gRPC services on the CPU.

The JAX package's own AgentClient (mujoco_mpc_tpu/service/client.py, given
a port) drives the port's agent server in this process: the wire is the
same (the copied agent.proto and generated module, the same service
name). Every response is held against a twin of the server's Agent, made
with the same arguments and Init's warm-up, driven directly through the
same calls: equal to the bit (the wire carries doubles of the port's
float32 values). The port's own AgentClient spawns its server as a
subprocess on the CPU. The estimation and direct services' responses equal
the port's Kalman and Direct called directly on the same inputs (the JAX
package's two failing service tests are no yardstick: ROADMAP queue 3).
Planning runs on one PyTorch thread; each in-process server has one worker
thread."""

import sys

import grpc
import numpy as np
import pytest
import torch

from mujoco_mpc_torch.agent.agent import Agent
from mujoco_mpc_torch.estimators import base as est_base
from mujoco_mpc_torch.estimators import get_estimator
from mujoco_mpc_torch.estimators.direct import Direct, DirectConfig
from mujoco_mpc_torch.physics import io as tio
from mujoco_mpc_torch.physics import step as tstep
from mujoco_mpc_torch.service import agent_service
from mujoco_mpc_torch.service import client as tclient
from mujoco_mpc_torch.service.direct_service import DirectClient
from mujoco_mpc_torch.service.filter_service import FilterClient
from mujoco_mpc_torch.tasks import registry as treg
from mujoco_mpc_tpu.service import client as jclient
from tests.torch_cases import one_torch_thread
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

H = 8  # planning horizon (steps)


def _twin(task):
  """An Agent as the server's Init makes it, warm-up included."""
  a = Agent(task, planner="sampling", horizon_steps=H, device="cpu")
  a.planner_step()
  a.step()
  a.total_cost()
  a.reset()
  return a


def _same_state(got, agent):
  want = agent.get_state()
  for k in ("qpos", "qvel", "act", "userdata"):
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
  assert got["time"] == want["time"]


@one_torch_thread()
def test_jax_client_drives_port_server(monkeypatch):
  """Init, SetState, GetState, PlannerStep, GetAction (plain, nominal,
  averaged over a window), Step, the mode RPCs, SetAnything, the task
  parameters, cost weights and terms, residuals and GetBestTrajectory,
  each equal to the twin's; Init with model_xml is refused where `mujoco`
  does not import (tests/test_torch_agent_xml.py: where it does)."""
  servicer = agent_service.AgentServicer(device="cpu")
  server, port = agent_service.make_server(0, max_workers=1,
                                           servicer=servicer)
  try:
    c = jclient.AgentClient("Particle", planner="sampling",
                            horizon_steps=H, port=port)
    twin = _twin("Particle")
    assert c.get_all_modes() == list(twin.mode_names)
    c.set_state(qpos=[0.2, -0.1], qvel=[0.05, 0.0], time=0.1)
    twin.set_state(qpos=[0.2, -0.1], qvel=[0.05, 0.0], time=0.1)
    _same_state(c.get_state(), twin)
    for _ in range(2):
      assert c.planner_step() == float(twin.planner_step().best_return)
      np.testing.assert_array_equal(c.get_action(), twin.action())
      np.testing.assert_array_equal(c.get_action(nominal_action=True),
                                    twin.action(nominal=True))
      st = c.step()
      twin.step()
      np.testing.assert_array_equal(st["qpos"], twin.get_state()["qpos"])
    best = c.get_best_trajectory()
    info = twin.last_info
    assert best["best_return"] == float(info.best_return)
    assert best["winner"] == int(info.winner)
    np.testing.assert_array_equal(best["candidate_returns"],
                                  info.costs.numpy())
    # the averaged action rolls the physics over the window, then puts the
    # state back
    u_avg = c.get_action(averaging_duration=0.05)
    _same_state(c.get_state(), twin)
    m, saved, acts = twin.sim_task.model, twin.data, []
    for _ in range(round(0.05 / float(m.opt.timestep))):
      acts.append(twin.action())
      twin.data = tstep.step(m, twin.data.replace(
          ctrl=torch.as_tensor(acts[-1])))
    twin.data = saved
    np.testing.assert_array_equal(u_avg, np.mean(acts, axis=0))
    mode = twin.mode_names[-1]
    c.set_mode(mode)
    twin.set_mode(mode)
    assert c.get_mode() == twin.get_mode() == mode
    name = twin.task.spec.names[1]
    c.set_anything(qpos=[0.1, 0.1], cost_weights={name: 0.25},
                   mode=mode, ctrl=[0.3, -0.2])
    twin.set_state(qpos=[0.1, 0.1])
    twin.set_cost_weights({name: 0.25})
    twin.set_mode(mode)
    twin.data = twin.data.replace(ctrl=torch.tensor([0.3, -0.2]))
    _same_state(c.get_state(), twin)
    terms = c.get_cost_term_values()
    assert terms == {k: float(v) for k, v in twin.cost_terms().items()}
    assert c.get_total_cost() == twin.total_cost()
    r = twin.task.residual(twin.task.model, twin._forward(),
                           twin.task.params.residual_params)
    np.testing.assert_array_equal(c.get_residuals(), r.numpy())
    params = c.get_task_parameters()
    assert list(params) == list(twin.task.param_names)
    c.close()
    monkeypatch.setitem(sys.modules, "mujoco", None)  # import fails
    with pytest.raises(grpc.RpcError) as err:
      jclient.AgentClient("Particle", port=port, model_xml="<mujoco/>")
    assert err.value.code() == grpc.StatusCode.UNIMPLEMENTED
    assert "snapshot" in err.value.details()
  finally:
    server.stop(None)


@one_torch_thread()
def test_port_client_spawns_server():
  """The port's AgentClient starts `python -m
  mujoco_mpc_torch.service.agent_service --device=cpu` and plans over it;
  start and stop planning with steps between."""
  with tclient.AgentClient("Particle", horizon_steps=H,
                           device="cpu") as c:
    c.set_state(qpos=[0.25, 0.0])
    assert np.isfinite(c.planner_step())
    assert c.get_action().shape == (2,)
    c.start_planning()
    t0 = c.get_state()["time"]
    for _ in range(3):
      c.step()
    c.stop_planning()
    assert c.get_state()["time"] > t0


@one_torch_thread()
def test_filter_service_matches_kalman():
  """Update, State, Covariance, Noise and Reset against the port's Kalman
  (Cartpole, its measurement slice) on the same controls and sensors."""
  m = treg.get_task("Cartpole", device="cpu").model
  start, dim = est_base.measurement_slice(m)
  kalman = get_estimator("kalman", m, sensor_start=start, nsensordata=dim)
  state = kalman.init()
  rng = np.random.RandomState(0)
  with FilterClient("Cartpole", filter="kalman", device="cpu") as fc:
    for _ in range(4):
      u, z = rng.uniform(-1, 1, m.nu), rng.uniform(-1, 1, dim)
      fc.update(u, z)
      state = kalman.update(state, torch.as_tensor(u, dtype=m.dtype),
                            torch.as_tensor(z, dtype=m.dtype))
    st = fc.state()
    qpos, qvel, _ = kalman.state(state)
    np.testing.assert_array_equal(st["qpos"], qpos.numpy())
    np.testing.assert_array_equal(st["qvel"], qvel.numpy())
    assert st["time"] == float(state.data.time)
    np.testing.assert_array_equal(fc.covariance(), state.cov.numpy())
    noise = fc.noise(process=[2e-4] * 4, sensor=[3e-3] * dim)
    np.testing.assert_array_equal(
        noise["process"], np.float32([2e-4] * 4).astype(np.float64))
    fc.reset()
    np.testing.assert_array_equal(fc.covariance(), kalman.init().cov)


@one_torch_thread()
def test_direct_service_matches_direct():
  """Data, Settings, Optimize, Cost, Status, Noise and SensorInfo against
  the port's Direct on the same window (Cartpole, 8 configurations of a
  rollout, its measurement slice)."""
  m = treg.get_task("Cartpole", device="cpu").model
  start, dim = est_base.measurement_slice(m)
  T = 8
  d = tio.make_data(m).replace(qpos=torch.tensor([0.3, 0.2]))
  qs, zs = [], []
  for _ in range(T):
    d = tstep.step(m, d)
    qs.append(d.qpos)
    zs.append(tstep.forward(m, d).sensordata[start:start + dim])
  rng = np.random.RandomState(1)
  qpos = torch.stack(qs) + torch.as_tensor(
      rng.normal(0, 0.01, (T, m.nq)), dtype=m.dtype)
  sensors, ctrls = torch.stack(zs), torch.zeros((T, m.nu))
  direct = Direct(m, DirectConfig(horizon=T, max_iterations=2),
                  sensor_start=start, nsensordata=dim)
  with DirectClient("Cartpole", horizon=T, device="cpu") as dc:
    assert dc.status() == {"horizon": T, "optimized": False}
    assert dc.sensor_info() == {"start_index": start,
                                "num_measurements": dim,
                                "dim_measurements": dim}
    for t in range(T):
      got = dc.data(t, qpos=qpos[t].numpy(), sensor=sensors[t].numpy(),
                    ctrl=ctrls[t].numpy())
      np.testing.assert_array_equal(got, qpos[t].numpy())
    dc.settings(max_iterations=2)
    res = dc.optimize()
    want = direct.optimize(qpos, sensors, ctrls)
    assert res == {"cost_initial": float(want.cost_initial),
                   "cost_final": float(want.cost),
                   "iterations": want.iterations}
    assert dc.status()["optimized"]
    assert dc.cost() == float(direct._total_cost(
        want.qpos, direct.default_parameters(), sensors, ctrls))
    noise = dc.noise(process=[2.0] * m.nv, sensor=[0.5] * dim)
    np.testing.assert_array_equal(noise["process"], [2.0] * m.nv)
    np.testing.assert_array_equal(noise["sensor"], [0.5] * dim)
    direct.config = DirectConfig(horizon=T, max_iterations=2,
                                 force_weight=torch.full((m.nv,), 2.0))
    direct.set_sensor_weights(torch.full((dim,), 0.5))
    assert dc.cost() == float(direct._total_cost(
        want.qpos, direct.default_parameters(), sensors, ctrls))
