"""The port's edges on the CPU: the CLI, testspeed, drive, checkpoint,
profiling and the trace tools.

The CLI lists exactly the JAX package's tasks and planners; testspeed and
drive equal the port's Agent driven by hand at the same cadence, to the
bit (the Agent itself was held against JAX by the planner and step
tests); a checkpoint round trip is bitwise, the next plan included; the
phase timer reports JAX's keys, and a trace is written with JAX's keys and
rendered by both packages' plot_trace. Planning runs on one PyTorch
thread on Particle (64 x 50, or a horizon of 10 where the tool takes
one)."""

import ast
import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from mujoco_mpc_torch import __main__ as cli
from mujoco_mpc_torch.agent import agent as tagent
from mujoco_mpc_torch.tasks import registry as treg
from mujoco_mpc_torch.tools import drive as tdrive
from mujoco_mpc_torch.tools import plots as tplots
from mujoco_mpc_torch.tools import testspeed as ttestspeed
from mujoco_mpc_torch.tools import trace as ttrace
from mujoco_mpc_torch.utils import checkpoint as tckpt
from mujoco_mpc_torch.utils import profiling as tprof
from tests.torch_cases import one_torch_thread
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _printed(fn, *args, **kwargs):
  """(fn's result, its standard output)."""
  buf = io.StringIO()
  with contextlib.redirect_stdout(buf):
    out = fn(*args, **kwargs)
  return out, buf.getvalue()


@one_torch_thread()
def test_cli_lists_jax_tasks_and_planners():
  """--list names JAX's 26 tasks and 7 planners; a planner added by
  register_planner is listed and built by Agent(planner=name); a short run
  on the CPU prints testspeed's two lines; the default device raises on a
  host without a card."""
  from mujoco_mpc_tpu.agent import agent as jagent
  from mujoco_mpc_tpu.tasks import registry as jreg

  _, out = _printed(cli.main, ["--list"])
  lines = dict(line.split(": ", 1) for line in out.strip().splitlines())
  assert lines["tasks"].split(", ") == list(jreg.task_names())
  assert len(jreg.task_names()) == 26
  assert lines["planners"].split(", ") == sorted(jagent._PLANNERS)
  assert len(jagent._PLANNERS) == 7

  made = []

  def factory(task, horizon):
    made.append(horizon)
    return tagent._PLANNERS["sampling"](task, horizon)

  tagent.register_planner("my_sampling", factory)
  try:
    _, out = _printed(cli.main, ["--list"])
    assert "my_sampling" in out.splitlines()[1]
    a = tagent.Agent("Particle", planner="my_sampling", horizon_steps=7,
                     device="cpu")
    assert made == [7] and a.planner_name == "my_sampling"
  finally:
    del tagent._PLANNERS["my_sampling"]

  rc, out = _printed(cli.main, ["--task", "Particle", "--time", "0.05",
                                "--plan_every", "5", "--device", "cpu"])
  assert rc == 0
  assert out.startswith("Total time-accumulated cost: ")
  assert "(1 planning steps)" in out and "x realtime)" in out
  with pytest.raises(RuntimeError, match="is_available"):
    cli.main(["--task", "Particle", "--time", "0.05"])


def _hand_driven(agent, nsteps, plan_every):
  """testspeed's loop, written out: (total cost, plans)."""
  dt = float(agent.sim_task.model.opt.timestep)
  total, plans = 0.0, 0
  for i in range(nsteps):
    if i % plan_every == 0:
      agent.planner_step()
      plans += 1
    agent.step()
    total += agent.total_cost() * dt
  return total, plans


@one_torch_thread()
def test_testspeed_equals_hand_driven_agent():
  out, printed = _printed(ttestspeed.synchronous_planning_cost, "Particle",
                          "sampling", total_time=0.02, plan_every=2,
                          device="cpu")
  # JAX's keys (mujoco_mpc_tpu/tools/testspeed.py:58-66)
  assert set(out) == {"task", "planner", "total_cost", "wall_s", "sim_s",
                      "realtime_factor", "planning_steps"}
  assert len(printed.strip().splitlines()) == 2
  a = tagent.Agent("Particle", planner="sampling", device="cpu")
  a.reset()
  a.planner_step()  # testspeed's warm-up, then its reset
  a.step()
  a.reset()
  total, plans = _hand_driven(a, 2, 2)
  assert out["total_cost"] == total
  assert out["planning_steps"] == plans == 1


def _json_keys_of(path: str) -> set:
  """The string keys of the dict literal passed to json.dumps in a
  module's source."""
  tree = ast.parse(open(path).read())
  for node in ast.walk(tree):
    if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
        == "dumps" and node.args and isinstance(node.args[0], ast.Dict)):
      return {k.value for k in node.args[0].keys}
  raise AssertionError(f"no json.dumps of a dict literal in {path}")


@one_torch_thread()
def test_drive_equals_hand_driven_agent():
  out, printed = _printed(tdrive.main, [
      "--task", "Particle", "--steps", "4", "--plan_every", "2",
      "--horizon", "10", "--device", "cpu"])
  assert json.loads(printed) == json.loads(json.dumps(out))
  assert set(out) == _json_keys_of(
      os.path.join(REPO, "mujoco_mpc_tpu", "tools", "drive.py"))
  a = tagent.Agent("Particle", planner="sampling", horizon_steps=10,
                   device="cpu")
  a.reset()
  start = tdrive.root_position(a)
  for _ in range(2):
    a.planner_step()
    a.steps(2)
  delta = tdrive.root_position(a) - start
  assert out["displacement"] == [round(float(x), 4) for x in delta]
  assert out["final_cost"] == a.total_cost()
  assert out["sim_time"] == float(a.data.time)


def _agent(task="Particle", planner="sampling"):
  return tagent.Agent(task, planner=planner, horizon_steps=10, device="cpu")


@one_torch_thread()
def test_checkpoint_round_trip_is_bitwise(tmp_path):
  """Save after a plan and a noisy step, restore into a fresh Agent: every
  leaf, the generator and the control noise bitwise, then the next plan
  and step equal; a Cartpole/iLQG agent refuses the file."""
  a = _agent()
  a.reset()
  a.set_cost_weights({"Velocity": 0.3})
  a.planner_step()
  a.step(ctrl_noise_std=0.1)
  path = tckpt.save(str(tmp_path / "particle.pt"), a)
  b = _agent()
  tckpt.restore(path, b)
  for what in ("policy", "previous_policy", "data"):
    want, got = (tckpt._leaves(getattr(x, what)) for x in (a, b))
    assert set(want) == set(got)
    for k in want:
      assert torch.equal(want[k], got[k]), (what, k)
  assert torch.equal(a.task.params.weights, b.task.params.weights)
  assert torch.equal(a.generator.get_state(), b.generator.get_state())
  assert torch.equal(a._ou_noise, b._ou_noise)
  for x in (a, b):
    x.planner_step()
    x.step(ctrl_noise_std=0.1)
  for k, v in tckpt._leaves(a.policy).items():
    assert torch.equal(v, tckpt._leaves(b.policy)[k]), k
  assert torch.equal(a.data.qpos, b.data.qpos)
  assert torch.equal(a.last_info.costs, b.last_info.costs)
  with pytest.raises(ValueError, match="leaves"):
    tckpt.restore(path, _agent("Cartpole", "ilqg"))


def test_phase_timer_and_device_trace(tmp_path):
  from mujoco_mpc_tpu.utils import profiling as jprof

  jt, tt = jprof.PhaseTimer(), tprof.PhaseTimer()
  with jt.phase("plan"):
    pass
  with tt.phase("plan", sync="cpu"):
    torch.ones(8).sum()
  with tt.phase("plan"):
    pass
  rep, want = tt.report(), jt.report()
  assert set(rep) == set(want) == {"plan"}
  assert set(rep["plan"]) == set(want["plan"])
  assert rep["plan"]["count"] == 2 and rep["plan"]["mean_ms"] >= 0
  with tprof.device_trace(str(tmp_path), device="cpu"):
    with tt.phase("edge_phase", sync="cpu"):
      torch.ones(64, 64) @ torch.ones(64, 64)
  trace = json.load(open(tmp_path / tprof.TRACE_FILE))
  names = {e.get("name") for e in trace["traceEvents"]}
  assert "edge_phase" in names
  with pytest.raises(RuntimeError, match="is_available"):
    with tprof.device_trace(str(tmp_path)):
      pass


class _JaxView:
  """The port's Agent as JAX's TraceRecorder reads an agent (its data's
  ctrl as numpy)."""

  def __init__(self, agent):
    self._a = agent
    self.task, self.planner_name = agent.task, agent.planner_name
    self.get_state, self.total_cost = agent.get_state, agent.total_cost
    self.cost_terms = agent.cost_terms

  @property
  def last_info(self):
    return self._a.last_info

  @property
  def data(self):
    return dataclasses.replace(self._a.data,
                               ctrl=self._a.data.ctrl.cpu().numpy())


@one_torch_thread()
def test_trace_has_jax_keys_and_both_plot_trace_render_it(tmp_path):
  """TraceRecorder over 4 steps writes JAX's keys, meta and values (JAX's
  recorder over the same agent), JAX's and the port's plot_trace render
  it, and the replay example summarizes it."""
  from mujoco_mpc_torch.examples import replay as treplay
  from mujoco_mpc_tpu.tools import plots as jplots
  from mujoco_mpc_tpu.tools import trace as jtrace

  a = _agent()
  a.reset()
  rec, jrec = ttrace.TraceRecorder(a), jtrace.TraceRecorder(_JaxView(a))
  for i in range(4):
    if i % 2 == 0:
      a.planner_step()
    a.step()
    rec.record()
    jrec.record()
  got = np.load(rec.save(str(tmp_path / "port")))
  want = np.load(jrec.save(str(tmp_path / "jax")))
  assert set(got.files) == set(want.files)
  for k in want.files:
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
  meta = json.loads(str(got["meta"]))
  assert meta == {"task": "Particle", "planner": "sampling",
                  "term_names": list(treg.get_task(
                      "Particle", device="cpu").spec.names)}
  for plot, name in ((jplots.plot_trace, "jax.png"),
                     (tplots.plot_trace, "port.png")):
    out = plot(str(tmp_path / "port.npz"), str(tmp_path / name),
               timer={"plan": 0.004})
    assert os.path.getsize(out) > 1000
  _, printed = _printed(treplay.main, [str(tmp_path / "port.npz"),
                                       "--summary"])
  assert "trace: 4 frames" in printed and "task=Particle" in printed
