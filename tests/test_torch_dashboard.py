"""The port's web dashboard (ui/server.py) and record_clip on the CPU.

JAX's dashboard request sequence (tests/test_ui.py) and a few bad
requests go to the port's AgentUI and to JAX's on Particle, without
threads: each response has the same status code and the same JSON keys.
A planner switch keeps the sim state. With the loops running, a planner
that raises is reported under /api/state's "error" and stops the loops
(JAX's plan loop swallows every exception). record_clip writes a clip the
port's Humanoid Track loads. live_view --headless writes its traces.
Planning runs on one PyTorch thread."""

import contextlib
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from mujoco_mpc_torch.agent import agent as tagent
from mujoco_mpc_torch.tasks import humanoid_track
from mujoco_mpc_torch.tools import record_clip
from mujoco_mpc_torch.ui import server as tserver
from tests.torch_cases import one_torch_thread
from tests.torch_engine_cases import release_jax_executables  # noqa: F401


def _req(port, path, body=None, raw=None):
  """(status, JSON body or the content type) of a request; HTTP errors
  are responses too."""
  url = f"http://127.0.0.1:{port}{path}"
  data = raw if raw is not None else (
      None if body is None else json.dumps(body).encode())
  req = urllib.request.Request(
      url, data=data, headers={"Content-Type": "application/json"},
      method="GET" if data is None else "POST")
  try:
    r = urllib.request.urlopen(req, timeout=30)
  except urllib.error.HTTPError as e:
    r = e
  kind = r.headers.get("Content-Type")
  payload = r.read()
  return r.status, (json.loads(payload) if kind == "application/json"
                    else kind)


@contextlib.contextmanager
def _served(ui, make_server=tserver.make_server):
  """ui's server on a free localhost port (yielded); stops both after."""
  srv = make_server(ui, port=0)
  t = threading.Thread(target=srv.serve_forever, daemon=True)
  t.start()
  try:
    yield srv.server_address[1]
  finally:
    srv.shutdown()
    srv.server_close()
    ui.stop()


def _shape(resp):
  """A response as compared: its status and its JSON keys or its content
  type."""
  code, body = resp
  return code, sorted(body) if isinstance(body, dict) else body


# JAX's tests/test_ui.py sequence (:38-109), then bad requests
_SEQUENCE = [
    ("/api/state", None, None),
    ("/api/set", {"weights": {"Position": 3.25}}, None),
    ("/api/set", {"paused": True, "speed": 2.0, "ctrl_noise": 0.1,
                  "traces": True}, None),
    ("/api/set", {"paused": False, "traces": False}, None),
    ("/api/state", None, None),
    ("/api/planner", {"planner": "cross_entropy"}, None),
    ("/api/state", None, None),
    ("/api/reset", {}, None),
    ("/api/planner", {"planner": "nope"}, None),
    ("/api/task", {"task": "nope"}, None),
    ("/api/set", {"weights": {"nope": 1.0}}, None),
    ("/api/set", {"speed": "fast"}, None),
    ("/api/set", None, b"{not json"),
    ("/api/nope", {}, None),
    ("/", None, None),
    ("/nope", None, None),
    ("/frame.jpg", None, None),
]


@one_torch_thread()
def test_dashboard_answers_as_jax_does():
  from mujoco_mpc_tpu.ui import server as jserver

  got, want = [], []
  for ui, make_server, out in (
      (tserver.AgentUI("Particle", render=False, device="cpu"),
       tserver.make_server, got),
      (jserver.AgentUI("Particle", render=False), jserver.make_server,
       want)):
    with _served(ui, make_server) as port:
      for path, body, raw in _SEQUENCE:
        out.append(_req(port, path, body, raw))
      assert ui.agent.planner_name == "cross_entropy"
  for (path, _, _), g, w in zip(_SEQUENCE, got, want):
    assert _shape(g) == _shape(w), path
  codes = [g[0] for g in got]
  assert codes == [200] * 8 + [400] * 5 + [404, 200, 404, 404]
  # the port's 404 says why there is no frame
  assert got[-1][1] == {"error": "rendering is off (render=False)"}
  # the slider reached the task (a planner switch rebuilds the Agent, with
  # the task's own weights, in both)
  assert got[4][1]["weights"]["Position"] == want[4][1]["weights"][
      "Position"] == 3.25
  st = got[0][1]
  assert st["tasks"] == want[0][1]["tasks"]
  assert st["planners"] == want[0][1]["planners"]
  assert st["weights"].keys() == want[0][1]["weights"].keys()


@one_torch_thread()
def test_planner_switch_keeps_the_state():
  ui = tserver.AgentUI("Particle", render=False, device="cpu")
  with _served(ui) as port:
    ui.agent.set_state(qpos=ui.agent.get_state()["qpos"] + 0.05,
                       qvel=[0.25, -0.5], time=0.125)
    before = ui.agent.get_state()
    assert _req(port, "/api/planner", {"planner": "cross_entropy"}) == (
        200, {"ok": True})
    after = ui.agent.get_state()
    assert ui.agent.planner_name == "cross_entropy"
    for k in ("qpos", "qvel", "time"):
      np.testing.assert_array_equal(after[k], before[k])
    code, st = _req(port, "/api/state")
    assert code == 200 and st["planner"] == "cross_entropy"
    assert st["time"] == 0.125


class _Broken(Exception):
  pass


@one_torch_thread()
def test_failing_planner_is_reported_and_stops_the_loops():
  """A registered planner whose optimize raises: with the loops on,
  /api/state reports the error and both loops end."""

  def factory(task, horizon):
    p = tagent._PLANNERS["sampling"](task, horizon)

    def optimize(*args, **kwargs):
      raise _Broken("planner exploded")

    p.optimize = optimize
    return p

  tagent.register_planner("exploding", factory)
  try:
    ui = tserver.AgentUI("Particle", planner="exploding", render=False,
                         device="cpu")
    with _served(ui) as port:
      ui.start()
      deadline = time.time() + 30
      while ui.error is None and time.time() < deadline:
        time.sleep(0.05)
      code, st = _req(port, "/api/state")
      assert code == 200
      assert st["error"] == "plan loop: _Broken: planner exploded"
      assert "_Broken" in ui.error_traceback
      for t in (ui._plan_thread, ui._phys_thread):
        t.join(timeout=30)
        assert not t.is_alive()
      assert st["planner_hz"] is None
  finally:
    del tagent._PLANNERS["exploding"]


@contextlib.contextmanager
def _short_sampling():
  """A planner "short_sampling", registered for the block: the sampling
  planner over 10 steps, so that a plan beside a physics loop on a loaded
  CPU takes a fraction of a second (the kernel's plain version steps the
  horizon one eager step at a time)."""
  from mujoco_mpc_torch.planners import sampling

  tagent.register_planner(
      "short_sampling", lambda task, horizon: sampling.SamplingPlanner(
          sampling.SamplingConfig.from_task(task, 10)))
  try:
    yield "short_sampling"
  finally:
    del tagent._PLANNERS["short_sampling"]


@one_torch_thread()
def test_live_loops_fill_the_history():
  """Threads on (JAX's test_live_loop_accrues_history): the physics loop
  fills the plot history and the plan loop times its plans and takes the
  best trajectory's root-body trace; no error."""
  with _short_sampling() as planner:
    ui = tserver.AgentUI("Particle", planner=planner, render=False,
                         device="cpu")
    ui.traces = True
    with _served(ui) as port:
      ui.start()
      deadline = time.time() + 60
      while time.time() < deadline and (
          len(ui.history) < 3 or not ui.plan_times
          or not len(ui._trace_pts)):
        time.sleep(0.05)
      code, st = _req(port, "/api/state")
  assert code == 200 and "error" not in st, st.get("error")
  assert len(st["history"]) >= 3 and st["history"][-1]["t"] > 0
  assert st["planner_hz"] is not None and st["planner_hz"] > 0
  # every other state of the best trajectory's first 24
  assert ui._trace_pts.shape == (12, 3)
  assert np.all(np.isfinite(ui._trace_pts))


@one_torch_thread()
def test_live_view_headless_writes_traces(tmp_path):
  """examples/live_view.py --headless: the asynchronous Agent stepped
  windowless, a root-body trace of the best trajectory and the plan's
  candidate returns every 20 steps, to an .npz; the card by default."""
  from mujoco_mpc_torch.examples import live_view

  out = tmp_path / "live.npz"
  with _short_sampling() as planner:
    live_view.main(["--task", "Particle", "--planner", planner,
                    "--headless", "21", "--trace-out", str(out),
                    "--device", "cpu"])
  z = np.load(out)
  assert z["traces"].shape == (2, 10, 3)
  assert z["candidate_returns"].shape[0] == 2
  assert np.all(np.isfinite(z["traces"]))
  with pytest.raises(RuntimeError, match="is_available"):
    live_view.main(["--headless", "1", "--trace-out", str(out)])


@one_torch_thread()
def test_record_clip_writes_a_clip_humanoid_track_loads(tmp_path,
                                                        monkeypatch):
  # one plan of 8 candidates and 2 steps: a Humanoid Walk plan on the
  # CPU is seconds of the kernel's plain version
  out = record_clip.main(["--candidates", "8", "--steps", "2", "--fps",
                          "400", "--name", "probe", "--out",
                          str(tmp_path / "probe.npz"), "--device", "cpu"])
  z = np.load(out)
  assert z["markers"].shape[1:] == (len(humanoid_track._MARKERS), 3)
  assert np.all(np.isfinite(z["markers"]))
  monkeypatch.setattr(humanoid_track, "_CLIP_DIR", str(tmp_path))
  (name, markers), = humanoid_track._load_clip_files()
  assert name == "Probe" and markers.shape[1:] == z["markers"].shape[1:]
  with pytest.raises(RuntimeError, match="is_available"):
    record_clip.main(["--out", str(tmp_path / "x.npz")])
