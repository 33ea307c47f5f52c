"""The embedding interface and its C ABI on the CPU.

create_policy starts an Agent's plan loop on Particle (64 x 50); its
step_policy, with the loop stopped, equals Agent.action from the same
state, to the bit (Agent.action was held against JAX's in the planner
tests); destroy_policy joins the plan thread. The C ABI is built with g++
into build/mujoco_mpc_torch/ and its smoke run on Particle on the CPU:
it checks every return code and shows that the plan thread runs between
two calls (the library releases the GIL it holds after starting the
interpreter). Planning runs on one PyTorch thread."""

import subprocess
import threading

import numpy as np
import pytest

from mujoco_mpc_torch.agent import interface
from mujoco_mpc_torch.native import build as native
from mujoco_mpc_torch.tasks import registry as treg
from tests.torch_cases import one_torch_thread
from tests.torch_engine_cases import release_jax_executables  # noqa: F401


def _plan_threads():
  return [t for t in threading.enumerate()
          if t.is_alive() and getattr(t, "_target", None) is not None
          and t._target.__qualname__.startswith("Agent.start_planning")]


@one_torch_thread()
def test_interface_step_policy_equals_agent_action():
  """step_policy returns (nu,); set_weights reaches the task's weights;
  with the loop stopped, step_policy from a state equals the Agent's own
  action from that state, bitwise; destroy_policy leaves no plan thread;
  the default device raises on a host without a card."""
  h = interface.create_policy("Particle", device="cpu")
  runner = interface._RUNNERS[h]
  try:
    assert runner.agent.plan_version >= 0 and len(_plan_threads()) == 1
    a = interface.step_policy(h, [0.1, -0.1], [0.0, 0.0], 0.0)
    assert a.shape == (2,) and np.all(np.isfinite(a))
    interface.set_weights(h, {"Velocity": 0.375})
    assert runner.agent.get_cost_weights()["Velocity"] == np.float32(0.375)
    runner.agent.stop_planning()
    got = interface.step_policy(h, [0.2, -0.15], [0.3, 0.1], 0.05)
    want = runner.agent.action()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(runner.agent.get_state()["qpos"],
                                  np.float32([0.2, -0.15]))
  finally:
    interface.destroy_policy(h)
  assert h not in interface._RUNNERS
  assert not _plan_threads()
  assert runner.agent._plan_thread is None
  with pytest.raises(RuntimeError, match="is_available"):
    interface.create_policy("Particle")


@one_torch_thread()
def test_plan_thread_failure_reaches_the_caller():
  """A planner that fails in the plan thread: every later step_policy
  raises the failure (JAX's runner keeps answering from the last policy),
  and destroy_policy joins the thread and raises it too."""
  from mujoco_mpc_torch.agent import agent as tagent

  calls = []

  def factory(task, horizon):
    p = tagent._PLANNERS["sampling"](task, 10)
    optimize = p.optimize

    def failing(*args, **kwargs):
      calls.append(1)
      if len(calls) > 1:  # the first plan, in create_policy, succeeds
        raise FloatingPointError("plan diverged")
      return optimize(*args, **kwargs)

    p.optimize = failing
    return p

  tagent.register_planner("failing", factory)
  try:
    h = interface.create_policy("Particle", planner="failing", device="cpu")
    runner = interface._RUNNERS[h]
    runner.agent._plan_thread.join(timeout=30)
    for _ in range(2):
      with pytest.raises(RuntimeError, match="plan thread failed") as e:
        interface.step_policy(h, [0.1, -0.1], [0.0, 0.0], 0.0)
      assert isinstance(e.value.__cause__, FloatingPointError)
    with pytest.raises(RuntimeError, match="plan thread failed"):
      interface.destroy_policy(h)
    assert h not in interface._RUNNERS and not _plan_threads()
    assert runner.agent._plan_error is None
  finally:
    del tagent._PLANNERS["failing"]


def test_c_abi_smoke_plans_between_calls(monkeypatch):
  """The C smoke on Particle on the CPU: its OK line with nu=2, and two
  same-state actions 1.5 s apart (a Particle plan takes about a second
  here, longer on a loaded host: the smoke asks such a pair up to 5
  times) with no call between them differ: the plan thread ran between
  the calls. On the default device (the card, which this host lacks) the
  smoke fails with the Python error's text."""
  monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the smoke plans on one thread
  native.build()
  native.build_test()
  m = treg.get_task("Particle", device="cpu")
  term = m.spec.names[0]
  # the default device's smoke runs beside the CPU's
  bad = subprocess.Popen(
      native.smoke_args("Particle", term, [0.2, -0.2], m.model.nv, None),
      env=native.smoke_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
      text=True)
  try:
    proc = native.run_smoke("Particle", term, [0.2, -0.2], m.model.nv,
                            "cpu", gap_ms=1500, timeout=120)
    _, bad_err = bad.communicate(timeout=120)
  finally:
    bad.kill()
  assert proc.returncode == 0, proc.stdout + proc.stderr
  assert "C ABI smoke test OK: nu=2 " in proc.stdout
  change = float(proc.stdout.split("max |action change| ")[1].split()[0])
  assert change > 0
  assert bad.returncode == 1
  assert ("create_policy failed: create_policy: RuntimeError: device cuda "
          "requested" in bad_err), bad_err
