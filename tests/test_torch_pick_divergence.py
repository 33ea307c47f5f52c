"""Pick's planning model diverges for perturbed candidates in the JAX
package's general rollout as in the port: the sampling planner's own
spline candidates at the Agent's shape (horizon 56 at the agent_timestep,
0.009 s; the nominal and three perturbed, on injected normals from a
numpy seed) through JAX's general rollout (jitted once per candidate:
vmapped over candidates it takes minutes here), the port's general
rollout and the kernel's plain version, in float64 on the CPU.

Tolerances, with the errors measured when they were set:
  the nominal candidate, every step's cost: rtol 1e-9 (measured 2.2e-12);
    its qpos: rtol 1e-9, atol 1e-10 (measured 1.2e-12 absolute);
  a perturbed candidate's qpos on the steps where it stays within 10 of
    the origin (the first 22 to 24 of 56): rtol 1e-9, atol 1e-9 (measured
    2.8e-11 absolute). The state then grows by orders of magnitude a step;
    JAX's general step turns it into NaN at about 1e14, the port's at
    about 1e90, so the first step whose cost is MAX_RETURN differs by one
    or two (JAX's 27, 28, 30; the port's 29, 29, 32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mujoco_mpc_tpu.ops import rollout as jrollout
from mujoco_mpc_torch.agent.agent import Agent
from mujoco_mpc_torch.ops import megarollout as tmr
from mujoco_mpc_torch.ops import rollout as trollout
from tests import torch_engine_cases as cases
from tests import torch_flat_cases as fc
from tests.torch_cases import one_torch_thread
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

N = 4


def test_pick_candidates_diverge_in_jax_and_port():
  t, j = cases.pair("Pick")
  with one_torch_thread():
    agent = Agent(t, device="cpu")
    agent.reset("home")
    mp, mq, ud = fc.operands("Pick", t.model)
    agent.set_state(mocap_pos=mp, mocap_quat=mq, userdata=ud)
    task, d, pl = agent.task, agent.data, agent.planner
    dt = float(task.model.opt.timestep)
    assert dt == 0.009
    k, nu = pl.config.spline_points, task.model.nu
    rng = np.random.RandomState(0)
    new_times, _, cands = pl._gen_candidates(
        task, agent.policy, d, None,
        noise=torch.tensor(rng.randn(N - 1, k, nu)),
        use2=torch.tensor(rng.rand(N - 1) < 0.2))
    acts = pl._actions(task, d, new_times, cands)
    horizon = acts.shape[1]
    assert horizon == pl.config.horizon == 56

    def policy(tt, dd):
      i = torch.clamp(torch.round(tt / dt).long(), 0, horizon - 1)
      return acts[torch.arange(N), i]

    port = trollout.rollout(task, trollout.broadcast(d, (N,)), policy,
                            horizon)
    kernel = tmr.MegaRollout(task, horizon, device="cpu").returns_plain(
        d.qpos, d.qvel, acts, task.params, d.time, torch.float64,
        mocap_pos=d.mocap_pos, mocap_quat=d.mocap_quat, userdata=d.userdata)

  jm = j.model.replace(opt=j.model.opt.replace(timestep=jnp.asarray(dt)))
  jt = j.replace(model=jm)
  jd = _jax_data(jm, d)

  @jax.jit
  def one(a):
    pf = lambda tt, _: a[jnp.clip(jnp.round(tt / dt).astype(jnp.int32), 0,
                                  horizon - 1)]
    r = jrollout.rollout(jt, jd, pf, horizon)
    return r.costs, r.qpos

  costs = port.costs.numpy()
  qpos = port.qpos.numpy()
  blown_jax = []
  for c in range(N):
    jc, jq = (np.asarray(x) for x in one(jnp.asarray(acts[c].numpy())))
    blown_jax.append(bool(np.any(jc == tmr.MAX_RETURN)))
    if c == 0:
      np.testing.assert_allclose(costs[0], jc, rtol=1e-9)
      np.testing.assert_allclose(qpos[0], jq, rtol=1e-9, atol=1e-10)
      continue
    calm = np.abs(qpos[c]).max(1) < 10.0
    assert calm[:10].all() and not calm.all()
    np.testing.assert_allclose(qpos[c][calm], jq[calm], rtol=1e-9, atol=1e-9)
  blown_port = np.any(costs == tmr.MAX_RETURN, axis=1)
  at_max = kernel.numpy() == tmr.MAX_RETURN
  assert blown_jax == [False] + [True] * (N - 1)
  assert blown_port.tolist() == blown_jax == at_max.tolist()
  assert np.all(np.isfinite(costs[0])) and float(kernel[0]) < tmr.MAX_RETURN


def _jax_data(jm, d):
  """JAX's Data at the port's start state (qpos, goal, userdata)."""
  import importlib
  jio = importlib.import_module("mujoco_mpc_tpu.physics.io")
  return jio.make_data(jm).replace(
      qpos=jnp.asarray(d.qpos.numpy()),
      mocap_pos=jnp.asarray(d.mocap_pos.numpy()),
      mocap_quat=jnp.asarray(d.mocap_quat.numpy()),
      userdata=jnp.asarray(d.userdata.numpy()))
