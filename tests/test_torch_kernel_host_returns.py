"""The host build of the CUDA kernel's returns against the plain version:
every case of tests/test_torch_kernel_host.py, float32 over 4 steps at
rtol 2e-3 here, and float64 over 30 at 1e-9 in
test_torch_kernel_host_returns64.py (measured: rel 7.6e-16 for the
Walker, 1.4e-15 for the Humanoid), so that the test workers share them
out. The build and the cases are that file's; the five flat-ground
kernel tasks' returns, with the fit of each model's block in shared
memory, are the last test's."""

import ctypes

import numpy as np
import pytest
import torch

from mujoco_mpc_torch.ops import megarollout as tmr
from mujoco_mpc_torch.tasks import registry as treg
from tests.test_torch_kernel_host import (_CASES, _NP, _packed,
                                          check_returns, host_returns)
from tests.test_torch_kernel_host import lib  # noqa: F401 (fixture)
from tests.test_torch_kernel_host_flat import kernel_aux
from tests.torch_cases import one_torch_thread
from tests.torch_flat_cases import KERNEL_TASKS, states
from tests.torch_engine_cases import release_jax_executables  # noqa: F401


@pytest.mark.parametrize("name", sorted(_CASES))
def test_host_kernel_returns_match_plain(lib, name):  # noqa: F811
  check_returns(lib, name, torch.float32, 4, 2e-3)


@one_torch_thread()
@pytest.mark.parametrize("name", KERNEL_TASKS)
def test_host_kernel_flat_task_returns_match_plain(lib, name):  # noqa: F811
  """The five flat-ground kernel tasks with their goal and mode operands
  (tests/torch_flat_cases.py), from a probe state with contacts active:
  float32 over 4 steps at rtol 2e-3 (measured 2.1e-5, Bimanual Reorient),
  float64 over 12 at 1e-9 (1.7e-13); and each model's block (the model
  head and one candidate's working set, carve) within the card's
  MR_SMEM_MAX in both precisions (measured 70,064 to 89,808 bytes in
  float32, 124,848 to 164,080 in float64, of 232,448)."""
  task = treg.get_task(name, device="cpu")
  for dtype, horizon, rtol in ((torch.float32, 4, 2e-3),
                               (torch.float64, 12, 1e-9)):
    mr = tmr.MegaRollout(task, horizon, device="cpu")
    raw, tier = _packed(mr.tm, task, dtype)
    block = lib[tier].host_block_bytes(int(dtype == torch.float64),
                                       raw.ctypes.data_as(ctypes.c_void_p))
    assert 0 < block <= tmr.SMEM_MAX, block
    home = states(name, task.model, 1)[0][:, 0].astype(_NP[dtype])
    v0 = np.zeros(mr.tm.nv, _NP[dtype])
    acts = (0.3 * np.random.RandomState(1).randn(8, horizon, mr.tm.nu)
            ).astype(_NP[dtype])
    p = task.params.to(dtype=dtype)
    aux = kernel_aux(mr.tm, name, dtype)
    out = host_returns(lib, mr, dtype, home, v0, acts, p, aux)
    want = mr.returns(*(torch.tensor(x) for x in (home, v0, acts)), p, 0.25,
                      *(torch.tensor(x) for x in aux)).numpy()
    assert np.all(want < tmr.MAX_RETURN)
    np.testing.assert_allclose(out, want, rtol=rtol)
