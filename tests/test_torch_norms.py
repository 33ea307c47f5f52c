"""The norms' closed-form value, gradient and Gauss-Newton Hessian
(ops/norms.py::norm_grad_hess) held against the JAX package's in float64
on the CPU, each of the 9 norms on a batch of residual blocks made from a
numpy seed, at rtol 1e-12, atol 1e-14 (measured 2.7e-16 of the max);
RECTIFY also at p = 0, its relu branch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_torch.ops import norms as tnorms
from mujoco_mpc_tpu.ops import norms as jnorms
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

F64 = torch.float64

# norm parameters (p, q) per norm, away from the kinks of the closed forms
NORM_PARAMS = {
    jnorms.NormType.NULL: (0.0, 0.0),
    jnorms.NormType.QUADRATIC: (0.0, 0.0),
    jnorms.NormType.L22: (0.3, 4.0),
    jnorms.NormType.L2: (0.1, 0.0),
    jnorms.NormType.COSH: (0.7, 0.0),
    jnorms.NormType.POWER_LOSS: (1.5, 0.0),
    jnorms.NormType.SMOOTH_ABS: (0.2, 0.0),
    jnorms.NormType.SMOOTH_ABS2: (0.3, 3.0),
    jnorms.NormType.RECTIFY: (0.25, 0.0),
}


@pytest.mark.parametrize("norm", list(NORM_PARAMS), ids=lambda n: n.name)
def test_norm_grad_hess_matches_jax(norm):
  p, q = NORM_PARAMS[norm]
  x = np.random.RandomState(int(norm) + 2).uniform(-1.5, 1.5, (5, 4))
  got = tnorms.norm_grad_hess(torch.tensor(x), tnorms.NormType(int(norm)),
                              torch.tensor(p, dtype=F64),
                              torch.tensor(q, dtype=F64))
  for b in range(x.shape[0]):
    want = jnorms.norm_grad_hess(jnp.asarray(x[b]), norm, p, q)
    for ours, theirs, what in zip(got, want, ("value", "grad", "hess")):
      np.testing.assert_allclose(ours[b].numpy(), np.asarray(theirs),
                                 rtol=1e-12, atol=1e-14, err_msg=what)
  if norm == jnorms.NormType.RECTIFY:  # the relu branch at p = 0
    got0 = tnorms.norm_grad_hess(torch.tensor(x[0]), tnorms.NormType.RECTIFY,
                                 torch.tensor(0.0, dtype=F64))
    want0 = jnorms.norm_grad_hess(jnp.asarray(x[0]), norm, 0.0)
    for ours, theirs in zip(got0, want0):
      np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                 rtol=1e-12, atol=1e-14)
