"""Examples, run as python -m mujoco_mpc_torch.examples.<name> [--device cpu]
(counterparts of the JAX package's examples/*.py)."""
