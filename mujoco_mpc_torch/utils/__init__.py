"""Checkpoints and phase timers (counterpart of mujoco_mpc_tpu/utils)."""
