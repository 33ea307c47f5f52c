"""Headless tools: testspeed, drive, trace, plots and record_clip
(counterpart of mujoco_mpc_tpu/tools)."""
