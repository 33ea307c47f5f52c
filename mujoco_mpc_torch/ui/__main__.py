from mujoco_mpc_torch.ui.server import main

main()
