"""sheeprl_tpu_torch — the PyTorch/CUDA port of sheeprl_tpu for NVIDIA Hopper.

A package of its own beside ``sheeprl_tpu`` (the JAX reference, which it
never imports).  It serves DreamerV3 policies through a session server,
runs DreamerV3 and SAC training steps on batches from a device-resident
replay, and trains PPO and A2C end to end on torch-tensor device envs
through its CLI (``python -m sheeprl_tpu_torch exp=ppo env=jax_cartpole
algo.env_backend=jax``).  The RSSM's LayerNorm-GRU
step (``csrc/gru_cell.cu``), its sequence (``csrc/seq_gru.cu``), the replay
gathers (``csrc/gather.cu``) and the sum-tree (``csrc/sum_tree.cu``) run as
hand-written CUDA kernels.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
