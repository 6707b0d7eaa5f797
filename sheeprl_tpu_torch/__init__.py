"""sheeprl_tpu_torch — the PyTorch/CUDA port of sheeprl_tpu for NVIDIA Hopper.

A package of its own beside ``sheeprl_tpu`` (the JAX reference, which it
never imports).  It serves DreamerV3 policies through a session server and
runs DreamerV3 training steps (``algos/dreamer_v3/dreamer_v3.py``) on
batches from a device-resident replay window.  The RSSM's LayerNorm-GRU
step (``csrc/gru_cell.cu``), its sequence (``csrc/seq_gru.cu``), the replay
gathers (``csrc/gather.cu``) and the sum-tree (``csrc/sum_tree.cu``) run as
hand-written CUDA kernels.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
