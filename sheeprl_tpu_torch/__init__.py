"""sheeprl_tpu_torch — the PyTorch/CUDA port of sheeprl_tpu for NVIDIA Hopper.

A package of its own beside ``sheeprl_tpu`` (the JAX reference, which it
never imports).  This slice serves DreamerV3 policies through a session
server; the RSSM's LayerNorm-GRU step runs as a hand-written CUDA kernel
(``csrc/gru_cell.cu``).  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""
