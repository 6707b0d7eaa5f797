"""DreamerV1 (counterpart of ``sheeprl_tpu/algos/dreamer_v1``): Gaussian
latents, flax's GRU cell and a pure dynamics-backprop actor, trained on
DreamerV3's env loop as a family of its own."""
