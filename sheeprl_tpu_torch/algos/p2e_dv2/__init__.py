"""Plan2Explore on DreamerV2 (counterpart of ``sheeprl_tpu/algos/p2e_dv2``):
the exploration phase (an exploration actor on an ensemble's disagreement,
a zero-shot task behaviour beside it) and the finetuning phase, both on the
shared Dreamer loop with DreamerV2's conventions."""
