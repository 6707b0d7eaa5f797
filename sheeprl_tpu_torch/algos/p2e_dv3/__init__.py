"""Plan2Explore on DreamerV3 (counterpart of ``sheeprl_tpu/algos/p2e_dv3``):
the exploration phase (an exploration actor on an ensemble's disagreement,
a zero-shot task behaviour beside it) and the finetuning phase, both on
DreamerV3's env loop."""
