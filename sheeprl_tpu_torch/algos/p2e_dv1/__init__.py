"""Plan2Explore on DreamerV1 (counterpart of ``sheeprl_tpu/algos/p2e_dv1``):
the exploration phase (an exploration actor on an ensemble's disagreement
about the next embedded observation, a zero-shot task behaviour beside it)
and the finetuning phase, both on the shared Dreamer loop with DreamerV1's
conventions."""
