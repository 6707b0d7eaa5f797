"""DroQ (counterpart of ``sheeprl_tpu/algos/droq``): SAC with dropout and
LayerNorm critics, a high replay ratio and one actor step a dispatch, on
SAC's env loop."""
