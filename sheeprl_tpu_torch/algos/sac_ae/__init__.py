"""SAC with a pixel autoencoder (counterpart of ``sheeprl_tpu/algos/sac_ae``;
arXiv:1910.01741) on the shared off-policy loop."""
