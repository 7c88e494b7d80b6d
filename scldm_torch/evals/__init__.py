"""Generation-quality evaluations (counterpart of scldm_tpu/evals/): MMD
under four kernels, Sinkhorn Wasserstein distances and the periodic
generation eval of LDM training."""
