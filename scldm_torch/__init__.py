"""PyTorch / CUDA port of scldm_tpu.

The JAX package `scldm_tpu` is the reference; this package computes the same
functions in PyTorch, with the Pallas TPU kernels rewritten by hand for
NVIDIA Hopper (`scldm_torch/kernels/csrc`). It imports neither jax nor flax.

Ported so far: CFG generation (`training.ldm_task.LDMTask.make_sample_fn`)
with the VAE decoder, the DiT and the flow-matching ODE samplers; the VAE
training step (`training.vae_task.VAETask`); LDM training
(`training.ldm_task.LDMTask.train_step`) with the EMA; joint conditioning
with its size-factor table (`sampling.size_factors`); the host data layer
(`data`: the vocabulary encoder, tokenization, CSR packing, h5ad files),
`cli.extract_metadata` and the generation output files (`utils.output`); the
user entry points `cli.train`, `cli.train_ldm` and `cli.inference` with the
config loader and builders (`config`), the DataModule and its native CSR
packer, checkpoints with step-exact resume, the preemption guard and the fit
loop (`training.checkpoint`, `training.preemption`, `training.loop`).
"""

__version__ = "0.1.0"
