"""Latent-diffusion task, generation path (counterpart of
scldm_tpu/training/ldm_task.py `LDMTask.make_sample_fn`).

One call of the sample function: log size factors and prior noise -> the
flow-matching ODE with the DiT under batched CFG -> VAE decode -> NB counts.
Training, EMA updates and encode-for-training are not ported yet; the
modules hold the weights that sampling uses.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from scldm_torch.nn.nnets import DiT, build_cfg_segments, combine_cfg_segments
from scldm_torch.nn.vae import TransformerVAE
from scldm_torch.ops.distributions import nb_sample
from scldm_torch.ops.fused_dit import extract_block_params, fused_dit_forward
from scldm_torch.sampling.size_factors import SizeFactorSampler
from scldm_torch.transport import Sampler, Transport


class LDMTask:
    """Holds the frozen VAE, the DiT and the transport."""

    def __init__(self, vae: TransformerVAE, dit: DiT, transport: Transport):
        self.vae = vae
        self.dit = dit
        self.transport = transport
        self.transport_sampler = Sampler(transport)

    def make_sample_fn(
        self,
        size_factor_sampler: SizeFactorSampler,
        *,
        guidance_weight: Optional[Dict[str, float]] = None,
        sampling_method: str = "dopri5",
        num_steps: int = 50,
    ):
        """Returns fn(generator, genes, condition=None, batch_size=None) ->
        (counts (2B, G), z (2B, M, E_latent)): the first half unconditional,
        the second half guided (the reference's doubled-batch convention).

        `genes` is (G,) (shared by the batch; the canonical row takes the
        decoder's batch-free path) or (B, G). Every draw comes from
        `generator`, which lives on the modules' device. Every DiT block runs
        through `ops.fused_dit.dit_block` (the CUDA kernel on a GPU). After
        each call `fn.drift_evals` holds the number of DiT evaluations it
        made."""
        if guidance_weight and self.dit.cfg_dropout_prob <= 0:
            raise ValueError(
                "CFG guidance needs null-token embedding rows, which only exist "
                "when the DiT was built with cfg_dropout_prob>0"
            )
        latent = self.vae.encoder.n_embed_latent
        seq_len = self.dit.seq_len

        @torch.inference_mode()
        def fn(generator: torch.Generator, genes: torch.Tensor,
               condition: Optional[Dict[str, torch.Tensor]] = None,
               batch_size: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
            if batch_size is None:
                if genes.ndim == 2:
                    batch_size = genes.shape[0]
                elif condition:
                    batch_size = next(iter(condition.values())).shape[0]
                else:
                    raise ValueError("batch_size required when genes is 1-D and no condition given")
            device = generator.device
            log_sf = size_factor_sampler.sample(generator, condition, batch_size, device)
            z0 = torch.randn((batch_size, seq_len, latent), generator=generator, device=device)
            samples, out, fn.drift_evals = self.generate_from_noise(
                z0, log_sf, genes, condition,
                guidance_weight=guidance_weight, sampling_method=sampling_method,
                num_steps=num_steps,
            )
            return nb_sample(out["mu"], out["theta"], generator), samples

        fn.drift_evals = 0
        return fn

    @torch.inference_mode()
    def generate_from_noise(
        self,
        z0: torch.Tensor,  # (B, M, E_latent) prior noise
        log_sf: torch.Tensor,  # (B,) log size factors
        genes: torch.Tensor,
        condition: Optional[Dict[str, torch.Tensor]] = None,
        *,
        guidance_weight: Optional[Dict[str, float]] = None,
        sampling_method: str = "dopri5",
        num_steps: int = 50,
    ):
        """The deterministic part of sampling, from given noise and size
        factors: returns (samples (2B, M, E_latent), {"mu", "theta"}, number
        of DiT evaluations)."""
        sample_ode = self.transport_sampler.sample_ode(
            sampling_method=sampling_method, num_steps=num_steps
        )
        dit = self.dit
        z_cfg = torch.cat([z0, z0]).float()
        condition_cfg = {k: torch.cat([v, v]) for k, v in condition.items()} if condition else None
        block_params = [extract_block_params(b) for b in dit.blocks]
        evals = 0

        def model_fn(x, t, condition=None):
            nonlocal evals
            evals += 1
            seg_x, seg_t, seg_cond, scale_segments, b, h = build_cfg_segments(
                x, t, condition, guidance_weight, dit.class_vocab_sizes, dit.condition_strategy
            )
            out = fused_dit_forward(dit, seg_x, seg_t, seg_cond, block_params)
            if not scale_segments:
                return out
            return combine_cfg_segments(out, scale_segments, b, h)

        samples = sample_ode(z_cfg, model_fn, condition=condition_cfg)

        # 1-D genes: one canonical query row for the whole batch; 2-D doubles
        genes_cfg = genes if genes.ndim == 1 else torch.cat([genes, genes])
        sf = torch.exp(log_sf.float()).reshape(-1, 1)
        out = self.vae.decode(samples, genes_cfg, torch.cat([sf, sf]))
        return samples, out, evals
