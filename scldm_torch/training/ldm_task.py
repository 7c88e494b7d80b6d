"""Latent-diffusion task (counterpart of scldm_tpu/training/ldm_task.py):
the DiT's flow-matching training on the latents of a frozen VAE, and CFG
generation.

- Training (`train_step`): the frozen VAE encodes the batch without
  gradients; the DiT takes the Linear/velocity flow-matching loss under the
  training conditioning (CFG dropout, random class selection); then the
  global-norm clip, `optax.adamw` (`optim.AdamW`) on the wsd schedule, and
  the EMA tick. On CUDA tensors every DiT block runs through the forward
  and backward kernels (`ops.fused_dit.fused_dit_train_apply`), as the JAX
  task runs its Pallas kernels on a TPU; `fused_training=False` runs the
  module path.
- Generation (`make_sample_fn`): log size factors and prior noise -> the
  flow-matching ODE with the DiT under batched CFG -> VAE decode -> NB
  counts, from the module's weights or a train state's EMA weights.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import torch

from scldm_torch.nn.nnets import DiT, build_cfg_segments, combine_cfg_segments
from scldm_torch.nn.vae import TransformerVAE
from scldm_torch.ops.distributions import nb_sample
from scldm_torch.ops.fused_dit import (
    extract_block_params,
    fused_dit_forward,
    fused_dit_train_apply,
)
from scldm_torch.ops.transforms import (
    COUNTS,
    COUNTS_SUBSET as C_SUB,
    GENES,
    GENES_SUBSET as G_SUB,
    NON_CONDITION_KEYS,
    widen_lean,
)
from scldm_torch.sampling.size_factors import SizeFactorSampler
from scldm_torch.training import metrics as M
from scldm_torch.training.ema import ema_init, ema_update
from scldm_torch.training.optim import AdamW, wsd_schedule
from scldm_torch.training.state import TrainState, create_train_state
from scldm_torch.training.vae_task import _fused_window_ok, fused_window_pooling
from scldm_torch.transport import Sampler, Transport


def split_condition(batch: Dict, class_vocab_sizes: Dict[str, int]) -> Dict:
    """The batch's label columns: keys that name a class table."""
    return {k: v for k, v in batch.items()
            if k not in NON_CONDITION_KEYS and k in class_vocab_sizes}


class LDMTask:
    """Holds the frozen VAE, the DiT, the transport and the training
    settings (the JAX defaults: AdamW at 5e-4, betas (0.9, 0.999), no weight
    decay, clip 10, the cosine wsd schedule decaying over the whole run, EMA
    0.9999 every 10 steps after step 10,000).

    `fused_training=None` takes the kernel path on CUDA tensors (the JAX
    rule is "on a TPU, with DiT dropout 0"; the port's DiT has no dropout),
    True on any device (on CPU tensors through the kernels' plain versions),
    False never. `fused_encode=None` resolves to False, as in JAX; the port
    keeps the VAE frozen (JAX `train_vae=False`), where JAX allows it."""

    def __init__(
        self,
        vae: TransformerVAE,
        dit: DiT,
        transport: Transport,
        *,
        learning_rate: float = 5e-4,
        betas: Tuple[float, float] = (0.9, 0.999),
        weight_decay: float = 0.0,
        grad_clip: float = 10.0,
        num_training_steps: int = 10_000,
        num_warmup_steps: Optional[int] = None,
        final_lr_factor: float = 0.1,
        fract_decay: float = 1.0,
        decay_type: str = "cosine",
        ema_decay: float = 0.9999,
        ema_update_every: int = 10,
        ema_update_after_step: int = 10_000,
        calculate_grad_norms: bool = False,
        fused_training: Optional[bool] = None,
        fused_encode: Optional[bool] = None,
    ):
        self.vae = vae
        self.dit = dit
        self.transport = transport
        self.transport_sampler = Sampler(transport)
        self.calculate_grad_norms = calculate_grad_norms
        self.fused_training = fused_training
        self.fused_encode = bool(fused_encode)
        self.grad_clip = grad_clip
        self.ema_cfg = dict(beta=ema_decay, update_every=ema_update_every,
                            update_after_step=ema_update_after_step)
        if num_warmup_steps is None:
            num_warmup_steps = max(1, int(0.1 * num_training_steps))
        self.schedule = wsd_schedule(
            num_training_steps=num_training_steps,
            final_lr_factor=final_lr_factor,
            num_warmup_steps=num_warmup_steps,
            fract_decay=fract_decay,
            decay_type=decay_type,
        )
        self._opt_kwargs = dict(learning_rate=learning_rate, schedule=self.schedule, betas=betas,
                                weight_decay=weight_decay)
        self._ema_dit: Optional[DiT] = None

    # -- training ----------------------------------------------------------------
    def init_state(self, generator: torch.Generator) -> TrainState:
        """A fresh optimizer and EMA over `self.dit`, whose module keeps the
        weights it holds; `generator` is the source of the steps' draws."""
        params = [p for p in self.dit.parameters() if p.requires_grad]
        return create_train_state(self.dit, AdamW(params, **self._opt_kwargs), generator,
                                  ema=ema_init(self.dit.named_parameters()))

    @torch.no_grad()
    def _encode(self, batch: Dict) -> torch.Tensor:
        """Latents (B, M, E_latent) of the frozen VAE from the expressed
        subsets (lean batches) or the full counts; no gradient."""
        batch = widen_lean(batch)
        counts = batch.get(COUNTS, batch.get(C_SUB))
        genes = batch.get(GENES, batch.get(G_SUB))
        if self.fused_encode and _fused_window_ok(self.vae):
            emb = self.vae.input_layer(batch.get(C_SUB, counts), batch.get(G_SUB, genes))
            return self.vae.encoder.trunk(fused_window_pooling(self.vae, emb)).float()
        return self.vae.encode(counts, genes, batch.get(C_SUB), batch.get(G_SUB)).float()

    def _use_fused(self, z: torch.Tensor) -> bool:
        return z.is_cuda if self.fused_training is None else self.fused_training

    def loss(self, batch: Dict, generator: torch.Generator,
             noise: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """Flow-matching loss of a batch on the DiT's current parameters
        (differentiable). The draws come from `generator`: the transport's
        noise x0 and times t, then the conditioning's class choice and CFG
        drop mask. `noise` may inject any of them ({"t", "x0"} together,
        "selected", "drop_mask")."""
        noise = noise or {}
        z = self._encode(batch)
        condition = split_condition(batch, self.dit.class_vocab_sizes)
        draws = {k: noise[k] for k in ("selected", "drop_mask") if k in noise}
        fused = self._use_fused(z)

        def model_fn(xt, t, condition):
            if fused:
                t_emb = self.dit.embed_condition(t, condition, generator, train=True, **draws)
                return fused_dit_train_apply(self.dit, xt, t_emb)
            return self.dit(xt, t, condition, train=True, generator=generator, **draws)

        kwargs = {"condition": condition}
        if "t" in noise:
            terms = self.transport.losses_at(model_fn, noise["t"], noise["x0"], z, kwargs)
        else:
            terms = self.transport.training_losses(model_fn, generator, z, kwargs)
        return terms["loss"].mean()

    def train_step(self, state: TrainState, batch: Dict,
                   noise: Optional[Dict[str, torch.Tensor]] = None) -> Tuple[TrainState, Dict]:
        """One optimizer step and EMA tick; updates `state` in place and
        returns it with the step's metrics (0-d tensors on the batch's
        device). `noise` as in `loss`."""
        state.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(batch, state.generator, noise)
        loss.backward()
        return state, {"train_loss": loss.detach(), **self.apply_gradients(state)}

    def apply_gradients(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """The step after the backward: the global-norm clip of the module's
        gradients, the optimizer step on the schedule and the EMA tick.
        Updates `state` in place and returns grad_norm, lr_mult and, with
        `calculate_grad_norms`, the per-module norms."""
        named = [(n, p.grad) for n, p in state.module.named_parameters() if p.grad is not None]
        grads = [g for _, g in named]
        gnorm = M.global_norm(grads)
        torch._foreach_mul_(grads, torch.clamp(self.grad_clip / (gnorm + 1e-12), max=1.0))
        lr_mult = self.schedule(state.step)
        state.optimizer.step()
        state.step += 1
        state.ema = ema_update(state.ema, state.module.named_parameters(), **self.ema_cfg)
        mets = {"grad_norm": gnorm.detach(), "lr_mult": torch.tensor(lr_mult, device=gnorm.device)}
        if self.calculate_grad_norms:
            mets.update(M.grad_norms_by_module(named, prefix="grad_norm/diffusion"))
        return mets

    def train_steps(self, state: TrainState, stacked: Dict) -> Tuple[TrainState, Dict]:
        """K steps, one per slice of the leading axis of `stacked`'s leaves
        ((K, batch, ...)); returns the metrics' means over the K steps."""
        k = next(iter(stacked.values())).shape[0]
        runs = []
        for i in range(k):
            state, mets = self.train_step(state, {key: v[i] for key, v in stacked.items()})
            runs.append(mets)
        return state, {key: torch.stack([m[key] for m in runs]).mean() for key in runs[0]}

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Dict, generator: torch.Generator,
                  use_ema: bool = False,
                  noise: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """Validation loss on the module path, with the online or the EMA
        weights, without CFG dropout; draws and `noise` as in `loss`."""
        noise = noise or {}
        z = self._encode(batch)
        condition = split_condition(batch, self.dit.class_vocab_sizes)
        dit = self.ema_module(state) if use_ema else state.module

        def model_fn(xt, t, condition):
            return dit.trunk(xt, dit.embed_condition(t, condition, generator,
                                                     selected=noise.get("selected")))

        kwargs = {"condition": condition}
        if "t" in noise:
            loss = self.transport.losses_at(model_fn, noise["t"], noise["x0"], z, kwargs)["loss"]
        else:
            loss = self.transport.training_losses(model_fn, generator, z, kwargs)["loss"]
        prefix = "val_ema" if use_ema else "val"
        return {f"{prefix}_loss": loss.mean(), f"{prefix}_diff": loss.mean()}

    @torch.no_grad()
    def ema_module(self, state: TrainState) -> DiT:
        """A copy of the DiT that holds the state's EMA weights (one copy per
        task, refreshed at each call)."""
        if self._ema_dit is None:
            self._ema_dit = copy.deepcopy(self.dit).requires_grad_(False)
        for name, p in self._ema_dit.named_parameters():
            p.copy_(state.ema.params[name])
        return self._ema_dit

    # -- generation ------------------------------------------------------------------
    def make_sample_fn(
        self,
        size_factor_sampler: SizeFactorSampler,
        *,
        guidance_weight: Optional[Dict[str, float]] = None,
        sampling_method: str = "dopri5",
        num_steps: int = 50,
        use_ema: bool = True,
    ):
        """Returns fn(generator, genes, condition=None, batch_size=None,
        state=None) -> (counts (2B, G), z (2B, M, E_latent)): the first half
        unconditional, the second half guided (the reference's doubled-batch
        convention). Without `state` the DiT module's weights sample; with a
        train state, its EMA weights (or, with `use_ema=False`, its module's).

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
               batch_size: Optional[int] = None,
               state: Optional[TrainState] = None) -> Tuple[torch.Tensor, torch.Tensor]:
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
                dit=None if state is None else (
                    self.ema_module(state) if use_ema else state.module),
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
        dit: Optional[DiT] = None,
    ):
        """The deterministic part of sampling, from given noise and size
        factors, with `dit` (default the task's): returns (samples (2B, M,
        E_latent), {"mu", "theta"}, number of DiT evaluations)."""
        sample_ode = self.transport_sampler.sample_ode(
            sampling_method=sampling_method, num_steps=num_steps
        )
        dit = self.dit if dit is None else dit
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
