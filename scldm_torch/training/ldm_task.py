"""Latent-diffusion task (counterpart of scldm_tpu/training/ldm_task.py):
the DiT's flow-matching training on the latents of a frozen VAE, and CFG
generation.

- Training (`train_step`): the frozen VAE encodes the batch without
  gradients; the DiT takes the transport's flow-matching loss (any path,
  prediction and loss weight) under the training conditioning (CFG
  dropout, random class selection); then the global-norm clip,
  `optax.adamw` (`optim.AdamW`) on the wsd schedule, and the EMA tick. On
  CUDA tensors every DiT block runs through the forward and backward
  kernels (`ops.fused_dit.fused_dit_train_apply`), as the JAX task runs its
  Pallas kernels on a TPU; `fused_training=False` runs the module path.
- Joint finetuning (`train_vae=True`, the config's
  `vae_as_tokenizer.train`): the train state's module carries the DiT and
  the VAE (`JointLDM`), optimised and clipped together; the encode runs
  inside the loss under gradient (without dropout, as JAX's `encode`), the
  EMA covers the DiT alone, and the kernel paths (`fused_training`,
  `fused_encode`) are off, as in JAX.
- Generation (`make_sample_fn`): log size factors and prior noise -> the
  probability-flow ODE with the DiT under batched CFG (every block through
  the forward kernel; `fused_blocks=False` runs the module path), the
  transport's drift taken from the guided model output -> VAE decode -> NB
  counts, from the module's weights or a train state's EMA weights. At
  E > 128 (the census decoder) the decode of the canonical gene row is the
  algebraic one (`vae_task.algebraic_decode`), as in JAX.

Compute dtype. The VAE and the DiT compute in their modules' `dtype` (the
configs' bfloat16: f32 weights, bf16 products; `nn/layers.py`). The frozen
encode and the decode run in the VAE's dtype; the latents stay in it, the
transport draws its noise in it (the interpolant and the target velocity
are f32), and the DiT's output is f32.
The DiT kernels (rows 1-2: `fused_dit_train_apply`, `fused_dit_forward`)
compute in f32 whatever the DiT's dtype, as JAX's kernel path does on a
TPU: the port takes them on CUDA tensors, where JAX takes them on a TPU,
so on the card a bf16 config trains and samples its DiT in f32 through the
kernels (the conditioning embedding, computed by the module, is rounded to
bf16 first, as in JAX). CPU tensors, `fused_training=False` and
`make_sample_fn(fused_blocks=False)` run the module DiT in its dtype, as
JAX does off the TPU; so does a DiT with dropout, in training and in
sampling, as JAX's gates close there.

On a mesh (`parallel.make_mesh`; a rank is a JAX process) the steps are
data-parallel over "data", as `vae_task.VAETask`'s: the initial weights from
rank 0, the gradients averaged over "data" before the clip, the metrics the
global means, the EMA replicated. The kernel gates stay as on one card, under
FSDP too (each rank runs a one-card step, under FSDP on the gathered
weights; JAX closes them under a multi-device mesh, which changes the
dispatch, not the math); under gene-SP they close, as JAX's. `fsdp` slices the train state's module over
"data" (`parallel.data_parallel.FlatShards`); `gene_sp` with a "model" axis
above 1 decodes the generation's genes in contiguous ranges over the model
ranks (`parallel.gene_sp`), and `make_sample_fn(split_over_data=True)`
splits a generation batch over the data ranks and gathers it back. At a
model axis of 1 `gene_sp` and `pipeline_microbatches` are ignored, as in JAX.

A "model" axis above 1 carries one of JAX's three layouts:

- gene-SP (`gene_sp`), above;
- the GPipe trunk (`pipeline_microbatches`, `parallel.pipeline`): the DiT's
  blocks in contiguous stages over the model ranks, the parameters and AdamW
  state replicated there; each stage runs its blocks through the DiT kernels
  (rows 1-2) on every microbatch, the conditioning through the module, and
  each rank's gradients are summed over "model" before the mean over
  "data". Generation runs the DiT on each rank (row 1 through
  `fused_dit_forward`) and decodes gene-parallel over "model", as JAX's
  `make_sample_fn` does under a pipeline;
- Megatron otherwise (`parallel.sharding_rules`): the DiT and the frozen VAE
  cut to each model rank's slices, the DiT step, the frozen encode and
  generation on the modules (the DiT kernels and the window pool close, as
  in JAX; the decode's `swiglu_vec` runs on each rank's hidden slice).
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict, Optional, Tuple

import torch

from scldm_torch.nn.heads import GaussianTransformerHead
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
from scldm_torch.parallel.data_parallel import (
    Layout,
    full_weights,
    step_gradients,
    trained_params,
)
from scldm_torch.parallel.gene_sp import GeneSP
from scldm_torch.parallel.mesh import axis_size
from scldm_torch.parallel.pipeline import Hops, pipeline_dit_apply
from scldm_torch.sampling.size_factors import SizeFactorSampler
from scldm_torch.training import metrics as M
from scldm_torch.training.ema import ema_init, ema_update
from scldm_torch.training.optim import AdamW, wsd_schedule
from scldm_torch.training.state import TrainState, create_train_state
from scldm_torch.training.vae_task import (
    _algebraic_path_ok,
    _fused_window_ok,
    algebraic_decode,
    fused_window_pooling,
    gene_sp_decode,
)
from scldm_torch.transport import Sampler, Transport


def split_condition(batch: Dict, class_vocab_sizes: Dict[str, int]) -> Dict:
    """The batch's label columns: keys that name a class table."""
    return {k: v for k, v in batch.items()
            if k not in NON_CONDITION_KEYS and k in class_vocab_sizes}


class JointLDM(torch.nn.Module):
    """The train state's module under joint finetuning: the DiT and the VAE,
    whose parameters are named `dit.*` and `vae.*` in its state dict."""

    def __init__(self, dit: DiT, vae: TransformerVAE):
        super().__init__()
        self.dit = dit
        self.vae = vae


class LDMTask:
    """Holds the VAE, the DiT, the transport and the training
    settings (the JAX defaults: AdamW at 5e-4, betas (0.9, 0.999), no weight
    decay, clip 10, the cosine wsd schedule decaying over the whole run, EMA
    0.9999 every 10 steps after step 10,000).

    `fused_training=None` takes the kernel path on CUDA tensors where the
    DiT has no dropout (the JAX rule is "on a TPU, with DiT dropout 0"; the
    kernels do not drop), True on any device (on CPU tensors through the
    kernels' plain versions; a DiT with dropout raises), False never. With
    dropout the module path draws the blocks' masks from the step's
    generator (`layers.Drops.draw`), after the conditioning's draws.
    `fused_encode=None` resolves to False, as in JAX.

    `train_vae=True` finetunes the VAE jointly (JAX's `train_vae`): the
    VAE module the task holds is trained in place beside the DiT, both
    under one optimizer and one global-norm clip; `fused_training` and
    `fused_encode` resolve to False whatever was asked, as in JAX. The
    optimizer updates every parameter, as optax does: those the loss does
    not reach (the VAE's decoder and head) take a zero gradient, so the
    weight decay still moves them.

    The generation decode, as JAX resolves it: `algebraic_decode=None` takes
    `vae_task.algebraic_decode` at E > 128 where the architecture qualifies
    (`_algebraic_path_ok`), for the canonical gene row only;
    `algebraic_vw_fold=None` folds the output projection wherever that
    decode runs; `algebraic_fused_gate=True` (off unless asked) runs its
    SwiGLU through the `swiglu_vec` kernel.

    `pipeline_microbatches` on a "model" axis above 1 trains the DiT trunk
    as a GPipe pipeline (the module docstring); it raises JAX's ValueErrors
    at DiT dropout, at a layer count the stages do not divide, and beside
    `gene_sp`."""

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
        algebraic_decode: Optional[bool] = None,
        algebraic_vw_fold: Optional[bool] = None,
        algebraic_fused_gate: bool = False,
        train_vae: bool = False,
        mesh=None,
        fsdp: bool = False,
        gene_sp: bool = False,
        pipeline_microbatches: Optional[int] = None,
    ):
        self.vae = vae
        self.train_vae = bool(train_vae)
        self.dit = dit
        self.transport = transport
        self.transport_sampler = Sampler(transport)
        self.calculate_grad_norms = calculate_grad_norms
        if fused_training and dit.dropout > 0:
            raise ValueError(f"fused_training=True: the DiT kernels have no dropout, and this "
                             f"DiT's is {dit.dropout}")
        n_model = 1 if mesh is None else axis_size(mesh, "model")
        self.pipeline = int(pipeline_microbatches) if pipeline_microbatches and n_model > 1 else None
        if self.pipeline:
            if dit.dropout != 0.0:
                raise ValueError("pipeline_microbatches requires DiT dropout=0")
            if dit.n_layer % n_model:
                raise ValueError(f"DiT n_layer={dit.n_layer} must divide into {n_model} "
                                 "pipeline stages")
        self.gene_sp = bool(gene_sp) and n_model > 1
        if self.gene_sp and self.pipeline:
            raise ValueError("gene_sp and pipeline_microbatches both claim the mesh 'model' "
                             "axis: enable at most one")
        self.megatron = n_model > 1 and not (self.gene_sp or self.pipeline)
        self.layout = None if mesh is None else Layout(mesh, fsdp=fsdp, megatron=self.megatron)
        self._hops = Hops(mesh) if self.pipeline else None
        # the generation decode is gene-parallel under gene-SP and the pipeline, as JAX's
        self._sp = (GeneSP(self.layout.model_group, vae.decoder.n_genes)
                    if self.gene_sp or self.pipeline else None)
        # JAX's gates close under a multi-device mesh; the port's ranks run
        # one-card steps (under FSDP on the gathered weights, under the
        # pipeline each stage its blocks), so only gene-SP, whose NB softmax
        # spans the ranks, and Megatron, where no rank holds a block's
        # weights, close them
        self._closed = self.gene_sp or self.megatron
        self.fused_training = False if (self.train_vae or self._closed) else fused_training
        self.fused_encode = bool(fused_encode) and not (self.train_vae or self.megatron)
        if algebraic_decode is None:
            algebraic_decode = vae.decoder.n_embed > 128
        self.algebraic_decode = bool(algebraic_decode) and _algebraic_path_ok(vae)
        if algebraic_vw_fold is None:
            algebraic_vw_fold = self.algebraic_decode
        self.algebraic_vw_fold = bool(algebraic_vw_fold) and self.algebraic_decode
        self.algebraic_fused_gate = (bool(algebraic_fused_gate) and self.algebraic_decode
                                     and self._sp is None)
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
        """A fresh optimizer and EMA over `self.dit` (and with `train_vae` an
        optimizer over `self.vae` too, the state's module a `JointLDM`),
        whose modules keep the weights they hold; `generator` is the source
        of the steps' draws. The EMA covers the DiT alone. On a mesh every
        rank takes rank 0's weights and the model ranks of a data row its
        first one's generator state; under Megatron the DiT and the VAE are
        cut to each model rank's slices; under FSDP the optimizer updates the
        module's slices and its sharded tensors are emptied."""
        module = self.dit
        if self.train_vae:
            module = JointLDM(self.dit, self.vae.requires_grad_(True))
            if self.vae.encoder.pos_embed is not None:
                # the all-zeros positional table stays frozen (JAX stops its gradient)
                self.vae.encoder.pos_embed.requires_grad_(False)
        params, shards = trained_params(self.layout, module,
                                        *(() if self.train_vae else (self.vae,)))
        state = create_train_state(module, AdamW(params, **self._opt_kwargs), generator,
                                   ema=ema_init(self.dit.named_parameters()), shards=shards)
        if self.layout is not None:
            self.layout.share_draws_(state)
        if shards is not None:
            shards.free()
        return state

    @staticmethod
    def state_dit(state: TrainState) -> DiT:
        """The DiT of a train state (the module, or a `JointLDM`'s DiT)."""
        return state.module.dit if isinstance(state.module, JointLDM) else state.module

    @torch.no_grad()
    def _encode(self, batch: Dict, vae: Optional[TransformerVAE] = None) -> torch.Tensor:
        """Latents (B, M, E_latent) of the task's VAE (or of `vae`, JAX's
        `_encode_with`) from the expressed subsets (lean batches) or the full
        counts, in the VAE's compute dtype (the transport draws its noise in
        it, as JAX's); no gradient."""
        return self._encode_with_grad(batch, vae)

    def _encode_with_grad(self, batch: Dict, vae: Optional[TransformerVAE] = None
                          ) -> torch.Tensor:
        """`_encode` under the caller's gradient mode: the joint finetuning's
        encode, which the loss differentiates (no dropout, as JAX's)."""
        vae = self.vae if vae is None else vae
        batch = widen_lean(batch)
        counts = batch.get(COUNTS, batch.get(C_SUB))
        genes = batch.get(GENES, batch.get(G_SUB))
        if self.fused_encode and _fused_window_ok(vae):
            emb = vae.input_layer(batch.get(C_SUB, counts), batch.get(G_SUB, genes))
            return vae.encoder.trunk(fused_window_pooling(vae, emb))
        return vae.encode(counts, genes, batch.get(C_SUB), batch.get(G_SUB))

    def _use_fused(self, z: torch.Tensor) -> bool:
        if self.train_vae or self.pipeline:
            return False
        if self.fused_training is None:
            return z.is_cuda and self.dit.dropout == 0.0
        return self.fused_training

    def loss(self, batch: Dict, generator: torch.Generator,
             noise: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """Flow-matching loss of a batch on the DiT's current parameters
        (differentiable). The draws come from `generator`: the transport's
        noise x0 and times t, then the conditioning's class choice and CFG
        drop mask, then (with DiT dropout) the blocks' dropout seed. `noise`
        may inject any of them ({"t", "x0"} together, "selected",
        "drop_mask", "drops": a `layers.Drops`)."""
        noise = noise or {}
        z = self._encode_with_grad(batch) if self.train_vae else self._encode(batch)
        condition = split_condition(batch, self.dit.class_vocab_sizes)
        draws = {k: noise[k] for k in ("selected", "drop_mask", "drops") if k in noise}
        fused = self._use_fused(z)

        def model_fn(xt, t, condition):
            if fused or self.pipeline:
                t_emb = self.dit.embed_condition(t, condition, generator, train=True,
                                                 selected=draws.get("selected"),
                                                 drop_mask=draws.get("drop_mask"))
                if self.pipeline:
                    return pipeline_dit_apply(self.dit, xt, t_emb, hops=self._hops,
                                              group=self.layout.model_group,
                                              n_micro=self.pipeline)
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
        device). `noise` as in `loss`. Under FSDP the full weights are
        gathered for the forward and backward. Under the pipeline every rank
        computes the loss and runs the backward, whose seed is 1 on the last
        stage and 0 elsewhere: the loss is taken once, where the last block
        ran (`parallel.pipeline`)."""
        state.optimizer.zero_grad(set_to_none=True)
        if state.shards is not None:
            state.shards.gather()
        loss = self.loss(batch, state.generator, noise)
        seed = None
        if self.pipeline:
            seed = torch.full_like(loss, float(self._hops.stage == self._hops.stages - 1))
        loss.backward(seed)
        return state, self.apply_gradients(state, {"train_loss": loss.detach()})

    def apply_gradients(self, state: TrainState, metrics: Optional[Dict] = None
                        ) -> Dict[str, torch.Tensor]:
        """The step after the backward: on a mesh the gradients' reduction
        (and `metrics`' means over "data"), the global-norm clip of the
        gradients, the optimizer step on the schedule and the EMA tick.
        Updates `state` in place and returns `metrics` with grad_norm,
        lr_mult and, with `calculate_grad_norms`, the per-module norms.
        Under `train_vae` a parameter the loss did not reach takes a zero
        gradient, so the optimizer updates it as optax updates every leaf."""
        if self.train_vae:
            for p in state.module.parameters():
                if p.requires_grad and p.grad is None:
                    p.grad = torch.zeros_like(p)
        metrics, named, norm = step_gradients(self.layout, state, metrics,
                                              sum_over_model=bool(self.pipeline))
        grads = [g for _, g in named]
        gnorm = norm(grads)
        torch._foreach_mul_(grads, torch.clamp(self.grad_clip / (gnorm + 1e-12), max=1.0))
        lr_mult = self.schedule(state.step)
        state.optimizer.step()
        state.step += 1
        blend = (state.ema.step + 1) % self.ema_cfg["update_every"] == 0
        with full_weights(self.layout, state) if blend else contextlib.nullcontext():
            state.ema = ema_update(state.ema, self.state_dit(state).named_parameters(),
                                   **self.ema_cfg)
        metrics.update(grad_norm=gnorm.detach(), lr_mult=torch.tensor(lr_mult, device=gnorm.device))
        if self.calculate_grad_norms:
            metrics.update(M.grad_norms_by_module(named, prefix="grad_norm/diffusion", norm=norm))
        return metrics

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
        weights, without CFG dropout (the encode under `train_vae` with the
        finetuned VAE); draws and `noise` as in `loss`."""
        with full_weights(self.layout, state):
            return self._eval_step(state, batch, generator, use_ema, noise or {})

    def _eval_step(self, state, batch, generator, use_ema, noise):
        z = self._encode(batch)
        condition = split_condition(batch, self.dit.class_vocab_sizes)
        dit = self.ema_module(state) if use_ema else self.state_dit(state)

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
        fused_blocks: bool = True,
        split_over_data: bool = False,
    ):
        """Returns fn(generator, genes, condition=None, batch_size=None,
        state=None) -> (counts (2B, G), z (2B, M, E_latent)): the first half
        unconditional, the second half guided (the reference's doubled-batch
        convention). Without `state` the DiT module's weights sample; with a
        train state, its EMA weights (or, with `use_ema=False`, its DiT's).
        The decode runs on the task's VAE, which under `train_vae` is the
        finetuned one.

        `genes` is (G,) (shared by the batch; the canonical row takes the
        decoder's batch-free path) or (B, G). Every draw comes from
        `generator`, which lives on the modules' device. With `fused_blocks`
        every DiT block of a dropout-free DiT runs through
        `ops.fused_dit.dit_block` (the CUDA kernel on a GPU); otherwise (JAX's
        gate closes at any DiT dropout) the denoiser is the module path,
        `DiT.forward_with_cfg_batched`. After each call `fn.drift_evals`
        holds the number of DiT evaluations it made. The counts are NB
        draws: a Gaussian-head VAE, which has no theta, raises at the call.

        On a mesh with `split_over_data` every rank passes the same global
        batch and draws the same noise; each data rank integrates its block
        of rows (dopri5's error norm taken over every rank's rows, so all
        take JAX's steps) and the rows are gathered back before the NB draw,
        so every rank returns the whole batch. A batch the data axis does not
        divide runs whole on every rank (JAX leaves it replicated). Under
        FSDP the state's full weights are gathered for the call."""
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
            if isinstance(self.vae.decoder_head, GaussianTransformerHead):
                raise ValueError("generation draws negative-binomial counts, and this VAE's "
                                 "Gaussian head has no theta")
            device = generator.device
            log_sf = size_factor_sampler.sample(generator, condition, batch_size, device)
            z0 = torch.randn((batch_size, seq_len, latent), generator=generator, device=device)
            layout = self.layout
            split = (split_over_data and layout is not None and layout.n_data > 1
                     and batch_size % layout.n_data == 0)
            if split:
                b = batch_size // layout.n_data
                rows = slice(layout.data_rank * b, (layout.data_rank + 1) * b)
                z0, log_sf = z0[rows], log_sf[rows]
                condition = {k: v[rows] for k, v in condition.items()} if condition else condition
                genes = genes[rows] if genes.ndim == 2 else genes
            with full_weights(layout, state):
                samples, out, fn.drift_evals = self.generate_from_noise(
                    z0, log_sf, genes, condition,
                    guidance_weight=guidance_weight, sampling_method=sampling_method,
                    num_steps=num_steps,
                    dit=None if state is None else (
                        self.ema_module(state) if use_ema else self.state_dit(state)),
                    fused_blocks=fused_blocks,
                    error_mean=layout.data_mean if split else None,
                )
            if split:
                def gather(x):  # [uncond rows; cond rows] of every rank, in rank order
                    return torch.cat([layout.gather_rows(x[:b]), layout.gather_rows(x[b:])])

                samples = gather(samples)
                out = {k: gather(v) if k == "mu" or v.ndim == 2 else v for k, v in out.items()}
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
        fused_blocks: bool = True,
        error_mean=None,
    ):
        """The deterministic part of sampling, from given noise and size
        factors, with `dit` (default the task's): returns (samples (2B, M,
        E_latent), {"mu", "theta"}, number of DiT evaluations). The decode
        takes `vae_task.algebraic_decode` where the task resolved it on and
        `genes` is the canonical row 1..G (checked on the host, once per
        call), the module decode otherwise; under gene-SP each "model" rank
        decodes its genes and the ranks' genes are gathered. `error_mean`
        is dopri5's mean in its error norm (`Sampler.sample_ode`)."""
        sample_ode = self.transport_sampler.sample_ode(
            sampling_method=sampling_method, num_steps=num_steps, error_mean=error_mean
        )
        dit = self.dit if dit is None else dit
        fused_blocks = self._fused_sampler(dit, fused_blocks) and not self._closed
        z_cfg = torch.cat([z0, z0]).float()
        condition_cfg = {k: torch.cat([v, v]) for k, v in condition.items()} if condition else None
        block_params = [extract_block_params(b) for b in dit.blocks] if fused_blocks else None
        evals = 0

        def model_fn(x, t, condition=None):
            nonlocal evals
            evals += 1
            if not fused_blocks:
                return dit.forward_with_cfg_batched(x, t, condition, guidance_weight)
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
        sf_cfg = torch.cat([sf, sf])
        sp = self._sp
        if self._decode_is_algebraic(genes):
            out = algebraic_decode(self.vae, samples, sf_cfg, fused_gate=self.algebraic_fused_gate,
                                   vw_fold=self.algebraic_vw_fold,
                                   **({} if sp is None else {"gene_sp": sp}))
        elif sp is not None:
            out = gene_sp_decode(self.vae, samples, genes_cfg, sf_cfg, sp)
        else:
            out = self.vae.decode(samples, genes_cfg, sf_cfg)
        if sp is not None:
            out = {k: sp.gather(v, -1) for k, v in out.items()}
        return samples, out, evals

    @staticmethod
    def _fused_sampler(dit: DiT, fused_blocks: bool) -> bool:
        """JAX's sampler gate: the block kernels, where asked, for a DiT
        without dropout (the kernels do not drop)."""
        return bool(fused_blocks) and dit.dropout == 0.0

    def _decode_is_algebraic(self, genes: torch.Tensor) -> bool:
        """The algebraic decode reads the whole canonical gene table as its
        queries: route to it only when `genes` is that row, 1..G."""
        n_genes = self.vae.decoder.n_genes
        return bool(
            self.algebraic_decode
            and genes.ndim == 1
            and genes.shape[0] == n_genes
            and torch.equal(genes.cpu(), torch.arange(1, n_genes + 1, dtype=genes.dtype))
        )
