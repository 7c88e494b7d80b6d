"""VAE training task (counterpart of scldm_tpu/training/vae_task.py): the NB
reconstruction loss, the training step (loss, backward, global-norm clip,
AdamWLegacy on the wsd schedule) and the validation metrics.

On the lean wire batch (expressed genes and counts only, uint16) the step
decodes every gene through the fused decoder tail
(`ops/fused_decoder.decoder_tail`: hand-written CUDA kernels, forward and
backward, on a GPU), as the JAX task does on a TPU; otherwise it runs the
plain module path.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from scldm_torch.nn.heads import NegativeBinomialTransformerHead
from scldm_torch.nn.vae import TransformerVAE
from scldm_torch.ops.distributions import log_nb_positive, nb_sample
from scldm_torch.ops.fused_decoder import build_attention_operands, decoder_tail, pack_weights
from scldm_torch.ops.transforms import (
    COUNTS,
    COUNTS_SUBSET as C_SUB,
    GENES,
    GENES_SUBSET as G_SUB,
    LIBRARY_SIZE as LIB,
    canonical_gene_ids,
    densify_expressed,
    log1p_cpm,
    widen_lean,
)
from scldm_torch.training import metrics as M
from scldm_torch.training.optim import AdamWLegacy, wsd_schedule
from scldm_torch.training.state import TrainState, create_train_state


def _fused_path_ok(vae: TransformerVAE) -> bool:
    """Whether `fused_nb_apply` computes what the module path computes: the
    JAX gate. The ported VAE is always the shared-embedding, shared-theta,
    dropout-free decoder it asks for; the tail omits the qkv biases, and at
    E > 128 the JAX task leaves the tail for its algebraic path. A width the
    CUDA kernels are not compiled for (`ops/fused_decoder.KERNEL_SHAPES`)
    passes this gate and raises at launch: it never quietly takes the module
    path instead."""
    return (
        isinstance(vae.decoder_head, NegativeBinomialTransformerHead)
        and vae.decoder.decoder_cross_attention.attn.c_attn.bias is None
        and vae.decoder.n_embed <= 128
    )


def fused_nb_apply(
    vae: TransformerVAE, batch: Dict, batch_chunk: Optional[int] = None
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """`TransformerVAE.forward` with the decoder's cross block and the NB
    head's mu logit as the fused tail, over the canonical gene list 1..G:
    the encoder and the decoder's trunk run as modules; no (B, G, E) tensor
    is formed. `batch_chunk` splits the tail into launches over batch slices
    of that size. Differentiable end to end. Returns ({"mu", "theta"}, h_z)."""
    h_z = vae.encoder(vae.input_layer(batch[C_SUB], batch[G_SUB]))
    x = vae.decoder.trunk(h_z)  # (B, M, E) pre-cross latents

    ca = vae.decoder.decoder_cross_attention
    head = vae.decoder_head
    n_head = ca.attn.n_head
    q = vae.input_layer.gene_embedding.weight[1:].float()  # canonical genes 1..G
    qp = ca.attn.c_attn_q(ca.ln_1q(q)).contiguous()
    k, v = ca.attn.c_attn(ca.ln_1(x.float())).chunk(2, dim=-1)
    kfull, vproj = build_attention_operands(k, v, ca.attn.c_proj.weight.t().float(), n_head)
    weights = pack_weights(
        ca.ln_2.weight, ca.ln_2.bias, ca.mlp.w1.weight.t(), ca.mlp.w2.weight.t(),
        ca.mlp.c_proj.weight.t(), head.params.weight.t(), head.params.bias,
    )
    eps = ca.ln_1.eps
    B = kfull.shape[0]
    if batch_chunk and B > batch_chunk:
        logits = torch.cat([
            decoder_tail(qp, q, kfull[lo : lo + batch_chunk], vproj[lo : lo + batch_chunk],
                         weights, n_head, eps)
            for lo in range(0, B, batch_chunk)
        ])
    else:
        logits = decoder_tail(qp, q, kfull, vproj, weights, n_head, eps)  # (B, G) f32

    theta = torch.exp(head.theta.weight[1:, 0].float())  # (G,)
    mu = torch.softmax(logits, dim=1) * batch[LIB]
    return {"mu": mu, "theta": theta}, h_z


def vae_loss(counts: torch.Tensor, params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """NB reconstruction loss, summed over genes, averaged over the batch."""
    return (-log_nb_positive(counts, params["mu"], params["theta"])).sum(dim=1).mean()


def validation_metrics(
    counts: torch.Tensor, out: Dict[str, torch.Tensor], counts_pred: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """The reference's validation metrics from the true counts, the head's
    parameters and counts drawn from them."""
    loss = vae_loss(counts, out)
    pred_scaled, true_scaled = log1p_cpm(counts_pred), log1p_cpm(counts)
    return {
        "val_loss": loss,
        "val_llh": loss,
        "val_theta": out["theta"].mean(),
        "val_zeros_accuracy": M.zeros_accuracy(counts_pred, counts),
        "val_mse": M.mse(pred_scaled, true_scaled),
        "val_pcc": M.nanmean(M.pearson_corrcoef(pred_scaled, true_scaled)),
    }


class VAETask:
    """Owns the model's optimizer settings and the steps; the state carries
    the parameters (in the module), the optimizer state and the step.

    `fused_decoder=None` takes the kernel path wherever the batch is a lean
    batch of CUDA tensors and the architecture qualifies (`_fused_path_ok`);
    True takes it on any device where the architecture qualifies (on CPU
    tensors through the plain version of the kernels), False never. `fused_batch_chunk` splits the tail into
    launches over batch slices of that size; the CUDA kernels have no batch
    ceiling, so nothing splits them unless asked."""

    def __init__(
        self,
        vae: TransformerVAE,
        *,
        learning_rate: float = 1e-3,
        betas: Tuple[float, float] = (0.9, 0.95),
        weight_decay: float = 0.0,
        caution: bool = False,
        grad_clip: float = 10.0,
        num_training_steps: int = 10_000,
        num_warmup_steps: Optional[int] = None,
        final_lr_factor: float = 0.1,
        init_div_factor: float = 100,
        fract_decay: float = 0.1,
        decay_type: str = "sqrt",
        calculate_grad_norms: bool = False,
        fused_decoder: Optional[bool] = None,
        fused_batch_chunk: Optional[int] = None,
    ):
        self.vae = vae
        self.calculate_grad_norms = calculate_grad_norms
        self.fused_decoder = fused_decoder if fused_decoder is None else bool(fused_decoder)
        self.fused_batch_chunk = fused_batch_chunk
        if num_warmup_steps is None:
            num_warmup_steps = max(1, int(0.1 * num_training_steps))
        self.schedule = wsd_schedule(
            num_training_steps=num_training_steps,
            final_lr_factor=final_lr_factor,
            num_warmup_steps=num_warmup_steps,
            init_div_factor=init_div_factor,
            fract_decay=fract_decay,
            decay_type=decay_type,
        )
        self.grad_clip = grad_clip
        self._opt_kwargs = dict(learning_rate=learning_rate, schedule=self.schedule, betas=betas,
                                weight_decay=weight_decay, caution=caution)

    # -- state -----------------------------------------------------------------
    def init_state(self, generator: torch.Generator) -> TrainState:
        """A fresh optimizer state over `self.vae`, whose module keeps the
        weights it holds (draw them with `utils.weights.init_reference_`, or
        load them); `generator` is the state's source of random draws."""
        params = [p for p in self.vae.parameters() if p.requires_grad]
        return create_train_state(self.vae, AdamWLegacy(params, **self._opt_kwargs), generator)

    # -- dispatch --------------------------------------------------------------
    def _materialize(self, batch: Dict) -> Dict:
        """Widen the uint16 wire format; rebuild the dense counts and the
        canonical gene list when the batch carries only the expressed subsets."""
        batch = widen_lean(batch)
        if COUNTS in batch:
            return batch
        n_genes = self.vae.decoder.n_genes
        counts = densify_expressed(batch[G_SUB], batch[C_SUB], n_genes)
        out = dict(batch)
        out[COUNTS] = counts
        # 1-D genes: the decoder's batch-free query path
        out[GENES] = canonical_gene_ids(n_genes, device=counts.device)
        if LIB not in out:
            out[LIB] = counts.sum(1, keepdim=True)
        return out

    def _apply(self, batch: Dict) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """The module path: `TransformerVAE.forward`."""
        return self.vae(
            counts=batch[COUNTS],
            genes=batch[GENES],
            library_size=batch[LIB],
            counts_subset=batch.get(C_SUB, batch[COUNTS]),
            genes_subset=batch.get(G_SUB, batch[GENES]),
        )

    def _use_fused(self, batch: Dict) -> bool:
        """The kernel path needs a lean batch (the canonical gene list) and an
        eligible architecture; with `fused_decoder=None`, CUDA tensors too."""
        if self.fused_decoder is False or COUNTS in batch or C_SUB not in batch:
            return False
        if not _fused_path_ok(self.vae):
            return False
        return self.fused_decoder is True or batch[C_SUB].is_cuda

    # -- steps -----------------------------------------------------------------
    def loss(self, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        """Reconstruction loss of a batch on the module's current parameters
        (differentiable), and its aux metrics."""
        use_fused = self._use_fused(batch)
        batch = self._materialize(batch)
        if use_fused:
            out, _ = fused_nb_apply(self.vae, batch, batch_chunk=self.fused_batch_chunk)
        else:
            out, _ = self._apply(batch)
        loss = vae_loss(batch[COUNTS], out)
        return loss, {"llh": loss.detach(), "theta": out["theta"].detach().mean()}

    def train_step(self, state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        """One optimizer step; updates `state` in place and returns it with the
        step's metrics (0-d tensors on the batch's device)."""
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = self.loss(batch)
        loss.backward()
        return state, {"train_loss": loss.detach(), "train_llh": aux["llh"],
                       "train_theta": aux["theta"], **self.apply_gradients(state)}

    def apply_gradients(self, state: TrainState) -> Dict:
        """The step after the backward: the global-norm clip of the module's
        gradients and the optimizer step on the schedule. Updates `state` in
        place and returns grad_norm, lr_mult and, with
        `calculate_grad_norms`, the per-module norms."""
        named = [(n, p.grad) for n, p in state.module.named_parameters() if p.grad is not None]
        grads = [g for _, g in named]
        # one global-norm pass shared by the clip and the metric
        gnorm = M.global_norm(grads)
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-12), max=1.0)
        torch._foreach_mul_(grads, scale)
        lr_mult = self.schedule(state.step)
        state.optimizer.step()
        state.step += 1
        mets = {"grad_norm": gnorm.detach(), "lr_mult": torch.tensor(lr_mult, device=gnorm.device)}
        if self.calculate_grad_norms:
            mets.update(M.grad_norms_by_module(named))
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
    def eval_step(self, state: TrainState, batch: Dict, generator: torch.Generator) -> Dict:
        """Validation metrics on the module path; the NB draw comes from
        `generator` (on the batch's device)."""
        batch = self._materialize(batch)
        out, _ = self._apply(batch)
        return validation_metrics(batch[COUNTS], out, nb_sample(out["mu"], out["theta"], generator))

    @torch.no_grad()
    def encode(self, batch: Dict) -> torch.Tensor:
        """Latents of a batch from the expressed subsets (or the full counts)."""
        batch = widen_lean(batch)
        counts = batch.get(C_SUB, batch.get(COUNTS))
        genes = batch.get(G_SUB, batch.get(GENES))
        if counts is None or genes is None:
            raise KeyError("encode needs counts/genes or counts_subset/genes_subset in the batch")
        return self.vae.encode(counts, genes)
