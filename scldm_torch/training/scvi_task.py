"""scVI-baseline training task (counterpart of scldm_tpu/training/scvi_task.py;
the reference's models.VAEScvi).

A true VAE: a Gaussian posterior with the reparameterised latent, and the
ELBO = the NB reconstruction NLL + kl_weight * (log q(z|x) - log p(z)) at
the sampled z. The MLPs' BatchNorm buffers live in the module, so the
state's checkpoint carries them (JAX keeps them as `batch_stats` in
`TrainState.extra`). It follows the port's task protocol (`init_state`,
`train_step`, `train_steps`, `eval_step`), so `training.loop.fit` and
`validate` drive it unchanged. The step's draws (eps, the dropout masks)
come from the state's generator, so a resumed run repeats an uninterrupted
one; `noise` injects them (`nn.vae.ScviVAE`).

JAX computes the scVI MLP in plain XLA (no Pallas kernel lies under it), so
the port computes it in plain PyTorch.

On a mesh (`parallel.make_mesh`) the steps are data-parallel over "data" as
the VAE task's: the initial weights from rank 0, the gradients averaged
over "data" before the clip, the metrics the global means. JAX's BatchNorm
under a mesh normalises by the global batch's statistics, so the port's
BatchNorm layers all-reduce their row sums over "data" (`nn.nnets.BatchNorm`'s
`group`). JAX replicates the scVI state on any mesh, so a "model" axis only
repeats the work.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from scldm_torch.nn.nnets import BatchNorm
from scldm_torch.nn.priors import StandardPrior
from scldm_torch.nn.vae import ScviVAE
from scldm_torch.ops.distributions import log_nb_positive, nb_sample, normal_log_prob
from scldm_torch.ops.transforms import (
    COUNTS,
    COUNTS_SUBSET as C_SUB,
    GENES_SUBSET as G_SUB,
    LIBRARY_SIZE as LIB,
    densify_expressed,
    widen_lean,
)
from scldm_torch.parallel.data_parallel import Layout, step_gradients, trained_params
from scldm_torch.training import metrics as M
from scldm_torch.training.optim import AdamWLegacy, wsd_schedule
from scldm_torch.training.state import TrainState, create_train_state


class ScviTask:
    def __init__(
        self,
        vae: ScviVAE,
        *,
        n_latent: int,
        kl_weight: float = 1.0,
        learning_rate: float = 1e-3,
        betas: Tuple[float, float] = (0.9, 0.95),
        weight_decay: float = 0.0,
        grad_clip: float = 10.0,
        num_training_steps: int = 10_000,
        num_warmup_steps: Optional[int] = None,
        decay_type: str = "sqrt",
        fract_decay: float = 0.1,
        mesh=None,
    ):
        self.vae = vae
        self.layout = None if mesh is None else Layout(mesh)
        if self.layout is not None and self.layout.n_data > 1:
            for m in vae.modules():
                if isinstance(m, BatchNorm):
                    m.group = self.layout.data_group
        self.prior = StandardPrior(n_latent)
        self.kl_weight = kl_weight
        self.grad_clip = grad_clip
        if num_warmup_steps is None:
            num_warmup_steps = max(1, int(0.1 * num_training_steps))
        self.schedule = wsd_schedule(
            num_training_steps=num_training_steps,
            num_warmup_steps=num_warmup_steps,
            decay_type=decay_type,
            fract_decay=fract_decay,
        )
        self._opt_kwargs = dict(learning_rate=learning_rate, schedule=self.schedule,
                                betas=betas, weight_decay=weight_decay)

    def init_state(self, generator: torch.Generator) -> TrainState:
        """A fresh optimizer over `self.vae`, whose module keeps the weights
        and BatchNorm buffers it holds (on a mesh, rank 0's); `generator` is
        the steps' draws."""
        params, _ = trained_params(self.layout, self.vae)
        return create_train_state(self.vae, AdamWLegacy(params, **self._opt_kwargs), generator)

    def _materialize(self, batch: Dict) -> Dict:
        """Widen the uint16 wire format; rebuild the dense counts (and the
        library where the lean batch lacks it) from the expressed subsets."""
        batch = widen_lean(batch)
        if COUNTS in batch:
            return batch
        counts = densify_expressed(batch[G_SUB], batch[C_SUB], self.vae.decoder_head.n_genes)
        out = dict(batch)
        out[COUNTS] = counts
        if LIB not in out:
            out[LIB] = counts.sum(1, keepdim=True)
        return out

    def _elbo(self, out: Dict, posterior, z: torch.Tensor, counts: torch.Tensor):
        """(the NB NLL summed over genes, kl_weight * (log q - log p) summed
        over the latent), each averaged over the cells."""
        loc, scale = posterior
        recon = -log_nb_positive(counts, out["mu"], out["theta"])
        kl = self.kl_weight * (normal_log_prob(z, loc, scale) - self.prior.log_prob(z))
        return recon.sum(1).mean(), kl.sum(1).mean()

    def loss(self, batch: Dict, generator: torch.Generator,
             noise: Optional[Dict] = None) -> Tuple[torch.Tensor, Dict]:
        """The training ELBO of a batch on the module's current parameters
        (differentiable; the BatchNorm buffers move), and its aux metrics."""
        batch = self._materialize(batch)
        out, posterior, z = self.vae(batch[COUNTS], batch[LIB], train=True,
                                     generator=generator, noise=noise)
        llh, kl = self._elbo(out, posterior, z, batch[COUNTS])
        return llh + kl, {"train_llh": llh.detach(), "train_kl": kl.detach(),
                          "train_theta": out["theta"].detach().mean()}

    def train_step(self, state: TrainState, batch: Dict,
                   noise: Optional[Dict] = None) -> Tuple[TrainState, Dict]:
        """One optimizer step: the ELBO's backward, the global-norm clip,
        AdamWLegacy on the schedule. Updates `state` in place and returns it
        with JAX's metrics (0-d tensors on the batch's device)."""
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = self.loss(batch, state.generator, noise)
        loss.backward()
        mets, named, norm = step_gradients(self.layout, state, {"train_loss": loss.detach(), **aux})
        grads = [g for _, g in named]
        gnorm = norm(grads)
        torch._foreach_mul_(grads, torch.clamp(self.grad_clip / (gnorm + 1e-12), max=1.0))
        state.optimizer.step()
        state.step += 1
        return state, mets

    def train_steps(self, state: TrainState, stacked: Dict) -> Tuple[TrainState, Dict]:
        """K steps, one per slice of the leading axis of `stacked`'s leaves;
        returns the metrics' means over the K steps."""
        k = next(iter(stacked.values())).shape[0]
        runs = []
        for i in range(k):
            state, mets = self.train_step(state, {key: v[i] for key, v in stacked.items()})
            runs.append(mets)
        return state, {key: torch.stack([m[key] for m in runs]).mean() for key in runs[0]}

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Dict, generator: torch.Generator,
                  noise: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        """Validation metrics in evaluation mode (running averages, no
        dropout): the ELBO at a sampled z, then counts drawn from the NB
        against the true ones on log1p-CPM by the true library. The draws
        (eps, then the counts) come from `generator`; `noise` may give
        "eps" and "counts_pred"."""
        noise = noise or {}
        batch = self._materialize(batch)
        counts = batch[COUNTS]
        out, posterior, z = state.module(counts, batch[LIB], generator=generator, noise=noise)
        llh, kl = self._elbo(out, posterior, z, counts)
        counts_pred = noise.get("counts_pred")
        if counts_pred is None:
            counts_pred = nb_sample(out["mu"], out["theta"], generator)
        lib = counts.sum(1, keepdim=True)
        pred_scaled = torch.log1p(counts_pred / lib * 10_000.0)
        true_scaled = torch.log1p(counts / lib * 10_000.0)
        return {
            "val_loss": llh + kl,
            "val_llh": llh,
            "val_kl": kl,
            "val_zeros_accuracy": M.zeros_accuracy(counts_pred, counts),
            "val_mse": M.mse(pred_scaled, true_scaled),
            "val_pcc": M.nanmean(M.pearson_corrcoef(pred_scaled, true_scaled)),
        }

    @torch.no_grad()
    def sample(self, state: TrainState, generator: torch.Generator,
               library_size: torch.Tensor) -> torch.Tensor:
        """Prior sampling to NB counts: z ~ N(0, I), the decode in evaluation
        mode, then counts drawn from the NB, all from `generator`."""
        z = self.prior.sample(generator, library_size.shape[0])
        out = state.module.decode(z, library_size)
        return nb_sample(out["mu"], out["theta"], generator)
