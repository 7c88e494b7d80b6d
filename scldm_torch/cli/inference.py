"""Generation and latent-inference entry point (counterpart of
scldm_tpu/cli/inference.py; the reference's experiments/scripts/inference.py).

Three modes, chosen by the config:
- `generation_args` set (configs/generation.yaml): sample cells with CFG
  from the trained LDM and write {dataset}_generated_0.h5ad, the
  unconditional half first (an LDM trained with `vae_as_tokenizer.train`
  decodes with the finetuned VAE its checkpoint carries);
- `inference_args` set (configs/inference.yaml): encode (and reconstruct)
  the test set or an external AnnData (`adata_inference`, gene-filtered to
  the vocabulary) and write {dataset}_inference_{i}.h5ad with z in obsm;
- `vae_only=true`: encode and reconstruct with the VAE alone (no LDM
  checkpoint needed).

One process a card (`device`, default cuda), one or several under torchrun.
With several, `n_model` (default 1) must divide the world, as JAX's must
divide its devices; the ranks form a (world / n_model, n_model) mesh, and
`n_model > 1` sets `training.gene_sp`: each "model" rank decodes a range of
the genes (never Megatron tensor parallelism, as in JAX). The data ranks
split each generation batch and gather it back (`make_sample_fn
(split_over_data=True)`); rank 0 writes the h5ad files. The encode paths
(`inference_args`, `vae_only`) run on rank 0 alone. One process with
`n_model=2` exits with JAX's message.
"""

from __future__ import annotations

import copy
from pathlib import Path

import numpy as np
import torch

from scldm_torch.cli._common import parse_config, setup_device
from scldm_torch.cli.train_ldm import load_vae_from_checkpoint
from scldm_torch.config.build import (
    build_datamodule,
    build_dit,
    build_ldm_task,
    build_vocabulary_encoder,
)
from scldm_torch.ops.distributions import nb_sample
from scldm_torch.ops.transforms import COUNTS, NON_CONDITION_KEYS
from scldm_torch.parallel import make_mesh, maybe_initialize_distributed, rank, world_size
from scldm_torch.sampling.size_factors import SizeFactorSampler
from scldm_torch.training.checkpoint import CheckpointManager
from scldm_torch.training.loop import to_device
from scldm_torch.utils.logger import logger
from scldm_torch.utils.output import (
    create_anndata_from_inference_output,
    process_generation_output,
)

DEFAULT_CONFIG = Path(__file__).resolve().parents[2] / "configs" / "generation.yaml"


def gene_row(genes: np.ndarray) -> np.ndarray:
    """(B, G) genes as one (G,) row where every cell carries the same row
    (as the DataModule's CSR batches do), which takes the decoder's
    batch-free query path, the same function; else unchanged."""
    if genes.ndim == 2 and len(genes) and (genes == genes[:1]).all():
        return genes[0]
    return genes


def device_batch(batch: dict, device) -> dict:
    """The batch as tensors on `device`; where the encoder reads the
    expressed subsets, the genes as `gene_row` gives them."""
    if "genes_subset" in batch:
        batch = {**batch, "genes": gene_row(batch["genes"])}
    return to_device(batch, device)


def main(argv=None) -> int:
    cfg = parse_config(argv, DEFAULT_CONFIG, __doc__)
    maybe_initialize_distributed(cfg.get("device") or "cuda")
    world = world_size()
    n_model = int(cfg.get("n_model") or 1)
    if world % max(n_model, 1):
        raise SystemExit(f"n_model={n_model} must divide the device count {world}")
    device = setup_device(cfg)
    if device.type == "cuda" and world > 1:
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(n_data=world // n_model, n_model=n_model) if world > 1 else None
    if mesh is not None:
        logger.info(f"inference mesh: {mesh}")

    vocab = build_vocabulary_encoder(cfg)
    datamodule = build_datamodule(cfg, vocab)
    if cfg.get("adata_inference"):
        datamodule.allow_missing_train = True
        datamodule.adata_inference = cfg["adata_inference"]
    datamodule.setup("predict")

    # the frozen VAE, and (unless vae_only) the LDM state: DiT and EMA
    vae = load_vae_from_checkpoint(cfg)
    out_dir = Path(cfg["paths"]["inference_path"])
    out_dir.mkdir(parents=True, exist_ok=True)
    dataset = cfg["datamodule"]["dataset"]
    if cfg.get("vae_only"):
        if rank() != 0:
            return 0
        return _vae_inference(vae, datamodule, vocab, out_dir, dataset, device)

    dit = build_dit(cfg)
    if mesh is not None and n_model > 1:
        # n_model means the gene-SP decode here, never Megatron TP (JAX's rule)
        cfg["training"]["gene_sp"] = True
    task = build_ldm_task(cfg, vae, dit, max_steps=1, mesh=mesh)
    # under vae_as_tokenizer.train the LDM checkpoint carries the finetuned
    # VAE, which the restore loads into `vae` for generation; the encode
    # path keeps the VAE checkpoint's weights, as JAX's (`task.vae_params`)
    frozen_vae = copy.deepcopy(vae) if task.train_vae else vae
    mgr = CheckpointManager(cfg["checkpoint_dir"])
    state = mgr.restore(task.init_state(torch.Generator(device).manual_seed(0)))
    mgr.close()

    gen_args = cfg.get("generation_args")
    if gen_args:
        sfs = SizeFactorSampler(vocab)
        gw = gen_args.get("guidance_weight")
        if isinstance(gw, (int, float)):  # a scalar override -> every class
            gw = {name: float(gw) for name in (dit.class_vocab_sizes or {})}
        sample_fn = task.make_sample_fn(
            sfs,
            guidance_weight=gw,
            sampling_method=gen_args.get("sampling_method", "dopri5"),
            num_steps=int(gen_args.get("timesteps", 50)),
            use_ema=bool(gen_args.get("use_ema", True)),
            split_over_data=True,
        )
        batches = []
        n_batches = int(gen_args.get("n_batches", 4))
        for i, batch in enumerate(datamodule.predict_batches()):
            if i >= n_batches:
                break
            condition = to_device({
                k: v for k, v in batch.items()
                if k not in NON_CONDITION_KEYS and k in vocab.class_vocab_sizes
            }, device)
            genes = to_device({"genes": gene_row(batch["genes"])}, device)["genes"]
            half = len(batch["library_size"])
            counts, z = sample_fn(torch.Generator(device).manual_seed(1000 + i), genes,
                                  condition, batch_size=half, state=state)
            counts, z = counts.cpu().numpy(), z.cpu().numpy()
            out = dict(batch)
            out[f"{COUNTS}_generated_unconditional"] = counts[:half]
            out[f"{COUNTS}_generated_conditional"] = counts[half:]
            out["z_generated_unconditional"] = z[:half].reshape(half, -1)
            out["z_generated_conditional"] = z[half:].reshape(half, -1)
            batches.append(out)
            logger.info(f"generated batch {i + 1}/{n_batches}")
        if rank() == 0:
            path = process_generation_output(batches, vocab, out_dir, dataset=dataset)
            logger.info(f"wrote {path}")
        return 0

    if rank() != 0:
        return 0
    inf_args = cfg.get("inference_args") or {}
    for i, batch in enumerate(datamodule.predict_batches()):
        dev = device_batch(batch, device)
        z = task._encode(dev, frozen_vae)
        outputs = {"z": z.float().cpu().numpy()}  # in the VAE's dtype: numpy has no bf16
        if inf_args.get("reconstruct", True):
            with torch.no_grad():
                out = frozen_vae.decode(z, dev["genes"], dev["library_size"])
            if "theta" not in out:  # JAX's reconstruct draws NB counts
                raise ValueError("the LDM path reconstructs NB counts, and this VAE's Gaussian "
                                 "head has no theta; set inference_args.reconstruct=false")
            outputs["reconstructed_counts"] = nb_sample(
                out["mu"], out["theta"], torch.Generator(device).manual_seed(i)).cpu().numpy()
        else:
            outputs["reconstructed_counts"] = np.asarray(batch[COUNTS])
        for k, v in batch.items():
            if k not in NON_CONDITION_KEYS:
                outputs[k] = np.asarray(v)
        path = create_anndata_from_inference_output(
            outputs, vocab, out_dir, dataset=dataset, index=i
        )
        logger.info(f"wrote {path}")
    return 0


@torch.no_grad()
def _vae_inference(vae, datamodule, vocab, out_dir: Path, dataset: str, device) -> int:
    """Encode and reconstruct every predict batch with the VAE alone (the
    reference's models.VAE.inference, models.py:352-381): NB counts drawn
    from the head, or the Gaussian head's mean, which has no theta."""
    for i, batch in enumerate(datamodule.predict_batches()):
        dev = device_batch(batch, device)
        out, z = vae(
            counts=dev[COUNTS],
            genes=dev["genes"],
            library_size=dev["library_size"],
            counts_subset=dev.get("counts_subset", dev[COUNTS]),
            genes_subset=dev.get("genes_subset", dev["genes"]),
        )
        if "theta" in out:
            counts_pred = nb_sample(out["mu"], out["theta"],
                                    torch.Generator(device).manual_seed(i))
        else:
            counts_pred = out["mu"].float()
        outputs = {"reconstructed_counts": counts_pred.cpu().numpy(),
                   "z": z.float().cpu().numpy()}
        for k, v in batch.items():
            if k not in NON_CONDITION_KEYS:
                outputs[k] = np.asarray(v)
        path = create_anndata_from_inference_output(
            outputs, vocab, out_dir, dataset=dataset, index=i
        )
        logger.info(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
