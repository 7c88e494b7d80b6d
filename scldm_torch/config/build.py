"""Builders: resolved config dict -> framework objects (counterpart of
scldm_tpu/config/build.py, the typed replacement for Hydra `_target_`
instantiation). Each builder reads the config group the loader produces,
with the reference tree's group names and keys.

The port's modules hold their weights, so `build_vae`, `build_dit` and
`build_scvi_vae` also draw them (`utils.weights.init_reference_`, JAX's
initialisers) from a generator seeded with the config's `seed`, on the
config's `device` (default "cuda"; without a card that raises). `model.compute_dtype`
(float32 or bfloat16, JAX's `_DTYPES`) is the modules' compute dtype over
f32 weights, and `model.remat` recomputes each trunk block in the backward,
both as in JAX.

Every model value JAX's builders take is passed on: the VAE's dropout,
`positional_encoding`, `shared_embedding`, `agg_func`, `decoder_name`,
`remat_cross` and `cross_chunks`, and the DiT's dropout; an unknown
`agg_func` or `decoder_name` raises a ValueError, as in JAX. The parallel
keys `training.fsdp`, `gene_sp` and `pipeline_microbatches` go to the tasks
with the CLIs' `mesh`, as JAX's builders pass them: without a mesh (one
process) or at a "model" axis of 1 they change nothing, as in JAX; over a
"model" axis above 1 (a task built with such a mesh through its API) the
pipeline trains the DiT trunk as GPipe stages and a task without gene-SP or
the pipeline takes Megatron's layout, as in JAX.
Every transport JAX's factory takes is built, and
`vae_as_tokenizer.train: true` finetunes the VAE inside the LDM
(`LDMTask(train_vae=True)`), as in JAX.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from scldm_torch.data.datamodule import DataModule
from scldm_torch.data.encoder import VocabularyEncoder
from scldm_torch.nn.nnets import DiT
from scldm_torch.nn.vae import ScviVAE, TransformerVAE, build_transformer_vae
from scldm_torch.nn.vae import build_scvi_vae as scvi_vae_module
from scldm_torch.training.ldm_task import LDMTask
from scldm_torch.training.scvi_task import ScviTask
from scldm_torch.training.vae_task import VAETask
from scldm_torch.transport import create_transport
from scldm_torch.utils.weights import init_reference_

# JAX's `_DTYPES`: the compute dtypes a config may name
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

def resolve_device(cfg: Dict) -> torch.device:
    """The config's `device` (default "cuda"). A card that is not there
    raises: nothing falls back to the CPU."""
    device = torch.device(cfg.get("device") or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device=cuda but no CUDA device is available; pass device=cpu to "
                           "run on the CPU")
    return device


def compute_dtype(cfg: Dict) -> torch.dtype:
    """`model.compute_dtype` (default float32) as a torch dtype; a name JAX's
    `_DTYPES` does not hold raises, as its lookup does."""
    name = cfg["model"].get("compute_dtype", "float32")
    if name not in DTYPES:
        raise ValueError(f"model.compute_dtype={name}: expected one of {sorted(DTYPES)}")
    return DTYPES[name]


def _generator(cfg: Dict, device: torch.device) -> torch.Generator:
    return torch.Generator(device).manual_seed(int(cfg.get("seed", 42)))


def build_vocabulary_encoder(cfg: Dict) -> VocabularyEncoder:
    ve = cfg["datamodule"]["vocabulary_encoder"]
    return VocabularyEncoder(
        adata_path=ve.get("adata_path"),
        class_vocab_sizes=ve.get("class_vocab_sizes") or {},
        mask_token=ve.get("mask_token", "<MASK>"),
        mask_token_idx=ve.get("mask_token_idx", 0),
        n_genes=ve.get("n_genes"),
        guidance_weight=ve.get("guidance_weight"),
        mu_size_factor=ve.get("mu_size_factor"),
        sd_size_factor=ve.get("sd_size_factor"),
        condition_strategy=ve.get("condition_strategy", "mutually_exclusive"),
        metadata_genes=ve.get("metadata_genes"),
        metadata_json=ve.get("metadata_json"),
    )


def build_datamodule(
    cfg: Dict,
    vocab: Optional[VocabularyEncoder] = None,
    num_hosts: int = 1,
    host_index: int = 0,
) -> DataModule:
    dm = cfg["datamodule"]["datamodule"]
    vocab = vocab if vocab is not None else build_vocabulary_encoder(cfg)
    return DataModule(
        vocabulary_encoder=vocab,
        train_adata_path=dm.get("train_adata_path"),
        test_adata_path=dm.get("test_adata_path"),
        adata_attr=dm.get("adata_attr", "X"),
        adata_key=dm.get("adata_key"),
        batch_size=dm.get("batch_size", 128),
        test_batch_size=dm.get("test_batch_size", 256),
        seed=dm.get("seed", 42),
        sample_genes=dm.get("sample_genes", "expressed"),
        genes_seq_len=dm.get("genes_seq_len", 2048),
        val_as_test=dm.get("val_as_test", False),
        drop_incomplete_batch=dm.get("drop_incomplete_batch", True),
        max_cache_size=dm.get("max_cache_size", 10),
        prefetch=dm.get("prefetch", 4),
        workers=int(dm.get("workers", 1)),
        num_hosts=num_hosts,
        host_index=host_index,
        allow_missing_train=dm.get("allow_missing_train", False),
        dense_transfer=dm.get("dense_transfer", True),
    )


def build_vae(cfg: Dict) -> TransformerVAE:
    """The VAE of `model.vae` on the config's device, its weights drawn from
    a generator seeded with the config's `seed`."""
    m = cfg["model"]["vae"]
    device = resolve_device(cfg)
    vae = build_transformer_vae(
        n_genes=m["n_genes"],
        n_embed=m.get("n_embed", 32),
        n_embed_latent=m.get("n_embed_latent", 16),
        n_layer=m.get("n_layer", 8),
        n_inducing_points=m.get("n_inducing_points", 16),
        n_head=m.get("n_head", 8),
        n_head_cross=m.get("n_head_cross", 4),
        dropout=float(m.get("dropout", 0.0)),
        bias=m.get("bias", False),
        multiple_of=m.get("multiple_of", 4),
        layernorm_eps=float(m.get("layernorm_eps", 1e-8)),
        positional_encoding=bool(m.get("positional_encoding", True)),
        shared_embedding=bool(m.get("shared_embedding", True)),
        agg_func=m.get("agg_func", "log1p"),
        decoder_head=cfg["model"].get("decoder_name", "negative_binomial_shared_theta"),
        remat=bool(cfg["model"].get("remat", False)),
        remat_cross=bool(cfg["model"].get("remat_cross", False)),
        cross_chunks=int(cfg["model"].get("cross_chunks", 1)),
        dtype=compute_dtype(cfg),
        device=device,
    )
    return init_reference_(vae, _generator(cfg, device))


def build_scvi_vae(cfg: Dict) -> ScviVAE:
    """The scVI baseline of `model.scvi` (configs/model/vae_scvi.yaml) on the
    config's device, in f32 as JAX builds it, its weights drawn from a
    generator seeded with the config's `seed`."""
    m = cfg["model"]["scvi"]
    device = resolve_device(cfg)
    vae = scvi_vae_module(
        n_genes=m["n_genes"],
        n_hidden=m.get("n_hidden", 128),
        n_latent=m.get("n_latent", 10),
        n_layers=m.get("n_layers", 1),
        dropout=float(m.get("dropout", 0.1)),
        shared_theta=m.get("shared_theta", True),
        device=device,
    )
    return init_reference_(vae, _generator(cfg, device))


def build_scvi_task(cfg: Dict, max_steps: int, mesh=None) -> ScviTask:
    m = cfg["model"]["scvi"]
    opt = cfg["model"]["optimizer"]
    sch = cfg["model"]["scheduler"]
    tr = cfg["training"]
    return ScviTask(
        build_scvi_vae(cfg),
        n_latent=m.get("n_latent", 10),
        kl_weight=float(m.get("kl_weight", 1.0)),
        learning_rate=float(opt.get("lr", 1e-3)),
        betas=tuple(opt.get("betas", (0.9, 0.95))),
        weight_decay=float(opt.get("weight_decay", 0.0)),
        grad_clip=float(tr.get("grad_clip", 10.0)),
        num_training_steps=max_steps,
        num_warmup_steps=sch.get("num_warmup_steps"),
        decay_type=sch.get("decay_type", "sqrt"),
        fract_decay=float(sch.get("fract_decay", 0.1)),
        mesh=mesh,
    )


def build_vae_task(cfg: Dict, vae: TransformerVAE, max_steps: int, mesh=None) -> VAETask:
    opt = cfg["model"]["optimizer"]
    sch = cfg["model"]["scheduler"]
    tr = cfg["training"]
    return VAETask(
        vae,
        learning_rate=float(opt.get("lr", 1e-3)),
        betas=tuple(opt.get("betas", (0.9, 0.95))),
        weight_decay=float(opt.get("weight_decay", 0.0)),
        caution=opt.get("caution", False),
        grad_clip=float(tr.get("grad_clip", 10.0)),
        num_training_steps=max_steps,
        num_warmup_steps=sch.get("num_warmup_steps"),
        final_lr_factor=float(sch.get("final_lr_factor", 0.1)),
        init_div_factor=float(sch.get("init_div_factor", 100)),
        fract_decay=float(sch.get("fract_decay", 0.1)),
        decay_type=sch.get("decay_type", "sqrt"),
        calculate_grad_norms=tr.get("calculate_grad_norms", False),
        mesh=mesh,
        fsdp=bool(tr.get("fsdp", False)),
        gene_sp=bool(tr.get("gene_sp", False)),
        # None = on at E > 128, as in JAX; configs may pin true / false
        algebraic_tail=tr.get("algebraic_tail"),
    )


def build_dit(cfg: Dict) -> DiT:
    """The DiT of `model.diffusion_model` on the config's device, its weights
    drawn from a generator seeded with the config's `seed`, with the
    adaLN-zero initialisation."""
    d = cfg["model"]["diffusion_model"]
    device = resolve_device(cfg)
    dit = DiT(
        n_embed=d.get("n_embed", 256),
        n_embed_input=d["n_embed_input"],
        n_layer=d.get("n_layer", 8),
        n_head=d.get("n_head", 8),
        seq_len=d["seq_len"],
        bias=d.get("bias", True),
        multiple_of=d.get("multiple_of", 4),
        layernorm_eps=float(d.get("layernorm_eps", 1e-8)),
        class_vocab_sizes=d.get("class_vocab_sizes") or {},
        cfg_dropout_prob=d.get("cfg_dropout_prob", 0.1),
        condition_strategy=d.get("condition_strategy", "mutually_exclusive"),
        remat=bool(cfg["model"].get("remat", False)),
        dtype=compute_dtype(cfg),
        dropout=float(d.get("dropout", 0.0)),
    ).to(device)  # its sin-cos table is a buffer made from numpy, on the host
    return init_reference_(dit, _generator(cfg, device))


def build_transport_from_cfg(cfg: Dict):
    t = cfg["model"]["transport"]
    return create_transport(
        path_type=t.get("path_type", "Linear"),
        prediction=t.get("prediction", "velocity"),
        loss_weight=t.get("loss_weight"),
        train_eps=_maybe_float(t.get("train_eps")),
        sample_eps=_maybe_float(t.get("sample_eps")),
    )


def _maybe_float(v):
    return float(v) if v is not None else None


def build_ldm_task(cfg: Dict, vae: TransformerVAE, dit: DiT, max_steps: int,
                   mesh=None) -> LDMTask:
    """The LDM task over `vae` (the port's task holds the VAE module with
    its weights, so JAX's separate `vae_params` has no counterpart here),
    frozen, or finetuned with the DiT under `vae_as_tokenizer.train`."""
    opt = cfg["model"]["optimizer"]
    sch = cfg["model"]["scheduler"]
    ema = cfg["model"].get("ema", {})
    tr = cfg["training"]
    return LDMTask(
        vae,
        dit,
        build_transport_from_cfg(cfg),
        learning_rate=float(opt.get("lr", 5e-4)),
        betas=tuple(opt.get("betas", (0.9, 0.999))),
        weight_decay=float(opt.get("weight_decay", 0.0)),
        grad_clip=float(tr.get("grad_clip", 10.0)),
        num_training_steps=max_steps,
        num_warmup_steps=sch.get("num_warmup_steps"),
        final_lr_factor=float(sch.get("final_lr_factor", 0.1)),
        fract_decay=float(sch.get("fract_decay", 1.0)),
        decay_type=sch.get("decay_type", "cosine"),
        ema_decay=float(ema.get("decay", 0.9999)),
        ema_update_every=int(ema.get("update_every", 10)),
        ema_update_after_step=int(ema.get("update_after_step", 10_000)),
        train_vae=bool((cfg["model"].get("vae_as_tokenizer") or {}).get("train", False)),
        calculate_grad_norms=tr.get("calculate_grad_norms", False),
        mesh=mesh,
        fsdp=bool(tr.get("fsdp", False)),
        pipeline_microbatches=tr.get("pipeline_microbatches"),
        gene_sp=bool(tr.get("gene_sp", False)),
        algebraic_decode=bool(tr.get("algebraic_decode", False)),
    )


def compute_max_steps(cfg: Dict, n_cells: int, world_size: int = 1) -> int:
    """max_steps = epochs * n_cells // (batch * world) (the reference's
    _utils.py:62-108)."""
    if cfg["training"].get("max_steps"):
        return int(cfg["training"]["max_steps"])
    batch = cfg["model"]["batch_size"]
    epochs = cfg.get("epochs", 100)
    return max(1, epochs * (n_cells // (batch * world_size)))
