"""Weights for the port's modules.

`load_reference_state_dict` is the bridge from the JAX package: the port's
modules carry the reference's PyTorch names, which is what
`scldm_tpu.utils.torch_import.export_torch_state_dict` emits, so a flax tree
loads with a transpose-free `load_state_dict`; `batch_stats_state_dict`
names a flax `batch_stats` collection the same way. `load_reference_ema_` carries
an EMA tree (the JAX `EMAState.params`, or the reference checkpoint's
`ema_model.ema_model.` weights) into a `training.ema.EMAState` the same way.
Into a module cut to Megatron slices (`parallel.sharding_rules.shard_module_`)
both load this rank's slices of the whole tensors.

`init_reference_` gives a module fresh weights from a `torch.Generator`,
with the initialisers of the JAX package (xavier-uniform Linear, zero
biases, unit LayerNorm and BatchNorm scales and shared-theta tables or
vectors, N(0, 1) gene embeddings, the decoder's own included, inducing
points and softbin bin embeddings, N(0, 0.02) class and timestep tables,
adaLN-zero, the MCAB's query modulation too). `zero_init=False` draws the adaLN and final
layers like any other Linear, so a randomly initialised DiT is not the
identity.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from scldm_torch.parallel.tensor_parallel import megatron_of

_LIGHTNING_PREFIXES = ("vae_model.", "diffusion_model.", "ema_model.ema_model.")


def _cleaned(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """Tensors by reference name, Lightning prefixes stripped."""
    cleaned: Dict[str, torch.Tensor] = {}
    for k, v in state_dict.items():
        for prefix in _LIGHTNING_PREFIXES:
            if k.startswith(prefix):
                k = k[len(prefix):]
                break
        cleaned[k] = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
    return cleaned


def batch_stats_state_dict(batch_stats: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """A flax `batch_stats` collection (nested dicts of arrays, as JAX's
    ScviTask keeps in `TrainState.extra`) as the port's BatchNorm buffers:
    `<path>.mean` -> `<path>.running_mean`, `<path>.var` -> `<path>.running_var`
    (`export_torch_state_dict` maps only `params`)."""
    out: Dict[str, np.ndarray] = {}
    for k, v in batch_stats.items():
        if isinstance(v, Mapping):
            out.update(batch_stats_state_dict(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}running_{k}"] = np.asarray(v)
    return out


def load_reference_state_dict(module: nn.Module, state_dict: Mapping, strict: bool = True):
    """Load a reference-named state dict (numpy arrays or tensors) into
    `module`, casting to each parameter's dtype and device; a Megatron
    module takes this rank's slices. Lightning prefixes are stripped. Returns
    `load_state_dict`'s result."""
    cleaned = _cleaned(state_dict)
    mt = megatron_of(module)
    return module.load_state_dict(cleaned if mt is None else mt.sliced_state_dict(cleaned),
                                  strict=strict)


@torch.no_grad()
def load_reference_ema_(ema, state_dict: Mapping, module: Optional[nn.Module] = None):
    """Copy a reference-named state dict into the averaged parameters of
    `ema` (a `training.ema.EMAState`), in place, casting to each tensor's
    dtype and device; with the EMA's `module` cut to Megatron slices, this
    rank's slices. Every averaged parameter must be present and no other
    key. Returns `ema`."""
    cleaned = _cleaned(state_dict)
    mt = None if module is None else megatron_of(module)
    if mt is not None:
        cleaned = mt.sliced_named(module, cleaned)
    if set(cleaned) != set(ema.params):
        raise KeyError(f"EMA keys differ: missing {sorted(set(ema.params) - set(cleaned))[:5]}, "
                       f"unexpected {sorted(set(cleaned) - set(ema.params))[:5]}")
    for name, t in ema.params.items():
        t.copy_(cleaned[name].reshape(t.shape))
    return ema


def _zero_init(name: str) -> bool:
    return "adaln_modulation" in name or name.startswith("final_layer.linear")


@torch.no_grad()
def init_reference_(
    module: nn.Module, generator: torch.Generator, *, zero_init: bool = True
) -> nn.Module:
    """Re-initialise every parameter of `module` in place from `generator`
    (a generator on the parameters' device). Returns the module."""
    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * std)

    for mod_name, mod in module.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        for p_name, p in mod.named_parameters(recurse=False):
            name = prefix + p_name
            if isinstance(mod, nn.Linear) and p_name == "weight":
                if zero_init and _zero_init(name):
                    p.zero_()
                elif name.startswith("t_embedder."):
                    normal_(p, 0.02)
                else:
                    fan_out, fan_in = p.shape
                    a = math.sqrt(6.0 / (fan_in + fan_out))
                    p.copy_(torch.rand(p.shape, generator=generator, device=p.device) * 2 * a - a)
            elif p_name == "bias":
                p.zero_()
            elif name.startswith("class_embeddings."):
                normal_(p, 0.02)
            elif name.endswith(("theta.weight", "theta")) or (p_name == "weight" and p.ndim == 1):
                p.fill_(1.0)  # shared-theta table or vector, LayerNorm and BatchNorm scales
            elif p_name == "pos_embed":
                p.zero_()  # the reference's frozen all-zeros encoder table
            else:
                normal_(p, 1.0)  # gene embeddings, inducing points, bin embeddings
    return module
