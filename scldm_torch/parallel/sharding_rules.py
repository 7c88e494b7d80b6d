"""JAX's parameter sharding rules (counterpart of
scldm_tpu/parallel/sharding_rules.py) over the port's parameter names, and
Megatron tensor parallelism built on them.

The rule (`param_pspec`), in the port's (out, in) weight layout:

- column-parallel: the output features of `c_attn`, `c_attn_q`, `w1`, `w2`,
  `adaln_modulation` and `adaln_modulation_q`, and their biases;
- row-parallel: the input features of `c_proj` (attention and SwiGLU);
- feature-sharded: `gene_embedding` and every class embedding (`theta`, the
  NB head's (vocab, 1) table, is not);
- everything else replicated.

`fit_spec` is JAX's `_fit_spec`: a dimension "model" does not divide stays
whole, and with `fsdp` the largest remaining dimension "data" divides goes
over "data" (a leaf of at least 1,024 elements).

`shard_module_` cuts a module's parameters to one "model" rank's slices
and binds each layer to the group (`tensor_parallel.TensorParallel`):

- an attention whose heads "model" divides keeps the q, k and v rows of its
  heads (not JAX's contiguous columns: only the math is held) and the
  matching input columns of `c_proj`, and attends over those heads alone;
- an attention whose heads it does not divide keeps JAX's contiguous slices
  of the leaves it divides and gathers them at each use (JAX runs such a
  layout, so the port must too);
- a SwiGLU keeps its hidden slice of `w1`, `w2` and `c_proj`;
- an adaLN modulation keeps a contiguous slice of its 6E (or 2E) outputs and
  gathers its output; an embedding keeps a feature slice and gathers its
  lookups.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from scldm_torch.parallel.tensor_parallel import Megatron, Slice, TensorParallel

COLUMN_PARALLEL = ("c_attn", "c_attn_q", "w1", "w2", "adaln_modulation", "adaln_modulation_q")
ROW_PARALLEL = ("c_proj",)
EMBEDDINGS = ("gene_embedding",)
FSDP_MIN_NUMEL = 1024  # JAX's size floor: the all-gather latency outweighs the memory win below


def param_pspec(name: str) -> Optional[int]:
    """The dimension of parameter `name` (the port's layout: Linear weights
    (out, in), embeddings (vocab, E)) that JAX's rule puts on "model", or
    None where it replicates."""
    parts = [p for p in name.split(".") if not p.isdigit()]  # nn.Sequential indices
    if len(parts) < 2:
        return None
    leaf, parent = parts[-1], parts[-2]
    grand = parts[-3] if len(parts) >= 3 else ""
    if leaf == "weight":
        if parent in COLUMN_PARALLEL:
            return 0
        if parent in ROW_PARALLEL:
            return 1
        if parent in EMBEDDINGS or grand == "class_embeddings":
            return 1
        return None
    if leaf == "bias" and parent in COLUMN_PARALLEL:
        return 0
    return None


def fit_spec(name: str, shape: Tuple[int, ...], n_model: int, n_data: int = 1,
             fsdp: bool = False) -> Tuple[Optional[int], bool]:
    """(the dimension on "model" or None, whether the leaf goes over "data"):
    `param_pspec` with JAX's `_fit_spec`."""
    dim = param_pspec(name) if n_model > 1 else None
    if dim is not None and (dim >= len(shape) or shape[dim] % n_model):
        dim = None
    on_data = False
    if fsdp and n_data > 1:
        free = [d for d in range(len(shape)) if d != dim and shape[d] % n_data == 0]
        if free:
            best = max(free, key=lambda d: shape[d])
            on_data = shape[best] >= n_data and math.prod(shape) >= FSDP_MIN_NUMEL
    return dim, on_data


def _blocks(width: int, n: int, rank: int, parts: int = 1) -> torch.Tensor:
    """Rank `rank`'s indices when each of `parts` equal blocks of `width`
    splits into `n` contiguous slices (parts = 3 for q, k and v)."""
    block = width // parts
    k = block // n
    return torch.tensor([i for j in range(parts)
                         for i in range(j * block + rank * k, j * block + (rank + 1) * k)],
                        dtype=torch.long)


def shard_module_(module: nn.Module, tp: TensorParallel) -> Megatron:
    """Cut `module`'s parameters (whole, the same on every rank) to this
    rank's slices in place and bind its layers to `tp` (the module
    docstring). Returns the slices, also kept as `module.megatron`."""
    from scldm_torch.nn.layers import MLP, CrossAttention, SelfAttention

    n, rank = tp.size, tp.rank
    # id(Linear) -> the head-aligned blocks of its output features, for the
    # layers whose attention or SwiGLU does the collectives
    owned = {}
    for m in module.modules():
        if isinstance(m, (SelfAttention, CrossAttention)) and m.n_head % n == 0:
            m.tp = tp
            owned[id(m.c_attn)] = 3 if isinstance(m, SelfAttention) else 2
            owned[id(m.c_proj)] = 1
            if isinstance(m, CrossAttention):
                owned[id(m.c_attn_q)] = 1
        elif isinstance(m, MLP) and m.w1.out_features % n == 0:
            m.tp = tp
            owned.update({id(lin): 1 for lin in (m.w1, m.w2, m.c_proj)})
    owners = {f"{mod_name}.{p_name}" if mod_name else p_name: m
              for mod_name, m in module.named_modules()
              for p_name, _ in m.named_parameters(recurse=False)}
    slices = []
    for name, p in list(module.named_parameters()):
        dim, _ = fit_spec(name, tuple(p.shape), n)
        if dim is None:
            continue
        owner = owners[name]
        width = p.shape[dim]
        parts = owned.get(id(owner), 1) if dim == 0 else 1
        index = _blocks(width, n, rank, parts)
        order = torch.cat([_blocks(width, n, r, parts) for r in range(n)])
        shape = tuple(p.shape)
        with torch.no_grad():
            p.data = p.data.index_select(dim, index.to(p.device)).contiguous()
        slices.append(Slice(name, p, dim, index, order, shape))
        if id(owner) in owned:
            continue
        owner.tp = tp
        if isinstance(owner, nn.Linear):
            parent = [q for q in name.split(".") if not q.isdigit()][-2]
            owner.tp_mode = "output" if parent.startswith("adaln_modulation") else "weight"
            if name.endswith("weight"):
                owner.tp_dim = dim
    mt = Megatron(tp, slices)
    module.megatron = mt
    return mt
