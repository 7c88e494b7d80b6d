"""Megatron tensor parallelism over the mesh's "model" axis: the collectives
that JAX's GSPMD inserts around the column- and row-parallel products of
`sharding_rules.param_pspec`, and the registry of a module's slices.

Each "model" rank holds 1/n of every leaf the rule shards (its slice, in
the module's own parameter, so AdamW makes its moments from the slice) and
every other leaf whole. A replicated activation enters a column-parallel
product through `copy_to` (identity forward, all-reduce backward: each rank's
backward yields its slice's part of the input's gradient); a row-parallel
product's partial sums leave through `reduce_from` (all-reduce forward,
identity backward). Both sum in f32 at least: the row-parallel products
return f32 partial sums of their bf16 operands (`nn.layers.row_parallel`),
so a bf16 result is rounded once, as one process's is; `gather` joins the ranks' feature slices of an
activation (all-gather forward, this rank's slice of the cotangent
backward), after a feature-sharded embedding and after the adaLN
modulation, whose six chunks of E do not follow a contiguous split. So
every rank ends each block holding the whole replicated activation with
its whole gradient, and every replicated leaf's gradient is already whole
on every rank (nothing sums them over "model").

`Megatron` keeps, for each sharded parameter of a root module, the
dimension and the global indices this rank holds, and moves whole tensors
in and out of slices: a reference state dict into a rank's slices
(`utils.weights.load_reference_state_dict`), and a rank's slices, AdamW
moments and EMA into whole tensors for the one-process checkpoint format.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def _all_gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The ranks' equal slices of `x` along `dim`, joined in rank order."""
    dim = dim % x.ndim
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' `x` summed in f32 at least, returned in `x`'s dtype: a bf16
    sum is rounded once, as one process's f32-accumulated product is."""
    acc = x.to(torch.promote_types(x.dtype, torch.float32)).contiguous().clone()
    dist.all_reduce(acc, group=group)
    return acc.to(x.dtype)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _sum(dy, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, rank):
        ctx.dim, ctx.rank, ctx.width = dim % x.ndim, rank, x.shape[dim]
        return _all_gather(x, dim, group, n).contiguous()

    @staticmethod
    def backward(ctx, dy):
        return dy.narrow(ctx.dim, ctx.rank * ctx.width, ctx.width), None, None, None, None


class TensorParallel:
    """This rank's "model" group of a Megatron layout, its size and rank, and
    the collectives over it. A module that computes on slices holds one as
    `tp` (None on one card); a copy of the module shares it."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def __deepcopy__(self, memo):
        return self

    def copy_to(self, x: torch.Tensor) -> torch.Tensor:
        """Identity; the backward sums the ranks' cotangents."""
        return _CopyTo.apply(x, self.group)

    def reduce_from(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the ranks' partial `x`; the backward is the identity."""
        return _ReduceFrom.apply(x, self.group)

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The ranks' slices of `x` along `dim` joined in rank order; the
        backward keeps this rank's slice of the cotangent."""
        return _Gather.apply(x, dim, self.group, self.size, self.rank)


@dataclass
class Slice:
    """A sharded parameter: its name under the root module, the parameter,
    the dimension split over "model", the global indices of that dimension
    this rank holds, every rank's indices in rank order, and the whole
    tensor's shape and the slice's."""

    name: str
    param: torch.nn.Parameter
    dim: int
    index: torch.Tensor
    order: torch.Tensor
    shape: Tuple[int, ...]

    @property
    def local(self) -> Tuple[int, ...]:
        return tuple(len(self.index) if d == self.dim else n for d, n in enumerate(self.shape))


class Megatron:
    """The Megatron slices of a root module's parameters over `tp`'s group
    (built by `sharding_rules.shard_module_`)."""

    def __init__(self, tp: TensorParallel, slices: Sequence[Slice]):
        self.tp = tp
        self.slices = list(slices)
        self.by_name = {s.name: s for s in self.slices}
        self.by_id = {id(s.param): s for s in self.slices}

    def take(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole tensor of parameter `name`."""
        s = self.by_name[name]
        return full.index_select(s.dim, s.index.to(full.device))

    @torch.no_grad()
    def whole(self, s: Slice, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's slice `t` (collective)."""
        parts = _all_gather(t.detach(), s.dim, self.tp.group, self.tp.size)
        full = parts.new_empty(s.shape)
        return full.index_copy_(s.dim, s.order.to(full.device), parts)

    def sliced_state_dict(self, state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A whole state dict with this rank's slices of the sharded entries."""
        return {k: self.take(k, v) if k in self.by_name else v for k, v in state_dict.items()}

    def whole_state_dict(self, state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A state dict of slices with the sharded entries whole (collective)."""
        return {k: self.whole(self.by_name[k], v) if k in self.by_name else v
                for k, v in state_dict.items()}

    def _named(self, module: torch.nn.Module, tensors: Mapping[str, torch.Tensor]):
        """(key in `tensors`, slice) of each sharded parameter of `module`
        that `tensors` holds under its name, or under its name without the
        first component (an EMA over one child of the module)."""
        for name, p in module.named_parameters():
            s = self.by_id.get(id(p))
            if s is None:
                continue
            for key in (name, name.partition(".")[2]):
                if key in tensors:
                    yield key, s
                    break

    def whole_named(self, module: torch.nn.Module,
                    tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Tensors shaped as `module`'s parameters by name (an EMA) with each
        sharded parameter's whole (collective)."""
        out = dict(tensors)
        for key, s in self._named(module, tensors):
            out[key] = self.whole(s, tensors[key])
        return out

    def sliced_named(self, module: torch.nn.Module,
                     tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Whole tensors by `module`'s parameter names with this rank's slice
        of each sharded parameter's."""
        out = dict(tensors)
        for key, s in self._named(module, tensors):
            out[key] = tensors[key].index_select(s.dim, s.index.to(tensors[key].device))
        return out

    def _slice_at(self, params: Sequence[torch.nn.Parameter]) -> Dict[int, Slice]:
        return {i: self.by_id[id(p)] for i, p in enumerate(params) if id(p) in self.by_id}

    def whole_optimizer_state(self, sd: dict, params: Sequence[torch.nn.Parameter]) -> dict:
        """An optimizer state dict whose i-th state belongs to `params[i]`,
        with the moments of the sharded parameters whole (collective)."""
        state = dict(sd["state"])
        for i, s in self._slice_at(params).items():
            if i in state:
                state[i] = {k: self.whole(s, v) if torch.is_tensor(v) and tuple(v.shape) == s.local
                            else v for k, v in state[i].items()}
        return {**sd, "state": state}

    def sliced_optimizer_state(self, sd: dict, params: Sequence[torch.nn.Parameter]) -> dict:
        """A one-process optimizer state dict with this rank's slices of the
        sharded parameters' moments."""
        state = dict(sd["state"])
        for i, s in self._slice_at(params).items():
            if i in state:
                state[i] = {k: v.index_select(s.dim, s.index.to(v.device))
                            if torch.is_tensor(v) and tuple(v.shape) == s.shape else v
                            for k, v in state[i].items()}
        return {**sd, "state": state}


def megatron_of(module: torch.nn.Module) -> Optional[Megatron]:
    """The Megatron slices a root module was sharded into, or None."""
    return module.__dict__.get("megatron")

