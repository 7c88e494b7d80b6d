"""Data parallelism and ZeRO-3 over the mesh's "data" axis (the port's
counterpart of JAX's replicated and FSDP shardings,
scldm_tpu/parallel/sharding_rules.py:71-104, which GSPMD turns into the
gradient all-reduce, the all-gathers and the reduce-scatters).

Each rank runs a one-card step on its own rows; the tasks never go through
`DistributedDataParallel` (they call the VAE's submodules and the kernels
read the weights directly, not through one `forward`). After the backward,
`Layout.sync` averages the gradients over "data" in one flat all-reduce (the
step's metrics ride in the same buffer, so the loss comes back as the global
mean); under gene-SP the gradients are first summed over "model". The
initial weights are broadcast from rank 0 (`Layout.broadcast_`).

`FlatShards` is the FSDP layout (`training.fsdp`), chosen over FSDP2's
`fully_shard`, which leaves DTensors outside a wrapped module's `forward`
where the tasks and the kernels' raw pointers read the weights. Every
trained parameter that JAX's rule shards (`sharding_rules.fit_spec` with
fsdp: at least 1,024 elements and a dimension the data axis divides) keeps
1/n of its elements,
and its optimizer moments are made from that slice: between steps its
module tensor is empty. A step all-gathers the full weights into the module
(`gather`), and after the backward reduce-scatters the gradients into the
slices (`reduce_scatter_grads`), each a single flat collective; the global
norm adds the slices' all-reduced squared norms to the replicated ones.
"""

from __future__ import annotations

import contextlib
import math
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

from scldm_torch.parallel.distributed import sync_generator_
from scldm_torch.parallel.mesh import axis_rank, axis_size
from scldm_torch.parallel.sharding_rules import fit_spec, shard_module_
from scldm_torch.parallel.tensor_parallel import TensorParallel, megatron_of
from scldm_torch.training import metrics as M

@torch.no_grad()
def all_reduce_flat_(tensors: Sequence[torch.Tensor], group, divide: Optional[int] = None) -> None:
    """Sum `tensors` over `group` in place, one flat all-reduce per dtype and
    device, then divide by `divide` where given (the mean over the group:
    gloo has no AVG)."""
    buckets: Dict[tuple, List[torch.Tensor]] = defaultdict(list)
    for t in tensors:
        buckets[(t.dtype, t.device)].append(t)
    for ts in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        if divide is not None:
            flat /= divide
        for t, piece in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(piece.view_as(t))


class _SyncSum(torch.autograd.Function):
    """The sum over `group` of each rank's tensor, whose backward sums the
    ranks' cotangents: the gradient each rank then holds is its rows' part
    of the mean of every rank's loss, once the step averages it over the
    group (a statistic of the global batch, as in a synchronised BatchNorm)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        ctx.group = group
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone()
        dist.all_reduce(dx, group=ctx.group)
        return dx, None


def sync_sum(x: torch.Tensor, group) -> torch.Tensor:
    """`_SyncSum`: the sum of each rank's `x` over `group`, differentiable."""
    return _SyncSum.apply(x, group)


class FlatShards:
    """The FSDP slices of a module's trained parameters over `group` (the
    module docstring). Rank r keeps elements [r k, (r + 1) k) of each
    parameter that `decide(name, parameter)` picks (`Layout.shard`: JAX's
    rule) of its flattened tensor, k = numel / n, as a parameter of its own
    (`shard_of`), which the optimizer updates in place of the full one.
    Built with the full weights in the module; `free` empties them."""

    def __init__(self, module: torch.nn.Module, group, decide):
        self.group = group
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.entries = []  # (name, parameter, its slice, its shape)
        for name, p in module.named_parameters():
            if p.requires_grad and decide(name, p):
                k = p.numel() // self.n
                piece = p.detach().reshape(-1)[self.rank * k: (self.rank + 1) * k]
                self.entries.append((name, p, torch.nn.Parameter(piece.clone()), tuple(p.shape)))
        if len({s.dtype for _, _, s, _ in self.entries}) > 1:
            raise ValueError("FlatShards takes parameters of one dtype")
        self._shard = {id(p): s for _, p, s, _ in self.entries}
        self.total = sum(s.numel() for _, _, s, _ in self.entries)

    def shard_of(self, p: torch.nn.Parameter) -> torch.nn.Parameter:
        """`p`'s slice if it is sharded, else `p`."""
        return self._shard.get(id(p), p)

    @torch.no_grad()
    def free(self) -> None:
        """Empty the full tensors (and their gradients) in the module."""
        for _, p, s, _ in self.entries:
            p.data = s.detach().new_empty(0)
            p.grad = None

    @torch.no_grad()
    def gather(self) -> None:
        """All-gather the full weights into the module, one flat collective."""
        if not self.entries:
            return
        local = torch.cat([s.detach().reshape(-1) for _, _, s, _ in self.entries])
        out = local.new_empty(self.n * self.total)
        dist.all_gather_into_tensor(out, local, group=self.group)
        out = out.view(self.n, self.total)
        off = 0
        for _, p, s, shape in self.entries:
            p.data = out[:, off: off + s.numel()].reshape(shape)
            off += s.numel()

    @contextlib.contextmanager
    def gathered(self):
        """The full weights in the module for the block's length."""
        self.gather()
        try:
            yield
        finally:
            self.free()

    @torch.no_grad()
    def reduce_scatter_grads(self, divide: int) -> None:
        """The full gradients' sum over the ranks, each rank keeping its
        slice divided by `divide` as its slice's gradient (one flat
        collective); then `free`."""
        if self.entries:
            flat = torch.cat([p.grad.reshape(self.n, -1) for _, p, _, _ in self.entries], dim=1)
            out = flat.new_empty(self.total)
            dist.reduce_scatter_tensor(out, flat.reshape(-1), group=self.group)
            out /= divide
            off = 0
            for _, _, s, _ in self.entries:
                s.grad = out[off: off + s.numel()].view_as(s)
                off += s.numel()
        self.free()

    @torch.no_grad()
    def load_slices(self) -> None:
        """Each slice from the module's full weights (after a load into them)."""
        for _, p, s, _ in self.entries:
            k = s.numel()
            s.copy_(p.detach().reshape(-1)[self.rank * k: (self.rank + 1) * k])

    def _indices(self, optimizer) -> Dict[int, tuple]:
        """{optimizer state index: (slice, full shape)} of the sharded parameters."""
        ids = {id(s): (s, shape) for _, _, s, shape in self.entries}
        params = [p for g in optimizer.param_groups for p in g["params"]]
        return {i: ids[id(p)] for i, p in enumerate(params) if id(p) in ids}

    @torch.no_grad()
    def full_optimizer_state(self, optimizer) -> dict:
        """The optimizer's state dict with every sliced tensor all-gathered
        to its parameter's full shape: the one-process format (collective)."""
        sd = optimizer.state_dict()
        state = dict(sd["state"])
        for i, (s, shape) in self._indices(optimizer).items():
            if i not in state:
                continue
            st = dict(state[i])
            for key, v in st.items():
                if torch.is_tensor(v) and v.shape == s.shape:
                    out = v.new_empty(self.n * v.numel())
                    dist.all_gather_into_tensor(out, v.reshape(-1), group=self.group)
                    st[key] = out.view(shape)
            state[i] = st
        return {**sd, "state": state}

    def sliced_optimizer_state(self, sd: dict, optimizer) -> dict:
        """A one-process optimizer state dict with this rank's slices of the
        sharded parameters' tensors."""
        state = dict(sd["state"])
        for i, (s, shape) in self._indices(optimizer).items():
            if i not in state:
                continue
            k = s.numel()
            state[i] = {key: (v.reshape(-1)[self.rank * k: (self.rank + 1) * k].clone()
                              if torch.is_tensor(v) and tuple(v.shape) == shape else v)
                        for key, v in state[i].items()}
        return {**sd, "state": state}


def trained_params(layout: Optional["Layout"], module: torch.nn.Module, *others):
    """(the parameters an optimizer over `module` updates, the FSDP slices or
    None). On a mesh the ranks first take rank 0's weights of `module` and
    `others`, under Megatron cut to each model rank's slices; the caller
    builds the optimizer, then frees the FSDP slices' full tensors
    (`FlatShards.free`)."""
    params = [p for p in module.parameters() if p.requires_grad]
    if layout is None:
        return params, None
    layout.broadcast_(module, *others)
    if layout.tp is not None:
        for m in (module, *others):
            shard_module_(m, layout.tp)
    shards = layout.shard(module)
    if shards is not None:
        params = [shards.shard_of(p) for p in params]
    return params, shards


class Layout:
    """What a task does on a mesh: the groups and sizes of its axes, the
    broadcast of the initial weights, Megatron slices over "model"
    (`megatron` with more than one model rank), FSDP slices (`fsdp` with
    more than one data rank) and the gradient and metric reductions of a
    step."""

    def __init__(self, mesh, fsdp: bool = False, megatron: bool = False):
        self.mesh = mesh
        self.n_data, self.n_model = axis_size(mesh, "data"), axis_size(mesh, "model")
        self.data_rank, self.model_rank = axis_rank(mesh, "data"), axis_rank(mesh, "model")
        self.data_group = mesh.get_group("data")
        self.model_group = mesh.get_group("model")
        self.fsdp = bool(fsdp) and self.n_data > 1
        self.tp = TensorParallel(self.model_group) if megatron and self.n_model > 1 else None

    def share_draws_(self, state) -> None:
        """Where several model ranks share a data row's rows, they take its
        first one's generator state and keep their group in the state, so
        that a checkpoint load re-syncs them (`training.checkpoint`)."""
        if self.n_model > 1:
            state.sync_group = self.model_group
            sync_generator_(state.generator, self.model_group)

    @torch.no_grad()
    def broadcast_(self, *modules: torch.nn.Module) -> None:
        """Every rank takes rank 0's parameters and buffers (one flat
        broadcast per dtype and device)."""
        tensors = [t for m in modules for t in (*m.parameters(), *m.buffers())]
        buckets: Dict[tuple, List[torch.Tensor]] = defaultdict(list)
        for t in tensors:
            buckets[(t.dtype, t.device)].append(t)
        for ts in buckets.values():
            flat = torch.cat([t.detach().reshape(-1) for t in ts])
            dist.broadcast(flat, src=0)
            for t, piece in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(piece.view_as(t))

    def shard(self, module: torch.nn.Module) -> Optional[FlatShards]:
        """The FSDP slices of `module` over "data", or None without FSDP:
        JAX's rule (`fit_spec`) decides on each leaf's whole shape, with
        "model" where the module is cut by Megatron."""
        if not self.fsdp:
            return None
        mt = megatron_of(module)
        n_model = 1 if mt is None else self.n_model

        def decide(name, p):
            s = mt.by_id.get(id(p)) if mt is not None else None
            shape = s.shape if s is not None else tuple(p.shape)
            return fit_spec(name, shape, n_model, self.n_data, True)[1]

        return FlatShards(module, self.data_group, decide)

    @torch.no_grad()
    def sync(self, state, metrics: Dict[str, torch.Tensor], sum_over_model: bool = False
             ) -> Dict[str, torch.Tensor]:
        """After a backward: the gradients summed over "model" where each
        model rank holds a part of them (gene-SP, the pipeline), then averaged over
        "data" (reduce-scattered into the FSDP slices, the rest in one flat
        all-reduce with the metrics). Returns the metrics' means over
        "data" (0-d f32 tensors)."""
        module = state.module
        grads = [p.grad for p in module.parameters() if p.grad is not None]
        if sum_over_model and self.n_model > 1:
            all_reduce_flat_(grads, self.model_group)
        keys = sorted(metrics)
        vals = [metrics[k].detach().float().reshape(1).clone() for k in keys]
        shards = state.shards
        if shards is not None:
            sharded = {id(p) for _, p, _, _ in shards.entries}
            grads = [p.grad for p in module.parameters()
                     if p.grad is not None and id(p) not in sharded]
            shards.reduce_scatter_grads(self.n_data)
        all_reduce_flat_(grads + vals, self.data_group, divide=self.n_data)
        return {k: v.reshape(()) for k, v in zip(keys, vals)}

    def slice_axes(self, state) -> Dict[int, tuple]:
        """{id(trained tensor): (the mesh axes its slices spread over, the
        whole tensor's numel)} for every slice: FSDP over "data", Megatron
        over "model", or both. The trained tensor is the FSDP slice where
        there is one, else the module's parameter."""
        shards, mt = state.shards, megatron_of(state.module)
        fs = {} if shards is None else {id(p): (s, shape) for _, p, s, shape in shards.entries}
        out = {}
        for p in state.module.parameters():
            s = None if mt is None else mt.by_id.get(id(p))
            axes = (("data",) if id(p) in fs else ()) + (("model",) if s is not None else ())
            if axes:
                shape = s.shape if s is not None else fs[id(p)][1]
                q = fs[id(p)][0] if id(p) in fs else p
                out[id(q)] = (axes, math.prod(shape))
        return out

    def _groups(self, axes: tuple) -> tuple:
        return tuple(self.data_group if a == "data" else self.model_group for a in axes)

    def mark_slices(self, state) -> None:
        """Tell the state's AdamWLegacy which tensors are slices (the
        cautious mask's mean over the whole tensor)."""
        for key, (axes, numel) in self.slice_axes(state).items():
            state.optimizer.set_slices({key: numel}, *self._groups(axes))

    def norm_fn(self, state):
        """The global L2 norm of a list of the step's gradients: each slice's
        squared norm all-reduced over the axes it spreads over (FSDP's
        "data", Megatron's "model"), each replicated gradient counted once."""
        if state.shards is None and megatron_of(state.module) is None:
            return M.global_norm
        axes = {k: a for k, (a, _) in self.slice_axes(state).items()}
        kinds = sorted(set(axes.values()))  # one order on every rank

        def norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
            grads = list(grads)
            of_grad = {id(q.grad): axes[id(q)] for q in self._trained(state)
                       if id(q) in axes and q.grad is not None}
            rep = [g for g in grads if id(g) not in of_grad]
            sq = M.global_norm(rep).square() if rep else grads[0].new_zeros((), dtype=torch.float32)
            for kind in kinds:  # every rank reduces every kind, zeros where it has none
                mine = [g.float().square().sum() for g in grads if of_grad.get(id(g)) == kind]
                part = torch.stack(mine).sum() if mine else sq.new_zeros(())
                for group in self._groups(kind):
                    dist.all_reduce(part, group=group)
                sq = sq + part
            return sq.sqrt()

        return norm

    @staticmethod
    def _trained(state) -> List[torch.Tensor]:
        shards = state.shards
        return [p if shards is None else shards.shard_of(p) for p in state.module.parameters()]

    def named_grads(self, state) -> List[tuple]:
        """(name, gradient) of every trained parameter with one: the FSDP
        slice's gradient where the parameter is sharded."""
        shards = state.shards
        out = []
        for name, p in state.module.named_parameters():
            q = p if shards is None else shards.shard_of(p)
            if q.grad is not None:
                out.append((name, q.grad))
        return out

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The data ranks' equal row blocks of `x` concatenated in rank order."""
        out = x.new_empty((self.n_data * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=self.data_group)
        return out

    def data_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of the elements of every data rank's `x` (equal sizes)."""
        s = x.float().sum().reshape(1)
        dist.all_reduce(s, group=self.data_group)
        return (s / (x.numel() * self.n_data)).reshape(())


def step_gradients(layout: Optional[Layout], state, metrics: Optional[Dict] = None,
                   sum_over_model: bool = False):
    """A step's gradients after its backward: (the metrics, reduced over
    "data" on a mesh; (name, gradient) of every trained parameter with one,
    the FSDP slice's where it is sharded; the global-norm function over
    them). Without a mesh, the module's gradients and `metrics` as given."""
    metrics = dict(metrics or {})
    if layout is None:
        named = [(n, p.grad) for n, p in state.module.named_parameters() if p.grad is not None]
        return metrics, named, M.global_norm
    metrics = layout.sync(state, metrics, sum_over_model)
    return metrics, layout.named_grads(state), layout.norm_fn(state)


def full_weights(layout: Optional[Layout], state):
    """A context with the full weights in the module: the FSDP slices
    gathered for its length (a no-op without them, or without `state`)."""
    if layout is None or state is None or state.shards is None:
        return contextlib.nullcontext()
    return state.shards.gathered()
