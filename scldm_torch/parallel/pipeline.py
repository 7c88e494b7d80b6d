"""GPipe pipeline parallelism for the DiT trunk over the mesh's "model" axis
(counterpart of scldm_tpu/parallel/pipeline.py).

Stage s of S holds blocks [s L/S, (s+1) L/S) and runs them on each of the
M microbatches of its data rank's rows in turn; the stage hop sends a
microbatch's activations to the next stage, and its cotangent comes back the
other way. The conditioning rows `c` are read locally on every stage, as
JAX's (every model rank holds them). Each stage runs its blocks through
`ops.fused_dit.dit_block_trainable`: the forward and backward kernels (rows
1-2) on CUDA tensors, their plain versions on CPU tensors; a stage holds its
blocks' whole weights, which the one-card kernels take.

JAX runs M + S - 1 ticks on every device and computes its fill and drain
ticks on zeros; eager PyTorch runs only the valid (stage, microbatch) pairs,
the same math. Autograd does not cross a hop, so the schedule is written out
in one autograd function (`_GPipe`): its forward runs every microbatch
through the stage, keeping each input and output under a graph of its own;
its backward takes the microbatches in reverse, each receiving its output's
cotangent from the next stage, running that graph's backward and sending its
input's cotangent to the previous stage. Every rank thus meets its hops in
the same order.

The output is the last stage's, all-reduced over "model" so that every rank
holds it (JAX's psum); the backward sums the ranks' cotangents (the psum's
transpose), of which the task gives only the last stage's a nonzero seed
(`training.ldm_task`: the loss is taken where the last block ran). A
parameter's gradient then lives on one stage only: a block's on its stage,
`input_proj`'s on stage 0, the final layer's on the last, and the
conditioning's on the last too, from every stage's cotangent of `c` summed
there (its module's backward runs once, on the whole cotangent, as in one
process, whatever its compute dtype); the task sums them over "model".

The hop is a broadcast on a group of the two neighbour ranks, one collective
under every backend: NCCL takes it, and gloo takes it on CUDA tensors as on
CPU tensors.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from scldm_torch.ops.fused_dit import (
    WEIGHT_NAMES,
    _final_layer,
    block_weights,
    dit_block_trainable,
)


def stack_block_params(dit) -> Dict[str, torch.Tensor]:
    """The blocks' kernel weights (`ops.fused_dit.block_weights`: matrices
    (in, out), biases) stacked on a leading L axis, differentiable."""
    ws = [block_weights(b) for b in dit.blocks]
    return {k: torch.stack([w[k] for w in ws]) for k in WEIGHT_NAMES}


class Hops:
    """The hops between neighbour stages of every data row of a mesh: this
    rank's stage, the row's ranks, and a two-rank group for each neighbour
    pair (every rank builds every pair's group, in one order)."""

    def __init__(self, mesh):
        grid = mesh.mesh.tolist()  # (n_data, n_model) global ranks
        me = dist.get_rank()
        self.row = next(r for r in grid if me in r)
        self.stages = len(self.row)
        self.stage = self.row.index(me)
        self.pairs: Dict[tuple, object] = {}
        for r in grid:
            for s in range(self.stages - 1):
                group = dist.new_group([r[s], r[s + 1]])
                if me in (r[s], r[s + 1]):
                    self.pairs[(r[s], r[s + 1])] = group

    def _pair(self, stage: int):
        me, other = self.row[self.stage], self.row[stage]
        return self.pairs[tuple(sorted((me, other)))]

    def send(self, x: torch.Tensor, stage: int) -> None:
        dist.broadcast(x.contiguous(), src=self.row[self.stage], group=self._pair(stage))

    def recv(self, like: torch.Tensor, stage: int) -> torch.Tensor:
        out = torch.empty_like(like, memory_format=torch.contiguous_format)
        dist.broadcast(out, src=self.row[stage], group=self._pair(stage))
        return out


class _GPipe(torch.autograd.Function):
    """This stage's blocks over every microbatch (the module docstring)."""

    @staticmethod
    def forward(ctx, x, c, hops: Hops, group, n_micro: int, n_head: int, eps: float, *ws):
        S, s = hops.stages, hops.stage
        L = ws[0].shape[0]
        per = L // S
        mine = [{k: w[s * per + i].detach().requires_grad_() for k, w in zip(WEIGHT_NAMES, ws)}
                for i in range(per)]
        b = x.shape[0] // n_micro
        kept = []
        outs = torch.zeros_like(x)
        for m in range(n_micro):
            rows = slice(m * b, (m + 1) * b)
            h = x[rows] if s == 0 else hops.recv(x[rows], s - 1)
            h = h.detach().requires_grad_()
            cm = c[rows].detach().requires_grad_()
            with torch.enable_grad():
                y = h
                for w in mine:
                    y = dit_block_trainable(y, cm, w, n_head, eps)
            kept.append((h, cm, y))
            if s < S - 1:
                hops.send(y.detach(), s + 1)
            else:
                outs[rows] = y.detach()
        dist.all_reduce(outs, group=group)  # JAX's psum: the last stage's outputs everywhere
        ctx.hops, ctx.group, ctx.kept, ctx.mine, ctx.per = hops, group, kept, mine, per
        ctx.shapes = [w.shape for w in ws]
        return outs

    @staticmethod
    def backward(ctx, dy):
        hops, kept, mine = ctx.hops, ctx.kept, ctx.mine
        S, s = hops.stages, hops.stage
        dy = dy.contiguous().clone()
        dist.all_reduce(dy, group=ctx.group)  # the psum's transpose
        b = dy.shape[0] // len(kept)
        dx = torch.zeros_like(dy)
        dc = dy.new_zeros((dy.shape[0],) + tuple(kept[0][1].shape[1:]))
        leaves = [w for ws in mine for w in ws.values()]
        for m in reversed(range(len(kept))):
            h, cm, y = kept[m]
            rows = slice(m * b, (m + 1) * b)
            g = dy[rows] if s == S - 1 else hops.recv(y, s + 1)
            torch.autograd.backward(y, g, inputs=[h, cm] + leaves)
            if s > 0:
                hops.send(h.grad, s - 1)
            else:
                dx[rows] = h.grad
            dc[rows] = cm.grad
            kept[m] = None
        # the conditioning's cotangent from every stage, summed and handed to the
        # last stage, where the final layer's joins it: the conditioning module's
        # backward then runs once, on the whole cotangent, as in one process
        dist.all_reduce(dc, group=ctx.group)
        if s != S - 1:
            dc.zero_()
        dws = []
        for k, shape in zip(WEIGHT_NAMES, ctx.shapes):
            full = dy.new_zeros(shape)
            for i, ws in enumerate(mine):
                if ws[k].grad is not None:
                    full[s * ctx.per + i] = ws[k].grad
            dws.append(full)
        return (dx, dc, None, None, None, None, None, *dws)


def pipeline_blocks(
    x: torch.Tensor,  # (B, T, E): this data rank's rows, the same on every model rank
    c: torch.Tensor,  # (B, E) adaLN conditioning rows
    stacked: Dict[str, torch.Tensor],  # (L, ...) stacked block weights
    *,
    hops: Hops,
    group,
    n_micro: int,
    n_head: int,
    eps: float,
) -> torch.Tensor:
    """The L stacked blocks as a GPipe pipeline over the "model" ranks of
    `hops` (`group` is their process group), in f32. Raises JAX's
    ValueErrors where L does not divide into the stages or the rows into
    the microbatches."""
    n_layer = stacked["wqkv"].shape[0]
    if n_layer % hops.stages:
        raise ValueError(f"n_layer={n_layer} must divide into {hops.stages} stages")
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0]} must split into {n_micro} microbatches "
                         f"per data shard")
    ws = [stacked[k].float() for k in WEIGHT_NAMES]
    return _GPipe.apply(x.float().contiguous(), c.float().contiguous(), hops, group, n_micro,
                        n_head, eps, *ws)


def pipeline_dit_apply(
    dit,
    x: torch.Tensor,  # (B, T, E_in)
    t_emb: torch.Tensor,  # (B, E) from DiT.embed_condition
    *,
    hops: Hops,
    group,
    n_micro: int,
) -> torch.Tensor:
    """Differentiable DiT apply with the trunk as a GPipe pipeline: the input
    projection, the positional table and the final layer in plain PyTorch on
    every rank, in f32 (as `ops.fused_dit.fused_dit_train_apply`), the
    blocks through `pipeline_blocks`."""
    c = t_emb.float()
    h = dit.input_proj(x.float(), torch.float32) + dit.pos_embed.float()
    h = pipeline_blocks(h, c, stack_block_params(dit), hops=hops, group=group, n_micro=n_micro,
                        n_head=dit.n_head, eps=dit.layernorm_eps)
    return _final_layer(dit, h, c)
