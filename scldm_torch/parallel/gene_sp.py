"""Gene-sequence parallelism over the mesh's "model" axis (the port's
counterpart of JAX's gene-SP sharding constraints,
scldm_tpu/training/vae_task.py:939-973 and ldm_task.py:446-480).

Each "model" rank decodes a contiguous range of the genes; the ranges split
the gene axis as evenly as it goes, the first ranks one gene longer
(G = 36,601 over two: 18,301 + 18,300). Gene tokens attend only to the
latents, never to each other, so the decode needs no collective until the
NB mean's softmax over every gene and the loss's gene sum:

- `softmax`: the row max and the row sum are all-reduced over "model"
  inside an autograd function; its backward all-reduces each row's
  sum(p * dp), the softmax's one coupling across genes.
- `sum`: the loss's gene sum, all-reduced in the forward; every rank then
  holds the same loss, and the backward hands each rank the cotangent of its
  own part (the identity).

So each rank's backward yields the part of every gradient that its genes
contribute, through the softmax's full coupling: the replicated parameters'
gradients are summed over "model" (and averaged over "data") by the task's
step, which gives the gradient of the one loss.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist



def split_sizes(n: int, parts: int) -> List[int]:
    """`n` split into `parts` contiguous sizes, the first ones one longer."""
    return [n // parts + (1 if i < n % parts else 0) for i in range(parts)]


class _SoftmaxAcross(torch.autograd.Function):
    """softmax over the last axis of a tensor whose last axis is split over
    the ranks of `group`."""

    @staticmethod
    def forward(ctx, s, group):
        m = s.amax(dim=-1, keepdim=True)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(s - m)
        z = e.sum(dim=-1, keepdim=True)
        dist.all_reduce(z, group=group)
        p = e / z
        ctx.save_for_backward(p)
        ctx.group = group
        return p

    @staticmethod
    def backward(ctx, dp):
        (p,) = ctx.saved_tensors
        dot = (p * dp).sum(dim=-1, keepdim=True)
        dist.all_reduce(dot, group=ctx.group)
        return p * (dp - dot), None


class _SumAcross(torch.autograd.Function):
    """The sum of each rank's tensor over `group`; the backward passes each
    rank the cotangent of its own term."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class GeneSP:
    """This "model" rank's range of `n_genes` genes, lo..hi (0-based, the
    canonical gene ids lo + 1..hi), and the collectives across the ranges."""

    def __init__(self, group, n_genes: int):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.n_genes = n_genes
        self.sizes = split_sizes(n_genes, self.size)
        if min(self.sizes) < 1:
            raise ValueError(f"{n_genes} genes do not split over {self.size} model ranks")
        self.lo = sum(self.sizes[: self.rank])
        self.hi = self.lo + self.sizes[self.rank]

    def take(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's genes of a tensor with the whole gene axis at `dim`."""
        return x.narrow(dim, self.lo, self.hi - self.lo)

    def softmax(self, s: torch.Tensor) -> torch.Tensor:
        """softmax over the whole gene axis of this rank's logits (last axis)."""
        return _SoftmaxAcross.apply(s, self.group)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of each rank's `x` (differentiable)."""
        return _SumAcross.apply(x, self.group)

    @torch.no_grad()
    def total(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of each rank's `x`, without gradient."""
        y = x.detach().clone()
        dist.all_reduce(y, group=self.group)
        return y

    @torch.no_grad()
    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The whole gene axis (at `dim`) from every rank's range, in order."""
        dim = dim % x.ndim
        width = max(self.sizes)
        local = x.detach().movedim(dim, 0)
        pad = local.new_zeros((width,) + tuple(local.shape[1:]))
        pad[: local.shape[0]] = local
        out = pad.new_empty((self.size * width,) + tuple(pad.shape[1:]))
        dist.all_gather_into_tensor(out, pad, group=self.group)
        full = torch.cat([out[i * width: i * width + n] for i, n in enumerate(self.sizes)])
        return full.movedim(0, dim).contiguous()

