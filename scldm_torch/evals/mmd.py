"""MMD kernels and the biased MMD estimate (counterpart of
scldm_tpu/evals/mmd.py; the reference's evaluations.py:10-82), with its
names and inputs.

The elementwise kernels (Bray-Curtis, Tanimoto, Ruzicka) are O(Bx By D).
JAX takes blocks of 512 rows of x against all of y and lets XLA fuse the
gene reduction; eager PyTorch would materialise each block's (512, By, D)
temporaries (35.7 GB at 1,024 cells of 17,002 genes). Here the rows of x
and the genes are both blocked, so no temporary exceeds `PAIR_BUDGET`
elements whatever the sign of the input; the gene sums run block by block.
"""

from __future__ import annotations

from functools import partial

import torch

#: elements of one (rows of x, rows of y, genes) temporary: 512 MiB in f32
PAIR_BUDGET = 1 << 27


def rbf_kernel(x: torch.Tensor, y: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    return torch.exp(-scale * _sq_dists(x, y))


def _sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances, clamped at 0: f32 cancellation on large
    raw counts can drive the expanded form negative."""
    x_norm = torch.sum(x * x, dim=1, keepdim=True)
    y_norm = torch.sum(y * y, dim=1, keepdim=True)
    return torch.clamp_min(x_norm - 2.0 * x @ y.T + y_norm.T, 0.0)


def median(x: torch.Tensor) -> torch.Tensor:
    """`jnp.median` of all of x: with an even count, the mean of the two
    middle values (`torch.median` returns the lower one, and
    `torch.quantile` refuses more than 2^24 elements)."""
    v = torch.sort(x.reshape(-1)).values
    n = v.numel()
    return (v[(n - 1) // 2] + v[n // 2]) * 0.5


def rbf_mmd_median(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Biased RBF MMD^2 with the median-distance bandwidth: the inputs
    rescaled to unit RMS (every intermediate finite in f32), the bandwidth
    the median squared cross-distance (scale-invariant, so the statistic is
    the same in the rescaled units)."""
    rms = torch.sqrt(0.5 * (torch.mean(x * x) + torch.mean(y * y)))
    s = torch.clamp_min(rms, 1e-12)
    xs, ys = x / s, y / s
    sq_xy = _sq_dists(xs, ys)
    gamma = 1.0 / torch.clamp_min(median(sq_xy), 1e-12)
    k_xx = torch.exp(-gamma * _sq_dists(xs, xs)).mean()
    k_yy = torch.exp(-gamma * _sq_dists(ys, ys)).mean()
    k_xy = torch.exp(-gamma * sq_xy).mean()
    return k_xx + k_yy - 2.0 * k_xy


def _blocked_pairwise(terms, combine, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K[i, j] = combine(num, den), with (num, den) the gene sums of
    `terms(x_i, y_j)`, over blocks of rows of x and of genes small enough
    that one (rows, len(y), genes) temporary holds at most `PAIR_BUDGET`
    elements."""
    n, m, d = x.shape[0], y.shape[0], x.shape[1]
    budget = PAIR_BUDGET
    genes = max(1, min(d, budget // max(m, 1)))
    rows = max(1, min(n, budget // (m * genes)))
    out = torch.empty((n, m), dtype=torch.promote_types(x.dtype, torch.float32),
                      device=x.device)
    for r in range(0, n, rows):
        num = den = 0.0
        for g in range(0, d, genes):
            a, b = terms(x[r:r + rows, None, g:g + genes], y[None, :, g:g + genes])
            num = num + a.sum(-1)
            den = den + b.sum(-1)
        out[r:r + rows] = combine(num, den)
    return out


def bray_curtis_kernel(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return _blocked_pairwise(lambda a, b: (torch.abs(a - b), torch.abs(a + b)),
                             lambda num, den: 1.0 - num / (den + 1e-8), x, y)


def tanimoto_kernel(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    def terms(a, b):
        ab = a * b
        return ab, a + b - ab

    return _blocked_pairwise(terms, lambda num, den: num / (den + 1e-8), x, y)


def ruzicka_kernel(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return _blocked_pairwise(lambda a, b: (torch.minimum(a, b), torch.maximum(a, b)),
                             lambda num, den: num / (den + 1e-8), x, y)


def mmd_loss(kernel, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Biased MMD^2 estimate: mean Kxx + mean Kyy - 2 mean Kxy."""
    return kernel(x, x).mean() + kernel(y, y).mean() - 2.0 * kernel(x, y).mean()


#: the reference's registry (models.py:39-44). Keys containing "counts" are
#: evaluated on log1p-CPM counts, the others on raw counts; mmd_rbf is the
#: median-bandwidth variant, as in JAX.
MMD_METRICS = {
    "mmd_braycurtis_counts": partial(mmd_loss, bray_curtis_kernel),
    "mmd_tanimoto": partial(mmd_loss, tanimoto_kernel),
    "mmd_ruzicka_counts": partial(mmd_loss, ruzicka_kernel),
    "mmd_rbf": rbf_mmd_median,
}
