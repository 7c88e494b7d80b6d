"""Per-condition log-library-size sampling for generation (counterpart of
scldm_tpu/sampling/size_factors.py): the per-class mu/sd statistics baked
into dense tables at construction, one gather plus one generator-driven
normal draw for the whole batch. Under `condition_strategy="joint"` the
table is (n1, n2), keyed by the pair of labels. Missing statistics give
zeros."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def constant_stats(class_vocab_sizes: Dict[str, int], mu: float = 6.0, sd: float = 0.1):
    """A statistics carrier with the same mu/sd for every class, for benches
    and smoke runs without metadata files."""

    class _Stats:
        mu_size_factor = {k: {i: mu for i in range(n)} for k, n in class_vocab_sizes.items()}
        sd_size_factor = {k: {i: sd for i in range(n)} for k, n in class_vocab_sizes.items()}
        joint_key = None
        joint_components = None
        joint_idx_2_classes = None

    _Stats.class_vocab_sizes = dict(class_vocab_sizes)
    return _Stats()


def _gather_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's gather semantics for one axis: a negative index counts from the
    end, then every index is clamped into [0, n)."""
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


class SizeFactorSampler:
    """Vectorised Normal(mu[class], sd[class]) sampler over condition labels.

    Under `condition_strategy="joint"`, with an encoder that carries the
    joint statistics (`joint_key`, `joint_idx_2_classes` keyed "i1_i2", the
    first two keys of `class_vocab_sizes` in insertion order as the table's
    axes), one (n1, n2) table; pairs without statistics hold mu = sd = 0.
    Otherwise one (n,) table per label, keyed by class index. An encoder
    whose `joint_key` is None takes the per-label tables under either
    strategy, as in JAX.

    `condition_strategy` defaults to the encoder's own (`mutually_exclusive`
    for a carrier without one), so a joint encoder gets its joint table
    without the caller repeating the strategy. Asked for per-label tables, a
    joint encoder has none: its statistics are keyed by label pair, and the
    sampler then draws zeros (JAX's constructor raises a TypeError there)."""

    def __init__(self, vocab_encoder, condition_strategy: Optional[str] = None):
        if condition_strategy is None:
            condition_strategy = getattr(vocab_encoder, "condition_strategy",
                                         "mutually_exclusive")
        self.strategy = condition_strategy
        self.tables: Dict[str, tuple[torch.Tensor, torch.Tensor]] = {}
        self.joint_table: Optional[tuple[torch.Tensor, torch.Tensor]] = None
        self.joint_components = getattr(vocab_encoder, "joint_components", None)

        mu_map = getattr(vocab_encoder, "mu_size_factor", None)
        sd_map = getattr(vocab_encoder, "sd_size_factor", None)
        if mu_map is None or sd_map is None:
            return

        if condition_strategy == "joint" and vocab_encoder.joint_key is not None:
            jk = vocab_encoder.joint_key
            if jk in mu_map and jk in sd_map and vocab_encoder.joint_idx_2_classes:
                c1, c2 = vocab_encoder.class_vocab_sizes.keys()
                n1 = vocab_encoder.class_vocab_sizes[c1]
                n2 = vocab_encoder.class_vocab_sizes[c2]
                mu_t = np.zeros((n1, n2), np.float32)
                sd_t = np.zeros((n1, n2), np.float32)
                for key, token in vocab_encoder.joint_idx_2_classes.items():
                    i1, i2 = (int(v) for v in key.split("_"))
                    mu_t[i1, i2] = mu_map[jk].get(token, 0.0)
                    sd_t[i1, i2] = sd_map[jk].get(token, 0.0)
                self.joint_table = (torch.from_numpy(mu_t), torch.from_numpy(sd_t))
        else:
            for label, stats in mu_map.items():
                if label not in sd_map or label == getattr(vocab_encoder, "joint_key", None):
                    continue
                n = max(stats.keys()) + 1 if stats else 0
                mu_t = np.zeros((n,), np.float32)
                sd_t = np.zeros((n,), np.float32)
                for idx, v in stats.items():
                    mu_t[idx] = v
                for idx, v in sd_map[label].items():
                    if idx < n:
                        sd_t[idx] = v
                self.tables[label] = (torch.from_numpy(mu_t), torch.from_numpy(sd_t))

    def sample(
        self,
        generator: torch.Generator,
        condition: Optional[Dict[str, torch.Tensor]],
        batch_size: int,
        device: torch.device | str,
    ) -> torch.Tensor:
        """Log size factors (batch_size,) f32 on `device`, drawn from
        `generator`: from the joint table when the strategy is joint and both
        of its labels are in `condition`, else from the first condition label
        (in sorted order) that has a table; zeros when none has."""
        if condition is None:
            return torch.zeros((batch_size,), device=device)

        if self.strategy == "joint" and self.joint_table is not None:
            keys = [k for k in (self.joint_components or list(condition)) if k in condition]
            if len(keys) == 2:
                mu_t, sd_t = (a.to(device) for a in self.joint_table)
                i1 = _gather_index(condition[keys[0]], mu_t.shape[0])
                i2 = _gather_index(condition[keys[1]], mu_t.shape[1])
                noise = torch.randn((batch_size,), generator=generator, device=device)
                return mu_t[i1, i2] + sd_t[i1, i2] * noise

        for label in sorted(condition):
            if label in self.tables:
                mu_t, sd_t = (a.to(device) for a in self.tables[label])
                idx = condition[label].long().clamp(0, mu_t.shape[0] - 1)
                noise = torch.randn((batch_size,), generator=generator, device=device)
                return mu_t[idx] + sd_t[idx] * noise
        return torch.zeros((batch_size,), device=device)
