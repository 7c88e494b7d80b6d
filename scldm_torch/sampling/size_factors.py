"""Per-condition log-library-size sampling for generation (counterpart of
scldm_tpu/sampling/size_factors.py): dense mu/sd tables per class, one
gather plus one generator-driven normal draw for the whole batch. Missing
statistics give zeros."""

from __future__ import annotations

from typing import Dict, Optional

import torch


def constant_stats(class_vocab_sizes: Dict[str, int], mu: float = 6.0, sd: float = 0.1):
    """A statistics carrier with the same mu/sd for every class, for benches
    and smoke runs without metadata files."""

    class _Stats:
        mu_size_factor = {k: {i: mu for i in range(n)} for k, n in class_vocab_sizes.items()}
        sd_size_factor = {k: {i: sd for i in range(n)} for k, n in class_vocab_sizes.items()}

    return _Stats()


class SizeFactorSampler:
    """Vectorised Normal(mu[class], sd[class]) sampler over condition labels.

    The joint (two-label) table of `condition_strategy="joint"` is not
    ported yet."""

    def __init__(self, vocab_encoder):
        self.tables: Dict[str, tuple[torch.Tensor, torch.Tensor]] = {}
        mu_map = getattr(vocab_encoder, "mu_size_factor", None) or {}
        sd_map = getattr(vocab_encoder, "sd_size_factor", None) or {}
        for label, stats in mu_map.items():
            if label not in sd_map:
                continue
            n = max(stats.keys()) + 1 if stats else 0
            mu_t = torch.zeros((n,))
            sd_t = torch.zeros((n,))
            for idx, v in stats.items():
                mu_t[idx] = v
            for idx, v in sd_map[label].items():
                if idx < n:
                    sd_t[idx] = v
            self.tables[label] = (mu_t, sd_t)

    def sample(
        self,
        generator: torch.Generator,
        condition: Optional[Dict[str, torch.Tensor]],
        batch_size: int,
        device: torch.device | str,
    ) -> torch.Tensor:
        """Log size factors (batch_size,) f32 on `device` from the first
        condition label (in sorted order) that has statistics; zeros when none
        has."""
        for label in sorted(condition or {}):
            if label in self.tables:
                mu_t, sd_t = (a.to(device) for a in self.tables[label])
                idx = condition[label].long().clamp(0, mu_t.shape[0] - 1)
                noise = torch.randn((batch_size,), generator=generator, device=device)
                return mu_t[idx] + sd_t[idx] * noise
        return torch.zeros((batch_size,), device=device)
