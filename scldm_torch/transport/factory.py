"""Transport factory (counterpart of scldm_tpu/transport/factory.py)."""

from __future__ import annotations

from typing import Optional

from scldm_torch.transport.transport import Transport


def create_transport(
    path_type: str = "Linear",
    prediction: str = "velocity",
    loss_weight: Optional[str] = None,
    train_eps: Optional[float] = None,
    sample_eps: Optional[float] = None,
) -> Transport:
    """A Transport from the reference's config keys, with its per-path
    default epsilons (0 and 0 for velocity on the Linear path). Only the
    Linear path with velocity prediction is ported; others raise."""
    if path_type != "Linear" or prediction != "velocity":
        raise NotImplementedError(
            f"transport {path_type}/{prediction} is not ported (only Linear/velocity)"
        )
    return Transport(
        loss_weight=loss_weight,
        train_eps=0.0 if train_eps is None else train_eps,
        sample_eps=0.0 if sample_eps is None else sample_eps,
    )
