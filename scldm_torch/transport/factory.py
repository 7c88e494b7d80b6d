"""Transport factory (counterpart of scldm_tpu/transport/factory.py)."""

from __future__ import annotations

from scldm_torch.transport.transport import Transport


def create_transport(path_type: str = "Linear", prediction: str = "velocity") -> Transport:
    """A Transport from the reference's config keys. Only the Linear path
    with velocity prediction is ported; the training loss's keys
    (`loss_weight`, `train_eps`) come with training."""
    if path_type != "Linear" or prediction != "velocity":
        raise NotImplementedError(
            f"transport {path_type}/{prediction} is not ported (only Linear/velocity)"
        )
    return Transport()
