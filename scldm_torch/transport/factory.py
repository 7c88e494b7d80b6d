"""Transport factory (counterpart of scldm_tpu/transport/factory.py)."""

from __future__ import annotations

from typing import Optional

from scldm_torch.transport.transport import ModelType, PathType, Transport, WeightType

PATH_TYPES = {"Linear": PathType.LINEAR, "GVP": PathType.GVP, "VP": PathType.VP}


def create_transport(
    path_type: str = "Linear",
    prediction: str = "velocity",
    loss_weight: Optional[str] = None,
    train_eps: Optional[float] = None,
    sample_eps: Optional[float] = None,
) -> Transport:
    """A Transport from the reference's config keys, with its per-path
    default epsilons: 1e-5 / 1e-3 on the VP path, 1e-3 / 1e-3 for noise or
    score prediction on the others, 0 / 0 for velocity on the others. An
    unknown prediction or loss weight means velocity or none, as in JAX; an
    unknown path raises a KeyError, as JAX's lookup does."""
    if prediction == "noise":
        model_type = ModelType.NOISE
    elif prediction == "score":
        model_type = ModelType.SCORE
    else:
        model_type = ModelType.VELOCITY

    if loss_weight == "velocity":
        loss_type = WeightType.VELOCITY
    elif loss_weight == "likelihood":
        loss_type = WeightType.LIKELIHOOD
    else:
        loss_type = WeightType.NONE

    path_enum = PATH_TYPES[path_type]
    if path_enum == PathType.VP:
        default_train, default_sample = 1e-5, 1e-3
    elif model_type != ModelType.VELOCITY:
        default_train, default_sample = 1e-3, 1e-3
    else:  # velocity on the Linear and GVP paths is stable everywhere
        default_train, default_sample = 0.0, 0.0
    return Transport(
        model_type=model_type,
        path_type=path_enum,
        loss_type=loss_type,
        train_eps=default_train if train_eps is None else train_eps,
        sample_eps=default_sample if sample_eps is None else sample_eps,
    )
