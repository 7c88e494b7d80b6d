"""Flow-matching transport: paths, losses, and the ODE, SDE and likelihood
samplers."""

from scldm_torch.transport.factory import create_transport
from scldm_torch.transport.path import GVPCPlan, ICPlan, VPCPlan, expand_t_like_x
from scldm_torch.transport.transport import (
    ModelType,
    PathType,
    Sampler,
    Transport,
    WeightType,
    mean_flat,
)

__all__ = ["GVPCPlan", "ICPlan", "ModelType", "PathType", "Sampler", "Transport", "VPCPlan",
           "WeightType", "create_transport", "expand_t_like_x", "mean_flat"]
