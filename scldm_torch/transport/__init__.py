"""Flow-matching transport and ODE samplers."""

from scldm_torch.transport.factory import create_transport
from scldm_torch.transport.transport import Sampler, Transport, mean_flat

__all__ = ["Sampler", "Transport", "create_transport", "mean_flat"]
