from particle_filters_tpu_torch.core.structs import PFState
from particle_filters_tpu_torch.models.particle_filter import ParticleFilter

__all__ = ["PFState", "ParticleFilter"]
