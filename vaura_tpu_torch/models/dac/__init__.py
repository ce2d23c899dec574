"""DAC codec, decode direction."""

from vaura_tpu_torch.models.dac.model import Dac, DacConfig, config_for_sample_rate

__all__ = ["Dac", "DacConfig", "config_for_sample_rate"]
