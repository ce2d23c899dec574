"""Models of the port; counterparts of ``vaura_tpu/models``."""
