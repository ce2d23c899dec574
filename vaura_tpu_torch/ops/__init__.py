"""Ops of the port; counterparts of ``vaura_tpu/ops``."""
