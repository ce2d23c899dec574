"""The port's actions (counterparts of the repo's ``scripts/``)."""
