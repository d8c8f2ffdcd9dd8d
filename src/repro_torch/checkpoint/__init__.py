"""Checkpoints of the port (:mod:`repro_torch.checkpoint.checkpoint`)."""
