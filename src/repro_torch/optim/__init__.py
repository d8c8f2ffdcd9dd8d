"""Optimizers of the port (the port of ``repro/optim``): AdamW as
functions on trees of tensors (:mod:`repro_torch.optim.adamw`)."""
