"""Fault tolerance of the port (:mod:`repro_torch.ft.monitor`)."""
