"""Input pipelines of the port (:mod:`repro_torch.data.pipeline`)."""
