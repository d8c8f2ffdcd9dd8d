"""What the port has of ``repro/distributed`` on one card: gradient
compression (:mod:`repro_torch.distributed.compression`)."""
