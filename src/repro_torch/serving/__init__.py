"""``repro_torch.serving`` — batched tuning behind a latency SLO (the port
of ``repro/serving``).

The serving layer over :class:`~repro_torch.service.TuningService`:

* :class:`FusedTuner` — cost-model or surrogate tuning as one device
  dispatch (the cost grid, the legality mask and the greedy argmin; on the
  card one CUDA graph replay per batch);
* :class:`AgentBatch` — concurrent sessions' ``act`` calls coalesced
  through one agent forward, each request's result its solo one;
* :class:`Server` — the deadline-aware admission queue: per-request SLO
  budgets, max-wait/max-batch flush, typed shedding (:class:`QueueFull` /
  :class:`DeadlineExceeded`), ``health()`` and ``serving_*`` ``stats()``.

Callers normally never touch this package directly::

    with TuningService(cfg, serving=True) as svc:      # or ServingConfig(...)
        s = svc.open_session(agent="brute", oracle="model")
        prog = s.tune_async(sites).result()            # one device dispatch
"""
from repro_torch.serving.batcher import AgentBatch
from repro_torch.serving.fused import FusedTuner, bucket_size
from repro_torch.serving.server import (DeadlineExceeded, QueueFull, Server,
                                        ServingConfig, ServingError)

__all__ = ["AgentBatch", "FusedTuner", "bucket_size", "Server",
           "ServingConfig", "ServingError", "QueueFull",
           "DeadlineExceeded"]
