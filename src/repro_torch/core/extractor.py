"""Kernel-site extraction — the paper's "automatic loop extractor" (§3);
the port of ``repro/core/extractor.py``.

Runs a step function on ``meta`` tensors (shapes and dtypes, no data, no
compute — where the reference uses ``jax.eval_shape``) with a
:class:`SiteRecorder` installed; every tunable op registers its shapes.
The per-layer loop records each layer's (identical) key, which the
recorder de-duplicates, as the reference's scan records it once.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.configs.base import get_config
from repro_torch.models import compute
from repro_torch.models.lm import build_model

META = torch.device("meta")


def extract_sites(fn, *args) -> List[compute.KernelSite]:
    """Run ``fn(*args)`` (``meta`` tensors) in eager mode, collecting sites."""
    rec = compute.SiteRecorder()
    with compute.compute_mode("eager", recorder=rec), torch.no_grad():
        fn(*args)
    return rec.unique_sites()


def meta_batch(batch: int, seq: int) -> dict:
    return {"tokens": torch.empty((batch, seq), dtype=torch.long,
                                  device=META),
            "targets": torch.empty((batch, seq), dtype=torch.long,
                                   device=META)}


def extract_arch_sites(arch: str, batch: int = 8,
                       seq: int = 2048) -> List[compute.KernelSite]:
    """All tunable sites in one training step of a ported architecture."""
    model = build_model(get_config(arch))
    params = model.init(device=META)
    return extract_sites(lambda p, b: model.train_loss(p, b), params,
                         meta_batch(batch, seq))


def extract_serve_sites(model, batch: int, prompt_len: int,
                        gen: int) -> List[compute.KernelSite]:
    """The sites of the prefill step and of a decode step, de-duplicated
    (the serve driver's extraction)."""
    from repro_torch.train.steps import make_prefill_step, make_serve_step
    params = model.init(device=META)
    cache = model.make_cache(batch, prompt_len + gen, device=META)
    sites = {s.key(): s for s in extract_sites(
        make_prefill_step(model), params,
        {"tokens": torch.empty((batch, prompt_len), dtype=torch.long,
                               device=META)}, cache)}
    sites.update((s.key(), s) for s in extract_sites(
        make_serve_step(model), params,
        torch.empty((batch, 1), dtype=torch.long, device=META), 0, cache))
    return list(sites.values())
