"""Kernel-site extraction — the paper's "automatic loop extractor" (§3);
the port of ``repro/core/extractor.py``.

Runs a step function on ``meta`` tensors (shapes and dtypes, no data, no
compute — where the reference uses ``jax.eval_shape``) with a
:class:`SiteRecorder` installed; every tunable op registers its shapes.
The per-layer loop records each layer's (identical) key, which the
recorder de-duplicates, as the reference's scan records it once.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.models import compute
from repro_torch.models.lm import build_model
from repro_torch.obs import trace

META = torch.device("meta")


def extract_sites(fn, *args) -> List[compute.KernelSite]:
    """Run ``fn(*args)`` (``meta`` tensors) in eager mode, collecting sites."""
    rec = compute.SiteRecorder()
    with compute.compute_mode("eager", recorder=rec), torch.no_grad():
        fn(*args)
    return rec.unique_sites()


def meta_batch(batch: int, seq: int,
               cfg: Optional[ModelConfig] = None) -> dict:
    """A train batch of ``seq`` positions on ``meta`` (the reference's
    ``_abstract_batch``): a vision frontend takes its prefix out of the
    tokens and adds f32 ``frontend_embeds``; an encoder-decoder adds f32
    ``src_embeds`` of ``seq`` positions."""
    n_pre = cfg.n_prefix if cfg is not None else 0
    b = {"tokens": torch.empty((batch, seq - n_pre), dtype=torch.long,
                               device=META),
         "targets": torch.empty((batch, seq - n_pre), dtype=torch.long,
                                device=META)}
    if n_pre:
        b["frontend_embeds"] = torch.empty((batch, n_pre, cfg.d_model),
                                           device=META)
    if cfg is not None and cfg.enc_dec:
        b["src_embeds"] = torch.empty((batch, seq, cfg.d_model), device=META)
    return b


def serve_batch(cfg: ModelConfig, prompts: torch.Tensor) -> dict:
    """The prefill batch of a serve, beside its ``(B, prompt_len)``
    prompts: a vision frontend's zero ``frontend_embeds``; an
    encoder-decoder's ``src_embeds`` of ``prompt_len`` positions,
    ``normal * 0.02`` from a CPU generator seeded 2 (the reference's
    serve draws them from ``PRNGKey(2)``)."""
    B, S = prompts.shape
    dev = prompts.device
    batch = {"tokens": prompts}
    if cfg.frontend == "vision":
        batch["frontend_embeds"] = torch.zeros(
            (B, cfg.n_frontend_tokens, cfg.d_model), device=dev)
    if cfg.enc_dec:
        src = torch.empty((B, S, cfg.d_model))
        if dev.type != "meta":
            gen = torch.Generator().manual_seed(2)
            src = torch.randn((B, S, cfg.d_model), generator=gen) * 0.02
        batch["src_embeds"] = src.to(dev)
    return batch


def serve_ctx(cfg: ModelConfig, prompt_len: int, gen: int) -> int:
    """The cache's positions a serve needs: the frontend prefix, the
    prompt and the generated tokens (the reference's serve leaves out the
    prefix and fails wherever it is longer than ``gen``)."""
    return cfg.n_prefix + prompt_len + gen


def extract_arch_sites(arch: str, batch: int = 8,
                       seq: int = 2048) -> List[compute.KernelSite]:
    """All tunable sites in one training step of a ported architecture."""
    cfg = get_config(arch)
    model = build_model(cfg)
    params = model.init(device=META)
    return extract_sites(lambda p, b: model.train_loss(p, b), params,
                         meta_batch(batch, seq, cfg))


def extract_serve_sites(model, batch: int, prompt_len: int,
                        gen: int) -> List[compute.KernelSite]:
    """The sites of the prefill step and of a decode step, de-duplicated
    (the serve driver's extraction).  Traced as ``nv.extract``, its parts
    ``nv.extract.init`` (the ``meta`` parameters and cache),
    ``nv.extract.prefill`` and ``nv.extract.decode``."""
    from repro_torch.train.steps import make_prefill_step, make_serve_step
    tr = trace.active()
    with tr.span("nv.extract", batch=batch, prompt_len=prompt_len, gen=gen):
        with tr.span("nv.extract.init"):
            params = model.init(device=META)
            cache = model.make_cache(
                batch, serve_ctx(model.cfg, prompt_len, gen), device=META)
            prompts = torch.empty((batch, prompt_len), dtype=torch.long,
                                  device=META)
        with tr.span("nv.extract.prefill"):
            sites = {s.key(): s for s in extract_sites(
                make_prefill_step(model), params,
                serve_batch(model.cfg, prompts), cache)}
        with tr.span("nv.extract.decode"):
            sites.update((s.key(), s) for s in extract_sites(
                make_serve_step(model), params,
                torch.empty((batch, 1), dtype=torch.long, device=META), 0,
                cache))
    return list(sites.values())
