"""Deterministic synthetic token pipeline, shard-aware and restartable
(the port of ``repro/data/pipeline.py``).

Every host materializes only its shard of the global batch; ``batch_at(step)``
is a pure function of ``(seed, step, host_index)``, so a restore at step N
sees exactly the stream a run without the failure would have seen (no
data-loader state in checkpoints).  The draws come from a CPU
``torch.Generator`` seeded from those three numbers, so a batch is the
same on every device; they do not repeat ``jax.random``'s stream.  A
vision frontend's batch holds ``seq_len - n_frontend_tokens`` tokens and
``frontend_embeds`` (B, n_frontend_tokens, d); an encoder-decoder's also
``src_embeds`` (B, seq_len, d): both f32 ``normal * 0.02``, as the
reference's.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

FOLLOW_P = 0.9          # share of positions that follow the affine rule


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    host_index: int = 0
    host_count: int = 1


class SyntheticPipeline:
    """Zipf-ish token stream + targets = next token (causal LM)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 data_cfg: DataConfig = DataConfig(), device="cpu"):
        if shape.global_batch % data_cfg.host_count:
            raise ValueError(f"global batch {shape.global_batch} is not a "
                             f"multiple of {data_cfg.host_count} hosts")
        self.cfg = cfg
        self.shape = shape
        self.dc = data_cfg
        self.device = torch.device(device)
        self.local_batch = shape.global_batch // data_cfg.host_count

    def _generator(self, step: int) -> torch.Generator:
        seq = np.random.SeedSequence([self.dc.seed, step, self.dc.host_index])
        return torch.Generator().manual_seed(
            int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1)))

    def _tokens(self, gen: torch.Generator, batch: int, seq: int):
        """Learnable synthetic stream: with p = 0.9 the next token follows
        the affine rule ``(prev * 5 + 7) % V`` (so the LM has signal to
        fit), else it resets to a Zipf-ish random token ``u² (V - 1)``."""
        V = self.cfg.vocab_size
        u = torch.rand((batch, seq + 1), generator=gen)
        noise = (u * u * (V - 1)).long()
        follow = torch.rand((batch, seq + 1), generator=gen) < FOLLOW_P
        out = torch.empty((batch, seq + 1), dtype=torch.long)
        out[:, 0] = noise[:, 0]
        for t in range(1, seq + 1):
            out[:, t] = torch.where(follow[:, t], (out[:, t - 1] * 5 + 7) % V,
                                    noise[:, t])
        return out

    def batch_at(self, step: int) -> dict:
        cfg, seq = self.cfg, self.shape.seq_len
        gen = self._generator(step)
        n_pre = cfg.n_prefix
        toks = self._tokens(gen, self.local_batch, seq - n_pre)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if n_pre:
            batch["frontend_embeds"] = torch.randn(
                (self.local_batch, n_pre, cfg.d_model), generator=gen) * 0.02
        if cfg.enc_dec:
            batch["src_embeds"] = torch.randn(
                (self.local_batch, seq, cfg.d_model), generator=gen) * 0.02
        return {k: v.to(self.device) for k, v in batch.items()}
