"""The kernel site: one tunable kernel instance with its shapes and dtype,
the unit every agent, oracle and transport speaks of (the reference's
``KernelSite`` of ``repro/models/compute.py``).  Kept free of torch so a
measurement worker whose runner needs no torch starts at once."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class KernelSite:
    """A tunable kernel instance — the analogue of one extracted loop.
    Keys are byte-identical to the JAX package's."""

    site: str
    kind: str            # "matmul" | "attention" | "chunk_scan"
    m: int               # matmul M / attention q_len
    n: int               # matmul N / attention head_dim
    k: int               # matmul K / attention kv_len
    batch: int = 1       # attention B*heads; matmul 1
    dtype: str = "bfloat16"
    transpose: str = "nn"
    causal: bool = False
    fused_ops: int = 0

    def key(self) -> str:
        k = self.__dict__.get("_key")
        if k is None:
            k = (f"{self.kind}:{self.site}:m{self.m}n{self.n}k{self.k}"
                 f"b{self.batch}:{self.dtype}:{self.transpose}"
                 f"{':c' if self.causal else ''}:f{self.fused_ops}")
            object.__setattr__(self, "_key", k)
        return k


class SiteRecorder:
    def __init__(self):
        self.sites: dict[str, KernelSite] = {}

    def record(self, s: KernelSite):
        self.sites[s.key()] = s

    def unique_sites(self) -> list[KernelSite]:
        return list(self.sites.values())
