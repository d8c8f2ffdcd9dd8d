"""Code-embedding generator — the code2vec analogue (paper §3.1); the port
of ``repro/core/embedding.py``.

A site's leaves are name-free operand descriptors (dim buckets, dtype,
layout, causality, fusion); a path context is (leaf_i, role-pair path,
leaf_j); the embedder attention-pools the contexts into one 340-feature
code vector and is trained end to end with the agent.  Featurization is
NumPy and bitwise-equal to the reference's.
"""
from __future__ import annotations

import itertools
import math
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.models.compute import KernelSite

_KINDS = ("matmul", "attention", "chunk_scan")
_ROLES = ("m", "n", "k", "batch")
_N_BUCKETS = 26
_DTYPES = ("bfloat16", "float32", "float16", "int8")
_LAYOUTS = ("nn", "nt", "tn", "tt")


def _build_vocab():
    toks: List[str] = ["<pad>"]
    for r in _ROLES:
        toks += [f"{r}:b{i}" for i in range(_N_BUCKETS)]
        toks += [f"{r}:align{a}" for a in (0, 1)]
    toks += [f"dtype:{d}" for d in _DTYPES]
    toks += [f"layout:{l}" for l in _LAYOUTS]
    toks += ["causal:0", "causal:1"]
    toks += [f"fused:{i}" for i in range(4)]
    return {t: i for i, t in enumerate(toks)}


_VOCAB = _build_vocab()
N_TOKENS = len(_VOCAB)

_PATHS = ["<pad>"] + [f"{k}|{a}-{b}" for k in _KINDS
                      for a, b in itertools.combinations_with_replacement(
                          ("dim", "dtype", "layout", "flag"), 2)]
_PATH_IDX = {p: i for i, p in enumerate(_PATHS)}
N_PATHS = len(_PATHS)

MAX_PATHS = 32
EMBED_DIM = 340
TOK_DIM = 64


def _bucket(v: int) -> int:
    return min(_N_BUCKETS - 1, int(math.log2(max(1, v))))


def _leaf_tokens(site: KernelSite) -> List[Tuple[str, str]]:
    leaves = []
    for r, v in (("m", site.m), ("n", site.n), ("k", site.k),
                 ("batch", site.batch)):
        leaves.append((f"{r}:b{_bucket(v)}", "dim"))
        leaves.append((f"{r}:align{int(v % 128 == 0)}", "dim"))
    leaves.append((f"dtype:{site.dtype}", "dtype"))
    leaves.append((f"layout:{site.transpose}", "layout"))
    leaves.append((f"causal:{int(site.causal)}", "flag"))
    leaves.append((f"fused:{min(site.fused_ops, 3)}", "flag"))
    return leaves


_FEAT_CACHE: dict = {}
_FEAT_CACHE_MAX = 65536


def featurize(site: KernelSite,
              cache: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """-> (contexts (MAX_PATHS, 3) int32, mask (MAX_PATHS,) f32),
    memoized (read-only arrays).  ``cache=False`` neither reads nor fills
    the memo and returns fresh, writable arrays of the same values (the
    seed's path, ``PPOAgent(fused=False)``)."""
    key = site.key()
    if cache:
        hit = _FEAT_CACHE.get(key)
        if hit is not None:
            return hit
    leaves = _leaf_tokens(site)
    ctxs = []
    for (ta, ca), (tb, cb) in itertools.combinations(leaves, 2):
        pa, pb = sorted((ca, cb))
        path = f"{site.kind}|{pa}-{pb}"
        ctxs.append((_VOCAB[ta], _PATH_IDX.get(path, 0), _VOCAB[tb]))
    if len(ctxs) > MAX_PATHS:
        step = len(ctxs) / MAX_PATHS
        ctxs = [ctxs[int(i * step)] for i in range(MAX_PATHS)]
    arr = np.zeros((MAX_PATHS, 3), np.int32)
    mask = np.zeros((MAX_PATHS,), np.float32)
    for i, c in enumerate(ctxs):
        arr[i] = c
        mask[i] = 1.0
    if cache:
        arr.flags.writeable = False
        mask.flags.writeable = False
        if len(_FEAT_CACHE) >= _FEAT_CACHE_MAX:
            _FEAT_CACHE.clear()
        _FEAT_CACHE[key] = (arr, mask)
    return arr, mask


def featurize_batch(sites, cache: bool = True
                    ) -> Tuple[np.ndarray, np.ndarray]:
    fs = [featurize(s, cache=cache) for s in sites]
    return (np.stack([f[0] for f in fs]), np.stack([f[1] for f in fs]))


def embedder_init(gen: torch.Generator, device="cpu"):
    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)
    return {"tok": normal(N_TOKENS, TOK_DIM) * 0.1,
            "path": normal(N_PATHS, TOK_DIM) * 0.1,
            "W": normal(3 * TOK_DIM, EMBED_DIM) * (1.0 / math.sqrt(3 * TOK_DIM)),
            "att": normal(EMBED_DIM) * 0.1}


def _pool(params, c, mask):
    score = c @ params["att"]                        # (B, MAX_PATHS)
    score = torch.where(mask > 0, score, torch.full_like(score, -1e30))
    alpha = torch.softmax(score, dim=-1)
    return torch.einsum("bp,bpe->be", alpha, c)


def embed_sites(params, contexts, mask):
    """contexts (B, MAX_PATHS, 3) int; mask (B, MAX_PATHS) -> (B, EMBED_DIM).
    The projection is factored through the vocab tables (each token/path
    row projected once), the same math as :func:`embed_sites_ref`."""
    W = params["W"]
    tok_a = params["tok"] @ W[:TOK_DIM]
    pth_w = params["path"] @ W[TOK_DIM:2 * TOK_DIM]
    tok_b = params["tok"] @ W[2 * TOK_DIM:]
    c = torch.tanh(tok_a[contexts[..., 0]] + pth_w[contexts[..., 1]]
                   + tok_b[contexts[..., 2]])
    return _pool(params, c, mask)


def embed_sites_ref(params, contexts, mask):
    """The unfactored formulation: per-context concat, then project."""
    t1 = params["tok"][contexts[..., 0]]
    pth = params["path"][contexts[..., 1]]
    t2 = params["tok"][contexts[..., 2]]
    c = torch.tanh(torch.cat([t1, pth, t2], -1) @ params["W"])
    return _pool(params, c, mask)
