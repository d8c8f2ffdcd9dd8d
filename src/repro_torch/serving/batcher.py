"""Cross-session micro-batching: many concurrent ``act`` requests, one
agent forward (the port of ``repro/serving/batcher.py``).

Almost every agent prices sites row by row, so a batch formed by
concatenating several requests' site lists and running one forward gives
each request what running it alone gives.  :class:`AgentBatch` is that
concatenate, forward once, split step; the admission queue of
:mod:`repro_torch.serving.server` decides when a batch is cut.

The exception is :class:`~repro_torch.core.agents.random_search
.RandomAgent`: its deterministic deployment draw is shaped by the whole
batch, so such an agent runs one ``act`` per request inside the flush.

For :class:`~repro_torch.core.agents.ppo.PPOAgent` the forward goes
through :meth:`~repro_torch.core.agents.ppo.PPOAgent.act_bucketed`, the
batch padded to a power-of-two bucket.

Legality is the port's (the reference has none): with ``oracles``, each
request's legal mask is ``mask_env(oracle).cost_grid(sites)`` finite, as
:func:`~repro_torch.core.vectorizer.tune` computes it; a request with a
site that has no legal action fails alone with ``ValueError``, and the
rest are coalesced with their masks passed as ``legal=``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.agents.ppo import PPOAgent
from repro_torch.core.agents.random_search import RandomAgent
from repro_torch.core.vectorizer import legal_mask, mask_env
from repro_torch.serving.fused import bucket_size

#: act(batch) != concat(act(parts)) for these: served per request
BATCH_UNSAFE = (RandomAgent,)


class AgentBatch:
    """One agent shared by many sessions: concatenated greedy ``act``.

    ``act_many([sites_a, sites_b, ...], oracles)`` runs one agent forward
    over the concatenation and returns per-request ``(n_i, 3)`` action
    arrays in request order (a request that failed its legality check
    gets its ``ValueError`` in its place).  Counters feed
    ``Server.stats()``."""

    def __init__(self, agent):
        self.agent = agent
        self.coalesced = not isinstance(agent, BATCH_UNSAFE)
        self.batches = 0          # forwards executed
        self.requests = 0         # requests served through them
        self.sites = 0            # sites across all forwards
        self.last_batch_sites = 0

    def act_many(self, site_lists: Sequence[List],
                 oracles: Optional[Sequence] = None) -> list:
        site_lists = [list(sl) for sl in site_lists]
        out: list = [None] * len(site_lists)
        masks: list = [None] * len(site_lists)
        if oracles is not None:
            for i, (sl, o) in enumerate(zip(site_lists, oracles)):
                if not sl:
                    continue
                try:
                    masks[i] = legal_mask(sl, mask_env(o))
                except ValueError as e:
                    out[i] = e
        live = [i for i, o in enumerate(out) if o is None]
        flat = [s for i in live for s in site_lists[i]]
        legal = None
        if oracles is not None and flat:
            width = max(masks[i].shape[1] for i in live
                        if masks[i] is not None)
            legal = np.zeros((len(flat), width), bool)
            off = 0
            for i in live:
                m = masks[i]
                if m is not None:
                    legal[off:off + len(m), :m.shape[1]] = m
                    off += len(m)
        if not self.coalesced:
            for i in live:
                out[i] = np.asarray(self.agent.act(
                    site_lists[i], sample=False,
                    **({} if masks[i] is None else {"legal": masks[i]})))
            self.batches += len(live)
        elif flat:
            kw = {} if legal is None else {"legal": legal}
            if isinstance(self.agent, PPOAgent):
                acts = self.agent.act_bucketed(
                    flat, bucket=bucket_size(len(flat)), **kw)
            else:
                acts = np.asarray(self.agent.act(flat, sample=False, **kw))
            self.batches += 1
            off = 0
            for i in live:
                n = len(site_lists[i])
                out[i] = acts[off:off + n]
                off += n
        for i in live:
            if out[i] is None:                 # an empty request
                out[i] = np.zeros((0, 3), np.int64)
        self.requests += len(site_lists)
        self.sites += len(flat)
        self.last_batch_sites = len(flat)
        return out
