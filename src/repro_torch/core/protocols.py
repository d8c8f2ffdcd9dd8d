"""Contracts shared across the port (from ``repro/core/protocols.py``):
the :class:`Agent` protocol of a decision method, the :class:`Oracle`
protocol of a reward source, agent-state versioning for
``Agent.load_state`` implementations, the :class:`MeasureTransport`
contract of how measurements execute, and :func:`resolve_health`.  All
three protocols are ``runtime_checkable``: ``isinstance`` checks that the
members are present, not their signatures.  :class:`AsyncOracle` puts an
oracle and its transport behind one handle, as the tuning service's
sessions hold them."""
from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

import numpy as np

AGENT_STATE_VERSION = 1


def check_agent_state(state: dict, expect_name: str) -> None:
    """The state must carry the matching registry name and a supported
    schema version; raises ``ValueError`` otherwise."""
    if not isinstance(state, dict):
        raise ValueError(f"agent state must be a dict, got {type(state)}")
    name = state.get("name")
    if name != expect_name:
        raise ValueError(f"agent state is for {name!r}, cannot load into "
                         f"a {expect_name!r} agent")
    version = state.get("version")
    if version != AGENT_STATE_VERSION:
        raise ValueError(f"agent state version {version!r} is not the "
                         f"supported {AGENT_STATE_VERSION}")


@runtime_checkable
class Agent(Protocol):
    """A vectorization decision method (RL, NNS, dtree, brute, ...)."""

    name: str

    def fit(self, sites: Sequence, oracle: "Oracle", **kwargs) -> "Agent":
        """Train or label against ``oracle``; returns ``self``.  For the
        search-free methods (random, polly, baseline) a no-op that may
        pick up the oracle's action space."""
        ...

    def act(self, sites: Sequence, *, sample: bool = False,
            legal=None) -> np.ndarray:
        """``(n, 3)`` integer per-head action indices.  ``sample=False``
        (deployment) is deterministic.  ``legal`` ((n, A) bool over flat
        actions, laid out as ``Oracle.cost_grid``) limits the pick to
        those actions; without it the pick is the reference's."""
        ...

    def state_dict(self) -> dict:
        """Everything ``act`` depends on, as plain python values and numpy
        arrays, carrying ``name`` and ``version``; stable, so that saving
        twice without training gives the same fingerprint."""
        ...

    def load_state(self, state: dict) -> "Agent":
        """Restore a ``state_dict`` (validated with
        :func:`check_agent_state`); ``act(sites, sample=False)`` is then
        the saver's, bitwise."""
        ...


@runtime_checkable
class Oracle(Protocol):
    """A batched reward oracle over (site, action) pairs, with the
    penalty semantics of ``cfg`` (``fail_penalty``, ``illegal_slowdown``)
    over the action space ``space``."""

    cfg: object
    space: object

    def baseline_costs(self, sites: Sequence) -> np.ndarray:
        """(n,) heuristic-baseline runtime per site."""
        ...

    def costs_batch(self, sites: Sequence, actions) -> np.ndarray:
        """(n,) runtime under each action; ``inf`` = illegal."""
        ...

    def rewards_batch(self, sites: Sequence, actions) -> np.ndarray:
        """(n,) paper eq. 2 rewards, the fail penalty for illegal."""
        ...

    def speedups_batch(self, sites: Sequence, actions) -> np.ndarray:
        """(n,) t_baseline / t_action, clamped for illegal actions."""
        ...

    def cost_grid(self, sites: Sequence) -> np.ndarray:
        """(n, max_n_actions) cost of every action (``inf`` pads illegal
        tiles and columns past a kind's action count)."""
        ...

    def tiles_costs(self, sites: Sequence, tiles) -> np.ndarray:
        """(n,) runtime under explicit tile values; ``inf`` = illegal."""
        ...


@runtime_checkable
class MeasureTransport(Protocol):
    """An asynchronous executor of ``(site, tiles)`` measurements.

    * ``submit`` returns one future per pair, index-aligned with the pairs;
    * duplicate keys, in flight or repeated within one batch, coalesce to
      one measurement feeding every future;
    * results stream into the attached ``MeasureDB`` exactly once per key,
      and pairs already in it resolve at once without re-measuring;
    * a pair that cannot be measured resolves to ``inf`` (fail-closed),
      never an exception out of ``future.result()``.
    """

    @property
    def backend_key(self) -> str:
        """Measurement-conditions fingerprint (DB cache key component)."""
        ...

    def submit(self, sites: Sequence, tiles) -> Sequence:
        """One future of seconds (``inf`` = failed) per pair, in order."""
        ...

    def drain(self) -> None:
        """Block until every in-flight measurement has resolved."""
        ...

    def close(self) -> None:
        """Drain, then release workers and files.  Idempotent."""
        ...

    def stats(self) -> dict:
        """Counters: ``transport_hits_total``, ``transport_misses_total``,
        ``transport_coalesced_total``, ``transport_timed_pairs_total``,
        ``transport_failed_pairs_total``, ``transport_retries_total``,
        ``transport_inflight_pairs``, ``transport_hit_ratio``."""
        ...

    def health(self) -> str:
        """``"ok"``, ``"degraded"`` or ``"down"``: the signal the oracle's
        circuit breaker consumes."""
        ...

    def __enter__(self) -> "MeasureTransport":
        ...

    def __exit__(self, *exc) -> None:
        ...


def resolve_health(oracle, transport=None) -> str:
    """Oracle-level and transport-level health as one ``ok | degraded |
    down`` verdict.  The oracle's own state wins (an open breaker reports
    ``degraded``); a ``down`` transport under an oracle that can degrade
    is ``degraded``; objects without ``health`` count as ``ok``."""
    h = getattr(oracle, "health", None)
    env_h = h() if callable(h) else "ok"
    if env_h != "ok":
        return env_h
    if transport is None:
        return "ok"
    h = getattr(transport, "health", None)
    t_h = h() if callable(h) else "ok"
    if t_h == "down" and getattr(oracle, "can_degrade", False):
        return "degraded"
    return t_h


class AsyncOracle:
    """A synchronous :class:`Oracle` and its :class:`MeasureTransport`
    behind one handle: the adapter the tuning service's sessions talk to.

    The Oracle surface delegates to ``oracle`` (so ``isinstance(x,
    Oracle)`` holds and agents train against it unchanged), and so does
    ``legality`` (the launch rule the oracle prices tiles under, which the
    legal mask of a tune and the serving route read); the asynchronous
    surface exposes the transport underneath: :meth:`submit_tiles` returns
    raw futures for callers that overlap measurement with other work, and
    :meth:`drain`/:meth:`close` manage its lifecycle.  ``transport=None``
    adapts a purely synchronous oracle (the analytic ``CostModelEnv``);
    closing never closes a transport the adapter did not receive."""

    def __init__(self, oracle: Oracle, transport=None):
        self.oracle = oracle
        self.transport = transport

    # -- Oracle delegation ---------------------------------------------------
    @property
    def cfg(self):
        return self.oracle.cfg

    @property
    def space(self):
        return self.oracle.space

    @property
    def legality(self):
        return getattr(self.oracle, "legality", None)

    def baseline_costs(self, sites: Sequence) -> np.ndarray:
        return self.oracle.baseline_costs(sites)

    def costs_batch(self, sites: Sequence, actions) -> np.ndarray:
        return self.oracle.costs_batch(sites, actions)

    def rewards_batch(self, sites: Sequence, actions) -> np.ndarray:
        return self.oracle.rewards_batch(sites, actions)

    def speedups_batch(self, sites: Sequence, actions) -> np.ndarray:
        return self.oracle.speedups_batch(sites, actions)

    def cost_grid(self, sites: Sequence) -> np.ndarray:
        return self.oracle.cost_grid(sites)

    def tiles_costs(self, sites: Sequence, tiles) -> np.ndarray:
        return self.oracle.tiles_costs(sites, tiles)

    # -- async surface -------------------------------------------------------
    def submit_tiles(self, sites: Sequence, tiles) -> Sequence:
        """Futures of raw seconds per explicit ``(site, tiles)`` pair: the
        overlap path (submit, do other work, ``drain()``, collect)."""
        if self.transport is None:
            raise RuntimeError("AsyncOracle has no transport "
                               "(synchronous oracle): use tiles_costs")
        return self.transport.submit(sites, tiles)

    def drain(self) -> None:
        if self.transport is not None:
            self.transport.drain()

    def close(self) -> None:
        if self.transport is not None:
            self.transport.close()

    def health(self) -> str:
        """``ok | degraded | down`` for this oracle and transport
        (:func:`resolve_health`)."""
        return resolve_health(self.oracle, self.transport)

    def __enter__(self) -> "AsyncOracle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
