"""Contracts shared across the port (from ``repro/core/protocols.py``):
agent-state versioning for ``Agent.load_state`` implementations, the
:class:`MeasureTransport` contract of how measurements execute, and
:func:`resolve_health`.  The ``Agent``/``Oracle`` protocols and the
``AsyncOracle`` adapter wait for the facade."""
from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

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
