"""Agent-state versioning shared by ``Agent.load_state`` implementations:
the port's copy of ``AGENT_STATE_VERSION``/``check_agent_state`` from
``repro/core/protocols.py`` (the protocols themselves wait)."""
from __future__ import annotations

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
