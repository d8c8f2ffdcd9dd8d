"""``repro_torch.artifacts`` — persistent tuning artifacts (the port of
``repro/artifacts``, in its on-disk formats).

* **agent checkpoints** (:mod:`~repro_torch.artifacts.agentio`) — a
  fitted agent's ``state_dict`` as an atomic, fingerprinted directory
  (``save_agent`` / ``load_agent``);
* **tuned programs** (:mod:`~repro_torch.artifacts.store`) —
  :class:`ProgramStore`, an append-only store of finished
  :class:`~repro_torch.core.vectorizer.TileProgram`s keyed by (site set,
  agent state fingerprint, oracle/backend fingerprint).

Consumed by ``NeuroVectorizer.save/load`` and ``program_store=``.
"""
from repro_torch.artifacts.agentio import (ARTIFACT_FORMAT, ArtifactError,
                                           agent_fingerprint,
                                           fingerprint_state, load_agent,
                                           read_agent_state, save_agent)
from repro_torch.artifacts.store import (ProgramStore, open_program_store,
                                         oracle_fingerprint, program_key,
                                         sites_fingerprint,
                                         tune_through_store)

__all__ = ["ArtifactError", "ARTIFACT_FORMAT", "save_agent", "load_agent",
           "read_agent_state", "agent_fingerprint", "fingerprint_state",
           "ProgramStore", "open_program_store", "program_key",
           "oracle_fingerprint", "sites_fingerprint", "tune_through_store"]
