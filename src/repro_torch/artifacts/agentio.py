"""Agent checkpoints — the trained policy as a deployable on-disk
artifact; the port of ``repro/artifacts/agentio.py``, in its on-disk
format, so an artifact written by either package loads in the other.

Any protocol :class:`~repro_torch.core.protocols.Agent`'s ``state_dict()``
— a nested dict of plain python values and arrays (numpy, or torch
tensors, stored as numpy) — is written as

    <dir>/state.json      non-array structure (arrays as ``__array__`` refs)
    <dir>/state.npz       the array leaves, keyed by their tree path
    <dir>/manifest.json   format, agent name, schema version, fingerprint

staged in a ``.tmp-<pid>`` sibling and moved into place with the manifest
written **last**, so a partially written directory is never restorable.
The manifest carries a SHA-256 *fingerprint* of the canonicalized state;
:func:`read_agent_state` recomputes it on load and refuses a mismatch
(torn writes, manual edits).  The fingerprint is the reference's function
of the state, so equal states fingerprint equally in both packages.

The fingerprint doubles as the agent-identity component of
:func:`repro_torch.artifacts.store.program_key`: two agents with
bitwise-equal deployable state share cached tuning decisions.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Optional, Tuple

import numpy as np
import torch

ARTIFACT_FORMAT = "neurovectorizer-agent"
MANIFEST = "manifest.json"
STATE_JSON = "state.json"
STATE_NPZ = "state.npz"

_SCALARS = (str, int, float, bool, type(None))


class ArtifactError(RuntimeError):
    """A persistence artifact is missing, incomplete, corrupted, or
    incompatible with what the caller tried to load it into."""


def _split_arrays(obj, path: str = "") -> Tuple[object, dict]:
    """Mirror ``obj`` with every array replaced by an ``__array__`` ref;
    returns ``(json_mirror, {tree_path: ndarray})``."""
    if isinstance(obj, dict):
        mirror, arrays = {}, {}
        for k, v in obj.items():
            if not isinstance(k, str):
                raise ArtifactError(f"non-string dict key {k!r} at "
                                    f"{path or '/'} cannot be serialized")
            m, a = _split_arrays(v, f"{path}/{k}")
            mirror[k] = m
            arrays.update(a)
        return mirror, arrays
    if isinstance(obj, (list, tuple)):
        mirror, arrays = [], {}
        for i, v in enumerate(obj):
            m, a = _split_arrays(v, f"{path}/{i}")
            mirror.append(m)
            arrays.update(a)
        return mirror, arrays
    if isinstance(obj, np.generic):                 # numpy scalar -> python
        return obj.item(), {}
    if isinstance(obj, torch.Tensor):
        return {"__array__": path}, {path: obj.detach().cpu().numpy()}
    if isinstance(obj, np.ndarray) or hasattr(obj, "__array_interface__"):
        return {"__array__": path}, {path: np.asarray(obj)}
    if isinstance(obj, _SCALARS):
        return obj, {}
    raise ArtifactError(f"unserializable value of type "
                        f"{type(obj).__name__} at {path or '/'}")


def _join_arrays(mirror, arrays: dict):
    if isinstance(mirror, dict):
        if set(mirror) == {"__array__"}:
            return np.asarray(arrays[mirror["__array__"]])
        return {k: _join_arrays(v, arrays) for k, v in mirror.items()}
    if isinstance(mirror, list):
        return [_join_arrays(v, arrays) for v in mirror]
    return mirror


def fingerprint_state(state: dict) -> str:
    """Canonical SHA-256 of a ``state_dict``: sorted-key JSON for the
    structure plus dtype/shape/bytes per array leaf.  Stable across a
    save→load round trip (tuples and lists hash identically)."""
    mirror, arrays = _split_arrays(state)
    h = hashlib.sha256()
    h.update(json.dumps(mirror, sort_keys=True,
                        separators=(",", ":")).encode())
    for key in sorted(arrays):
        a = np.ascontiguousarray(arrays[key])
        h.update(key.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def agent_fingerprint(agent) -> str:
    """Fingerprint of an agent's *current* deployable state."""
    return fingerprint_state(agent.state_dict())


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------

def save_agent(agent, directory: str) -> str:
    """Write ``agent.state_dict()`` as an atomic artifact directory;
    returns the state fingerprint recorded in the manifest."""
    state = agent.state_dict()
    if not isinstance(state, dict) or "name" not in state \
            or "version" not in state:
        raise ArtifactError("state_dict() must be a dict carrying 'name' "
                            "and 'version'")
    mirror, arrays = _split_arrays(state)
    fp = fingerprint_state(state)
    directory = str(directory).rstrip(os.sep)
    tmp = directory + f".tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        with open(os.path.join(tmp, STATE_JSON), "w") as f:
            json.dump(mirror, f)
        np.savez(os.path.join(tmp, STATE_NPZ), **arrays)
        # manifest is written LAST: its presence marks the staged artifact
        # complete, so a directory without one is never restorable
        manifest = {"format": ARTIFACT_FORMAT, "agent": state["name"],
                    "version": state["version"], "fingerprint": fp,
                    "time": time.time()}
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
        # whole-directory swap: an existing (valid) artifact is moved
        # aside, not overwritten file-by-file — a crash at any point
        # leaves either the old or the new artifact restorable
        old = None
        if os.path.isdir(directory):
            old = directory + f".old-{os.getpid()}"
            shutil.rmtree(old, ignore_errors=True)
            os.replace(directory, old)
        os.replace(tmp, directory)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return fp


def read_agent_state(directory: str) -> Tuple[dict, dict]:
    """Load and verify ``(state, manifest)`` from an artifact directory.

    Raises :class:`ArtifactError` when the directory is not a complete
    artifact (no manifest — e.g. an interrupted save) or when the
    recomputed fingerprint disagrees with the manifest (corruption)."""
    directory = str(directory)
    mpath = os.path.join(directory, MANIFEST)
    if not os.path.exists(mpath):
        raise ArtifactError(f"no restorable agent artifact at {directory!r} "
                            f"(manifest.json missing — incomplete save?)")
    with open(mpath) as f:
        manifest = json.load(f)
    if manifest.get("format") != ARTIFACT_FORMAT:
        raise ArtifactError(f"{directory!r} is not an agent artifact "
                            f"(format={manifest.get('format')!r})")
    with open(os.path.join(directory, STATE_JSON)) as f:
        mirror = json.load(f)
    with np.load(os.path.join(directory, STATE_NPZ),
                 allow_pickle=False) as npz:
        arrays = {k: npz[k] for k in npz.files}
    state = _join_arrays(mirror, arrays)
    fp = fingerprint_state(state)
    if fp != manifest.get("fingerprint"):
        raise ArtifactError(
            f"fingerprint mismatch for {directory!r}: manifest says "
            f"{manifest.get('fingerprint')!r} but the stored state hashes "
            f"to {fp!r} — the artifact is corrupted; refusing to load")
    return state, manifest


def load_agent(directory: str, agent=None, cfg=None, seed: int = 0,
               device="cuda", **agent_kwargs):
    """Restore an agent from an artifact directory.

    Pass ``agent=`` to load the state into an already-constructed agent
    (name/version are validated by its ``load_state``); otherwise the
    registry constructs one from the manifest's agent name with ``cfg`` /
    ``seed`` / ``device`` / extra kwargs — these must match the saving
    side for bit-exact behaviour (the facade records them; see
    ``NeuroVectorizer.load``)."""
    state, manifest = read_agent_state(directory)
    if agent is None:
        from repro_torch.configs.neurovec import DEFAULT
        from repro_torch.core.agents import make_agent
        agent = make_agent(manifest["agent"],
                           cfg if cfg is not None else DEFAULT,
                           seed=seed, device=device, **agent_kwargs)
    agent.load_state(state)
    return agent
