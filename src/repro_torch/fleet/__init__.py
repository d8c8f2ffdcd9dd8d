"""``repro_torch.fleet``: cross-host measurement and shared artifacts (the
port of ``repro/fleet``, speaking its wire protocol byte for byte).

:class:`SocketTransport` ships ``(site, tiles)`` batches to remote
``serve-worker`` hosts over TCP under the full
:class:`~repro_torch.core.protocols.MeasureTransport` contract, and the
``serve-artifacts`` daemon (:class:`ArtifactServer`) shares a
:class:`~repro_torch.measure.db.MeasureDB` and a
:class:`~repro_torch.artifacts.store.ProgramStore` as a push-invalidated,
keep-N-versioned service with :class:`RemoteMeasureDB` /
:class:`RemoteProgramStore` client mirrors.  A port client talks to a
reference daemon and the other way round.

Callers opt in with ``make_transport("socket", hosts=[...])``, the facade's
``transport="socket", hosts=[...]``, ``serve --transport socket --hosts
...``, or a ``fleet://host:port`` store path.  The daemons::

    python -m repro_torch.fleet serve-worker --port 7761 --transport pool --workers 2
    python -m repro_torch.fleet serve-artifacts --port 7762 \\
        --measure-db measure.jsonl --program-store programs.jsonl
"""
from repro_torch.fleet.artifacts import (ArtifactServer, RemoteMeasureDB,
                                         RemoteProgramStore,
                                         complete_versions, write_version)
from repro_torch.fleet.rpc import FLEET_SCHEME, PROTO_VERSION, parse_address
from repro_torch.fleet.transport import SocketTransport
from repro_torch.fleet.worker_server import MeasureServer

__all__ = [
    "ArtifactServer", "FLEET_SCHEME", "MeasureServer", "PROTO_VERSION",
    "RemoteMeasureDB", "RemoteProgramStore", "SocketTransport",
    "complete_versions", "parse_address", "write_version",
]
