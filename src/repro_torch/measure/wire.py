"""Length-prefixed JSON framing: the wire format of the worker-pool pipe
protocol and of the :mod:`repro_torch.fleet` socket protocol (the port of
``repro/measure/wire.py``; the same bytes for the same message).

Every frame is ``len(payload)`` as a 4-byte big-endian prefix followed by
the UTF-8 JSON payload.  Shared by :mod:`~repro_torch.measure.pool` (the
parent), :mod:`~repro_torch.measure.worker` (the child) and the fleet
clients and servers, and kept free of heavy imports so the worker starts
cheaply.

A payload is capped at :data:`MAX_FRAME_BYTES`: a torn or garbage header
decodes to an arbitrary 32-bit length (``b"garb"`` is about 1.7 GB), and
without the cap a reader would try that allocation before noticing the
stream is ruined.  An oversize prefix raises ``ValueError``, the class
readers already treat as a poisoned connection.
"""
from __future__ import annotations

import json
import struct

_LEN = struct.Struct(">I")

#: Ceiling on one frame's JSON payload: far above any real message (a
#: job or result is under 1 KB; a full artifact-store sync of about 1e5
#: records a few MB), small enough that a garbage prefix is refused.
MAX_FRAME_BYTES = 64 * 1024 * 1024


def read_frame(stream, max_bytes: int = MAX_FRAME_BYTES) -> "dict | None":
    """One length-prefixed JSON frame; ``None`` on a clean EOF.

    Raises ``EOFError`` on a truncated header or payload and ``ValueError``
    on a length prefix beyond ``max_bytes`` or a payload that is not UTF-8
    JSON.
    """
    head = stream.read(_LEN.size)
    if not head:
        return None
    if len(head) < _LEN.size:
        raise EOFError("truncated frame header")
    (n,) = _LEN.unpack(head)
    if n > max_bytes:
        raise ValueError(
            f"frame length {n} exceeds cap {max_bytes} — garbage or torn "
            f"header")
    payload = stream.read(n)
    if len(payload) < n:
        raise EOFError("truncated frame payload")
    try:
        return json.loads(payload.decode("utf-8"))
    except UnicodeDecodeError as e:     # the poisoned-stream class
        raise ValueError(f"frame payload is not UTF-8: {e}") from e


def write_frame(stream, msg: dict, max_bytes: int = MAX_FRAME_BYTES) -> None:
    payload = json.dumps(msg).encode("utf-8")
    if len(payload) > max_bytes:
        raise ValueError(
            f"refusing to write a {len(payload)}-byte frame (cap "
            f"{max_bytes})")
    stream.write(_LEN.pack(len(payload)) + payload)
    stream.flush()
