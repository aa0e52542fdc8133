"""Wire protocol: length-prefixed JSON header + raw payload framing, and
the process-request reply builder (see the package docstring in
``dips_tpu/serve/__init__.py`` for the full command reference)."""

from __future__ import annotations

import json
import logging
import socket
import struct
import time
from typing import Optional, Tuple

log = logging.getLogger("dips_tpu.serve")
_LEN = struct.Struct("<I")
#: protocol sanity caps: headers are small JSON; payloads are frames
#: (a 4K RGBA frame is ~33 MB) — reject anything absurd before allocating
_MAX_HEADER = 64 * 1024
_MAX_PAYLOAD = 256 * 1024 * 1024


def _send(sock: socket.socket, header: dict, payload: bytes = b"") -> None:
    hdr = json.dumps(header).encode()
    sock.sendall(_LEN.pack(len(hdr)) + hdr + payload)


#: a message that started arriving must finish within this long of zero
#: forward progress (then the connection is declared broken) — the short
#: idle poll timeout must never drop partially-read messages
_PARTIAL_TIMEOUT_S = 30.0


def _recv_exact(sock: socket.socket, n: int,
                started: bool = False) -> Optional[bytes]:
    """Read exactly ``n`` bytes.  ``socket.timeout`` propagates only while
    IDLE (nothing consumed and ``started`` false, i.e. between messages, so
    the server can poll its shutdown flag); mid-message stalls keep
    waiting — dropping a partial read would desync the framing — until
    ``_PARTIAL_TIMEOUT_S`` passes with no progress at all."""
    buf = bytearray()
    deadline = None
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            if not started and not buf:
                raise
            now = time.monotonic()
            if deadline is None:
                deadline = now + _PARTIAL_TIMEOUT_S
            elif now > deadline:
                raise ValueError(
                    f"incomplete message: {len(buf)}/{n} bytes then "
                    f"{_PARTIAL_TIMEOUT_S:g}s of silence")
            continue
        if not chunk:
            return None
        buf.extend(chunk)
        deadline = None  # forward progress restarts the stall clock
    return bytes(buf)


def _recv(sock: socket.socket) -> Optional[Tuple[dict, bytes]]:
    raw_len = _recv_exact(sock, _LEN.size)
    if raw_len is None:
        return None
    hdr_len = _LEN.unpack(raw_len)[0]
    if hdr_len > _MAX_HEADER:
        raise ValueError(f"header length {hdr_len} exceeds {_MAX_HEADER}")
    hdr = _recv_exact(sock, hdr_len, started=True)
    if hdr is None:
        return None
    header = json.loads(hdr)
    n = int(header.get("payload_len", 0))
    if not 0 <= n <= _MAX_PAYLOAD:
        raise ValueError(f"payload length {n} exceeds {_MAX_PAYLOAD}")
    payload = _recv_exact(sock, n, started=True) if n else b""
    if n and payload is None:
        return None
    return header, payload


def _process_reply(eng, frames, header: dict) -> Tuple[dict, bytes]:
    """Run frames through the engine and build the (header, payload) reply.

    When the client asks for ``"packed": true`` and the engine emits
    THRESHOLD masks, the payload is bit-packed along the row axis (8x
    fewer bytes; ops/wire.py bit order) and the response header's
    ``shape`` stays the *unpacked* shape.  On a ``packed_wire`` engine
    the device-packed padded planes are forwarded VERBATIM (header gains
    ``"padded": [Hp, Wp]``) — no host unpack/repack on the serving path.
    """
    from ..properties import OutputMode
    want = bool(header.get("packed")
                and eng.props.output == OutputMode.THRESHOLD
                and eng.props.out_channels > 0)
    if want and eng.packed_wire:
        outs, stats = eng.process_frames(list(frames), packed=True)
        body = outs.tobytes()  # (N, 1, Hp//8, Wp) device-packed planes
        hdr = {"ok": True, "packed": True, "padded": [eng.hp, eng.wp],
               "shape": [len(frames), eng.height, eng.width, 1]}
    else:
        outs, stats = eng.process_frames(list(frames))
        if want:
            from ..ops.wire import pack_mask_host
            body = pack_mask_host(outs[..., 0]).tobytes()
        else:
            body = outs.tobytes()
        hdr = {"ok": True, "packed": want, "shape": list(outs.shape)}
    hdr["payload_len"] = len(body)
    hdr["stats"] = [[float(v) for v in row] for row in stats]
    return hdr, body
