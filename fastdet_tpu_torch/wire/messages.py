"""Application-layer messages of the fastdet wire protocol.

Byte-compatible with the reference (spec: docs/DESIGN.md:47-111):

- TCP control plane: ``FEED <lport> <path>\\r\\n``  ->  ``+OK <rport> <sessionid>\\r\\n``
  (errors ``!UNKNOWN`` / ``!INVALID``; reference server/server.py:267-310).
- UDP request payload:  ``'JPEG' reqid:u32 threshold*100:u32 len:u32 jpeg``
  (reference server/server.py:228, client.py:67-69).
- UDP response payload: ``'YOLO' reqid:u32 msec:u32 len:u32`` followed by
  N 10-byte records ``klass:u8 conf*255:u8 x:i16 y:i16 w:i16 h:i16``
  (reference server/server.py:235-239, docs/DESIGN.md:102-111).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

PAYLOAD_HEADER = struct.Struct(">4sLLL")
RESULT_RECORD = struct.Struct(">BBhhhh")

MAGIC_REQUEST = b"JPEG"
MAGIC_RESPONSE = b"YOLO"
CMD_FEED = b"FEED"

OK_PREFIX = b"+OK "
ERR_UNKNOWN = b"!UNKNOWN\r\n"
ERR_INVALID = b"!INVALID\r\n"


# ---------------------------------------------------------------------------
# Control plane (TCP lines)
# ---------------------------------------------------------------------------

def pack_feed(local_udp_port: int, path: str) -> bytes:
    """Client -> server handshake line (client.py:43-45)."""
    return f"FEED {local_udp_port} {path}".encode("ascii") + b"\r\n"


def parse_command(line: bytes) -> Tuple[bytes, bytes]:
    """Split a control line into (COMMAND, args); command is upper-cased.

    Mirrors RTSPService.feedline (server.py:267-269).
    """
    cmd, _, args = line.strip().partition(b" ")
    return cmd.upper(), args


def parse_feed_args(args: bytes) -> Optional[Tuple[int, str]]:
    """Parse ``<lport> <path>`` FEED arguments; None if invalid.

    Mirrors RTSPService.startfeed validation (server.py:287-299): at
    least two whitespace-separated fields, first an int, second utf-8.
    Documented divergence: the port must be a usable UDP port (1-65535);
    the reference accepts any int and then crashes per-send with
    OverflowError while the client hangs on a 'successful' handshake —
    we answer !INVALID up front.
    """
    flds = args.split()
    if len(flds) < 2:
        return None
    try:
        port = int(flds[0])
        path = flds[1].decode("utf-8")
    except (UnicodeError, ValueError):
        return None
    if not 1 <= port <= 65535:
        return None
    return port, path


def pack_ok(udp_port: int, session_id: bytes) -> bytes:
    """Server -> client handshake reply (server.py:309-310)."""
    return f"+OK {udp_port} {session_id.hex()}".encode("ascii") + b"\r\n"


def parse_ok(resp: bytes) -> Tuple[int, bytes]:
    """Parse the ``+OK`` reply; raises IOError on error replies.

    Mirrors RTSPClient.open (client.py:46-55).
    """
    if not resp.startswith(OK_PREFIX):
        raise IOError(resp)
    f = resp[4:].strip().split()
    return int(f[0]), bytes.fromhex(f[1].decode("ascii"))


# ---------------------------------------------------------------------------
# Data plane payloads (carried inside RTP-like frames)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DetectRequest:
    reqid: int
    threshold: float          # fraction in [0, 1]; wire carries int(t*100)
    jpeg: bytes

    def pack(self) -> bytes:
        return (
            PAYLOAD_HEADER.pack(
                MAGIC_REQUEST, self.reqid, int(self.threshold * 100), len(self.jpeg)
            )
            + self.jpeg
        )


def _i16(v: float) -> int:
    """int() truncation like the reference pack (server.py:235-238), but
    clamped to int16 wire range — the reference would raise struct.error on
    boxes beyond ±2^15 px; we saturate instead (documented divergence)."""
    if v != v:          # NaN
        return 0
    if v >= 32767:      # also catches +inf (int(inf) would raise)
        return 32767
    if v <= -32768:
        return -32768
    return int(v)


#: One detection result in server coordinates: class id (1-indexed),
#: confidence in [0,1], and pixel-space x, y, w, h (floats; truncated to
#: int16 on the wire exactly like server.py:235-238 ``int()``).
ResultTuple = Tuple[int, float, float, float, float, float]


@dataclass(frozen=True)
class DetectResponse:
    reqid: int
    msec: int
    results: Sequence[ResultTuple]

    def pack(self) -> bytes:
        buf = b""
        for klass, conf, x, y, w, h in self.results:
            buf += RESULT_RECORD.pack(
                klass,
                int(conf * 255),
                _i16(x), _i16(y), _i16(w), _i16(h),
            )
        return PAYLOAD_HEADER.pack(MAGIC_RESPONSE, self.reqid, self.msec, len(buf)) + buf


def pack_response_raw(reqid: int, msec: int, records: bytes) -> bytes:
    """Response payload from an ALREADY-PACKED >BBhhhh record blob.

    Serving hot path: DetectionEngine.fetch_wire packs a whole batch's
    records in one vectorized numpy pass; this just prepends the header.
    Byte-identical to DetectResponse.pack for the same results."""
    return PAYLOAD_HEADER.pack(MAGIC_RESPONSE, reqid, msec, len(records)) + records


def parse_request(data: bytes) -> Optional[DetectRequest]:
    """Parse a request payload; None on malformed/short data.

    Mirrors DetectService.process_data validation (server.py:225-232):
    payloads shorter than 16 bytes and length mismatches are silently
    dropped; the magic is *not* verified (the reference never checks it).
    """
    if len(data) < 16:
        return None
    _tp, reqid, threshold100, length = PAYLOAD_HEADER.unpack(data[:16])
    body = data[16:]
    if len(body) != length:
        return None
    return DetectRequest(reqid=reqid, threshold=threshold100 * 0.01, jpeg=body)


def parse_response(data: bytes) -> Optional[Tuple[int, int, List[Tuple[int, int, int, int, int, int]]]]:
    """Parse a response payload into (reqid, msec, records); None if invalid.

    Records are the raw wire integers (klass:u8, conf255:u8, x, y, w, h:i16),
    mirroring RTSPClient.process_data (client.py:116-130).
    """
    if len(data) < 16:
        return None
    _tp, reqid, msec, length = PAYLOAD_HEADER.unpack(data[:16])
    body = data[16:]
    if len(body) != length:
        return None
    records = []
    for i in range(0, len(body) - 9, 10):
        records.append(RESULT_RECORD.unpack(body[i : i + 10]))
    return reqid, msec, records
