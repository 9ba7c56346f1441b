"""The protocol's client side, the benchmark's frozen copy.

Copied from the program's ``wire/rtp.py`` and ``wire/messages.py`` and
``runtime/client.py`` (the reference protocol: server/client.py): TCP
``FEED <lport> <path>\\r\\n`` -> ``+OK <rport> <session>\\r\\n``, a
12-byte initiation datagram, then ``JPEG`` requests (``>4sLLL`` header:
magic, request id, threshold * 100, length) in 32768-byte RTP-like
chunks (``>BBH``: 0x80, 96 | marker on the last chunk, sequence number),
and ``YOLO`` answers (magic, request id, msec, length, then 10-byte
``>BBhhhh`` records). A sequence gap cancels the payload in flight.
"""

from __future__ import annotations

import socket
import struct
from typing import List, Optional, Tuple

RTP_HEADER = struct.Struct(">BBH")
PAYLOAD_HEADER = struct.Struct(">4sLLL")
RECORD = struct.Struct(">BBhhhh")
PT_DATA = 96
MARKER = 0x80
CLIENT_CHUNK_SIZE = 32768
EMPTY_PACKET = b"\x80\x00" + b"\x00" * 10


def request_frames(seqno: int, reqid: int, threshold: float,
                   jpeg: bytes) -> Tuple[List[bytes], int]:
    """One request's datagrams from ``seqno``; returns (frames, next)."""
    payload = PAYLOAD_HEADER.pack(b"JPEG", reqid, int(threshold * 100),
                                  len(jpeg)) + jpeg
    frames = []
    for i0 in range(0, len(payload), CLIENT_CHUNK_SIZE):
        last = i0 + CLIENT_CHUNK_SIZE >= len(payload)
        frames.append(RTP_HEADER.pack(0x80, PT_DATA | (MARKER if last else 0),
                                      seqno & 0xFFFF)
                      + payload[i0:i0 + CLIENT_CHUNK_SIZE])
        seqno += 1
    return frames, seqno


class Reassembler:
    """Chunks -> payloads; a sequence gap cancels the payload in flight."""

    def __init__(self):
        self._buf: Optional[List[bytes]] = []
        self._expected: Optional[int] = None

    def feed(self, frame: bytes) -> List[bytes]:
        if len(frame) < 4:
            return []
        _, pt, seqno = RTP_HEADER.unpack(frame[:4])
        done: List[bytes] = []
        if self._expected is not None and seqno != self._expected and not (
                self._expected == 0 and seqno == 1):
            self._buf = None
        if (pt & 0x7F) == PT_DATA and self._buf is not None:
            self._buf.append(frame[4:])
        if pt & MARKER:
            if self._buf is not None:
                done.append(b"".join(self._buf))
            self._buf = []
        self._expected = (seqno + 1) & 0xFFFF
        return done


def parse_answer(payload: bytes) -> Optional[Tuple[int, int, bytes]]:
    """(request id, msec, record bytes) of a ``YOLO`` payload, or None."""
    if len(payload) < 16:
        return None
    _, reqid, msec, length = PAYLOAD_HEADER.unpack(payload[:16])
    body = payload[16:]
    if len(body) != length:
        return None
    return reqid, msec, body


def parse_records(body: bytes) -> List[Tuple[int, int, int, int, int, int]]:
    return [RECORD.unpack(body[i:i + 10])
            for i in range(0, len(body) - 9, 10)]


class Session:
    """One camera's session: a UDP socket and its control connection."""

    def __init__(self, host: str, port: int, path: str,
                 timeout: float = 10.0):
        self.host = host
        self.udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.udp.setblocking(False)
        self.udp.bind((host, 0))
        lport = self.udp.getsockname()[1]
        self.tcp = socket.create_connection((host, port), timeout)
        self.tcp.sendall(f"FEED {lport} {path}".encode("ascii") + b"\r\n")
        resp = b""
        while b"\n" not in resp:
            part = self.tcp.recv(65536)
            if not part:
                raise OSError("server closed the connection mid-handshake")
            resp += part
        if not resp.startswith(b"+OK "):
            raise OSError(f"handshake refused: {resp!r}")
        self.rport = int(resp[4:].split()[0])
        self.udp.sendto(EMPTY_PACKET, (host, self.rport))
        self.seqno = 1
        self.reasm = Reassembler()

    def send(self, reqid: int, threshold: float, jpeg: bytes) -> None:
        frames, self.seqno = request_frames(self.seqno, reqid, threshold,
                                            jpeg)
        for f in frames:
            self.udp.sendto(f, (self.host, self.rport))

    def receive(self) -> List[Tuple[int, int, bytes]]:
        """Every answer whose last datagram has arrived (non-blocking)."""
        out = []
        while True:
            try:
                data = self.udp.recv(65536)
            except BlockingIOError:
                return out
            for payload in self.reasm.feed(data):
                parsed = parse_answer(payload)
                if parsed is not None:
                    out.append(parsed)

    def close(self) -> None:
        for s in (self.tcp, self.udp):
            try:
                s.close()
            except OSError:
                pass
