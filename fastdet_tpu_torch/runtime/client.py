"""Protocol client library (the reference's test client, rebuilt on wire/).

Behavioral contract from reference server/client.py:18-130: bind an
ephemeral UDP socket, TCP handshake ``FEED lport path`` -> ``+OK``, send
the 12-byte initiation packet, then stream 'JPEG' requests in 32768-byte
chunks and reassemble 'YOLO' responses. Used by the client CLI, the test
suite, and the benchmark harness (where a callback-based variant allows
multiple requests in flight).
"""

from __future__ import annotations

import logging
import select
import socket
import time
from typing import Callable, Dict, List, Optional, Tuple

from fastdet_tpu_torch import wire

logger = logging.getLogger(__name__)

ResponseRecords = List[Tuple[int, int, int, int, int, int]]


class DetectClient:
    def __init__(self, host: str, port: int = 10000, path: str = "detect"):
        self.host = host
        self.port = port
        self.path = path
        self.sock_udp: Optional[socket.socket] = None
        self.sock_tcp: Optional[socket.socket] = None
        self.rtp_port: Optional[int] = None
        self.session_id: Optional[bytes] = None
        self.sender = wire.FrameSender(chunk_size=wire.CLIENT_CHUNK_SIZE)
        self.reasm = wire.Reassembler()
        #: reqid -> (msec, records), filled by poll()
        self.responses: Dict[int, Tuple[int, ResponseRecords]] = {}
        self.on_response: Optional[Callable[[int, int, ResponseRecords], None]] = None

    def open(self, timeout: float = 5.0) -> None:
        # fresh stream state: a re-opened client must not prepend stale
        # partial chunks from a previous session to the new stream
        self.sender = wire.FrameSender(chunk_size=wire.CLIENT_CHUNK_SIZE)
        self.reasm = wire.Reassembler()
        self.sock_udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock_udp.setblocking(False)
        self.sock_udp.bind(("", 0))
        lport = self.sock_udp.getsockname()[1]
        self.sock_tcp = socket.create_connection((self.host, self.port), timeout)
        self.sock_tcp.sendall(wire.pack_feed(lport, self.path))
        # the +OK line may arrive split across TCP segments: read to \n
        self.sock_tcp.settimeout(timeout)
        resp = b""
        while b"\n" not in resp:
            part = self.sock_tcp.recv(65536)
            if not part:
                raise OSError("server closed the connection mid-handshake")
            resp += part
        self.rtp_port, self.session_id = wire.parse_ok(resp)  # raises on !ERR
        logger.info(
            "open: lport=%s rtp_port=%s session=%s",
            lport, self.rtp_port, self.session_id.hex(),
        )
        # initiation packet; both sides start their data stream at seqno 1
        self.sock_udp.sendto(wire.EMPTY_PACKET, (self.host, self.rtp_port))
        self.sender.seqno = 1

    def request(self, reqid: int, threshold: float, jpeg: bytes) -> None:
        if self.sock_udp is None:
            raise OSError("client is closed")
        payload = wire.DetectRequest(reqid, threshold, jpeg).pack()
        for frame in self.sender.frames(payload):
            self.sock_udp.sendto(frame, (self.host, self.rtp_port))

    def poll(self, timeout: float = 0.0) -> None:
        """Drain pending datagrams; parsed responses land in .responses."""
        if self.sock_udp is None:
            raise OSError("client is closed")
        r, _, _ = select.select([self.sock_udp], [], [], timeout)
        if not r:
            return
        while True:
            try:
                data, _ = self.sock_udp.recvfrom(65536)
            except BlockingIOError:
                break
            for payload in self.reasm.feed(data):
                parsed = wire.parse_response(payload)
                if parsed is None:
                    continue
                reqid, msec, records = parsed
                logger.info(
                    "client: msec=%s, reqid=%s, result=%s", msec, reqid, records
                )
                self.responses[reqid] = (msec, records)
                if self.on_response is not None:
                    self.on_response(reqid, msec, records)

    def wait_response(self, reqid: int, timeout: float = 5.0):
        """Block until the response for ``reqid`` arrives (or timeout)."""
        deadline = time.monotonic() + timeout
        while reqid not in self.responses:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"no response for reqid={reqid}")
            self.poll(min(remaining, 0.25))
        return self.responses.pop(reqid)

    def close(self) -> None:
        for s in (self.sock_tcp, self.sock_udp):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        self.sock_tcp = self.sock_udp = None
