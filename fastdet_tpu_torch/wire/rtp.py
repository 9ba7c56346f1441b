"""RTP-like framing for the fastdet wire protocol.

Byte-compatible with the reference's RTP-ish UDP framing
(spec: reference docs/DESIGN.md:64-82; server impl server/server.py:206-255;
python client impl server/client.py:72-114; C# client
Assets/client/RemoteYOLODetector.cs:167-218).

Frame layout (big-endian)::

    0      1      2      3
    +------+------+------+------+
    |flags | pt   |    seqno    |   then payload bytes
    +------+------+------+------+

- ``flags`` is always 0x80 (RTP version 2, no padding/extension/CSRC).
- ``pt`` carries payload type 96 in the low 7 bits; the high bit is the
  RTP *marker*, set on the final chunk of a payload.
- ``seqno`` is an unsigned 16-bit sequence number.

Sequence-number semantics (must interop with BOTH reference clients):

- the reference Python client masks an ever-increasing counter with
  0xffff, so it wraps 0xffff -> 0 (client.py:79),
- the reference C# client wraps 0xffff -> 1 (RemoteYOLODetector.cs:184),
- the reference *server* adds 1 with no mask (server.py:222) and therefore
  drops one payload at every wrap against either client.

Our :class:`Reassembler` accepts both wrap conventions, and otherwise
reproduces the reference drop semantics exactly: a gap cancels the
in-flight payload (buffer becomes invalid until the next marker packet).
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Optional

RTP_HEADER = struct.Struct(">BBH")
RTP_FLAGS = 0x80          # V=2, P=0, X=0, CC=0
PT_DATA = 96              # dynamic payload type used for all fastdet data
MARKER = 0x80             # marker bit in the pt byte

# Chunk sizes used by the reference peers. The server chunks responses at
# 40000 (server.py:182), the python test client chunks requests at 32768
# (client.py:72), the C# client at 40000 (RemoteYOLODetector.cs:169).
SERVER_CHUNK_SIZE = 40000
CLIENT_CHUNK_SIZE = 32768

#: The 12-byte "empty" RTP packet used for stream initiation on both sides
#: (docs/DESIGN.md:64-65, server.py:201, client.py:58).
EMPTY_PACKET = b"\x80\x00" + b"\x00" * 10


def pack_frame(seqno: int, payload: bytes, marker: bool) -> bytes:
    """Pack one RTP-like frame. ``seqno`` is masked to 16 bits."""
    pt = PT_DATA | (MARKER if marker else 0)
    return RTP_HEADER.pack(RTP_FLAGS, pt, seqno & 0xFFFF) + payload


def unpack_header(data: bytes):
    """Return (flags, pt, seqno) of a frame. Raises struct.error if short."""
    return RTP_HEADER.unpack(data[:4])


def chunk_payload(
    payload: bytes, start_seqno: int, chunk_size: int = SERVER_CHUNK_SIZE
) -> Iterator[bytes]:
    """Split ``payload`` into framed chunks.

    Mirrors the reference sender loop (server.py:243-255): every chunk uses
    pt=96 and the final chunk additionally sets the marker bit. The sequence
    number increments per chunk (16-bit masked on the wire). An empty
    payload produces no frames, exactly like the reference ``while`` loop.
    """
    seqno = start_seqno
    i0 = 0
    n = len(payload)
    while i0 < n:
        i1 = i0 + chunk_size
        yield pack_frame(seqno, payload[i0:i1], marker=n <= i1)
        seqno += 1
        i0 = i1


class FrameSender:
    """Stateful sender: tracks the outgoing sequence counter.

    The counter is a plain int incremented per chunk and masked to 16 bits
    on the wire, matching server.py:250-251. It starts at 0; sending the
    initiation packet (seqno 0) bumps it to 1 like DetectService.init()
    (server.py:199-204).
    """

    def __init__(self, chunk_size: int = SERVER_CHUNK_SIZE):
        self.chunk_size = chunk_size
        self.seqno = 0

    def initiation_packet(self) -> bytes:
        self.seqno += 1
        return EMPTY_PACKET

    def frames(self, payload: bytes) -> List[bytes]:
        out = list(chunk_payload(payload, self.seqno, self.chunk_size))
        self.seqno += len(out)
        return out


class Reassembler:
    """Stateful receiver reassembling chunked payloads with drop detection.

    Reproduces DetectService.recvdata (server.py:206-223):

    - a sequence gap invalidates the in-flight buffer (payload cancelled),
    - pt&0x7f == 96 appends the chunk body when the buffer is valid,
    - the marker bit finalizes: a valid buffer is delivered, and the buffer
      resets to valid-empty either way,
    - the expected seqno becomes received+1.

    Improvement over the reference (documented divergence): the expected
    counter wraps modulo 2**16 and *additionally* accepts the C# client's
    0xffff -> 1 wrap, so no payload is spuriously dropped at the 65k-packet
    boundary (the reference server drops one there, server.py:222).
    """

    def __init__(self):
        # In-flight chunk bodies (None = invalidated by a gap). Kept as a
        # list of zero-copy views joined once at the marker: a 100 KB
        # request arrives as ~4 chunks, and incremental bytes-concat would
        # memcpy the growing prefix on every datagram (~2x the payload),
        # all on the event-loop thread.
        self._buf: Optional[List[memoryview]] = []
        self._expected: Optional[int] = None  # None = accept any first seqno
        self.drops = 0          # number of detected gaps
        self.delivered = 0      # number of completed payloads

    @property
    def idle(self) -> bool:
        """Between payloads: no chunk held and no cancelled payload
        waiting for its marker."""
        return self._buf is not None and not self._buf

    def _seqno_ok(self, seqno: int) -> bool:
        if self._expected is None:
            return True
        if seqno == self._expected:
            return True
        # C# client wrap convention: 0xffff -> 1 (RemoteYOLODetector.cs:184).
        if self._expected == 0 and seqno == 1:
            return True
        return False

    def feed(self, frame: bytes) -> List[bytes]:
        """Feed one UDP datagram; return the list of completed payloads."""
        if len(frame) < 4:
            return []
        _, pt, seqno = unpack_header(frame)
        completed: List[bytes] = []
        if not self._seqno_ok(seqno):
            self.drops += 1
            self._buf = None
        if (pt & 0x7F) == PT_DATA and self._buf is not None:
            self._buf.append(memoryview(frame)[4:])
        if pt & MARKER:
            if self._buf is not None:
                payload = b"".join(self._buf)
                completed.append(payload)
                self.delivered += 1
            self._buf = []
        self._expected = (seqno + 1) & 0xFFFF
        return completed
