"""Connectivity-diagnostic HTTP stub.

Role parity with the reference's standalone httpserver.py (SURVEY.md
§2.14, reference server/httpserver.py): verify that a mobile client can
reach the serving host at all before debugging the detection protocol.
Built on the same asyncio stack as the main serving runtime
(runtime/server.py) rather than ``http.server`` — one concurrency model
across the project; this tool never needs more HTTP than it can parse in
a dozen lines.

The port's copy of the JAX package's ``fastdet_tpu/cli/httpserver.py``
(it touches no tensor, so it takes no device). Behavior contract
(pinned in tests/test_torch_cli.py, as tests/test_httpserver.py pins the
JAX copy):

- ``GET /``     -> 200 text/plain, body ``repr((requestline, headers))``
- ``GET other`` -> 404 ``not found``
- ``HEAD``      -> zero bytes, clean close: the reference's do_HEAD calls
  send_response without end_headers, which only *buffers* the status
  line, so the reference actually answers HEAD with nothing — reproduced
  bug-for-bug since probes may depend on it.
- flags ``[-d] [-s port]``, default port 10000, same log line format.

Usage: python -m fastdet_tpu_torch.cli.httpserver [-d] [-s port]
"""

from __future__ import annotations

import asyncio
import getopt
import logging
import sys
from typing import Optional

logger = logging.getLogger(__name__)


def _http_response(status: str, body: bytes) -> bytes:
    head = "\r\n".join((
        f"HTTP/1.0 {status}",
        "Content-Type: text/plain",
        f"Content-Length: {len(body)}",
        "",
        "",
    ))
    return head.encode("latin-1") + body


class DiagConnection(asyncio.Protocol):
    """One diagnostic exchange: buffer until the header block is complete,
    echo what arrived, close (HTTP/1.0 one-shot semantics)."""

    def connection_made(self, transport) -> None:
        self.transport = transport
        self.buf = b""

    def data_received(self, data: bytes) -> None:
        self.buf += data
        end = self.buf.find(b"\r\n\r\n")
        if end < 0:
            return  # headers not complete yet
        lines = self.buf[:end].decode("latin-1", "replace").split("\r\n")
        requestline = lines[0]
        method, _, rest = requestline.partition(" ")
        path = rest.split(" ", 1)[0]
        logger.info("%s: path=%s", method, path)
        if method == "HEAD":
            self.transport.close()  # reference quirk: HEAD sends nothing
            return
        if path != "/":
            self.transport.write(_http_response("404 Not Found", b"not found"))
        else:
            headers = {}
            for line in lines[1:]:
                key, sep, value = line.partition(":")
                if sep:
                    headers[key.strip()] = value.strip()
            body = repr((requestline, headers)).encode("utf-8")
            self.transport.write(_http_response("200 OK", body))
        self.transport.close()


class DiagServer:
    """Bind-and-run wrapper (port=0 supported; bound_port set once live)."""

    def __init__(self, host: str = "", port: int = 10000):
        self.host = host
        self.port = port
        self.bound_port: Optional[int] = None

    async def serve(self, ready: Optional[asyncio.Event] = None) -> None:
        loop = asyncio.get_running_loop()
        server = await loop.create_server(DiagConnection, self.host, self.port)
        self.bound_port = server.sockets[0].getsockname()[1]
        logging.info(f"listening: port={self.bound_port}...")
        if ready is not None:
            ready.set()
        async with server:
            await server.serve_forever()


def main(argv):
    def usage():
        print(f"usage: {argv[0]} [-d] [-s port]")
        return 100

    try:
        (opts, _args) = getopt.getopt(argv[1:], "ds:")
    except getopt.GetoptError:
        return usage()
    level = logging.INFO
    port = 10000
    for (k, v) in opts:
        if k == "-d":
            level = logging.DEBUG
        elif k == "-s":
            port = int(v)
    logging.basicConfig(format="%(asctime)s %(levelname)s %(message)s",
                        level=level)
    try:
        asyncio.run(DiagServer(port=port).serve())
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
