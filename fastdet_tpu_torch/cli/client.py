"""Client CLI — flag-for-flag parity with the reference client CLI.

Reference grammar (server/client.py:133-176)::

    python -m fastdet_tpu_torch.cli.client [-d] [-t interval]
        rtsp://host[:port]/path [file ...]

The port's copy of the JAX package's ``fastdet_tpu/cli/client.py``, over
the port's DetectClient; it touches no tensor, so it takes no device.
Loops forever re-sending the files every ``interval`` seconds, logging
each response. Extension: ``-n count`` sends a bounded number of requests
then exits with status 0 (for scripted tests/benchmarks; the reference
only loops forever).
"""

from __future__ import annotations

import getopt
import logging
import sys
import time


def main(argv):
    def usage():
        print(
            f"usage: {argv[0]} [-d] [-t interval] [-n count] "
            f"rtsp://host[:port]/path [file ...]"
        )
        return 100

    try:
        (opts, args) = getopt.getopt(argv[1:], "dt:n:")
    except getopt.GetoptError:
        return usage()
    level = logging.INFO
    interval = 0.1
    count = None
    client_host = "localhost"
    client_port = 10000
    threshold = 0.1
    for (k, v) in opts:
        if k == "-d":
            level = logging.DEBUG
        elif k == "-t":
            interval = float(v)
        elif k == "-n":
            count = int(v)
    logging.basicConfig(
        format="%(asctime)s %(levelname)s %(message)s", level=level
    )

    if not args:
        return usage()
    url = args.pop(0)
    if not url.startswith("rtsp://"):
        return usage()
    (hostport, _, remotepath) = url[7:].partition("/")
    (host, _, port) = hostport.partition(":")
    if host:
        client_host = host
    if port:
        client_port = int(port)

    from fastdet_tpu_torch.runtime.client import DetectClient

    logging.info("connecting: %s:%s...", client_host, client_port)
    client = DetectClient(client_host, client_port, remotepath)
    client.open()
    files = []
    for path in args:
        with open(path, "rb") as fp:
            files.append(fp.read())
    reqid = 0
    while True:
        for data in files:
            reqid += 1
            client.request(reqid, threshold, data)
            client.poll()
            if count is not None and reqid >= count:
                deadline = time.time() + 3.0
                while client.responses.keys() < set(range(1, count + 1)):
                    if time.time() > deadline:
                        break
                    client.poll(0.1)
                client.close()
                return 0
            time.sleep(interval)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
