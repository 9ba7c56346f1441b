"""Server CLI — flag-for-flag parity with the reference server CLI.

Reference grammar (server/server.py:330-350)::

    python -m fastdet_tpu_torch.cli.server [-d] [-o dbgout] [-m mode] [-s port]
        [-t interval] [name:num_classes:weights ...]

No positional args registers the DummyDetector at path 'detect'
(server.py:359-360). ``-t interval`` (the reference's select timeout) is
accepted for compatibility; the asyncio runtime needs no poll interval.
``weights`` accepts fastdet .npz, darknet ``.weights`` (converted once
and cached beside it as ``.weights.npz``), ``.onnx`` and
``synthetic[:arch]``. Engines run on the CUDA card.
``-m`` picks bf16 (the default), f32 or int8; int8 calibrates its
activation scales at startup on the frames in FASTDET_CALIB_DIR, else on
synthetic scenes.
"""

from __future__ import annotations

import getopt
import logging
import sys


def main(argv):
    def usage():
        print(
            f"usage: {argv[0]} [-d] [-o dbgout] [-m mode] [-s port] "
            f"[-t interval] [name:num_classes:weights ...]"
        )
        return 100

    try:
        (opts, args) = getopt.getopt(argv[1:], "do:m:s:t:")
    except getopt.GetoptError:
        return usage()
    level = logging.INFO
    mode = None
    server_port = 10000
    dbgout = None
    for (k, v) in opts:
        if k == "-d":
            level = logging.DEBUG
        elif k == "-o":
            dbgout = v
        elif k == "-m":
            mode = v
        elif k == "-s":
            server_port = int(v)
        elif k == "-t":
            float(v)  # accepted for reference-CLI compatibility; unused
    logging.basicConfig(
        format="%(asctime)s %(levelname)s %(message)s", level=level
    )

    from fastdet_tpu_torch.runtime.server import DetectionServer, build_services

    services = build_services(args, mode=mode, dbgout=dbgout)
    logging.info("detectors=%s", services)
    server = DetectionServer(services, port=server_port, dbgout=dbgout)
    server.run()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
