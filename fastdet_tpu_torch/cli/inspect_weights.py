"""Model/weights introspection tool.

Equivalent of the reference's models/inspect_onnx.py (SURVEY.md §2.15),
for this framework's formats: prints the layer graph of an architecture
spec and, given a weights file, each parameter's name/shape/stats — the
tool you reach for when reverse-engineering or validating a weight blob.
The port's copy of the JAX package's ``fastdet_tpu/cli/inspect_weights.py``:
its text output equals that tool's line for line. It reads arrays on the
host only, so it takes no device.

Usage:
    python -m fastdet_tpu_torch.cli.inspect_weights [-a arch] [-c classes] [weights]
    python -m fastdet_tpu_torch.cli.inspect_weights -g tiny        # graph only
    python -m fastdet_tpu_torch.cli.inspect_weights -r model.onnx  # raw ONNX dump
        (node list + initializer stats for ANY onnx file, like the
        reference's models/inspect_onnx.py:7-25 — no onnx package needed)
"""

from __future__ import annotations

import getopt
import sys

import numpy as np


def print_graph(spec) -> None:
    from fastdet_tpu_torch.models import yolov3

    in_ch = 3
    channels = []
    size = spec.image_size
    print(f"# {spec.name} num_classes={spec.num_classes} image={size}")
    for i, l in enumerate(spec.layers):
        if isinstance(l, yolov3.Conv):
            size = size // l.stride
            desc = (f"conv {l.name:>8} {l.ksize}x{l.ksize}/{l.stride} "
                    f"{in_ch:4d}->{l.filters:<4d}"
                    f"{' bn' if l.bn else '   '}{' leaky' if l.act else ' linear'}")
            in_ch = l.filters
        elif isinstance(l, yolov3.MaxPool):
            if l.stride > 1:
                size //= l.stride
            desc = f"max  {l.size}x{l.size}/{l.stride}"
        elif isinstance(l, yolov3.Upsample):
            size *= 2
            desc = "upsample x2"
        elif isinstance(l, yolov3.Route):
            in_ch = sum(channels[s] for s in l.sources)
            desc = f"route {list(l.sources)} -> {in_ch}ch"
        elif isinstance(l, yolov3.Shortcut):
            desc = f"shortcut from {l.source}"
        elif isinstance(l, yolov3.YoloHead):
            desc = f"yolo head scale={l.scale} grid={size} anchors={spec.anchors[l.scale]}"
        channels.append(in_ch)
        print(f"{i:3d}  {size:3d}x{size:<3d}  {desc}")


def print_params(spec, params) -> None:
    total = 0
    for name, p in params.items():
        for key, leaf in _leaves(p):
            a = np.asarray(leaf)
            total += a.size
            print(f"{name}/{key:12s} {str(a.shape):>20s}  "
                  f"min={a.min():+.4f} max={a.max():+.4f} mean={a.mean():+.4f}")
    print(f"# total parameters: {total:,}")


def _leaves(p):
    for k, v in p.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                yield f"{k}/{kk}", vv
        else:
            yield k, v


def print_onnx_raw(path: str) -> None:
    """Dump an arbitrary ONNX file's graph + initializers (the reference
    inspect_onnx.py's printable_graph / numpy_helper dump equivalent)."""
    from fastdet_tpu_torch.models import onnx_io

    g = onnx_io.load_graph(path)
    print(f"# graph {g.name!r}: inputs={g.inputs} outputs={g.outputs}")
    for i, node in enumerate(g.nodes):
        attrs = ", ".join(
            f"{k}={v if not isinstance(v, np.ndarray) else f'tensor{v.shape}'}"
            for k, v in node.attrs.items()
        )
        print(f"{i:4d}  {node.op_type:<22s} {node.inputs} -> {node.outputs}"
              + (f"  [{attrs}]" if attrs else ""))
    print()
    total = 0
    for name, a in g.initializers.items():
        total += a.size
        if a.size:
            print(f"{name:40s} {str(a.dtype):8s} {str(a.shape):>20s}  "
                  f"min={a.min():+.4f} max={a.max():+.4f}")
        else:
            print(f"{name:40s} {str(a.dtype):8s} {str(a.shape):>20s}  (empty)")
    print(f"# total initializer elements: {total:,}")


def main(argv):
    def usage():
        print(f"usage: {argv[0]} [-a arch] [-c num_classes] [-g arch] "
              f"[-r model.onnx] [weights]")
        return 100

    try:
        (opts, args) = getopt.getopt(argv[1:], "a:c:g:r:")
    except getopt.GetoptError:
        return usage()
    arch = None
    num_classes = 80
    graph_only = None
    for (k, v) in opts:
        if k == "-a":
            arch = v
        elif k == "-c":
            num_classes = int(v)
        elif k == "-g":
            graph_only = v
        elif k == "-r":
            print_onnx_raw(v)
            return 0

    from fastdet_tpu_torch.models import weights as weights_io
    from fastdet_tpu_torch.models import yolov3

    if graph_only:
        print_graph(yolov3.get_spec(graph_only, num_classes))
        return 0
    if not args:
        return usage()
    spec, params = weights_io.load_model(args[0], arch=arch, num_classes=num_classes)
    print_graph(spec)
    print()
    print_params(spec, params)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
