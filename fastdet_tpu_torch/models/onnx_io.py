"""ONNX weight import/export without the ``onnx`` package.

The port's copy of the JAX package's ``fastdet_tpu/models/onnx_io.py``:
the same bytes out of :func:`save_onnx` and the same arrays out of
:func:`load_onnx` (tests/test_torch_checkpoint.py), with host numpy
leaves. The reference's registry contract is ``name:num_classes:path.onnx``
and its tooling walks GraphProto initializers. Initializers are plain
protobuf, so this module hand-rolls exactly the subset of the ONNX
protobuf schema needed to (a) read conv/BN weights out of a
YOLOv3-family graph in graph order and (b) write a structurally valid
single-graph model that ONNX tooling (and our own reader) can consume.

Wire-format notes: protobuf messages are sequences of (tag, value) where
tag = field_number << 3 | wire_type; wire types used by ONNX: 0 = varint,
1 = 64-bit, 2 = length-delimited (strings, bytes, sub-messages, packed
repeated), 5 = 32-bit. Field numbers below are from onnx.proto3
(ModelProto: ir_version=1, opset_import=8, graph=7, producer_name=2;
GraphProto: node=1, name=2, initializer=5, input=11, output=12;
NodeProto: input=1, output=2, name=3, op_type=4, attribute=5;
TensorProto: dims=1, data_type=2, float_data=4, int64_data=7, name=8,
raw_data=9; AttributeProto: name=1, f=2, i=3, s=4, t=5, ints=8, type=20;
ValueInfoProto: name=1, type=2; OperatorSetIdProto: domain=1, version=2).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from fastdet_tpu_torch.models import yolov3
from fastdet_tpu_torch.models.layers import BN_EPS

# TensorProto.DataType values we understand
_DT_FLOAT = 1
_DT_INT32 = 6
_DT_INT64 = 7

# AttributeProto.AttributeType
_ATTR_FLOAT = 1
_ATTR_INT = 2
_ATTR_STRING = 3
_ATTR_TENSOR = 4
_ATTR_FLOATS = 6
_ATTR_INTS = 7


# ---------------------------------------------------------------------------
# Wire-level decode
# ---------------------------------------------------------------------------

def _read_varint(buf, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("onnx: truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & ((1 << 64) - 1), pos
        shift += 7
        if shift > 63:
            raise ValueError("onnx: varint too long")


def _fields(buf) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) for one message body.

    Length-delimited values come back as memoryview; varints as int;
    fixed32/64 as raw 4/8 bytes.
    """
    mv = memoryview(buf)
    pos = 0
    n = len(mv)
    while pos < n:
        tag, pos = _read_varint(mv, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:
            val, pos = _read_varint(mv, pos)
        elif wt == 2:
            ln, pos = _read_varint(mv, pos)
            if pos + ln > n:
                raise ValueError("onnx: truncated field")
            val = mv[pos : pos + ln]
            pos += ln
        elif wt == 5:
            val = mv[pos : pos + 4]
            pos += 4
        elif wt == 1:
            val = mv[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"onnx: unsupported wire type {wt}")
        yield field, wt, val


def _varints(buf) -> List[int]:
    """Decode a packed repeated varint payload."""
    out = []
    mv = memoryview(buf)
    pos = 0
    while pos < len(mv):
        v, pos = _read_varint(mv, pos)
        out.append(v)
    return out


def _signed64(v: int) -> int:
    """Protobuf int64 is two's complement over 10 varint bytes: values
    with bit 63 set are negative (e.g. a Reshape dim of -1 arrives as
    2**64-1 unsigned) — without this they overflow np.int64 conversion."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _parse_tensor(buf) -> Tuple[str, np.ndarray]:
    """TensorProto -> (name, array). float32/int32/int64 only."""
    dims: List[int] = []
    dtype = _DT_FLOAT
    name = ""
    raw: Optional[memoryview] = None
    floats: List[float] = []
    ints: List[int] = []
    for field, wt, val in _fields(buf):
        if field == 1:                    # dims (packed or unpacked)
            dims.extend(_varints(val) if wt == 2 else [val])
        elif field == 2 and wt == 0:      # data_type
            dtype = val
        elif field == 4:                  # float_data
            if wt == 2:
                floats.extend(np.frombuffer(bytes(val), "<f4").tolist())
            else:
                floats.append(struct.unpack("<f", bytes(val))[0])
        elif field in (5, 7):             # int32_data / int64_data
            got = _varints(val) if wt == 2 else [val]
            ints.extend(_signed64(v) for v in got)
        elif field == 8 and wt == 2:      # name
            name = bytes(val).decode("utf-8")
        elif field == 9 and wt == 2:      # raw_data
            raw = val
    np_dtype = {_DT_FLOAT: np.float32, _DT_INT32: np.int32,
                _DT_INT64: np.int64}.get(dtype)
    if np_dtype is None:
        raise ValueError(f"onnx: unsupported tensor dtype {dtype} ({name})")
    if raw is not None:
        # one copy out of the file's buffer: aligned and writable leaves
        arr = np.frombuffer(raw, np_dtype).copy()
    elif dtype == _DT_FLOAT:
        arr = np.asarray(floats, np.float32)
    else:
        arr = np.asarray(ints, np_dtype)
    shape = tuple(int(d) for d in dims)
    expected = int(np.prod(shape)) if shape else arr.size
    if arr.size != expected:
        raise ValueError(f"onnx: tensor {name!r} size {arr.size} != dims {shape}")
    return name, arr.reshape(shape)


def _parse_attr(buf) -> Tuple[str, Any]:
    name = ""
    value: Any = None
    for field, wt, val in _fields(buf):
        if field == 1 and wt == 2:
            name = bytes(val).decode("utf-8")
        elif field == 2:                  # f (fixed32)
            value = struct.unpack("<f", bytes(val))[0]
        elif field == 3 and wt == 0:      # i
            value = _signed64(val)
        elif field == 4 and wt == 2:      # s
            value = bytes(val)
        elif field == 5 and wt == 2:      # t
            value = _parse_tensor(val)[1]
        elif field == 7:                  # floats
            value = (value or [])
            if wt == 2:
                value = np.frombuffer(bytes(val), "<f4").tolist()
            else:
                value.append(struct.unpack("<f", bytes(val))[0])
        elif field == 8:                  # ints
            got = _varints(val) if wt == 2 else [val]
            value = (value or []) + [_signed64(v) for v in got]
    return name, value


class OnnxNode:
    __slots__ = ("op_type", "inputs", "outputs", "name", "attrs")

    def __init__(self):
        self.op_type = ""
        self.inputs: List[str] = []
        self.outputs: List[str] = []
        self.name = ""
        self.attrs: Dict[str, Any] = {}


def _parse_node(buf) -> OnnxNode:
    n = OnnxNode()
    for field, wt, val in _fields(buf):
        if field == 1 and wt == 2:
            n.inputs.append(bytes(val).decode("utf-8"))
        elif field == 2 and wt == 2:
            n.outputs.append(bytes(val).decode("utf-8"))
        elif field == 3 and wt == 2:
            n.name = bytes(val).decode("utf-8")
        elif field == 4 and wt == 2:
            n.op_type = bytes(val).decode("utf-8")
        elif field == 5 and wt == 2:
            k, v = _parse_attr(val)
            n.attrs[k] = v
    return n


class OnnxGraph:
    __slots__ = ("name", "nodes", "initializers", "inputs", "outputs")

    def __init__(self):
        self.name = ""
        self.nodes: List[OnnxNode] = []
        self.initializers: Dict[str, np.ndarray] = {}
        self.inputs: List[str] = []
        self.outputs: List[str] = []


def _value_info_name(buf) -> str:
    for field, wt, val in _fields(buf):
        if field == 1 and wt == 2:
            return bytes(val).decode("utf-8")
    return ""


def parse_graph(buf) -> OnnxGraph:
    g = OnnxGraph()
    for field, wt, val in _fields(buf):
        if field == 1 and wt == 2:
            g.nodes.append(_parse_node(val))
        elif field == 2 and wt == 2:
            g.name = bytes(val).decode("utf-8")
        elif field == 5 and wt == 2:
            name, arr = _parse_tensor(val)
            g.initializers[name] = arr
        elif field == 11 and wt == 2:
            g.inputs.append(_value_info_name(val))
        elif field == 12 and wt == 2:
            g.outputs.append(_value_info_name(val))
    return g


def parse_model(data: bytes) -> OnnxGraph:
    """ModelProto bytes -> the (single) GraphProto."""
    for field, wt, val in _fields(data):
        if field == 7 and wt == 2:
            return parse_graph(val)
    raise ValueError("onnx: no graph in model")


def load_graph(path: str) -> OnnxGraph:
    with open(path, "rb") as fp:
        return parse_model(fp.read())


# ---------------------------------------------------------------------------
# Wire-level encode
# ---------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    if v < 0:
        # protobuf int64: negatives are 64-bit two's complement (ten
        # bytes on the wire); python's arithmetic shift would loop forever
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wt: int) -> bytes:
    return _varint(field << 3 | wt)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _str_field(field: int, s: str) -> bytes:
    return _len_field(field, s.encode("utf-8"))


def _int_field(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def _tensor_bytes(name: str, arr: np.ndarray) -> bytes:
    a = np.asarray(arr)
    if a.dtype == np.float32:
        dt = _DT_FLOAT
    elif a.dtype == np.int64:
        dt = _DT_INT64
    elif a.dtype == np.int32:
        dt = _DT_INT32
    else:
        raise ValueError(f"onnx export: unsupported dtype {a.dtype}")
    out = b"".join(_int_field(1, int(d)) for d in a.shape)
    out += _int_field(2, dt)
    out += _str_field(8, name)
    out += _len_field(9, np.ascontiguousarray(a).tobytes())
    return out


def _attr_bytes(name: str, value: Any) -> bytes:
    out = _str_field(1, name)
    if isinstance(value, float):
        out += _tag(2, 5) + struct.pack("<f", value)
        out += _int_field(20, _ATTR_FLOAT)
    elif isinstance(value, bool):
        raise ValueError("onnx export: bool attr unsupported")
    elif isinstance(value, int):
        out += _int_field(3, value)
        out += _int_field(20, _ATTR_INT)
    elif isinstance(value, (list, tuple)):
        for v in value:
            out += _int_field(8, int(v))
        out += _int_field(20, _ATTR_INTS)
    elif isinstance(value, bytes):
        out += _len_field(4, value)
        out += _int_field(20, _ATTR_STRING)
    elif isinstance(value, np.ndarray):
        out += _len_field(5, _tensor_bytes(name + "_value", value))
        out += _int_field(20, _ATTR_TENSOR)
    else:
        raise ValueError(f"onnx export: unsupported attr {name}={value!r}")
    return out


def _node_bytes(op_type: str, inputs: List[str], outputs: List[str],
                name: str = "", **attrs: Any) -> bytes:
    out = b"".join(_str_field(1, i) for i in inputs)
    out += b"".join(_str_field(2, o) for o in outputs)
    if name:
        out += _str_field(3, name)
    out += _str_field(4, op_type)
    for k, v in attrs.items():
        out += _len_field(5, _attr_bytes(k, v))
    return out


def _value_info_bytes(name: str, dims: Optional[Tuple[int, ...]] = None) -> bytes:
    # ValueInfoProto{name=1, type=2:TypeProto{tensor_type=1:Tensor{
    #   elem_type=1, shape=2:TensorShapeProto{dim=1:{dim_value=1}}}}}
    out = _str_field(1, name)
    shape = b""
    for d in dims or ():
        shape += _len_field(1, _int_field(1, int(d)))
    tensor = _int_field(1, _DT_FLOAT) + _len_field(2, shape)
    out += _len_field(2, _len_field(1, tensor))
    return out


# ---------------------------------------------------------------------------
# YOLOv3-family import: graph -> (spec, params)
# ---------------------------------------------------------------------------

def _conv_shape_chain(spec) -> List[Tuple[int, int, int]]:
    """Expected (in_channels, filters, ksize) per conv, in spec order, by
    simulating channel flow through the layer graph (Route concatenates,
    Shortcut/MaxPool/Upsample preserve channels).

    Conv-to-spec assignment is VERIFIED against this chain instead of
    trusted from graph order: YOLOv3's parallel head branches carry
    distinct channel signatures (e.g. full: 1024/512/256-in heads), so an
    exporter whose topological sort emits branches in a different scale
    order fails loudly here instead of silently loading head weights into
    the wrong scale. Within a branch the data dependency chain makes
    graph order unambiguous.
    """
    return yolov3.conv_io_channels(spec)


def load_onnx(
    path: str, arch: Optional[str] = None, num_classes: Optional[int] = None,
):
    """Read conv/BN weights from a YOLOv3-family ONNX file.

    Dialect tolerance (the reference consumed third-party exports,
    server/detector.py:118, so ours must too):

    - convs are collected in graph order but every assignment is verified
      against the spec's channel chain (`_conv_shape_chain`) — a clear
      error replaces silent misassignment on exotic node orderings;
    - BN may appear as a BatchNormalization node after the conv OR be
      pre-folded by the exporter into conv weight+bias (materialized as
      an exact identity-BN entry so the {'w','bn'} contract holds for
      every consumer — numerically bit-identical after fold_conv_bn);
      a BN node whose params are NOT plain initializers is refused
      loudly rather than silently treated as folded;
    - structural nodes (Resize vs Upsample vs ConvTranspose upsampling,
      Concat, Add, activations) are not interpreted — weights define the
      model and the spec defines the structure, so any upsample spelling
      is accepted as long as the channel chain checks out.

    Returns (spec, unfolded params) like the other loaders.
    """
    g = load_graph(path)
    init = g.initializers
    # tensor name -> node consuming it (first consumer wins; enough to
    # find the BN that immediately follows each conv)
    consumer: Dict[str, OnnxNode] = {}
    for node in g.nodes:
        for i in node.inputs:
            consumer.setdefault(i, node)

    convs: List[Tuple[np.ndarray, Optional[np.ndarray], Optional[Dict[str, np.ndarray]]]] = []
    for node in g.nodes:
        if node.op_type != "Conv":
            continue
        if len(node.inputs) < 2 or node.inputs[1] not in init:
            raise ValueError(f"onnx: conv {node.name!r} weight not an initializer")
        w = init[node.inputs[1]]            # OIHW
        bias = None
        if len(node.inputs) > 2 and node.inputs[2] in init:
            bias = init[node.inputs[2]]
        bn = None
        bn_unreadable = False
        nxt = consumer.get(node.outputs[0])
        if nxt is not None and nxt.op_type == "BatchNormalization":
            names = nxt.inputs[1:5]
            if all(n in init for n in names):
                bn = {
                    "gamma": init[names[0]],
                    "beta": init[names[1]],
                    "mean": init[names[2]],
                    "var": init[names[3]],
                }
            else:
                # A BN node EXISTS but its params aren't plain
                # initializers (Constant/Identity-wrapped by some
                # exporters). Silently treating the conv as BN-folded
                # would discard gamma/beta/mean/var and load garbage
                # with no shape error — refuse loudly instead.
                bn_unreadable = True
        convs.append((w, bias, bn, bn_unreadable))

    if arch is None:
        arch = {13: "tiny", 75: "full"}.get(len(convs))
        if arch is None:
            raise ValueError(
                f"onnx: {len(convs)} convs matches neither yolov3-tiny (13) "
                f"nor yolov3 (75)"
            )
    probe = yolov3.get_spec(arch, 80)
    if len(convs) != len(probe.conv_specs()):
        raise ValueError(
            f"onnx: {len(convs)} convs, {arch} needs {len(probe.conv_specs())}"
        )
    # infer num_classes from the head conv width: filters = 3*(5+C)
    head_idx = [i for i, c in enumerate(probe.conv_specs()) if not c.bn]
    inferred = convs[head_idx[0]][0].shape[0] // 3 - 5
    if num_classes is not None and inferred != num_classes:
        raise ValueError(
            f"onnx: model has {inferred} classes, registry says {num_classes}"
        )
    spec = yolov3.get_spec(arch, inferred)

    chain = _conv_shape_chain(spec)
    params: Dict[str, Any] = {}
    for i, (cspec, (w, bias, bn, bn_unreadable)) in enumerate(
            zip(spec.conv_specs(), convs)):
        in_ch, filters, k = chain[i]
        if w.shape != (filters, in_ch, k, k):
            raise ValueError(
                f"onnx: conv #{i} ({cspec.name}) has weight shape "
                f"{tuple(w.shape)}, expected (out={filters}, in={in_ch}, "
                f"k={k}): the file's conv order does not match the "
                f"{spec.name} layer graph (head branches exported out of "
                f"scale order, or a different architecture?)"
            )
        entry: Dict[str, Any] = {
            # OIHW -> HWIO
            "w": np.ascontiguousarray(w.transpose(2, 3, 1, 0))
        }
        if cspec.bn:
            if bn is not None:
                entry["bn"] = dict(bn)
            elif bn_unreadable:
                raise ValueError(
                    f"onnx: conv {cspec.name}'s BatchNormalization params "
                    f"are not plain initializers (Constant/Identity-"
                    f"wrapped export?) — refusing to guess; re-export with "
                    f"constant folding or fold BN before export"
                )
            elif bias is not None:
                # BN-folded export: materialize an EXACT identity BN
                # (inv = gamma/sqrt(var+eps) = 1/sqrt(1-eps+eps) = 1)
                # so the entry honors the documented {'w','bn'} contract
                # — save_darknet and every bn-keyed consumer keep
                # working — while fold_conv_bn reproduces w'=w, b'=bias
                # bit-for-bit.
                f = np.float32
                entry["bn"] = {
                    "gamma": np.ones(cspec.filters, f),
                    "beta": np.asarray(bias, f),
                    "mean": np.zeros(cspec.filters, f),
                    "var": np.full(cspec.filters, 1.0 - BN_EPS, f),
                }
            else:
                raise ValueError(
                    f"onnx: conv {cspec.name} has neither a "
                    f"BatchNormalization consumer nor a folded bias"
                )
        else:
            if bias is None:
                bias = np.zeros((cspec.filters,), np.float32)
            entry["b"] = bias
        params[cspec.name] = entry
    return spec, params


# ---------------------------------------------------------------------------
# YOLOv3-family export: (spec, params) -> .onnx
# ---------------------------------------------------------------------------

def save_onnx(path: str, spec, params: Dict[str, Any]) -> None:
    """Write a structurally valid ONNX (opset 11) YOLOv3-family graph.

    Input tensor is named 'input', NCHW float32 (the reference feeds
    exactly that name, server/detector.py:135); graph outputs are the raw
    head convolutions in scale order, so anchor selection by
    number-of-outputs (detector.py:96-106) works on the exported file.
    """
    nodes: List[bytes] = []
    inits: List[bytes] = []
    out_of: List[str] = []           # layer index -> tensor name
    cur = "input"
    head_outputs: List[str] = []
    uid = [0]

    def fresh(base: str) -> str:
        uid[0] += 1
        return f"{base}_{uid[0]}"

    for li, layer in enumerate(spec.layers):
        if isinstance(layer, yolov3.Conv):
            p = params[layer.name]
            w = np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1)  # HWIO->OIHW
            wname = f"{layer.name}.weight"
            inits.append(_tensor_bytes(wname, np.ascontiguousarray(w)))
            conv_in = [cur, wname]
            if "b" in p and "bn" not in p:
                bname = f"{layer.name}.bias"
                inits.append(_tensor_bytes(bname, np.asarray(p["b"], np.float32)))
                conv_in.append(bname)
            pad = layer.ksize // 2
            y = fresh(layer.name)
            nodes.append(_node_bytes(
                "Conv", conv_in, [y], name=layer.name,
                kernel_shape=[layer.ksize, layer.ksize],
                strides=[layer.stride, layer.stride],
                pads=[pad, pad, pad, pad],
            ))
            cur = y
            if "bn" in p:
                bn = p["bn"]
                names = []
                for k in ("gamma", "beta", "mean", "var"):
                    nm = f"{layer.name}.bn.{k}"
                    inits.append(_tensor_bytes(nm, np.asarray(bn[k], np.float32)))
                    names.append(nm)
                y = fresh(layer.name + "_bn")
                nodes.append(_node_bytes(
                    "BatchNormalization", [cur] + names, [y],
                    epsilon=float(BN_EPS),
                ))
                cur = y
            if layer.act:
                y = fresh(layer.name + "_lrelu")
                nodes.append(_node_bytes("LeakyRelu", [cur], [y], alpha=0.1))
                cur = y
        elif isinstance(layer, yolov3.MaxPool):
            y = fresh("pool")
            # size=2,stride=1 keeps resolution (darknet pads right/bottom)
            pads = [0, 0, layer.size - layer.stride, layer.size - layer.stride] \
                if layer.stride == 1 else [0, 0, 0, 0]
            nodes.append(_node_bytes(
                "MaxPool", [cur], [y],
                kernel_shape=[layer.size, layer.size],
                strides=[layer.stride, layer.stride], pads=pads,
            ))
            cur = y
        elif isinstance(layer, yolov3.Upsample):
            sname = fresh("scales")
            inits.append(_tensor_bytes(
                sname, np.asarray([1.0, 1.0, 2.0, 2.0], np.float32)))
            rname = fresh("roi")
            inits.append(_tensor_bytes(rname, np.asarray([], np.float32)))
            y = fresh("upsample")
            nodes.append(_node_bytes(
                "Resize", [cur, rname, sname], [y], mode=b"nearest"))
            cur = y
        elif isinstance(layer, yolov3.Route):
            srcs = [out_of[i] for i in layer.sources]
            if len(srcs) == 1:
                cur = srcs[0]
            else:
                y = fresh("concat")
                nodes.append(_node_bytes("Concat", srcs, [y], axis=1))
                cur = y
        elif isinstance(layer, yolov3.Shortcut):
            y = fresh("add")
            nodes.append(_node_bytes("Add", [cur, out_of[layer.source]], [y]))
            cur = y
        elif isinstance(layer, yolov3.YoloHead):
            head_outputs.append(cur)
        out_of.append(cur)

    size = spec.image_size
    graph = b"".join(_len_field(1, nb) for nb in nodes)
    graph += _str_field(2, spec.name)
    graph += b"".join(_len_field(5, ib) for ib in inits)
    graph += _len_field(11, _value_info_bytes("input", (1, 3, size, size)))
    for h in head_outputs:
        graph += _len_field(12, _value_info_bytes(h))

    opset = _str_field(1, "") + _int_field(2, 11)
    model = _int_field(1, 7)                      # ir_version 7
    # producer_name: the JAX package's, so both write the same bytes
    model += _str_field(2, "fastdet_tpu")
    model += _len_field(7, graph)
    model += _len_field(8, opset)
    with open(path, "wb") as fp:
        fp.write(model)
