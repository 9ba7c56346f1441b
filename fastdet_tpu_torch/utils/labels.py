"""Class-name tables (the port's copy of the JAX package's
``fastdet_tpu/utils/labels.py``, table for table).

Runtime class ids are 1-indexed (0 = UNDEFINED on the wire; reference
emits argmax+1, server/detector.py:165, and the client filters klass==0).
The on-disk .names files are 0-indexed lists, one name per line, exactly
like the reference's models/coco.names (80 standard COCO classes) and
models/rsu.names (9 classes).
"""

from __future__ import annotations

from typing import List, Optional

COCO_NAMES: List[str] = [
    "person", "bicycle", "car", "motorbike", "aeroplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "sofa", "pottedplant", "bed", "diningtable", "toilet", "tvmonitor",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
]

RSU_NAMES: List[str] = [
    "person", "car", "bicycle", "camera", "a60g", "rsubox", "asub6",
    "ammw", "autocar",
]


# Label tables for the first-party trained shape checkpoints
# (data/synth.py; weights/detect{3,9}_tiny.npz) — 0-indexed on
# disk like coco.names/rsu.names; name_of() applies the 1-indexed wire
# convention.
SHAPES3_NAMES: List[str] = ["disc", "box", "tri"]
SHAPES9_NAMES: List[str] = ["disc", "box", "tri", "ring", "frame",
                            "cross", "bar", "dots", "stripes"]

# 80-class shape world (hue family x shape, synth.SHAPE_CLASSES_80) —
# the trained stand-in for the reference's full:80 COCO endpoint.
_HUES = ["red", "amber", "lime", "green", "teal", "azure", "blue",
         "violet", "pink"]
SHAPES80_NAMES: List[str] = [
    f"{_HUES[k // 9]}-{SHAPES9_NAMES[k % 9]}" for k in range(80)]


def load_names(path: str) -> List[str]:
    with open(path) as fp:
        return [line.strip() for line in fp if line.strip()]


def name_of(names: List[str], klass: int) -> Optional[str]:
    """1-indexed lookup; None for 0/out-of-range (client-side UNDEFINED)."""
    if 1 <= klass <= len(names):
        return names[klass - 1]
    return None
