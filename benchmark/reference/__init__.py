"""The plain reference that decides ``correct``.

Plain PyTorch and NumPy, independent of the program under test: it
imports nothing of ``fastdet_tpu_torch`` (nor JAX), takes only what the
benchmark hands both sides (the JPEG bytes, the unfolded weights, the
configuration's layer list) and works everything else out again:

- :mod:`.darknet`: the network of a Darknet layer list in float32, batch
  norm unfolded, TF32 off: YOLOv3's layers and YOLOv4's (Mish, SPP's
  centred pools, grouped routes); it refuses a layer it does not
  implement;
- :mod:`.detect`: Pillow JPEG decode, YOLO head decode (with
  ``scale_x_y``), Gaussian
  soft-NMS and the wire's ``>BBhhhh`` records.
"""
