"""Kernels: kernel B1's share of its roofline in the traced part of the
window. Least time: the bytes B1 has to move for the frames it
reconstructed there (benchmark.flops.b1_bytes, a floor) over the HBM's
3.35 TB/s; device time: the summed duration of the trace's
``sparse_tile_kernel`` events. Frames in the trace are its B1 launches
times the window's frames per B1 launch (the program's counters).
Source: the device trace."""

from benchmark.flops import PEAK_HBM_BYTES_PER_S, b1_bytes

KERNEL = "sparse_tile_kernel"


def read(run):
    w = run.window
    if w.trace is None:
        return None
    us, launches = w.trace.kernel_us(KERNEL)
    ing0, ing1 = w.before["ingest"], w.after["ingest"]
    frames = sum(ing1.get(k, 0) - ing0.get(k, 0)
                 for k in ("sparse", "sparse_dense"))
    runs = w.after["b1_launches"] - w.before["b1_launches"]
    if us <= 0 or launches == 0 or runs <= 0 or frames <= 0:
        return None
    per_frame = sum(b1_bytes(j) for j in run.jpegs) / len(run.jpegs)
    least_s = launches * frames / runs * per_frame / PEAK_HBM_BYTES_PER_S
    return 100.0 * least_s / (us / 1e6)
