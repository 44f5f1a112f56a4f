"""The warp kernel's share of its roofline, in %: the least time the
bytes its warps need take at the card's HBM bandwidth (``roofline.py``,
``peaks.json``), over the device time of ``affine_warp_kernel``, per
stream-frame of the traced slice."""

from portbench import roofline


def read(outcome, cell):
    t = outcome.trace
    if t is None or not t.stream_frames:
        return None
    kernel_s = sum(s for name, s in t.kernel_s.items() if "affine_warp_kernel" in name)
    if kernel_s <= 0:
        return None
    bound_s = roofline.warp_bytes_per_frame(cell.config) * t.stream_frames / \
        roofline.peak("hbm_bytes_per_s")
    return 100.0 * bound_s / kernel_s
