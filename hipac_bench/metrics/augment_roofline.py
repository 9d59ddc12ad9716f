"""Kernel ``augment`` against its bound: every uint8 byte of the step's
images read once and every float32 value written once, over 3.35 TB/s
(about 12 operations an element are far below the peak), divided by the
kernel's device time in the traced window."""

from hipac_bench import counts, readers


def read(trace: dict, work: dict):
    patches = work.get("patches")
    if not patches:
        return None
    px = patches * counts.IMAGE * counts.IMAGE * 3
    return readers.roofline(trace, "augment_kernel",
                            counts.augment_bytes(patches), 12.0 * px)
