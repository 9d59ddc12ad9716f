"""Kernel 2a (``fused_normalize``) against its bound: every uint8 byte of
the cells read once, every bf16 value and 8-byte sum written once, over
3.35 TB/s (2 operations an element are far below the bf16 peak), divided
by the kernel's device time in the traced window."""

from hipac_bench import counts, readers


def read(trace: dict, work: dict):
    cells = work.get("cells")
    if not cells:
        return None
    px = cells * counts.IMAGE * counts.IMAGE * 3
    return readers.roofline(trace, "fused_normalize",
                            counts.fused_normalize_bytes(cells), 2.0 * px)
