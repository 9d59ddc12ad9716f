"""The slide loop's share of the bf16 peak: ResNet18's forward operations
at 224² with the 2-class head, 2 × 1.813 GMAC, for every cell forwarded
in the traced window (the device filter forwards every cell)."""

from hipac_bench import counts, readers


def read(trace: dict, work: dict):
    if not work.get("cells"):
        return None
    return readers.mfu(2.0 * counts.forward_macs() * work["cells"], trace)
