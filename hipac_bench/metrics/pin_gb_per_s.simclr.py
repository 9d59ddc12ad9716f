"""The rate of pinning a SimCLR batch: ``hipac.feed.pinned_bytes`` over the
summed ``hipac.feed.pin`` spans, in GB/s (1e9 bytes); none where nothing is
pinned (on the CPU)."""

from hipac_bench import spans


def read(trace: dict, work: dict):
    return spans.gb_per_s(work, spans.PIN, spans.PINNED_BYTES)
