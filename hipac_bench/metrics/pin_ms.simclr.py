"""The host's time to copy a SimCLR step's batch into pinned memory
(``to_device``'s ``hipac.feed.pin`` spans), in ms a step; none where nothing
is pinned (on the CPU)."""

from hipac_bench import spans


def read(trace: dict, work: dict):
    return spans.ms_per_step(work, (spans.PIN,))
