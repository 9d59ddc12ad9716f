"""The rate of gathering a SimCLR batch from the packed store:
``hipac.data.bytes`` (the images read) over the summed
``hipac.data.gather`` spans, in GB/s (1e9 bytes)."""

from hipac_bench import spans


def read(trace: dict, work: dict):
    return spans.gb_per_s(work, spans.GATHER, spans.GATHERED_BYTES)
