"""The host's time to gather a SimCLR step's rows from the packed store
(``BatchIterator``'s ``hipac.data.gather`` spans), in ms a step."""

from hipac_bench import spans


def read(trace: dict, work: dict):
    return spans.ms_per_step(work, (spans.GATHER,))
