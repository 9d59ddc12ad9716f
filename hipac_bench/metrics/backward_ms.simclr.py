"""The host's time in a SimCLR step's ``loss.backward()`` (the
``hipac.simclr.backward`` span), in ms a step: the backward's issue, and
the waits on the device that the host meets once it runs ahead of it. Where
the device sets the pace, it shrinks as the feed grows."""

from hipac_bench import spans


def read(trace: dict, work: dict):
    return spans.ms_per_step(work, (spans.SIMCLR_BACKWARD,))
