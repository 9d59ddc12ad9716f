"""The host's time to issue a SimCLR step's work outside the backward
(views, both forwards, NT-Xent, Adam: the ``hipac.simclr.*`` spans less
``hipac.simclr.backward``), in ms a step. The device runs the work later;
the host's waits on the device fall in the backward, read apart by
``backward_ms.simclr``."""

from hipac_bench import spans


def read(trace: dict, work: dict):
    return spans.ms_per_step(work, spans.SIMCLR_ISSUE)
