"""Device idle share under the slide cell's loop: 1 − the union of kernel,
copy and set intervals over the traced window, in per cent."""

from hipac_bench import readers


def read(trace: dict, work: dict):
    return readers.idle_share(trace) if work.get("cells") else None
