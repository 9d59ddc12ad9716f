"""The classifier train step's share of the bf16 peak: three times the
forward's operations a patch, less the stem's gradient of the input image,
for every patch of the traced window's steps."""

from hipac_bench import counts, readers


def read(trace: dict, work: dict):
    if not work.get("patches"):
        return None
    return readers.mfu(counts.train_flop() * work["patches"], trace)
