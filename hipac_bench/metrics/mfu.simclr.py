"""The SimCLR step's share of the bf16 peak: a view's training operations
through the encoder and the 512 → 512 → 128 projection (three times the
forward, less the stem's input gradient), and a step's NT-Xent similarity
matrix and its two gradient products over the 1,024 views."""

from hipac_bench import counts, readers


def read(trace: dict, work: dict):
    if not work.get("views"):
        return None
    per_view = counts.train_flop(classes=None,
                                 extra_macs=counts.projection_macs())
    per_step = counts.nt_xent_flop(work["views"] // work["steps"])
    return readers.mfu(per_view * work["views"] + per_step * work["steps"],
                       trace)
