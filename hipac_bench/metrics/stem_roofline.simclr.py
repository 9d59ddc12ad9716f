"""The training stem's kernels (BatchNorm statistics, BatchNorm, ReLU and the
3×3/2 maxpool, forward and backward: every kernel whose name holds
``hipac_stem_train``) against the least bytes any implementation must move
for a view: forward, read conv1's bf16 plane (112² × 64) and write the
pooled one (56² × 64); backward, read the plane and the pooled gradient and
write the plane's gradient. Over 3.35 TB/s, divided by the kernels' device
time in the traced window; none where no such kernel ran."""

from hipac_bench import counts, readers

STEM_CHANNELS = 64


def read(trace: dict, work: dict):
    views = work.get("views")
    if not views:
        return None
    plane = 2 * views * (counts.IMAGE // 2) ** 2 * STEM_CHANNELS
    pooled = 2 * views * (counts.IMAGE // 4) ** 2 * STEM_CHANNELS
    nbytes = (plane + pooled) + (2 * plane + pooled)
    return readers.roofline(trace, "hipac_stem_train", nbytes, 0.0)
