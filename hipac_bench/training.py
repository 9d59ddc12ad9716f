"""What the training cells share: the patch store as the program's dataset,
the record of a program's first steps, and the comparison of those steps
with the plain reference's.
"""

from __future__ import annotations

import importlib
import os
import tempfile
import time

import numpy as np
import torch

from hipac_bench import inputs
from hipac_bench.reference import train as ref_train

PORT = "ss25_hierarchical_multiscale_image_classification_tpu_torch"
#: the steps that the reference follows
STEPS = 3


def port(module: str):
    return importlib.import_module(f"{PORT}.{module}")


def store_dir() -> str:
    """Where patch stores live: the temporary directory's, so that the runs
    of one side share them."""
    return os.path.join(tempfile.gettempdir(), "hipac_bench")


def dataset(spec: dict, device: torch.device):
    """(the program's ``PatchDataset`` over the store of ``spec``, the
    store's path, its labels)."""
    path, labels = inputs.patch_store(spec, store_dir(), device)
    manifest = port("data.manifest")
    records = [manifest.PatchRecord(slide="store", level=3, x=i, y=0,
                                    label=int(labels[i]), store="packed",
                                    path=path, row=i)
               for i in range(len(labels))]
    ds = port("data.datasets").PatchDataset(
        manifest.PatchManifest(records), resize_to=int(spec["size"]))
    return ds, path, labels


class FirstSteps:
    """Wraps a train step and keeps, of the first :data:`STEPS` calls, each
    loss, the first gradient as Adam holds it after one step
    (``exp_avg / (1 − β1)``), and the parameters and BatchNorm's running
    statistics after the last."""

    def __init__(self, step, loss_of, model):
        self.step, self.loss_of = step, loss_of
        self.params = dict(model.named_parameters())
        self.buffers = {k: v for k, v in model.named_buffers()
                        if k.endswith(("running_mean", "running_var"))}
        self.rec = {"losses": [], "grad1": None, "after": None,
                    "running": None}

    def __call__(self, state, *args):
        state, out = self.step(state, *args)
        n = len(self.rec["losses"])
        if n < STEPS:
            self.rec["losses"].append(self.loss_of(out).detach().clone())
            if n == 0:
                beta1 = state.optimizer.param_groups[0]["betas"][0]
                held = state.optimizer.state
                self.rec["grad1"] = {
                    k: (held[p]["exp_avg"].detach().clone() / (1.0 - beta1)
                        if "exp_avg" in held.get(p, {})
                        else torch.zeros_like(p))
                    for k, p in self.params.items()}
            if n == STEPS - 1:
                self.rec["after"] = {k: p.detach().clone()
                                     for k, p in self.params.items()}
                self.rec["running"] = {k: b.detach().clone()
                                       for k, b in self.buffers.items()}
        return state, out

    def result(self) -> dict:
        rec = dict(self.rec)
        rec["losses"] = [float(v) for v in rec["losses"]]
        return rec


def first_batches(path: str, labels: np.ndarray, seed: int, batch: int,
                  device) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The rows of epoch 0's first :data:`STEPS` batches, read by the
    reference from the store file itself."""
    rows = inputs.read_store(path)
    order = ref_train.batch_order(len(labels), seed, 0)
    out = []
    for i in range(STEPS):
        idx = order[i * batch:(i + 1) * batch]
        out.append((torch.from_numpy(np.asarray(rows[idx])).to(device),
                    torch.from_numpy(labels[idx]).to(device)))
    return out


def readings(prog: dict, ref: dict, start: dict, limits: dict) -> dict:
    """The numbers that ``limits`` names, each beside its limit; with
    ``limits`` None every reading, for the control's record."""
    r = ref_train.step_readings(prog, ref, start)
    if limits is None:
        return r
    return {k: {"value": r[k], "limit": v} for k, v in limits.items()}


def other_steps(variant: str, run_reference) -> dict:
    """The steps that stand in the program's place for ``variant``: the
    reference with float8 products, forward and backward (the
    lower-precision control), or the reference with half of each batch
    left out (a fault)."""
    from hipac_bench.reference import resnet

    if variant == "control":
        return run_reference(quant=resnet.fp8_round,
                             act=resnet.fp8_act)
    if variant == "half_batch":
        return run_reference(half=True)
    raise ValueError(f"unknown variant {variant!r}")


def epochs_window(run_epoch, seconds: float, per_epoch: dict) -> dict:
    """Whole epochs, at least one, until ``seconds`` have passed; the work
    done."""
    n = 0
    start = time.perf_counter()
    end = start
    while n == 0 or end - start < seconds:
        run_epoch()
        end = time.perf_counter()
        n += 1
    work = {k: v * n for k, v in per_epoch.items()}
    work.update(attempted=per_epoch["steps"] * n, failed=0,
                seconds=end - start, epochs=n)
    return work
