"""SimCLR pretraining, as ``pretrain_simclr`` runs it on one card, by a copy
of that function's loop body (the program has no function of one epoch to
call; a change to its loop does not reach this copy): epochs over a
packed store (``BatchIterator``, each batch to the card through
``to_device``), each step ``train/simclr_trainer.py::make_simclr_train_step``
(two views, two bf16 forwards of ``models/simclr.py::SimCLRModel``, the
dense NT-Xent, the backward, fused Adam), the losses fetched once an epoch.
The loop's best-loss and periodic checkpoint writes are left out: they
write the model to disk and are not the step.

Check (after the window): the plain float32 reference follows the first
steps (run in set-up through the same step and loop) from the same weights,
rows and draws; the numbers that ``traffic["limits"]`` names are compared
(the median leaf's first-gradient norm, the first step's loss and the
worst leaf's change over the steps).
"""

from __future__ import annotations

import time

import torch

from hipac_bench import inputs, training, weights
from hipac_bench.reference import train as ref_train
from hipac_bench.trace import span


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device, workdir: str):
        self.cfg, self.t, self.seed, self.dev = cfg, traffic, seed, device

    def setup(self, pieces: dict) -> None:
        t = time.perf_counter()
        trainer = training.port("train.simclr_trainer")
        simclr = training.port("models.simclr")
        self.to_device = training.port("parallel.feed").to_device
        datasets = training.port("data.datasets")
        state_mod = training.port("train.state")
        if self.dev.type == "cuda":
            training.port("ops.build").load_library()
        pieces["kernels"] = time.perf_counter() - t

        t = time.perf_counter()
        ds, self.path, self.labels = training.dataset(self.t["store"],
                                                      self.dev)
        pieces["inputs"] = time.perf_counter() - t

        t = time.perf_counter()
        c = self.cfg
        g = torch.Generator(device=self.dev).manual_seed(
            inputs.sub_seed(self.seed, 2))
        self.start = weights.simclr(g, self.dev, c["projection_hidden_dim"],
                                    c["projection_dim"])
        model = simclr.SimCLRModel(projection_dim=c["projection_dim"],
                                   projection_hidden_dim=c[
                                       "projection_hidden_dim"])
        model.load_state_dict(self.start)
        self.state = state_mod.create_train_state(model, c["learning_rate"],
                                                  self.dev)
        self.step = trainer.make_simclr_train_step(
            c["temperature"], c["image_size"], c["loss_impl"])
        self.batches = datasets.BatchIterator(ds, c["batch_size"],
                                              seed=self.seed)
        self.generator = torch.Generator(device=self.dev).manual_seed(
            self.seed + 17)
        pieces["weights"] = time.perf_counter() - t

        t = time.perf_counter()
        rec = training.FirstSteps(self.step, lambda loss: loss,
                                  self.state.model)
        self._epoch(rec)
        self.first = rec.result()
        pieces["warmup"] = time.perf_counter() - t

    def _epoch(self, step=None) -> float:
        """One epoch of ``pretrain_simclr``'s loop: the mean loss."""
        step = step or self.step
        losses = []
        with span("bench.simclr.epoch"):
            for imgs, _labels, valid in self.batches:
                imgs_t = self.to_device(imgs, self.dev)
                valid_t = self.to_device(valid, self.dev).bool()
                self.state, loss = step(self.state, self.generator, imgs_t,
                                        valid_t)
                losses.append(loss)
            return float(sum(torch.stack(losses).cpu().numpy())) / len(losses)

    def window(self, seconds: float) -> dict:
        steps = len(self.batches)
        return training.epochs_window(self._epoch, seconds, {
            "steps": steps, "views": 2 * steps * self.cfg["batch_size"]})

    def end_to_end(self, work: dict) -> dict:
        return {"simclr_views_per_s": work["views"] / work["seconds"]}

    def launches(self) -> dict:
        return {}

    def release(self) -> None:
        self.state = None

    def check(self, variant: str = "program", limits="cell") -> dict:
        """The program's first steps against the reference's (``variant``
        ``control`` or ``half_batch``: the reference in lower precision, or
        with a fault, in the program's place)."""
        c = self.cfg
        batches = [u8 for u8, _ in training.first_batches(
            self.path, self.labels, self.seed, c["batch_size"], self.dev)]

        def run(**kw):
            g = torch.Generator(device=self.dev).manual_seed(self.seed + 17)
            return ref_train.simclr_steps(self.start, batches, g,
                                          c["learning_rate"],
                                          c["temperature"], c["image_size"],
                                          **kw)

        ref = run()
        other = (self.first if variant == "program"
                 else training.other_steps(variant, run))
        return training.readings(other, ref, self.start, self.t["limits"]
                                 if limits == "cell" else limits)
