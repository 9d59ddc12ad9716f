"""Patch-classifier training, as ``--train`` runs it on one card:
``train/trainer.py::Trainer.train_epoch`` epoch after epoch over a packed
store of labelled patches (shuffled, ``Prefetcher`` depth 2), each step the
``augment`` kernel, the bf16 ResNet18 forward, the class-weighted cross
entropy, the backward and fused Adam.

The model holds the benchmark's weights from the seed; the Trainer gets
``--train``'s other settings (Adam at the configuration's rate, class
weights ``(1/count)/min``, the seed for the order and the draws). Set-up
runs the first epoch through the same Trainer, and keeps its first steps'
losses, first gradient and parameters for the check; the window continues
with the same object.

Check (after the window): the plain float32 reference follows those first
steps from the same weights, rows and draws; the numbers that
``traffic["limits"]`` names are compared (the worst leaf's first-gradient
norm and the worst leaf's change over the steps; ``reference/train.py::
step_readings`` computes them and the others that ``hipac_bench.control``
records).
"""

from __future__ import annotations

import time

import torch

from hipac_bench import inputs, training, weights
from hipac_bench.reference import train as ref_train


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device, workdir: str):
        self.cfg, self.t, self.seed, self.dev = cfg, traffic, seed, device

    def setup(self, pieces: dict) -> None:
        t = time.perf_counter()
        trainer_mod = training.port("train.trainer")
        resnet = training.port("models.resnet")
        self.augment = training.port("ops.augment").augment_batch_kernel
        if self.dev.type == "cuda":
            training.port("ops.build").load_library()
        pieces["kernels"] = time.perf_counter() - t

        t = time.perf_counter()
        ds, self.path, self.labels = training.dataset(self.t["store"],
                                                      self.dev)
        pieces["inputs"] = time.perf_counter() - t

        t = time.perf_counter()
        g = torch.Generator(device=self.dev).manual_seed(
            inputs.sub_seed(self.seed, 2))
        self.start = weights.resnet18(g, self.dev, num_classes=2)
        model = resnet.ResNet18Classifier(num_classes=2)
        model.load_state_dict(self.start)
        losses = training.port("train.losses")
        self.trainer = trainer_mod.Trainer(
            model, ds, None, batch_size=self.cfg["batch_size"],
            learning_rate=self.cfg["learning_rate"],
            class_weights=losses.class_weights_inv_min(self.labels, 2),
            seed=self.seed, device=self.dev)
        pieces["weights"] = time.perf_counter() - t

        t = time.perf_counter()
        step = self.trainer.train_step
        rec = training.FirstSteps(
            step, lambda m: m["loss"],
            self.trainer.state.model)
        self.trainer.train_step = rec
        self.trainer.train_epoch(0)
        self.trainer.train_step = step
        self.first = rec.result()
        self.epoch = 1
        self.augment.launches = 0
        pieces["warmup"] = time.perf_counter() - t

    def _epoch(self) -> None:
        from hipac_bench.trace import span

        with span("bench.train.epoch"):
            self.trainer.train_epoch(self.epoch)
        self.epoch += 1

    def window(self, seconds: float) -> dict:
        steps = len(self.trainer.batch_iter)
        return training.epochs_window(self._epoch, seconds, {
            "steps": steps, "patches": steps * self.cfg["batch_size"]})

    def end_to_end(self, work: dict) -> dict:
        return {"train_patches_per_s": work["patches"] / work["seconds"]}

    def launches(self) -> dict:
        return {"augment": self.augment.launches}

    def release(self) -> None:
        self.trainer = None

    def check(self, variant: str = "program", limits="cell") -> dict:
        """The program's first steps against the reference's (``variant``
        ``control`` or ``half_batch``: the reference in lower precision, or
        with a fault, in the program's place)."""
        batches = training.first_batches(self.path, self.labels, self.seed,
                                         self.cfg["batch_size"], self.dev)
        weights = ref_train.class_weights_inv_min(self.labels)

        def run(**kw):
            g = torch.Generator(device=self.dev).manual_seed(self.seed + 1)
            return ref_train.classifier_steps(self.start, batches, weights, g,
                                              self.cfg["learning_rate"], **kw)

        ref = run()
        other = (self.first if variant == "program"
                 else training.other_steps(variant, run))
        return training.readings(other, ref, self.start, self.t["limits"]
                                 if limits == "cell" else limits)
