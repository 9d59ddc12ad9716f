"""Worker processes of the port's data-parallel tests (gloo on the CPU).

Not a test module: ``run_world`` spawns ``world`` processes that each join a
gloo process group through the port's ``parallel/mesh.py::init_from_env``
and run one of the functions below on their rank's rows; each writes its
results with ``torch.save`` to ``<out>/rank<r>.pt``. The workers import
torch and the port only (no jax), so they start in a few seconds.
"""

from __future__ import annotations

import os
import socket

import numpy as np
import torch

PKG = "ss25_hierarchical_multiscale_image_classification_tpu_torch"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank: int, fn, world: int, port: int, out: str, args) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    import torch.distributed as dist

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.mesh import (
        init_from_env,
    )

    group = init_from_env("cpu")
    try:
        result = fn(rank, world, group, *args)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_world(fn, world: int, out: str, *args) -> list:
    """Run ``fn(rank, world, group, *args)`` in ``world`` spawned gloo
    processes; the list of their results, by rank."""
    import torch.multiprocessing as mp

    os.makedirs(out, exist_ok=True)
    mp.start_processes(_entry, args=(fn, world, _free_port(), out, args),
                       nprocs=world, join=True, start_method="spawn")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def rows(x, rank: int, world: int):
    """Rank ``rank``'s contiguous rows of ``x``."""
    n = len(x) // world
    return x[rank * n:(rank + 1) * n]


# ---------------------------------------------------------------------------
# inputs shared by the workers and the tests
# ---------------------------------------------------------------------------

def collective_inputs(seed: int = 0) -> dict:
    """Numpy inputs of the collectives' cases, global shapes."""
    rng = np.random.default_rng(seed)
    n = 8
    return {
        "x": rng.normal(size=(n, 5)).astype(np.float32),
        "coef": rng.normal(size=(n, 5)).astype(np.float32),
        "bn_x": rng.normal(1.0, 2.0, size=(n, 6, 3, 3)).astype(np.float32),
        "bn_coef": rng.normal(size=(n, 6, 3, 3)).astype(np.float32),
        "z_i": rng.normal(size=(n, 16)).astype(np.float32),
        "z_j": rng.normal(size=(n, 16)).astype(np.float32),
        # the wrap-padded final batch: its last two rows are padding
        "valid": np.array([True] * 6 + [False] * 2),
        "h": rng.normal(size=(64, 32)).astype(np.float32),
        "mask": rng.random(64) > 0.25,
        "v": rng.normal(size=(32, 16)).astype(np.float32),
        "vb": rng.normal(size=(16,)).astype(np.float32),
        "w": rng.normal(size=(16,)).astype(np.float32),
    }


TAU = 0.5


def bn_case(x: torch.Tensor, coef: torch.Tensor, group):
    """A training-mode BatchNorm2d(6) forward on ``x`` (momentum 0.1 from
    seeded statistics), the loss Σ y·coef backward: (y, dx, dweight,
    dbias, running mean, running var)."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
        BatchNorm2d,
    )

    bn = BatchNorm2d(6, eps=1e-5).train()
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, 6))
        bn.bias.copy_(torch.linspace(-0.2, 0.3, 6))
        bn.running_mean.copy_(torch.linspace(-1.0, 1.0, 6))
        bn.running_var.copy_(torch.linspace(0.5, 2.0, 6))
    bn.group = group
    x = x.clone().requires_grad_(True)
    y = bn(x)
    (y * coef).sum().backward()
    return (y.detach(), x.grad, bn.weight.grad, bn.bias.grad,
            bn.running_mean.clone(), bn.running_var.clone())


def ntxent_case(z_i, z_j, valid, group, kernel_route: bool):
    """NT-Xent of this rank's rows (the dense loss, or the kernel route's
    full-matrix reduction, whose CPU tensors take its plain version): the
    loss and the rows' gradients."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.simclr import (
        nt_xent_loss,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.ops.nt_xent import (
        nt_xent_loss_kernel,
    )

    z_i = z_i.clone().requires_grad_(True)
    z_j = z_j.clone().requires_grad_(True)
    fn = nt_xent_loss_kernel if kernel_route else nt_xent_loss
    loss = fn(z_i, z_j, TAU, valid=valid, group=group)
    loss.backward()
    return loss.detach(), z_i.grad, z_j.grad


def collectives_worker(rank: int, world: int, group, seed: int) -> dict:
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.mil import (
        sharded_attention_pool,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.collectives import (
        all_reduce_sum,
        gather_rows,
    )

    d = {k: torch.from_numpy(v) for k, v in collective_inputs(seed).items()}
    x = rows(d["x"], rank, world).clone().requires_grad_(True)
    gathered = gather_rows(x, group)
    # rank r's loss is (r + 1)·Σ gathered·coef: the gradient of x must sum
    # every rank's, W(W+1)/2 · coef on its rows
    ((rank + 1) * (gathered * d["coef"]).sum()).backward()
    out = {"gathered": gathered.detach(), "gather_grad": x.grad}
    y, dx, dw, db, rm, rv = bn_case(rows(d["bn_x"], rank, world),
                                    rows(d["bn_coef"], rank, world), group)
    out["bn"] = (y, dx, all_reduce_sum(dw, group), all_reduce_sum(db, group),
                 rm, rv)
    for route in (False, True):
        out[f"ntxent_{route}"] = ntxent_case(
            rows(d["z_i"], rank, world), rows(d["z_j"], rank, world),
            rows(d["valid"], rank, world), group, route)
    out["pool"] = sharded_attention_pool(
        rows(d["h"], rank, world), rows(d["mask"], rank, world), d["v"],
        d["w"], v_bias=d["vb"], group=group)
    return out


# ---------------------------------------------------------------------------
# the train steps
# ---------------------------------------------------------------------------

SIZE = 32  # layer4 is 1×1: its BN reduces over the global batch only
WIDTH = 8
BATCH = 8  # global, of which the last two rows are wrap padding


def step_inputs(seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "imgs": rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8),
        "labels": np.array([0, 1, 1, 0, 1, 0, 1, 1], np.int64),
        "valid": np.array([1] * 6 + [0] * 2, np.float32),
    }


def classifier_state(sd: dict, group=None):
    """A width-8 ResNet18 classifier from ``sd`` with its Adam state."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
        ResNet,
        set_process_group,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.state import (
        create_train_state,
    )

    model = ResNet((2, 2, 2, 2), 2, WIDTH)
    model.load_state_dict(sd, strict=False)
    set_process_group(model, group)
    return create_train_state(model, 1e-3, torch.device("cpu"))


def classifier_step(sd: dict, cw, group=None, rank: int = 0, world: int = 1,
                    steps: int = 2, seed: int = 3) -> dict:
    """``steps`` classifier train steps on this rank's rows of the global
    batch; the metrics of each step, the first step's gradients and
    running statistics, the final state dict."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.trainer import (
        make_train_step,
    )

    d = step_inputs(seed)
    state = classifier_state(sd, group)
    step = make_train_step(cw, group=group)
    gen = torch.Generator().manual_seed(11)
    metrics, grads, stats = [], None, None
    for _ in range(steps):
        state, m = step(state, gen, torch.from_numpy(rows(d["imgs"], rank, world)),
                        torch.from_numpy(rows(d["labels"], rank, world)),
                        torch.from_numpy(rows(d["valid"], rank, world)))
        metrics.append({k: float(v) for k, v in m.items()})
        if grads is None:  # the first step's, summed over the ranks
            grads = {k: p.grad.clone()
                     for k, p in state.model.named_parameters()}
            stats = {k: v.clone() for k, v in state.model.named_buffers()
                     if "running" in k}
    return {"metrics": metrics, "grads": grads, "stats": stats,
            "sd": {k: v.clone() for k, v in state.model.state_dict().items()}}


def classifier_worker(rank: int, world: int, group, sd: dict, cw,
                      out: str) -> dict:
    """Two classifier steps, then ``Trainer.fit`` writing under ``out``."""
    return {"step": classifier_step(sd, cw, group, rank, world),
            "fit": trainer_fit(rank, world, group, sd, cw, out)}


def simclr_step(sd: dict, loss_impl: str, group=None, rank: int = 0,
                world: int = 1, seed: int = 4) -> dict:
    """One SimCLR train step on this rank's rows: the loss, the gradients,
    the state dict after it."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
        set_process_group,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.simclr import (
        SimCLRModel,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.simclr_trainer import (
        make_simclr_train_step,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.state import (
        create_train_state,
    )

    d = step_inputs(seed)
    model = SimCLRModel()
    model.load_state_dict(sd, strict=False)
    set_process_group(model, group)
    state = create_train_state(model, 1e-3, torch.device("cpu"))
    step = make_simclr_train_step(TAU, SIZE, loss_impl, group)
    gen = torch.Generator().manual_seed(12)
    state, loss = step(state, gen, torch.from_numpy(rows(d["imgs"], rank, world)),
                       torch.from_numpy(rows(d["valid"], rank, world)).bool())
    return {"loss": float(loss),
            "grads": {k: p.grad.clone()
                      for k, p in state.model.named_parameters()},
            "stats": {k: v.clone() for k, v in state.model.named_buffers()
                      if "running" in k},
            "sd": {k: v.clone() for k, v in state.model.state_dict().items()}}


def simclr_worker(rank: int, world: int, group, sd: dict) -> dict:
    """The SimCLR step with the dense loss and with the kernel route."""
    return {impl: simclr_step(sd, impl, group, rank, world)
            for impl in ("xla", "pallas")}


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

class ArrayDataset:
    """An in-memory stand-in for ``PatchDataset`` (what ``BatchIterator``
    reads)."""

    resize_to = SIZE

    def __init__(self, imgs: np.ndarray, labels: np.ndarray):
        self.imgs, self.labels = imgs, labels

    def __len__(self) -> int:
        return len(self.imgs)

    def read_batch(self, idx):
        return self.imgs[idx], self.labels[idx]


def trainer_fit(rank: int, world: int, group, sd: dict, cw, out: str) -> dict:
    """``Trainer.fit`` for one epoch of 10 images at batch 8 (the second
    batch wrap-padded) with checkpoints and history under ``out``."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
        ResNet,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.trainer import (
        Trainer,
    )

    rng = np.random.default_rng(9)
    ds = ArrayDataset(rng.integers(0, 256, (10, SIZE, SIZE, 3), dtype=np.uint8),
                      np.array([0, 1] * 5, np.int64))
    model = ResNet((2, 2, 2, 2), 2, WIDTH)
    model.load_state_dict(sd, strict=False)
    trainer = Trainer(model, ds, ds, batch_size=BATCH, learning_rate=1e-3,
                      class_weights=cw, seed=0, device="cpu", group=group)
    history = trainer.fit(1, checkpoint_every=1,
                          checkpoint_prefix=os.path.join(out, "clf"),
                          history_path=os.path.join(out, "history.json"))
    return {"history": [{k: v for k, v in h.items() if k != "seconds"}
                        for h in history],
            "sd": trainer.variables()}


def cli_worker(rank: int, world: int, group, argv: list) -> dict:
    """The port's CLI ``main`` as one rank (the process group that
    ``torchrun`` would describe is already joined)."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.cli import (
        main as cli,
    )

    return {"rc": cli.main(argv)}


# ---------------------------------------------------------------------------
# the data-parallel paths of multiscale training, QAT, the streamed trainer
# and feature extraction
# ---------------------------------------------------------------------------

MS_LEVELS = (2, 3)
MS_LR = 1e-4


def ms_inputs(seed: int = 5) -> dict:
    """A global batch of 8 cells at levels (2, 3), 32² each, whose last two
    rows are wrap padding."""
    rng = np.random.default_rng(seed)
    return {
        "imgs": {lvl: rng.integers(0, 256, (BATCH, SIZE, SIZE, 3),
                                   dtype=np.uint8) for lvl in MS_LEVELS},
        "labels": np.array([1, 0, 1, 1, 0, 0, 1, 0], np.int64),
        "valid": np.array([1] * 6 + [0] * 2, np.float32),
    }


def ms_step(sd: dict, cw, group=None, rank: int = 0, world: int = 1,
            steps: int = 2, seed: int = 5) -> dict:
    """``steps`` multiscale train steps on this rank's rows of the global
    batch: each step's metrics, the first step's gradients and running
    statistics, the final state dict and Adam's state."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.convert import (
        hierarchical_from_state_dict,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
        set_process_group,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.multiscale_trainer import (
        make_multiscale_train_step,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.state import (
        create_train_state,
    )

    d = ms_inputs(seed)
    model = hierarchical_from_state_dict(sd)
    set_process_group(model, group)
    state = create_train_state(model, MS_LR, torch.device("cpu"))
    step = make_multiscale_train_step(cw, 0.5, group)
    gen = torch.Generator().manual_seed(13)
    imgs = {lvl: torch.from_numpy(rows(x, rank, world))
            for lvl, x in d["imgs"].items()}
    metrics, grads, stats = [], None, None
    for _ in range(steps):
        state, m = step(state, gen, imgs,
                        torch.from_numpy(rows(d["labels"], rank, world)),
                        torch.from_numpy(rows(d["valid"], rank, world)))
        metrics.append({k: float(v) for k, v in m.items()})
        if grads is None:
            grads = {k: p.grad.clone()
                     for k, p in state.model.named_parameters()}
            stats = {k: v.clone() for k, v in state.model.named_buffers()
                     if "running" in k}
    adam = [v.clone() for s in state.optimizer.state.values()
            for v in s.values() if isinstance(v, torch.Tensor)]
    return {"metrics": metrics, "grads": grads, "stats": stats,
            "sd": {k: v.clone() for k, v in state.model.state_dict().items()},
            "adam": adam}


def ms_worker(rank: int, world: int, group, sd: dict, cw, cfg, ds_kw: dict
              ) -> dict:
    """Two multiscale steps, then ``train_multiscale_classifier`` on the
    store of ``cfg`` (rank 0 writes the artifact)."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.multiscale import (
        MultiscaleDataset,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.multiscale_trainer import (
        train_multiscale_classifier,
    )

    ds = MultiscaleDataset.from_patches_dir(cfg.data.patches_dir, **ds_kw)
    out = train_multiscale_classifier(cfg, dataset=ds, epochs=2,
                                      device="cpu", group=group)
    return {"step": ms_step(sd, cw, group, rank, world),
            "fit": {"history": out["history"],
                    "calibration": out["calibration"],
                    "variables": out["variables"]}}


def qat_run(cfg, sd: dict, group=None) -> dict:
    """``qat_finetune`` for two epochs at 32² on ``cfg``'s level-3 store
    (rank 0 writes the artifact)."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.qat import (
        qat_finetune,
    )

    out = qat_finetune(cfg, variables=sd, level=3, epochs=2, batch_size=BATCH,
                       learning_rate=1e-3, input_size=SIZE,
                       n_calib_batches=1, device="cpu", group=group)
    return {"history": out["history"], "folded": out["folded"],
            "ascales": out["ascales"], "tree": out["quantized"].tree(),
            "artifact_path": out["artifact_path"]}


def qat_worker(rank: int, world: int, group, cfg, sd: dict) -> dict:
    return qat_run(cfg, sd, group)


def narrow_classifier(cfg):
    """The streamed trainer's model at 16 filters (for time on the CPU)."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.resnet import (
        ResNet18Classifier,
    )

    return ResNet18Classifier(
        num_classes=cfg.model.num_classes, num_filters=16,
        generator=torch.Generator().manual_seed(cfg.train.seed),
        frozen_bn=cfg.train.freeze_bn)


def streaming_run(cfg, epochs: int, group=None) -> dict:
    """``train_resnet_classifier_streaming`` at level 3, stride 28, with the
    16-filter trunk, and without pyarrow, as on the card's machine: the
    store's manifest is ``manifest.npz`` (reading back a parquet manifest
    that the producer thread wrote crashes in this build's pyarrow)."""
    import sys

    from ss25_hierarchical_multiscale_image_classification_tpu_torch.train import (
        streaming,
        trainer,
    )

    kept = streaming._classifier, trainer._classifier
    blocked = {m: sys.modules.get(m) for m in ("pyarrow", "pyarrow.parquet")}
    streaming._classifier = trainer._classifier = narrow_classifier
    sys.modules.update(dict.fromkeys(blocked))
    try:
        out = streaming.train_resnet_classifier_streaming(
            cfg, level=3, epochs=epochs, stride=28, device="cpu", group=group)
    finally:
        streaming._classifier, trainer._classifier = kept
        for m, mod in blocked.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod
    return {"streamed_epoch": out["streamed_epoch"],
            "history": [{k: v for k, v in h.items() if k != "seconds"}
                        for h in out["history"]],
            "variables": out["variables"]}


def streaming_worker(rank: int, world: int, group, cfg, epochs: int) -> dict:
    return streaming_run(cfg, epochs, group)


def features_run(recs, sd: dict, int8: bool, qtree=None, group=None,
                 stem_s2d: bool = False) -> dict:
    """``run_feature_extraction`` over the records at 32², batch 8."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.datasets import (
        PatchDataset,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.manifest import (
        PatchManifest,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.features import (
        run_feature_extraction,
    )

    ds = PatchDataset(PatchManifest(recs), resize_to=SIZE)
    feats, labels, names = run_feature_extraction(
        ds, sd, batch_size=BATCH, feature_dim=64, device="cpu", int8=int8,
        qtree=qtree, group=group, stem_s2d=stem_s2d)
    return {"feats": np.array(feats), "labels": labels, "names": names}


def features_worker(rank: int, world: int, group, recs, sd: dict,
                    qtree) -> dict:
    """The float32 (both stems), lazily calibrated int8 and artifact int8
    extractions, and the lazily calibrated int8 tree this rank holds."""
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.infer.features import (
        lazy_qtree,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.datasets import (
        PatchDataset,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch.data.manifest import (
        PatchManifest,
    )

    ds = PatchDataset(PatchManifest(recs), resize_to=SIZE)
    tree = lazy_qtree(sd, ds, BATCH, "cpu", group)
    return {"float": features_run(recs, sd, False, group=group),
            "float_s2d": features_run(recs, sd, False, group=group,
                                      stem_s2d=True),
            "int8": features_run(recs, sd, True, group=group),
            "int8_tree": features_run(recs, sd, True, qtree, group=group),
            "tree": {k: v for k, v in tree.items() if k != "plan"}}
