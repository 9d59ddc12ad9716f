"""Plain float32 training steps of the two training cells, and the
comparison of a program's first steps with them.

- The patch classifier's step: the augmentation, ResNet18 in training mode,
  the class-weighted cross entropy ``Σ w_y ℓ / Σ w_y``, the backward, Adam.
- SimCLR's step: two views, two training-mode forwards of the encoder and
  the 512 → 512 → ReLU → 128 projection (Chen et al., arXiv:2002.05709),
  NT-Xent at temperature τ over the 2N views, the backward, Adam.

Adam (Kingma and Ba, arXiv:1412.6980) with β = (0.9, 0.999) and ε = 1e-8
outside the square root. The epoch's row order is a copy of the program's
(``np.random.default_rng(seed + epoch).shuffle``). Nothing here imports the
program under test.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from hipac_bench.reference import augment as aug
from hipac_bench.reference import resnet

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def batch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    order = np.arange(n)
    np.random.default_rng(seed + epoch).shuffle(order)
    return order


def class_weights_inv_min(labels: np.ndarray, classes: int = 2) -> np.ndarray:
    counts = np.maximum(np.bincount(labels, minlength=classes), 1)
    w = 1.0 / counts.astype(np.float64)
    return (w / w.min()).astype(np.float32)


def weighted_ce(logits, labels, weights) -> torch.Tensor:
    nll = F.cross_entropy(logits.float(), labels.long(), reduction="none")
    w = weights[labels.long()]
    return (w * nll).sum() / w.sum()


def nt_xent(z1: torch.Tensor, z2: torch.Tensor, tau: float) -> torch.Tensor:
    z = F.normalize(torch.cat([z1, z2]).float(), dim=1)
    n2 = z.shape[0]
    n = n2 // 2
    sim = (z @ z.T) / tau
    sim = sim.masked_fill(torch.eye(n2, dtype=torch.bool, device=z.device),
                          float("-inf"))
    pos = torch.cat([torch.arange(n, n2), torch.arange(0, n)]).to(z.device)
    return (torch.logsumexp(sim, dim=1)
            - sim[torch.arange(n2, device=z.device), pos]).mean()


class Adam:
    def __init__(self, params: dict, lr: float):
        self.p = params
        self.lr = lr
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.t += 1
        b1, b2 = BETAS
        for k, p in self.p.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            mhat = self.m[k] / (1 - b1 ** self.t)
            vhat = self.v[k] / (1 - b2 ** self.t)
            p.sub_(self.lr * mhat / (vhat.sqrt() + ADAM_EPS))


def _split(weights: dict, device) -> tuple[dict, dict]:
    """(trainable leaves as float32 copies requiring grad, the rest)."""
    train, rest = {}, {}
    for k, v in weights.items():
        v = v.detach().to(device=device, dtype=torch.float32).clone()
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            rest[k] = v
        else:
            train[k] = v.requires_grad_(True)
    return train, rest


class RunningStats:
    """BatchNorm's running statistics, moved after each training-mode
    forward toward the batch's mean and biased variance by ``momentum``
    (the rule of the flax models the program follows)."""

    def __init__(self, rest: dict, prefix: str = "", momentum: float = 0.1):
        self.stats = {k: v.clone() for k, v in rest.items()
                      if k.endswith(("running_mean", "running_var"))}
        self.prefix, self.m = prefix, momentum

    def update(self, batch: dict) -> None:
        for name, (mean, var) in batch.items():
            for key, value in ((f"{self.prefix}{name}.running_mean", mean),
                               (f"{self.prefix}{name}.running_var", var)):
                self.stats[key].mul_(1.0 - self.m).add_(value, alpha=self.m)


def _run(weights, device, lr, steps, loss_of, prefix: str = ""):
    """Adam over ``loss_of(step, params, running)``, which moves
    ``running`` (:class:`RunningStats`) with each forward's batch
    statistics; the losses, the first step's gradients, and the leaves and
    running statistics after the last step."""
    params, rest = _split(weights, device)
    running = RunningStats(rest, prefix)
    opt = Adam(params, lr)
    losses, grad1 = [], None
    for i in range(steps):
        full = dict(rest, **params)
        loss = loss_of(i, full, running)
        grads = torch.autograd.grad(loss, list(params.values()))
        grads = dict(zip(params.keys(), grads))
        if i == 0:
            grad1 = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(grads)
        losses.append(float(loss.detach()))
    after = {k: v.detach().clone() for k, v in params.items()}
    return {"losses": losses, "grad1": grad1, "after": after,
            "running": running.stats}


def classifier_steps(weights: dict, batches, class_weights, generator,
                     lr: float, quant=resnet.identity,
                     act=resnet.identity, half: bool = False):
    """The classifier's first ``len(batches)`` steps from ``weights``, each
    batch a (uint8 images, labels) pair on the device, the augmentation
    drawn from ``generator``. ``half`` leaves out the second half of every
    batch (a fault, for the check's own test)."""
    dev = batches[0][0].device
    cw = torch.as_tensor(class_weights, dtype=torch.float32, device=dev)

    def loss_of(i, p, running):
        u8, labels = batches[i]
        x = aug.augment(aug.draw_augment(generator, u8.shape[0]), u8)
        if half:
            x, labels = x[: len(x) // 2], labels[: len(labels) // 2]
        stats: dict = {}
        logits = resnet.forward(p, x, train=True, stats=stats, quant=quant,
                                act=act)
        running.update(stats)
        return weighted_ce(logits, labels, cw)

    with resnet.float32_exact():
        return _run(weights, dev, lr, len(batches), loss_of)


def simclr_forward(p: dict, x: torch.Tensor, quant=resnet.identity,
                   act=resnet.identity, running=None):
    trunk = {k[len("encoder."):]: v for k, v in p.items()
             if k.startswith("encoder.")}
    stats: dict = {}
    f = resnet.forward(trunk, x, train=True, stats=stats, quant=quant,
                       act=act)
    if running is not None:
        running.update(stats)
    h = act(F.relu(act(F.linear(f, quant(p["projector.0.weight"]),
                                    p["projector.0.bias"]))))
    return act(F.linear(h, quant(p["projector.2.weight"]),
                        p["projector.2.bias"]))


def simclr_steps(weights: dict, batches, generator, lr: float, tau: float,
                 out_size: int, quant=resnet.identity,
                 act=resnet.identity, half: bool = False):
    """SimCLR's first ``len(batches)`` steps from ``weights`` over uint8
    image batches on the device, the views drawn from ``generator``."""
    dev = batches[0].device

    def loss_of(i, p, running):
        u8 = batches[i]
        b, s = u8.shape[0], u8.shape[1]
        views = [aug.view(aug.draw_view(generator, b, s), u8, out_size)
                 for _ in range(2)]
        if half:
            views = [v[: b // 2] for v in views]
        z1 = simclr_forward(p, views[0], quant, act, running)
        z2 = simclr_forward(p, views[1], quant, act, running)
        return nt_xent(z1, z2, tau)

    with resnet.float32_exact():
        return _run(weights, dev, lr, len(batches), loss_of, "encoder.")


# ---------------------------------------------------------------------------
# Comparison
# ---------------------------------------------------------------------------


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def kept_leaves(ref_grad1: dict, share: float = 1e-3) -> list[str]:
    """Leaves whose first reference gradient is not nought to rounding:
    its norm at least ``share`` of the median leaf's."""
    norms = _norms(ref_grad1)
    med = float(np.median(list(norms.values())))
    return sorted(k for k, n in norms.items() if n >= share * med)


def leaf_gaps(prog: dict, ref: dict, keys: list[str]) -> dict:
    """|‖prog‖ − ‖ref‖| / max(‖ref‖, median ‖ref‖) of each of ``keys``."""
    return _scaled(prog, ref, ref, keys)


def _scaled(a: dict, b: dict, ref: dict, keys: list[str]) -> dict:
    """|‖a‖ − ‖b‖| / max(‖ref‖, median ‖ref‖) of each of ``keys``."""
    an, bn = _norms({k: a[k] for k in keys}), _norms({k: b[k] for k in keys})
    rn = _norms({k: ref[k] for k in keys})
    med = float(np.median(list(rn.values())))
    return {k: abs(an[k] - bn[k]) / max(rn[k], med) for k in keys}


def step_readings(prog: dict, ref: dict, start: dict) -> dict:
    """The numbers that a training cell can compare: the worst step's
    relative loss gap (``loss_gap``) and the first step's (``loss1_gap``);
    of the first gradient and of each leaf's change over the steps, the
    worst leaf's gap (``grad_gap``, ``update_gap``, with the leaf's name)
    and the median leaf's (``grad_gap_median``, ``update_gap_median``); the
    norm of the first gradients' difference by leaf (``grad_diff_gap``,
    ``grad_diff_gap_median``); and of BatchNorm's running statistics' move
    (``bn_gap``, ``bn_gap_median``). Each leaf's gap is over the larger of
    its reference norm and the median leaf's. ``prog`` and ``ref`` hold
    ``losses``, ``grad1``, ``after`` and ``running``; ``start`` the state
    before."""
    keys = kept_leaves(ref["grad1"])
    rel = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                               ref["losses"])]
    out = {"loss_gap": max(rel), "loss1_gap": rel[0], "leaves": len(keys)}
    d_prog = {k: prog["after"][k].double().cpu() - start[k].double().cpu()
              for k in keys}
    d_ref = {k: ref["after"][k].double().cpu() - start[k].double().cpu()
             for k in keys}
    diff = {k: prog["grad1"][k] - ref["grad1"][k] for k in keys}
    zero = {k: torch.zeros_like(v) for k, v in diff.items()}
    for name, gaps in (("grad", leaf_gaps(prog["grad1"], ref["grad1"], keys)),
                       ("update", leaf_gaps(d_prog, d_ref, keys)),
                       ("grad_diff", _scaled(diff, zero, ref["grad1"], keys))):
        worst = max(gaps, key=gaps.get)
        out[f"{name}_gap"] = gaps[worst]
        out[f"{name}_leaf"] = worst
        out[f"{name}_gap_median"] = float(np.median(list(gaps.values())))
    # BatchNorm's running statistics: each one's move over the steps
    run = sorted(ref["running"])
    moved = [{k: r["running"][k].double().cpu() - start[k].double().cpu()
              for k in run} for r in (prog, ref)]
    gaps = _scaled(moved[0], moved[1], moved[1], run)
    worst = max(gaps, key=gaps.get)
    out["bn_gap"], out["bn_leaf"] = gaps[worst], worst
    out["bn_gap_median"] = float(np.median(list(gaps.values())))
    return out
