"""The port's spans and counters (``utils/profiling.py``) and the benchmark's
readers of them, on the CPU.

- with no ``torch.profiler`` session a span or a count records nothing and
  opens no ``record_function``;
- under one, a ``BatchIterator`` epoch gives one ``hipac.data.gather`` span
  a batch with its bytes counted, each span on the profiler's timeline too;
- the modules that carry spans import no torch for them;
- ``trace`` (the CLI's ``--profile``) writes ``spans.json`` beside the
  Chrome trace: the profiler's count, total, mean and self time of each
  program span, then the counters;
- ``simclr_epoch`` leaves ``pretrain_simclr``'s weights as its loop gave
  them before the epoch was a function, bit for bit;
- the six span readers of ``hipac_bench`` on hand-made records, and a
  traced run of the SimCLR cell at a small size.
"""

import contextlib
import json
import subprocess
import sys
import threading
import types

import numpy as np
import pytest
import torch

from hipac_bench import catalog, run, training
from hipac_bench.tests import tiny
from ss25_hierarchical_multiscale_image_classification_tpu_torch import config
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data import (
    datasets,
    manifest,
    patch_store,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.models.simclr import (
    SimCLRModel,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel import (
    feed,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train import (
    simclr_trainer,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.train.state import (
    create_train_state,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.utils import (
    profiling,
)

torch.set_num_threads(2)
SIZE = 32


@pytest.fixture(autouse=True)
def _clean_registry():
    profiling.reset()
    yield
    profiling.reset()


def _profiler(cuda=False):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _dataset(root, n, size=SIZE):
    w = patch_store.PackedPatchWriter(str(root), 3, "s1", size)
    imgs = np.random.default_rng(5).integers(0, 256, (n, size, size, 3),
                                             dtype=np.uint8)
    recs = w.write_batch(imgs, np.zeros((n, 2), int), np.zeros(n, int))
    w.close()
    return datasets.PatchDataset(manifest.PatchManifest(recs), resize_to=size)


# ---------------------------------------------------------------------------
# off and on
# ---------------------------------------------------------------------------


def test_without_a_profiler_nothing_records_and_no_record_function_opens(
        tmp_path, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("record_function opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with profiling.annotate("a"):
        with profiling.annotate("b"):
            profiling.count("c", 3)
    for imgs, _labels, valid in datasets.BatchIterator(
            _dataset(tmp_path, 10), 4, seed=1):
        feed.to_device(imgs, torch.device("cpu"))
    assert profiling.records() == []
    assert profiling.counters() == {}


def test_a_profiled_epoch_records_one_gather_a_batch(tmp_path):
    ds = _dataset(tmp_path, 10)
    batches = datasets.BatchIterator(ds, 4, seed=1)
    with _profiler() as prof:
        with profiling.annotate("hipac.test.epoch"):
            n = sum(1 for _ in batches)
    spans = profiling.records()
    gathers = [s for s in spans if s.name == "hipac.data.gather"]
    outer = [s for s in spans if s.name == "hipac.test.epoch"]
    assert n == 3 and len(gathers) == 3 and len(outer) == 1
    assert all(outer[0].start_ns <= g.start_ns < g.end_ns <= outer[0].end_ns
               for g in gathers)
    # 10 rows in batches of 4: the last wrap-padded to 4 as well
    assert profiling.counters() == {"hipac.data.bytes": 12 * SIZE * SIZE * 3}
    names = [e.name for e in prof.events()]
    assert names.count("hipac.data.gather") == 3
    assert names.count("hipac.test.epoch") == 1
    # on the CPU nothing is pinned
    feed.to_device(np.zeros(4, np.float32), torch.device("cpu"))
    assert not any(s.name.startswith("hipac.feed") for s in
                   profiling.records())


def test_spans_record_on_the_profiled_thread_alone():
    """``torch.profiler`` profiles the thread that started it: a span or a
    count on another thread is on no timeline, and records nothing."""
    got = {}

    def work(tag, profile):
        with _profiler() if profile else contextlib.nullcontext():
            with profiling.annotate(f"outer.{tag}"):
                with profiling.annotate(f"inner.{tag}"):
                    profiling.count(f"n.{tag}")
        got[tag] = threading.get_ident()

    with _profiler():
        t = threading.Thread(target=work, args=("bystander", False))
        t.start()
        t.join(timeout=60)
        work("main", False)
    assert not t.is_alive()
    t = threading.Thread(target=work, args=("worker", True))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    spans = {s.name: s for s in profiling.records()}
    assert sorted(spans) == ["inner.main", "inner.worker", "outer.main",
                             "outer.worker"]
    assert profiling.counters() == {"n.main": 1, "n.worker": 1}
    for tag in ("main", "worker"):
        outer, inner = spans[f"outer.{tag}"], spans[f"inner.{tag}"]
        assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert got["main"] != got["worker"]


def test_the_span_carrying_modules_import_no_torch_for_their_spans():
    """``data/datasets.py`` and the kernel build module stay importable
    without torch; spans and counts there cost nothing before it loads."""
    pkg = "ss25_hierarchical_multiscale_image_classification_tpu_torch"
    code = (f"import sys\n"
            f"from {pkg}.utils import profiling\n"
            f"from {pkg}.data import datasets\n"
            f"from {pkg}.ops import build\n"
            f"with profiling.annotate('a'):\n"
            f"    profiling.count('b')\n"
            f"assert 'torch' not in sys.modules, 'torch loaded'\n"
            f"assert profiling.records() == [] and profiling.counters() == {{}}\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=False)
    assert res.returncode == 0, res.stderr


# ---------------------------------------------------------------------------
# spans.json
# ---------------------------------------------------------------------------


def test_span_table_keeps_the_program_spans_and_takes_children_out():
    with _profiler() as prof:
        for _ in range(2):
            with profiling.annotate("hipac.top"):
                with profiling.annotate("hipac.child"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
        with torch.profiler.record_function("other.span"):
            pass
    got = profiling.span_table(prof)
    assert sorted(got) == ["hipac.child", "hipac.top"]
    top, child = got["hipac.top"], got["hipac.child"]
    assert top["count"] == child["count"] == 2
    assert top["mean_ms"] == pytest.approx(top["total_ms"] / 2)
    assert 0 <= top["self_ms"] <= top["total_ms"] - child["total_ms"] + 1e-6
    assert child["self_ms"] < child["total_ms"]  # the matmul is inside


def test_trace_writes_the_spans_and_counters_then_resets(tmp_path,
                                                        monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.annotate("hipac.outer"):
            for _ in range(2):
                with profiling.annotate("hipac.inner"):
                    torch.ones(32, 32) @ torch.ones(32, 32)
        profiling.count("things", 5)
        spans = profiling.records()
    got = json.loads((tmp_path / "prof" / "spans.json").read_text())
    assert (tmp_path / "prof" / "trace.json").is_file()
    assert got["counters"] == {"things": 5}
    assert sorted(got["spans"]) == ["hipac.inner", "hipac.outer"]
    assert got["spans"]["hipac.inner"]["count"] == 2
    assert got["spans"]["hipac.outer"]["count"] == 1
    assert len(spans) == 3
    assert profiling.records() == [] and profiling.counters() == {}
    monkeypatch.setenv("RANK", "2")
    assert profiling.spans_path("d").endswith("spans_rank2.json")


# ---------------------------------------------------------------------------
# simclr_epoch
# ---------------------------------------------------------------------------


def test_simclr_epoch_gives_pretrain_simclr_the_weights_of_its_old_loop(
        tmp_path):
    ds = _dataset(tmp_path / "patches", 20)
    cfg = config.Config(simclr=config.SimCLRConfig(batch_size=8),
                        models_dir=str(tmp_path / "models"))
    got = simclr_trainer.pretrain_simclr(cfg, epochs=2, dataset=ds,
                                         input_size=SIZE, device="cpu")

    # the loop as pretrain_simclr ran it inline
    sc, dev = cfg.simclr, torch.device("cpu")
    model = SimCLRModel(projection_dim=sc.projection_dim,
                        projection_hidden_dim=sc.projection_hidden_dim,
                        generator=torch.Generator().manual_seed(sc.seed))
    state = create_train_state(model, sc.learning_rate, dev)
    step = simclr_trainer.make_simclr_train_step(sc.temperature, SIZE,
                                                 sc.loss_impl)
    batches = datasets.BatchIterator(ds, sc.batch_size, seed=sc.seed,
                                     rows=feed.process_batch_slice(
                                         sc.batch_size))
    generator = torch.Generator(device=dev).manual_seed(sc.seed + 17)
    for _epoch in range(2):
        for imgs, _labels, valid in batches:
            state, _loss = step(state, generator, feed.to_device(imgs, dev),
                                feed.to_device(valid, dev).bool())
    want = state.model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k].cpu()) for k in want)


def test_simclr_epoch_returns_the_mean_loss_and_records_the_step_spans(
        tmp_path):
    ds = _dataset(tmp_path, 12)
    model = SimCLRModel(generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, 1e-3, torch.device("cpu"))
    step = simclr_trainer.make_simclr_train_step(0.5, SIZE)
    seen = []

    def recording(state, generator, imgs, valid):
        state, loss = step(state, generator, imgs, valid)
        seen.append(float(loss))
        return state, loss

    batches = datasets.BatchIterator(ds, 4, seed=0)
    with _profiler():
        state, loss = simclr_trainer.simclr_epoch(
            state, recording, batches, torch.Generator().manual_seed(1),
            torch.device("cpu"))
    assert len(seen) == 3 and loss == pytest.approx(np.mean(seen))
    names = [s.name for s in profiling.records()]
    for name in ("hipac.simclr.views", "hipac.simclr.forward",
                 "hipac.simclr.loss", "hipac.simclr.backward",
                 "hipac.data.gather"):
        assert names.count(name) == 3, name
    assert names.count("hipac.simclr.optimizer") == 6  # zero_grad, step
    assert simclr_trainer.simclr_epoch(state, recording, [], None,
                                       torch.device("cpu"))[1] == 0.0


# ---------------------------------------------------------------------------
# the benchmark's readers
# ---------------------------------------------------------------------------

MS = 1_000_000  # ns
READERS = ("gather_ms.simclr", "pin_ms.simclr", "issue_ms.simclr",
           "backward_ms.simclr", "pin_gb_per_s.simclr",
           "gather_gb_per_s.simclr")


def _hand_made(steps=2, gathers=None, pins=True):
    spans, i = [], 0

    def add(name, ms):
        nonlocal i
        spans.append(profiling.Span(name, i * 100 * MS,
                                    i * 100 * MS + int(ms * MS)))
        i += 1

    for k in range(steps if gathers is None else gathers):
        add("hipac.data.gather", 3 + 2 * k)          # 3, 5: 4 ms a step
    for _ in range(steps):
        if pins:
            add("hipac.feed.pin", 12)
            add("hipac.feed.pin", 8)                  # 20 ms a step
        add("hipac.other", 1)                         # read by none
        add("hipac.simclr.views", 1)
        add("hipac.simclr.optimizer", 0.5)
        add("hipac.simclr.forward", 10)
        add("hipac.simclr.loss", 2)
        add("hipac.simclr.backward", 20)
        add("hipac.simclr.optimizer", 1.5)            # 15 ms a step
    counters = {"hipac.data.bytes": 40_000_000 * steps}
    if pins:
        counters["hipac.feed.pinned_bytes"] = 80_000_000 * steps
    return spans, counters


def _read(monkeypatch, spans, counters, steps=2):
    monkeypatch.setattr(profiling, "records", lambda: list(spans))
    monkeypatch.setattr(profiling, "counters", lambda: dict(counters))
    work = {"steps": steps, "views": 2 * 512 * steps}
    return {name: catalog.metric(name).read({}, work) for name in READERS}


def test_the_readers_on_hand_made_records(monkeypatch):
    got = _read(monkeypatch, *_hand_made())
    assert got["gather_ms.simclr"] == pytest.approx(4.0)
    assert got["pin_ms.simclr"] == pytest.approx(20.0)
    assert got["issue_ms.simclr"] == pytest.approx(15.0)
    assert got["backward_ms.simclr"] == pytest.approx(20.0)
    # 160 MB in 40 ms; 80 MB in 8 ms
    assert got["pin_gb_per_s.simclr"] == pytest.approx(4.0)
    assert got["gather_gb_per_s.simclr"] == pytest.approx(10.0)


@pytest.mark.parametrize("gathers", [0, 1, 3])
def test_the_readers_give_none_where_the_gathers_are_not_the_steps(
        monkeypatch, gathers):
    got = _read(monkeypatch, *_hand_made(gathers=gathers))
    assert got == dict.fromkeys(READERS)


def test_the_pin_readers_give_none_where_nothing_was_pinned(monkeypatch):
    got = _read(monkeypatch, *_hand_made(pins=False))
    assert got["pin_ms.simclr"] is None
    assert got["pin_gb_per_s.simclr"] is None
    assert got["gather_ms.simclr"] == pytest.approx(4.0)


def test_the_readers_give_none_on_a_program_without_spans(monkeypatch):
    monkeypatch.setattr(training, "port",
                        lambda module: types.SimpleNamespace())
    work = {"steps": 2, "views": 2048}
    assert all(catalog.metric(n).read({}, work) is None for n in READERS)


def test_a_traced_simclr_run_reports_the_span_metrics(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    # the suite's other files load JAX into this process; the run may add
    # none of the names the benchmark forbids
    loaded = set(run.forbidden_modules())
    forbidden = run.forbidden_modules
    monkeypatch.setattr(run, "forbidden_modules",
                        lambda: sorted(set(forbidden()) - loaded))
    out: dict = {}
    rc = run.main(["--workload", "simclr-pretrain", "--seed", str(tiny.SEED),
                   "--seconds", "0", "--trace", "1"],
                  overrides=tiny.SIMCLR, device="cpu", out=out)
    assert rc == 0 and out["correct"] is True
    metrics = out["metrics"]
    assert metrics["gather_ms.simclr"]["value"] > 0
    assert metrics["gather_ms.simclr"]["unit"] == "ms"
    assert metrics["issue_ms.simclr"]["value"] > 0
    assert metrics["backward_ms.simclr"]["value"] > 0
    assert metrics["gather_gb_per_s.simclr"]["unit"] == "GB/s"
    assert metrics["gather_gb_per_s.simclr"]["value"] > 0
    assert not any(name.startswith("pin_") for name in metrics)
    # the records are the window's: a gather a step, its bytes counted
    steps, batch = out["attempted"], tiny.SIMCLR["config"]["batch_size"]
    size = tiny.STORE["size"]
    assert profiling.counters() == {
        "hipac.data.bytes": steps * batch * size * size * 3}
    assert out["breakdown"]["idle_gaps"][0][0].startswith(
        "bench.simclr.epoch/hipac.")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: pinned copies exist only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_profiled_copy_to_the_card_is_pinned_and_counted(cuda_device):
    a = np.arange(3 * 1024, dtype=np.uint8).reshape(3, 1024)
    with _profiler(cuda=True):
        t = feed.to_device(a, cuda_device)
        torch.cuda.synchronize(cuda_device)
    assert torch.equal(t.cpu(), torch.from_numpy(a))
    names = [s.name for s in profiling.records()]
    assert names == ["hipac.feed.pin"]
    assert profiling.counters() == {"hipac.feed.pinned_bytes": a.nbytes}
