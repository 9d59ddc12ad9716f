"""The port's downloads (``io/download.py``: ``--download``, ``--remote``,
``--balance_dataset``) against the JAX package's, over loopback.

A ``ThreadingHTTPServer`` on 127.0.0.1 serves files that the test writes
and records every path it is asked for; ``CAMELYON16_BASE_URL`` of both
packages' ``io/download`` modules points at it, so nothing leaves the
machine. The JAX package downloads through ``requests`` and ``tqdm``, the
port through ``urllib.request``. Checked: the same file trees, byte for
byte, and the same requested paths; a second run requests nothing; a 404
and a connection dropped mid-body leave no file and return False in both;
``--balance_dataset`` over tumor_036 … tumor_038 (one served TIFF, two
404s) writes the JAX package's packed store and manifest; and the CLI runs
``--download`` where the JAX CLI does, before ``--move_files``, and
``--balance_dataset`` after ``--evaluate``.
"""

import http.server
import importlib
import os
import shutil
import threading

import pytest

from ss25_hierarchical_multiscale_image_classification_tpu.config import (
    DataConfig as JDataConfig,
)
from ss25_hierarchical_multiscale_image_classification_tpu.io import (
    download as jdownload,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.cli import (
    main as cli,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.config import (
    SUBSET_LIMITS,
    DataConfig,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.data import (
    manifest,
)
from ss25_hierarchical_multiscale_image_classification_tpu_torch.io import (
    download,
    synthetic,
)

from torch_port_native import load_jax_native_lib

#: a path whose response promises this many bytes and sends fewer
DROPPED = "CAMELYON16/training/normal/normal_001.tif"
DROP_SIZE, DROP_SENT = 4096, 1000


@pytest.fixture(autouse=True, scope="session")
def _jax_native_lib():
    """The JAX TIFF code's library, built or loaded under the workers' lock
    before any test here reaches it (``tests/torch_port_native.py``)."""
    load_jax_native_lib()


class _Server:
    """Serves ``files`` (path → bytes) with 404 for the rest, a dropped
    body for ``drop``; ``requests`` lists the paths asked for."""

    def __init__(self):
        self.files, self.requests, self.drop = {}, [], set()
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                path = self.path.lstrip("/")
                server.requests.append(path)
                if path in server.drop:
                    self.send_response(200)
                    self.send_header("Content-Length", str(DROP_SIZE))
                    self.end_headers()
                    self.wfile.write(b"x" * DROP_SENT)
                    self.wfile.flush()
                    self.close_connection = True
                    return
                body = server.files.get(path)
                if body is None:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture
def server(monkeypatch):
    for var in ("http_proxy", "HTTP_PROXY", "https_proxy", "HTTPS_PROXY",
                "all_proxy", "ALL_PROXY"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("NO_PROXY", "127.0.0.1,localhost")
    srv = _Server()
    for mod in (download, jdownload):
        monkeypatch.setattr(mod, "CAMELYON16_BASE_URL", srv.url)
    yield srv
    srv.close()


def _serve_everything(srv):
    for paths in download.CAMELYON16_FILES.values():
        for p in paths:
            srv.files[p] = f"bytes of {p}".encode()


def _tree(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _both(srv, tmp_path, act):
    """``act(module, data_config)`` with the port's and with JAX's module,
    each in its own root: ``{package: (tree, requested paths)}``."""
    out = {}
    for name, mod, cfg in (("port", download, DataConfig),
                           ("jax", jdownload, JDataConfig)):
        root = str(tmp_path / name)
        srv.requests.clear()
        act(mod, cfg(data_dir=root))
        out[name] = (_tree(root), sorted(srv.requests))
    return out


def test_the_copied_constants_equal_jax():
    from ss25_hierarchical_multiscale_image_classification_tpu import (
        config as jconfig,
    )
    from ss25_hierarchical_multiscale_image_classification_tpu_torch import (
        config,
    )

    assert download.CAMELYON16_FILES == jdownload.CAMELYON16_FILES
    assert config.CAMELYON16_BASE_URL == jconfig.CAMELYON16_BASE_URL
    assert config.SUBSET_LIMITS == jconfig.SUBSET_LIMITS


@pytest.mark.parametrize("remote", [False, True], ids=["subset", "remote"])
def test_download_dataset_equals_jax(server, tmp_path, remote):
    _serve_everything(server)
    got = _both(server, tmp_path,
                lambda mod, data: mod.download_dataset(data, remote=remote))
    assert got["port"] == got["jax"]
    tree, requested = got["port"]
    n_images = (sum(SUBSET_LIMITS.values()) if remote else 3)
    assert len(requested) == len(tree) == n_images + 2
    assert tree[os.path.join("train", "img", "tumor_001.tif")] == (
        b"bytes of CAMELYON16/training/tumor/tumor_001.tif")
    assert os.path.join("test", "mask", "lesion_annotations.zip") in tree
    if remote:
        assert os.path.join("train", "img", "tumor_110.tif") in tree
        assert os.path.join("train", "img", "tumor_111.tif") not in tree


def test_a_second_download_requests_nothing(server, tmp_path):
    _serve_everything(server)

    def twice(mod, data):
        mod.download_dataset(data)
        server.requests.clear()
        mod.download_dataset(data)

    got = _both(server, tmp_path, twice)
    assert got["port"] == got["jax"]
    assert got["port"][1] == [] and len(got["port"][0]) == 5


@pytest.mark.parametrize("failure", ["not_found", "dropped"])
def test_a_failed_file_leaves_nothing_in_both(server, tmp_path, failure):
    if failure == "dropped":
        server.drop.add(DROPPED)
    for name, mod in (("port", download), ("jax", jdownload)):
        dest = tmp_path / name / "normal_001.tif"
        assert mod.download_file(server.url + DROPPED, str(dest)) is False
        assert not dest.exists()
        assert dest.parent.is_dir()  # made before the request, as in JAX
    assert server.requests == [DROPPED, DROPPED]


def test_download_dataset_skips_what_fails_in_both(server, tmp_path):
    """Only the tumor slide and the training zip are served; the normal
    slide's body drops; the rest are 404s: both trees hold the two files."""
    server.files.update({
        "CAMELYON16/training/tumor/tumor_001.tif": b"tumor",
        "CAMELYON16/training/lesion_annotations.zip": b"zip"})
    server.drop.add(DROPPED)
    got = _both(server, tmp_path, lambda mod, data: mod.download_dataset(data))
    assert got["port"] == got["jax"]
    assert sorted(got["port"][0]) == [
        os.path.join("train", "img", "tumor_001.tif"),
        os.path.join("train", "mask", "lesion_annotations.zip")]
    assert len(got["port"][1]) == 5


def test_stage_gates_equal_jax(tmp_path):
    for root in (tmp_path / "p", tmp_path / "j"):
        os.makedirs(root / "features")
    (tmp_path / "p" / "features" / "patch_features_3.npy").write_bytes(b"")
    (tmp_path / "j" / "features" / "patch_features_3.npy").write_bytes(b"")
    data, jdata = (DataConfig(data_dir=str(tmp_path / "p")),
                   JDataConfig(data_dir=str(tmp_path / "j")))
    for level in (2, 3):
        assert (download.features_extracted(data, level)
                == jdownload.features_extracted(jdata, level) == (level == 3))
        assert (download.patches_extracted(data, level)
                == jdownload.patches_extracted(jdata, level) is False)


# ---------------------------------------------------------------------------
# --balance_dataset
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tumor_tiff(tmp_path_factory):
    """A synthetic tumor slide as a tiled TIFF (3584 × 2688: a 2 × 2 grid of
    224² cells at level 3) and its annotation XML."""
    root = str(tmp_path_factory.mktemp("balance_src"))
    path = synthetic.write_synthetic_case(
        root, "tumor_036",
        synthetic.tumor_spec(width=3584, height=2688,
                             tissue_radii=(0.45, 0.45), seed=36),
        container="tiff")
    return path, os.path.join(root, "annotations", "tumor_036.xml")


def _rows(recs):
    return [(r.slide, r.level, r.x, r.y, r.label, r.store, r.row) for r in recs]


def test_balance_dataset_equals_jax(server, tmp_path, tumor_tiff):
    tif, xml = tumor_tiff
    server.files["CAMELYON16/training/tumor/tumor_036.tif"] = open(
        tif, "rb").read()

    def balance(mod, data):
        os.makedirs(data.annotations_dir)
        shutil.copy(xml, data.annotations_dir)
        mod.download_all_tumor_extract_patches(data, start=36, end=38)

    got = _both(server, tmp_path, balance)
    assert got["port"][1] == got["jax"][1] == [
        f"CAMELYON16/training/tumor/tumor_{i:03d}.tif" for i in (36, 37, 38)]
    # the same slide, annotation, packed store and manifest rows
    ptree, jtree = got["port"][0], got["jax"][0]
    assert ptree.keys() == jtree.keys()
    store = [k for k in ptree if k.startswith("patches") and "manifest" not in k]
    assert store and all(ptree[k] == jtree[k] for k in store)
    prows = _rows(manifest.load_level_manifest(
        str(tmp_path / "port" / "patches"), 3))
    from ss25_hierarchical_multiscale_image_classification_tpu.data.manifest import (
        load_or_scan_manifest,
    )

    jrows = _rows(load_or_scan_manifest(str(tmp_path / "jax" / "patches"), 3))
    assert prows == jrows and prows
    assert {r[4] for r in prows} == {1}  # tumor patches only


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def test_cli_runs_the_download_actions_in_the_jax_order(server, tmp_path,
                                                        monkeypatch):
    """``--download`` runs after the tools that return early and before
    ``--move_files``; ``--balance_dataset`` after ``--evaluate``; both
    with the CLI's data root, and ``--remote`` passed through. Neither
    resolves ``--device``."""
    jcli = importlib.import_module(
        "ss25_hierarchical_multiscale_image_classification_tpu.cli.main")
    order = {"port": [], "jax": []}
    # the JAX CLI imports them from its io/download inside main()
    for name, mod in (("port", cli), ("jax", jdownload)):
        calls = order[name]
        monkeypatch.setattr(mod, "download_dataset", lambda data, remote=False,
                            calls=calls: calls.append(("download", remote)))
        monkeypatch.setattr(
            mod, "download_all_tumor_extract_patches",
            lambda data, calls=calls: calls.append(("balance",
                                                    data.data_dir)))
    monkeypatch.setattr(cli, "move_files_up",
                        lambda d: order["port"].append(("move", None)))
    monkeypatch.setattr(cli, "evaluate_resnet_classifier",
                        lambda cfg, **kw: order["port"].append(("eval", None)))
    monkeypatch.setattr(cli, "resolve_device", lambda d: "cpu")
    root = str(tmp_path / "root")
    argv = ["--balance_dataset", "--download", "--remote", "--move_files",
            "--data_dir", root]
    assert cli.main(argv + ["--evaluate", "--device", "cpu"]) == 0
    assert order["port"] == [("download", True), ("move", None),
                             ("eval", None), ("balance", root)]
    jmove = importlib.import_module(
        "ss25_hierarchical_multiscale_image_classification_tpu.utils.structure")
    monkeypatch.setattr(jmove, "move_files_up",
                        lambda d: order["jax"].append(("move", None)))
    assert jcli.main(argv + ["--compile_cache_dir", "off"]) == 0
    assert order["jax"] == [o for o in order["port"] if o[0] != "eval"]
    # a real run against the loopback server: the subset's five files
    monkeypatch.setattr(cli, "download_dataset", download.download_dataset)
    _serve_everything(server)
    server.requests.clear()
    assert cli.main(["--download", "--data_dir", root]) == 0
    assert len(server.requests) == 5
    assert os.path.exists(os.path.join(root, "train", "img", "normal_001.tif"))


def test_cli_refuses_the_download_actions_under_torchrun(server, tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    for flag in ("--download", "--balance_dataset"):
        assert cli.main(["--train", flag, "--data_dir", str(tmp_path),
                         "--device", "cpu"]) == 2
    assert server.requests == []
