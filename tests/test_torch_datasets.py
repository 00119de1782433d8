"""The port's builtin datasets and their readers vs the JAX package's.

Every builtin scheme of `cli/schemes.load_input` (mnist, iris, lfw, curves,
cifar10, csv) gives the JAX package's arrays exactly at a small n; the
vendored iris.csv and digits.csv.gz parse to scikit-learn's arrays exactly
(skipped without scikit-learn); the native IDX and CSV readers, built from
the port's own copy of `dataloader.cc`, agree with the Python paths and
refuse what the JAX package's refuse (tests/test_native_loader.py's cases);
the download, checksum, retry, untar-escape and cache-hit cases of
tests/test_fetch.py run against a local `http.server` or an injected
opener, never the network; and the record readers give the JAX package's
batches exactly.
"""

import gzip
import hashlib
import io
import os
import struct
import tarfile
import threading
from http.server import HTTPServer, SimpleHTTPRequestHandler

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one share of the cores)

from deeplearning4j_tpu.cli.schemes import load_input as jax_load_input  # noqa: E402,E501
from deeplearning4j_tpu.datasets import fetchers as jax_fetchers  # noqa: E402
from deeplearning4j_tpu.datasets import records as jax_records  # noqa: E402
from deeplearning4j_tpu_torch import native  # noqa: E402
from deeplearning4j_tpu_torch.cli.schemes import load_input  # noqa: E402
from deeplearning4j_tpu_torch.datasets import fetch, fetchers, records  # noqa: E402,E501
from deeplearning4j_tpu_torch.datasets import mnist as mnist_mod  # noqa: E402,E501

needs_native = pytest.mark.skipif(native.get_library() is None,
                                  reason="g++ unavailable: no native reader")


@pytest.fixture(autouse=True)
def _no_real_data(monkeypatch, tmp_path):
    """Nothing on disk or configured: every builtin takes its stand-in in
    both packages, whatever the machine holds in its home directory."""
    for var in ("MNIST_DIR", "CIFAR10_DIR", "LFW_DIR", "CURVES_DIR",
                "DL4J_MNIST_URL", "DL4J_CIFAR10_URL", "DL4J_LFW_URL",
                "DL4J_CURVES_URL"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("SCIKIT_LEARN_DATA", str(tmp_path / "skdata"))


def _assert_same(got, want):
    np.testing.assert_array_equal(got.features, want.features)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.features.dtype == want.features.dtype
    assert got.labels.dtype == want.labels.dtype


# -- the builtin schemes ----------------------------------------------------------

@pytest.mark.parametrize("uri", ["mnist:37", "iris", "iris:20", "lfw:11",
                                 "curves:9", "cifar10:13"])
def test_builtin_schemes_equal_jax(uri):
    _assert_same(load_input(uri), jax_load_input(uri))


def test_num_examples_overrides_the_uri_count_as_in_jax():
    _assert_same(load_input("mnist:5", num_examples=8),
                 jax_load_input("mnist:5", num_examples=8))


def _write_csv(path, rows=40, seed=3, header=False):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((rows, 5))
    y = rng.randint(0, 4, rows)
    with open(path, "w") as f:
        if header:
            f.write("a,b,c,d,e,label\n")
        for xi, yi in zip(x, y):
            f.write(",".join(f"{v:.6f}" for v in xi) + f",{yi}\n")
    return x, y


@pytest.mark.parametrize("form", ["csv:{p}", "csv:{p}:0", "{p}"])
def test_csv_scheme_equals_jax_through_the_native_reader(tmp_path, form):
    p = str(tmp_path / "data.csv")
    _write_csv(p)
    uri = form.format(p=p)
    _assert_same(load_input(uri), jax_load_input(uri))
    _assert_same(load_input(uri, num_examples=7),
                 jax_load_input(uri, num_examples=7))


def test_fetcher_iterators_equal_jax():
    for name, kw in (("iris_iterator", dict(batch_size=32)),
                     ("mnist_iterator", dict(batch_size=7,
                                             num_examples=20)),
                     ("curves_iterator", dict(batch_size=4,
                                              num_examples=10)),
                     ("cifar10_iterator", dict(batch_size=5,
                                               num_examples=12))):
        got = list(getattr(fetchers, name)(**kw))
        want = list(getattr(jax_fetchers, name)(**kw))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    got = fetchers.MnistDataFetcher(binarize=False).fetch(6)
    _assert_same(got, jax_fetchers.MnistDataFetcher(binarize=False).fetch(6))


def test_the_port_imports_no_scikit_learn_outside_lfw():
    """Only LFW's fallback chain names scikit-learn, inside its try."""
    root = os.path.dirname(os.path.dirname(fetchers.__file__))
    hits = []
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path, encoding="utf-8") as f:
                    hits += [(os.path.relpath(path, root), line.strip())
                             for line in f if "import" in line
                             and "sklearn" in line]
    assert hits == [("datasets/fetchers.py",
                     "from sklearn.datasets import fetch_lfw_people")]


# -- the vendored CSVs ------------------------------------------------------------

def test_vendored_csvs_parse_as_scikit_learns():
    sk = pytest.importorskip("sklearn.datasets")
    X, y = fetchers.load_iris()
    want_x, want_y = sk.load_iris(return_X_y=True)
    np.testing.assert_array_equal(X, want_x)
    np.testing.assert_array_equal(y, want_y)
    assert X.dtype == want_x.dtype
    X, y = mnist_mod.load_digits()
    want_x, want_y = sk.load_digits(return_X_y=True)
    np.testing.assert_array_equal(X, want_x)
    np.testing.assert_array_equal(y, want_y)
    assert X.dtype == want_x.dtype and y.dtype == want_y.dtype


def test_lfw_without_scikit_learn_lands_on_the_stand_in(monkeypatch):
    """An ImportError in LFW's try takes the synthetic path, as the JAX
    package's OSError (no local cache) does."""
    import builtins

    real_import = builtins.__import__

    def no_sklearn(name, *a, **kw):
        if name.startswith("sklearn"):
            raise ImportError("no scikit-learn here")
        return real_import(name, *a, **kw)

    want = jax_load_input("lfw:6")
    monkeypatch.setattr(builtins, "__import__", no_sklearn)
    _assert_same(fetchers.LFWDataFetcher().fetch(6), want)


# -- the native readers -------------------------------------------------------------

def _write_idx(path, arr: np.ndarray):
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | arr.ndim))
        for d in arr.shape:
            f.write(struct.pack(">I", d))
        f.write(arr.astype(np.uint8).tobytes())


def test_native_library_builds_into_the_ports_build_dir():
    if native.get_library() is None:
        pytest.skip("g++ unavailable")
    path = native.library_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.exists(path)
    assert "deeplearning4j_tpu_torch" in path


@needs_native
def test_native_idx_roundtrip_and_python_agree(tmp_path):
    arr = (np.arange(3 * 5 * 4) % 251).astype(np.uint8).reshape(3, 5, 4)
    p = str(tmp_path / "images.idx3-ubyte")
    _write_idx(p, arr)
    out = native.native_read_idx(p)
    np.testing.assert_array_equal(out, arr)
    np.testing.assert_array_equal(mnist_mod.read_idx_python(p), arr)
    # a .gz copy takes the Python path
    pgz = str(tmp_path / "z.idx3-ubyte")
    with open(p, "rb") as f, gzip.open(pgz + ".gz", "wb") as g:
        g.write(f.read())
    np.testing.assert_array_equal(mnist_mod.read_idx(pgz), arr)
    assert native.native_read_idx(pgz) is None


@needs_native
def test_native_idx_refuses_other_dtypes_and_short_files(tmp_path):
    p = str(tmp_path / "f32.idx")
    with open(p, "wb") as f:  # dtype 0x0D: float32
        f.write(struct.pack(">III", 0x0D01, 2, 0) + b"\0" * 8)
    assert native.native_read_idx(p) is None
    with pytest.raises(ValueError, match="unsupported IDX dtype"):
        mnist_mod.read_idx(p)
    short = str(tmp_path / "short.idx")
    with open(short, "wb") as f:
        f.write(struct.pack(">II", 0x0801, 10) + b"\1\2")
    assert native.native_read_idx(short) is None


@needs_native
def test_native_csv_parse_and_refusals(tmp_path):
    rng = np.random.RandomState(0)
    arr = rng.randn(200, 7).astype(np.float32)
    p = str(tmp_path / "data.csv")
    with open(p, "w") as f:
        f.write("a,b,c,d,e,f,g\n")
        for row in arr:
            f.write(",".join(f"{v:.6f}" for v in row) + "\n")
    out = native.native_read_csv(p, skip_header=True)
    np.testing.assert_allclose(out, arr, rtol=0, atol=1e-5)
    # one thread and many give the same array
    np.testing.assert_array_equal(
        native.native_read_csv(p, skip_header=True, nthreads=1), out)
    bad = str(tmp_path / "bad.csv")
    with open(bad, "w") as f:
        f.write("1.0,2.0\n3.0,setosa\n")
    assert native.native_read_csv(bad) is None
    ragged = str(tmp_path / "ragged.csv")
    with open(ragged, "w") as f:  # strtod must not cross the newline
        f.write("1.0,\n2.0,3.0\n")
    assert native.native_read_csv(ragged) is None


@needs_native
def test_csv_fetcher_native_and_python_paths_agree(tmp_path, monkeypatch):
    p = str(tmp_path / "train.csv")
    _write_csv(p, header=True)
    via_native = fetchers.CSVDataFetcher(p, skip_header=True).fetch()
    want = jax_fetchers.CSVDataFetcher(p, skip_header=True).fetch()
    _assert_same(via_native, want)
    monkeypatch.setenv("DL4J_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)
    assert native.get_library() is None
    _assert_same(fetchers.CSVDataFetcher(p, skip_header=True).fetch(), want)
    monkeypatch.setattr(native, "_load_failed", False)


def test_python_fallback_when_native_disabled(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)
    p = str(tmp_path / "train.csv")
    with open(p, "w") as f:
        f.write("0.1,0.2,0\n0.3,0.4,1\n")
    ds = fetchers.CSVDataFetcher(p, label_column=-1).fetch()
    assert ds.features.shape == (2, 2) and ds.labels.shape == (2, 2)
    idx = str(tmp_path / "l.idx1-ubyte")
    _write_idx(idx, np.arange(5, dtype=np.uint8))
    np.testing.assert_array_equal(mnist_mod.read_idx(idx), np.arange(5))
    monkeypatch.setattr(native, "_load_failed", False)


# -- real MNIST on disk -------------------------------------------------------------

def _idx_images(arr):
    n, h, w = arr.shape
    return struct.pack(">IIII", 0x00000803, n, h, w) + arr.tobytes()


def _idx_labels(arr):
    return struct.pack(">II", 0x00000801, len(arr)) + arr.tobytes()


def _mnist_files(rng):
    """Tiny but valid MNIST .gz files under the canonical names."""
    out = {}
    for prefix, n in (("train", 40), ("t10k", 16)):
        imgs = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
        labels = rng.randint(0, 10, n).astype(np.uint8)
        out[f"{prefix}-images-idx3-ubyte.gz"] = gzip.compress(
            _idx_images(imgs))
        out[f"{prefix}-labels-idx1-ubyte.gz"] = gzip.compress(
            _idx_labels(labels))
    return out


@pytest.mark.parametrize("gz", [True, False])
def test_mnist_from_disk_equals_jax(tmp_path, monkeypatch, gz):
    d = tmp_path / "mnist"
    d.mkdir()
    for name, blob in _mnist_files(np.random.RandomState(5)).items():
        if gz:
            (d / name).write_bytes(blob)
        else:
            (d / name[:-3]).write_bytes(gzip.decompress(blob))
    monkeypatch.setenv("MNIST_DIR", str(d))
    assert mnist_mod.find_mnist_dir() == str(d)
    _assert_same(load_input("mnist:25"), jax_load_input("mnist:25"))
    for train in (True, False):
        _assert_same(fetchers.MnistDataFetcher(False, train).fetch(30),
                     jax_fetchers.MnistDataFetcher(False, train).fetch(30))


# -- downloads, against a local server ---------------------------------------------------

@pytest.fixture()
def file_server(tmp_path):
    """Serve tmp_path/'srv' over a loopback HTTP server."""
    srv_dir = tmp_path / "srv"
    srv_dir.mkdir()

    class Handler(SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=str(srv_dir), **kw)

        def log_message(self, *a):
            pass

    httpd = HTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield srv_dir, f"http://127.0.0.1:{httpd.server_port}/"
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_download_verifies_checksum_and_is_atomic(file_server, tmp_path):
    srv_dir, base = file_server
    payload = b"x" * 4096
    (srv_dir / "blob.bin").write_bytes(payload)
    good = hashlib.sha256(payload).hexdigest()
    dest = str(tmp_path / "out" / "blob.bin")
    p = fetch.download_file(base + "blob.bin", dest, sha256=good)
    assert fetch.sha256_of(p) == good
    assert not os.path.exists(dest + ".part")
    dest2 = str(tmp_path / "out" / "blob2.bin")
    with pytest.raises(fetch.ChecksumError):
        fetch.download_file(base + "blob.bin", dest2, sha256="0" * 64)
    assert not os.path.exists(dest2) and not os.path.exists(dest2 + ".part")


def test_download_refetches_a_corrupt_cache_and_raises_on_missing(
        file_server, tmp_path):
    srv_dir, base = file_server
    payload = b"fresh bytes"
    (srv_dir / "f.bin").write_bytes(payload)
    dest = str(tmp_path / "f.bin")
    with open(dest, "wb") as f:
        f.write(b"stale garbage")
    fetch.download_file(base + "f.bin", dest,
                        sha256=hashlib.sha256(payload).hexdigest())
    assert open(dest, "rb").read() == payload
    with pytest.raises(IOError):
        fetch.download_file(base + "nope.bin", str(tmp_path / "n.bin"),
                            retries=2)


def test_fetch_mnist_downloads_then_hits_the_cache(file_server, tmp_path,
                                                   monkeypatch):
    """A clean MNIST_DIR and a fixture URL: download, verify, gunzip, and
    the stock fetcher reads what JAX's reads; a second fetch with the
    server emptied is served from the cache."""
    srv_dir, base = file_server
    files = _mnist_files(np.random.RandomState(0))
    sums = {}
    for name, blob in files.items():
        (srv_dir / name).write_bytes(blob)
        sums[name] = hashlib.sha256(blob).hexdigest()
    cache = tmp_path / "mnist_cache"
    monkeypatch.setenv("MNIST_DIR", str(cache))
    monkeypatch.setenv("DL4J_MNIST_URL", base)
    assert fetch.fetch_mnist(checksums=sums) == str(cache)
    for name in files:
        assert (cache / name).exists() and (cache / name[:-3]).exists()
    got = fetchers.MnistDataFetcher(binarize=False).fetch(32)
    _assert_same(got, jax_fetchers.MnistDataFetcher(binarize=False).fetch(32))
    for name in files:
        (srv_dir / name).unlink()
    assert fetch.fetch_mnist(checksums=sums) == str(cache)


def _png_bytes(rng):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.randint(0, 256, (62, 47), np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


def test_fetch_lfw_untar_and_record_reader_equal_jax(file_server, tmp_path,
                                                     monkeypatch):
    pytest.importorskip("PIL")
    srv_dir, base = file_server
    rng = np.random.RandomState(2)
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        for person, k in (("Alice_A", 3), ("Bob_B", 2)):
            for i in range(k):
                data = _png_bytes(rng)
                info = tarfile.TarInfo(f"lfw/{person}/{person}_{i:04d}.png")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    blob = buf.getvalue()
    (srv_dir / "lfw.tgz").write_bytes(blob)
    monkeypatch.setenv("LFW_DIR", str(tmp_path / "lfw_cache"))
    monkeypatch.setenv("DL4J_LFW_URL", base + "lfw.tgz")
    root = fetch.fetch_lfw(sha256=hashlib.sha256(blob).hexdigest())
    assert sorted(os.listdir(root)) == ["Alice_A", "Bob_B"]
    got = fetchers.LFWDataFetcher().fetch(5)
    assert got.features.shape == (5, 62 * 47) and got.labels.shape[1] == 2
    _assert_same(got, jax_fetchers.LFWDataFetcher().fetch(5))


def test_untar_rejects_escaping_members(tmp_path):
    evil = tmp_path / "evil.tar"
    with tarfile.open(evil, "w") as tf:
        data = b"pwned"
        info = tarfile.TarInfo("../escape.txt")
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))
    with pytest.raises(IOError, match="escapes"):
        fetch.untar_file(str(evil), str(tmp_path / "dest"))
    assert not (tmp_path / "escape.txt").exists()


def test_gunzip_file_is_idempotent(tmp_path):
    gz = tmp_path / "a.bin.gz"
    gz.write_bytes(gzip.compress(b"hello idx"))
    out = fetch.gunzip_file(str(gz))
    assert open(out, "rb").read() == b"hello idx"
    assert fetch.gunzip_file(str(gz)) == out


def _flaky_opener(payload: bytes, fail_first: int):
    """A urlopen stand-in that fails `fail_first` times, then serves."""
    calls = {"n": 0}

    class _Resp(io.BytesIO):
        def __enter__(self):
            return self

        def __exit__(self, *a):
            self.close()

    def opener(url, timeout=None):
        calls["n"] += 1
        if calls["n"] <= fail_first:
            raise OSError(f"mirror down (attempt {calls['n']})")
        return _Resp(payload)

    return opener, calls


def test_download_retries_with_jittered_exponential_backoff(
        tmp_path, monkeypatch):
    payload = b"eventually consistent mirror"
    opener, calls = _flaky_opener(payload, fail_first=2)
    slept = []
    monkeypatch.setattr(fetch, "_sleep", slept.append)
    dest = str(tmp_path / "d.bin")
    out = fetch.download_file(
        "http://127.0.0.1:9/d.bin", dest,
        sha256=hashlib.sha256(payload).hexdigest(), retries=4,
        opener=opener)
    assert out == dest and open(dest, "rb").read() == payload
    assert calls["n"] == 3 and len(slept) == 2
    for n, delay in enumerate(slept, start=1):
        assert 0.0 < delay <= min(fetch.BACKOFF_CAP_S,
                                  fetch.BACKOFF_BASE_S * 2.0 ** (n - 1))
    assert not os.path.exists(dest + ".part")
    # every attempt failing: IOError, no sleep after the last, no partial
    opener, calls = _flaky_opener(b"", fail_first=99)
    slept.clear()
    never = str(tmp_path / "never.bin")
    with pytest.raises(IOError):
        fetch.download_file("http://127.0.0.1:9/never.bin", never,
                            retries=3, opener=opener)
    assert calls["n"] == 3 and len(slept) == 2
    assert not os.path.exists(never) and not os.path.exists(never + ".part")


def test_backoff_seconds_envelope_equals_jax():
    from deeplearning4j_tpu.datasets import fetch as jax_fetch

    for attempt, u in ((1, 1.0), (3, 1.0), (50, 1.0), (4, 0.0), (2, 0.5),
                       (6, 0.37)):
        assert fetch.backoff_seconds(attempt, rng=lambda u=u: u) == \
            jax_fetch.backoff_seconds(attempt, rng=lambda u=u: u)
    assert fetch.backoff_seconds(50, rng=lambda: 1.0) == fetch.BACKOFF_CAP_S


# -- record readers ------------------------------------------------------------------

def test_csv_record_reader_and_iterator_equal_jax(tmp_path):
    p = str(tmp_path / "r.csv")
    _write_csv(p, rows=23, header=True)
    for kw in (dict(batch_size=5), dict(batch_size=8, shuffle_seed=4),
               dict(batch_size=6, one_hot=False),
               dict(batch_size=10, num_classes=6)):
        got = list(records.RecordReaderDataSetIterator(
            records.CSVRecordReader(p, skip_header=True), **kw))
        want = list(jax_records.RecordReaderDataSetIterator(
            jax_records.CSVRecordReader(p, skip_header=True), **kw))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    reader = records.CSVRecordReader(p, skip_header=True)
    assert reader.num_classes == jax_records.CSVRecordReader(
        p, skip_header=True).num_classes
    assert reader.labels == [str(i) for i in range(reader.num_classes)]
    # no label column: the features are the target
    it = records.RecordReaderDataSetIterator(
        records.CSVRecordReader(p, label_column=None, skip_header=True),
        batch_size=50)
    (ds,) = list(it)
    np.testing.assert_array_equal(ds.features, ds.labels)
    assert it.total_examples() == 23 and it.input_columns() == 6


def test_image_folder_dataset_equals_jax(tmp_path):
    pytest.importorskip("PIL")
    rng = np.random.RandomState(4)
    for person, k in (("Carol_C", 2), ("Dan_D", 3)):
        d = tmp_path / "faces" / person
        d.mkdir(parents=True)
        for i in range(k):
            (d / f"{i}.png").write_bytes(_png_bytes(rng))
    root = str(tmp_path / "faces")
    got = records.image_folder_dataset(root, 31, 24)
    _assert_same(got, jax_records.image_folder_dataset(root, 31, 24))
    assert got.features.shape == (5, 31 * 24)
    reader = records.ImageRecordReader(root, 31, 24)
    assert len(reader) == 5 and reader.labels == ["Carol_C", "Dan_D"]
