"""Checksummed HTTP dataset acquisition.

Counterpart of `deeplearning4j_tpu/datasets/fetch.py` (its own copy, pure
Python): `download_file` verifies a SHA-256 digest, writes to a '.part'
file and renames it into place (an interrupted pull never poisons the
cache), keeps a present file that passes its checksum, and retries with
full-jitter exponential backoff (`backoff_seconds`); `gunzip_file`,
`untar_file` (refusing members that escape the target directory) and
`fetch_mnist`, `fetch_cifar10`, `fetch_curves` and `fetch_lfw`, whose base
URLs can be pointed at any mirror (the `DL4J_*_URL` variables), which is
how the tests serve them from a local `http.server`.
"""

from __future__ import annotations

import gzip
import hashlib
import logging
import os
import random
import shutil
import tarfile
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, Optional

log = logging.getLogger("deeplearning4j_tpu_torch")

#: retry backoff envelope: attempt n sleeps jittered
#: min(BACKOFF_CAP_S, BACKOFF_BASE_S * 2**(n-1)) seconds
BACKOFF_BASE_S = 0.5
BACKOFF_CAP_S = 8.0

#: monkeypatchable sleep so retry tests run in milliseconds
_sleep = time.sleep


def backoff_seconds(attempt: int, rng: Callable[[], float] = random.random
                    ) -> float:
    """Full-jitter exponential backoff (AWS-style): uniform in
    (0, min(cap, base * 2**(attempt-1))] — jitter decorrelates a fleet
    of workers hammering the same recovering mirror."""
    ceiling = min(BACKOFF_CAP_S, BACKOFF_BASE_S * (2.0 ** (attempt - 1)))
    return ceiling * max(rng(), 1e-3)

# canonical sources (the reference's trainingFilesURL etc.); override with
# base_url= or the DL4J_MNIST_URL / DL4J_LFW_URL / DL4J_CIFAR10_URL /
# DL4J_CURVES_URL environment variables
MNIST_BASE_URL = "http://yann.lecun.com/exdb/mnist/"
LFW_URL = "http://vis-www.cs.umass.edu/lfw/lfw.tgz"
CIFAR10_URL = "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz"
# published digest of the canonical cifar-10-python.tar.gz
CIFAR10_SHA256 = \
    "6d958be074577803d12ecdefd02955f39262c83c16fe9348329d7fe0b5c001ce"
# the reference's CurvesDataFetcher pulls a serialized corpus from S3
# (CurvesDataFetcher.java:38-65 CURVES_URL); the Java-serialized .ser is
# replaced by an .npz with 'features' (+ optional 'labels') arrays
CURVES_URL = ""  # no canonical public .npz source; set DL4J_CURVES_URL

MNIST_FILES = ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz",
               "t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz")

# published SHA-256 digests of the canonical MNIST gz files; fetches from a
# different mirror/fixture must pass their own checksums (or None to skip)
MNIST_SHA256 = {
    "train-images-idx3-ubyte.gz":
        "440fcabf73cc546fa21475e81ea370265605f56be210a4024d2ca8f203523609",
    "train-labels-idx1-ubyte.gz":
        "3552534a0a558bbed6aed32b30c495cca23d567ec52cac8be1a0730e8010255c",
    "t10k-images-idx3-ubyte.gz":
        "8d422c7b0a1c1c79245a5bcf07fe86e33eeafee792b84584aec276f5a2dbc4e6",
    "t10k-labels-idx1-ubyte.gz":
        "f7ae60f92e00ec6debd23a6088c31dbd2371eca3ffa0defaefb259924204aec6",
}


class ChecksumError(IOError):
    """Downloaded bytes did not match the expected SHA-256."""


def sha256_of(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def download_file(url: str, dest: str, sha256: Optional[str] = None,
                  retries: int = 3, timeout: float = 30.0,
                  force: bool = False, opener=None) -> str:
    """Fetch `url` into `dest` with checksum verification.

    Already-present files that pass the checksum are kept (the reference's
    `if(!tarFile.isFile())` skip, hardened: a present-but-corrupt file is
    re-downloaded rather than trusted). Writes to `dest + '.part'` then
    renames, so a crash mid-download leaves no half file at `dest`; a
    failed attempt deletes its partial temp file before backing off.

    Retries sleep full-jitter exponential backoff (`backoff_seconds`)
    instead of hammering a struggling mirror back-to-back.  `opener`
    overrides `urllib.request.urlopen` (tests inject flaky fakes).
    """
    opener = urllib.request.urlopen if opener is None else opener
    if not force and os.path.exists(dest):
        if sha256 is None or sha256_of(dest) == sha256:
            return dest
        log.warning("cached %s fails checksum; re-downloading", dest)
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    tmp = dest + ".part"
    last_err: Optional[Exception] = None
    for attempt in range(1, retries + 1):
        try:
            with opener(url, timeout=timeout) as r, \
                    open(tmp, "wb") as f:
                shutil.copyfileobj(r, f)
            if sha256 is not None:
                got = sha256_of(tmp)
                if got != sha256:
                    raise ChecksumError(
                        f"{url}: sha256 {got} != expected {sha256}")
            os.replace(tmp, dest)
            return dest
        except ChecksumError:
            # corrupt source content — retrying the same URL is pointless
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        except (urllib.error.URLError, OSError) as e:
            last_err = e
            if os.path.exists(tmp):  # never leave a partial around
                os.remove(tmp)
            log.warning("download %s attempt %d/%d failed: %r",
                        url, attempt, retries, e)
            if attempt < retries:
                delay = backoff_seconds(attempt)
                log.info("download %s: backing off %.2fs before retry",
                         url, delay)
                _sleep(delay)
    raise IOError(f"could not download {url}: {last_err!r}")


def gunzip_file(gz_path: str, dest: Optional[str] = None) -> str:
    """`MnistFetcher.gunzipFile` parity, keeping the .gz (re-verifiable)."""
    dest = dest or gz_path[:-3]
    if not os.path.exists(dest):
        tmp = dest + ".part"
        with gzip.open(gz_path, "rb") as src, open(tmp, "wb") as out:
            shutil.copyfileobj(src, out)
        os.replace(tmp, dest)
    return dest


def untar_file(tar_path: str, dest_dir: str) -> str:
    """`MnistFetcher.untarFile` / ArchiveUtils parity, with a member-path
    guard (no absolute paths or .. escapes)."""
    os.makedirs(dest_dir, exist_ok=True)
    base = os.path.realpath(dest_dir)
    with tarfile.open(tar_path, "r:*") as tf:
        for m in tf.getmembers():
            target = os.path.realpath(os.path.join(dest_dir, m.name))
            if not (target == base or target.startswith(base + os.sep)):
                raise IOError(f"tar member escapes dest dir: {m.name}")
        try:
            tf.extractall(dest_dir, filter="data")
        except TypeError:  # Python < 3.12 has no filter kwarg
            tf.extractall(dest_dir)
    return dest_dir


def fetch_mnist(cache_dir: Optional[str] = None,
                base_url: Optional[str] = None,
                checksums: Optional[Dict[str, Optional[str]]] = None,
                retries: int = 3) -> str:
    """Download + unpack the four MNIST IDX files; returns the directory,
    ready for `mnist.load_real_mnist` / `find_mnist_dir`.

    cache_dir defaults to $MNIST_DIR or ~/MNIST (the reference's layout);
    base_url defaults to $DL4J_MNIST_URL or the canonical LeCun server.
    checksums defaults to the canonical digests — pass {name: None} entries
    to skip verification for a mirror with different bytes.
    """
    cache_dir = cache_dir or os.environ.get("MNIST_DIR") \
        or os.path.expanduser("~/MNIST")
    base_url = base_url or os.environ.get("DL4J_MNIST_URL") or MNIST_BASE_URL
    if not base_url.endswith("/"):
        base_url += "/"
    sums = MNIST_SHA256 if checksums is None else checksums
    os.makedirs(cache_dir, exist_ok=True)
    for name in MNIST_FILES:
        gz = download_file(base_url + name, os.path.join(cache_dir, name),
                           sha256=sums.get(name), retries=retries)
        gunzip_file(gz)
    return cache_dir


def fetch_cifar10(cache_dir: Optional[str] = None,
                  url: Optional[str] = None,
                  sha256: Optional[str] = "default",
                  retries: int = 3) -> str:
    """Download + untar `cifar-10-python.tar.gz`; returns the
    `cifar-10-batches-py` directory ready for `cifar.load_real_cifar10`.

    cache_dir defaults to $CIFAR10_DIR or ~/CIFAR10; url to
    $DL4J_CIFAR10_URL or the canonical Toronto server.  sha256 defaults to
    the canonical digest — pass None to skip verification for a fixture
    archive with different bytes.
    """
    from deeplearning4j_tpu_torch.datasets.cifar import (BATCH_DIR,
                                                         TRAIN_BATCHES)

    cache_dir = cache_dir or os.environ.get("CIFAR10_DIR") \
        or os.path.expanduser("~/CIFAR10")
    url = url or os.environ.get("DL4J_CIFAR10_URL") or CIFAR10_URL
    if sha256 == "default":
        # a non-canonical source (mirror/fixture) has different bytes;
        # only pin the digest when pulling from the canonical URL
        sha256 = CIFAR10_SHA256 if url == CIFAR10_URL else None
    root = os.path.join(cache_dir, BATCH_DIR)
    if os.path.exists(os.path.join(root, TRAIN_BATCHES[0])):
        return root
    tgz = download_file(url, os.path.join(cache_dir, os.path.basename(url)),
                        sha256=sha256, retries=retries)
    untar_file(tgz, cache_dir)
    if not os.path.exists(os.path.join(root, TRAIN_BATCHES[0])):
        # archive laid out without the cifar-10-batches-py/ prefix
        root = cache_dir
    return root


def fetch_curves(cache_dir: Optional[str] = None, url: Optional[str] = None,
                 sha256: Optional[str] = None, retries: int = 3) -> str:
    """Download the curves corpus (.npz with 'features' [+ 'labels']);
    returns the local file path.

    The reference's `CurvesDataFetcher.java:38-65` downloads and
    deserializes a Java `curves.ser` DataSet; the corpus format here is an
    .npz archive.  url defaults to $DL4J_CURVES_URL (there is no
    canonical public .npz mirror)."""
    cache_dir = cache_dir or os.environ.get("CURVES_DIR") \
        or os.path.expanduser("~/CURVES")
    url = url or os.environ.get("DL4J_CURVES_URL") or CURVES_URL
    if not url:
        raise IOError("no curves source configured (set DL4J_CURVES_URL)")
    return download_file(
        url, os.path.join(cache_dir, os.path.basename(url)),
        sha256=sha256, retries=retries)


def fetch_lfw(cache_dir: Optional[str] = None, url: Optional[str] = None,
              sha256: Optional[str] = None, retries: int = 3) -> str:
    """Download + untar LFW (`base/LFWLoader.getIfNotExists`); returns the
    image root (one subdirectory per person) for `ImageRecordReader`."""
    cache_dir = cache_dir or os.environ.get("LFW_DIR") \
        or os.path.expanduser("~/LFW")
    url = url or os.environ.get("DL4J_LFW_URL") or LFW_URL
    # already-extracted trees win before any network touch (the reference's
    # `if(!tarFile.isFile())` skip, extended to the extracted form): either
    # the lfw/-prefixed layout or a flat person-per-directory cache_dir
    root = os.path.join(cache_dir, "lfw")
    if os.path.isdir(root):
        return root
    if os.path.isdir(cache_dir) and any(
            e.is_dir() for e in os.scandir(cache_dir)):
        return cache_dir
    tgz = download_file(url, os.path.join(cache_dir, os.path.basename(url)),
                        sha256=sha256, retries=retries)
    untar_file(tgz, cache_dir)
    if not os.path.isdir(root):  # archive laid out without a lfw/ prefix
        root = cache_dir
    return root
