"""Archive extraction helpers.

Parity: reference `util/ArchiveUtils.java` — unpack .tar.gz/.tgz/.zip/.gz
into a target directory (used by the dataset downloaders).
"""

from __future__ import annotations

import gzip
import os
import shutil
import tarfile
import zipfile


def unzip_file_to(archive_path: str, dest_dir: str) -> None:
    """Extract any supported archive into dest_dir
    (`ArchiveUtils.unzipFileTo`)."""
    os.makedirs(dest_dir, exist_ok=True)
    if archive_path.endswith((".tar.gz", ".tgz", ".tar")):
        mode = "r:gz" if archive_path.endswith(("gz",)) else "r"
        with tarfile.open(archive_path, mode) as t:
            t.extractall(dest_dir, filter="data")
    elif archive_path.endswith(".zip"):
        with zipfile.ZipFile(archive_path) as z:
            z.extractall(dest_dir)
    elif archive_path.endswith(".gz"):
        out = os.path.join(
            dest_dir, os.path.basename(archive_path)[:-3])
        with gzip.open(archive_path, "rb") as src, open(out, "wb") as dst:
            shutil.copyfileobj(src, dst)
    else:
        raise ValueError(f"unsupported archive format: {archive_path}")
