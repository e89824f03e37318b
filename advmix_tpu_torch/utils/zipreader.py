"""Read images straight from `archive.zip@member` paths.

Port of `advmix_tpu/utils/zipreader.py` (reference
`lib/utils/zipreader.py:23-46`): open archives are cached, one per path,
and a member's bytes are decoded by `cv2.imdecode`. The datasets use it
when DATASET.DATA_FORMAT is `zip`. `cv2` is imported at the first read.
"""

from __future__ import annotations

import zipfile

import numpy as np

_CACHE: dict = {}


def split_zip_path(path: str):
    """`<archive>.zip@<member>` -> (archive, member without a leading /)."""
    assert "@" in path, f"not a zip path: {path}"
    archive, member = path.split("@", 1)
    return archive, member.lstrip("/")


def imread(path: str, flags=None):
    """cv2.imread of a zip member: a BGR uint8 image, or None where cv2
    cannot decode the bytes."""
    import cv2

    if flags is None:
        flags = cv2.IMREAD_COLOR
    archive, member = split_zip_path(path)
    if archive not in _CACHE:
        _CACHE[archive] = zipfile.ZipFile(archive, "r")
    data = _CACHE[archive].read(member)
    return cv2.imdecode(np.frombuffer(data, np.uint8), flags)
