"""OpenCV's limit on the images it decodes, which every decoder of the port
applies to a header's sides before it allocates anything: a file of a few
bytes that declares a huge image then fails alike in cv2 and in the port,
and cannot make the port fill gigabytes.

``cv2.imdecode`` checks every header with ``validateInputImageSize``
(``loadsave.cpp``): sides at most 1 << 20, at most 1 << 30 pixels.  Its PNG
reader refuses earlier, at libpng's default user limit of 1,000,000 a side.
"""

from __future__ import annotations

MAX_SIDE = 1 << 20
MAX_PIXELS = 1 << 30
PNG_MAX_SIDE = 1_000_000


def check_size(width: int, height: int, fmt: str, max_side: int = MAX_SIDE) -> None:
    """``ValueError`` where OpenCV refuses an image of ``width`` x ``height``."""
    if width > max_side or height > max_side or width * height > MAX_PIXELS:
        raise ValueError(f"{fmt} of {width}x{height} pixels, which OpenCV refuses (a side over "
                         f"{max_side} or over {MAX_PIXELS} pixels)")
