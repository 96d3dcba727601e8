"""Progress bars through ``tqdm`` when it imports, else none.

``tqdm`` is not on the card's guaranteed package list: without it the
callers iterate plainly (the training loop logs its own lines), and no
other behaviour depends on it.
"""

from __future__ import annotations

from typing import Iterable, Optional


class _NoBar:
    def __init__(self, iterable: Optional[Iterable]):
        self.iterable = iterable

    def __iter__(self):
        return iter(self.iterable)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def update(self, n: int = 1) -> None:
        pass

    def set_postfix(self, **kwargs) -> None:
        pass


def has_tqdm() -> bool:
    try:
        import tqdm  # noqa: F401
    except ImportError:
        return False
    return True


def progress(iterable: Optional[Iterable] = None, enabled: bool = True, **kwargs):
    """``tqdm(iterable, **kwargs)`` (auto-disabled off a terminal) when
    ``enabled`` and tqdm imports; otherwise a bar that draws nothing."""
    if enabled:
        try:
            from tqdm import tqdm
        except ImportError:
            pass
        else:
            return tqdm(iterable, disable=None, **kwargs)
    return _NoBar(iterable)
