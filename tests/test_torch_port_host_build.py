"""``native.build_all``: every host C++ library of the port built at once
(one g++ per source, as ``chip_smoke.py``'s build phase runs it beside
nvcc), each loadable, and nothing rebuilt once built."""

import pytest

from rcnn_ocr_tpu_torch import native


def test_build_all_builds_every_host_library_once(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_libs", {})
    first = native.build_all()
    assert set(first) == set(native.ENTRIES) and all(s > 0 for s in first.values())
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        native.library_path(n).name for n in native.ENTRIES)
    assert set(native._libs) == set(native.ENTRIES)
    monkeypatch.setattr(native, "_libs", {})
    assert native.build_all() == {name: 0.0 for name in native.ENTRIES}
    assert set(native._libs) == set(native.ENTRIES)


def test_build_all_raises_with_the_compilers_output(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "CXX_FLAGS", [*native.CXX_FLAGS, "-DRCNN_NO_SUCH_FLAG",
                                              "-Werror=this-is-not-a-warning"])
    with pytest.raises(RuntimeError, match="building the host C\\+\\+ failed"):
        native.build_all()
