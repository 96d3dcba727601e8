"""The traffic generator repeats from a seed and gives every seed the same
line sizes."""

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark import traffic

WORKLOADS = Path(__file__).resolve().parents[1] / "workloads"


@pytest.mark.parametrize("mix", sorted(p.name for p in WORKLOADS.glob("*.json")))
def test_lines_repeat_from_a_seed_and_keep_their_sizes(mix):
    spec = dict(json.loads((WORKLOADS / mix).read_text())["lines"], n_lines=64)
    a, b = traffic.make_lines(spec, 5), traffic.make_lines(spec, 5)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    c = traffic.make_lines(spec, 6)
    assert sorted(x.shape for x in a) == sorted(x.shape for x in c)
    assert any(not np.array_equal(x, y) for x, y in zip(a, c))
    for x in a:
        assert x.dtype == np.uint8 and x.shape[2] == 3
        assert 12 <= x.shape[0] < 65 and x.shape[1] <= spec["max_width"]
