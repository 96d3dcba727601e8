"""The port's optimizers and schedulers vs the JAX package's, on the CPU.

Three steps of each optimizer, with and without global-norm clipping, on
the same tree of arrays and the same gradients (``numpy.random.default_rng``),
against the JAX ``build_optimizer`` (optax): parameters after every step
within rtol 1e-5 / atol 1e-4 x lr.  The atol is for Adam's bias correction:
optax computes ``1 - 0.999**t`` in fp32 (4.7e-5 off at t = 1), torch in
double, so an Adam step of size lr differs by about 2.3e-5 x lr.  The
schedulers are pure Python in both packages and must give the same
learning rates exactly, also across a ``state_dict`` round trip.
"""

import math

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rcnn_ocr_tpu.training import optim as jax_optim
from rcnn_ocr_tpu_torch.training import optim

SHAPES = {"w": (5, 3), "b": (3,), "k": (2, 2, 4)}


@pytest.mark.parametrize("grad_clip", [0.0, 0.5])
@pytest.mark.parametrize("name", ["Adam", "AdamW", "SGD"])
def test_three_steps_match_optax(name, grad_clip):
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(3)]
    kw = dict(weight_decay=0.01, momentum=0.9, grad_clip=grad_clip)

    tx = jax_optim.build_optimizer(name, 0.05, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(jp)

    spec = optim.build_optimizer(name, 0.05, **kw)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    opt = spec.init(tp.values())
    for g in grads:
        updates, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        spec.apply(opt)
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-4 * 0.05, err_msg=k)


def test_clip_uses_optax_factor():
    """Global norm 5 clipped to 1: gradients scaled by exactly 1/5; a norm
    under the limit is left alone."""
    p = [torch.zeros(3, requires_grad=True), torch.zeros(2, requires_grad=True)]
    p[0].grad = torch.tensor([3.0, 0.0, 0.0])
    p[1].grad = torch.tensor([0.0, 4.0])
    norm = optim.clip_by_global_norm_(p, 1.0)
    assert float(norm) == 5.0
    assert p[0].grad.tolist() == pytest.approx([0.6, 0.0, 0.0], rel=1e-7)
    assert p[1].grad.tolist() == pytest.approx([0.0, 0.8], rel=1e-7)
    optim.clip_by_global_norm_(p, 2.0)
    assert p[1].grad.tolist() == pytest.approx([0.0, 0.8], rel=1e-7)


def test_adam_weight_decay_is_l2_into_the_gradient():
    """Zero gradient, nonzero weights: Adam still moves (L2, not decoupled),
    by exactly lr on the first step."""
    w = torch.ones(2, requires_grad=True)
    spec = optim.build_optimizer("Adam", 0.1, weight_decay=0.5)
    opt = spec.init([w])
    w.grad = torch.zeros(2)
    spec.apply(opt)
    torch.testing.assert_close(w.detach(), torch.full((2,), 0.9), rtol=1e-6, atol=1e-7)


def test_lr_get_set_and_unknown_names():
    spec = optim.build_optimizer("SGD", 0.1)
    opt = spec.init([torch.zeros(1, requires_grad=True)])
    assert optim.get_lr(opt) == pytest.approx(0.1)
    optim.set_lr(opt, 0.05)
    assert optim.get_lr(opt) == 0.05
    with pytest.raises(ValueError):
        optim.build_optimizer("RMSNope", 0.1)
    with pytest.raises(ValueError):
        optim.build_scheduler("Nope", 1.0, 10)
    assert optim.build_scheduler(None, 1.0, 10) is None
    assert optim.build_scheduler("None", 1.0, 10) is None


@pytest.mark.parametrize("name", ["ReduceLROnPlateau", "CosineAnnealingLR"])
def test_scheduler_sequences_and_state_match_jax(name):
    metrics = [1.0, 1.0, 0.9, 0.9, 0.9, 0.9, 0.9, 0.5, 0.6, 0.6, 0.6, 0.6, 0.6, 0.4]
    ours = optim.build_scheduler(name, 0.01, 10)
    theirs = jax_optim.build_scheduler(name, 0.01, 10)
    assert type(ours).__name__ == type(theirs).__name__ == name
    for i, m in enumerate(metrics):
        assert ours.step(m) == theirs.step(m)
        assert ours.state_dict() == theirs.state_dict()
        if i == 6:  # round trip mid-sequence, across packages
            resumed = optim.build_scheduler(name, 0.01, 10)
            resumed.load_state_dict(theirs.state_dict())
            ours = resumed
    if name == "CosineAnnealingLR":
        assert ours.lr == pytest.approx(0.01 * (1 + math.cos(math.pi * 14 / 10)) / 2)
