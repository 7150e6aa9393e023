"""The port's optimizer against optax, as the JAX package builds it
(``crdr_tpu/trainer/optimizer.py::build_optimizer``), on a fixed sequence of
5 gradient trees: clipped Adam (and AdamW, SGD with momentum, the cosine
schedule, ``paramwise_opt``) with ``MultiStepLR``, whose milestone falls
inside the sequence, and one step skipped (JAX's trainer keeps the whole
state then: ``select_update``).  The parameters must equal optax's to 1e-6
after every step, and a skipped step leaves the parameters, the moments and
the step count (hence the LR) exactly as they were."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from crdr_tpu.trainer.optimizer import build_optimizer as jax_optimizer
from crdr_tpu_torch.trainer.optimizer import build_optimizer

SHAPES = {"enc.weight": (4, 3, 3, 3), "enc.bias": (4,),
          "dec.weight": (5, 7), "quant": (2, 1, 3)}
SKIP = 1  # the second step is skipped
SCALES = (0.05, 3.0, 0.2, 5.0, 0.1)  # gradient norms under and over the clip


def _trees(seed):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * sc).astype(np.float32)
              for k, s in SHAPES.items()} for sc in SCALES]
    grads[2]["quant"][:] = 0.0  # a parameter without gradient this step
    return params, grads


CASES = {
    "adam": ({"type": "Adam", "lr": 1e-2},
             {"type": "MultiStepLR", "milestones": [2], "gamma": 0.1}, 1.0),
    "adam_betas": ({"type": "Adam", "lr": 3e-3, "betas": (0.8, 0.99),
                    "eps": 1e-6},
                   {"type": "MultiStepLR", "milestones": [1, 3],
                    "gamma": 0.5}, 2.0),
    "adamw": ({"type": "AdamW", "lr": 1e-2, "weight_decay": 0.1},
              {"type": "MultiStepLR", "milestones": [2], "gamma": 0.1}, 1.0),
    "sgd": ({"type": "SGD", "lr": 1e-2, "momentum": 0.9},
            {"type": "MultiStepLR", "milestones": [2], "gamma": 0.1}, None),
    "cosine": ({"type": "Adam", "lr": 1e-2},
               {"type": "CosineLR", "decay_steps": 3, "alpha": 0.1}, 1.0),
    "paramwise": ({"type": "Adam", "lr": 1e-2,
                   "paramwise_opt": [{"key": "dec", "lr_mult": 0.1},
                                     {"key": "enc", "lr_mult": 3.0}]},
                  {"type": "MultiStepLR", "milestones": [2], "gamma": 0.1},
                  1.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_optax_with_a_milestone_and_a_skipped_step(case):
    optim_opt, sched_opt, clip = CASES[case]
    params, grads = _trees(3)
    tx = jax_optimizer(optim_opt, sched_opt, clip)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = tx.init(j_params)
    t_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                for k, v in params.items()}
    opt = build_optimizer(list(t_params.items()), optim_opt, sched_opt, clip)
    for i, g in enumerate(grads):
        skip = i == SKIP
        if not skip:
            upd, j_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                     j_state, j_params)
            j_params = optax.apply_updates(j_params, upd)
        before = ({k: v.detach().clone() for k, v in t_params.items()},
                  {k: v.clone() for k, v in opt.state.items()})
        for k, p in t_params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step(torch.tensor(skip))
        if skip:
            for k, p in t_params.items():
                assert torch.equal(p.detach(), before[0][k]), k
            for k, v in opt.state.items():
                assert torch.equal(v, before[1][k]), k
        for k, p in t_params.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(j_params[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=f"step {i} {k}")
    assert int(opt.state["count"]) == len(grads) - 1


def test_schedule_counts_taken_steps_only():
    """The LR of a step is the schedule at the number of steps taken
    before it, as optax's count: a skipped step does not move a
    milestone."""
    p = torch.nn.Parameter(torch.zeros(3))
    opt = build_optimizer([("p", p)], {"type": "SGD", "lr": 1.0},
                          {"type": "MultiStepLR", "milestones": [2],
                           "gamma": 0.1})
    moved = []
    for skip in (False, True, True, False, False):
        before = p.detach().clone()
        p.grad = torch.ones(3)
        opt.step(torch.tensor(skip))
        moved.append(float((before - p.detach())[0]))
    assert moved == pytest.approx([1.0, 0.0, 0.0, 1.0, 0.1])


def test_nan_gradients_under_skip_leave_the_state():
    p = torch.nn.Parameter(torch.ones(4))
    opt = build_optimizer([("p", p)], {"type": "Adam", "lr": 1e-3}, None, 1.0)
    p.grad = torch.ones(4)
    opt.step(torch.tensor(False))
    state = {k: v.clone() for k, v in opt.state.items()}
    value = p.detach().clone()
    p.grad = torch.full((4,), float("nan"))
    opt.step(torch.tensor(True))
    assert torch.equal(p.detach(), value)
    assert all(torch.equal(opt.state[k], v) for k, v in state.items())


def test_state_dict_round_trip_and_mismatch():
    p = torch.nn.Parameter(torch.ones(4))
    opt = build_optimizer([("p", p)], {"type": "Adam", "lr": 1e-3})
    p.grad = torch.ones(4)
    opt.step()
    other = build_optimizer([("p", torch.nn.Parameter(torch.ones(4)))],
                            {"type": "Adam", "lr": 1e-3})
    other.load_state_dict(opt.state_dict())
    assert all(torch.equal(other.state[k], v) for k, v in opt.state.items())
    wrong = build_optimizer([("p", torch.nn.Parameter(torch.ones(5)))],
                            {"type": "Adam", "lr": 1e-3})
    with pytest.raises(ValueError, match="does not fit"):
        wrong.load_state_dict(opt.state_dict())
    with pytest.raises(ValueError, match="unknown"):
        build_optimizer([("p", p)], {"type": "Lion"})


def test_parameters_live_in_one_aligned_flat_buffer():
    """Each parameter is a view into the optimizer's flat buffer, starting
    512 bytes after the one before it (the padding stays zero), and a step
    updates it in place; a parameter whose ``.grad`` is None counts as a
    zero gradient."""
    a = torch.nn.Parameter(torch.arange(6.0).reshape(2, 3))
    b = torch.nn.Parameter(torch.ones(4))
    c = torch.nn.Parameter(torch.full((2,), 5.0))
    opt = build_optimizer([("a", a), ("b", b), ("c", c)],
                          {"type": "SGD", "lr": 0.5})
    base = opt.flat.data_ptr()
    assert [q.data_ptr() - base for q in (a, b, c)] == [0, 512, 1024]
    assert torch.equal(b.detach(), torch.ones(4))
    for _ in range(2):
        opt.zero_grad()
        (a.sum() + 2 * b.sum()).backward()
        assert c.grad is None
        opt.step(torch.tensor(False))
    assert a.data_ptr() == base
    assert torch.equal(a.detach(), torch.arange(6.0).reshape(2, 3) - 1.0)
    assert torch.equal(b.detach(), torch.full((4,), -1.0))
    assert torch.equal(c.detach(), torch.full((2,), 5.0))
    pad = torch.ones_like(opt.flat, dtype=torch.bool)
    for off, size in zip(opt.offsets, opt.sizes):
        pad[off:off + size] = False
    assert not opt.flat[pad].any() and not opt.state["trace"][pad].any()
