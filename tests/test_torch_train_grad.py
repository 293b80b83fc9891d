"""What training differentiates: the port's autograd gradients against
``jax.grad`` of the flax modules, on the same numpy LLRs, ground truth and
parameters, float32, toy_4x8 Z=4, T=2 (message GNN) and 3 (neural min-sum),
h=16.

* ``MessageGNNDecoder``, all five factories, each plain, with injection and
  multiloss, and with shared layers: loss within 1e-5, every parameter's
  gradient within 4e-5 relative.
* ``NeuralMinSumDecoder`` with every weight sharing, per-iteration weights
  on and off, learnable alpha and offset: within 1.1e-6 relative; the same
  on quantised LLRs, whose tied minimums split their gradient evenly on both
  sides (``jnp.min`` and ``torch.amin``).
* ``remat=True`` (``torch.utils.checkpoint``) changes nothing: the same
  parameter names, an identical forward, gradients within rtol 1e-5 and
  atol 1e-6 (the bar ``tests/test_message_gnn.py`` holds ``nn.remat`` to).

"Relative" is per parameter tensor: the largest difference over the largest
magnitude of the JAX gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gnn_parity import FACTORIES, both_plans, model_pair
from test_torch_neural_min_sum import nms_pair
from test_torch_parity import bpsk_llrs

import ldpc_tpu_torch.models.message_gnn as tmg
from ldpc_tpu_torch import convert

MSG_REL = 4e-5
NMS_REL = 1.1e-6
LOSS_ATOL = 1e-5
MSG_OPTIONS = [{}, {"input_injection": True, "multiloss": True}, {"share_layers": True}]
MSG_IDS = ["plain", "inject_multiloss", "shared"]
SHARINGS = ("edge", "cell", "type", "scalar")


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_value_and_grad(model, params, llr, plan, truth):
    """Mean per-frame loss of the flax module and its gradient tree, op by
    op: a message-GNN case takes about 0.2-0.3 s so, where compiling it
    under ``jax.jit`` takes 0.85-1.2 s, and every case has its own module."""
    return jax.value_and_grad(lambda p: model.apply(p, llr, plan, truth)[1].mean())(params)


# The neural min-sum module runs a lax.scan, which compiles even op by op:
# one compile per configuration, reused by its noise and its tied-minimum case.
jitted_value_and_grad = jax.jit(jax_value_and_grad, static_argnums=0)


def torch_value_and_grad(model, llr: np.ndarray, plan, truth: np.ndarray):
    """The port's mean loss and each named parameter's gradient (zeros where
    a parameter gets none), as numpy."""
    model.zero_grad(set_to_none=True)
    _, loss = model(torch.from_numpy(llr), plan, torch.from_numpy(truth))
    loss = loss.mean()
    loss.backward()
    grads = {name: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for name, p in model.named_parameters()}
    return float(loss.detach()), grads


def assert_grads_close(got: dict, want: dict, rel: float) -> float:
    """Every gradient within ``rel`` of the largest magnitude of its JAX
    counterpart; returns the worst ratio."""
    assert set(got) == set(want)
    worst = 0.0
    for name, w in want.items():
        w = np.asarray(w, dtype=np.float32)
        g = got[name]
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max(initial=0.0)), 1e-12)
        err = float(np.abs(g - w).max(initial=0.0)) / scale
        assert err <= rel, f"{name}: gradient differs by {err:.3g} relative"
        worst = max(worst, err)
    return worst


def truth_bits(shape, seed: int = 1) -> np.ndarray:
    return (np.random.default_rng(seed).random(shape) < 0.1).astype(np.float32)


@pytest.mark.parametrize("options", MSG_OPTIONS, ids=MSG_IDS)
@pytest.mark.parametrize("factory", FACTORIES)
def test_message_gnn_grads_match_jax(one_thread, factory, options):
    _, pj, qt, pt = both_plans("toy_4x8", 4)
    llr = bpsk_llrs(qt.num_vars, 4, 1.0, seed=0)
    truth = truth_bits(llr.shape)
    mj, params, mt = model_pair(factory, pj, pt, llr, num_iterations=2, hidden_dim=16,
                                compute_dtype="float32", **options)
    loss_j, grads_j = jax_value_and_grad(mj, params, jnp.asarray(llr), pj, jnp.asarray(truth))
    loss_t, grads_t = torch_value_and_grad(mt, llr, pt, truth)
    assert abs(loss_t - float(loss_j)) <= LOSS_ATOL
    assert_grads_close(grads_t, convert.message_gnn_state_dict_from_numpy(grads_j), MSG_REL)


def _nms_case(sharing: str, per_iteration: bool, quantise: bool = False) -> float:
    _, pj, qt, pt = both_plans("toy_4x8", 4)
    llr = bpsk_llrs(qt.num_vars, 4, 1.0, seed=4)
    if quantise:  # integer LLRs: equal magnitudes within a frame
        llr = np.round(llr).astype(np.float32)
        assert all(len(np.unique(np.abs(frame))) < frame.size for frame in llr)
    truth = truth_bits(llr.shape, seed=2)
    mj, params, mt = nms_pair(pj, pt, llr, seed=3, num_iterations=3, depth_L=2,
                              weight_sharing=sharing, learnable_alpha=True,
                              learnable_offset=True, per_iteration=per_iteration)
    loss_j, grads_j = jitted_value_and_grad(mj, params, jnp.asarray(llr), pj,
                                            jnp.asarray(truth))
    loss_t, grads_t = torch_value_and_grad(mt, llr, pt, truth)
    assert abs(loss_t - float(loss_j)) <= LOSS_ATOL
    return assert_grads_close(grads_t, convert.neural_min_sum_state_dict_from_numpy(grads_j),
                              NMS_REL)


@pytest.mark.parametrize("per_iteration", [False, True])
@pytest.mark.parametrize("sharing", SHARINGS)
def test_neural_min_sum_grads_match_jax(one_thread, sharing, per_iteration):
    _nms_case(sharing, per_iteration)


@pytest.mark.parametrize("per_iteration", [False, True])
@pytest.mark.parametrize("sharing", SHARINGS)
def test_neural_min_sum_grads_on_tied_minimums(one_thread, sharing, per_iteration):
    """Integer LLRs, whose tied minimums both frameworks split evenly."""
    _nms_case(sharing, per_iteration, quantise=True)


@pytest.mark.parametrize("factory", FACTORIES)
def test_remat_is_transparent(one_thread, factory):
    """The same parameters with and without remat: names equal, soft bits
    and loss identical, gradients within rtol 1e-5, atol 1e-6 (bf16 compute,
    multiloss)."""
    _, _, qt, pt = both_plans("toy_4x8", 4)
    llr = torch.from_numpy(bpsk_llrs(qt.num_vars, 4, 1.0, seed=6))
    truth = torch.from_numpy(truth_bits(tuple(llr.shape), seed=7))
    kw = dict(num_iterations=3, hidden_dim=8, multiloss=True, input_injection=True)
    base = getattr(tmg, factory)(pt, generator=torch.Generator().manual_seed(1), **kw)
    rmt = getattr(tmg, factory)(pt, remat=True, **kw)
    assert rmt.remat and not base.remat
    assert list(base.state_dict()) == list(rmt.state_dict())
    with torch.no_grad():  # move the zero projections so every layer matters
        for p in base.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    rmt.load_state_dict(base.state_dict(), strict=True)
    outs, grads = [], []
    for model in (base, rmt):
        model.zero_grad(set_to_none=True)
        soft, loss = model(llr, pt, truth)
        loss.mean().backward()
        outs.append((soft.detach(), loss.detach()))
        grads.append({n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                      for n, p in model.named_parameters()})
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=1e-5, atol=1e-6)
    # without gradients remat takes the plain call
    with torch.no_grad():
        torch.testing.assert_close(rmt(llr, pt)[0], base(llr, pt)[0], rtol=0, atol=0)
