"""The port's node-centered ``GNNLDPCDecoder`` against the flax module of
``ldpc_tpu.models.gnn`` on the same numpy LLRs, ground truth and parameters,
float32: soft bits and loss within 1e-5, gradients against ``jax.grad``
within 1e-5 relative (per parameter, the largest difference over the
largest JAX magnitude), over both type sources, both loss modes and depth
0 and 2 at toy_4x8 Z=4, T=3, and once at nr_2_0_4 Z=4.  The untrained
decoder is min-sum at alpha 1 without freezing; flax checkpoints carry over
through ``convert.load_gnn``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from test_torch_gnn_parity import both_plans, perturbed
from test_torch_parity import bpsk_llrs
from test_torch_train_grad import assert_grads_close, torch_value_and_grad, truth_bits

from ldpc_tpu.models.gnn import GNNLDPCDecoder as JGNN
from ldpc_tpu_torch import convert
from ldpc_tpu_torch.models import (GNNLDPCDecoder, decode_min_sum, make_base_graph_gnn_decoder,
                                   make_gnn_decoder)

ATOL = 1e-5
GRAD_REL = 1e-5


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.partial(jax.jit, static_argnums=0)
def apply_and_grad(model, params, llr, plan, truth):
    """Soft bits, per-frame loss and the gradient of the mean loss, in one
    compile per configuration (the module runs a lax.scan)."""
    def mean_loss(p):
        soft, loss = model.apply(p, llr, plan, truth)
        return loss.mean(), (soft, loss)

    (_, (soft, loss)), grads = jax.value_and_grad(mean_loss, has_aux=True)(params)
    return soft, loss, grads


def gnn_pair(pj, pt, llr: np.ndarray, seed: int = 1, scale: float = 0.1, **kw):
    """(flax module, its params moved by seeded noise, the port's module with
    the same parameters)."""
    mj = JGNN(**kw)
    params = mj.init(jax.random.PRNGKey(seed), jnp.asarray(llr[:2]), pj)
    if scale:
        params = perturbed(params, seed, scale)
    mt = GNNLDPCDecoder(pt, **kw)
    mt.load_state_dict(convert.gnn_state_dict_from_numpy(params), strict=True)
    return mj, params, mt


@pytest.mark.parametrize("depth_L", [0, 2])
@pytest.mark.parametrize("loss_mode", ["max", "mean"])
@pytest.mark.parametrize("type_source", ["shift", "cell"])
def test_forward_and_grads_match_flax(one_thread, type_source, loss_mode, depth_L):
    _, pj, qt, pt = both_plans("toy_4x8", 4)
    llr = bpsk_llrs(qt.num_vars, 5, 1.0, seed=0)
    truth = truth_bits(llr.shape, seed=3)
    mj, params, mt = gnn_pair(pj, pt, llr, num_iterations=3, depth_L=depth_L,
                              type_source=type_source, loss_mode=loss_mode)
    soft_j, loss_j, grads_j = apply_and_grad(mj, params, jnp.asarray(llr), pj,
                                             jnp.asarray(truth))
    with torch.no_grad():
        soft_t, loss_t = mt(torch.from_numpy(llr), pt, torch.from_numpy(truth))
    np.testing.assert_allclose(soft_t.numpy(), np.asarray(soft_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=0, atol=ATOL)
    _, grads_t = torch_value_and_grad(mt, llr, pt, truth)
    assert_grads_close(grads_t, convert.gnn_state_dict_from_numpy(grads_j), GRAD_REL)
    np.testing.assert_array_equal(mt.decode(torch.from_numpy(llr), pt).numpy(),
                                  (np.asarray(soft_j) > 0.5).astype(np.float32))


def test_nr_code_matches_flax(one_thread):
    """A 5G base graph (rows and columns of uneven degree), cell sharing."""
    _, pj, qt, pt = both_plans("nr_2_0_4", 4)
    llr = bpsk_llrs(qt.num_vars, 3, 2.0, seed=1)
    truth = truth_bits(llr.shape, seed=4)
    mj, params, mt = gnn_pair(pj, pt, llr, num_iterations=2, depth_L=2, type_source="cell")
    soft_j, loss_j = mj.apply(params, jnp.asarray(llr), pj, jnp.asarray(truth))
    soft_t, loss_t = mt(torch.from_numpy(llr), pt, torch.from_numpy(truth))
    np.testing.assert_allclose(soft_t.detach().numpy(), np.asarray(soft_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(loss_t.detach().numpy(), np.asarray(loss_j), rtol=0, atol=ATOL)


@pytest.mark.parametrize("type_source", ["shift", "cell"])
def test_untrained_is_min_sum_at_alpha_one(one_thread, type_source):
    """Unit weights and zero taps: the beliefs of min-sum at alpha 1 after T
    iterations, with no frame frozen (the soft bits are the sigmoid of the
    final beliefs, decisions identical)."""
    _, _, qt, pt = both_plans("nr_2_0_4", 4)
    llr = torch.from_numpy(bpsk_llrs(qt.num_vars, 6, 1.0, seed=2))
    model = GNNLDPCDecoder(pt, num_iterations=5, depth_L=2, type_source=type_source)
    soft = model.decode(llr, pt)
    res = decode_min_sum(llr, pt, 5, 1.0)
    with torch.no_grad():
        probs, loss = model(llr, pt)
    assert loss is None
    torch.testing.assert_close(probs, torch.sigmoid(-res.beliefs), rtol=0, atol=1e-6)
    assert torch.equal(soft, (res.beliefs < 0).to(torch.float32))


def test_factories_and_parameter_shapes():
    _, _, qt, pt = both_plans("toy_4x8", 4)
    shift, cell = make_gnn_decoder(pt), make_base_graph_gnn_decoder(pt, 4, 3, loss_mode="mean")
    assert (shift.type_source, shift.num_iterations, shift.depth_L) == ("shift", 5, 2)
    assert (cell.type_source, cell.num_iterations, cell.depth_L, cell.loss_mode) == \
        ("cell", 4, 3, "mean")
    assert shift.w_ch.shape == shift.w_c2v.shape == (pt.num_edge_types,)
    assert cell.w_ch.shape == (pt.K,) and cell.w_res.shape == (3,)
    assert not bool(cell.w_res.any()) and bool((cell.w_c2v == 1).all())
    with pytest.raises(ValueError):
        GNNLDPCDecoder(pt, type_source="edge")
    with pytest.raises(ValueError):
        GNNLDPCDecoder(pt, loss_mode="sum")


def test_flax_checkpoint_loads(one_thread, tmp_path):
    """A flax msgpack written by flax's own serializer reads into the port's
    module (``load_gnn`` and the dispatching ``state_dict_from_flax``) and
    decodes as the flax module does; an unknown entry is refused."""
    _, pj, qt, pt = both_plans("toy_4x8", 4)
    llr = bpsk_llrs(qt.num_vars, 4, 2.0, seed=5)
    mj, params, _ = gnn_pair(pj, pt, llr, seed=2, num_iterations=3, depth_L=2,
                             type_source="cell")
    path = tmp_path / "gnn.msgpack"
    path.write_bytes(serialization.msgpack_serialize(
        {"params": serialization.to_state_dict(params)}))
    mt = make_base_graph_gnn_decoder(pt, 3, 2)
    convert.load_gnn(path, mt)
    soft_j, _ = mj.apply(params, jnp.asarray(llr), pj)
    with torch.no_grad():
        soft_t, _ = mt(torch.from_numpy(llr), pt)
    np.testing.assert_allclose(soft_t.numpy(), np.asarray(soft_j), rtol=0, atol=ATOL)
    tree = convert.read_flax_msgpack(path)["params"]
    assert set(convert.state_dict_from_flax(tree, mt)) == set(mt.state_dict())
    with pytest.raises(KeyError):
        convert.gnn_state_dict_from_numpy({"params": {**tree["params"], "alpha": np.ones(())}})
