"""B3, the ``fused_neural`` and ``neural_group`` kernels (replace
ldpc_tpu/ops/pallas_neural.py:111 ``kernel``): ``_pack_weights`` equal to
the JAX function's; the kernels' plain PyTorch version against
``make_fused_neural_minsum(..., interpret=True)`` at toy_4x8 (depth 0, 1,
4 and 6) and on rows of 31 and 64 members at Z=4 (the routes of the 64-bit
and 128-bit state words), and against ``model.apply`` at nr_2_0_4 Z=4
(depth 1, 2 and 4), toy_4x8 Z=32 and nr_2_0_32 Z=128 (the slice form's
shape), bits identical (the JAX package's own bar,
tests/test_pallas_neural.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu.codes as jcodes
from ldpc_tpu.ops import pallas_neural as jpn
from ldpc_tpu.ops import qc_msg as jqc
import ldpc_tpu_torch.codes as tcodes
from ldpc_tpu_torch.ops import fused_neural as tfn
from ldpc_tpu_torch.ops import qc_msg as tqc
from test_torch_neural_group import row_shifts
from test_torch_neural_min_sum import FLAG_CASES, nms_pair, plans
from test_torch_parity import bpsk_llrs


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: the suite's workers run side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def flags(sharing, depth, learn_a, learn_o, per_it, T=3):
    return dict(num_iterations=T, depth_L=depth, weight_sharing=sharing,
                learnable_alpha=learn_a, learnable_offset=learn_o, per_iteration=per_it)


@pytest.mark.parametrize("sharing,depth,learn_a,learn_o,per_it", FLAG_CASES)
def test_pack_weights_matches_jax(sharing, depth, learn_a, learn_o, per_it):
    """From the flax tree, the port's module and its state_dict alike."""
    qj, pj, qt, pt = plans("nr_2_0_4", 4)
    llr = bpsk_llrs(qt.num_vars, 2, 1.0, seed=0)
    kw = flags(sharing, depth, learn_a, learn_o, per_it)
    _, params, mt = nms_pair(pj, pt, llr, **kw)
    want = jpn._pack_weights(qj, params, 3, depth, per_it)
    for source in (params, mt, mt.state_dict()):
        got = tfn._pack_weights(qt, source, 3, depth, per_it)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("sharing,depth,learn_a,learn_o,per_it",
                         [FLAG_CASES[0], FLAG_CASES[3], ("edge", 4, True, True, True),
                          ("edge", 6, True, True, True)])
def test_plain_matches_jax_kernel(sharing, depth, learn_a, learn_o, per_it):
    """The JAX kernel in Pallas interpret mode, on a batch that is not a
    multiple of its batch tile; depths 4 and 6 (neural_group's run-time-depth
    form) over depth + 2 iterations, so that every tap of the FIFO reaches
    the decisions."""
    qj, pj, qt, pt = plans("toy_4x8", 4)
    llr = bpsk_llrs(qt.num_vars, 11, 1.0, seed=1)
    T = depth + 2 if depth >= 4 else 3
    kw = flags(sharing, depth, learn_a, learn_o, per_it, T=T)
    _, params, mt = nms_pair(pj, pt, llr, seed=2, **kw)
    want = jpn.make_fused_neural_minsum(qj, params, T, depth, batch_tile=8, interpret=True,
                                        per_iteration=per_it)(jnp.asarray(llr))
    launches = dict(tfn.LAUNCHES)
    dec = tfn.make_fused_neural_minsum(qt, mt, T, depth, per_iteration=per_it, device="cpu")
    got = dec(torch.from_numpy(llr))
    assert tfn.LAUNCHES == launches  # a CPU tensor never reaches the kernel
    assert got.shape == llr.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.numpy().mean() < 0.5  # some decisions are wrong, not all


@pytest.mark.parametrize("members,depth,T,route", [(31, 2, 4, "neural_group_wide"),
                                                 (64, 3, 5, "neural_group_w128")])
def test_plain_matches_jax_kernel_on_wide_rows(members, depth, T, route):
    """Rows of 31 and 64 members at Z=4 (more signs than the 32-bit and the
    64-bit state words hold): the plain version behind neural_group_wide and
    neural_group_w128 against the JAX kernel in interpret mode, edge weights
    and every parameter per iteration, bits identical."""
    shifts = row_shifts(members)
    qj = jcodes.qc_layout(jcodes.BaseGraph(f"row{members}", shifts), 4)
    qt = tcodes.qc_layout(tcodes.BaseGraph(f"row{members}", shifts), 4)
    pj, pt = jqc.make_plan(qj), tqc.make_plan(qt, "cpu")
    llr = bpsk_llrs(qt.num_vars, 11, 1.0, seed=members)
    kw = flags("edge", depth, True, True, True, T=T)
    _, params, mt = nms_pair(pj, pt, llr, seed=members, **kw)
    want = jpn.make_fused_neural_minsum(qj, params, T, depth, batch_tile=8, interpret=True,
                                        per_iteration=True)(jnp.asarray(llr))
    launches = dict(tfn.LAUNCHES)
    dec = tfn.make_fused_neural_minsum(qt, mt, T, depth, per_iteration=True, device="cpu")
    assert qt.dr_max == members and dec.route == route
    got = dec(torch.from_numpy(llr))
    assert tfn.LAUNCHES == launches
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.numpy().mean() < 0.5


@pytest.mark.parametrize("name,Z,case", [("nr_2_0_4", 4, FLAG_CASES[1]),
                                         ("nr_2_0_4", 4, FLAG_CASES[2]),
                                         ("nr_2_0_4", 4, FLAG_CASES[3]),
                                         ("toy_4x8", 32, ("edge", 2, True, True, True)),
                                         ("nr_2_0_32", 128, ("edge", 2, True, True, True)),
                                         ("nr_2_0_4", 4, ("edge", 4, True, True, True))])
def test_plain_matches_module(name, Z, case):
    """Bits identical to ``model.decode`` of the flax module, at a 5G base
    graph and at the production lifting Z=32 (per-iteration offset min-sum,
    edge sharing, as the committed Z=32 checkpoint), at nr_2_0_32 Z=128
    (neural_group's slice form) and at depth 4 over 6 iterations."""
    _, pj, qt, pt = plans(name, Z)
    llr = bpsk_llrs(qt.num_vars, 8, 1.5, seed=4)
    T = 6 if case[1] == 4 else 4
    kw = flags(*case, T=T)
    mj, params, mt = nms_pair(pj, pt, llr, seed=5, **kw)
    want = np.asarray(mj.decode(params, jnp.asarray(llr), pj))
    dec = tfn.make_fused_neural_minsum(qt, mt, T, case[1], per_iteration=case[4], device="cpu")
    assert dec.route == "neural_group"
    got = dec(torch.from_numpy(llr)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(dec.plain(torch.from_numpy(llr)).numpy(), got)


def test_unit_weights_are_plain_min_sum():
    """w_ch 1, no taps, alpha 1, offset 0: the decisions of fused min-sum at
    alpha 1 (the plain versions agree here, though they add in another order)."""
    from ldpc_tpu_torch.models import NeuralMinSumDecoder
    from ldpc_tpu_torch.ops import fused_minsum as tfm

    _, _, qt, pt = plans("nr_2_0_4", 4)
    llr = torch.from_numpy(bpsk_llrs(qt.num_vars, 16, 1.0, seed=6))
    model = NeuralMinSumDecoder(pt, num_iterations=6, depth_L=0, weight_sharing="scalar")
    bits = tfn.make_fused_neural_minsum(qt, model, 6, 0, device="cpu")(llr)
    want, _ = tfm.make_fused_minsum(qt, 6, 1.0, track_convergence=False, device="cpu")(llr)
    np.testing.assert_array_equal(bits.numpy(), want.numpy())


def test_shared_memory_plan():
    """Frames per block keep 512 threads busy while they fit; above about
    Z=100 at depth 2 the state moves to global scratch; the byte counts
    follow the kernel's layout."""
    import ldpc_tpu_torch.codes as tcodes

    small = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_4"), 4)
    assert tfn.neural_plan(small, 5, 2) == (True, 4)
    z32 = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 32)
    assert tfn.neural_plan(z32, 10, 2) == (True, 1)
    E, n = z32.num_edges, z32.num_vars
    graph = 4 * 197 + 42 + 52 + 2
    assert tfn.neural_smem_bytes(z32, 10, 2, 1) == 4 * (graph + 40 + n + 3 * E)
    z128 = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 128)
    assert tfn.neural_plan(z128, 10, 2) == (False, 1)
    assert tfn.neural_smem_bytes(z128, 10, 2, 1, shared=False) == 4 * (graph + 40
                                                                       + z128.num_vars)


def test_entry_points_raise():
    _, _, qt, pt = plans("toy_4x8", 4)
    from ldpc_tpu_torch.models import NeuralMinSumDecoder

    model = NeuralMinSumDecoder(pt, num_iterations=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfn.make_fused_neural_minsum(qt, model, 3, 2)
    dec = tfn.make_fused_neural_minsum(qt, model, 3, 2, device="cpu")
    with pytest.raises(ValueError, match=r"llr must be \(B, 32\)"):
        dec(torch.zeros((2, 5)))
    with pytest.raises(TypeError, match="float32"):
        dec(torch.zeros((2, qt.num_vars), dtype=torch.float64))
    with pytest.raises(ValueError, match="num_iterations"):
        tfn.make_fused_neural_minsum(qt, model, 0, 2, device="cpu")
    with pytest.raises(ValueError, match="unsupported w_ch shape"):
        tfn._pack_weights(qt, {"w_ch": np.ones((2, 2, 2, 2))}, 3, 2, False)
    assert jax.default_backend() == "cpu"
