"""B6 and B7, the fully-neural ``msg_gnn`` kernels (replace
ldpc_tpu/ops/pallas_gnn.py:137 ``_kernel`` and :295 ``_kernel_v2``): ``_extract``
within 1e-6 of the JAX function; each kernel's plain PyTorch version against
``make_fused_gnn_decoder[_v2](..., interpret=True)`` at toy_4x8 and against
``model.apply`` at nr_2_0_4 Z=4, soft bits within 3e-2 and decisions equal
where the module is confident (tests/test_pallas_gnn.py); the committed
``message_gnn_nr_2_0_4`` checkpoint through the plain version against JAX."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpc_tpu.models.message_gnn as jmg
from ldpc_tpu.ops import pallas_gnn as jpg
from ldpc_tpu_torch import convert
from ldpc_tpu_torch.models import create_message_gnn_decoder
from ldpc_tpu_torch.ops import fused_gnn as tfg
from test_torch_gnn_parity import KERNEL_ATOL, both_plans, model_pair
from test_torch_parity import bpsk_llrs

RESULTS = Path(__file__).resolve().parent.parent / "results"
BUILDERS = {"msg_gnn": (jpg.make_fused_gnn_decoder, tfg.make_fused_gnn_decoder),
            "msg_gnn_v2": (jpg.make_fused_gnn_decoder_v2, tfg.make_fused_gnn_decoder_v2)}


def assert_close_and_confident(got: np.ndarray, want: np.ndarray, atol: float = KERNEL_ATOL):
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    confident = np.abs(want - 0.5) > 0.05
    assert confident.mean() > 0.5  # the check below must actually bite
    assert ((got > 0.5) == (want > 0.5))[confident].all()


@pytest.mark.parametrize("inject,share", [(True, False), (False, True)])
def test_extract_matches_jax(inject, share):
    qj, pj, qt, pt = both_plans("nr_2_0_4", 4)
    llr = bpsk_llrs(qt.num_vars, 2, 1.0, seed=0)
    kw = dict(num_iterations=2, hidden_dim=8, input_injection=inject, share_layers=share)
    _, params, mt = model_pair("create_message_gnn_decoder", pj, pt, llr, **kw)
    want = jpg._extract(params, qj, 2, 8, share, inject)
    got = tfg._extract(mt, qt, 2, 8, share, inject)
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(value), rtol=0, atol=1e-6,
                                   err_msg=key)
    assert got["bias1c"].shape == (2, 8, qt.num_base_edges) and got["h_in"] == (24 if inject
                                                                               else 16)


@pytest.mark.parametrize("kind", list(BUILDERS))
def test_plain_matches_jax_kernel(kind):
    """toy_4x8 Z=4 h=16 T=3 with input injection, in Pallas interpret mode."""
    qj, pj, qt, pt = both_plans("toy_4x8", 4)
    llr = bpsk_llrs(qt.num_vars, 5, 2.0, seed=1)
    kw = dict(num_iterations=3, hidden_dim=16, input_injection=True)
    mj, params, mt = model_pair("create_message_gnn_decoder", pj, pt, llr, **kw)
    jbuild, tbuild = BUILDERS[kind]
    want = np.asarray(jbuild(qj, params, interpret=True, **kw)(jnp.asarray(llr)))
    launches = dict(tfg.LAUNCHES)
    got = tbuild(qt, mt, device="cpu", **kw)(torch.from_numpy(llr))
    assert tfg.LAUNCHES == launches  # a CPU tensor never reaches a kernel
    assert got.shape == llr.shape and got.dtype == torch.float32
    # The same function up to the summation order inside the products.
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    soft_module = np.asarray(mj.apply(params, jnp.asarray(llr), pj)[0])
    assert_close_and_confident(got.numpy(), soft_module)


@pytest.mark.parametrize("kind", list(BUILDERS))
@pytest.mark.parametrize("inject,share", [(True, False), (False, False), (True, True)])
def test_plain_matches_module(kind, inject, share):
    """A 5G base graph against ``model.apply``, at the JAX package's own
    configuration for this bar (h=16, T=3: tests/test_pallas_gnn.py; h=64 is
    held on the trained checkpoint below); a state_dict builds the same
    decoder as the module."""
    _, pj, qt, pt = both_plans("nr_2_0_4", 4)
    llr = bpsk_llrs(qt.num_vars, 4, 2.0, seed=2)
    kw = dict(num_iterations=3, hidden_dim=16, input_injection=inject, share_layers=share)
    mj, params, mt = model_pair("create_message_gnn_decoder", pj, pt, llr, seed=4, **kw)
    soft_module = np.asarray(mj.apply(params, jnp.asarray(llr), pj)[0])
    dec = BUILDERS[kind][1](qt, mt, device="cpu", **kw)
    got = dec(torch.from_numpy(llr)).numpy()
    assert_close_and_confident(got, soft_module)
    sd = BUILDERS[kind][1](qt, mt.state_dict(), device="cpu", **kw)
    np.testing.assert_array_equal(sd(torch.from_numpy(llr)).numpy(), got)


def test_v2_matches_v1():
    """B7 moves one bf16 rounding of B6: within 2e-2 of each other."""
    _, pj, qt, pt = both_plans("nr_2_0_4", 4)
    llr = torch.from_numpy(bpsk_llrs(qt.num_vars, 4, 1.0, seed=3))
    kw = dict(num_iterations=3, hidden_dim=16, input_injection=True)
    _, _, mt = model_pair("create_message_gnn_decoder", pj, pt, llr.numpy(), seed=6, **kw)
    v1 = tfg.make_fused_gnn_decoder(qt, mt, device="cpu", **kw)(llr)
    v2 = tfg.make_fused_gnn_decoder_v2(qt, mt, device="cpu", mm_group=3, **kw)(llr)
    diff = (v1 - v2).abs().max().item()
    assert 0 < diff <= 2e-2


def test_trained_checkpoint_matches_jax():
    """results/message_gnn_nr_2_0_4.msgpack (h=64, T=5, input injection),
    read by the port's reader, through both plain versions against the flax
    module with the flax reader's parameters."""
    from flax import serialization

    _, pj, qt, pt = both_plans("nr_2_0_4", 4)
    llr = bpsk_llrs(qt.num_vars, 4, 1.0, seed=5)
    kw = dict(num_iterations=5, hidden_dim=64, input_injection=True)
    mj = jmg.create_message_gnn_decoder(pj, **kw)
    template = mj.init(jax.random.PRNGKey(0), jnp.asarray(llr[:2]), pj)
    payload = serialization.msgpack_restore(
        (RESULTS / "message_gnn_nr_2_0_4.msgpack").read_bytes())
    params = serialization.from_state_dict(template, payload["params"])
    soft_module = np.asarray(mj.apply(params, jnp.asarray(llr), pj)[0])
    mt = create_message_gnn_decoder(pt, **kw)
    convert.load_message_gnn(RESULTS / "message_gnn_nr_2_0_4.msgpack", mt)
    for kind, (_, tbuild) in BUILDERS.items():
        got = tbuild(qt, mt, device="cpu", **kw)(torch.from_numpy(llr)).numpy()
        assert_close_and_confident(got, soft_module)


def test_plans_and_raising_paths():
    """Shared memory and scratch follow the kernel's layout; a width without
    a kernel instantiation raises, and so does the card without a card."""
    _, _, qt, pt = both_plans("nr_2_0_32", 32)
    K, C, R, n = qt.num_base_edges, qt.num_base_cols, qt.num_base_rows, qt.num_vars
    words = (6 * K + R + C + 2 + 3) // 4 * 4 + (C + R + 3) // 4 * 4 + n + 196 + 128 \
        + 4 * 64 * 64 + 64 * 256
    assert tfg.msg_gnn_smem_bytes(qt, 64) == 4 * words
    assert tfg.msg_gnn_scratch_floats(qt, 64, False) == (C + R) * 32 * 64 + K * 32 * 32
    assert tfg.msg_gnn_scratch_floats(qt, 64, True) == (3 * C + R) * 32 * 64 + K * 32 * 32
    model = create_message_gnn_decoder(pt, num_iterations=2, hidden_dim=32)
    with pytest.raises(ValueError, match="hidden_dim in"):
        tfg.make_fused_gnn_decoder(qt, model, 2, 32, device="cpu")
    model = create_message_gnn_decoder(pt, num_iterations=2, hidden_dim=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfg.make_fused_gnn_decoder_v2(qt, model, 2, 16)
