"""B7 and B9 at hidden width 128 (csrc/fused_msg_gnn_tc.cu
``msg_gnn_wide_tc_kernel``, replacing ldpc_tpu/ops/pallas_gnn.py:295
``_kernel_v2`` and :952 ``_kernel_v4`` at h=128) on the CPU.

* The plain versions against the JAX builders in Pallas interpret mode at
  toy_4x8, T=2, and the h=128 sweep checkpoints through the plain versions
  against the flax module's ``apply``: soft bits within 3e-2 and the
  confident decisions equal, the JAX package's bar.
* The kernel's order of sums (``wg_model`` of
  ``tests/test_torch_msg_gnn_wide_wg.py``: 64-message warpgroup tiles, the
  layer's weights in chunks of ``WIDE_CHUNK`` hidden units as the wrapper
  packs them, each chunk's first layer as four products added with b1 in
  the plain version's order, the second layer chunk by chunk in one
  accumulator) on the exact inputs of ``ops/msg_gnn_exact.py`` at h=128
  (``EXACT_WIDE_CASES``): the plain version's soft bits exactly, every sum
  checked exact in any order (the weights' quantum of 1/128 keeps the
  argument of ``ops/msg_gnn_exact.py``).
* The streamed packing, the width gate, the plans, the ported ft-floor tool
  and the kernel bench at h=128, on one torch thread: under several test
  workers torch's thread pools contend.
"""
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from test_torch_gnn_parity import both_plans, model_pair
from test_torch_msg_gnn_fused import assert_close_and_confident
from test_torch_msg_gnn_tc import _r
from test_torch_msg_gnn_wide_wg import unpack_wg_chunks, wg_model
from test_torch_parity import bpsk_llrs

import ldpc_tpu.models.message_gnn as jmg
from ldpc_tpu.ops import pallas_gnn as jpg
from ldpc_tpu_torch import convert
from ldpc_tpu_torch.codes import get_base_graph, qc_layout
from ldpc_tpu_torch.models import create_corrected_minsum_gnn_decoder, create_message_gnn_decoder
from ldpc_tpu_torch.ops import fused_gnn as fg, qc_msg
from ldpc_tpu_torch.ops.msg_gnn_exact import EXACT_WIDE_CASES, exact_msg_gnn_case
from ldpc_tpu_torch.tools import bench_gnn_kernel, eval_ft_floor

RESULTS = Path(__file__).resolve().parent.parent / "results"
H = 128
BUILDERS = {"msg_gnn_v2": (jpg.make_fused_gnn_decoder_v2, fg.make_fused_gnn_decoder_v2),
            "msg_gnn_v4": (jpg.make_fused_gnn_decoder_v4, fg.make_fused_gnn_decoder_v4)}


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# The plain versions against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", list(BUILDERS))
@pytest.mark.parametrize("inject", [False, True])
def test_plain_matches_jax_kernel(one_thread, kind, inject):
    """toy_4x8 Z=4, h=128, T=2, the JAX builder in Pallas interpret mode."""
    qj, pj, qt, pt = both_plans("toy_4x8", 4)
    llr = bpsk_llrs(qt.num_vars, 5, 2.0, seed=11)
    kw = dict(num_iterations=2, hidden_dim=H, input_injection=inject)
    _, params, mt = model_pair("create_message_gnn_decoder", pj, pt, llr, **kw)
    jbuild, tbuild = BUILDERS[kind]
    want = np.asarray(jbuild(qj, params, interpret=True, **kw)(jnp.asarray(llr)))
    launches = dict(fg.LAUNCHES)
    got = tbuild(qt, mt, device="cpu", **kw)(torch.from_numpy(llr))
    assert fg.LAUNCHES == launches  # a CPU tensor never reaches a kernel
    assert got.shape == llr.shape and got.dtype == torch.float32
    assert_close_and_confident(got.numpy(), want)


@functools.lru_cache(maxsize=None)
def _checkpoint_case(name: str, T: int):
    """(port layout, port module, LLRs, the flax module's soft bits) of an
    h=128 sweep checkpoint on four nr_2_0_4 frames at 1 dB; the flax module
    applied once, jitted."""
    _, pj, qt, pt = both_plans("nr_2_0_4", 4)
    llr = bpsk_llrs(qt.num_vars, 4, 1.0, seed=7)
    kw = dict(num_iterations=T, hidden_dim=H, input_injection=True, multiloss=True)
    mj = jmg.create_message_gnn_decoder(pj, **kw)
    template = mj.init(jax.random.PRNGKey(0), jnp.asarray(llr[:2]), pj)
    payload = serialization.msgpack_restore((RESULTS / name).read_bytes())
    params = serialization.from_state_dict(template, payload["params"])
    soft = np.asarray(jax.jit(lambda p, x: mj.apply(p, x, pj)[0])(params, jnp.asarray(llr)))
    mt = create_message_gnn_decoder(pt, **kw)
    convert.load_message_gnn(RESULTS / name, mt)
    return qt, mt, llr, soft


# On the T=5 checkpoint's frames the JAX package's own B7 (interpret mode, on
# the flax reader's parameters) lies 2.91e-2 from the module, and the plain
# B7 3.5e-3 from it (tests/test_torch_msg_gnn_wide_witness.py, apart for its
# 20 s compile): the fused function rounds to bf16 where the module does
# not, and at h=128 such flips carry through five layers.  So that
# checkpoint is held within 4e-2, the T=10 one to the 3e-2 bar; the
# confident decisions equal in both.
CHECKPOINT_ATOL = {"gnn_sweep_h128_t10_ft.msgpack": 3e-2, "gnn_sweep_h128_t5.msgpack": 4e-2}


@pytest.mark.parametrize("kind", list(BUILDERS))
@pytest.mark.parametrize("name,T", [("gnn_sweep_h128_t10_ft.msgpack", 10),
                                    ("gnn_sweep_h128_t5.msgpack", 5)])
def test_checkpoint_matches_flax_module(one_thread, kind, name, T):
    """The h=128 sweep checkpoints, read by the port's reader, through both
    plain versions against the flax module with the flax reader's
    parameters: soft bits within CHECKPOINT_ATOL, decisions equal where the
    module is confident."""
    qt, mt, llr, soft = _checkpoint_case(name, T)
    got = BUILDERS[kind][1](qt, mt, T, H, input_injection=True, device="cpu")(
        torch.from_numpy(llr))
    assert_close_and_confident(got.numpy(), soft, atol=CHECKPOINT_ATOL[name])


# ---------------------------------------------------------------------------
# The kernel's order of sums (wg_model)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", list(BUILDERS))
@pytest.mark.parametrize("code,Z,h,batch,inject,share", EXACT_WIDE_CASES)
def test_chunk_model_equals_plain_on_exact_inputs(one_thread, kind, code, Z, h, batch, inject,
                                                  share):
    """The streamed chunks, the 64-message warpgroup tiles, the four
    first-layer products a chunk and the per-chunk second layer (wg_model)
    give the plain version's soft bits exactly; the decode is not trivial
    (both decisions present, soft bits not all saturated)."""
    qc = qc_layout(get_base_graph(code), Z)
    model, llr = exact_msg_gnn_case(qc, h, batch, inject, share)
    dec = BUILDERS[kind][1](qc, model, 2, h, share_layers=share, input_injection=inject,
                            device="cpu")
    x = torch.from_numpy(llr)
    plain = dec(x)
    assert torch.equal(wg_model(dec, x), plain)
    decided = plain > 0.5
    assert decided.any() and (~decided).any()
    assert ((plain - 0.5).abs() < 0.45).float().mean() > 0.05


def test_chunk_model_b9_last_layer_alone(one_thread):
    """B9 at T=1: its thin last layer chunk by chunk, with no proj8 . f."""
    qc = qc_layout(get_base_graph("nr_2_0_4"), 4)
    model, llr = exact_msg_gnn_case(qc, H, 5, True, False, num_iterations=1)
    dec = fg.make_fused_gnn_decoder_v4(qc, model, 1, H, input_injection=True, device="cpu")
    x = torch.from_numpy(llr)
    assert torch.equal(wg_model(dec, x), dec(x))


# ---------------------------------------------------------------------------
# Packing, width gate, plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("inject", [False, True])
@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_pack_streamed_round_trip(inject, kind):
    """Each chunk holds, in core-matrix order, [W1vf; W1cf] of its units
    (their f columns, W1v's rows then W1c's), W1va and W1ca of its units,
    with injection [W1vl; W1cl], then [W2v W2c] cut to its units' columns;
    no padding.  B7 and B9 stream the same layout."""
    T = 2
    w = _r(torch.from_numpy(np.random.default_rng(int(inject)).standard_normal(
        (T, 8, H, H), np.float32)))
    packed = fg.pack_tc_weights(w, inject, kind)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    # _MsgTables order: va, ca, vl, cl, vf, cf, W2v, W2c
    for c, m in enumerate(unpack_wg_chunks(packed, H, inject)):
        u = slice(c * fg.WIDE_CHUNK, (c + 1) * fg.WIDE_CHUNK)
        assert torch.equal(m["W1f"], torch.cat([w[:, 4][:, u], w[:, 5][:, u]], dim=1))
        assert torch.equal(m["W1va"], w[:, 0][:, u]) and torch.equal(m["W1ca"], w[:, 1][:, u])
        assert ("W1l" in m) == inject
        if inject:
            assert torch.equal(m["W1l"], torch.cat([w[:, 2][:, u], w[:, 3][:, u]], dim=1))
        assert torch.equal(m["W2"], torch.cat([w[:, 6][:, :, u], w[:, 7][:, :, u]], dim=2))
    assert fg.tc_chunk_elems(H, inject) == (8 if inject else 6) * fg.WIDE_CHUNK * H
    with pytest.raises(ValueError, match="no streamed layout"):
        fg.pack_tc_weights(w, inject, "msg_gnn_v3")


def test_width_gate(one_thread):
    """B7 and B9 build at h=128 (and decode on the CPU through their plain
    versions); h=32 still raises for every kernel, and so do B4, B5, B6 and
    B8 at h=128, with the width set in the message."""
    qc = qc_layout(get_base_graph("toy_4x8"), 4)
    plan = qc_msg.make_plan(qc, device="cpu")
    llr = torch.zeros((2, qc.num_vars))
    for inject in (False, True):
        model = create_message_gnn_decoder(plan, num_iterations=2, hidden_dim=H,
                                           input_injection=inject)
        for kind in BUILDERS:
            dec = BUILDERS[kind][1](qc, model, 2, H, input_injection=inject, device="cpu")
            assert dec(llr).shape == llr.shape
        for build in (fg.make_fused_gnn_decoder, fg.make_fused_gnn_decoder_v3):
            with pytest.raises(ValueError, match=r"hidden_dim in \(16, 64\), got 128"):
                build(qc, model, 2, H, input_injection=inject, device="cpu")
    corrected = create_corrected_minsum_gnn_decoder(plan, num_iterations=2, hidden_dim=H)
    for build in (fg.make_fused_corrected_gnn_decoder, fg.make_fused_corrected_gnn_decoder_v2):
        with pytest.raises(ValueError, match="hidden_dim in"):
            build(qc, corrected, 2, H, device="cpu")
    model = create_message_gnn_decoder(plan, num_iterations=2, hidden_dim=32)
    for kind in ("msg_gnn_v2", "msg_gnn_v4"):
        with pytest.raises(ValueError, match=r"hidden_dim in \(16, 64, 128\), got 32"):
            BUILDERS[kind][1](qc, model, 2, 32, device="cpu")
    assert {k: v for k, v in fg.KERNEL_HIDDEN_DIMS.items() if H in v} == {
        "msg_gnn_v2": (16, 64, 128), "msg_gnn_v4": (16, 64, 128)}


def test_wide_plans():
    """Shared memory of the h=128 kernels (make_layout): the state, the ring
    of two weight chunks, one tile buffer a whole warpgroup (f, vmean, rmean
    and with injection lf of 64 messages) and the ring's barriers; scratch
    as at the other widths."""
    qc = qc_layout(get_base_graph("nr_2_0_4"), 4)
    K, C, R, Z = qc.num_base_edges, qc.num_base_cols, qc.num_base_rows, qc.Z
    state = 4 * ((6 * K + R + C + 2 + 3) // 4 * 4 + (C + R + 3) // 4 * 4 + C * Z + 388)
    chunk_inj = 2 * 16 * 128 + 16 * 128 + 16 * 128 + 2 * 16 * 128 + 128 * 32  # bf16
    assert fg.tc_chunk_elems(H, True) == chunk_inj == 16_384
    tile = 4 * 64 * 128 * 2  # features, vmean, rmean, lf rows of one tile buffer, bytes
    for kind, small in (("msg_gnn_v2", 128), ("msg_gnn_v4", 384)):
        for warps in (4, 8):
            assert fg.msg_gnn_smem_bytes(qc, H, kind, True, warps) == \
                state + 4 * small + 2 * 2 * chunk_inj + warps // 4 * tile + 32
    assert fg.msg_gnn_smem_bytes(qc, H, "msg_gnn_v2", True, 4) == 139_504
    assert fg.msg_gnn_smem_bytes(qc, H, "msg_gnn_v2", True, 8) == 205_040
    assert fg.msg_gnn_smem_bytes(qc, H, "msg_gnn_v4", False, 8) == 156_912
    assert fg.msg_gnn_scratch_floats(qc, H, "msg_gnn_v2") * 4 == (K + C + R) * Z * H * 2 == 297_984
    qc32 = qc_layout(get_base_graph("nr_2_0_32"), 32)
    assert fg.msg_gnn_scratch_floats(qc32, H, "msg_gnn_v2") * 4 == 2_383_872
    assert fg.msg_gnn_scratch_floats(qc32, H, "msg_gnn_v4") * 4 == 2_383_872 + 4 * 6304


# ---------------------------------------------------------------------------
# The tools at h=128
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ft_floor(tmp_path_factory):
    """(argv, result) of the ported ft-floor tool at one trial of three
    frames at 0 and 1 dB on the CPU (B7's plain version), run once for the
    tests that read it, on one torch thread."""
    out = tmp_path_factory.mktemp("ft_floor") / "floor.json"
    argv = ["--device", "cpu", "--trials", "1", "--batch", "3", "--snrs", "0,1", "--out", str(out)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        launches = dict(fg.LAUNCHES)
        got = eval_ft_floor.main(argv)
        assert fg.LAUNCHES == launches
    finally:
        torch.set_num_threads(threads)
    return argv, got


def test_eval_ft_floor_writes_the_schema(one_thread, ft_floor):
    """The ported ft-floor tool at one trial of a few frames: both committed
    h=128 T=10 checkpoints through B7's plain version, the JAX tool's schema
    (protocol, snr_range, models with ber and fer) written and returned; the
    missing ft2 checkpoint is skipped; the same seeds give the same counts."""
    argv, got = ft_floor
    out = Path(argv[argv.index("--out") + 1])
    assert json.loads(out.read_text()) == got
    assert set(got) == {"protocol", "snr_range", "models"} and got["snr_range"] == [0.0, 1.0]
    assert got["protocol"]["bits_per_point"] == 3 * 208 and got["protocol"]["code"] == "nr_2_0_4"
    assert "msg_gnn_v2 kernel" in got["protocol"]["serving"]
    assert set(got["models"]) == {"h=128 T=10", "h=128 T=10 ft"}
    for m in got["models"].values():
        assert len(m["ber"]) == len(m["fer"]) == 2 and m["frames"] == 3
        assert all(0.0 <= b <= f <= 1.0 for b, f in zip(m["ber"], m["fer"]))
    launches = dict(fg.LAUNCHES)
    again = eval_ft_floor.main(argv)
    assert fg.LAUNCHES == launches  # a CPU tensor never reaches a kernel
    assert [m["bit_errors"] for m in again["models"].values()] == \
        [m["bit_errors"] for m in got["models"].values()]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_ft_floor.main(["--trials", "1", "--out", str(out)])


def test_eval_ft_floor_loop_takes_the_builder(one_thread, ft_floor):
    """The tool's loop (``error_counts``) serves the checkpoints through any
    builder on the same seeds: through B7's plain version it gives main's
    counts (at 0 dB, main's first SNR, whose trials draw from the same
    seeds), through B9's counts of its own over the same frames."""
    args = ([0.0], 1, 3, eval_ft_floor.SEED, torch.device("cpu"))
    v2 = eval_ft_floor.error_counts(fg.make_fused_gnn_decoder_v2, *args)
    got = ft_floor[1]
    assert [m["bit_errors"] for m in v2.values()] == \
        [m["bit_errors"][:1] for m in got["models"].values()]
    v4 = eval_ft_floor.error_counts(fg.make_fused_gnn_decoder_v4, *args)
    assert set(v4) == set(v2) == {"h=128 T=10", "h=128 T=10 ft"}
    for m in v4.values():
        assert m["frames"] == 3 and 0 <= m["frame_errors"][0] <= 3
        assert m["frame_errors"][0] <= m["bit_errors"][0] <= 3 * 208


def test_bench_at_h128(one_thread, monkeypatch):
    """``bench_gnn_kernel --hidden 128 --kernels v2,v4 --fresh`` runs B7 and
    B9 (their plain versions here) against the module; the other variants
    still refuse h=128."""
    monkeypatch.setattr(bench_gnn_kernel, "ROUNDS", 1)
    out = bench_gnn_kernel.main(["--device", "cpu", "--hidden", "128", "--kernels", "v2,v4",
                                 "--fresh", "--batch", "2", "--iters", "2"])
    assert out["hidden_dim"] == 128
    assert {v["kernel"] for v in out["variants"].values()} == {"msg_gnn_v2", "msg_gnn_v4"}
    assert all(v["decision_agreement"] == 1.0 for v in out["variants"].values())
    with pytest.raises(ValueError, match="--hidden in"):
        bench_gnn_kernel.main(["--device", "cpu", "--hidden", "128", "--kernels", "v1,v2",
                               "--fresh"])
