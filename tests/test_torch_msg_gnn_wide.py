"""B7 and B9 at hidden width 128 (csrc/fused_msg_gnn_tc.cu
``msg_gnn_wide_tc_kernel``, replacing ldpc_tpu/ops/pallas_gnn.py:295
``_kernel_v2`` and :952 ``_kernel_v4`` at h=128) on the CPU.

* The plain versions against the JAX builders in Pallas interpret mode at
  toy_4x8, T=2, and the h=128 sweep checkpoints through the plain versions
  against the flax module's ``apply``: soft bits within 3e-2 and the
  confident decisions equal, the JAX package's bar.
* A torch model of the kernel's chunk order: per 16-message tile the layer's
  weights walk in chunks of ``WIDE_CHUNK`` hidden units as the wrapper packs
  them, pv and pc of a chunk's units over [f | mean | lf] plus b1, then their
  terms of the second layer (B9's last layer: of the thin product) added to
  one accumulator.  On the exact inputs of ``ops/msg_gnn_exact.py`` at h=128
  (``EXACT_WIDE_CASES``) it must give the plain version's soft bits exactly:
  every sum it takes is checked exact in any order, value by value, with a
  conservative bound (per output, the magnitudes of its terms add up to less
  than 2**24 times the product of the least quantum of its row of inputs and
  the least quantum of its row of weights), so the weights' quantum of 1/128
  keeps the argument of ``ops/msg_gnn_exact.py``.
* The streamed packing, the width gate, the plans, the ported ft-floor tool
  and the kernel bench at h=128.
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
from test_torch_msg_gnn_tc import TILE, _exact_sum, _graph, _member_sums, _quanta, _r
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
def test_plain_matches_jax_kernel(kind, inject):
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
def test_checkpoint_matches_flax_module(kind, name, T):
    """The h=128 sweep checkpoints, read by the port's reader, through both
    plain versions against the flax module with the flax reader's
    parameters: soft bits within CHECKPOINT_ATOL, decisions equal where the
    module is confident."""
    qt, mt, llr, soft = _checkpoint_case(name, T)
    got = BUILDERS[kind][1](qt, mt, T, H, input_injection=True, device="cpu")(
        torch.from_numpy(llr))
    assert_close_and_confident(got.numpy(), soft, atol=CHECKPOINT_ATOL[name])


# ---------------------------------------------------------------------------
# A model of the kernel's chunk order
# ---------------------------------------------------------------------------


def unpack_chunks(packed: torch.Tensor, h: int, inject: bool):
    """The streamed layout (T, layer) -> per chunk (W1v rows (T, chunk, kin),
    W1c rows (T, chunk, kin), W2 columns (T, h, 2 chunk): its units' W2v
    columns, then their W2c columns); the row padding must be zero."""
    chunk = fg.WIDE_CHUNK
    ws1, ws2 = fg.tc_chunk_widths(h, inject)
    kin = ws1 - 8
    T = packed.shape[0]
    assert packed.shape == (T, h // chunk * fg.tc_chunk_elems(h, inject))
    p = packed.to(torch.float32).reshape(T, h // chunk, -1)
    out = []
    for c in range(h // chunk):
        w1v = p[:, c, :chunk * ws1].reshape(T, chunk, ws1)
        w1c = p[:, c, chunk * ws1:2 * chunk * ws1].reshape(T, chunk, ws1)
        w2 = p[:, c, 2 * chunk * ws1:].reshape(T, h, ws2)
        for m, width in ((w1v, kin), (w1c, kin), (w2, 2 * chunk)):
            assert not m[..., width:].any()
        out.append((w1v[..., :kin], w1c[..., :kin], w2[..., :2 * chunk]))
    return out


def _least_quanta(x: torch.Tensor) -> torch.Tensor:
    """Per row of x (..., k), the least quantum of its nonzero values (inf
    where all are 0)."""
    return _quanta(x).amin(dim=-1)


def _acc(pairs, init: torch.Tensor | None = None) -> torch.Tensor:
    """init + the sum of a @ w^T over (a, w, least quanta of a's rows) in
    ``pairs`` as one float32 accumulation, after checking it exact in any
    order: per output, the magnitudes of every product and of init add up to
    less than 2**24 times a lower bound of the least quantum among them (each
    product's quantum is at least its input row's least quantum times its
    weight row's)."""
    shape = pairs[0][0].shape[:-1] + (pairs[0][1].shape[0],)
    bound = torch.zeros(shape, dtype=torch.float64)
    q = torch.full(shape, torch.inf, dtype=torch.float64)
    acc = torch.zeros(shape)
    for a, w, qa in pairs:
        bound = bound + a.double().abs() @ w.double().abs().t()
        q = torch.minimum(q, qa[..., None] * _least_quanta(w))
        acc = acc + a @ w.t()
    if init is not None:
        init = init.expand(shape)
        bound = bound + init.double().abs()
        q = torch.minimum(q, _quanta(init))
        acc = init + acc
    assert bool((bound < 2.0 ** 24 * q).all()), "a sum is not exact"
    return acc


def chunk_model(dec, llr: torch.Tensor) -> torch.Tensor:
    """B7 (``msg_gnn_v2``) or B9 (``msg_gnn_v4``) at h=128 as the kernel
    computes it, on the CPU: per 16-message tile and layer, each chunk's pv
    and pc (one accumulation over [f | mean | lf], plus b1: B7's per edge,
    B9's per layer), relu, bf16, and their second-layer terms into one
    accumulator over all chunks, plus b2 (B9: the delta, then the residual);
    B9's last layer w2last . [h1v; h1c] chunk by chunk, then proj8 . f,
    summed per variable with dsc in member order."""
    qc, h, T, inject = dec.qc, dec.hidden_dim, dec.num_iterations, dec.input_injection
    tb, v4 = dec.tables, dec.kind == "msg_gnn_v4"
    Z, K, C = qc.Z, qc.num_base_edges, qc.num_base_cols
    E, n, CH = K * Z, C * Z, fg.WIDE_CHUNK
    row_ptr, row_edge, col_ptr, col_edge, shift, col, row = _graph(dec)
    chunks = unpack_chunks(tb.w_bf16, h, inject)
    emb_w, emb_b, proj_w, proj_b = tb.emb[:h], tb.emb[h:2 * h], tb.emb[2 * h:3 * h], tb.emb[3 * h]
    inv_dc, inv_dr = tb.inv[:C], tb.inv[C:]
    B = llr.shape[0]

    i = torch.arange(E)
    k = i // Z
    z = i - k * Z
    vrow = col[k] * Z + z
    crow = row[k] * Z + (z - shift[k]) % Z
    lf = _r(llr[:, vrow, None] * emb_w + emb_b)  # (B, E, h)
    f = _r((llr[:, vrow, None] * emb_w + emb_b) + tb.tab[0][k]) if v4 else lf
    ntiles = -(-E // TILE)
    pad = ntiles * TILE - E

    def tiles(x):  # (B, E, w) -> (B, tiles, 16, w), rows past E zero
        return torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(B, ntiles, TILE, -1)

    def untile(x):
        return x.reshape(B, ntiles * TILE, -1)[:, :E]

    for t in range(T):
        vsum = _member_sums(f, col_ptr, lambda j, zs: col_edge[j] * Z + zs, Z)
        rsum = _member_sums(f, row_ptr, lambda j, zs: row_edge[j] * Z + (zs + shift[row_edge[j]])
                            % Z, Z)
        vmean = _r(vsum * inv_dc.repeat_interleave(Z)[:, None])
        rmean = _r(rsum * inv_dr.repeat_interleave(Z)[:, None])
        av = tiles(torch.cat([f, vmean[:, vrow]] + ([lf] if inject else []), dim=-1))
        ac = tiles(torch.cat([f, rmean[:, crow]] + ([lf] if inject else []), dim=-1))
        qv, qc_ = _least_quanta(av), _least_quanta(ac)
        if v4:  # per layer
            b1v, b1c = tb.small[t, :h], tb.small[t, h:2 * h]
        else:  # (2, K, h), per edge
            b1v, b1c = (tiles(tb.tab[t][side][k].expand(B, E, h)) for side in (0, 1))
        last = v4 and t == T - 1
        pairs = []
        for c, (w1v, w1c, w2) in enumerate(chunks):
            units = slice(c * CH, (c + 1) * CH)
            h1v = _r(torch.relu(_acc([(av, w1v[t], qv)], init=b1v[..., units])))
            h1c = _r(torch.relu(_acc([(ac, w1c[t], qc_)], init=b1c[..., units])))
            h1 = [(x, _least_quanta(x)) for x in (h1v, h1c)]
            if last:
                w2last = tb.extra[:2 * h]
                pairs += [(x, w2last[None, side * h + c * CH:side * h + (c + 1) * CH], q)
                          for side, (x, q) in enumerate(h1)]
            else:
                pairs += [(x, w2[t][:, side * CH:(side + 1) * CH], q)
                          for side, (x, q) in enumerate(h1)]
        if last:
            if t >= 1:
                pairs.append((tiles(f), proj_w[None], _least_quanta(tiles(f))))
            s = untile(_acc(pairs))[..., 0]
            break
        out, b2 = _acc(pairs), tb.small[t, 2 * h:3 * h] if v4 else tb.small[t, :h]
        _exact_sum(out, b2)
        new = untile(_r(out + b2))
        if v4:
            d = _r(tb.tab[t + 1][k])
            new = _r(new + d) if t == 0 else _r(_r(new + d) + f)
        elif t >= 1:
            _exact_sum(new, f)
            new = _r(new + f)
        f = new

    if v4:  # dsc is float32, not dyadic: summed in the plain version's order
        terms, adds = s, tb.extra[2 * h:]
    else:
        terms, adds = _acc([(f, proj_w[None], _least_quanta(f))])[..., 0], proj_b.expand(K)
    acc = torch.zeros((B, n))
    for cc in range(C):
        for j in range(int(col_ptr[cc]), int(col_ptr[cc + 1])):
            rows = col_edge[j] * Z + torch.arange(Z)
            sl = slice(cc * Z, (cc + 1) * Z)
            if not v4:
                _exact_sum(acc[:, sl], terms[:, rows], adds[col_edge[j]])
            acc[:, sl] = (acc[:, sl] + terms[:, rows]) + adds[col_edge[j]]
    return 1.0 / (1.0 + torch.exp(llr + acc))


@pytest.mark.parametrize("kind", list(BUILDERS))
@pytest.mark.parametrize("code,Z,h,batch,inject,share", EXACT_WIDE_CASES)
def test_chunk_model_equals_plain_on_exact_inputs(one_thread, kind, code, Z, h, batch, inject,
                                                  share):
    """The streamed chunks, the flat-index tiles and the per-chunk second
    layer give the plain version's soft bits exactly; the decode is not
    trivial (both decisions present, soft bits not all saturated)."""
    qc = qc_layout(get_base_graph(code), Z)
    model, llr = exact_msg_gnn_case(qc, h, batch, inject, share)
    dec = BUILDERS[kind][1](qc, model, 2, h, share_layers=share, input_injection=inject,
                            device="cpu")
    x = torch.from_numpy(llr)
    plain = dec(x)
    assert torch.equal(chunk_model(dec, x), plain)
    decided = plain > 0.5
    assert decided.any() and (~decided).any()
    assert ((plain - 0.5).abs() < 0.45).float().mean() > 0.05


def test_chunk_model_b9_last_layer_alone(one_thread):
    """B9 at T=1: its thin last layer chunk by chunk, with no residual."""
    qc = qc_layout(get_base_graph("nr_2_0_4"), 4)
    model, llr = exact_msg_gnn_case(qc, H, 5, True, False, num_iterations=1)
    dec = fg.make_fused_gnn_decoder_v4(qc, model, 1, H, input_injection=True, device="cpu")
    x = torch.from_numpy(llr)
    assert torch.equal(chunk_model(dec, x), dec(x))


# ---------------------------------------------------------------------------
# Packing, width gate, plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("inject", [False, True])
@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_pack_streamed_round_trip(inject, kind):
    """Each chunk holds the W1v rows, then the W1c rows, of its units
    ([W1vf W1va (W1vl)], [W1cf W1ca (W1cl)]) and the h rows of [W2v W2c] cut
    to its units' columns; rows padded with zeros to 2h (3h) + 8 and 2 chunk
    + 8.  B7 and B9 stream the same layout."""
    T, chunk = 2, fg.WIDE_CHUNK
    w = _r(torch.from_numpy(np.random.default_rng(int(inject)).standard_normal(
        (T, 8, H, H), np.float32)))
    packed = fg.pack_tc_weights(w, inject, kind)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    # _MsgTables order: va, ca, vl, cl, vf, cf, W2v, W2c
    w1v = torch.cat([w[:, 4], w[:, 0]] + ([w[:, 2]] if inject else []), dim=2)
    w1c = torch.cat([w[:, 5], w[:, 1]] + ([w[:, 3]] if inject else []), dim=2)
    for c, (v, cc, w2) in enumerate(unpack_chunks(packed, H, inject)):
        units = slice(c * chunk, (c + 1) * chunk)
        assert torch.equal(v, w1v[:, units]) and torch.equal(cc, w1c[:, units])
        assert torch.equal(w2, torch.cat([w[:, 6][:, :, units], w[:, 7][:, :, units]], dim=2))
    kin = (3 if inject else 2) * H
    assert fg.tc_chunk_elems(H, inject) == 2 * chunk * (kin + 8) + H * (2 * chunk + 8)
    with pytest.raises(ValueError, match="no streamed layout"):
        fg.pack_tc_weights(w, inject, "msg_gnn_v3")


def test_width_gate():
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
    """Shared memory of the h=128 kernels (make_layout): the state, two
    weight chunks and one tile buffer a warp; scratch as at the
    other widths."""
    qc = qc_layout(get_base_graph("nr_2_0_4"), 4)
    K, C, R, Z = qc.num_base_edges, qc.num_base_cols, qc.num_base_rows, qc.Z
    state = 4 * ((6 * K + R + C + 2 + 3) // 4 * 4 + (C + R + 3) // 4 * 4 + C * Z + 388)
    chunk_inj = 2 * 16 * 392 + 128 * 40  # bf16
    assert fg.tc_chunk_elems(H, True) == chunk_inj == 17_664
    tile = 3 * 16 * 136 * 2  # features, vmean, rmean rows of one tile buffer, bytes
    for kind, small in (("msg_gnn_v2", 128), ("msg_gnn_v4", 384)):
        for warps in (1, 11):
            assert fg.msg_gnn_smem_bytes(qc, H, kind, True, warps) == \
                state + 4 * small + 2 * 2 * chunk_inj + warps * tile
    assert fg.msg_gnn_smem_bytes(qc, H, "msg_gnn_v2", True, 1) == 92_112
    assert fg.msg_gnn_smem_bytes(qc, H, "msg_gnn_v2", True, 11) == 222_672
    assert fg.msg_gnn_smem_bytes(qc, H, "msg_gnn_v4", False, 12) == 220_368
    assert fg.msg_gnn_scratch_floats(qc, H, "msg_gnn_v2") * 4 == (K + C + R) * Z * H * 2 == 297_984
    qc32 = qc_layout(get_base_graph("nr_2_0_32"), 32)
    assert fg.msg_gnn_scratch_floats(qc32, H, "msg_gnn_v2") * 4 == 2_383_872
    assert fg.msg_gnn_scratch_floats(qc32, H, "msg_gnn_v4") * 4 == 2_383_872 + 4 * 6304


# ---------------------------------------------------------------------------
# The tools at h=128
# ---------------------------------------------------------------------------


def test_eval_ft_floor_writes_the_schema(tmp_path):
    """The ported ft-floor tool at one trial of a few frames: both committed
    h=128 T=10 checkpoints through B7's plain version, the JAX tool's schema
    (protocol, snr_range, models with ber and fer) written and returned; the
    missing ft2 checkpoint is skipped; the same seeds give the same counts."""
    out = tmp_path / "floor.json"
    argv = ["--device", "cpu", "--trials", "1", "--batch", "3", "--snrs", "0,1", "--out", str(out)]
    launches = dict(fg.LAUNCHES)
    got = eval_ft_floor.main(argv)
    assert fg.LAUNCHES == launches
    assert json.loads(out.read_text()) == got
    assert set(got) == {"protocol", "snr_range", "models"} and got["snr_range"] == [0.0, 1.0]
    assert got["protocol"]["bits_per_point"] == 3 * 208 and got["protocol"]["code"] == "nr_2_0_4"
    assert "msg_gnn_v2 kernel" in got["protocol"]["serving"]
    assert set(got["models"]) == {"h=128 T=10", "h=128 T=10 ft"}
    for m in got["models"].values():
        assert len(m["ber"]) == len(m["fer"]) == 2 and m["frames"] == 3
        assert all(0.0 <= b <= f <= 1.0 for b, f in zip(m["ber"], m["fer"]))
    again = eval_ft_floor.main(argv)
    assert [m["bit_errors"] for m in again["models"].values()] == \
        [m["bit_errors"] for m in got["models"].values()]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_ft_floor.main(["--trials", "1", "--out", str(out)])


def test_eval_ft_floor_loop_takes_the_builder(tmp_path):
    """The tool's loop (``error_counts``) serves the checkpoints through any
    builder on the same seeds: through B7's plain version it gives main's
    counts, through B9's counts of its own over the same frames."""
    args = ([0.0], 1, 3, eval_ft_floor.SEED, torch.device("cpu"))
    v2 = eval_ft_floor.error_counts(fg.make_fused_gnn_decoder_v2, *args)
    got = eval_ft_floor.main(["--device", "cpu", "--trials", "1", "--batch", "3", "--snrs", "0",
                              "--out", str(tmp_path / "floor.json")])
    assert [m["bit_errors"] for m in v2.values()] == \
        [m["bit_errors"] for m in got["models"].values()]
    v4 = eval_ft_floor.error_counts(fg.make_fused_gnn_decoder_v4, *args)
    assert set(v4) == set(v2) == {"h=128 T=10", "h=128 T=10 ft"}
    for m in v4.values():
        assert m["frames"] == 3 and 0 <= m["frame_errors"][0] <= 3
        assert m["frame_errors"][0] <= m["bit_errors"][0] <= 3 * 208


def test_bench_at_h128(monkeypatch):
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
