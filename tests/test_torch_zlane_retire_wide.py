"""B2's wide rows: the four large-Z retiring kernels of csrc/fused_retire.cu
on their 64-bit and 128-bit state words (``retire_zlane_wide``,
``retire_zlane_layered_wide``, ``retire_zlane_sumproduct_wide``,
``retire_zlane_layered_sumproduct_wide`` and the same four with ``_w128``),
which take codes with rows of 28 to 121 members from the ``fused_zlane``
kernel (replaces ldpc_tpu/ops/pallas_minsum.py:399 ``_kernel_zlane`` on such
codes).  Held here, on the CPU:

* numpy models of the four kernels' per-lane algorithms on the wrapper's own
  tables, with the words of ``test_torch_retire_wide`` (uint64) and
  ``test_torch_retire_w128`` (two uint64 limbs), their state read and
  written in place in scratch slices laid out as each kernel lays them out
  (``retire_zlane``: R*Z words; ``retire_zlane_layered``: A, then R*Z words,
  lo limb first; the sum-product kernels: K*Z floats of c2v), filled with
  garbage first (the flooding kernels clear theirs a frame; the layered ones
  never read it in their first sweep): after every iteration the beliefs and
  c2v of every frame still decoding equal the plain version's; bits and
  ``conv_iter`` equal ``fused_decode_plain``'s, tracked and in throughput
  mode.  Codes at Z=8: rows of 31 and 58 members (64-bit word), 64 and 121
  (128-bit word);
* the routes by row width (27 -> the 32-bit word, 28 and 58 -> ``*_wide``,
  59 and 121 -> ``*_w128``, 122 -> ``fused_zlane``), ``chip_smoke.py``'s two
  zlane_wide codes, which ``auto`` sends to ``fused_zlane``; the scratch
  and slice byte counts with fixed numbers; the launch counters;
* one JAX case: min-sum flooding on the 31-member Z=8 code through
  ``pallas_minsum.make_fused_minsum_zlane`` in interpret mode against the
  plain version behind ``retire_zlane_wide``, bits and ``conv_iter``
  identical.  Its compile starts in a thread of its own before the file's
  first case, where that case is to run, and overlaps the models.
"""
import concurrent.futures
import functools

import numpy as np
import pytest
import torch

from test_torch_minsum_retire import wide_row_shifts as shifts_31
from test_torch_parity import bpsk_llrs
from test_torch_retire_w128 import Word128, wide_row_code
from test_torch_retire_wide import Word64, flooding_model, layered_model, plain_history, row_code

import ldpc_tpu_torch.codes as tcodes
from ldpc_tpu_torch.models.classical import (BeliefPropagationDecoder, MinSumScaledDecoder,
                                             _resolve_backend)
from ldpc_tpu_torch.ops import fused_minsum as fm

ITERS = 8
SCHEDULES = [("minsum", "flooding"), ("minsum", "layered"), ("sumproduct", "flooding"),
             ("sumproduct", "layered")]
ROUTE = {("minsum", "flooding"): "retire_zlane", ("minsum", "layered"): "retire_zlane_layered",
         ("sumproduct", "flooding"): "retire_zlane_sumproduct",
         ("sumproduct", "layered"): "retire_zlane_layered_sumproduct"}
f32, U32 = np.float32, np.uint32


@pytest.fixture(scope="module", autouse=True)
def _jax_case_in_background(request):
    """Starts the JAX case's decode where that case is to run."""
    if any(item.name == "test_minsum_plain_matches_jax" for item in request.session.items):
        _jax_decode()


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: the suite's workers run side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def code(name: str):
    """``w31`` (test_torch_minsum_retire's wide_row_shifts), ``w58``
    (test_torch_retire_wide's row_code), ``w64`` and ``w121``
    (chip_smoke.py's wide_row_code), all at Z=8."""
    if name == "w31":
        return tcodes.qc_layout(tcodes.BaseGraph("wide", shifts_31()), 8)
    if name == "w58":
        return row_code(58, cols=60, Z=8)
    return wide_row_code(int(name[1:]), Z=8)


def _llrs(name: str, kind: str) -> np.ndarray:
    """noise: BPSK LLRs at an SNR where frames converge at different
    iterations and some never; ties: quantised to odd integers (tied
    minimums, no zero: a wide row with two zero members sends every member
    +-0.0, whose signs would go unseen)."""
    qc = code(name)
    snr = {"w31": 6.0, "w58": 7.0, "w64": 8.0, "w121": 8.0}[name]
    llr = bpsk_llrs(qc.num_vars, 11, snr, seed=qc.dr_max)
    return np.floor(llr / 2.0) * 2.0 + 1.0 if kind == "ties" else llr


def _garbage(words: int, rows: int, seed: int) -> np.ndarray:
    """``rows`` slices of ``words`` uint32 words of garbage (NaN patterns
    among them), as a reused scratch holds."""
    return np.random.default_rng(seed).integers(0, 2 ** 32, (rows, words), dtype=np.uint64
                                                ).astype(U32)


def slices(qc, route: str, word):
    """A ``state`` for the models whose arrays are views of one scratch slice
    a frame laid out as ``route``'s kernel lays it out, sized by the
    wrapper's scratch bytes; returns (state, the scratch)."""
    bits = word.bits
    made = {}

    def state(B: int, RZ: int, KZ: int, w):
        A = np.zeros((B, RZ, 2), f32)  # retire_zlane: in shared memory
        W = w.zeros((B, RZ))
        c2v = np.zeros((B, KZ), f32)
        if route == "retire_zlane":
            words = fm.retire_zlane_scratch_bytes(qc, bits) // 4
            assert words == bits // 32 * RZ
            made["scratch"] = s = _garbage(words, B, 1)
            W = s.view(np.uint64).reshape(W.shape)  # lo limb first
            assert np.shares_memory(W, s)
        elif route == "retire_zlane_layered":
            words = fm.retire_zlane_layered_scratch_bytes(qc, bits) // 4
            assert words == (2 + bits // 32) * RZ
            made["scratch"] = s = _garbage(words, B, 2)
            A = s[:, :2 * RZ].view(f32).reshape(B, RZ, 2)
            W = s[:, 2 * RZ:].view(np.uint64).reshape(W.shape)
            assert np.shares_memory(A, s) and np.shares_memory(W, s)
        else:
            scratch_bytes = (fm.retire_zlane_sumproduct_scratch_bytes
                             if route == "retire_zlane_sumproduct"
                             else fm.retire_zlane_layered_sumproduct_scratch_bytes)
            words = scratch_bytes(qc, bits) // 4
            assert words == KZ
            made["scratch"] = s = _garbage(words, B, 3)
            c2v = s.view(f32)
        return A, W, c2v

    return state, made


MODEL_CASES = [("w31", "noise", Word64), ("w31", "ties", Word64), ("w58", "noise", Word64),
               ("w64", "noise", Word128), ("w121", "noise", Word128),
               ("w121", "ties", Word128)]


@pytest.mark.parametrize("mode,schedule", SCHEDULES)
@pytest.mark.parametrize("name,kind,word", MODEL_CASES)
def test_model_matches_plain(name, kind, word, mode, schedule):
    """After every iteration the beliefs and c2v of every frame still
    decoding equal the plain version's, the state in its scratch slices;
    bits and conv_iter equal fused_decode_plain's, tracked and in throughput
    mode; a fused_zlane decoder routes to the kernel on this word."""
    qc = code(name)
    assert (28 <= qc.dr_max <= 58) == (word is Word64) and qc.dr_max <= 121
    suffix = fm._WORD_SUFFIX[word.bits]
    route = ROUTE[mode, schedule]
    llr = _llrs(name, kind)
    alpha = 0.75 if mode == "minsum" else 1.0
    model = layered_model if schedule == "layered" else flooding_model
    reference = plain_history(qc, llr, ITERS, mode, schedule, alpha)
    for track in (True, False):
        state, made = slices(qc, route, word)
        bits_m, conv_m, history = model(qc, llr, ITERS, track, mode, alpha, word, state)
        assert made["scratch"].size  # the kernel's slices were the state
        for (live, bel_m, c2v_m), (bel_p, c2v_p) in zip(history, reference):
            np.testing.assert_array_equal(bel_m[live].view(U32), bel_p[live].view(U32))
            np.testing.assert_array_equal(c2v_m[live].view(U32), c2v_p[live].view(U32))
        dec = fm.make_fused_minsum_zlane(qc, ITERS, alpha, mode=mode, schedule=schedule,
                                         track_convergence=track, device="cpu")
        assert dec.route == route + suffix and dec.retire and dec.graph is not None
        bits_p, conv_p = dec(torch.from_numpy(llr))
        np.testing.assert_array_equal(bits_m, bits_p.numpy())
        np.testing.assert_array_equal(conv_m, conv_p.numpy())
        if not track:
            assert (conv_m == ITERS).all()
        elif kind == "noise":
            assert len(set(conv_m.tolist())) > 1


# ---------------------------------------------------------------------------
# Routes, bytes, counters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("members", [27, 28, 58, 59, 121, 122])
def test_routes_by_row_width(members):
    """On a fused_zlane decoder (builder and serving objects with backend
    "fused_zlane") a row of 27 members runs on the 32-bit word, 28 to 58 on
    the 64-bit word, 59 to 121 on the 128-bit word, 122 on fused_zlane; the
    fits functions agree."""
    qc = row_code(members, cols=max(64, members + 2), Z=8)
    assert qc.dr_max == members
    suffix = "" if members <= 27 else "_wide" if members <= 58 else "_w128" \
        if members <= 121 else None
    for mode, schedule in SCHEDULES:
        dec = fm.make_fused_minsum_zlane(qc, 5, mode=mode, schedule=schedule, device="cpu")
        if suffix is None:
            assert dec.route == "fused_zlane" and not dec.retire
        else:
            assert dec.route == ROUTE[mode, schedule] + suffix and dec.retire
    route = "fused_zlane" if suffix is None else "retire_zlane_sumproduct" + suffix
    bp = BeliefPropagationDecoder(qc, 5, early_stopping=False, backend="fused_zlane",
                                  device="cpu")
    assert bp._fused.route == route
    ms = MinSumScaledDecoder(qc, 5, 0.75, early_stopping=False, backend="fused_zlane",
                             schedule="layered", device="cpu")
    assert ms._fused.route == ("fused_zlane" if suffix is None
                               else "retire_zlane_layered" + suffix)
    fits = (fm.retire_zlane_fits, fm.retire_zlane_layered_fits, fm.retire_zlane_sumproduct_fits,
            fm.retire_zlane_layered_sumproduct_fits)
    for takes in fits:
        assert takes(qc) == (members <= 27)
        assert takes(qc, word_bits=64) == (members <= 58)
        assert takes(qc, word_bits=128) == (members <= 121)


def ieee_384():
    """chip_smoke.py's zlane_wide code of rows of 32: (6, 32) circulants at
    Z=384, shift (r*c) mod 384."""
    r, c = np.meshgrid(np.arange(6), np.arange(32), indexing="ij")
    return tcodes.qc_layout(tcodes.BaseGraph("ieee_6x32", (r * c) % 384), 384)


def array_256():
    """chip_smoke.py's zlane_wide code of rows of 64: (4, 64) circulants at
    Z=256, shift (r*c) mod 256."""
    r, c = np.meshgrid(np.arange(4), np.arange(64), indexing="ij")
    return tcodes.qc_layout(tcodes.BaseGraph("array_4x64", (r * c) % 256), 256)


def test_zlane_wide_codes_route_and_bytes():
    """The zlane_wide phase's codes: auto sends both to fused_zlane (fused
    needs more than a block's shared memory for a frame), whose serving
    objects then take the wider words' large-Z kernels; the scratch a block
    or frame group takes, with fixed byte counts, grows with the word where
    the kernel keeps state words there and not in the sum-product kernels;
    shared memory does not depend on the word."""
    for qc, rows, edges, suffix in ((ieee_384(), 32, 73_728, "_wide"),
                                    (array_256(), 64, 65_536, "_w128")):
        assert qc.dr_max == rows and qc.num_edges == edges and qc.Z % 8 == 0
        assert not fm.fused_kernel_fits(qc) and _resolve_backend("auto", qc) == "fused_zlane"
        server = MinSumScaledDecoder(qc, 5, 0.75, early_stopping=False, device="cpu")
        assert server._fused.route == "retire_zlane" + suffix
        assert BeliefPropagationDecoder(qc, 5, device="cpu")._fused.route == \
            "retire_zlane_sumproduct" + suffix
        assert fm.retire_zlane_plans(qc) and fm.retire_zlane_layered_plans(qc)
        assert fm.retire_zlane_sumproduct_plans(qc) and fm.retire_zlane_layered_sumproduct_plans(qc)
    ieee, array = ieee_384(), array_256()
    # R*Z = 2304 checks and K*Z = 73,728 edges at Z=384; 1024 and 65,536 at Z=256.
    assert [fm.retire_zlane_scratch_bytes(ieee, b) for b in fm.WORD_BITS] == [9216, 18432, 36864]
    assert [fm.retire_zlane_layered_scratch_bytes(ieee, b) for b in fm.WORD_BITS] == \
        [27648, 36864, 55296]
    assert [fm.retire_zlane_scratch_bytes(array, b) for b in fm.WORD_BITS] == [4096, 8192, 16384]
    assert [fm.retire_zlane_layered_scratch_bytes(array, b) for b in fm.WORD_BITS] == \
        [12288, 16384, 24576]
    for qc, c2v in ((ieee, 294_912), (array, 262_144)):
        for bits in fm.WORD_BITS:
            assert fm.retire_zlane_sumproduct_scratch_bytes(qc, bits) == c2v
            assert fm.retire_zlane_layered_sumproduct_scratch_bytes(qc, bits) == c2v
    # A frame's beliefs at Z=384: 49,152 bytes; retire_zlane adds A (18,432).
    assert fm.retire_zlane_smem_bytes(ieee, 1) == 4 * (
        -(-(6 * 192 + 6 + 32 + 2 + 4) // 4) * 4) + 4 * (32 * 384 + 2 * 2304)
    assert fm.retire_zlane_layered_smem_bytes(ieee, 1) - fm.retire_zlane_layered_smem_bytes(
        ieee, 0) == 49_152


def test_launch_counters_and_cpu_tensors():
    """Every new route is retiring, counted and mapped to its kernel and
    word; the layered ones read the layered structure; a CPU tensor runs the
    plain version and moves no counter."""
    new = fm.ZLANE_WIDE_ROUTES + fm.ZLANE_W128_ROUTES
    assert len(set(new)) == 8 and set(new) <= set(fm.RETIRING) <= set(fm.LAUNCHES)
    assert {fm._ROUTE_WORD[r] for r in new} == {(route, bits) for route in ROUTE.values()
                                                for bits in (64, 128)}
    assert {r for r in new if "layered" in r} <= set(fm._LAYERED_ROUTES)
    assert not {r for r in new if "layered" not in r} & set(fm._LAYERED_ROUTES)
    launches = dict(fm.LAUNCHES)
    for name in ("w31", "w121"):
        qc = code(name)
        llr = torch.from_numpy(bpsk_llrs(qc.num_vars, 2, 4.0, seed=2))
        for mode, schedule in SCHEDULES:
            fm.make_fused_minsum_zlane(qc, 2, mode=mode, schedule=schedule, device="cpu")(llr)
    assert fm.LAUNCHES == launches


# ---------------------------------------------------------------------------
# The JAX kernel
# ---------------------------------------------------------------------------


def _jax_llrs() -> np.ndarray:
    return bpsk_llrs(code("w31").num_vars, 11, 6.0, seed=9)


@functools.cache
def _jax_decode() -> concurrent.futures.Future:
    """The JAX zlane kernel's (bits, conv_iter) on _jax_llrs(), decoded in a
    thread of its own: XLA's compile releases the interpreter, so the models
    run meanwhile.  Flooding min-sum: its JAX side needs no FMA-free XLA."""
    def decode():
        import jax.numpy as jnp
        import ldpc_tpu.codes as jcodes
        from ldpc_tpu.ops import pallas_minsum as jpm

        jqc = jcodes.qc_layout(jcodes.BaseGraph("wide", shifts_31()), 8)
        jdec = jpm.make_fused_minsum_zlane(jqc, ITERS, 0.75, batch_tile=4, interpret=True)
        return tuple(np.asarray(a) for a in jdec(jnp.asarray(_jax_llrs())))

    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(decode)
    pool.shutdown(wait=False)
    return future


def test_minsum_plain_matches_jax():
    """Min-sum flooding on the 31-member Z=8 code: the plain version behind
    retire_zlane_wide against the JAX zlane kernel in interpret mode, bits
    and conv_iter identical."""
    dec = fm.make_fused_minsum_zlane(code("w31"), ITERS, 0.75, device="cpu")
    assert dec.route == "retire_zlane_wide"
    bits_j, conv_j = _jax_decode().result()
    bits_t, conv_t = dec(torch.from_numpy(_jax_llrs()))
    np.testing.assert_array_equal(bits_j, bits_t.numpy())
    np.testing.assert_array_equal(conv_j, conv_t.numpy())
    assert len(set(conv_t.tolist())) > 1
