"""B1's layered min-sum path, the ``retire_layered`` kernel
(csrc/fused_retire.cu, replaces ldpc_tpu/ops/pallas_minsum.py:143 ``_kernel``
for mode "minsum", schedule "layered").

The kernel runs a frame's base rows in order, one warp's lanes on a row's Z
checks, keeps each check's c2v compressed to (alpha*m1, alpha*m2, argmin,
signs), folds each new c2v into the beliefs as (belief + new) - old, runs a
parity pass over every check after a sweep and lets a frame go the sweep it
converges.  Rows of a row group (consecutive rows that share no column) may
run side by side.  Held here, on the CPU:

* its plain version (``fused_decode_plain``, layered) against the JAX kernel
  in interpret mode, bits and conv_iter identical, on tied minimums, exact
  zeros (-0.0 among them), batches that all converge in the first sweep and
  batches that never converge;
* the premise of retiring: sweeps past a frame's freezing change neither its
  bits nor its conv_iter;
* the structure tables the kernel reads, through a numpy model of the
  kernel's per-lane algorithm (state words, old c2v expanded from them, the
  rows of a group updated side by side, parity from sign bits), against the
  plain version: bits, conv_iter and, without tracking, every belief;
* the shared-memory plans and the routes.

Three JAX compiles (toy_4x8 and nr_2_0_4 with tracking, toy_4x8 without),
in one child process, serve every input kind: the batch shape is fixed."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_minsum_retire import ITERS, KINDS, _check_kind, _flip, hard_llrs
from test_torch_parity import assert_decoder_parity, bpsk_llrs

import ldpc_tpu_torch.codes as tcodes
from ldpc_tpu_torch.models.classical import MinSumScaledDecoder
from ldpc_tpu_torch.ops import fused_minsum as fm

CODES = [("toy_4x8", 4), ("nr_2_0_4", 4)]
_U = np.uint32


def _qc(name: str, Z: int):
    return tcodes.qc_layout(tcodes.get_base_graph(name), Z)


# The JAX kernel in interpret mode, run in a child process whose XLA targets
# no FMA instructions (--xla_cpu_max_isa=AVX): XLA's CPU backend otherwise
# contracts the TPU kernel's  beliefs + alpha*sp*sgn*loo  into a fused
# multiply-add, which rounds once where the kernel's source (and the TPU, and
# the port) round the product and then the sum.  On noise alone that moves
# beliefs by an ulp from the first sweep and, at nr_2_0_4 Z=4 after 8 sweeps,
# flips bits.  One compile per code and flag set.
_JAX_CHILD = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
import ldpc_tpu.codes as jcodes
from ldpc_tpu.ops import pallas_minsum as jpm

inputs, out, decoders = np.load(sys.argv[1]), {}, {}
iters = int(inputs["iters"])
for key in inputs.files:
    if key == "iters":
        continue
    name, Z, track, kind = key.split(":")
    if (name, Z, track) not in decoders:
        qc = jcodes.qc_layout(jcodes.get_base_graph(name), int(Z))
        decoders[name, Z, track] = jpm.make_fused_minsum(
            qc, iters, 0.75, batch_tile=8, interpret=True, track_convergence=track == "1",
            schedule="layered")
    bits, conv = decoders[name, Z, track](jnp.asarray(inputs[key]))
    out[key + ":bits"], out[key + ":conv"] = np.asarray(bits), np.asarray(conv)
np.savez(sys.argv[2], **out)
"""
_JAX_CASES = [(name, Z, True) for name, Z in CODES] + [("toy_4x8", 4, False)]


def _key(name: str, Z: int, track: bool, kind: str) -> str:
    return f"{name}:{Z}:{int(track)}:{kind}"


def _case_llrs(name: str, Z: int, track: bool, kind: str) -> np.ndarray:
    n = _qc(name, Z).num_vars
    return hard_llrs(kind, n, seed=(Z if track else 0) + len(kind))


@pytest.fixture(scope="module")
def jax_layered(tmp_path_factory):
    """{case key: (bits, conv_iter)} of the JAX kernel on every case's LLRs."""
    tmp = tmp_path_factory.mktemp("jax_layered")
    inputs = {_key(*case, kind): _case_llrs(*case, kind) for case in _JAX_CASES for kind in KINDS}
    np.savez(tmp / "in.npz", iters=ITERS, **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX").strip())
    root = Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, "-c", f"import sys; sys.path.insert(0, {str(root)!r})\n"
                    + _JAX_CHILD, str(tmp / "in.npz"), str(tmp / "out.npz")],
                   env=env, cwd=root, check=True, timeout=600)
    out = np.load(tmp / "out.npz")
    return {key: (out[key + ":bits"], out[key + ":conv"]) for key in inputs}, inputs


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,Z", CODES)
def test_plain_matches_jax_on_hard_inputs(jax_layered, name, Z, kind):
    outputs, inputs = jax_layered
    key = _key(name, Z, True, kind)
    llr = inputs[key]
    if kind == "zeros":
        assert (np.signbit(llr) & (llr == 0)).any() and (~np.signbit(llr) & (llr == 0)).any()
    dec = fm.make_fused_minsum(_qc(name, Z), ITERS, 0.75, schedule="layered", device="cpu")
    assert dec.route == "retire_layered"
    bits_t, conv_t = dec(torch.from_numpy(llr))
    assert_decoder_parity("minsum", *outputs[key], bits_t, conv_t)
    _check_kind(conv_t.numpy(), kind)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_jax_throughput_mode(jax_layered, kind):
    outputs, inputs = jax_layered
    key = _key("toy_4x8", 4, False, kind)
    dec = fm.make_fused_minsum(_qc("toy_4x8", 4), ITERS, 0.75, schedule="layered",
                               track_convergence=False, device="cpu")
    bits_t, conv_t = dec(torch.from_numpy(inputs[key]))
    assert_decoder_parity("minsum", *outputs[key], bits_t, conv_t)
    assert (conv_t.numpy() == ITERS).all()


@pytest.mark.parametrize("name,Z", [("toy_4x8", 4), ("nr_2_0_4", 8)])
def test_sweeps_past_freezing_change_nothing(name, Z):
    """A frame frozen at sweep c <= T has the same bits and conv_iter after
    T and after 2T sweeps: the kernel may stop at c."""
    qc = _qc(name, Z)
    llr = torch.from_numpy(bpsk_llrs(qc.num_vars, 64, -1.0, seed=5))
    short_bits, short_conv = fm.make_fused_minsum(qc, 4, schedule="layered", device="cpu")(llr)
    long_bits, long_conv = fm.make_fused_minsum(qc, 8, schedule="layered", device="cpu")(llr)
    frozen = short_conv < 4
    assert 0 < int(frozen.sum()) < 64
    torch.testing.assert_close(long_bits[frozen], short_bits[frozen], rtol=0, atol=0)
    torch.testing.assert_close(long_conv[frozen], short_conv[frozen], rtol=0, atol=0)
    assert bool((long_conv[~frozen] >= 4).all()) and bool((long_conv > 4).any())


# ---------------------------------------------------------------------------
# The structure tables, through a numpy model of the kernel
# ---------------------------------------------------------------------------


def _unpack(qc):
    st = fm._structure(qc)
    K, R = st.K, st.R
    g = fm._layered_structure(st)
    assert g.dtype == np.int32 and g[2 * K + R + 1] == 0 and g[-1] == R
    return st, g[:2 * K].reshape(K, 2), g[2 * K:2 * K + R + 1], g[2 * K + R + 1:]


def kernel_model(qc, llr: np.ndarray, T: int, alpha: float, track: bool):
    """csrc/fused_retire.cu's retire_layered_kernel on (frame, lane) arrays:
    row groups in order, the rows of a group side by side (each reads the
    beliefs before any of them writes), the old c2v expanded from the state
    words, (belief + new) - old, a parity pass from the sign bits of the
    beliefs after every sweep but the last, retirement.  Returns (bits,
    conv_iter, beliefs after the last sweep)."""
    st, row_mem, row_ptr, grp_ptr = _unpack(qc)
    Z, R = st.Z, st.R
    f32, alpha = np.float32, np.float32(alpha)
    pow2 = Z & (Z - 1) == 0
    z = np.arange(Z)

    def rolled(s, offset):
        if pow2:
            return ((z + s) & (Z - 1)) | offset
        v = z + s
        return np.where(v >= Z, v - Z, v) + offset

    def row_update(r):
        """Row r's new beliefs at its members' positions and its new state."""
        q = r * Z + z
        a, w_old = A[:, q], W[:, q]
        arg_old = w_old >> _U(27)
        j0, d = row_ptr[r], row_ptr[r + 1] - row_ptr[r]
        pos = [rolled(row_mem[j0 + j, 1], row_mem[j0 + j, 0]) for j in range(d)]
        b = [bel[:, p] for p in pos]
        m1 = np.full((B, Z), 1e9, f32)
        m2 = m1.copy()
        arg = np.full((B, Z), 31, _U)
        neg = np.zeros((B, Z), _U)
        old = [_flip(np.where(arg_old == j, a[..., 1], a[..., 0]), w_old << _U(31 - j))
               for j in range(d)]
        for j in reversed(range(d)):  # the kernel folds the last member first
            x = b[j] - old[j]
            mag = np.abs(x)
            neg = (neg << _U(1)) | (x.view(_U) >> _U(31))
            arg = np.where(mag <= m1, _U(j), arg)
            m2 = np.minimum(np.maximum(mag, m1), m2)
            m1 = np.minimum(mag, m1)
        odd = np.bitwise_count(neg) & 1
        an = np.stack([alpha * np.where(m1 < 1e9, m1, f32(0)),
                       alpha * np.where(m2 < 1e9, m2, f32(0))], axis=-1)
        wn = (neg ^ np.where(odd == 1, _U((1 << d) - 1), _U(0))) | (arg << _U(27))
        new = [(b[j] + _flip(np.where(arg == j, an[..., 1], an[..., 0]), wn << _U(31 - j)))
               - old[j] for j in range(d)]
        return q, an, wn, pos, new

    B = llr.shape[0]
    bel = llr + f32(0.0)  # -0.0 -> +0.0
    A = np.zeros((B, R * Z, 2), f32)
    W = np.zeros((B, R * Z), _U)
    live = np.ones(B, bool)
    bits = np.zeros_like(llr)
    conv = np.full(B, T, np.int32)
    for t in range(T):
        for g0, g1 in zip(grp_ptr[:-1], grp_ptr[1:]):
            updates = [row_update(r) for r in range(g0, g1)]
            for q, an, wn, pos, new in updates:
                A[:, q], W[:, q] = an, wn
                for p, v in zip(pos, new):
                    bel[:, p] = v
        if track and t + 1 < T:
            violated = np.zeros(B, bool)
            for r in range(R):
                parity = np.zeros((B, Z), _U)
                for i in range(row_ptr[r], row_ptr[r + 1]):
                    parity ^= bel[:, rolled(row_mem[i, 1], row_mem[i, 0])].view(_U)
                violated |= (parity >> _U(31)).astype(bool).any(axis=1)
            done = live & ~violated
            bits[done] = (bel[done] < 0).astype(f32)
            conv[done] = t + 1
            live &= ~done
    bits[live] = (bel[live] < 0).astype(f32)
    return bits, conv, bel


def plain_beliefs(qc, llr: np.ndarray, T: int, alpha: float) -> np.ndarray:
    """The plain version's beliefs after T layered sweeps (fused_decode_plain's
    row loop, no freezing)."""
    st = fm._structure(qc)
    ix = fm._PlainIndex(st, torch.device("cpu"))
    bel = torch.from_numpy(llr).clone()
    c2v = torch.zeros((llr.shape[0], st.K * st.Z), dtype=torch.float32)
    for _ in range(T):
        for row in ix.rows:
            fm._layered_row(bel, c2v, row, st.Z, alpha, False)
    return bel.numpy()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,Z", [("toy_4x8", 4), ("nr_2_0_4", 4), ("nr_2_0_32", 24),
                                    ("nr_2_0_32", 32)])
def test_kernel_model_matches_plain(name, Z, kind):
    """Bits and conv_iter identical, with and without tracking; without,
    every belief after the last sweep equal (== counts -0.0 as +0.0)."""
    qc = _qc(name, Z)
    llr = hard_llrs(kind, qc.num_vars, seed=Z)
    for track in (True, False):
        bits_m, conv_m, bel_m = kernel_model(qc, llr, ITERS, 0.75, track)
        dec = fm.make_fused_minsum(qc, ITERS, 0.75, schedule="layered",
                                   track_convergence=track, device="cpu")
        bits_p, conv_p = dec.plain(torch.from_numpy(llr))
        assert_decoder_parity("minsum", bits_m, conv_m, bits_p, conv_p)
    np.testing.assert_array_equal(bel_m, plain_beliefs(qc, llr, ITERS, 0.75))


def test_row_groups():
    """nr_2_0_32 (NR BG2): 42 rows in 28 groups, 10 of two rows and 2 of
    three; rows of a group pairwise share no column, and each group ends
    where the next row shares a column with it."""
    st = fm._structure(_qc("nr_2_0_32", 32))
    starts = fm.row_groups(st)
    sizes = np.diff(starts)
    assert starts[0] == 0 and starts[-1] == 42 and len(sizes) == 28
    assert sorted(sizes.tolist()) == [1] * 16 + [2] * 10 + [3] * 2
    cols = [{st.cols[k] for k in m} for m in st.row_members]
    for g0, g1 in zip(starts[:-1], starts[1:]):
        group = set()
        for r in range(g0, g1):
            assert not group & cols[r]
            group |= cols[r]
        if g1 < st.R:
            assert group & cols[g1]
    toy = fm._structure(_qc("toy_4x8", 4))
    assert fm.row_groups(toy) == [0, 1, 2, 3, 4]


def test_layered_structure_tables():
    st, row_mem, row_ptr, grp_ptr = _unpack(_qc("nr_2_0_32", 32))
    np.testing.assert_array_equal(np.diff(row_ptr), [len(m) for m in st.row_members])
    row_edges = [k for m in st.row_members for k in m]
    np.testing.assert_array_equal(row_mem[:, 0], [st.cols[k] * 32 for k in row_edges])
    np.testing.assert_array_equal(row_mem[:, 1], [st.shifts[k] for k in row_edges])
    np.testing.assert_array_equal(grp_ptr, fm.row_groups(st))


def test_plans_and_shared_memory():
    """22,784 bytes a frame at NR BG2 Z=32 (3 R*Z state words and C*Z
    beliefs), a 1,872-byte structure (2K + R + G + 2 words, rounded to 16
    bytes), so 10 frames a block; parts up to the largest row group."""
    qc = _qc("nr_2_0_32", 32)
    assert fm.retire_layered_smem_bytes(qc, 2) - fm.retire_layered_smem_bytes(qc, 1) == 22784
    assert fm.retire_layered_smem_bytes(qc, 1) == 1872 + 22784
    assert fm.retire_layered_smem_bytes(qc, 10) == 229712 <= fm._SMEM_BUDGET
    plans = fm.retire_layered_plans(qc)
    assert (1, 10) in plans and (1, 11) not in plans and (3, 10) in plans
    assert {p for p, _ in plans} == {1, 2, 3}
    qc64 = _qc("nr_2_0_32", 64)
    assert fm.retire_layered_smem_bytes(qc64, 2) - fm.retire_layered_smem_bytes(qc64, 1) == 45568
    assert max(f for _, f in fm.retire_layered_plans(qc64)) == 5
    assert all(fm.retire_threads(qc64, p, f) <= 1024 for p, f in fm.retire_layered_plans(qc64))
    # One-warp frames take up to 32 a block; a frame of more warps takes a
    # named barrier, so at most 15.
    toy = fm.retire_layered_plans(_qc("toy_4x8", 4))
    assert toy == [(1, f) for f in range(1, 33)]
    assert max(f for p, f in fm.retire_layered_plans(_qc("nr_2_0_4", 4)) if p > 1) == 15


def test_routes_and_launch_counters():
    """Layered min-sum routes to retire_layered (retire_zlane_layered on a
    fused_zlane decoder); rows of 28 to 58 members go to retire_layered_wide
    on a fused decoder; min-sum
    and sum-product flooding and layered sum-product go to theirs; the
    serving object reaches retire_layered; a CPU tensor moves no launch
    counter."""
    from test_torch_minsum_retire import wide_row_shifts

    qc = _qc("nr_2_0_32", 32)
    dec = fm.make_fused_minsum(qc, 20, schedule="layered", device="cpu")
    assert dec.route == "retire_layered" and dec.retire and dec.graph is not None
    assert fm.make_fused_minsum(qc, 20, device="cpu").route == "fused_retire"
    sp = fm.make_fused_minsum(qc, 20, mode="sumproduct", schedule="layered", device="cpu")
    assert sp.route == "retire_layered_sumproduct" and sp.retire
    bp = fm.make_fused_bp(qc, 20, device="cpu")
    assert bp.route == "retire_sumproduct" and bp.retire
    server = MinSumScaledDecoder(qc, 20, 0.75, early_stopping=False, schedule="layered",
                                 device="cpu")
    assert server._fused.route == "retire_layered"
    wide = tcodes.qc_layout(tcodes.BaseGraph("wide", wide_row_shifts()), 4)
    assert not fm.retire_layered_fits(wide) and fm.retire_layered_fits(wide, word_bits=64)
    assert fm.make_fused_minsum(wide, 5, schedule="layered",
                                device="cpu").route == "retire_layered_wide"
    zl = fm.make_fused_minsum_zlane(_qc("nr_2_0_32", 384), 5, schedule="layered", device="cpu")
    assert zl.route == "retire_zlane_layered"
    assert "retire_layered" in fm.LAUNCHES
    launches = dict(fm.LAUNCHES)
    small = _qc("nr_2_0_4", 4)
    llr = torch.from_numpy(bpsk_llrs(small.num_vars, 3, 1.0, seed=1))
    fm.make_fused_minsum(small, 3, schedule="layered", device="cpu")(llr)
    server.decode(torch.zeros((2, qc.num_vars)))
    assert fm.LAUNCHES == launches
    with pytest.raises(ValueError, match="no fused launch"):
        fm.make_fused_minsum(small, 3, device="cpu")._launch_fused(llr)
    with pytest.raises(ValueError, match="no fused launch"):
        zl._launch_fused(torch.zeros((1, zl.n)))
