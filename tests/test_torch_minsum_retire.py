"""B1's min-sum flooding path, the ``fused_retire`` kernel
(csrc/fused_retire.cu, replaces ldpc_tpu/ops/pallas_minsum.py:143 ``_kernel``
for mode "minsum", schedule "flooding").

The kernel keeps each check's c2v compressed to (alpha*m1, alpha*m2, argmin,
signs), reads the syndrome off the next check pass and lets a frame go the
iteration it converges.  Held here, on the CPU:

* its plain version (``fused_decode_plain``) against the JAX kernel in
  interpret mode, bits and conv_iter identical, on the inputs that design is
  most likely to get wrong: tied minimums from quantised LLRs, exact zeros
  (-0.0 among them; sign(0) = +1), batches that all converge at iteration 1
  and batches that never converge;
* the premise of retiring: iterations past a frame's freezing change neither
  its bits nor its conv_iter;
* the structure tables the kernel reads, through a numpy model of the
  kernel's per-lane algorithm (state words, sign order, parity from sign
  bits), against the plain version.

One JAX compile per code and flag set serves every input kind (the batch
shape is fixed)."""
import functools

import numpy as np
import pytest
import torch

from test_torch_parity import assert_decoder_parity, bpsk_llrs

import ldpc_tpu_torch.codes as tcodes
from ldpc_tpu_torch.ops import fused_minsum as fm

CODES = [("toy_4x8", 4), ("nr_2_0_4", 4)]
KINDS = ("ties", "zeros", "converged_at_1", "never_converged")
BATCH, ITERS = 13, 8


def hard_llrs(kind: str, n: int, seed: int) -> np.ndarray:
    """(BATCH, n) float32 LLRs of one input kind."""
    if kind == "ties":  # quantised to even integers: many |v2c| minimums tie
        llr = np.round(bpsk_llrs(n, BATCH, 1.0, seed) / 2.0) * 2.0
    elif kind == "zeros":  # a fifth +0.0, a tenth -0.0
        llr = bpsk_llrs(n, BATCH, 1.0, seed)
        mask = np.random.default_rng(seed + 1).random(llr.shape)
        llr[mask < 0.2] = 0.0
        llr[mask > 0.9] = -0.0
    elif kind == "converged_at_1":
        llr = bpsk_llrs(n, BATCH, 9.0, seed)
    else:  # noise alone, a seed whose decisions reach no codeword in 8 iterations
        llr = np.random.default_rng(0).standard_normal((BATCH, n)) * 2.0
    return llr.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_decoder(name: str, Z: int, track: bool):
    import ldpc_tpu.codes as jcodes
    from ldpc_tpu.ops import pallas_minsum as jpm

    qc = jcodes.qc_layout(jcodes.get_base_graph(name), Z)
    return jpm.make_fused_minsum(qc, ITERS, 0.75, batch_tile=8, interpret=True,
                                 track_convergence=track)


def _check_kind(conv: np.ndarray, kind: str) -> None:
    """The batch has the property its kind names."""
    if kind == "converged_at_1":
        assert (conv == 1).all()
    elif kind == "never_converged":
        assert (conv == ITERS).all()
    else:
        assert len(set(conv.tolist())) > 1


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,Z", CODES)
def test_plain_matches_jax_on_hard_inputs(name, Z, kind):
    import jax.numpy as jnp

    qc = tcodes.qc_layout(tcodes.get_base_graph(name), Z)
    llr = hard_llrs(kind, qc.num_vars, seed=Z + len(kind))
    if kind == "zeros":
        assert (np.signbit(llr) & (llr == 0)).any() and (~np.signbit(llr) & (llr == 0)).any()
    bits_j, conv_j = _jax_decoder(name, Z, True)(jnp.asarray(llr))
    bits_t, conv_t = fm.make_fused_minsum(qc, ITERS, 0.75, device="cpu")(torch.from_numpy(llr))
    assert_decoder_parity("minsum", bits_j, conv_j, bits_t, conv_t)
    _check_kind(conv_t.numpy(), kind)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_jax_throughput_mode(kind):
    import jax.numpy as jnp

    qc = tcodes.qc_layout(tcodes.get_base_graph("toy_4x8"), 4)
    llr = hard_llrs(kind, qc.num_vars, seed=len(kind))
    bits_j, conv_j = _jax_decoder("toy_4x8", 4, False)(jnp.asarray(llr))
    dec = fm.make_fused_minsum(qc, ITERS, 0.75, track_convergence=False, device="cpu")
    bits_t, conv_t = dec(torch.from_numpy(llr))
    assert_decoder_parity("minsum", bits_j, conv_j, bits_t, conv_t)
    assert (conv_t.numpy() == ITERS).all()


@pytest.mark.parametrize("name,Z", [("toy_4x8", 4), ("nr_2_0_4", 8)])
def test_iterations_past_freezing_change_nothing(name, Z):
    """A frame frozen at iteration c <= T has the same bits and conv_iter
    after T and after 2T iterations: the kernel may stop at c."""
    qc = tcodes.qc_layout(tcodes.get_base_graph(name), Z)
    llr = torch.from_numpy(bpsk_llrs(qc.num_vars, 64, 0.0, seed=5))
    short_bits, short_conv = fm.make_fused_minsum(qc, 6, device="cpu")(llr)
    long_bits, long_conv = fm.make_fused_minsum(qc, 12, device="cpu")(llr)
    frozen = short_conv < 6
    assert 0 < int(frozen.sum()) < 64
    torch.testing.assert_close(long_bits[frozen], short_bits[frozen], rtol=0, atol=0)
    torch.testing.assert_close(long_conv[frozen], short_conv[frozen], rtol=0, atol=0)
    assert bool((long_conv[~frozen] >= 6).all()) and bool((long_conv > 6).any())


# ---------------------------------------------------------------------------
# The structure tables, through a numpy model of the kernel
# ---------------------------------------------------------------------------

_U = np.uint32


def _unpack(qc, parts: int = 1):
    st = fm._structure(qc)
    K, R, C = st.K, st.R, st.C
    g = fm._retire_structure(st, parts)
    assert g.dtype == np.int32 and g.shape == (6 * K + R + C + 2 + 2 * (parts + 1),)
    u = g.view(_U)
    return (st, u[:4 * K].reshape(K, 4), g[4 * K:6 * K].reshape(K, 2), g[6 * K:6 * K + R + 1],
            g[6 * K + R + 1:6 * K + R + C + 2], g[6 * K + R + C + 2:].reshape(2, parts + 1))


def _flip(a, bits):
    """a with its sign flipped where bit 31 of bits is set (flip_if)."""
    return (a.view(_U) ^ (bits & _U(0x80000000))).view(np.float32)


def kernel_model(qc, llr: np.ndarray, T: int, alpha: float, track: bool):
    """csrc/fused_retire.cu's algorithm on (frame, lane) arrays: check pass,
    syndrome from the sign bits of the beliefs it reads, retirement, column
    pass that expands the compressed state."""
    st, col_mem, row_mem, row_ptr, col_ptr, _ = _unpack(qc)
    Z, R, C = st.Z, st.R, st.C
    f32, alpha = np.float32, np.float32(alpha)
    pow2 = Z & (Z - 1) == 0

    def rolled(s, offset):
        if pow2:
            return ((z + s) & (Z - 1)) | offset
        v = z + s
        return np.where(v >= Z, v - Z, v) + offset

    B = llr.shape[0]
    z = np.arange(Z)
    bel = llr + f32(0.0)  # -0.0 -> +0.0
    A = np.zeros((B, R * Z, 2), f32)
    W = np.zeros((B, R * Z), _U)
    live = np.ones(B, bool)
    bits = np.zeros_like(llr)
    conv = np.full(B, T, np.int32)
    for t in range(T):
        violated = np.zeros((B, Z), bool)
        for r in range(R):
            q = r * Z + z
            a, w_old = A[:, q].copy(), W[:, q].copy()
            arg_old = w_old >> _U(27)
            j0, d = row_ptr[r], row_ptr[r + 1] - row_ptr[r]
            m1 = np.full((B, Z), 1e9, f32)
            m2 = m1.copy()
            arg = np.full((B, Z), 31, _U)
            neg = np.zeros((B, Z), _U)
            parity = np.zeros((B, Z), _U)
            for j in reversed(range(d)):  # the kernel folds the last member first
                b = bel[:, rolled(row_mem[j0 + j, 1], row_mem[j0 + j, 0])]
                c = _flip(np.where(arg_old == j, a[..., 1], a[..., 0]), w_old << _U(31 - j))
                x = b - c
                mag = np.abs(x)
                neg = (neg << _U(1)) | (x.view(_U) >> _U(31))
                parity ^= b.view(_U)
                arg = np.where(mag <= m1, _U(j), arg)
                m2 = np.minimum(np.maximum(mag, m1), m2)
                m1 = np.minimum(mag, m1)
            odd = np.bitwise_count(neg) & 1
            A[:, q, 0] = alpha * np.where(m1 < 1e9, m1, f32(0))
            A[:, q, 1] = alpha * np.where(m2 < 1e9, m2, f32(0))
            W[:, q] = (neg ^ np.where(odd == 1, _U((1 << d) - 1), _U(0))) | (arg << _U(27))
            violated |= (parity >> _U(31)).astype(bool)
        if track and t > 0:
            done = live & ~violated.any(axis=1)
            bits[done] = (bel[done] < 0).astype(f32)
            conv[done] = t
            live &= ~done
        for c in range(C):
            cs = np.zeros((B, Z), f32)
            for i in range(col_ptr[c], col_ptr[c + 1]):
                offset, shift, jz, sa = (int(v) for v in col_mem[i])
                q = rolled(Z - shift, offset)
                w = W[:, q]
                v = np.where((w & _U(0xF8000000)) == jz, A[:, q, 1], A[:, q, 0])
                cs = cs + _flip(v, w << _U(sa))
            bel[:, c * Z + z] = llr[:, c * Z + z] + cs
    bits[live] = (bel[live] < 0).astype(np.float32)
    return bits, conv


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,Z", [("toy_4x8", 4), ("nr_2_0_4", 8), ("nr_2_0_4", 24)])
def test_kernel_model_matches_plain(name, Z, kind):
    qc = tcodes.qc_layout(tcodes.get_base_graph(name), Z)
    llr = hard_llrs(kind, qc.num_vars, seed=Z)
    for track in (True, False):
        bits_m, conv_m = kernel_model(qc, llr, ITERS, 0.75, track)
        dec = fm.make_fused_minsum(qc, ITERS, 0.75, track_convergence=track, device="cpu")
        bits_p, conv_p = dec.plain(torch.from_numpy(llr))
        assert_decoder_parity("minsum", bits_m, conv_m, bits_p, conv_p)


def test_retire_structure_tables():
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 32)
    st, col_mem, row_mem, row_ptr, col_ptr, part = _unpack(qc, parts=3)
    Z = st.Z
    np.testing.assert_array_equal(np.diff(row_ptr), [len(m) for m in st.row_members])
    np.testing.assert_array_equal(np.diff(col_ptr), [len(m) for m in st.col_members])
    row_edges = [k for m in st.row_members for k in m]
    np.testing.assert_array_equal(row_mem[:, 0], [st.cols[k] * Z for k in row_edges])
    np.testing.assert_array_equal(row_mem[:, 1], [st.shifts[k] for k in row_edges])
    i = 0
    for members in st.col_members:
        for k in members:
            r = next(r for r, m in enumerate(st.row_members) if k in m)
            j = st.row_members[r].index(k)
            assert tuple(col_mem[i]) == (r * Z, st.shifts[k], j << 27, 31 - j)
            i += 1
    # Parts cover the rows and columns in order, with about equal work.
    for bounds, n_items in zip(part, (st.R, st.C)):
        assert bounds[0] == 0 and bounds[-1] == n_items and (np.diff(bounds) > 0).all()
    row_work = np.add([len(m) for m in st.row_members], 6)
    shares = [row_work[a:b].sum() / row_work.sum() for a, b in zip(part[0][:-1], part[0][1:])]
    assert max(shares) < 0.4


def test_retire_plans_and_shared_memory():
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 32)
    K, C, R, Z = qc.num_base_edges, qc.num_base_cols, qc.num_base_rows, 32
    words = -(-(6 * K + R + C + 2 + 2 * 5) // 4) * 4
    assert fm.retire_smem_bytes(qc, 4, 7) == 4 * (words + 7 * (2 * C * Z + 3 * R * Z))
    assert fm.retire_smem_bytes(qc, 1, 2) - fm.retire_smem_bytes(qc, 1, 1) == 29440
    plans = fm.retire_plans(qc)
    assert (4, 7) in plans and (4, 8) not in plans and (1, 7) in plans
    assert all(fm.retire_threads(qc, p, f) <= 1024 and f <= 15 for p, f in plans)
    qc64 = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_32"), 64)
    assert fm.retire_threads(qc64, 2, 3) == 384 and (2, 3) in fm.retire_plans(qc64)


def test_rows_beyond_the_state_word_are_refused(monkeypatch):
    """fused_retire refuses rows of more members than its 32-bit state word
    holds signs of, and sends them to its 64-bit word (fused_retire_wide),
    then to its 128-bit word (fused_retire_w128); rows beyond that word too
    go to the fused kernel."""
    qc = tcodes.qc_layout(tcodes.get_base_graph("toy_4x8"), 4)  # rows of up to 5 members
    assert fm.retire_kernel_fits(qc) and fm.make_fused_minsum(qc, 5, device="cpu").retire
    monkeypatch.setattr(fm, "_RETIRE_MAX_DEGREE", 4)
    assert not fm.retire_kernel_fits(qc) and fm.retire_kernel_fits(qc, word_bits=64)
    assert fm.make_fused_minsum(qc, 5, device="cpu").route == "fused_retire_wide"
    monkeypatch.setattr(fm, "_RETIRE_WIDE_MAX_DEGREE", 4)
    assert not fm.retire_kernel_fits(qc, word_bits=64)
    assert fm.make_fused_minsum(qc, 5, device="cpu").route == "fused_retire_w128"
    monkeypatch.setattr(fm, "_RETIRE_WIDER_MAX_DEGREE", 4)
    assert not fm.retire_kernel_fits(qc, word_bits=128)
    dec = fm.make_fused_minsum(qc, 5, device="cpu")
    assert not dec.retire and dec.graph is not None
    assert not fm.make_fused_minsum(qc, 5, mode="sumproduct", device="cpu").retire


def wide_row_shifts() -> np.ndarray:
    """(4, 32) base matrix whose first row has 31 members, more than
    fused_retire's 32-bit state word holds signs of; every column has a
    member."""
    rng = np.random.default_rng(3)
    shifts = np.where(rng.random((4, 32)) < 0.4, rng.integers(0, 4, (4, 32)), -1)
    shifts[0] = np.append(rng.integers(0, 4, 31), -1)
    shifts[1, 31] = 1
    return shifts


@pytest.mark.parametrize("track", [True, False])
def test_wide_rows_run_on_the_fused_kernel_and_match_jax(track):
    """A code with a row of 31 members: min-sum flooding is routed to
    fused_retire's 64-bit state word (fused_retire_wide) and no longer to
    the fused kernel; the plain version matches the JAX kernel."""
    import jax.numpy as jnp
    import ldpc_tpu.codes as jcodes
    from ldpc_tpu.ops import pallas_minsum as jpm

    shifts = wide_row_shifts()
    qc = tcodes.qc_layout(tcodes.BaseGraph("wide", shifts), 4)
    assert qc.dr_max == 31 and not fm.retire_kernel_fits(qc)
    assert fm.retire_kernel_fits(qc, word_bits=64)
    dec = fm.make_fused_minsum(qc, ITERS, 0.75, track_convergence=track, device="cpu")
    assert dec.retire and dec.route == "fused_retire_wide"
    jdec = jpm.make_fused_minsum(jcodes.qc_layout(jcodes.BaseGraph("wide", shifts), 4), ITERS,
                                 0.75, batch_tile=8, interpret=True, track_convergence=track)
    llr = bpsk_llrs(qc.num_vars, BATCH, 4.0, seed=9)
    bits_j, conv_j = jdec(jnp.asarray(llr))
    bits_t, conv_t = dec(torch.from_numpy(llr))
    assert_decoder_parity("minsum", bits_j, conv_j, bits_t, conv_t)
