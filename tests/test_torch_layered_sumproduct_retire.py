"""B1's and B2's layered sum-product paths, the ``retire_layered_sumproduct``
and ``retire_zlane_layered_sumproduct`` kernels (csrc/fused_retire.cu,
replace ldpc_tpu/ops/pallas_minsum.py:143 ``_kernel`` and :399
``_kernel_zlane`` for mode "sumproduct", schedule "layered").

Both run ``retire_layered``'s frame loop over a sum-product row update: a
frame's base rows in order, one lane a lifted check, each member's phi
computed once and added to S in member order, (belief + new) - old, c2v
check-aligned at (row_ptr[r] + j)*Z + z and never cleared (the first sweep
reads none), a parity pass after each sweep but the last, frames that
retire the sweep they converge.  ``retire_layered_sumproduct`` keeps a
frame's beliefs and c2v in shared memory, ``retire_zlane_layered_sumproduct``
the beliefs there and c2v in the frame group's slice of a global scratch.
Held here, on the CPU:

* the plain version (``fused_decode_plain`` -> ``_layered_row``) against the
  JAX kernels in interpret mode at the sum-product bars: ``make_fused_minsum``
  at nr_2_0_4 Z=4 and ``make_fused_minsum_zlane`` at nr_2_0_4 Z=24, one
  compile each, on noise, ties and zeros (-0.0 among them);
* a torch model of the kernels' per-lane algorithm on the wrapper's
  structure tables, its state read and written in place in one flat
  scratch laid out as each kernel lays it out, against the plain version:
  bits and conv_iter identical and, without tracking, every belief after
  every sweep (torch.equal);
* the shared-memory and scratch arithmetic, the plans and the routes.

No FMA hazard: the only product before a fold is +-1 * phi, exact, so the
JAX side runs in this process (contrast tests/test_torch_minsum_layered.py).
"""
import functools

import numpy as np
import pytest
import torch

from test_torch_minsum_retire import ITERS, KINDS, hard_llrs, wide_row_shifts
from test_torch_minsum_sumproduct_retire import wide_row_code
from test_torch_parity import assert_decoder_parity, bpsk_llrs

import ldpc_tpu_torch.codes as tcodes
from ldpc_tpu_torch.ops import fused_minsum as fm
from ldpc_tpu_torch.ops.qc_msg import _phi

JAX_KINDS = ("noise", "ties", "zeros")


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: the suite's workers run side by side, and the
    model's phi then runs over the same element ranges as the plain
    version's."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qc(name: str, Z: int):
    return tcodes.qc_layout(tcodes.get_base_graph(name), Z)


def _llrs(kind: str, n: int, seed: int) -> np.ndarray:
    """noise (-1 dB: frames that stop at sweeps 2 to 8) or one of the hard
    kinds of test_torch_minsum_retire.py; converged_at_1 at 12 dB, where a
    frame of 20,000 bits at Z=384 still needs a second sweep at 9 dB."""
    if kind == "noise":
        return bpsk_llrs(n, 13, -1.0, seed)
    if kind == "converged_at_1" and n > 10_000:
        return bpsk_llrs(n, 13, 12.0, seed)
    return hard_llrs(kind, n, seed)


def _build(qc, T: int, zlane: bool = False, **flags):
    build = fm.make_fused_minsum_zlane if zlane else fm.make_fused_minsum
    return build(qc, T, 1.0, mode="sumproduct", schedule="layered", device="cpu", **flags)


# ---------------------------------------------------------------------------
# The plain version against the JAX kernels
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_decoder(Z: int):
    import ldpc_tpu.codes as jcodes
    from ldpc_tpu.ops import pallas_minsum as jpm

    qc = jcodes.qc_layout(jcodes.get_base_graph("nr_2_0_4"), Z)
    build = jpm.make_fused_minsum if Z == 4 else jpm.make_fused_minsum_zlane
    return build(qc, ITERS, 1.0, batch_tile=8, interpret=True, mode="sumproduct",
                 schedule="layered")


@pytest.mark.parametrize("kind", JAX_KINDS)
@pytest.mark.parametrize("Z", [4, 24])
def test_plain_matches_jax(Z, kind):
    """nr_2_0_4 at Z=4 (make_fused_minsum) and Z=24 (make_fused_minsum_zlane),
    tracking, 8 sweeps: the sum-product bars (bits >= 99.9%, conv_iter
    within 1); frames stop at different sweeps."""
    import jax.numpy as jnp

    qc = _qc("nr_2_0_4", Z)
    llr = _llrs(kind, qc.num_vars, seed=Z + len(kind))
    if kind == "zeros":
        assert (np.signbit(llr) & (llr == 0)).any() and (~np.signbit(llr) & (llr == 0)).any()
    dec = _build(qc, ITERS, zlane=Z == 24)
    assert dec.route == ("retire_layered_sumproduct" if Z == 4
                         else "retire_zlane_layered_sumproduct")
    launches = dict(fm.LAUNCHES)
    bits_t, conv_t = dec(torch.from_numpy(llr))
    assert fm.LAUNCHES == launches  # a CPU tensor never reaches a kernel
    bits_j, conv_j = _jax_decoder(Z)(jnp.asarray(llr))
    assert_decoder_parity("sumproduct", bits_j, conv_j, bits_t, conv_t)
    assert len(set(conv_t.tolist())) > 1


# ---------------------------------------------------------------------------
# The kernels' algorithm, its state in place, against the plain version
# ---------------------------------------------------------------------------


def _unpack(qc):
    """The wrapper's layered structure: row members (col*Z, shift), row_ptr,
    the first row of each row group then R."""
    st = fm._structure(qc)
    K, R = st.K, st.R
    g = torch.from_numpy(fm._layered_structure(st).astype(np.int64))
    return st, g[:2 * K].reshape(K, 2), g[2 * K:2 * K + R + 1], g[2 * K + R + 1:]


def kernel_model(qc, llr: torch.Tensor, T: int, track: bool, parts: int, slots: int,
                 zlane: bool):
    """csrc/fused_retire.cu's layered sum-product kernels on (frame, lane)
    tensors.  ``slots`` frame groups take the batch's frames in waves; each
    group's state lives in one flat scratch laid out as the kernel lays it
    out (``zlane``: c2v alone, K*Z floats a group; else the beliefs, C*Z
    rounded to 16 bytes, then c2v), filled with NaN and never cleared, so a
    sweep that read a slot it should not would show.  A sweep runs the row
    groups in order and a group's rows `parts` at a time, side by side (each
    reads before any writes); lane (r, z) reads member j's belief at its
    rolled position and its c2v at (row_ptr[r] + j)*Z + z, none in the first
    sweep; phi_j once, S in member order, the sign bit flipped by sp ^
    sign(x_j), (belief + new) - old.  After each sweep but the last a parity
    pass from the sign bits; a frame that passes retires.  Returns bits,
    conv_iter and, per sweep, (live frames, beliefs)."""
    st, row_mem, row_ptr, grp_ptr = _unpack(qc)
    Z, C, K = st.Z, st.C, st.K
    z = torch.arange(Z)
    pow2 = Z & (Z - 1) == 0
    bel_words = -(-C * Z // 4) * 4
    c2v_words = -(-K * Z // 4) * 4
    if zlane:
        assert 4 * c2v_words == fm.retire_zlane_layered_sumproduct_scratch_bytes(qc)
        frame_words, c2v_at0 = c2v_words, 0
    else:
        frame_words, c2v_at0 = bel_words + c2v_words, bel_words
        assert 4 * frame_words == (fm.retire_layered_sumproduct_smem_bytes(qc, 2)
                                   - fm.retire_layered_sumproduct_smem_bytes(qc, 1))
    scratch = torch.full((slots, frame_words), float("nan"))

    def rolled(s, offset):
        if pow2:
            return ((z + s) & (Z - 1)) | offset
        v = z + s
        return torch.where(v >= Z, v - Z, v) + offset

    def row_update(bel, c2v, r, first):
        """Row r's lanes: (belief positions, new beliefs, c2v slots, new c2v)."""
        j0, d = int(row_ptr[r]), int(row_ptr[r + 1] - row_ptr[r])
        pos = torch.cat([rolled(int(row_mem[j0 + j, 1]), int(row_mem[j0 + j, 0]))
                         for j in range(d)])
        slot = torch.cat([(j0 + j) * Z + z for j in range(d)])
        m = bel.shape[0]
        b = bel[:, pos].reshape(m, d, Z)
        old = torch.zeros_like(b) if first else c2v[:, slot].reshape(m, d, Z)
        x = b - old
        ph = _phi(torch.clamp(x.abs(), 1e-7, 20.0))
        S = torch.zeros((m, Z))
        for j in range(d):  # member order
            S = S + ph[:, j]
        neg = torch.signbit(x)
        sp = neg.sum(dim=1) % 2 == 1
        out = _phi(torch.clamp(S[:, None] - ph, min=1e-7))
        new = torch.where(sp[:, None] ^ neg, -out, out)  # the sign bit flipped
        return pos, ((b + new) - old).reshape(m, d * Z), slot, new.reshape(m, d * Z)

    B = llr.shape[0]
    bits = torch.zeros_like(llr)
    conv = torch.full((B,), T, dtype=torch.int32)
    live_at = torch.zeros((T, B), dtype=torch.bool)
    bel_at = torch.zeros((T,) + tuple(llr.shape))
    for f0 in range(0, B, slots):
        m = min(slots, B - f0)
        group = scratch[:m]
        c2v = group[:, c2v_at0:c2v_at0 + K * Z]  # views into the scratch
        bel = group[:, :C * Z] if not zlane else torch.empty((m, C * Z))
        bel.copy_(llr[f0:f0 + m] + 0.0)  # -0.0 -> +0.0
        live = torch.ones(m, dtype=torch.bool)
        for t in range(T):
            for g0, g1 in zip(grp_ptr[:-1].tolist(), grp_ptr[1:].tolist()):
                for r0 in range(g0, g1, parts):
                    updates = [row_update(bel, c2v, r, t == 0)
                               for r in range(r0, min(r0 + parts, g1))]
                    for pos, new_bel, slot, new in updates:
                        bel[:, pos] = torch.where(live[:, None], new_bel, bel[:, pos])
                        c2v[:, slot] = torch.where(live[:, None], new, c2v[:, slot])
            live_at[t, f0:f0 + m], bel_at[t, f0:f0 + m] = live, bel
            if track and t + 1 < T:
                parity = torch.zeros((m, st.R * Z), dtype=torch.bool)
                for r in range(st.R):
                    for i in range(int(row_ptr[r]), int(row_ptr[r + 1])):
                        p = rolled(int(row_mem[i, 1]), int(row_mem[i, 0]))
                        parity[:, r * Z:(r + 1) * Z] ^= torch.signbit(bel[:, p])
                done = live & ~parity.any(dim=1)
                bits[f0:f0 + m][done] = (bel[done] < 0).to(torch.float32)
                conv[f0:f0 + m][done] = t + 1
                live &= ~done
                if not bool(live.any()):
                    break
        bits[f0:f0 + m][live] = (bel[live] < 0).to(torch.float32)
    return bits, conv, list(zip(live_at, bel_at))


def plain_sweeps(qc, llr: torch.Tensor, T: int) -> list[torch.Tensor]:
    """The plain version's beliefs after each layered sweep
    (fused_decode_plain's row loop, no freezing)."""
    st = fm._structure(qc)
    ix = fm._PlainIndex(st, llr.device)
    bel = llr.clone()
    c2v = torch.zeros((llr.shape[0], st.K * st.Z))
    out = []
    for _ in range(T):
        for row in ix.rows:
            fm._layered_row(bel, c2v, row, st.Z, 1.0, True)
        out.append(bel.clone())
    return out


def _check_model(qc, llr: torch.Tensor, parts: int, slots: int, zlane: bool) -> torch.Tensor:
    """Tracked: bits and conv_iter identical to the plain version.  Throughput
    mode: every belief after every sweep identical (torch.equal) too.
    Returns the tracked conv_iter."""
    bits_p, conv = _build(qc, ITERS, zlane).plain(llr)
    bits_m, conv_m, _ = kernel_model(qc, llr, ITERS, True, parts, slots, zlane)
    assert torch.equal(bits_m, bits_p) and torch.equal(conv_m, conv)
    bits_m, conv_m, history = kernel_model(qc, llr, ITERS, False, parts, slots, zlane)
    for (live, bel_m), bel_p in zip(history, plain_sweeps(qc, llr, ITERS)):
        assert bool(live.all()) and torch.equal(bel_m, bel_p)
    bits_p, _ = _build(qc, ITERS, zlane, track_convergence=False).plain(llr)
    assert torch.equal(bits_m, bits_p) and bool((conv_m == ITERS).all())
    return conv


def _check_kind(conv: torch.Tensor, kind: str) -> None:
    """The batch has the property its kind names: every frame stops at the
    first sweep, none stops, or (ties, zeros) the frames stop at one sweep
    or more."""
    if kind == "converged_at_1":
        assert bool((conv == 1).all())
    elif kind == "never_converged":
        assert bool((conv == ITERS).all())
    else:
        assert bool((conv < ITERS).any())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,Z,parts,slots", [("toy_4x8", 4, 1, 13), ("nr_2_0_4", 4, 2, 13),
                                                ("nr_2_0_32", 32, 3, 5)])
def test_model_matches_plain(name, Z, parts, slots, kind):
    """Shared memory (retire_layered_sumproduct): beliefs and c2v of a frame
    group in one region.  At Z=32 five groups take 13 frames in waves; at
    Z=4 one wave (the phi then see the plain version's element ranges)."""
    qc = _qc(name, Z)
    llr = torch.from_numpy(_llrs(kind, qc.num_vars, seed=Z + 3 * len(kind)))
    conv = _check_model(qc, llr, parts, slots, zlane=False)
    _check_kind(conv, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_slice_model_matches_plain_z384(kind):
    """The L2 slice (retire_zlane_layered_sumproduct) at nr_2_0_32 Z=384: 6
    frames, two groups of two parts taking them in three waves."""
    qc = _qc("nr_2_0_32", 384)
    llr = torch.from_numpy(_llrs(kind, qc.num_vars, seed=384 + len(kind))[:6])
    _check_kind(_check_model(qc, llr, parts=2, slots=2, zlane=True), kind)


@pytest.mark.parametrize("zlane", [False, True])
def test_model_wide_rows(zlane):
    """A row of 20 members (the kernels' run-time loop, phi kept in a local
    array): beliefs, bits and conv_iter as above; the slice layout at Z=8."""
    qc = wide_row_code(20, Z=8 if zlane else 4)
    if zlane:
        assert fm.retire_zlane_layered_sumproduct_fits(qc)
    assert qc.dr_max == 20 and fm.retire_layered_sumproduct_fits(qc)
    llr = torch.from_numpy(bpsk_llrs(qc.num_vars, 13, 6.0, seed=6))
    conv = _check_model(qc, llr, parts=1, slots=13, zlane=zlane)
    assert len(set(conv.tolist())) > 1


@pytest.mark.parametrize("name,Z", [("nr_2_0_4", 4), ("nr_2_0_32", 32)])
def test_sweeps_past_freezing_change_nothing(name, Z):
    """A frame frozen at sweep c < 4 has the same bits and conv_iter after 4
    and after 8 sweeps, and early exit changes no output: the kernels may
    stop a frame at c.  At -2 dB frames stop at sweeps 2 to 8."""
    qc = _qc(name, Z)
    llr = torch.from_numpy(bpsk_llrs(qc.num_vars, 16, -2.0, seed=Z))
    short_bits, short_conv = _build(qc, 4).plain(llr)
    long_bits, long_conv = _build(qc, 8).plain(llr)
    frozen = short_conv < 4
    assert 0 < int(frozen.sum()) < 16
    assert torch.equal(long_bits[frozen], short_bits[frozen])
    assert torch.equal(long_conv[frozen], short_conv[frozen])
    exit_bits, exit_conv = _build(qc, 8, early_exit=True).plain(llr)
    assert torch.equal(exit_bits, long_bits) and torch.equal(exit_conv, long_conv)


# ---------------------------------------------------------------------------
# Plans, bytes and routes
# ---------------------------------------------------------------------------


def test_plans_and_bytes():
    """31,872 bytes a frame at NR BG2 Z=32 (C*Z beliefs and K*Z c2v floats)
    beside the 1,872-byte layered structure: 7 frames a block, up to 3
    parts (21 warps, 672 threads).  At Z=384 the beliefs alone, 79,872
    bytes, and 302,592 bytes of c2v scratch a frame group; plans within 768
    threads a block."""
    qc = _qc("nr_2_0_32", 32)
    R, C, K = qc.num_base_rows, qc.num_base_cols, qc.num_base_edges
    assert 4 * (C * 32 + K * 32) == 31872
    one, two = (fm.retire_layered_sumproduct_smem_bytes(qc, f) for f in (1, 2))
    assert two - one == 31872 and one - 31872 == 1872
    assert fm.retire_layered_sumproduct_smem_bytes(qc, 7) == 224_976 <= fm._SMEM_BUDGET
    assert fm.retire_layered_sumproduct_smem_bytes(qc, 8) > fm._SMEM_BUDGET
    plans = fm.retire_layered_sumproduct_plans(qc)
    assert (3, 7) in plans and max(f for _, f in plans) == 7 and {p for p, _ in plans} == {1, 2, 3}
    assert fm.retire_threads(qc, 3, 7) == 672
    qc384 = _qc("nr_2_0_32", 384)
    assert fm.retire_zlane_layered_sumproduct_scratch_bytes(qc384) == 302_592 == 4 * K * 384
    assert fm.retire_zlane_layered_sumproduct_smem_bytes(qc384) == 1872 + 79_872
    assert fm.retire_zlane_layered_sumproduct_plans(qc384) == [(1, 1), (1, 2), (2, 1)]
    assert not fm.retire_layered_sumproduct_fits(qc384)
    for q in (qc, qc384, _qc("toy_4x8", 4), _qc("nr_2_0_32", 24)):
        for p, f in (fm.retire_layered_sumproduct_plans(q)
                     + fm.retire_zlane_layered_sumproduct_plans(q)):
            assert fm.retire_threads(q, p, f) <= fm._LAYERED_SUMPRODUCT_MAX_THREADS == 768
    # One-warp frames: 24 a block within 768 threads.
    assert max(f for _, f in fm.retire_layered_sumproduct_plans(_qc("toy_4x8", 4))) == 24
    assert fm.retire_zlane_layered_sumproduct_plans(_qc("nr_2_0_4", 12)) == []


class _OccupancyModel:
    """Stands in for the kernel library's occupancy queries: resident blocks
    an SM limited by 2048 threads, 65,536 registers at 80 a thread and
    233,472 bytes of shared memory (1 KB of it kept back a block)."""

    def __init__(self, qc):
        self.qc = qc

    def _blocks(self, p, f, smem):
        threads = fm.retire_threads(self.qc, p, f)
        return min(2048 // threads, 65536 // (80 * threads), 233_472 // (smem + 1024))

    def ldpc_retire_layered_sumproduct_occupancy(self, Z, R, C, K, G, p, f, track, word_bits):
        return self._blocks(p, f, fm.retire_layered_sumproduct_smem_bytes(self.qc, f))

    def ldpc_retire_zlane_layered_sumproduct_occupancy(self, Z, R, C, K, G, p, f, track,
                                                       word_bits):
        return self._blocks(p, f, fm.retire_zlane_layered_sumproduct_smem_bytes(self.qc, f))


def test_plan_rule():
    """The plans take the most resident frames an SM, then the fewest parts,
    then the fewest frames a block, with no cap on frame groups: 7 frames of
    one warp at Z=32 (not of three), two frame groups of one part at Z=384,
    one group of two parts when parts=2 is asked for."""
    qc32, qc384 = _qc("nr_2_0_32", 32), _qc("nr_2_0_32", 384)
    lib32, lib384 = _OccupancyModel(qc32), _OccupancyModel(qc384)
    assert fm.retire_layered_sumproduct_plan(qc32, True, lib=lib32) == (1, 7, 1)
    assert fm.retire_layered_sumproduct_plan(qc32, True, 3, lib=lib32) == (3, 7, 1)
    assert fm.retire_zlane_layered_sumproduct_plan(qc384, True, lib=lib384) == (1, 1, 2)
    assert fm.retire_zlane_layered_sumproduct_plan(qc384, True, 2, lib=lib384) == (2, 1, 1)
    # No frame group an SM is capped: at Z=32 the L2-slice kernel keeps as
    # many one-warp frames as the registers allow, 25 in this model.
    plan = fm.retire_zlane_layered_sumproduct_plan(qc32, True, lib=_OccupancyModel(qc32))
    assert plan[0] == 1 and plan[1] * plan[2] == 25


def test_routes_and_launch_counters():
    """Layered sum-product routes to retire_layered_sumproduct on a fused
    decoder and to retire_zlane_layered_sumproduct on a fused_zlane decoder,
    every flag set, both keeping the CSR structure for the side doors; a row
    of 31 members goes to retire_layered_sumproduct_wide on a fused decoder
    and to retire_zlane_layered_sumproduct_wide on a fused_zlane one, a row
    of 122 keeps fused_zlane; a CPU tensor moves no launch counter."""
    for name, Z in [("toy_4x8", 4), ("nr_2_0_4", 4), ("nr_2_0_32", 24), ("nr_2_0_32", 32),
                    ("nr_2_0_32", 64)]:
        for track, early_exit in ((True, False), (False, False), (True, True)):
            dec = _build(_qc(name, Z), 5, track_convergence=track, early_exit=early_exit)
            assert dec.route == "retire_layered_sumproduct" and dec.retire
            assert dec.graph is not None  # the CSR structure _launch_fused needs
    for Z in (24, 256, 384):
        qc = _qc("nr_2_0_4" if Z == 24 else "nr_2_0_32", Z)
        dec = _build(qc, 5, zlane=True)
        assert dec.route == "retire_zlane_layered_sumproduct" and dec.retire
        assert dec.graph is not None
    wide = tcodes.qc_layout(tcodes.BaseGraph("wide", wide_row_shifts()), 8)
    assert wide.dr_max == 31 and not fm.retire_layered_sumproduct_fits(wide)
    assert fm.retire_layered_sumproduct_fits(wide, word_bits=64)
    assert not fm.retire_zlane_layered_sumproduct_fits(wide)
    assert _build(wide, 5).route == "retire_layered_sumproduct_wide"
    assert _build(wide, 5, zlane=True).route == "retire_zlane_layered_sumproduct_wide"
    from test_torch_retire_wide import row_code

    assert _build(row_code(122, cols=124, Z=8), 5, zlane=True).route == "fused_zlane"
    assert {"retire_layered_sumproduct", "retire_zlane_layered_sumproduct"} <= set(fm.RETIRING)
    assert set(fm.RETIRING) <= set(fm.LAUNCHES)
    launches = dict(fm.LAUNCHES)
    small = _qc("nr_2_0_4", 24)
    llr = torch.from_numpy(bpsk_llrs(small.num_vars, 3, 1.0, seed=1))
    _build(small, 3)(llr)
    _build(small, 3, zlane=True)(llr)
    assert fm.LAUNCHES == launches
