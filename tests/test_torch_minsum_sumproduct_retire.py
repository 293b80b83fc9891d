"""B1's sum-product flooding path, the ``retire_sumproduct`` kernel
(csrc/fused_retire.cu, replaces ldpc_tpu/ops/pallas_minsum.py:143 ``_kernel``
for mode "sumproduct", schedule "flooding").

The kernel runs ``fused_retire``'s frame loop with one float of c2v a lifted
edge, check-aligned, computes each member's phi once and adds them to S in
member order, reads the syndrome off the next check pass and lets a frame
go the iteration it converges.  Held here, on the CPU, with no JAX (the
plain version is held against the JAX kernel by
tests/test_torch_minsum_sumproduct.py):

* the premise of retiring: iterations past a frame's freezing change
  neither its bits nor its conv_iter;
* a torch model of the kernel's per-lane algorithm on the wrapper's
  structure tables, whose beliefs after every iteration equal the plain
  version's (``_check_update_slots`` plus the column sum) and whose bits and
  conv_iter equal ``fused_decode_plain``'s;
* the shared-memory plans, the structure and the routes.
"""
import numpy as np
import pytest
import torch

from test_torch_minsum_retire import KINDS, hard_llrs
from test_torch_parity import bpsk_llrs

import ldpc_tpu_torch.codes as tcodes
from ldpc_tpu_torch.models.classical import BeliefPropagationDecoder
from ldpc_tpu_torch.ops import fused_minsum as fm
from ldpc_tpu_torch.ops.qc_msg import _phi

ITERS = 8


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: the suite's workers run side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qc(name: str, Z: int):
    return tcodes.qc_layout(tcodes.get_base_graph(name), Z)


def wide_row_code(members: int = 20, Z: int = 4):
    """A (4, 32) base graph at ``Z`` whose first row has ``members`` members:
    more than the kernel keeps phi of in registers (12), at most the 27 a
    state word holds signs of.  Every column has a member."""
    rng = np.random.default_rng(3)
    shifts = np.where(rng.random((4, 32)) < 0.4, rng.integers(0, 4, (4, 32)), -1)
    shifts[0] = np.concatenate([rng.integers(0, 4, members), np.full(32 - members, -1)])
    shifts[1, members:] = 1
    return tcodes.qc_layout(tcodes.BaseGraph("wide", shifts), Z)


def _llrs(kind: str, n: int, seed: int) -> torch.Tensor:
    """noise (1 dB, a mix of frames) or one of the hard kinds of
    test_torch_minsum_retire.py."""
    if kind == "noise":
        return torch.from_numpy(bpsk_llrs(n, 13, 1.0, seed))
    return torch.from_numpy(hard_llrs(kind, n, seed))


def _bp(qc, T: int, **flags):
    return fm.make_fused_minsum(qc, T, 1.0, mode="sumproduct", device="cpu", **flags)


# ---------------------------------------------------------------------------
# Retirement's premise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ("noise",) + KINDS)
@pytest.mark.parametrize("name,Z", [("nr_2_0_4", 4), ("nr_2_0_32", 24)])
def test_iterations_past_freezing_change_nothing(name, Z, kind):
    """A frame frozen at iteration c < 5 has the same bits and conv_iter
    after 5 and after 20 iterations, and early exit changes no output: the
    kernel may stop a frame at c."""
    qc = _qc(name, Z)
    llr = _llrs(kind, qc.num_vars, seed=Z + len(kind))
    short_bits, short_conv = _bp(qc, 5).plain(llr)
    long_bits, long_conv = _bp(qc, 20).plain(llr)
    frozen = short_conv < 5
    assert torch.equal(long_bits[frozen], short_bits[frozen])
    assert torch.equal(long_conv[frozen], short_conv[frozen])
    assert bool((long_conv[~frozen] >= 5).all())
    exit_bits, exit_conv = _bp(qc, 20, early_exit=True).plain(llr)
    assert torch.equal(exit_bits, long_bits) and torch.equal(exit_conv, long_conv)
    if kind == "converged_at_1":
        assert bool(frozen.all())
    elif kind == "never_converged":
        assert not bool(frozen.any())
    else:  # frames stop at different iterations; with zeros, some after 5
        assert bool(frozen.any()) and len(set(long_conv.tolist())) > 1
        assert kind != "zeros" or not bool(frozen.all())


# ---------------------------------------------------------------------------
# The kernel's algorithm on the structure tables, against the plain version
# ---------------------------------------------------------------------------


def _unpack(qc):
    """The wrapper's sum-product structure: column members (edge offset i*Z,
    shift, ...), row members (col*Z, shift), row_ptr, col_ptr."""
    st = fm._structure(qc)
    K, R, C = st.K, st.R, st.C
    g = torch.from_numpy(fm._retire_structure(st, 1, per_edge=True).astype(np.int64))
    return (st, g[:4 * K].reshape(K, 4), g[4 * K:6 * K].reshape(K, 2), g[6 * K:6 * K + R + 1],
            g[6 * K + R + 1:6 * K + R + C + 2])


def kernel_model(qc, llr: torch.Tensor, T: int, track: bool):
    """csrc/fused_retire.cu's sum-product algorithm on (frame, lane)
    tensors: check pass (v2c from check-aligned c2v, phi_j kept per member
    and added to S in member order, signs from sign bits, the syndrome of
    the beliefs it reads), retirement, column pass.  Returns bits, conv_iter
    and, per iteration, (live frames, beliefs after the column pass).

    The check pass runs the lanes (r, z) of every row at once, member slot
    by member slot, each lane's arithmetic the kernel's thread's."""
    st, col_mem, row_mem, row_ptr, col_ptr = _unpack(qc)
    Z, R, C, K = st.Z, st.R, st.C, st.K
    z = torch.arange(Z)
    pow2 = Z & (Z - 1) == 0

    def rolled(s, offset):
        if pow2:
            return ((z + s) & (Z - 1)) | offset
        v = z + s
        return torch.where(v >= Z, v - Z, v) + offset

    # Member slot j of every lane (r, z): the belief it reads, its own c2v
    # slot (row_ptr[r] + j)*Z + z, whether row r has a member j.
    degree = row_ptr[1:] - row_ptr[:-1]
    dr = int(degree.max())
    bel_at = torch.zeros((dr, R * Z), dtype=torch.int64)
    c2v_at = torch.zeros((dr, R * Z), dtype=torch.int64)
    valid = torch.zeros((dr, R * Z), dtype=torch.bool)
    for r in range(R):
        lanes = slice(r * Z, (r + 1) * Z)
        for j in range(int(degree[r])):
            i = int(row_ptr[r]) + j
            bel_at[j, lanes] = rolled(int(row_mem[i, 1]), int(row_mem[i, 0]))
            c2v_at[j, lanes] = i * Z + z
            valid[j, lanes] = True

    B = llr.shape[0]
    bel = llr + 0.0  # -0.0 -> +0.0
    c2v = torch.zeros((B, K * Z))
    live = torch.ones(B, dtype=torch.bool)
    bits = torch.zeros_like(llr)
    conv = torch.full((B,), T, dtype=torch.int32)
    history = []
    for t in range(T):
        # Check pass.
        S = torch.zeros((B, R * Z))
        neg = torch.zeros((B, dr, R * Z), dtype=torch.bool)
        parity = torch.zeros((B, R * Z), dtype=torch.bool)
        ph = []
        for j in range(dr):
            b = bel[:, bel_at[j]]
            x = b - c2v[:, c2v_at[j]]
            neg[:, j] = torch.signbit(x) & valid[j]
            parity ^= torch.signbit(b) & valid[j]
            ph.append(_phi(torch.clamp(x.abs(), 1e-7, 20.0)))
        for j in range(dr):  # S in member order
            S = torch.where(valid[j], S + ph[j], S)
        sp = neg.sum(dim=1) % 2 == 1
        new = c2v.clone()
        for j in range(dr):
            out = _phi(torch.clamp(S - ph[j], min=1e-7))
            out = torch.where(sp ^ neg[:, j], -out, out)  # the sign bit flipped
            new[:, c2v_at[j][valid[j]]] = out[:, valid[j]]
        if track and t > 0:
            done = live & ~parity.any(dim=1)
            bits[done] = (bel[done] < 0).to(torch.float32)
            conv[done] = t
            live &= ~done
        c2v = torch.where(live[:, None], new, c2v)
        # Column pass.
        out = bel.clone()
        for c in range(C):
            cs = torch.zeros((B, Z))
            for i in range(int(col_ptr[c]), int(col_ptr[c + 1])):
                cs = cs + c2v[:, rolled(Z - int(col_mem[i, 1]), int(col_mem[i, 0]))]
            out[:, c * Z:(c + 1) * Z] = llr[:, c * Z:(c + 1) * Z] + cs
        bel = torch.where(live[:, None], out, bel)
        history.append((live.clone(), bel.clone()))
    bits[live] = (bel[live] < 0).to(torch.float32)
    return bits, conv, history


def plain_beliefs(qc, llr: torch.Tensor, T: int) -> list[torch.Tensor]:
    """The plain version's beliefs after each flooding iteration:
    ``_check_update_slots`` then the column sum, as fused_decode_plain."""
    st = fm._structure(qc)
    ix = fm._PlainIndex(st, llr.device)
    c2v = torch.zeros((llr.shape[0], st.K * st.Z))
    bel, out = llr.clone(), []
    for _ in range(T):
        fm._check_update_slots(bel, c2v, ix, 1.0, True)
        colsum = torch.zeros_like(llr)
        for j in range(ix.c_idx.shape[0]):
            colsum = colsum + torch.where(ix.c_valid[j], c2v[:, ix.c_idx[j]], 0.0)
        bel = llr + colsum
        out.append(bel)
    return out


MODEL_CODES = [("toy_4x8", 4), ("nr_2_0_4", 4), ("nr_2_0_32", 24), ("nr_2_0_32", 32)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,Z", MODEL_CODES)
def test_kernel_model_matches_plain(name, Z, kind):
    """Beliefs of every live frame after every iteration identical
    (torch.equal) to the plain version's; bits and conv_iter identical to
    fused_decode_plain's, tracked and in throughput mode."""
    qc = _qc(name, Z)
    llr = _llrs(kind, qc.num_vars, seed=Z + 3 * len(kind))
    reference = plain_beliefs(qc, llr, ITERS)
    for track in (True, False):
        bits_m, conv_m, history = kernel_model(qc, llr, ITERS, track)
        for (live, bel_m), bel_p in zip(history, reference):
            assert torch.equal(bel_m[live], bel_p[live])
        bits_p, conv_p = _bp(qc, ITERS, track_convergence=track).plain(llr)
        assert torch.equal(bits_m, bits_p) and torch.equal(conv_m, conv_p)
        if track and kind == "converged_at_1":
            assert bool((conv_m == 1).any())
        if not track:
            assert bool((conv_m == ITERS).all())


def test_kernel_model_wide_rows():
    """A row of 20 members (the kernel parks its phi in the c2v slots):
    beliefs, bits and conv_iter as above."""
    qc = wide_row_code(20)
    assert qc.dr_max == 20 and fm.retire_sumproduct_fits(qc)
    llr = torch.from_numpy(bpsk_llrs(qc.num_vars, 13, 5.0, seed=6))  # 1 to 8 iterations
    reference = plain_beliefs(qc, llr, ITERS)
    bits_m, conv_m, history = kernel_model(qc, llr, ITERS, True)
    for (live, bel_m), bel_p in zip(history, reference):
        assert torch.equal(bel_m[live], bel_p[live])
    bits_p, conv_p = _bp(qc, ITERS).plain(llr)
    assert torch.equal(bits_m, bits_p) and torch.equal(conv_m, conv_p)
    assert len(set(conv_m.tolist())) > 1


# ---------------------------------------------------------------------------
# Plans, structure and routes
# ---------------------------------------------------------------------------


def test_plans_and_shared_memory():
    """31,872 bytes a frame at NR BG2 Z=32 (beliefs C*Z and c2v K*Z floats),
    38,528 with the LLRs staged; the structure 5,152 bytes at 4 parts.  So 7
    frames a block with the LLRs read from the input rows, 5 staged."""
    qc = _qc("nr_2_0_32", 32)
    K, C, Z = qc.num_base_edges, qc.num_base_cols, 32
    assert 4 * (C * Z + K * Z) == 31872
    one, two = (fm.retire_sumproduct_smem_bytes(qc, 4, f) for f in (1, 2))
    assert two - one == 31872 and one - 31872 == 5152
    staged = [fm.retire_sumproduct_smem_bytes(qc, 4, f, staged=True) for f in (1, 2)]
    assert staged[1] - staged[0] == 38528 and staged[0] - 38528 == 5152
    plans = fm.retire_sumproduct_plans(qc)
    assert (4, 7, False) in plans and (4, 8, False) not in plans
    assert (4, 5, True) in plans and (4, 6, True) not in plans
    assert all(fm.retire_threads(qc, p, f) <= 1024 and f <= 15 for p, f, _ in plans)
    qc64 = _qc("nr_2_0_32", 64)
    assert max(f for p, f, s in fm.retire_sumproduct_plans(qc64) if not s) == 3


def test_structure_carries_edge_offsets():
    """The sum-product structure is fused_retire's with each column
    member's r*Z replaced by its edge's row-order offset i*Z."""
    qc = _qc("nr_2_0_32", 32)
    st = fm._structure(qc)
    minsum = fm._retire_structure(st, 3)
    sumproduct = fm._retire_structure(st, 3, per_edge=True)
    K, Z = st.K, st.Z
    np.testing.assert_array_equal(minsum[4 * K:], sumproduct[4 * K:])
    cols_m, cols_s = minsum[:4 * K].reshape(K, 4), sumproduct[:4 * K].reshape(K, 4)
    np.testing.assert_array_equal(cols_m[:, 1:], cols_s[:, 1:])
    position = {k: i for i, k in enumerate(k for m in st.row_members for k in m)}
    np.testing.assert_array_equal(cols_s[:, 0],
                                  [position[k] * Z for m in st.col_members for k in m])


def test_routes_and_launch_counters():
    """Sum-product flooding (builders and serving object) routes to
    retire_sumproduct where the retiring kernels take the code, keeping the
    CSR structure for the replaced kernel (retire_zlane_sumproduct on a
    fused_zlane decoder); sum-product layered goes to
    retire_layered_sumproduct and rows of 31 members to
    retire_sumproduct_wide; a CPU
    tensor moves no launch counter."""
    from test_torch_minsum_retire import wide_row_shifts

    for name, Z in MODEL_CODES + [("nr_2_0_32", 64)]:
        qc = _qc(name, Z)
        assert fm.retire_kernel_fits(qc) and fm.retire_sumproduct_fits(qc)
        for dec in (fm.make_fused_bp(qc, 20, device="cpu"), _bp(qc, 20, early_exit=True),
                    _bp(qc, 20, track_convergence=False)):
            assert dec.route == "retire_sumproduct" and dec.retire and dec.graph is not None
    qc = _qc("nr_2_0_32", 32)
    server = BeliefPropagationDecoder(qc, 20, early_stopping=False, device="cpu")
    assert server._fused.route == "retire_sumproduct"
    layered = _bp(qc, 20, schedule="layered")
    assert layered.route == "retire_layered_sumproduct" and layered.retire
    wide = tcodes.qc_layout(tcodes.BaseGraph("wide", wide_row_shifts()), 4)
    assert not fm.retire_sumproduct_fits(wide) and fm.retire_sumproduct_fits(wide, word_bits=64)
    assert _bp(wide, 5).route == "retire_sumproduct_wide"
    assert fm.retire_sumproduct_fits(wide_row_code(20))
    zl = fm.make_fused_minsum_zlane(_qc("nr_2_0_32", 384), 5, mode="sumproduct", device="cpu")
    assert zl.route == "retire_zlane_sumproduct"
    assert "retire_sumproduct" in fm.LAUNCHES
    launches = dict(fm.LAUNCHES)
    small = _qc("nr_2_0_4", 4)
    llr = torch.from_numpy(bpsk_llrs(small.num_vars, 3, 1.0, seed=1))
    fm.make_fused_bp(small, 3, device="cpu")(llr)
    server.decode(torch.zeros((2, qc.num_vars)))
    assert fm.LAUNCHES == launches
