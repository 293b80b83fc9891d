"""B2's layered min-sum and sum-product flooding paths at large Z, the
``retire_zlane_layered`` and ``retire_zlane_sumproduct`` kernels
(csrc/fused_retire.cu, replace ldpc_tpu/ops/pallas_minsum.py:399
``_kernel_zlane`` for schedule "layered" in mode "minsum" and for mode
"sumproduct" with the flooding schedule).

They run ``retire_layered``'s and ``retire_sumproduct``'s algorithms for Z
where a frame's beliefs and check state exceed a block's shared memory: the
beliefs stay in shared memory and the check state lives in a frame group's
slice of a global scratch (layered: A = (alpha*m1, alpha*m2), then the state
words W; sum-product: c2v, one float a lifted edge).  Held here, on the
CPU:

* the shared-memory and scratch arithmetic and the plans, with fixed byte
  counts at nr_2_0_32 Z=384 and Z=256;
* the routes of a ``fused_zlane`` decoder at Z in {256, 288, 384} and at
  nr_2_0_4 Z=24, the serving objects', and the launch counters, which a CPU
  tensor leaves alone;
* numpy / torch models of the two kernels' per-lane algorithms on the
  wrapper's structure tables, with the state read and written through the
  slices as the scratch lays them out (frame groups that take frame after
  frame, layered slices never cleared), against the plain version at Z=384
  and Z=256 on the hard input kinds, tracking on and off: bits and
  conv_iter identical;
* the plain version against the JAX zlane kernel in interpret mode at
  nr_2_0_4 Z=24 on the ties and zeros kinds, both paths, in one child
  process whose XLA targets no FMA (``--xla_cpu_max_isa=AVX``; see
  tests/test_torch_minsum_layered.py), started with the first case where a
  JAX case is to run.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_minsum_layered import _unpack as _layered_unpack
from test_torch_minsum_retire import ITERS, KINDS, _check_kind, _flip, hard_llrs
from test_torch_minsum_sumproduct_retire import plain_beliefs
from test_torch_parity import assert_decoder_parity, bpsk_llrs

import ldpc_tpu_torch.codes as tcodes
from ldpc_tpu_torch.models.classical import BeliefPropagationDecoder, MinSumScaledDecoder
from ldpc_tpu_torch.ops import fused_minsum as fm
from ldpc_tpu_torch.ops.qc_msg import _phi

_U = np.uint32
# Frame groups of the models: 8 frames in waves of 5 and 3.
SLOTS = 5


@pytest.fixture(autouse=True)
def one_thread():
    """The plain version and the models run many small operations; one
    torch thread each, so several test workers do not fight over the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qc(Z: int, name: str = "nr_2_0_32"):
    return tcodes.qc_layout(tcodes.get_base_graph(name), Z)


def large_z_llrs(kind: str, n: int, seed: int) -> np.ndarray:
    """hard_llrs, except that a batch converged at iteration 1 takes 12 dB:
    at 9 dB some of a frame's 20,000 bits at Z=384 still need a second
    iteration."""
    if kind == "converged_at_1":
        return bpsk_llrs(n, 13, 12.0, seed)
    return hard_llrs(kind, n, seed)


# ---------------------------------------------------------------------------
# The JAX zlane kernel, in a child process
# ---------------------------------------------------------------------------

_JAX_CHILD = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
import ldpc_tpu.codes as jcodes
from ldpc_tpu.ops import pallas_minsum as jpm

inputs, out = np.load(sys.argv[1]), {}
iters = int(inputs["iters"])
qc = jcodes.qc_layout(jcodes.get_base_graph("nr_2_0_4"), 24)
decoders = {"layered": jpm.make_fused_minsum_zlane(qc, iters, 0.75, batch_tile=8, interpret=True,
                                                   schedule="layered"),
            "sumproduct": jpm.make_fused_minsum_zlane(qc, iters, 1.0, batch_tile=8,
                                                      interpret=True, mode="sumproduct")}
for key in inputs.files:
    if key != "iters":
        bits, conv = decoders[key.split(":")[0]](jnp.asarray(inputs[key]))
        out[key + ":bits"], out[key + ":conv"] = np.asarray(bits), np.asarray(conv)
np.savez(sys.argv[2], **out)
"""
JAX_PATHS = ("layered", "sumproduct")
JAX_KINDS = ("ties", "zeros")


def _jax_llrs(kind: str) -> np.ndarray:
    return hard_llrs(kind, _qc(24, "nr_2_0_4").num_vars, seed=24 + len(kind))


@pytest.fixture(scope="module")
def jax_zlane(tmp_path_factory):
    """Starts the child that runs the JAX kernel on every (path, kind);
    returns a function that waits for it and gives {key: (bits, conv)}."""
    tmp = tmp_path_factory.mktemp("jax_zlane")
    inputs = {f"{path}:{kind}": _jax_llrs(kind) for path in JAX_PATHS for kind in JAX_KINDS}
    np.savez(tmp / "in.npz", iters=ITERS, **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX").strip())
    root = Path(__file__).resolve().parents[1]
    script = f"import sys; sys.path.insert(0, {str(root)!r})\n" + _JAX_CHILD
    child = subprocess.Popen([sys.executable, "-c", script, str(tmp / "in.npz"),
                              str(tmp / "out.npz")], env=env, cwd=root)
    results = {}

    def wait():
        if not results:
            assert child.wait(timeout=600) == 0
            out = np.load(tmp / "out.npz")
            results.update({key: (out[key + ":bits"], out[key + ":conv"]) for key in inputs})
        return results

    yield wait
    if child.poll() is None:
        child.kill()
        child.wait()


@pytest.fixture(scope="module", autouse=True)
def _early_jax_child(request):
    """Where a JAX case is to run, starts its child with the module's first
    case, so that the JAX compiles run beside the models; a run without one
    starts no child."""
    if any(getattr(item, "originalname", None) == "test_plain_matches_jax_zlane"
           and item.module is request.module for item in request.session.items):
        request.getfixturevalue("jax_zlane")


# ---------------------------------------------------------------------------
# Plans and byte arithmetic
# ---------------------------------------------------------------------------


# (Z, layered smem of one frame, its scratch a frame, sum-product smem at 2
# parts, its scratch a block)
FIXED = [(384, 81_744, 193_536, 85_008, 302_592),
         (256, 55_120, 129_024, 58_384, 201_728)]


@pytest.mark.parametrize("Z,lay,lay_scratch,sp,sp_scratch", FIXED)
def test_byte_arithmetic(Z, lay, lay_scratch, sp, sp_scratch):
    """Fixed byte counts at nr_2_0_32 (R=42, C=52, K=197), and the formulas
    they come from: retire_layered's structure (1,872 bytes), the beliefs
    (C*Z floats), A (R*Z float pairs) and W (R*Z words) in the slice, c2v
    (K*Z floats), retire_zlane's structure (5,136 bytes at 2 parts)."""
    qc = _qc(Z)
    R, C, K = qc.num_base_rows, qc.num_base_cols, qc.num_base_edges
    assert fm.retire_zlane_layered_smem_bytes(qc) == lay == 1872 + 4 * C * Z
    assert fm.retire_zlane_layered_smem_bytes(qc, 2) == 1872 + 8 * C * Z
    assert fm.retire_zlane_layered_scratch_bytes(qc) == lay_scratch == 12 * R * Z
    assert fm.retire_zlane_sumproduct_smem_bytes(qc, 2) == sp == 5136 + 4 * C * Z
    assert fm.retire_zlane_sumproduct_scratch_bytes(qc) == sp_scratch == 4 * K * Z
    # A whole frame of retire_layered (beliefs and state) fits at Z=256, not
    # at Z=384; beliefs and c2v of retire_sumproduct fit at neither.
    assert fm.retire_layered_fits(qc) == (Z == 256)
    assert not fm.retire_sumproduct_fits(qc)


def test_plans_at_z384():
    """12 warps a part: 1 or 2 parts (1024 threads at most); two frames of
    one part a block, three exceed shared memory."""
    qc = _qc(384)
    assert fm.retire_zlane_layered_plans(qc) == [(1, 1), (1, 2), (2, 1)]
    assert fm.retire_zlane_sumproduct_plans(qc) == [1, 2]
    for p, f in fm.retire_zlane_layered_plans(qc):
        assert fm.retire_threads(qc, p, f) <= 1024
        assert fm.retire_zlane_layered_smem_bytes(qc, f) <= fm._SMEM_BUDGET
    assert fm.retire_zlane_layered_smem_bytes(qc, 3) > fm._SMEM_BUDGET


def test_plans_at_z256():
    """8 warps a part: parts up to NR BG2's largest row group (3); up to 4
    frames of one part a block, 2 of two."""
    qc = _qc(256)
    assert set(fm.retire_zlane_layered_plans(qc)) == {(1, 1), (1, 2), (1, 3), (1, 4), (2, 1),
                                                      (2, 2), (3, 1)}
    assert fm.retire_zlane_sumproduct_plans(qc) == [1, 2, 3, 4]


# ---------------------------------------------------------------------------
# Routes and launch counters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,Z", [("nr_2_0_32", 256), ("nr_2_0_32", 288), ("nr_2_0_32", 384),
                                    ("nr_2_0_4", 24)])
def test_routes(name, Z):
    """A fused_zlane decoder sends layered min-sum to retire_zlane_layered
    and sum-product flooding to retire_zlane_sumproduct, keeping the CSR
    structure for the side door; layered sum-product goes to
    retire_zlane_layered_sumproduct; min-sum flooding stays on
    retire_zlane."""
    qc = _qc(Z, name)
    assert fm.retire_zlane_layered_fits(qc) and fm.retire_zlane_sumproduct_fits(qc)
    routes = {("minsum", "flooding"): "retire_zlane",
              ("minsum", "layered"): "retire_zlane_layered",
              ("sumproduct", "flooding"): "retire_zlane_sumproduct",
              ("sumproduct", "layered"): "retire_zlane_layered_sumproduct"}
    for (mode, schedule), route in routes.items():
        for track, early_exit in ((True, False), (False, False), (True, True)):
            dec = fm.make_fused_minsum_zlane(qc, 5, mode=mode, schedule=schedule,
                                             track_convergence=track, early_exit=early_exit,
                                             device="cpu")
            assert dec.route == route and dec.retire == (route != "fused_zlane")
            assert dec.graph is not None  # the CSR structure _launch_zlane needs


def test_serving_objects_and_wide_rows():
    """At Z=384 (auto resolves to fused_zlane) the layered serving object
    reaches retire_zlane_layered and BeliefPropagationDecoder
    retire_zlane_sumproduct; a row of 31 members takes their 64-bit-word
    forms and a row of 122 keeps fused_zlane; Z % 8 != 0 takes neither."""
    from test_torch_minsum_retire import wide_row_shifts

    qc = _qc(384)
    layered = MinSumScaledDecoder(qc, 5, 0.75, early_stopping=False, schedule="layered",
                                  device="cpu")
    assert layered._fused.kind == "fused_zlane"
    assert layered._fused.route == "retire_zlane_layered"
    assert BeliefPropagationDecoder(qc, 5, device="cpu")._fused.route == "retire_zlane_sumproduct"
    wide = tcodes.qc_layout(tcodes.BaseGraph("wide", wide_row_shifts()), 8)
    assert not fm.retire_zlane_layered_fits(wide) and not fm.retire_zlane_sumproduct_fits(wide)
    from test_torch_retire_wide import row_code

    widest = row_code(122, cols=124, Z=8)
    for kw, route in (({"schedule": "layered"}, "retire_zlane_layered_wide"),
                      ({"mode": "sumproduct"}, "retire_zlane_sumproduct_wide")):
        assert fm.make_fused_minsum_zlane(wide, 5, device="cpu", **kw).route == route
        assert fm.make_fused_minsum_zlane(widest, 5, device="cpu", **kw).route == "fused_zlane"
    odd = _qc(12, "nr_2_0_4")
    assert not fm.retire_zlane_layered_fits(odd) and not fm.retire_zlane_sumproduct_fits(odd)
    assert fm.retire_zlane_layered_plans(odd) == []


def test_launch_counters_unmoved_by_cpu_tensors():
    """The routes name launch counters; decoding CPU tensors (builders and
    serving objects) moves none."""
    assert {"retire_zlane_layered", "retire_zlane_sumproduct"} <= set(fm.LAUNCHES)
    assert set(fm.RETIRING) <= set(fm.LAUNCHES)
    launches = dict(fm.LAUNCHES)
    qc = _qc(24, "nr_2_0_4")
    llr = torch.from_numpy(bpsk_llrs(qc.num_vars, 3, 1.0, seed=2))
    fm.make_fused_minsum_zlane(qc, 3, schedule="layered", device="cpu")(llr)
    fm.make_fused_minsum_zlane(qc, 3, mode="sumproduct", device="cpu")(llr)
    qc384 = _qc(384)
    MinSumScaledDecoder(qc384, 2, schedule="layered", device="cpu").decode(
        torch.zeros((1, qc384.num_vars)))
    BeliefPropagationDecoder(qc384, 2, device="cpu").decode(torch.zeros((1, qc384.num_vars)))
    assert fm.LAUNCHES == launches


# ---------------------------------------------------------------------------
# The layered kernel's algorithm, its state in the slices
# ---------------------------------------------------------------------------


def layered_slice_model(qc, llr: np.ndarray, T: int, alpha: float, track: bool):
    """csrc/fused_retire.cu's retire_zlane_layered_kernel on (frame, lane)
    arrays, SLOTS frame groups taking frames in waves: each group's A and W
    read and written in place in its slice of one scratch array, laid out as
    the kernel lays it out (A first, then W; retire_zlane_layered_scratch_bytes
    a group).  Neither is cleared between frames: the scratch starts as
    garbage and the first sweep reads no state.  Row groups in order, the
    rows of a group side by side, (belief + new) - old, a parity pass after
    every sweep but the last, retirement.  Returns (bits, conv_iter)."""
    st, row_mem, row_ptr, grp_ptr = _layered_unpack(qc)
    Z, R = st.Z, st.R
    RZ = R * Z
    f32, alpha = np.float32, np.float32(alpha)
    pow2 = Z & (Z - 1) == 0
    z = np.arange(Z)
    words = fm.retire_zlane_layered_scratch_bytes(qc) // 4
    assert words == 3 * RZ
    scratch = np.random.default_rng(0).integers(0, 2 ** 32, SLOTS * words, dtype=np.uint64)
    scratch = scratch.astype(_U).reshape(SLOTS, words)
    A_all = scratch[:, :2 * RZ].view(f32).reshape(SLOTS, RZ, 2)
    W_all = scratch[:, 2 * RZ:]

    def rolled(s, offset):
        if pow2:
            return ((z + s) & (Z - 1)) | offset
        v = z + s
        return np.where(v >= Z, v - Z, v) + offset

    B = llr.shape[0]
    bits = np.zeros_like(llr)
    conv = np.full(B, T, np.int32)
    for f0 in range(0, B, SLOTS):
        m = min(SLOTS, B - f0)
        A, W = A_all[:m], W_all[:m]  # views into the slices
        bel = llr[f0:f0 + m] + f32(0.0)  # -0.0 -> +0.0
        live = np.ones(m, bool)

        def row_update(r, first):
            q = r * Z + z
            if first:
                a, w_old = np.zeros((m, Z, 2), f32), np.zeros((m, Z), _U)
            else:
                a, w_old = A[:, q], W[:, q]
            arg_old = w_old >> _U(27)
            j0, d = row_ptr[r], row_ptr[r + 1] - row_ptr[r]
            pos = [rolled(row_mem[j0 + j, 1], row_mem[j0 + j, 0]) for j in range(d)]
            b = [bel[:, p] for p in pos]
            old = [_flip(np.where(arg_old == j, a[..., 1], a[..., 0]), w_old << _U(31 - j))
                   for j in range(d)]
            m1 = np.full((m, Z), 1e9, f32)
            m2 = m1.copy()
            arg = np.full((m, Z), 31, _U)
            neg = np.zeros((m, Z), _U)
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

        for t in range(T):
            for g0, g1 in zip(grp_ptr[:-1], grp_ptr[1:]):
                updates = [row_update(r, t == 0) for r in range(g0, g1)]
                for q, an, wn, pos, new in updates:
                    A[:, q], W[:, q] = an, wn
                    for p, v in zip(pos, new):
                        bel[:, p] = v
            if track and t + 1 < T:
                violated = np.zeros(m, bool)
                for r in range(R):
                    parity = np.zeros((m, Z), _U)
                    for i in range(row_ptr[r], row_ptr[r + 1]):
                        parity ^= bel[:, rolled(row_mem[i, 1], row_mem[i, 0])].view(_U)
                    violated |= (parity >> _U(31)).astype(bool).any(axis=1)
                done = live & ~violated
                bits[f0:f0 + m][done] = (bel[done] < 0).astype(f32)
                conv[f0:f0 + m][done] = t + 1
                live &= ~done
                if not live.any():
                    break
        bits[f0:f0 + m][live] = (bel[live] < 0).astype(f32)
    return bits, conv


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("Z", [384, 256])
def test_layered_model_matches_plain(Z, kind):
    """Bits and conv_iter identical to the plain version, tracked and in
    throughput mode.  8 of the kind's frames: two waves, the second
    partial."""
    qc = _qc(Z)
    llr = large_z_llrs(kind, qc.num_vars, seed=Z + len(kind))[:8]
    if kind == "zeros":
        assert (np.signbit(llr) & (llr == 0)).any() and (~np.signbit(llr) & (llr == 0)).any()
    for track in (True, False):
        dec = fm.make_fused_minsum_zlane(qc, ITERS, 0.75, schedule="layered",
                                         track_convergence=track, device="cpu")
        assert dec.route == "retire_zlane_layered"
        bits_p, conv_p = dec.plain(torch.from_numpy(llr))
        bits_m, conv_m = layered_slice_model(qc, llr, ITERS, 0.75, track)
        assert_decoder_parity("minsum", bits_m, conv_m, bits_p, conv_p)
        if track and kind in ("converged_at_1", "never_converged"):
            _check_kind(conv_p.numpy(), kind)


# ---------------------------------------------------------------------------
# The sum-product kernel's algorithm, c2v in the slices
# ---------------------------------------------------------------------------


def _sumproduct_unpack(qc, parts: int):
    """retire_zlane_sumproduct's structure (retire_sumproduct's, per_edge):
    column members (edge offset i*Z, shift, ...), row members (col*Z,
    shift), row_ptr, col_ptr, and the parts' first rows and columns."""
    st = fm._structure(qc)
    K, R, C = st.K, st.R, st.C
    g = torch.from_numpy(fm._retire_structure(st, parts, per_edge=True).astype(np.int64))
    bounds = g[6 * K + R + C + 2:].reshape(2, parts + 1)
    assert bounds[0, 0] == 0 and bounds[0, -1] == R and bounds[1, 0] == 0 and bounds[1, -1] == C
    return (st, g[:4 * K].reshape(K, 4), g[4 * K:6 * K].reshape(K, 2), g[6 * K:6 * K + R + 1],
            g[6 * K + R + 1:6 * K + R + C + 2], bounds)


def sumproduct_slice_model(qc, llr: torch.Tensor, T: int, track: bool, parts: int = 2):
    """csrc/fused_retire.cu's retire_zlane_sumproduct_kernel on (frame,
    lane) tensors, SLOTS blocks taking frames in waves, each block's c2v
    read and written in place in its slice of one scratch tensor (K*Z
    floats a block, check-aligned: member j of row r, lane z at
    (row_ptr[r] + j)*Z + z), cleared per frame.  Check pass: phi_j kept per
    member and added to S in member order, signs from sign bits, the
    syndrome of the beliefs it reads; retirement; column pass from the LLRs,
    each column's c2v summed from 0 in col_members order.  The lanes (r, z)
    of every row run at once, member slot by member slot, each lane's
    arithmetic the kernel's thread's.  Returns bits, conv_iter and, per
    iteration, (live frames, beliefs after the column pass)."""
    st, col_mem, row_mem, row_ptr, col_ptr, _ = _sumproduct_unpack(qc, parts)
    Z, R, C, K = st.Z, st.R, st.C, st.K
    z = torch.arange(Z)
    pow2 = Z & (Z - 1) == 0
    words = fm.retire_zlane_sumproduct_scratch_bytes(qc) // 4
    assert words == K * Z
    scratch = torch.full((SLOTS, words), float("nan"))

    def rolled(s, offset):
        if pow2:
            return ((z + s) & (Z - 1)) | offset
        v = z + s
        return torch.where(v >= Z, v - Z, v) + offset

    # Member slot j of every lane (r, z): the belief it reads, its c2v in
    # the slice, whether row r has a member j.
    degree = row_ptr[1:] - row_ptr[:-1]
    dr = int(degree.max())
    bel_at = torch.zeros((dr, R * Z), dtype=torch.int64)
    c2v_at = torch.zeros((dr, R * Z), dtype=torch.int64)
    valid = torch.zeros((dr, R * Z), dtype=torch.bool)
    for r in range(R):
        for j in range(int(degree[r])):
            i = int(row_ptr[r]) + j
            bel_at[j, r * Z:(r + 1) * Z] = rolled(int(row_mem[i, 1]), int(row_mem[i, 0]))
            c2v_at[j, r * Z:(r + 1) * Z] = i * Z + z
            valid[j, r * Z:(r + 1) * Z] = True
    # Member slot i of every variable (c, z): the c2v its column pass reads
    # ((z - shift) mod Z in the edge's slot); absent slots add 0.
    dv = int((col_ptr[1:] - col_ptr[:-1]).max())
    col_at = torch.zeros((dv, C * Z), dtype=torch.int64)
    col_valid = torch.zeros((dv, C * Z), dtype=torch.bool)
    for c in range(C):
        for i in range(int(col_ptr[c + 1] - col_ptr[c])):
            e = int(col_ptr[c]) + i
            col_at[i, c * Z:(c + 1) * Z] = rolled(Z - int(col_mem[e, 1]), int(col_mem[e, 0]))
            col_valid[i, c * Z:(c + 1) * Z] = True

    B = llr.shape[0]
    bits = torch.zeros_like(llr)
    conv = torch.full((B,), T, dtype=torch.int32)
    live_at = torch.zeros((T, B), dtype=torch.bool)
    bel_at_t = torch.zeros((T,) + tuple(llr.shape))
    for f0 in range(0, B, SLOTS):
        m = min(SLOTS, B - f0)
        c2v = scratch[:m]  # a view: the blocks' slices
        c2v.zero_()  # clear_state
        src = llr[f0:f0 + m]
        bel = src + 0.0  # -0.0 -> +0.0
        live = torch.ones(m, dtype=torch.bool)
        for t in range(T):
            S = torch.zeros((m, R * Z))
            neg = torch.zeros((m, dr, R * Z), dtype=torch.bool)
            parity = torch.zeros((m, R * Z), dtype=torch.bool)
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
                bits[f0:f0 + m][done] = (bel[done] < 0).to(torch.float32)
                conv[f0:f0 + m][done] = t
                live &= ~done
                if not bool(live.any()):
                    break
            c2v.copy_(torch.where(live[:, None], new, c2v))
            cs = torch.zeros((m, C * Z))
            for i in range(dv):
                cs = cs + torch.where(col_valid[i], c2v[:, col_at[i]], 0.0)
            bel = torch.where(live[:, None], src + cs, bel)
            live_at[t, f0:f0 + m], bel_at_t[t, f0:f0 + m] = live, bel
        bits[f0:f0 + m][live] = (bel[live] < 0).to(torch.float32)
    return bits, conv, list(zip(live_at, bel_at_t))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("Z", [384, 256])
def test_sumproduct_model_matches_plain(Z, kind):
    """Tracked: bits and conv_iter identical to the plain version.  In
    throughput mode (every frame live every iteration): the beliefs after
    every iteration identical (torch.equal) to the plain version's
    flooding loop, so the bits too.  8 of the kind's frames: two waves, the
    second partial."""
    qc = _qc(Z)
    llr = torch.from_numpy(large_z_llrs(kind, qc.num_vars, seed=Z + 3 * len(kind))[:8])
    dec = fm.make_fused_minsum_zlane(qc, ITERS, 1.0, mode="sumproduct", device="cpu")
    assert dec.route == "retire_zlane_sumproduct"
    bits_p, conv_p = dec.plain(llr)
    bits_m, conv_m, _ = sumproduct_slice_model(qc, llr, ITERS, True)
    assert torch.equal(bits_m, bits_p) and torch.equal(conv_m, conv_p)
    if kind in ("converged_at_1", "never_converged"):
        _check_kind(conv_p.numpy(), kind)
    bits_m, conv_m, history = sumproduct_slice_model(qc, llr, ITERS, False)
    reference = plain_beliefs(qc, llr, ITERS)
    for (live, bel_m), bel_p in zip(history, reference):
        assert bool(live.all()) and torch.equal(bel_m, bel_p)
    assert torch.equal(bits_m, (reference[-1] < 0).to(torch.float32))
    assert bool((conv_m == ITERS).all())


# ---------------------------------------------------------------------------
# Against the JAX zlane kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", JAX_KINDS)
@pytest.mark.parametrize("path", JAX_PATHS)
def test_plain_matches_jax_zlane(jax_zlane, path, kind):
    """The plain version that the two kernels are held to against the JAX
    zlane kernel in interpret mode: layered min-sum bits and conv_iter
    identical, sum-product at the sum-product bars."""
    qc = _qc(24, "nr_2_0_4")
    llr = _jax_llrs(kind)
    kw = {"schedule": "layered"} if path == "layered" else {"mode": "sumproduct"}
    dec = fm.make_fused_minsum_zlane(qc, ITERS, 0.75 if path == "layered" else 1.0,
                                     device="cpu", **kw)
    assert dec.route == f"retire_zlane_{path}"
    bits_t, conv_t = dec(torch.from_numpy(llr))
    bits_j, conv_j = jax_zlane()[f"{path}:{kind}"]
    assert_decoder_parity("minsum" if path == "layered" else "sumproduct", bits_j, conv_j,
                          bits_t, conv_t)
    _check_kind(conv_t.numpy(), kind)
