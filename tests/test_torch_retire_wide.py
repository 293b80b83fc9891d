"""B1's wide rows: the four retiring kernels of csrc/fused_retire.cu on their
64-bit state word (``fused_retire_wide``, ``retire_layered_wide``,
``retire_sumproduct_wide``, ``retire_layered_sumproduct_wide``), which take
codes with rows of 28 to 58 members from the ``fused`` kernel (replaces
ldpc_tpu/ops/pallas_minsum.py:143 ``_kernel`` on such codes).

The 64-bit word keeps a check's output signs at bits 0..57 and its argmin in
the top 6 bits (no member: 63); a column member's structure entry carries j
and 63 - j where the 32-bit word's carries j << 27 and 31 - j.  Held here, on
the CPU:

* numpy models of the four kernels' per-lane algorithms on the wrapper's own
  wide tables, with the state words and sign masks as uint64: after every
  iteration the beliefs, and the c2v (min-sum: expanded from the state
  words), of every frame still decoding equal the plain version's; bits and
  ``conv_iter`` equal ``fused_decode_plain``'s, tracked and in throughput
  mode.  Codes: the 31-member row of ``wide_row_shifts()``, a row of exactly
  58 members, and IEEE 802.3an's shape (a (6, 32) array of Z=64 circulants,
  every cell filled, shift (r*c) mod 64) at a small batch;
* the routes (27 members -> the 32-bit word, 28 to 58 -> the 64-bit word, 59
  to 121 -> the 128-bit word of the ``*_w128`` routes, 122 -> ``fused``),
  the launch counters, the shared-memory plans with fixed byte counts, and
  the wide structure encoding;
* one JAX case: sum-product flooding on the 31-member code through
  ``pallas_minsum.make_fused_bp`` in interpret mode against the plain
  version behind ``retire_sumproduct_wide``.
"""
import functools

import numpy as np
import pytest
import torch

from test_torch_minsum_retire import hard_llrs, wide_row_shifts
from test_torch_parity import assert_decoder_parity, bpsk_llrs

import ldpc_tpu_torch.codes as tcodes
from ldpc_tpu_torch.models.classical import BeliefPropagationDecoder, MinSumScaledDecoder
from ldpc_tpu_torch.ops import fused_minsum as fm
from ldpc_tpu_torch.ops.qc_msg import _phi

ITERS = 8
SCHEDULES = [("minsum", "flooding"), ("minsum", "layered"), ("sumproduct", "flooding"),
             ("sumproduct", "layered")]
WIDE_ROUTE = {("minsum", "flooding"): "fused_retire_wide",
              ("minsum", "layered"): "retire_layered_wide",
              ("sumproduct", "flooding"): "retire_sumproduct_wide",
              ("sumproduct", "layered"): "retire_layered_sumproduct_wide"}
NARROW_ROUTE = {key: route.removesuffix("_wide") for key, route in WIDE_ROUTE.items()}
NARROW_ROUTE["minsum", "flooding"] = "fused_retire"

f32, U32, U64 = np.float32, np.uint32, np.uint64
SIGN_BITS = 58  # kSignBits<unsigned long long> in csrc/retire.cuh
NO_MEMBER = 63  # kNoMember<unsigned long long>


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: the suite's workers run side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def row_code(members: int, cols: int = 64, Z: int = 4):
    """A (4, cols) base graph at ``Z`` whose first row has ``members``
    members (columns 0 .. members - 1) and is the widest: the other rows
    take each of those columns with probability 1/4 and share the rest
    round robin, so every column has a member."""
    rng = np.random.default_rng(members)
    shifts = np.full((4, cols), -1)
    shifts[0, :members] = rng.integers(0, Z, members)
    shifts[1:, :members] = np.where(rng.random((3, members)) < 0.25,
                                    rng.integers(0, Z, (3, members)), -1)
    for c in range(members, cols):
        shifts[1 + c % 3, c] = rng.integers(0, Z)
    return tcodes.qc_layout(tcodes.BaseGraph(f"row{members}", shifts), Z)


@functools.lru_cache(maxsize=None)
def code(name: str):
    """The wide codes: ``w31`` (wide_row_shifts at Z=4), ``w58`` (a row of
    exactly 58 members, Z=4) and ``ieee`` (802.3an's shape: (6, 32) at
    Z=64, every cell, shift (r*c) mod 64; n = 2048, rows of 32)."""
    if name == "w31":
        return tcodes.qc_layout(tcodes.BaseGraph("wide", wide_row_shifts()), 4)
    if name == "w58":
        return row_code(58, cols=60)
    r, c = np.meshgrid(np.arange(6), np.arange(32), indexing="ij")
    return tcodes.qc_layout(tcodes.BaseGraph("ieee_6x32", (r * c) % 64), 64)


def _llrs(name: str, kind: str) -> np.ndarray:
    """noise: BPSK LLRs at an SNR where frames converge at different
    iterations and some never; ties: quantised to even integers (tied
    minimums)."""
    qc = code(name)
    if kind == "ties":
        return hard_llrs("ties", qc.num_vars, seed=qc.dr_max)
    snr, batch = {"w31": (4.0, 13), "w58": (6.0, 13), "ieee": (6.0, 6)}[name]
    return bpsk_llrs(qc.num_vars, batch, snr, seed=qc.dr_max)


# ---------------------------------------------------------------------------
# The 64-bit state word, as csrc/retire.cuh reads and writes it
# ---------------------------------------------------------------------------


def _flip(a, bits):
    """a with its sign flipped where bit 31 of bits is set (flip_if)."""
    return (a.view(U32) ^ (bits & U32(0x80000000))).view(f32)


def _bit_at_31(w, j):
    """bit_at_31: bit j of a 64-bit word at bit 31 of a uint32."""
    return ((w >> U64(j)) & U64(1)).astype(U32) << U32(31)


def _argmin_of(w):
    return (w >> U64(SIGN_BITS)).astype(U32)


def _state_word(neg, d: int, arg):
    """product_flips then state_word: the signs flipped where the sign product
    is negative, the argmin above them."""
    odd = np.bitwise_count(neg) & 1
    signs = neg ^ np.where(odd == 1, U64((1 << d) - 1), U64(0))
    return signs | (arg.astype(U64) << U64(SIGN_BITS))


def _c2v_of(a, w, j):
    return _flip(np.where(_argmin_of(w) == j, a[..., 1], a[..., 0]), _bit_at_31(w, j))


def _c2v_row(a, w, d):
    """c2v_of for members 0..d-1 of a check row at once (d, ...)."""
    j = np.arange(d).reshape((d,) + (1,) * w.ndim)
    loo = np.where(_argmin_of(w) == j, a[..., 1], a[..., 0])
    return _flip(loo, ((w >> j.astype(U64)) & U64(1)).astype(U32) << U32(31))


def _phi_np(x):
    """The plain version's phi (torch), on numpy float32."""
    return _phi(torch.from_numpy(np.ascontiguousarray(x))).numpy()


def _unpack(qc, per_edge: bool, word_bits: int = 64):
    st = fm._structure(qc)
    K, R, C = st.K, st.R, st.C
    g = fm._retire_structure(st, 1, per_edge=per_edge, word_bits=word_bits)
    return (st, g[:4 * K].reshape(K, 4), g[4 * K:6 * K].reshape(K, 2), g[6 * K:6 * K + R + 1],
            g[6 * K + R + 1:6 * K + R + C + 2])


class _Frames:
    """What the models share: lanes, rolls, retirement and the c2v in the
    plain version's layout (var-aligned per base edge)."""

    def __init__(self, qc, llr: np.ndarray, per_edge: bool, word_bits: int = 64):
        self.st, self.col_mem, self.row_mem, self.row_ptr, self.col_ptr = _unpack(
            qc, per_edge, word_bits)
        self.Z = self.st.Z
        self.z = np.arange(self.Z)
        self.e_idx = fm._PlainIndex(self.st, torch.device("cpu")).e_idx.numpy()
        self.B = llr.shape[0]
        self.llr = llr
        self.bel = llr + f32(0.0)  # -0.0 -> +0.0
        self.live = np.ones(self.B, bool)
        self.bits = np.zeros_like(llr)
        self.conv = None
        self.history = []
        self.rows = {}

    def rolled(self, s, offset):
        Z, z = self.Z, self.z
        if Z & (Z - 1) == 0:
            return ((z + s) & (Z - 1)) | offset
        v = z + s
        return np.where(v >= Z, v - Z, v) + offset

    def row(self, r):
        """Row r's degree, first member index and member belief lanes."""
        if r not in self.rows:
            j0, d = int(self.row_ptr[r]), int(self.row_ptr[r + 1] - self.row_ptr[r])
            self.rows[r] = j0, d, [self.rolled(int(self.row_mem[j0 + j, 1]),
                                               int(self.row_mem[j0 + j, 0])) for j in range(d)]
        return self.rows[r]

    def retire(self, done, t):
        self.bits[done] = (self.bel[done] < 0).astype(f32)
        self.conv[done] = t
        self.live &= ~done

    def finish(self):
        self.bits[self.live] = (self.bel[self.live] < 0).astype(f32)
        return self.bits, self.conv, self.history


def _minsum_fold(b, old, d):
    """The min-sum fold of a row's d members, last first, on the 64-bit
    word: (m1, m2, argmin, neg)."""
    shape = b[0].shape
    m1, m2 = np.full(shape, 1e9, f32), np.full(shape, 1e9, f32)
    arg, neg = np.full(shape, NO_MEMBER, U32), np.zeros(shape, U64)
    for j in reversed(range(d)):
        x = b[j] - old[j]
        mag = np.abs(x)
        neg = (neg << U64(1)) | (x.view(U32) >> U32(31)).astype(U64)  # push_sign
        arg = np.where(mag <= m1, U32(j), arg)
        m2 = np.minimum(np.maximum(mag, m1), m2)
        m1 = np.minimum(mag, m1)
    return m1, m2, arg, neg


def _new_minsum_state(m1, m2, arg, neg, d, alpha):
    an = np.stack([alpha * np.where(m1 < 1e9, m1, f32(0)),
                   alpha * np.where(m2 < 1e9, m2, f32(0))], axis=-1)
    return an, _state_word(neg, d, arg)


def _sumproduct_fold(b, old, d):
    """phi_j of each member, S summed in member order, the sign mask
    (uint64) and the sign product at bit 31: (ph, S, neg, sp)."""
    ph, S, neg = [], np.zeros(b[0].shape, f32), np.zeros(b[0].shape, U64)
    for j in range(d):
        x = b[j] - old[j]
        neg |= (x.view(U32) >> U32(31)).astype(U64) << U64(j)  # sign_at
        ph.append(_phi_np(np.clip(np.abs(x), f32(1e-7), f32(20.0))))
        S = S + ph[j]
    sp = (np.bitwise_count(neg) & 1).astype(U32) << U32(31)
    return ph, S, neg, sp


def _sumproduct_out(S, p, sp, neg, j):
    """c2v_out: phi(max(S - p, 1e-7)) with sign bit sp ^ bit j of neg."""
    return _flip(_phi_np(np.maximum(S - p, f32(1e-7))), sp ^ _bit_at_31(neg, j))


class Word64:
    """The 64-bit state word's operations (csrc/retire.cuh) on uint64 arrays,
    as the models below use them: a word, a check's fold and new state,
    sum-product's sign mask, and a column member's c2v (is_argmin,
    member_sign)."""

    bits = 64

    @staticmethod
    def zeros(shape):
        return np.zeros(shape, U64)

    c2v_row = staticmethod(_c2v_row)
    fold = staticmethod(_minsum_fold)
    new_state = staticmethod(_new_minsum_state)
    sp_fold = staticmethod(_sumproduct_fold)
    sp_out = staticmethod(_sumproduct_out)

    @staticmethod
    def member_c2v(a, w, jz, sa):
        v = np.where(_argmin_of(w) == jz, a[..., 1], a[..., 0])
        return _flip(v, ((w << U64(sa)) >> U64(32)).astype(U32))


def _zero_state(B: int, RZ: int, KZ: int, word):
    """The models' check state in arrays of their own: A (B, RZ, 2), W of
    ``word`` and check-aligned c2v (B, KZ)."""
    return np.zeros((B, RZ, 2), f32), word.zeros((B, RZ)), np.zeros((B, KZ), f32)


def flooding_model(qc, llr: np.ndarray, T: int, track: bool, mode: str, alpha: float,
                   word=Word64, state=_zero_state):
    """retire_minsum_kernel / retire_sumproduct_kernel on ``word`` (the
    64-bit one by default; decode_frames): a check pass that reads the
    syndrome of the beliefs it reads, retirement, a column pass.  ``state``
    gives the (A, W, c2v) arrays the kernel reads and writes (its slices of
    scratch for the large-Z kernels), which are cleared first, as
    clear_state clears them.  Returns bits, conv_iter and, per iteration,
    (live frames, beliefs, c2v in the plain layout)."""
    sumproduct = mode == "sumproduct"
    m = _Frames(qc, llr, per_edge=sumproduct, word_bits=word.bits)
    st, Z, z, B = m.st, m.Z, m.z, m.B
    alpha = f32(alpha)
    A, W, c2v = state(B, st.R * Z, st.K * Z, word)  # sum-product's c2v: check-aligned
    A[...], W[...], c2v[...] = 0, 0, 0
    m.conv = np.full(B, T, np.int32)
    for t in range(T):
        violated = np.zeros(B, bool)
        plain_c2v = np.zeros((B, st.K * Z), f32)
        for r in range(st.R):
            j0, d, pos = m.row(r)
            q = r * Z + z
            b = [m.bel[:, p] for p in pos]
            parity = np.zeros((B, Z), U32)
            for bj in b:
                parity ^= bj.view(U32)
            violated |= (parity >> U32(31)).astype(bool).any(axis=1)
            if sumproduct:
                slots = [(j0 + j) * Z + z for j in range(d)]
                ph, S, neg, sp = word.sp_fold(b, [c2v[:, e] for e in slots], d)
                for j, e in enumerate(slots):
                    c2v[:, e] = word.sp_out(S, ph[j], sp, neg, j)
                    plain_c2v[:, m.e_idx[j, q]] = c2v[:, e]
            else:
                old = word.c2v_row(A[:, q], W[:, q], d)
                A[:, q], W[:, q] = word.new_state(*word.fold(b, old, d), d, alpha)
                new = word.c2v_row(A[:, q], W[:, q], d)
                for j in range(d):
                    plain_c2v[:, m.e_idx[j, q]] = new[j]
        if track and t > 0:
            m.retire(m.live & ~violated, t)
        out = m.bel.copy()
        for c in range(st.C):
            cs = np.zeros((B, Z), f32)
            for i in range(int(m.col_ptr[c]), int(m.col_ptr[c + 1])):
                offset, shift, jz, sa = (int(v) for v in m.col_mem[i])
                q = m.rolled(Z - shift, offset)
                if sumproduct:
                    cs = cs + c2v[:, q]
                else:
                    cs = cs + word.member_c2v(A[:, q], W[:, q], jz, sa)
            out[:, c * Z + z] = llr[:, c * Z + z] + cs
        m.bel = np.where(m.live[:, None], out, m.bel)
        m.history.append((m.live.copy(), m.bel.copy(), plain_c2v))
    return m.finish()


def layered_model(qc, llr: np.ndarray, T: int, track: bool, mode: str, alpha: float,
                  word=Word64, state=_zero_state):
    """retire_layered_kernel / retire_layered_sumproduct_kernel on ``word``
    (the 64-bit one by default; layered_frames, one part): rows in order,
    each member's belief (belief + new) - old, a parity pass after every
    sweep but the last, retirement.  ``state`` as flooding_model's, never
    cleared: the first sweep reads none of it (old c2v +0.0).  Returns as
    flooding_model (live: the frames that ran the sweep)."""
    sumproduct = mode == "sumproduct"
    m = _Frames(qc, llr, per_edge=False, word_bits=word.bits)
    st, Z, z, B = m.st, m.Z, m.z, m.B
    alpha = f32(alpha)
    A, W, c2v = state(B, st.R * Z, st.K * Z, word)  # sum-product's c2v: check-aligned
    plain_c2v = np.zeros((B, st.K * Z), f32)
    m.conv = np.full(B, T, np.int32)
    for t in range(T):
        for r in range(st.R):
            j0, d, pos = m.row(r)
            q = r * Z + z
            b = [m.bel[:, p] for p in pos]
            if sumproduct:
                slots = [(j0 + j) * Z + z for j in range(d)]
                old = [c2v[:, e] if t else np.zeros((B, Z), f32) for e in slots]
                ph, S, neg, sp = word.sp_fold(b, old, d)
                new = [word.sp_out(S, ph[j], sp, neg, j) for j in range(d)]
                for j, e in enumerate(slots):
                    c2v[:, e] = new[j]
            else:
                old = (word.c2v_row(A[:, q], W[:, q], d) if t
                       else np.zeros((d, B, Z), f32))
                A[:, q], W[:, q] = word.new_state(*word.fold(b, old, d), d, alpha)
                new = word.c2v_row(A[:, q], W[:, q], d)
            for j, p in enumerate(pos):
                m.bel[:, p] = np.where(m.live[:, None], (b[j] + new[j]) - old[j], b[j])
                plain_c2v[:, m.e_idx[j, q]] = np.where(m.live[:, None], new[j],
                                                       plain_c2v[:, m.e_idx[j, q]])
        m.history.append((m.live.copy(), m.bel.copy(), plain_c2v.copy()))
        if track and t + 1 < T:
            violated = np.zeros(B, bool)
            for r in range(st.R):
                parity = np.zeros((B, Z), U32)
                for p in m.row(r)[2]:
                    parity ^= m.bel[:, p].view(U32)
                violated |= (parity >> U32(31)).astype(bool).any(axis=1)
            m.retire(m.live & ~violated, t + 1)
    return m.finish()


def plain_history(qc, llr: np.ndarray, T: int, mode: str, schedule: str, alpha: float):
    """The plain version's (beliefs, c2v) after each iteration, no freezing
    (fused_decode_plain's loop body)."""
    st = fm._structure(qc)
    ix = fm._PlainIndex(st, torch.device("cpu"))
    sumproduct = mode == "sumproduct"
    llr_t = torch.from_numpy(llr)
    bel, c2v = llr_t.clone(), torch.zeros((llr.shape[0], st.K * st.Z))
    out = []
    for _ in range(T):
        if schedule == "layered":
            for row in ix.rows:
                fm._layered_row(bel, c2v, row, st.Z, alpha, sumproduct)
        else:
            fm._check_update_slots(bel, c2v, ix, alpha, sumproduct)
            colsum = torch.zeros_like(llr_t)
            for j in range(ix.c_idx.shape[0]):
                colsum = colsum + torch.where(ix.c_valid[j], c2v[:, ix.c_idx[j]], 0.0)
            bel = llr_t + colsum
        out.append((bel.numpy().copy(), c2v.numpy().copy()))
    return out


MODEL_CASES = [("w31", "noise"), ("w31", "ties"), ("w58", "noise"), ("w58", "ties"),
               ("ieee", "noise")]


@pytest.mark.parametrize("mode,schedule", SCHEDULES)
@pytest.mark.parametrize("name,kind", MODEL_CASES)
def test_model_matches_plain(name, kind, mode, schedule):
    """After every iteration the beliefs and c2v of every frame still
    decoding equal the plain version's (c2v expanded from the 64-bit state
    words for min-sum); bits and conv_iter equal fused_decode_plain's,
    tracked and in throughput mode; the decoder routes to the wide kernel."""
    qc = code(name)
    assert 28 <= qc.dr_max <= 58
    llr = _llrs(name, kind)
    alpha = 0.75 if mode == "minsum" else 1.0
    model = layered_model if schedule == "layered" else flooding_model
    reference = plain_history(qc, llr, ITERS, mode, schedule, alpha)
    for track in (True, False):
        bits_m, conv_m, history = model(qc, llr, ITERS, track, mode, alpha)
        for (live, bel_m, c2v_m), (bel_p, c2v_p) in zip(history, reference):
            np.testing.assert_array_equal(bel_m[live], bel_p[live])
            np.testing.assert_array_equal(c2v_m[live], c2v_p[live])
        dec = fm.make_fused_minsum(qc, ITERS, alpha, mode=mode, schedule=schedule,
                                   track_convergence=track, device="cpu")
        assert dec.route == WIDE_ROUTE[mode, schedule] and dec.retire
        bits_p, conv_p = dec.plain(torch.from_numpy(llr))
        np.testing.assert_array_equal(bits_m, bits_p.numpy())
        np.testing.assert_array_equal(conv_m, conv_p.numpy())
        if not track:
            assert (conv_m == ITERS).all()
        elif kind == "noise":
            assert len(set(conv_m.tolist())) > 1


def test_state_word_holds_58_members():
    """A row of 58 members fills every sign bit below the argmin: with every
    v2c negative (an even count) each output sign is set, bits 0..57; with
    one member positive (an odd count) only that member's is; the argmin
    reads back from the top 6 bits, and each member's c2v from bit j."""
    qc = code("w58")
    m = _Frames(qc, -np.abs(bpsk_llrs(qc.num_vars, 64, 0.0, seed=1)), per_edge=False)
    _, d, pos = m.row(0)
    assert d == 58
    b = [m.bel[:, p] for p in pos]
    zeros = [np.zeros_like(x) for x in b]
    all58 = U64((1 << 58) - 1)
    for flipped in (None, 40):
        if flipped is not None:
            b[flipped] = np.abs(b[flipped])
        m1, m2, arg, neg = _minsum_fold(b, zeros, d)
        an, w = _new_minsum_state(m1, m2, arg, neg, d, f32(0.75))
        signs = w & all58
        if flipped is None:
            assert (neg == all58).all() and (signs == all58).all()
        else:
            assert (signs == U64(1 << flipped)).all()
        assert (_argmin_of(w) == arg).all() and (arg < 58).all()
        for j in (0, 31, 32, 57):
            assert (np.signbit(_c2v_of(an, w, j)) == (((signs >> U64(j)) & U64(1)) == 1)).all()


# ---------------------------------------------------------------------------
# Routes, plans, structure
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("members", [27, 28, 58, 59, 121, 122])
def test_routes_by_row_width(members):
    """A row of 27 members runs on the 32-bit word, 28 to 58 on the 64-bit
    word (``*_wide``), 59 to 121 on the 128-bit word (``*_w128``), 122 on
    fused; the builders, the serving objects with backend "auto" and
    "fused"; fused_zlane decoders take the same words' large-Z forms and
    keep their own kernel over 121 members."""
    qc = row_code(members, cols=max(64, members + 2))
    assert qc.dr_max == members
    suffix = "" if members <= 58 else "_w128"
    for mode, schedule in SCHEDULES:
        dec = fm.make_fused_minsum(qc, 5, mode=mode, schedule=schedule, device="cpu")
        if members <= 27:
            assert dec.route == NARROW_ROUTE[mode, schedule]
        elif members <= 121:
            route = WIDE_ROUTE[mode, schedule].removesuffix("_wide" if suffix else "")
            assert dec.route == route + suffix and dec.retire
            assert dec.graph is not None  # _launch_fused, the side door
        else:
            assert dec.route == "fused" and not dec.retire
    expected = ("retire_sumproduct" if members <= 27 else
                "retire_sumproduct_wide" if members <= 58 else
                "retire_sumproduct_w128" if members <= 121 else "fused")
    assert fm.make_fused_bp(qc, 5, device="cpu").route == expected
    for backend in ("auto", "fused"):
        bp = BeliefPropagationDecoder(qc, 5, early_stopping=False, backend=backend,
                                      device="cpu")
        assert bp._fused.route == expected
        ms = MinSumScaledDecoder(qc, 5, 0.75, early_stopping=False, backend=backend,
                                 schedule="layered", device="cpu")
        assert ms._fused.route == ("retire_layered" if members <= 27 else "retire_layered_wide"
                                   if members <= 58 else "retire_layered_w128"
                                   if members <= 121 else "fused")
    wide = 27 < members <= 58
    assert fm.retire_kernel_fits(qc, word_bits=128) == (members <= 121)
    assert fm.retire_kernel_fits(qc, word_bits=64) == (members <= 58)
    assert fm.retire_kernel_fits(qc) == (members <= 27)
    zl = fm.make_fused_minsum_zlane(row_code(members, cols=max(64, members + 2), Z=8), 5,
                                    device="cpu")
    assert zl.route == ("retire_zlane" if members <= 27 else "retire_zlane_wide" if members <= 58
                        else "retire_zlane_w128" if members <= 121 else "fused_zlane")
    if wide:
        assert set(WIDE_ROUTE.values()) == set(fm.WIDE_ROUTES)


def test_launch_counters_and_cpu_tensors():
    """Every wide route is retiring and counted; a CPU tensor runs the
    plain version and moves no counter."""
    assert set(fm.WIDE_ROUTES) <= set(fm.RETIRING) <= set(fm.LAUNCHES)
    assert {"retire_layered_wide", "retire_layered_sumproduct_wide"} <= set(fm._LAYERED_ROUTES)
    qc = code("w31")
    launches = dict(fm.LAUNCHES)
    llr = torch.from_numpy(bpsk_llrs(qc.num_vars, 3, 4.0, seed=2))
    for mode, schedule in SCHEDULES:
        fm.make_fused_minsum(qc, 3, mode=mode, schedule=schedule, device="cpu")(llr)
    assert fm.LAUNCHES == launches


def test_shared_memory_plans():
    """16 bytes a check's min-sum state with the 64-bit word (12 with the
    32-bit): at the (6, 32) Z=64 code a fused_retire_wide frame is 22,528
    bytes (beliefs and LLRs 16,384, state 6,144) and a retire_layered_wide
    frame 14,336; the structure 4,784 bytes at one part.  The sum-product
    kernels' shared memory does not depend on the word."""
    qc = code("ieee")
    Z, C, R, K = 64, 32, 6, 192
    assert (qc.Z, qc.num_base_cols, qc.num_base_rows, qc.num_base_edges) == (Z, C, R, K)
    words = -(-(6 * K + R + C + 2 + 2 * 2) // 4) * 4
    assert 4 * words == 4784
    for parts, frames in ((1, 1), (2, 3), (4, 9)):
        assert fm.retire_smem_bytes(qc, parts, frames, word_bits=64) == \
            4 * (-(-(6 * K + R + C + 2 + 2 * (parts + 1)) // 4) * 4) + frames * 22528
        assert fm.retire_smem_bytes(qc, parts, frames) == \
            fm.retire_smem_bytes(qc, parts, frames, word_bits=64) - frames * 4 * R * Z
    assert 4 * (2 * C * Z + 4 * R * Z) == 22528
    layered_words = -(-(2 * K + R + 1 + len(fm.row_groups(fm._structure(qc)))) // 4) * 4
    for frames in (1, 7, 15):
        assert fm.retire_layered_smem_bytes(qc, frames, word_bits=64) == \
            4 * layered_words + frames * 14336
        assert fm.retire_layered_smem_bytes(qc, frames) == 4 * layered_words + frames * 12800
    assert fm.retire_plans(qc, word_bits=64)[-1] == (4, 4)
    assert max(f for p, f in fm.retire_layered_plans(qc, word_bits=64)) == 15
    # every row its own group
    assert {p for p, _ in fm.retire_layered_plans(qc, word_bits=64)} == {1}
    assert max(f for _, f, s in fm.retire_sumproduct_plans(qc) if not s) == 3
    assert max(f for _, f in fm.retire_layered_sumproduct_plans(qc)) == 4
    # A row of 58 members at Z=4: wide plans exist, the 32-bit word refuses it.
    w58 = code("w58")
    assert fm.retire_plans(w58, word_bits=64) and not fm.retire_kernel_fits(w58)


def test_wide_structure_encoding():
    """The wide structure is the 32-bit one with each column member's (j <<
    27, 31 - j) replaced by (j, 63 - j), for min-sum and sum-product (edge
    offsets), at every parts count."""
    qc = code("w58")
    st = fm._structure(qc)
    K = st.K
    position = {k: j for m in st.row_members for j, k in enumerate(m)}
    js = np.asarray([position[k] for m in st.col_members for k in m])
    assert js.max() == 57
    for per_edge in (False, True):
        for parts in (1, 3):
            narrow = fm._retire_structure(st, parts, per_edge=per_edge)
            wide = fm._retire_structure(st, parts, per_edge=per_edge, word_bits=64)
            np.testing.assert_array_equal(narrow[4 * K:], wide[4 * K:])
            cols_n, cols_w = narrow[:4 * K].reshape(K, 4), wide[:4 * K].reshape(K, 4)
            np.testing.assert_array_equal(cols_n[:, :2], cols_w[:, :2])
            np.testing.assert_array_equal(cols_w[:, 2], js)
            np.testing.assert_array_equal(cols_w[:, 3], 63 - js)


# ---------------------------------------------------------------------------
# The JAX kernel
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_bp():
    import ldpc_tpu.codes as jcodes
    from ldpc_tpu.ops import pallas_minsum as jpm

    qc = jcodes.qc_layout(jcodes.BaseGraph("wide", wide_row_shifts()), 4)
    return jpm.make_fused_bp(qc, ITERS, batch_tile=8, interpret=True)


def test_sumproduct_plain_matches_jax():
    """Sum-product flooding on the 31-member code: the plain version behind
    retire_sumproduct_wide against the JAX kernel in interpret mode (the
    JAX package's sum-product bar)."""
    import jax.numpy as jnp

    qc = code("w31")
    dec = fm.make_fused_bp(qc, ITERS, device="cpu")
    assert dec.route == "retire_sumproduct_wide"
    llr = bpsk_llrs(qc.num_vars, 13, 4.0, seed=9)
    bits_j, conv_j = _jax_bp()(jnp.asarray(llr))
    bits_t, conv_t = dec(torch.from_numpy(llr))
    assert_decoder_parity("sumproduct", bits_j, conv_j, bits_t, conv_t)
    assert len(set(conv_t.tolist())) > 1
