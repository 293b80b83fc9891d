"""B1's widest rows: the four retiring kernels of csrc/fused_retire.cu on their
128-bit state word (``fused_retire_w128``, ``retire_layered_w128``,
``retire_sumproduct_w128``, ``retire_layered_sumproduct_w128``), which take
codes with rows of 59 to 121 members from the ``fused`` kernel (replaces
ldpc_tpu/ops/pallas_minsum.py:143 ``_kernel`` on such codes).

The 128-bit word (``Word128`` in csrc/retire.cuh) is two 64-bit limbs, lo
(bits 0..63) and hi (64..127): a check's output signs at bits 0..120 and its
argmin in the top 7 bits (no member: 127); a column member's structure entry
carries j and 127 - j.  Held here, on the CPU:

* numpy models of the four kernels' per-lane algorithms on the wrapper's own
  tables, with the word as two uint64 limbs and every limb operation of
  retire.cuh (the carry of push_sign, product_flips' mask across the limbs,
  the limb that bit_at_31 and member_sign pick): after every iteration the
  beliefs and the c2v of every frame still decoding equal the plain
  version's; bits and ``conv_iter`` equal ``fused_decode_plain``'s, tracked
  and in throughput mode.  Codes: rows of 64 and of 121 members at Z=4,
  built as ``chip_smoke.py``'s ``wide_row_code``, and J. L. Fan's array code
  at p = 61 (a (4, 61) array of 61 x 61 circulants, shift (r*c) mod 61, rows
  of 61 members, n = 3721) at a batch of a few frames;
* the routes (58 members -> the 64-bit word, 59 and 121 -> the 128-bit word,
  122 -> ``fused``), the launch counters, the shared-memory plans with fixed
  byte counts, and the structure encoding;
* one JAX case: min-sum flooding on the 64-member code through
  ``pallas_minsum.make_fused_minsum`` in interpret mode against the plain
  version behind ``fused_retire_w128``, bits and ``conv_iter`` identical.
  Its compile (about 15 s of XLA) starts in a thread of its own before the
  file's first case, where that case is to run, and overlaps the models.
"""
import concurrent.futures
import functools

import numpy as np
import pytest
import torch

from test_torch_parity import bpsk_llrs
from test_torch_retire_wide import (SCHEDULES, _Frames, _flip, _phi_np, flooding_model,
                                    layered_model, plain_history)

import ldpc_tpu_torch.codes as tcodes
from ldpc_tpu_torch.ops import fused_minsum as fm

ITERS = 8
W128_ROUTE = {("minsum", "flooding"): "fused_retire_w128",
              ("minsum", "layered"): "retire_layered_w128",
              ("sumproduct", "flooding"): "retire_sumproduct_w128",
              ("sumproduct", "layered"): "retire_layered_sumproduct_w128"}

f32, U32, U64 = np.float32, np.uint32, np.uint64
SIGN_BITS = 121  # kSignBits<Word128> in csrc/retire.cuh
NO_MEMBER = 127  # kNoMember<Word128>
ARG_SHIFT = U64(SIGN_BITS - 64)  # the argmin's place in hi


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


def wide_row_shifts(members: int) -> np.ndarray:
    """chip_smoke.py's wide_row_code's base matrix: (4, max(32, members +
    2)), its first row with ``members`` members, every column with a
    member."""
    cols = 32 if members < 32 else members + 2
    rng = np.random.default_rng(3)
    shifts = np.where(rng.random((4, cols)) < 0.4, rng.integers(0, 4, (4, cols)), -1)
    shifts[0] = np.concatenate([rng.integers(0, 4, members), np.full(cols - members, -1)])
    shifts[1, members:] = 1
    return shifts


def wide_row_code(members: int, Z: int = 4):
    return tcodes.qc_layout(tcodes.BaseGraph("wide", wide_row_shifts(members)), Z)


def array_code(p: int, rows: int = 4, cols: int | None = None):
    """J. L. Fan's array code (chip_smoke.py's array_code): a (rows, cols)
    array of p x p circulants, shift (r*c) mod p in every cell."""
    r, c = np.meshgrid(np.arange(rows), np.arange(cols or p), indexing="ij")
    return tcodes.qc_layout(tcodes.BaseGraph(f"array_p{p}", (r * c) % p), p)


@functools.lru_cache(maxsize=None)
def code(name: str):
    """``w59``, ``w64``, ``w121``: wide_row_code at Z=4 with a row of that
    many members; ``array61``: the array code at p = 61 (rows of 61)."""
    if name == "array61":
        return array_code(61)
    return wide_row_code(int(name[1:]))


def _llrs(name: str, kind: str) -> np.ndarray:
    """noise: BPSK LLRs at an SNR where frames converge at different
    iterations and some never; ties: the same quantised to odd integers, so
    that minimums tie and none is zero (a row this wide with two zero
    members sends every member +-0.0, and its signs would go unseen)."""
    qc = code(name)
    snr, batch = {"w64": (7.0, 13), "w121": (7.0, 13), "array61": (7.25, 4)}[name]
    llr = bpsk_llrs(qc.num_vars, batch, snr, seed=qc.dr_max)
    return np.floor(llr / 2.0) * 2.0 + 1.0 if kind == "ties" else llr


# ---------------------------------------------------------------------------
# The 128-bit state word, as csrc/retire.cuh reads and writes it: arrays of
# shape (..., 2), [..., 0] the limb lo and [..., 1] the limb hi
# ---------------------------------------------------------------------------


def _word(lo, hi):
    """The word of limbs lo and hi (arrays or scalars of one shape)."""
    w = np.empty(np.shape(lo if np.ndim(lo) else hi) + (2,), U64)
    w[..., 0], w[..., 1] = lo, hi
    return w


def _bit_at_31(w, j: int):
    """bit_at_31: bit j of the word, from the limb that holds it."""
    limb = w[..., 0] if j < 64 else w[..., 1]
    return ((limb >> U64(j & 63)) & U64(1)).astype(U32) << U32(31)


def _odd(w):
    return (np.bitwise_count(w[..., 0]) + np.bitwise_count(w[..., 1])) & 1


def _argmin_of(w):
    return (w[..., 1] >> ARG_SHIFT).astype(U32)


def _push_sign(x, neg):
    """push_sign: the word shifted up one, bit 63 of lo carried into hi,
    the sign bit of x at bit 0."""
    lo, hi = neg[..., 0], neg[..., 1]
    return _word((lo << U64(1)) | (x.view(U32) >> U32(31)).astype(U64),
                 (hi << U64(1)) | (lo >> U64(63)))


def _product_flips(neg, d: int):
    """product_flips: d bits across the limbs where the sign count is odd."""
    lo, hi = ((1 << d) - 1, 0) if d < 64 else ((1 << 64) - 1, (1 << (d - 64)) - 1)
    return np.where((_odd(neg) == 1)[..., None], np.asarray([lo, hi], U64), U64(0))


def _state_word(signs, arg):
    return _word(signs[..., 0], signs[..., 1] | (arg.astype(U64) << ARG_SHIFT))


def _c2v_of(a, w, j: int):
    return _flip(np.where(_argmin_of(w) == j, a[..., 1], a[..., 0]), _bit_at_31(w, j))


def _c2v_row(a, w, d: int):
    """c2v_of for members 0..d-1 of a check row at once (d, ...): bit j from
    lo for j < 64, else from hi."""
    j = np.arange(d).reshape((d,) + (1,) * (w.ndim - 1))
    loo = np.where(_argmin_of(w) == j, a[..., 1], a[..., 0])
    limb = np.where(j < 64, w[..., 0], w[..., 1])
    return _flip(loo, ((limb >> (j & 63).astype(U64)) & U64(1)).astype(U32) << U32(31))


def _minsum_fold(b, old, d: int):
    """The min-sum fold of a row's d members, last first: (m1, m2, argmin,
    neg)."""
    shape = b[0].shape
    m1, m2 = np.full(shape, 1e9, f32), np.full(shape, 1e9, f32)
    arg, neg = np.full(shape, NO_MEMBER, U32), np.zeros(shape + (2,), U64)
    for j in reversed(range(d)):
        x = b[j] - old[j]
        mag = np.abs(x)
        neg = _push_sign(x, neg)
        arg = np.where(mag <= m1, U32(j), arg)
        m2 = np.minimum(np.maximum(mag, m1), m2)
        m1 = np.minimum(mag, m1)
    return m1, m2, arg, neg


def _new_minsum_state(m1, m2, arg, neg, d: int, alpha):
    an = np.stack([alpha * np.where(m1 < 1e9, m1, f32(0)),
                   alpha * np.where(m2 < 1e9, m2, f32(0))], axis=-1)
    return an, _state_word(neg ^ _product_flips(neg, d), arg)


def _sign_at(x, j: int):
    """sign_at<Word128>: the sign bit of x at bit j, in its limb."""
    w = np.zeros(x.shape + (2,), U64)
    w[..., j >> 6] = (x.view(U32) >> U32(31)).astype(U64) << U64(j & 63)
    return w


def _sumproduct_fold(b, old, d: int):
    """phi_j of each member, S summed in member order, the 128-bit sign mask
    and the sign product at bit 31: (ph, S, neg, sp)."""
    ph, S, neg = [], np.zeros(b[0].shape, f32), np.zeros(b[0].shape + (2,), U64)
    for j in range(d):
        x = b[j] - old[j]
        neg |= _sign_at(x, j)
        ph.append(_phi_np(np.clip(np.abs(x), f32(1e-7), f32(20.0))))
        S = S + ph[j]
    return ph, S, neg, _odd(neg).astype(U32) << U32(31)


def _sumproduct_out(S, p, sp, neg, j: int):
    return _flip(_phi_np(np.maximum(S - p, f32(1e-7))), sp ^ _bit_at_31(neg, j))


class Word128:
    """The 128-bit word's operations for test_torch_retire_wide's models."""

    bits = 128

    @staticmethod
    def zeros(shape):
        return np.zeros(tuple(shape) + (2,), U64)

    c2v_row = staticmethod(_c2v_row)
    fold = staticmethod(_minsum_fold)
    new_state = staticmethod(_new_minsum_state)
    sp_fold = staticmethod(_sumproduct_fold)
    sp_out = staticmethod(_sumproduct_out)

    @staticmethod
    def member_c2v(a, w, jz: int, sa: int):
        """is_argmin, then member_sign: a shift by 127 - j of the limb that
        holds bit j (lo by 63 - j where 127 - j >= 64), its top 32 bits."""
        v = np.where(_argmin_of(w) == jz, a[..., 1], a[..., 0])
        limb = w[..., 0] if sa >= 64 else w[..., 1]
        return _flip(v, ((limb << U64(sa & 63)) >> U64(32)).astype(U32))


# ---------------------------------------------------------------------------
# The models against the plain version
# ---------------------------------------------------------------------------

MODEL_CASES = [("w64", "noise"), ("w121", "noise"), ("w121", "ties"), ("array61", "noise")]


@pytest.mark.parametrize("mode,schedule", SCHEDULES)
@pytest.mark.parametrize("name,kind", MODEL_CASES)
def test_model_matches_plain(name, kind, mode, schedule):
    """After every iteration the beliefs and c2v of every frame still
    decoding equal the plain version's (c2v expanded from the 128-bit state
    words for min-sum); bits and conv_iter equal fused_decode_plain's,
    tracked and in throughput mode; the decoder routes to the w128 kernel."""
    qc = code(name)
    assert 59 <= qc.dr_max <= 121
    llr = _llrs(name, kind)
    alpha = 0.75 if mode == "minsum" else 1.0
    model = layered_model if schedule == "layered" else flooding_model
    reference = plain_history(qc, llr, ITERS, mode, schedule, alpha)
    for track in (True, False):
        bits_m, conv_m, history = model(qc, llr, ITERS, track, mode, alpha, word=Word128)
        for (live, bel_m, c2v_m), (bel_p, c2v_p) in zip(history, reference):
            np.testing.assert_array_equal(bel_m[live], bel_p[live])
            np.testing.assert_array_equal(c2v_m[live], c2v_p[live])
        dec = fm.make_fused_minsum(qc, ITERS, alpha, mode=mode, schedule=schedule,
                                   track_convergence=track, device="cpu")
        assert dec.route == W128_ROUTE[mode, schedule] and dec.retire
        bits_p, conv_p = dec.plain(torch.from_numpy(llr))
        np.testing.assert_array_equal(bits_m, bits_p.numpy())
        np.testing.assert_array_equal(conv_m, conv_p.numpy())
        if not track:
            assert (conv_m == ITERS).all()
        elif kind == "noise":
            assert len(set(conv_m.tolist())) > 1


def test_state_word_holds_121_members():
    """A row of 121 members fills every sign bit below the argmin, across
    both limbs: with every v2c negative (an odd count) the sign product
    flips every output sign to +; with one member positive (an even count)
    every output sign but that member's is set.  The argmin reads back from
    the top 7 bits, and each member's c2v from its bit, at both sides of the
    limbs' seam (63, 64) and at the last member (120)."""
    qc = code("w121")
    m = _Frames(qc, -np.abs(bpsk_llrs(qc.num_vars, 64, 0.0, seed=1)), per_edge=False,
                word_bits=128)
    _, d, pos = m.row(0)
    assert d == 121
    b = [m.bel[:, p] for p in pos]
    zeros = [np.zeros_like(x) for x in b]
    all121 = np.asarray([(1 << 64) - 1, (1 << 57) - 1], U64)
    for flipped in (None, 40, 64):
        if flipped is not None:
            b = [np.abs(x) if j == flipped else -np.abs(x) for j, x in enumerate(b)]
        m1, m2, arg, neg = _minsum_fold(b, zeros, d)
        an, w = _new_minsum_state(m1, m2, arg, neg, d, f32(0.75))
        signs = w & all121
        if flipped is None:
            assert (neg == all121).all() and (signs == 0).all()
        else:
            one = np.zeros(2, U64)
            one[flipped // 64] = U64(1) << U64(flipped % 64)
            assert (signs == all121 ^ one).all()
        assert (_argmin_of(w) == arg).all() and (arg < 121).all()
        for j in (0, 40, 63, 64, 120):
            bit = (signs[..., j // 64] >> U64(j % 64)) & U64(1)
            assert (np.signbit(_c2v_of(an, w, j)) == (bit == 1)).all()
            assert (_bit_at_31(w, j) == (bit.astype(U32) << U32(31))).all()


@pytest.mark.parametrize("d", [59, 63, 64, 65, 121])
def test_product_flips_and_member_sign_across_limbs(d):
    """product_flips sets exactly bits 0..d-1 across the limbs; member_sign
    with the structure's 127 - j brings bit j to bit 31 from either limb,
    and bit_at_31 agrees with it for every member."""
    rng = np.random.default_rng(d)

    def random_words():
        return _word(rng.integers(0, 1 << 63, 16, dtype=np.int64).astype(U64) * U64(3),
                     rng.integers(0, 1 << 57, 16, dtype=np.int64).astype(U64))

    neg = random_words()
    neg[_odd(neg) == 0, 0] ^= U64(1)  # an odd count of signs: every flip set
    want = (1 << d) - 1
    assert all(int(f[0]) | (int(f[1]) << 64) == want for f in _product_flips(neg, d))
    neg[:, 0] ^= U64(1)  # an even count: none
    assert (_product_flips(neg, d) == 0).all()
    w = random_words()
    a = np.ones(w.shape[:-1] + (2,), f32)
    for j in range(d):
        sign = np.signbit(Word128.member_c2v(a, w, jz=NO_MEMBER, sa=127 - j))
        bit = (w[..., j // 64] >> U64(j % 64)) & U64(1)
        assert (sign == (bit == 1)).all()
        assert (np.signbit(_flip(a[..., 0], _bit_at_31(w, j))) == sign).all()


# ---------------------------------------------------------------------------
# Routes, counters, plans, structure
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("members", [58, 59, 121, 122])
def test_routes_by_word(members):
    """chip_smoke.py's wide-row codes: 58 members on the 64-bit word, 59 and
    121 on the 128-bit word, 122 on fused; each w128 route launches its B1
    kernel's instantiation on word_bits 128."""
    qc = wide_row_code(members)
    assert qc.dr_max == members
    for (mode, schedule), route in W128_ROUTE.items():
        dec = fm.make_fused_minsum(qc, 5, mode=mode, schedule=schedule, device="cpu")
        if members <= 58:
            assert dec.route == route.replace("_w128", "_wide")
        elif members <= 121:
            assert dec.route == route and dec.retire and dec.graph is not None
            assert fm._ROUTE_WORD[route] == (route.removesuffix("_w128"), 128)
        else:
            assert dec.route == "fused" and not dec.retire
    assert fm.retire_kernel_fits(qc, word_bits=128) == (members <= 121)
    assert fm.retire_layered_fits(qc, word_bits=128) == (members <= 121)
    assert fm.retire_sumproduct_fits(qc, word_bits=128) == (members <= 121)
    assert fm.retire_layered_sumproduct_fits(qc, word_bits=128) == (members <= 121)


def test_launch_counters_and_cpu_tensors():
    """Every w128 route is retiring and counted, the layered ones read the
    layered structure; a CPU tensor runs the plain version and moves no
    counter."""
    assert set(fm.W128_ROUTES) == set(W128_ROUTE.values())
    assert set(fm.W128_ROUTES) <= set(fm.RETIRING) <= set(fm.LAUNCHES)
    assert {"retire_layered_w128", "retire_layered_sumproduct_w128"} <= set(fm._LAYERED_ROUTES)
    qc = code("w64")
    launches = dict(fm.LAUNCHES)
    llr = torch.from_numpy(bpsk_llrs(qc.num_vars, 3, 4.0, seed=2))
    for mode, schedule in SCHEDULES:
        fm.make_fused_minsum(qc, 3, mode=mode, schedule=schedule, device="cpu")(llr)
    assert fm.LAUNCHES == launches


def test_shared_memory_plans():
    """24 bytes a check's min-sum state with the 128-bit word: at
    chip_smoke.py's widest_rows code (p = 67, (4, 64) cells) a
    fused_retire_w128 frame is 40,736 bytes (beliefs and LLRs 34,304, state
    6,432), a retire_layered_w128 frame 23,584; the structures 6,448 bytes
    (one part) and 2,096.  The sum-product kernels' shared memory does not
    depend on the word."""
    qc = array_code(67, cols=64)
    Z, C, R, K = 67, 64, 4, 256
    assert (qc.Z, qc.num_base_cols, qc.num_base_rows, qc.num_base_edges) == (Z, C, R, K)
    assert 4 * (2 * C * Z + 6 * R * Z) == 40736 and 4 * (C * Z + 6 * R * Z) == 23584
    for parts, frames in ((1, 1), (2, 3), (4, 2)):
        structure = 4 * (-(-(6 * K + R + C + 2 + 2 * (parts + 1)) // 4) * 4)
        assert fm.retire_smem_bytes(qc, parts, frames, word_bits=128) == \
            structure + frames * 40736
        assert fm.retire_smem_bytes(qc, parts, frames, word_bits=128) - \
            fm.retire_smem_bytes(qc, parts, frames, word_bits=64) == frames * 8 * R * Z
    assert fm.retire_smem_bytes(qc, word_bits=128) == 6448 + 40736
    for frames in (1, 5, 9):
        assert fm.retire_layered_smem_bytes(qc, frames, word_bits=128) == 2096 + frames * 23584
    assert max(f for p, f in fm.retire_plans(qc, word_bits=128) if p == 1) == 5
    assert fm.retire_layered_plans(qc, word_bits=128) == [(1, f) for f in range(1, 10)]
    assert max(f for _, f, s in fm.retire_sumproduct_plans(qc) if not s) == 2
    assert fm.retire_layered_sumproduct_plans(qc) == [(1, 1), (1, 2)]


def test_structure_encoding():
    """The 128-bit structure is the 32-bit one with each column member's (j
    << 27, 31 - j) replaced by (j, 127 - j), for min-sum and sum-product
    (edge offsets), at every parts count."""
    qc = code("w121")
    st = fm._structure(qc)
    K = st.K
    position = {k: j for m in st.row_members for j, k in enumerate(m)}
    js = np.asarray([position[k] for m in st.col_members for k in m])
    assert js.max() == 120
    for per_edge in (False, True):
        for parts in (1, 3):
            narrow = fm._retire_structure(st, parts, per_edge=per_edge)
            w128 = fm._retire_structure(st, parts, per_edge=per_edge, word_bits=128)
            np.testing.assert_array_equal(narrow[4 * K:], w128[4 * K:])
            cols_n, cols_w = narrow[:4 * K].reshape(K, 4), w128[:4 * K].reshape(K, 4)
            np.testing.assert_array_equal(cols_n[:, :2], cols_w[:, :2])
            np.testing.assert_array_equal(cols_w[:, 2], js)
            np.testing.assert_array_equal(cols_w[:, 3], 127 - js)


# ---------------------------------------------------------------------------
# The JAX kernel
# ---------------------------------------------------------------------------


def _jax_llrs() -> np.ndarray:
    return bpsk_llrs(code("w64").num_vars, 13, 7.0, seed=9)


@functools.cache
def _jax_decode() -> concurrent.futures.Future:
    """The JAX kernel's (bits, conv_iter) on _jax_llrs(), decoded in a thread
    of its own: XLA's compile releases the interpreter, so the models run
    meanwhile."""
    def decode():
        import jax.numpy as jnp
        import ldpc_tpu.codes as jcodes
        from ldpc_tpu.ops import pallas_minsum as jpm

        jqc = jcodes.qc_layout(jcodes.BaseGraph("wide", wide_row_shifts(64)), 4)
        jdec = jpm.make_fused_minsum(jqc, ITERS, 0.75, batch_tile=8, interpret=True)
        return tuple(np.asarray(a) for a in jdec(jnp.asarray(_jax_llrs())))

    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(decode)
    pool.shutdown(wait=False)
    return future


def test_minsum_plain_matches_jax():
    """Min-sum flooding on the 64-member code: the plain version behind
    fused_retire_w128 against the JAX kernel in interpret mode, bits and
    conv_iter identical."""
    dec = fm.make_fused_minsum(code("w64"), ITERS, 0.75, device="cpu")
    assert dec.route == "fused_retire_w128"
    bits_j, conv_j = _jax_decode().result()
    bits_t, conv_t = dec(torch.from_numpy(_jax_llrs()))
    np.testing.assert_array_equal(bits_j, bits_t.numpy())
    np.testing.assert_array_equal(conv_j, conv_t.numpy())
    assert len(set(conv_t.tolist())) > 1
