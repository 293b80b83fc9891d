"""B3's redesign, the ``neural_group`` kernel (csrc/fused_neural.cu, replaces
ldpc_tpu/ops/pallas_neural.py:111 ``kernel`` on the codes it takes).

The kernel decodes a frame on a group of warps split into parts (rows and
columns cut to equal work), keeps each lifted check's c2v compressed (A =
alpha * max(m' - offset, 0) for m1 and m2, W = output signs and argmin),
rebuilds every member's v2c in the check pass from the column sums, the
state, the check-aligned weights and a check-aligned FIFO ring, and writes
the bits from its last column pass.  Held here, on the CPU, with no JAX
(the plain version is held against the JAX kernel by
tests/test_torch_fused_neural.py):

* a torch model of the kernel's per-lane algorithm on the wrapper's own
  tables (structure and parts, check-aligned weights, parameters), whose
  c2v, expanded from the state after every iteration, and bits equal
  ``neural_decode_plain``'s bit for bit, over every weight sharing, depth
  0-4, per-iteration parameters on and off, learnable alpha and offset
  (negative ones too), tied magnitudes and +-0.0 LLRs; in the slice forms
  (``neural_group_slice_kernel``) with the FIFO, and in form 2 the state
  words, read and written in place in a NaN-filled flat scratch laid out
  as the kernel's slices, reused frame after frame and never cleared;
* the shared-memory and scratch plans with fixed byte counts (Z=32, 128
  and 384), the weight repacking and the routes.
"""
import numpy as np
import pytest
import torch

from test_torch_minsum_retire import hard_llrs
from test_torch_parity import bpsk_llrs

import ldpc_tpu_torch.codes as tcodes
from ldpc_tpu_torch.models import NeuralMinSumDecoder
from ldpc_tpu_torch.ops import fused_minsum as fm, fused_neural as fn, qc_msg
from ldpc_tpu_torch.ops.qc_msg import _BIG

# Per state word (csrc/retire.cuh): the signs it holds (kSignBits), its
# argmin when no member is below the sentinel (kNoMember), and its 64-bit
# limbs (one for the 32-bit word, whose value stays below 2^32).
SIGN_BITS = {32: 27, 64: 58, 128: 121}
NO_MEMBER = {32: 31, 64: 63, 128: 127}
LIMBS = {32: 1, 64: 1, 128: 2}


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: the suite's workers run side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qc(name: str, Z: int):
    return tcodes.qc_layout(tcodes.get_base_graph(name), Z)


def row_shifts(members: int, Z: int = 4) -> np.ndarray:
    """A base matrix whose first row has ``members`` members, (4, 32) up to
    31 members and (4, members + 2) above; every column has one."""
    cols = 32 if members < 32 else members + 2
    rng = np.random.default_rng(members)
    shifts = np.where(rng.random((4, cols)) < 0.3, rng.integers(0, Z, (4, cols)), -1)
    shifts[0] = np.where(np.arange(cols) < members, rng.integers(0, Z, cols), -1)
    shifts[1, members:] = 0
    return shifts


def _row_code(members: int, Z: int = 4):
    return tcodes.qc_layout(tcodes.BaseGraph(f"row{members}", row_shifts(members, Z)), Z)


def _decoder(qc, T: int, L: int, sharing: str, per_it: bool, seed: int,
             negative: bool = False):
    """A decoder of a NeuralMinSumDecoder whose parameters are moved by
    normal noise from a seed (so weights, taps, alpha and offset all
    matter); ``negative`` makes every offset and one alpha negative."""
    model = NeuralMinSumDecoder(qc_msg.make_plan(qc, "cpu"), num_iterations=T, depth_L=L,
                                weight_sharing=sharing, learnable_alpha=True,
                                learnable_offset=True, per_iteration=per_it)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
            p.add_(0.3 * noise if name in ("w_res", "offset") else 0.1 * noise)
        if negative:
            model.offset.copy_(-model.offset.abs() - 0.05)
            model.alpha.view(-1)[0].neg_()
    return fn.make_fused_neural_minsum(qc, model, T, L, per_iteration=per_it, device="cpu")


def _unpack(st, parts: int, word_bits: int = 32):
    """The wrapper's structure of ``parts`` parts: column members (r*Z,
    shift, j << 27, 31 - j; on the wider words j, bits - 1 - j), row
    members (col*Z, shift), row_ptr, col_ptr, first row and first column of
    each part."""
    K, R, C = st.K, st.R, st.C
    g = fm._retire_structure(st, parts, word_bits=word_bits).view(np.uint32).astype(np.int64)
    col_mem = g[:4 * K].reshape(K, 4)
    row_mem = g[4 * K:6 * K].reshape(K, 2)
    o = 6 * K
    row_ptr, col_ptr = g[o:o + R + 1], g[o + R + 1:o + R + C + 2]
    o += R + C + 2
    return col_mem, row_mem, row_ptr, col_ptr, g[o:o + parts + 1], g[o + parts + 1:]


def _flip(v: torch.Tensor, bit: torch.Tensor) -> torch.Tensor:
    """v with its sign bit flipped where ``bit`` is 1 (flip_if)."""
    return torch.where(bit.bool(), -v, v)


# ---------------------------------------------------------------------------
# The state word, as csrc/retire.cuh reads and writes it: int64 tensors of
# shape (..., LIMBS[bits]), limb 0 bits 0..63 (lo), limb 1 bits 64..127 (hi);
# the 32-bit word is one limb below 2^32.  Shifts of a limb wrap at 64 bits.
# ---------------------------------------------------------------------------


def _zeros(shape, bits: int) -> torch.Tensor:
    return torch.zeros(tuple(shape) + (LIMBS[bits],), dtype=torch.int64)


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each 64-bit limb (the masks drop what >> shifts in)."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    return (x * 0x0101010101010101) >> 56


def _push_sign(neg: torch.Tensor, x: torch.Tensor, bits: int) -> torch.Tensor:
    """push_sign: the word shifted up one (bit 63 of lo carried into hi),
    the sign bit of x at bit 0."""
    out = neg << 1
    out[..., 0] |= torch.signbit(x).long()
    if bits == 32:
        out &= 0xFFFFFFFF
    if LIMBS[bits] == 2:
        out[..., 1] |= (neg[..., 0] >> 63) & 1
    return out


def _product_flips(neg: torch.Tensor, d: int, bits: int) -> torch.Tensor:
    """product_flips: the d low bits, across the limbs, where the count of
    set bits is odd."""
    mask = torch.tensor([(1 << d) - 1 if d < 64 else -1, (1 << max(d - 64, 0)) - 1][:LIMBS[bits]])
    return torch.where((_popcount(neg).sum(-1) % 2 == 1)[..., None], mask, 0)


def _state_word(signs: torch.Tensor, arg: torch.Tensor, bits: int) -> torch.Tensor:
    """state_word: the argmin above the signs, in the top limb."""
    out = signs.clone()
    out[..., -1] |= arg << (SIGN_BITS[bits] - 64 * (LIMBS[bits] - 1))
    return out


def _argmin_of(w: torch.Tensor, bits: int) -> torch.Tensor:
    shift = SIGN_BITS[bits] - 64 * (LIMBS[bits] - 1)
    return (w[..., -1] >> shift) & (2 ** (bits - SIGN_BITS[bits]) - 1)


def _bit(w: torch.Tensor, j: int) -> torch.Tensor:
    """bit_at_31's bit: bit j of the word, from the limb that holds it."""
    return (w[..., j // 64] >> (j % 64)) & 1


def _c2v_of(a: torch.Tensor, w: torch.Tensor, j: int, bits: int) -> torch.Tensor:
    """Member j's c2v from its check's state (a (..., 2), w (..., limbs))."""
    v = torch.where(_argmin_of(w, bits) == j, a[..., 1], a[..., 0])
    return _flip(v, _bit(w, j))


def _member_c2v(a: torch.Tensor, w: torch.Tensor, jz: int, jw: int, bits: int) -> torch.Tensor:
    """The column pass's read of a check state through the structure's
    fields: is_argmin, then member_sign's bit 31.  32-bit word: (w ^ jz) &
    0xf8000000 with jz = j << 27, then w << jw (jw = 31 - j); 64-bit: the
    argmin against jz = j, then bit 31 of (w << jw) >> 32 (jw = 63 - j);
    128-bit: the same with jw = 127 - j, shifting lo by 63 - j where jw >=
    64, else hi."""
    if bits == 32:
        v = torch.where(((w[..., 0] ^ jz) & 0xF8000000) == 0, a[..., 1], a[..., 0])
        return _flip(v, (w[..., 0] >> (31 - jw)) & 1)
    v = torch.where(_argmin_of(w, bits) == jz, a[..., 1], a[..., 0])
    limb = w[..., 0] if jw >= 64 else w[..., -1]
    return _flip(v, ((limb << (jw & 63)) >> 63) & 1)


def _to_words(W: torch.Tensor, bits: int) -> torch.Tensor:
    """(B, R*Z, limbs) words -> (B, R*Z * bits/32) int32, as the kernel
    lays them out in memory (little-endian, lo limb first)."""
    if bits == 32:
        halves = W & 0xFFFFFFFF
    else:
        halves = torch.stack([W & 0xFFFFFFFF, (W >> 32) & 0xFFFFFFFF], dim=-1)
    return (halves - ((halves >> 31) << 32)).to(torch.int32).reshape(W.shape[0], -1)


def _from_words(words: torch.Tensor, bits: int) -> torch.Tensor:
    """_to_words' inverse on whatever the words hold."""
    u = words.long() & 0xFFFFFFFF
    if bits == 32:
        return u.reshape(u.shape[0], -1, 1)
    u = u.reshape(u.shape[0], -1, LIMBS[bits], 2)
    return u[..., 0] | (u[..., 1] << 32)


def kernel_model(dec, llr: torch.Tensor, parts: int, record: list | None = None,
                 slices: int = 0, layout: int = 2):
    """csrc/fused_neural.cu's neural_group algorithm on (frame, lane) tensors,
    on the decoder's own tables: check pass p of each part's rows (pass 0
    folds LLR + 0.0; later passes rebuild each member's v2c as ((cs - c2v) +
    w * llr) + live * taps, store it in the FIFO ring slot p mod L and fold
    it, members last first), then the column pass of each part's columns
    (c2v expanded from the state, summed from +0.0); bits from the last.
    ``record`` receives c2v, var-aligned (B, K*Z), after every check pass.

    The state word is the decoder's (``dec.word_bits``: 32, 64 or 128
    bits, as limbs, with every limb operation of retire.cuh), and depths
    over 4 step their FIFO offsets as the run-time-depth form does: from
    slot t mod L down one plane a tap, slot 0 wrapping to L - 1.

    ``slices`` > 0: slice form ``layout`` (1 or 2).  Each frame's FIFO and
    (form 2) state words live in one of ``slices`` slices of a flat int32
    scratch laid out as the kernel's (form 2: W entry r*Z + z at words
    (r*Z + z) * bits/32 on, then FIFO plane l at bits/32 R*Z + l*K*Z; form
    1: plane l at l*K*Z; the edge at row-order position i and check lane z
    at i*Z + z), filled with NaN once and never cleared; frames take the
    slices ``slices`` at a time, as a block's frame groups take them, so a
    read before the frame's own write would reach an earlier frame's state
    or a NaN."""
    if not slices:
        return _model(dec, llr, parts, record, None, 0)
    words = fn.neural_group_scratch_bytes(dec.qc, dec.depth_L, layout) // 4
    scratch = torch.full((slices, words), 0x7FC00000, dtype=torch.int32)  # NaN
    outs, recs = [], []
    for f0 in range(0, llr.shape[0], slices):
        rec = [] if record is not None else None
        chunk = llr[f0:f0 + slices]
        outs.append(_model(dec, chunk, parts, rec, scratch[:chunk.shape[0]], layout))
        recs.append(rec)
    if record is not None:
        record.extend(torch.cat(per_t) for per_t in zip(*recs))
    return torch.cat(outs)


def _model(dec, llr: torch.Tensor, parts: int, record: list | None,
           scratch: torch.Tensor | None, layout: int):
    """kernel_model on a batch, with the FIFO and (``layout`` 2) W in
    ``scratch`` (a slice form) or in tensors of their own."""
    st, tb = dec.st, dec.tables
    Z, R, C, K, T, L = st.Z, st.R, st.C, st.K, dec.num_iterations, dec.depth_L
    bits = dec.word_bits
    col_mem, row_mem, row_ptr, col_ptr, row_part, col_part = _unpack(st, parts, bits)
    B, KZ, S = llr.shape[0], K * Z, max(L, 1)
    params = tb.params.tolist()
    alpha, offset, w_res = params[:T], params[T:2 * T], params[2 * T:]
    wc = tb.wc
    z = torch.arange(Z)
    pow2 = Z & (Z - 1) == 0

    def rolled(s, offset_):
        if pow2:
            return ((z + s) & (Z - 1)) | offset_
        v = z + s
        return torch.where(v >= Z, v - Z, v) + offset_

    A = torch.zeros((B, R * Z, 2))
    cs = torch.zeros((B, C * Z))
    w_words = bits // 32 * R * Z if layout == 2 else 0  # W's words in the slice
    W = _zeros((B, R * Z), bits)
    if scratch is None:
        fifo = torch.zeros((B, L * KZ))
    else:
        fifo = scratch[:, w_words:w_words + L * KZ].view(torch.float32)  # writes land there
    if w_words:
        W = _from_words(scratch[:, :w_words], bits)  # whatever the slice holds
    # Every row and column belongs to exactly one part.
    assert row_part[0] == 0 and row_part[-1] == R and (np.diff(row_part) >= 0).all()
    assert col_part[0] == 0 and col_part[-1] == C and (np.diff(col_part) >= 0).all()

    for p in range(T):
        A_new, W_new = A.clone(), W.clone()
        t = p - 1
        if p:
            w_plane = wc[t if wc.shape[0] > 1 else 0]
            taps, live = min(L, t), 1.0 if t > 0 else 0.0
        for part in range(parts):
            for r in range(row_part[part], row_part[part + 1]):
                j0, d = int(row_ptr[r]), int(row_ptr[r + 1] - row_ptr[r])
                q = r * Z + z
                a_old, w_old = A[:, q], W[:, q]
                m1 = torch.full((B, Z), _BIG)
                m2 = m1.clone()
                arg = torch.full((B, Z), NO_MEMBER[bits], dtype=torch.int64)
                neg = _zeros((B, Z), bits)
                for j in reversed(range(d)):
                    col_z, shift = row_mem[j0 + j]
                    v = rolled(int(shift), int(col_z))
                    if p == 0:
                        x = llr[:, v] + 0.0
                    else:
                        e = (j0 + j) * Z + z
                        x = (cs[:, v] - _c2v_of(a_old, w_old, j, bits)) + w_plane[e] * llr[:, v]
                        if L:
                            res = torch.zeros((B, Z))
                            for l, slot in zip(range(taps), _read_offsets(t, L, KZ)):
                                res = res + w_res[t * S + l] * fifo[:, slot + e]
                            x = x + live * res
                            fifo[:, (p % L) * KZ + e] = x
                    mag = x.abs()
                    neg = _push_sign(neg, x, bits)
                    arg = torch.where(mag <= m1, j, arg)
                    m2 = torch.minimum(torch.maximum(mag, m1), m2)
                    m1 = torch.minimum(mag, m1)
                sp = _product_flips(neg, d, bits)
                m1z = torch.where(m1 < _BIG, m1, 0.0)
                m2z = torch.where(m2 < _BIG, m2, 0.0)
                A_new[:, q, 0] = alpha[p] * torch.clamp(m1z - offset[p], min=0.0)
                A_new[:, q, 1] = alpha[p] * torch.clamp(m2z - offset[p], min=0.0)
                W_new[:, q] = _state_word(neg ^ sp, arg, bits)
        A, W = A_new, W_new  # the barrier between the passes
        if w_words:  # the new words, as uint32 bits, into the slice
            scratch[:, :w_words] = _to_words(W, bits)
            W = _from_words(scratch[:, :w_words], bits)
        if record is not None:
            record.append(_expand(st, row_mem, row_ptr, A, W, bits))
        cs_new = torch.zeros_like(cs)
        for part in range(parts):
            for c in range(col_part[part], col_part[part + 1]):
                acc = torch.zeros((B, Z))
                for i in range(int(col_ptr[c]), int(col_ptr[c + 1])):
                    r_z, shift, jz, jw = col_mem[i]
                    q = rolled(Z - int(shift), int(r_z))
                    acc = acc + _member_c2v(A[:, q], W[:, q], int(jz), int(jw), bits)
                cs_new[:, c * Z + z] = acc
        cs = cs_new
    return ((llr + cs) < 0).to(torch.float32)


def _read_offsets(t: int, L: int, KZ: int) -> list[int]:
    """The FIFO offsets of q_t, q_{t-1}, ... (slot (t - l) mod L times K*Z):
    found apart for depth 1 to 4, as those forms find them once a pass;
    over 4 stepped as the run-time-depth form steps them, from slot t mod L
    down one plane a tap, slot 0 wrapping to L - 1."""
    if L <= 4:
        return [((t - l) % L) * KZ for l in range(L)]
    out, slot = [], (t % L) * KZ
    for _ in range(L):
        out.append(slot)
        slot = (L - 1) * KZ if slot == 0 else slot - KZ
    return out


def _expand(st, row_mem, row_ptr, A, W, bits: int) -> torch.Tensor:
    """Every lifted edge's c2v from the check states, var-aligned (B, K*Z)
    as the plain version keeps it: base edge k's variable lane v is check
    lane (v - shift) mod Z."""
    Z = st.Z
    out = torch.zeros((A.shape[0], st.K * Z))
    v = torch.arange(Z)
    for r, members in enumerate(st.row_members):
        for j, k in enumerate(members):
            zc = (v - st.shifts[k]) % Z
            out[:, k * Z + v] = _c2v_of(A[:, r * Z + zc], W[:, r * Z + zc], j, bits)
    return out


def _plain(dec, llr: torch.Tensor, record: list):
    ix, ev = fm._PlainIndex(dec.st, llr.device), torch.as_tensor(dec._edge_var)
    return fn.neural_decode_plain(llr, ix, ev, dec.tables, dec.num_iterations, dec.depth_L,
                                  record)


def _bits_of(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def assert_model_is_plain(dec, llr: torch.Tensor, parts: int, slices: int = 0,
                          layout: int = 2) -> None:
    """The model's bits and its c2v after every iteration equal the plain
    version's, value and sign bit (+-0.0 too)."""
    want_c2v, got_c2v = [], []
    want = _plain(dec, llr, want_c2v)
    got = kernel_model(dec, llr, parts, got_c2v, slices, layout)
    assert len(got_c2v) == len(want_c2v) == dec.num_iterations
    for t, (g, w) in enumerate(zip(got_c2v, want_c2v)):
        assert torch.equal(_bits_of(g), _bits_of(w)), f"c2v differs after iteration {t}"
    assert torch.equal(got, want)


# (code, Z, batch, T, depth, sharing, per_iteration, parts, negative)
CASES = [
    ("toy_4x8", 4, 5, 4, 0, "scalar", False, 1, False),
    ("toy_4x8", 4, 5, 4, 1, "cell", True, 2, True),
    ("toy_4x8", 4, 5, 5, 2, "type", True, 4, False),
    ("toy_4x8", 4, 5, 5, 3, "edge", False, 3, True),
    ("toy_4x8", 4, 5, 1, 2, "edge", True, 2, False),
    ("nr_2_0_4", 4, 4, 4, 0, "edge", True, 16, False),
    ("nr_2_0_4", 4, 4, 4, 1, "scalar", True, 5, False),
    ("nr_2_0_4", 4, 4, 5, 2, "edge", True, 16, True),
    ("nr_2_0_4", 4, 4, 5, 3, "cell", True, 7, False),
    ("nr_2_0_4", 4, 4, 4, 2, "type", False, 1, True),
    ("nr_2_0_32", 32, 2, 4, 2, "edge", True, 16, False),
    ("nr_2_0_32", 32, 2, 4, 3, "type", True, 9, True),
    ("nr_2_0_32", 32, 2, 3, 0, "scalar", False, 4, False),
    ("nr_2_0_32", 24, 2, 4, 1, "edge", False, 6, False),
    ("toy_4x8", 4, 5, 6, 4, "edge", True, 2, True),
    ("nr_2_0_4", 4, 4, 6, 4, "type", True, 5, False),
]


@pytest.mark.parametrize("name,Z,batch,T,L,sharing,per_it,parts,negative", CASES)
def test_model_matches_plain(name, Z, batch, T, L, sharing, per_it, parts, negative):
    """Noise at 1 dB on a mix of frames; Z=24 takes the non-power-of-two
    roll."""
    qc = _qc(name, Z)
    dec = _decoder(qc, T, L, sharing, per_it, seed=Z + T + L, negative=negative)
    assert dec.route == "neural_group"
    llr = torch.from_numpy(bpsk_llrs(qc.num_vars, batch, 1.0, seed=T + L))
    assert_model_is_plain(dec, llr, parts)


@pytest.mark.parametrize("layout", [1, 2])
@pytest.mark.parametrize("L", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("name,Z,batch,parts,slices", [("nr_2_0_4", 4, 7, 3, 3),
                                                       ("nr_2_0_32", 12, 5, 4, 2)])
def test_slice_model_matches_plain(name, Z, batch, parts, slices, L, layout):
    """The slice forms forced where a frame fits a block: the FIFO (and in
    form 2 W) in a NaN-filled scratch of fewer slices than frames, so later
    frames find an earlier frame's state in their slice; T=6 so that depth
    4's taps all run; Z=12 takes the non-power-of-two roll."""
    qc = _qc(name, Z)
    dec = _decoder(qc, 6, L, "edge", True, seed=Z + L, negative=L % 2 == 1)
    llr = torch.from_numpy(bpsk_llrs(qc.num_vars, batch, 1.0, seed=L))
    assert_model_is_plain(dec, llr, parts, slices, layout)


@pytest.mark.parametrize("kind", ["ties", "zeros"])
@pytest.mark.parametrize("name,Z,L,parts", [("nr_2_0_4", 4, 2, 8), ("toy_4x8", 4, 3, 2)])
def test_model_on_ties_and_zeros(name, Z, L, parts, kind):
    """Quantised LLRs (tied magnitudes, so argmin ties) and LLRs of +0.0
    and -0.0, with negative offsets: the zero c2v keep the plain version's
    sign bit too."""
    qc = _qc(name, Z)
    dec = _decoder(qc, 4, L, "edge", True, seed=11, negative=True)
    llr = torch.from_numpy(hard_llrs(kind, qc.num_vars, seed=3)[:6])
    assert_model_is_plain(dec, llr, parts)


# The wider state words: (row members, T, depth, sharing, per_iteration,
# parts, negative).  28, 31 and 58 members on the 64-bit word, 59, 64 and 121
# on the 128-bit one (a row of 64 folds members 63..58 in the loop, then the
# 58-member switch, and carries bit 63 of lo into hi).
WIDE_CASES = [(28, 4, 2, "edge", True, 2, False), (31, 5, 3, "cell", True, 3, True),
              (58, 4, 1, "type", False, 2, True), (59, 4, 2, "edge", True, 4, False),
              (64, 6, 4, "edge", True, 2, True), (121, 4, 2, "scalar", True, 3, True),
              (121, 3, 0, "edge", False, 1, False)]


@pytest.mark.parametrize("members,T,L,sharing,per_it,parts,negative", WIDE_CASES)
def test_wide_model_matches_plain(members, T, L, sharing, per_it, parts, negative):
    """The model on the 64-bit and 128-bit state words at rows of 28 to 121
    members (Z=4), noise at 1 dB: c2v after every iteration and bits equal
    the plain version's, sign bits too."""
    qc = _row_code(members)
    assert qc.dr_max == members
    dec = _decoder(qc, T, L, sharing, per_it, seed=members + L, negative=negative)
    assert dec.word_bits == (64 if members <= 58 else 128)
    assert dec.route == fn.GROUP_ROUTES[dec.word_bits]
    llr = torch.from_numpy(bpsk_llrs(qc.num_vars, 4, 1.0, seed=members))
    assert_model_is_plain(dec, llr, parts)


# Depths over 4, on the run-time-depth form: (code, Z, batch, depth,
# sharing, per_iteration, parts, negative), T = depth + 2 so that every tap
# reaches the decisions.
DEEP_CASES = [("toy_4x8", 4, 5, 5, "edge", True, 2, True),
              ("toy_4x8", 4, 5, 6, "cell", False, 3, False),
              ("nr_2_0_4", 4, 4, 8, "edge", True, 5, True),
              ("nr_2_0_32", 24, 2, 5, "type", True, 6, False),
              ("row31", 4, 3, 6, "edge", True, 2, True),
              ("row64", 4, 3, 8, "edge", True, 3, False)]


@pytest.mark.parametrize("name,Z,batch,L,sharing,per_it,parts,negative", DEEP_CASES)
def test_deep_model_matches_plain(name, Z, batch, L, sharing, per_it, parts, negative):
    """Depths 5, 6 and 8 with their FIFO offsets stepped as the run-time
    form steps them, on each state word; Z=24 takes the non-power-of-two
    roll."""
    qc = _row_code(int(name[3:])) if name.startswith("row") else _qc(name, Z)
    dec = _decoder(qc, L + 2, L, sharing, per_it, seed=Z + L, negative=negative)
    assert dec.run_time_depth and dec.route == fn.GROUP_ROUTES[dec.word_bits]
    llr = torch.from_numpy(bpsk_llrs(qc.num_vars, batch, 1.0, seed=L))
    assert_model_is_plain(dec, llr, parts)


@pytest.mark.parametrize("layout", [1, 2])
@pytest.mark.parametrize("name,L,parts,slices", [("row31", 2, 2, 2), ("row64", 3, 3, 2),
                                                 ("row121", 5, 2, 2), ("nr_2_0_4", 6, 3, 3)])
def test_wide_and_deep_slice_model_matches_plain(name, L, parts, slices, layout):
    """The slice forms on the wider words (form 2 keeps 2 or 4 words an
    entry of W in the slice, lo limb first) and at depth 5 and 6, in a
    NaN-filled scratch of fewer slices than frames."""
    qc = _row_code(int(name[3:])) if name.startswith("row") else _qc(name, 4)
    dec = _decoder(qc, L + 2, L, "edge", True, seed=L + layout, negative=layout == 2)
    llr = torch.from_numpy(bpsk_llrs(qc.num_vars, 5, 1.0, seed=L))
    assert_model_is_plain(dec, llr, parts, slices, layout)


@pytest.mark.parametrize("kind", ["ties", "zeros"])
@pytest.mark.parametrize("members,L,parts", [(31, 2, 2), (64, 6, 3), (121, 2, 2)])
def test_wide_model_on_ties_and_zeros(members, L, parts, kind):
    """Tied magnitudes (quantised to odd integers, with negative offsets)
    and LLRs of +0.0 and -0.0 (with positive offsets, so that many c2v are
    +-0.0, of both signs, which the model must reproduce bit for bit) on the
    wider words and at depth 6."""
    qc = _row_code(members)
    dec = _decoder(qc, L + 2, L, "edge", True, seed=members, negative=kind == "ties")
    llr = hard_llrs(kind, qc.num_vars, seed=members)[:6]
    if kind == "ties":
        llr = np.floor(llr / 2.0) * 2.0 + 1.0
    llr = torch.from_numpy(llr.astype(np.float32))
    if kind == "zeros":
        want = []
        _plain(dec, llr, want)
        c2v = torch.stack(want)
        assert ((c2v == 0) & torch.signbit(c2v)).any() and ((c2v == 0) & ~torch.signbit(c2v)).any()
    assert_model_is_plain(dec, llr, parts)


def test_word_limbs():
    """The limb operations the model shares with the kernel: a push carries
    bit 63 of lo into hi, product_flips spans the limbs, the argmin sits in
    the top bits of the top limb, and the words round-trip through memory."""
    neg = torch.tensor([[-(1 << 63), 0]])  # bit 63 of lo
    pushed = _push_sign(neg, torch.tensor([-1.0]), 128)
    assert pushed.tolist() == [[1, 1]]
    flips = _product_flips(torch.tensor([[1, 0]]), 121, 128)
    assert flips.tolist() == [[-1, (1 << 57) - 1]]
    assert _product_flips(torch.tensor([[3, 0]]), 121, 128).tolist() == [[0, 0]]
    w = _state_word(torch.tensor([[5, 1]]), torch.tensor([100]), 128)
    assert _argmin_of(w, 128).tolist() == [100] and _bit(w, 64).tolist() == [1]
    assert _argmin_of(_state_word(torch.tensor([[7]]), torch.tensor([57]), 64), 64).tolist() == [57]
    for bits in (32, 64, 128):
        word = _state_word(_zeros((1, 3), bits) + 6, torch.tensor([[1, 2, 3]]), bits)
        assert torch.equal(_from_words(_to_words(word, bits), bits), word)


def test_zero_c2v_reach_only_sums_from_zero():
    """With alpha 0 every c2v is +-0.0: the bits are the LLRs' decisions,
    -0.0 LLRs decided as 0, in the plain version and the model alike."""
    qc = _qc("toy_4x8", 4)
    dec = _decoder(qc, 3, 2, "edge", True, seed=5)
    dec.tables.alpha = [0.0, -0.0, 0.0]
    dec.tables.params[:3] = torch.tensor(dec.tables.alpha)
    llr = torch.from_numpy(hard_llrs("zeros", qc.num_vars, seed=4)[:6])
    want = _plain(dec, llr, [])
    assert torch.equal(want, (llr < 0).to(torch.float32))
    assert torch.equal(kernel_model(dec, llr, 2), want)


# ---------------------------------------------------------------------------
# Plans, weights and routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L,frame", [(0, 29_440), (1, 54_656), (2, 79_872), (3, 105_088)])
def test_frame_bytes_at_nr_bg2_z32(L, frame):
    """4 (2 C*Z + 3 R*Z + L K*Z) bytes: LLRs, column sums, check state,
    FIFO."""
    qc = _qc("nr_2_0_32", 32)
    assert fn.neural_group_frame_bytes(qc, L) == frame
    structure = 4 * fm._retire_structure_words(qc, 16)
    assert fn.neural_group_smem_bytes(qc, L, 16, 2) == structure + 2 * frame
    assert fn.neural_group_smem_bytes(qc, L, 16, 2, staged=True) == structure + 2 * frame \
        + 2 * 25_216


def test_plans_at_nr_bg2_z32():
    """Depth 2: at most 2 frames a block, 2 of 16 parts with the staged
    weights (215,424 B); depth 0: 7 frames of at most 4 parts."""
    qc = _qc("nr_2_0_32", 32)
    assert max(f for _, f in fn.neural_group_plans(qc, 2)) == 2
    assert (16, 2) in fn.neural_group_plans(qc, 2, staged=True)
    assert fn.neural_group_smem_bytes(qc, 2, 16, 2, staged=True) == 215_424
    assert max(f for _, f in fn.neural_group_plans(qc, 0)) == 7
    assert max(p for p, f in fn.neural_group_plans(qc, 0) if f == 7) == 4
    assert all(p * f <= 32 for p, f in fn.neural_group_plans(qc, 1))


@pytest.mark.parametrize("Z,L,layout,frame,scratch", [(128, 2, 1, 91_136, 201_728),
                                                      (128, 2, 2, 69_632, 223_232),
                                                      (128, 4, 2, 69_632, 424_960),
                                                      (384, 2, 2, 208_896, 669_696),
                                                      (384, 0, 2, 208_896, 64_512)])
def test_slice_bytes_at_nr_bg2(Z, L, layout, frame, scratch):
    """The slice forms: 4 (3 R*Z + C*Z) bytes of shared memory a frame (A,
    column sums, W) and 4 L K*Z bytes of scratch (FIFO) in form 1; 4 (2 R*Z
    + C*Z) and 4 (R*Z + L K*Z) in form 2 (W in the slice); the whole frame,
    4 (2 C*Z + 3 R*Z + L K*Z) bytes, exceeds a block."""
    qc = _qc("nr_2_0_32", Z)
    assert fn.neural_group_frame_bytes(qc, L, layout) == frame
    assert fn.neural_group_scratch_bytes(qc, L, layout) == scratch
    assert fn.neural_group_frame_bytes(qc, L) == 4 * (2 * 52 * Z + 3 * 42 * Z + L * 197 * Z)
    assert fn.neural_group_frame_bytes(qc, L) > fm._SMEM_BUDGET
    structure = 4 * fm._retire_structure_words(qc, 2)
    assert fn.neural_group_smem_bytes(qc, L, 2, 1, slice=layout) == structure + frame
    with pytest.raises(ValueError, match="slice form"):
        fn.neural_group_smem_bytes(qc, L, 2, 1, staged=True, slice=layout)


def test_slice_plans_at_nr_bg2():
    """No plan holds a whole frame at Z=128 (depth 2) or Z=384.  At Z=128
    form 1 takes up to 2 frames a block, form 2 up to 3 of 2 parts (24
    warps, 214,032 B); at Z=384 only form 2, one frame of at most 2 parts
    (24 warps); never with the weights staged.  Z=32 at depth 4: one whole
    frame a block (130,304 B)."""
    z128, z384, z32 = (_qc("nr_2_0_32", Z) for Z in (128, 384, 32))
    for qc in (z128, z384):
        assert not fn.neural_group_plans(qc, 2)
        assert not fn.neural_group_plans(qc, 2, staged=True, slice=2)
        assert fn.neural_group_fits(qc, 2) and fn.neural_group_fits(qc, 4)
    assert max(f for _, f in fn.neural_group_plans(z128, 2, slice=1)) == 2
    plans = fn.neural_group_plans(z128, 2, slice=2)
    assert max(f for _, f in plans) == 3 and max(p for p, f in plans if f == 3) == 2
    assert fn.neural_group_smem_bytes(z128, 2, 2, 3, slice=2) == 214_032
    assert not fn.neural_group_plans(z384, 4, slice=1)
    assert fn.neural_group_plans(z384, 4, slice=2) == [(1, 1), (2, 1)]
    assert fn.neural_group_smem_bytes(z384, 4, 2, 1, slice=2) == 214_032
    assert [fn.neural_group_layout(qc, L) for qc, L in
            ((z32, 2), (z32, 4), (z128, 2), (z128, 4), (z384, 0), (z384, 4))] == [0, 0, 1, 1, 2, 2]
    assert fn.neural_group_frame_bytes(z32, 4) == 130_304
    assert max(f for _, f in fn.neural_group_plans(z32, 4)) == 1
    assert max(f for p, f in fn.neural_group_plans(z32, 4, slice=2) if p == 2) == 12


def _ieee_shape():
    """chip_smoke.py's wide_rows code: (6, 32) at Z=64, shift (r*c) mod 64."""
    r, c = np.meshgrid(np.arange(6), np.arange(32), indexing="ij")
    return tcodes.qc_layout(tcodes.BaseGraph("ieee", (r * c) % 64), 64)


def _array_code(p: int, cols: int):
    """J. L. Fan's array code (chip_smoke.py's array_code), 4 rows."""
    r, c = np.meshgrid(np.arange(4), np.arange(cols), indexing="ij")
    return tcodes.qc_layout(tcodes.BaseGraph(f"array_p{p}", (r * c) % p), p)


@pytest.mark.parametrize("code,bits,frame,form1,form2,scratch1,scratch2", [
    ("ieee", 64, 120_832, 14_336, 11_264, 98_304, 101_376),
    ("array67", 128, 177_952, 23_584, 19_296, 137_216, 141_504),
    ("array61", 128, 154_704, 20_752, 16_848, 119_072, 122_976)])
def test_wide_frame_and_slice_bytes(code, bits, frame, form1, form2, scratch1, scratch2):
    """Depth 2 on the wider words: 4 (2 C*Z + (2 + bits/32) R*Z + 2 K*Z)
    bytes a whole frame; in the slice forms A, the column sums padded to an
    even count (C*Z = 3721 at p = 61) and in form 1 W (2 or 4 words a
    check); the slices hold the FIFO and in form 2 W.  wide_rows' frame
    fits a block with its two staged weight planes (223,968 B of 231,424)."""
    qc = {"ieee": _ieee_shape, "array67": lambda: _array_code(67, 64),
          "array61": lambda: _array_code(61, 61)}[code]()
    assert fn.neural_group_word_bits(qc) == bits
    got = (fn.neural_group_frame_bytes(qc, 2), fn.neural_group_frame_bytes(qc, 2, 1),
           fn.neural_group_frame_bytes(qc, 2, 2), fn.neural_group_scratch_bytes(qc, 2, 1),
           fn.neural_group_scratch_bytes(qc, 2, 2))
    assert got == (frame, form1, form2, scratch1, scratch2)
    Z, R, C, K = qc.Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges
    assert frame == 4 * -(-(2 * C * Z + (2 + bits // 32) * R * Z + 2 * K * Z) // 4) * 4
    if code == "ieee":
        assert fn.neural_group_smem_bytes(qc, 2, 6, 1, staged=True) == 223_968
        assert fn.neural_group_layout(qc, 2) == 0 and (6, 1) in fn.neural_group_plans(qc, 2, True)


@pytest.mark.parametrize("L,layout,frame", [(5, 0, 155_520), (6, 0, 180_736), (8, 1, 22_784),
                                            (12, 1, 22_784)])
def test_deep_frame_bytes_at_nr_bg2_z32(L, layout, frame):
    """Depths over 4 at NR BG2 Z=32: a whole frame a block up to depth 7
    (180,736 B at depth 6), then the FIFO in the slices (form 1, whose
    shared memory does not grow with the depth)."""
    qc = _qc("nr_2_0_32", 32)
    assert fn.neural_group_layout(qc, L) == layout
    assert fn.neural_group_frame_bytes(qc, L, layout) == frame
    assert fn.neural_group_scratch_bytes(qc, L, 1) == 4 * L * 6304
    assert max(f for _, f in fn.neural_group_plans(qc, L, slice=layout)) >= 1


def test_depth_limit():
    """neural_group takes any depth whose FIFO offsets stay 32-bit ((L + 1)
    K*Z < 2^30 words); fused_neural what lies beyond."""
    qc = _qc("nr_2_0_32", 384)
    KZ = qc.num_base_edges * 384
    deepest = (1 << 30) // KZ - 1
    assert (deepest + 1) * KZ < 1 << 30 <= (deepest + 2) * KZ
    assert fn.neural_group_fits(qc, deepest) and fn.neural_group_route(qc, deepest) == "neural_group"
    assert not fn.neural_group_fits(qc, deepest + 1)
    assert fn.neural_group_route(qc, deepest + 1) == "fused_neural"


class _OccupancyModel:
    """Stands in for the kernel library's occupancy query: resident blocks
    an SM limited by 2048 threads, 65,536 registers at 64 a thread (the
    kernels' launch bound of 1024 threads) and 233,472 bytes of shared
    memory (1 KB of it kept back a block)."""

    def __init__(self, qc):
        self.qc = qc

    def ldpc_neural_group_occupancy(self, Z, R, C, K, L, p, f, staged, slice, word_bits=32):
        threads = fm.retire_threads(self.qc, p, f)
        smem = fn.neural_group_smem_bytes(self.qc, L, p, f, bool(staged), slice)
        return min(2048 // threads, 65536 // (64 * threads), 233_472 // (smem + 1024))


@pytest.mark.parametrize("Z,L,staged,layout,parts,plan", [
    (32, 2, True, 0, None, (14, 2, 1)), (32, 2, False, 0, None, (14, 1, 2)),
    (4, 2, True, 0, None, (14, 1, 2)), (32, 4, True, 0, None, (32, 1, 1)),
    (128, 2, False, 1, None, (8, 1, 1)), (128, 2, False, 2, None, (8, 1, 1)),
    (384, 2, False, 2, None, (2, 1, 1)), (128, 2, False, 1, 3, (3, 1, 2)),
    (32, 4, False, 1, None, (10, 1, 3))])
def test_plan_rule(Z, L, staged, layout, parts, plan):
    """On a stand-in occupancy query of the H100 (132 SMs, 50 MB of L2):
    nms_main's plan stays two groups of 14 parts; a group alone on its SM
    takes the most parts (32 at Z=32 depth 4, 8 of 4 warps at Z=128, 2 of 12
    at Z=384); at Z=128 two groups an SM would put 53 MB of slices in
    flight, so one; with ``parts`` given the slices' size gives way; at
    Z=32 depth 4 in form 1 three groups' 39.9 MB fit."""
    qc = _qc("nr_2_0_4" if Z == 4 else "nr_2_0_32", Z)
    assert fn.neural_group_plan(qc, L, staged, parts, _OccupancyModel(qc), layout, sms=132,
                                l2_bytes=50 * 2**20) == plan


@pytest.mark.parametrize("name,Z", [("nr_2_0_4", 4), ("nr_2_0_32", 12), ("nr_2_0_32", 24),
                                    ("nr_2_0_32", 32), ("nr_2_0_32", 64)])
def test_plan_rule_keeps_shared_plans(name, Z):
    """Where a whole frame fits, the plan is the one of the rule before the
    slice forms (the most resident groups of at most 14 warps, then the
    most parts, then the fewest groups a block) whenever that rule keeps two
    groups or more an SM; where it keeps one, the group takes the most parts
    a block holds."""
    qc = _qc(name, Z)
    lib, zw = _OccupancyModel(qc), -(-Z // 32)
    for L in range(5):
        for staged in (False, True):
            plans = fn.neural_group_plans(qc, L, staged)
            if not plans:
                continue
            old = max(((lib.ldpc_neural_group_occupancy(Z, 0, 0, 0, L, p, f, staged, 0) * f, p,
                        -f), (p, f)) for p, f in plans if p * zw <= 14)
            got = fn.neural_group_plan(qc, L, staged, None, lib, sms=132, l2_bytes=50 * 2**20)
            if old[0][0] > 1:
                assert got[:2] == old[1], (L, staged)
            else:
                assert got[0] == max(p for p, _ in plans), (L, staged)


@pytest.mark.parametrize("name,Z,L,route", [
    ("nr_2_0_32", 32, 2, "neural_group"), ("nr_2_0_32", 32, 0, "neural_group"),
    ("nr_2_0_4", 4, 3, "neural_group"), ("nr_2_0_32", 64, 2, "neural_group"),
    ("nr_2_0_32", 128, 2, "neural_group"), ("nr_2_0_32", 32, 4, "neural_group"),
    ("nr_2_0_32", 384, 4, "neural_group"), ("nr_2_0_4", 4, 5, "neural_group"),
    ("nr_2_0_32", 32, 6, "neural_group"), ("nr_2_0_32", 384, 8, "neural_group"),
    ("row27", 4, 2, "neural_group"), ("row28", 4, 2, "neural_group_wide"),
    ("row31", 4, 2, "neural_group_wide"), ("row58", 4, 5, "neural_group_wide"),
    ("row59", 4, 2, "neural_group_w128"), ("row121", 4, 6, "neural_group_w128"),
    ("row122", 4, 2, "fused_neural")])
def test_routes(name, Z, L, route):
    """Z=128 at depth 2 (319,488 B a frame), Z=384 and depth 4 on
    neural_group (the slice form where a frame does not fit a block); depth
    5 and more on its run-time-depth form; rows of 28 to 58 members on the
    64-bit state word (neural_group_wide), 59 to 121 on the 128-bit one
    (neural_group_w128), a row of 122 (over the widest word's 121 signs) on
    fused_neural; CPU tensors reach no kernel."""
    qc = _row_code(int(name[3:])) if name.startswith("row") else _qc(name, Z)
    assert fn.neural_group_fits(qc, L) == (route != "fused_neural")
    assert fn.neural_group_route(qc, L) == route
    dec = _decoder(qc, 2, L, "scalar", False, seed=1)
    assert dec.route == route and dec.run_time_depth == (L > 4)
    if route != "fused_neural":
        assert fn.GROUP_ROUTES[dec.word_bits] == route
        assert dec.layout == (0 if Z < 128 else 1 if Z == 128 else 2)
    launches = dict(fn.LAUNCHES)
    dec(torch.zeros((1, qc.num_vars)))
    assert fn.LAUNCHES == launches


@pytest.mark.parametrize("per_it", [False, True])
def test_check_aligned_weights(per_it):
    """wc[t, i*Z + z] is the weight of the edge at row-order position i and
    check lane z: w[t, k*Z + (z + shift[k]) mod Z]; planes padded to 16
    bytes with zeros."""
    qc = _qc("nr_2_0_32", 24)
    dec = _decoder(qc, 3, 2, "edge", per_it, seed=2)
    st, Z, K = dec.st, qc.Z, qc.num_base_edges
    w, wc = dec.tables.w, dec.tables.wc
    assert wc.shape == (w.shape[0], -(-K * Z // 4) * 4) and w.shape[0] == (3 if per_it else 1)
    i = 0
    for members in st.row_members:
        for k in members:
            for z in range(Z):
                assert torch.equal(wc[:, i * Z + z], w[:, k * Z + (z + st.shifts[k]) % Z])
            i += 1
    assert not wc[:, K * Z:].any()
