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

SIGN_BITS = 27
NO_MEMBER = 31


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: the suite's workers run side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qc(name: str, Z: int):
    return tcodes.qc_layout(tcodes.get_base_graph(name), Z)


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


def _unpack(st, parts: int):
    """The wrapper's structure of ``parts`` parts: column members (r*Z,
    shift, j << 27, 31 - j), row members (col*Z, shift), row_ptr, col_ptr,
    first row and first column of each part."""
    K, R, C = st.K, st.R, st.C
    g = fm._retire_structure(st, parts).view(np.uint32).astype(np.int64)
    col_mem = g[:4 * K].reshape(K, 4)
    row_mem = g[4 * K:6 * K].reshape(K, 2)
    o = 6 * K
    row_ptr, col_ptr = g[o:o + R + 1], g[o + R + 1:o + R + C + 2]
    o += R + C + 2
    return col_mem, row_mem, row_ptr, col_ptr, g[o:o + parts + 1], g[o + parts + 1:]


def _flip(v: torch.Tensor, bit: torch.Tensor) -> torch.Tensor:
    """v with its sign bit flipped where ``bit`` is 1 (flip_if)."""
    return torch.where(bit.bool(), -v, v)


def _c2v_of(a: torch.Tensor, w: torch.Tensor, j: int) -> torch.Tensor:
    """Member j's c2v from its check's state (a (..., 2), w int64 words)."""
    v = torch.where((w >> SIGN_BITS) == j, a[..., 1], a[..., 0])
    return _flip(v, (w >> j) & 1)


def kernel_model(dec, llr: torch.Tensor, parts: int, record: list | None = None,
                 slices: int = 0, layout: int = 2):
    """csrc/fused_neural.cu's neural_group algorithm on (frame, lane) tensors,
    on the decoder's own tables: check pass p of each part's rows (pass 0
    folds LLR + 0.0; later passes rebuild each member's v2c as ((cs - c2v) +
    w * llr) + live * taps, store it in the FIFO ring slot p mod L and fold
    it, members last first), then the column pass of each part's columns
    (c2v expanded from the state, summed from +0.0); bits from the last.
    ``record`` receives c2v, var-aligned (B, K*Z), after every check pass.

    ``slices`` > 0: slice form ``layout`` (1 or 2).  Each frame's FIFO and
    (form 2) state words live in one of ``slices`` slices of a flat int32
    scratch laid out as the kernel's (form 2: W at word r*Z + z, then FIFO
    plane l at R*Z + l*K*Z; form 1: plane l at l*K*Z; the edge at row-order
    position i and check lane z at i*Z + z), filled with NaN once and never
    cleared; frames take the slices ``slices`` at a time, as a block's frame
    groups take them, so a read before the frame's own write would reach
    an earlier frame's state or a NaN."""
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
    col_mem, row_mem, row_ptr, col_ptr, row_part, col_part = _unpack(st, parts)
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
    w_words = R * Z if layout == 2 else 0  # W's words in the slice
    W = torch.zeros((B, R * Z), dtype=torch.int64)
    if scratch is None:
        fifo = torch.zeros((B, L * KZ))
    else:
        fifo = scratch[:, w_words:w_words + L * KZ].view(torch.float32)  # writes land there
    if w_words:
        W = scratch[:, :w_words].long() & 0xFFFFFFFF  # whatever the slice holds
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
                arg = torch.full((B, Z), NO_MEMBER, dtype=torch.int64)
                neg = torch.zeros((B, Z), dtype=torch.int64)
                for j in reversed(range(d)):
                    col_z, shift = row_mem[j0 + j]
                    v = rolled(int(shift), int(col_z))
                    if p == 0:
                        x = llr[:, v] + 0.0
                    else:
                        e = (j0 + j) * Z + z
                        x = (cs[:, v] - _c2v_of(a_old, w_old, j)) + w_plane[e] * llr[:, v]
                        if L:
                            res = torch.zeros((B, Z))
                            for l in range(taps):
                                res = res + w_res[t * S + l] * fifo[:, ((t - l) % L) * KZ + e]
                            x = x + live * res
                            fifo[:, (p % L) * KZ + e] = x
                    mag = x.abs()
                    neg = (neg << 1) | torch.signbit(x).long()
                    arg = torch.where(mag <= m1, j, arg)
                    m2 = torch.minimum(torch.maximum(mag, m1), m2)
                    m1 = torch.minimum(mag, m1)
                sp = torch.where(_popcount(neg) % 2 == 1, (1 << d) - 1, 0)
                m1z = torch.where(m1 < _BIG, m1, 0.0)
                m2z = torch.where(m2 < _BIG, m2, 0.0)
                A_new[:, q, 0] = alpha[p] * torch.clamp(m1z - offset[p], min=0.0)
                A_new[:, q, 1] = alpha[p] * torch.clamp(m2z - offset[p], min=0.0)
                W_new[:, q] = (neg ^ sp) | (arg << SIGN_BITS)
        A, W = A_new, W_new  # the barrier between the passes
        if w_words:  # the new words, as uint32 bits, into the slice
            scratch[:, :w_words] = (W - ((W >> 31) << 32)).to(torch.int32)
            W = scratch[:, :w_words].long() & 0xFFFFFFFF
        if record is not None:
            record.append(_expand(st, row_mem, row_ptr, A, W))
        cs_new = torch.zeros_like(cs)
        for part in range(parts):
            for c in range(col_part[part], col_part[part + 1]):
                acc = torch.zeros((B, Z))
                for i in range(int(col_ptr[c]), int(col_ptr[c + 1])):
                    r_z, shift, jz, jw = col_mem[i]
                    q = rolled(Z - int(shift), int(r_z))
                    a, w = A[:, q], W[:, q]
                    v = torch.where(((w ^ int(jz)) & 0xF8000000) == 0, a[..., 1], a[..., 0])
                    acc = acc + _flip(v, (w >> (31 - int(jw))) & 1)
                cs_new[:, c * Z + z] = acc
        cs = cs_new
    return ((llr + cs) < 0).to(torch.float32)


def _popcount(x: torch.Tensor) -> torch.Tensor:
    count = torch.zeros_like(x)
    for b in range(SIGN_BITS):
        count += (x >> b) & 1
    return count


def _expand(st, row_mem, row_ptr, A, W) -> torch.Tensor:
    """Every lifted edge's c2v from the check states, var-aligned (B, K*Z)
    as the plain version keeps it: base edge k's variable lane v is check
    lane (v - shift) mod Z."""
    Z = st.Z
    out = torch.zeros((A.shape[0], st.K * Z))
    v = torch.arange(Z)
    for r, members in enumerate(st.row_members):
        for j, k in enumerate(members):
            zc = (v - st.shifts[k]) % Z
            out[:, k * Z + v] = _c2v_of(A[:, r * Z + zc], W[:, r * Z + zc], j)
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


class _OccupancyModel:
    """Stands in for the kernel library's occupancy query: resident blocks
    an SM limited by 2048 threads, 65,536 registers at 64 a thread (the
    kernels' launch bound of 1024 threads) and 233,472 bytes of shared
    memory (1 KB of it kept back a block)."""

    def __init__(self, qc):
        self.qc = qc

    def ldpc_neural_group_occupancy(self, Z, R, C, K, L, p, f, staged, slice):
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


def _row_code(members: int, Z: int = 4):
    """A (4, 32) base graph whose first row has ``members`` members; every
    column has one."""
    rng = np.random.default_rng(members)
    shifts = np.where(rng.random((4, 32)) < 0.3, rng.integers(0, Z, (4, 32)), -1)
    shifts[0] = np.where(np.arange(32) < members, rng.integers(0, Z, 32), -1)
    shifts[1, members:] = 0
    return tcodes.qc_layout(tcodes.BaseGraph(f"row{members}", shifts), Z)


@pytest.mark.parametrize("name,Z,L,route", [
    ("nr_2_0_32", 32, 2, "neural_group"), ("nr_2_0_32", 32, 0, "neural_group"),
    ("nr_2_0_4", 4, 3, "neural_group"), ("nr_2_0_32", 64, 2, "neural_group"),
    ("nr_2_0_32", 128, 2, "neural_group"), ("nr_2_0_32", 32, 4, "neural_group"),
    ("nr_2_0_32", 384, 4, "neural_group"), ("nr_2_0_4", 4, 5, "fused_neural"),
    ("row31", 4, 2, "fused_neural")])
def test_routes(name, Z, L, route):
    """Z=128 at depth 2 (319,488 B a frame), Z=384 and depth 4 on
    neural_group (the slice form where a frame does not fit a block); depth
    5 and a row of 31 members (over the state word's 27 signs) on
    fused_neural; CPU tensors reach neither kernel."""
    qc = _row_code(31) if name == "row31" else _qc(name, Z)
    assert fn.neural_group_fits(qc, L) == (route == "neural_group")
    dec = _decoder(qc, 2, L, "scalar", False, seed=1)
    assert dec.route == route
    if route == "neural_group":
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
