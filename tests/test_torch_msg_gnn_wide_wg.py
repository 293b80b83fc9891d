"""B7 and B9 at hidden width 128 on warpgroup tiles (csrc/fused_msg_gnn_tc.cu
``msg_gnn_wide_tc_kernel``): the order, layouts and ring of the kernel, on
the CPU, without JAX.

* ``wg_model``: the kernel's order of sums on the CPU.  Per 64-message
  warpgroup tile and 16-unit weight chunk, as the wrapper packs it, the
  first layer is three products, each one accumulation (f . [W1vf; W1cf]^T
  + lf . [W1vl; W1cl]^T, vmean . W1va^T, rmean . W1ca^T), added with b1;
  relu and bf16 give h1, whose terms of the second
  layer go into one accumulator over all chunks (B9's last layer: proj8 . f
  first, then the thin products chunk by chunk).  Every sum it takes is
  checked exact in any order, value by value, with a conservative bound
  (per output, the magnitudes of its terms add up to less than 2**24 times
  the product of the least quantum of its row of inputs and the least
  quantum of its row of weights), so on the exact inputs of
  ``ops/msg_gnn_exact.py`` it must give the plain version's soft bits
  exactly: ``tests/test_torch_msg_gnn_wide.py`` holds it there on
  ``EXACT_WIDE_CASES``.
* The core-matrix order the kernel's ``cm`` and its ``wgmma`` descriptors
  read, the chunk's matrices and their offsets, the shared memory of the
  block with fixed byte counts, and the chunk ring's barrier phases under
  many interleavings of its warpgroups.
"""
import random

import pytest
import torch

from test_torch_msg_gnn_tc import _exact_sum, _graph, _member_sums, _quanta, _r

from ldpc_tpu_torch.codes import get_base_graph, qc_layout
from ldpc_tpu_torch.models import create_message_gnn_decoder
from ldpc_tpu_torch.ops import fused_gnn as fg, qc_msg

H = 128
CH = fg.WIDE_CHUNK
ROWS = fg.WIDE_ROWS


def cm(n: int, k: int, K: int) -> int:
    """The kernel's ``cm``: offset of entry (n, k) of an n x K matrix in
    core-matrix order."""
    return ((n >> 3) * (K >> 3) + (k >> 3)) * 64 + (n & 7) * 8 + (k & 7)


def from_core_matrix_order(x: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """The inverse of ``fg.core_matrix_order``: (..., n k) -> (..., n, k)."""
    lead = x.shape[:-1]
    return x.reshape(*lead, n // 8, k // 8, 8, 8).transpose(-3, -2).reshape(*lead, n, k)


def unpack_wg_chunks(packed: torch.Tensor, h: int, inject: bool) -> list:
    """The streamed layout (T, layer) -> per chunk {name: (T, rows, cols)
    float32} of ``fg.tc_chunk_matrices``."""
    T = packed.shape[0]
    per = fg.tc_chunk_elems(h, inject)
    assert packed.shape == (T, h // CH * per)
    p = packed.to(torch.float32).reshape(T, h // CH, per)
    out = []
    for c in range(h // CH):
        o, chunk = 0, {}
        for name, rows, cols in fg.tc_chunk_matrices(h, inject):
            chunk[name] = from_core_matrix_order(p[:, c, o:o + rows * cols], rows, cols)
            o += rows * cols
        out.append(chunk)
    return out


def _least_quanta(x: torch.Tensor) -> torch.Tensor:
    """Per row of x (..., k), the least quantum of its nonzero values (inf
    where all are 0)."""
    return _quanta(x).amin(dim=-1)


def _acc(pairs, init: torch.Tensor | None = None) -> torch.Tensor:
    """init + the sum of a @ w^T over (a, w, least quanta of a's rows) in
    ``pairs`` as one float32 accumulation, after checking it exact in any
    order: per output, the magnitudes of every product and of init add up to
    less than 2**24 times a lower bound of the least quantum among them (each
    product's quantum is at least its input row's least quantum times its
    weight row's)."""
    shape = pairs[0][0].shape[:-1] + (pairs[0][1].shape[0],)
    bound = torch.zeros(shape, dtype=torch.float64)
    q = torch.full(shape, torch.inf, dtype=torch.float64)
    acc = torch.zeros(shape)
    for a, w, qa in pairs:
        bound = bound + a.double().abs() @ w.double().abs().t()
        q = torch.minimum(q, qa[..., None] * _least_quanta(w))
        acc = acc + a @ w.t()
    if init is not None:
        init = init.expand(shape)
        bound = bound + init.double().abs()
        q = torch.minimum(q, _quanta(init))
        acc = init + acc
    assert bool((bound < 2.0 ** 24 * q).all()), "a sum is not exact"
    return acc


def _add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _exact_sum(a, b)
    return a + b


def _first_sums(v4: bool, f, m, b):
    """The kernel's first_sums for one side (f: the f and lf product; pv: m
    = vmean's product, b = b1v; pc: rmean's, b1c), each addition checked
    exact: B7 (f + m) + b, B9 f + (m + b)."""
    return _add(f, _add(m, b)) if v4 else _add(_add(f, m), b)


def wg_model(dec, llr: torch.Tensor) -> torch.Tensor:
    """B7 (``msg_gnn_v2``) or B9 (``msg_gnn_v4``) at h=128 as the kernel
    computes it, on the CPU: per 64-message tile and layer, each chunk's
    three first-layer products (one accumulation each, lf's inside f's)
    added with b1 (B7's per edge, B9's per layer), relu, bf16, and their
    second-layer terms into one accumulator over all chunks, plus b2 (B9: the
    delta, then the residual); B9's last layer proj8 . f and w2last . [h1v;
    h1c] chunk by chunk in one accumulation, summed per variable with dsc in
    member order."""
    qc, h, T, inject = dec.qc, dec.hidden_dim, dec.num_iterations, dec.input_injection
    tb, v4 = dec.tables, dec.kind == "msg_gnn_v4"
    Z, K, C = qc.Z, qc.num_base_edges, qc.num_base_cols
    E, n = K * Z, C * Z
    row_ptr, row_edge, col_ptr, col_edge, shift, col, row = _graph(dec)
    chunks = unpack_wg_chunks(tb.w_bf16, h, inject)
    emb_w, emb_b, proj_w, proj_b = tb.emb[:h], tb.emb[h:2 * h], tb.emb[2 * h:3 * h], tb.emb[3 * h]
    inv_dc, inv_dr = tb.inv[:C], tb.inv[C:]
    B = llr.shape[0]

    i = torch.arange(E)
    k = i // Z
    z = i - k * Z
    vrow = col[k] * Z + z
    crow = row[k] * Z + (z - shift[k]) % Z
    lf = _r(llr[:, vrow, None] * emb_w + emb_b)  # (B, E, h)
    f = _r((llr[:, vrow, None] * emb_w + emb_b) + tb.tab[0][k]) if v4 else lf
    ntiles = -(-E // ROWS)
    pad = ntiles * ROWS - E

    def tiles(x):  # (B, E, w) -> (B, tiles, 64, w), rows past E zero
        return torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(B, ntiles, ROWS, -1)

    def untile(x):
        return x.reshape(B, ntiles * ROWS, -1)[:, :E]

    LF = tiles(lf)
    qLF = _least_quanta(LF)
    for t in range(T):
        vsum = _member_sums(f, col_ptr, lambda j, zs: col_edge[j] * Z + zs, Z)
        rsum = _member_sums(f, row_ptr, lambda j, zs: row_edge[j] * Z + (zs + shift[row_edge[j]])
                            % Z, Z)
        vmean = _r(vsum * inv_dc.repeat_interleave(Z)[:, None])
        rmean = _r(rsum * inv_dr.repeat_interleave(Z)[:, None])
        F, VM, RM = tiles(f), tiles(vmean[:, vrow]), tiles(rmean[:, crow])
        qF, qVM, qRM = _least_quanta(F), _least_quanta(VM), _least_quanta(RM)
        if v4:  # per layer
            b1v, b1c = tb.small[t, :h], tb.small[t, h:2 * h]
        else:  # (2, K, h), per edge
            b1v, b1c = (tiles(tb.tab[t][side][k].expand(B, E, h)) for side in (0, 1))
        last = v4 and t == T - 1
        pairs = [(F, proj_w[None], qF)] if last and t >= 1 else []
        for c, w in enumerate(chunks):
            units = slice(c * CH, (c + 1) * CH)
            pf = _acc([(F, w["W1f"][t], qF)] + ([(LF, w["W1l"][t], qLF)] if inject else []))
            pm = _acc([(VM, w["W1va"][t], qVM)])
            pr = _acc([(RM, w["W1ca"][t], qRM)])
            pv = _first_sums(v4, pf[..., :CH], pm, b1v[..., units])
            pc = _first_sums(v4, pf[..., CH:], pr, b1c[..., units])
            h1 = [(x, _least_quanta(x)) for x in (_r(torch.relu(pv)), _r(torch.relu(pc)))]
            if last:
                w2last = tb.extra[:2 * h]
                pairs += [(x, w2last[None, side * h + c * CH:side * h + (c + 1) * CH], q)
                          for side, (x, q) in enumerate(h1)]
            else:
                pairs += [(x, w["W2"][t][:, side * CH:(side + 1) * CH], q)
                          for side, (x, q) in enumerate(h1)]
        if last:
            s = untile(_acc(pairs))[..., 0]
            break
        out, b2 = _acc(pairs), tb.small[t, 2 * h:3 * h] if v4 else tb.small[t, :h]
        _exact_sum(out, b2)
        new = untile(_r(out + b2))
        if v4:
            d = _r(tb.tab[t + 1][k])
            new = _r(new + d) if t == 0 else _r(_r(new + d) + f)
        elif t >= 1:
            _exact_sum(new, f)
            new = _r(new + f)
        f = new

    if v4:  # dsc is float32, not dyadic: summed in the plain version's order
        terms, adds = s, tb.extra[2 * h:]
    else:
        terms, adds = _acc([(f, proj_w[None], _least_quanta(f))])[..., 0], proj_b.expand(K)
    acc = torch.zeros((B, n))
    for cc in range(C):
        for j in range(int(col_ptr[cc]), int(col_ptr[cc + 1])):
            rows = col_edge[j] * Z + torch.arange(Z)
            sl = slice(cc * Z, (cc + 1) * Z)
            if not v4:
                _exact_sum(acc[:, sl], terms[:, rows], adds[col_edge[j]])
            acc[:, sl] = (acc[:, sl] + terms[:, rows]) + adds[col_edge[j]]
    return 1.0 / (1.0 + torch.exp(llr + acc))


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,K", [(32, 128), (16, 128), (128, 32)])
def test_core_matrix_order_is_the_kernels_cm(n, K):
    """Entry (r, k) of a packed matrix sits at the kernel's cm(r, k, K), and
    the order inverts."""
    m = torch.arange(2 * n * K, dtype=torch.float32).reshape(2, n, K)
    x = fg.core_matrix_order(m)
    assert x.shape == (2, n * K)
    offsets = torch.tensor([[cm(r, c, K) for c in range(K)] for r in range(n)])
    assert torch.equal(x[:, offsets], m)
    assert torch.equal(from_core_matrix_order(x, n, K), m)


@pytest.mark.parametrize("K", [128, 32])
def test_wgmma_descriptor_reads_core_matrices(K):
    """The kernel's descriptors (wg_desc: start at k-tile kt's 256 bytes,
    128 bytes between the two 8-column blocks of a k-tile, K * 16 bytes
    between 8-row groups) address entry (r, 16 kt + c) of a core-matrix
    matrix at byte 2 cm(r, 16 kt + c, K): no swizzle, 8 rows of 16 bytes a
    block."""
    lbo, sbo = 128, K * 16
    for kt in range(K // 16):
        start = kt * 256
        for r in range(64):
            for c in range(16):
                byte = start + (r // 8) * sbo + (c // 8) * lbo + (r % 8) * 16 + (c % 8) * 2
                assert byte == 2 * cm(r, 16 * kt + c, K)


@pytest.mark.parametrize("inject", [False, True])
def test_chunk_matrix_offsets(inject):
    """The chunk's matrices where first_products and the second layer read
    them (elements): [W1vf; W1cf] at 0, W1va at 2 CH h, W1ca at 3 CH h,
    [W1vl; W1cl] at 4 CH h, [W2v W2c] at 6 CH h (4 CH h without
    injection); 32,768 bytes a chunk with injection, 24,576 without."""
    offsets, o = {}, 0
    for name, rows, cols in fg.tc_chunk_matrices(H, inject):
        offsets[name] = (o, rows, cols)
        o += rows * cols
    want = {"W1f": (0, 2 * CH, H), "W1va": (2 * CH * H, CH, H), "W1ca": (3 * CH * H, CH, H),
            "W2": ((6 if inject else 4) * CH * H, H, 2 * CH)}
    if inject:
        want["W1l"] = (4 * CH * H, 2 * CH, H)
    assert offsets == want
    assert 2 * fg.tc_chunk_elems(H, inject) == (32_768 if inject else 24_576)


# ---------------------------------------------------------------------------
# Shared memory and the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("code,Z,inject,want", [
    ("nr_2_0_4", 4, True, (205_040, 206_064)), ("nr_2_0_4", 4, False, (155_888, 156_912)),
    ("nr_2_0_32", 32, True, (210_864, 211_888)), ("nr_2_0_32", 32, False, (161_712, 162_736))])
def test_wide_smem_bytes(code, Z, inject, want):
    """One block of eight warps (two warpgroups): the state, the ring of two
    chunks, each warpgroup's tile buffer (f, vmean, rmean and with injection
    lf, 64 rows of 256 bytes each) and the ring's barriers and counts (32
    bytes); B7 then B9 (B9 stages 2h more floats of biases)."""
    qc = qc_layout(get_base_graph(code), Z)
    K, C, R = qc.num_base_edges, qc.num_base_cols, qc.num_base_rows
    assert fg.WIDE_WARPS == 8 and fg.WIDE_GROUPS == 2 and fg.WIDE_STAGES == 2
    for kind, small, bytes_ in zip(("msg_gnn_v2", "msg_gnn_v4"), (H, 3 * H), want):
        state = 4 * (-(-(6 * K + R + C + 2) // 4) * 4 + -(-(C + R) // 4) * 4 + C * Z + 388 + small)
        tile = (4 if inject else 3) * ROWS * H * 2
        assert fg.msg_gnn_smem_bytes(qc, H, kind, inject, fg.WIDE_WARPS) == bytes_ == \
            state + 2 * fg.tc_chunk_elems(H, inject) * 2 + 2 * tile + 32


def test_wide_builder_checks_the_block():
    """The h=128 builders check the whole block (eight warps) against a
    block's shared memory: nr_2_0_32 fits at Z=64; at Z=384 the frame's LLRs
    alone (80 KB) leave no room and the builder raises."""
    for Z, fits in ((64, True), (384, False)):
        qc = qc_layout(get_base_graph("nr_2_0_32"), Z)
        model = create_message_gnn_decoder(qc_msg.make_plan(qc, device="cpu"), num_iterations=1,
                                           hidden_dim=H, input_injection=True)
        for build in (fg.make_fused_gnn_decoder_v2, fg.make_fused_gnn_decoder_v4):
            if fits:
                build(qc, model, 1, H, input_injection=True, device="cpu")
            else:
                with pytest.raises(ValueError, match="weight chunk ring"):
                    build(qc, model, 1, H, input_injection=True, device="cpu")


# ---------------------------------------------------------------------------
# The chunk ring
# ---------------------------------------------------------------------------


def ring_run(tiles_per_layer, seed: int, stages: int = fg.WIDE_STAGES,
             groups: int = fg.WIDE_GROUPS, chunks: int = H // CH, offset: bool = True) -> int:
    """The ring of layer_wide under one random interleaving of its
    warpgroups: every warpgroup waits for step s's full barrier with the
    parity (seq + s) / stages & 1 (mbarrier.try_wait.parity passes once the
    barrier's completed phases have the other parity), reads the buffer, and
    counts its release; the warpgroup whose count completes a multiple of the
    warpgroups refills the buffer with step s + stages, whose bytes land at
    a random later move.  Thread 0 fills a layer's first steps; a block
    barrier ends each layer.  seq counts the steps of the layers before
    (``offset=False``: a broken ring that counts each layer's steps from 0).
    Returns the fills; raises if a wait passes before its chunk has landed,
    or no warpgroup can move."""
    rng = random.Random(seed)
    units = groups
    phases = [0] * stages    # completed phases of each full barrier
    data = [None] * stages   # the step whose chunk a buffer holds
    released = [0] * stages
    landing = []             # fills in flight: (stage, step)
    fills, seq = 0, 0
    for ntiles in tiles_per_layer:
        steps = -(-ntiles // groups) * chunks
        base = seq if offset else 0

        def fill(q):
            nonlocal fills
            assert released[q % stages] % units == 0, "a buffer refilled while it is read"
            landing.append((q % stages, q))
            fills += 1

        for s in range(min(steps, stages)):
            fill(base + s)
        pos = [0] * units  # each warpgroup's next step
        while min(pos) < steps:
            movable = [w for w in range(units) if pos[w] < steps and
                       phases[(base + pos[w]) % stages] & 1 != ((base + pos[w]) // stages) & 1]
            if landing and (not movable or rng.random() < 0.3):
                st, q = landing.pop(rng.randrange(len(landing)))
                data[st] = q
                phases[st] += 1
                continue
            assert movable, "no warpgroup can move"
            w = rng.choice(movable)
            q = base + pos[w]
            st = q % stages
            assert data[st] == q, f"step {q} read the chunk of step {data[st]}"
            released[st] += 1
            if released[st] % units == 0 and pos[w] + stages < steps:
                fill(q + stages)
            pos[w] += 1
        assert not landing
        seq += steps
    return fills


@pytest.mark.parametrize("stages", [2, 3])
@pytest.mark.parametrize("tiles", [[13] * 10, [99, 99, 1, 2, 3]])
def test_ring_phases_under_any_interleaving(tiles, stages):
    """nr_2_0_4 Z=4 (13 tiles a layer, 10 layers; 7 rounds, one warpgroup
    idle in the last) and nr_2_0_32 Z=32 (99 tiles), then layers of one to
    three tiles, with the ring's two stages and with three: across layers
    the parities of seq find every chunk, for many interleavings; one fill
    a step."""
    steps = sum(-(-n // fg.WIDE_GROUPS) * (H // CH) for n in tiles)
    for seed in range(10):
        assert ring_run(tiles, seed, stages=stages) == steps


def test_ring_model_catches_a_ring_without_seq():
    """Counting each layer's steps from 0 breaks a ring whose layers leave
    its stages' phases out of step (three stages, eight chunks a round): the
    simulation catches it."""
    with pytest.raises(AssertionError, match="read the chunk|no warpgroup can move"):
        for seed in range(10):
            ring_run([13, 13, 13], seed, stages=3, offset=False)
