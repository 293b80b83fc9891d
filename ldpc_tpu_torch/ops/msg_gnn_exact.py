"""Inputs on which a fully-neural message-GNN kernel and its plain version
must agree exactly, whatever order each sums in.

``exact_msg_gnn_case`` builds a ``create_message_gnn_decoder`` model and
LLRs from a numpy seed whose every value is dyadic and, before the output
projection, nonnegative: first- and second-layer weights 1/h or 2/h on a
quarter of the entries and 0 elsewhere, biases 0 or 1/4, embedding weights
0, 1/8 or 1/4 and biases 1/4, 1/2 or 1, no type embeddings (or, with
``type_embeddings``, entries drawn from those values), LLRs multiples of 1/2
in [0, 4]; the projection is +-1/32 with bias -1, so the decisions take both
values.  bf16 x bf16 products are exact in float32, and a sum of
terms that are all multiples of one power of two Q is exact in any order,
and through any alignment that keeps 24 bits below its largest term, while
the terms' magnitudes add up to less than 2**24 Q.  With no negative value
no sum cancels, so no value is small beside the terms it is summed with:
every sum of a T=2 decode stays inside that span (checked value by value
on the CPU, in tests/test_torch_msg_gnn_tc.py).  So only an index, a shift
or a rounding point placed elsewhere can make a kernel differ from its
plain version on these inputs: the bar is ``torch.equal``.  The ReLUs are
never negative here; the 3e-2 cases hold them.

``EXACT_CASES`` are the configurations the tests and ``chip_smoke.py`` hold
to that bar, at the widths every fully-neural kernel is built for;
``EXACT_WIDE_CASES`` those at h = 128, for B7 and B9 alone (weights of 1/h
or 2/h are then multiples of 1/128).  ``EXACT_TE_CASES`` add type
embeddings of 0, 1/4 or 1/2 (``EXACT_TYPE_EMBEDDINGS``) for ``msg_gnn_v3``,
whose features carry them: its seed adds te_0 and each writeback the next
block of the delta table (te_{t+1} - te_t), so a wrong block or edge index
there shows only where the embeddings are not zero.  The features stay
nonnegative (a writeback removes te_t from a value it rounded up from at
least te_t), and at T = 3 the middle block is a difference of two nonzero
embeddings.

``exact_corrected_case`` does the same for the corrected min-sum GNN
(``create_corrected_minsum_gnn_decoder``, B4).  There the messages are
min-sum messages of both signs, corrected by float32 sums, so their own
quanta are fine; what makes the reordered sums exact is that each one
multiplies bf16 values bounded away from 0.  The only sums a kernel may
reorder are its products: the features f = bf16(m * emb_w + ebias), the
variable means and the LLR features lf times first-layer weights, the
check's sum of those products, and bf16(relu(.)) of the first layer times
the folded second layer w2p.  Embedding weights 0, 1/128 or 1/64 against
biases of 2 or 3 (plus type embeddings 0, 1/2 or 1) keep every f, mean and
lf in [1.5, 4.5] while |m| < 32: bf16 values there are multiples of 2**-7.
First-layer weights 1/h or 2/h on a quarter of the entries and first-layer
biases 1 or 2 keep every first-layer output at 1 or above, so its bf16 is a
multiple of 2**-7 too (the ReLUs never clip here).  Second-layer weights
1/h or 2/h on an eighth of the entries and projections of +-1/64 make w2p a
small multiple of 2**-6 / h.  alpha is 3/4 and w_ch 1/2.  The LLRs are
multiples of 1/2 with magnitudes up to 4, each frame with its own share of
negative bits (0 to one half), so that some frames stop after one or two
iterations and the others end with soft bits of both decisions.  The
bounds are checked value by value on the CPU (tests/test_torch_corrected_tc.py);
every other operation of the decode runs in the same order in a kernel and
its plain version.  ``CORRECTED_EXACT_CASES`` adds the early-exit flag.

The same cases hold B5 (``make_fused_corrected_gnn_decoder``), whose second
layer is not folded.  It also reorders W1cf f + W1ca rmean (one
accumulator; rmean is a mean of features, in [1.5, 4.5] like them), W2v h1
+ b2v and W2c h1 + b2c (h1 a multiple of 2**-7, the weights of 1/h, b2 0
or 1/4: multiples of 2**-7 / h, far below 2**24 of them), and the
projection sum_j lo_j pw_j (lo = bf16(out_v + out_c), a rounding of such
a multiple, so again a multiple of 2**-7 / h, times +-1/64).  Each is
exact in any order; tests/test_torch_corrected_v1_tc.py checks them value
by value, with out_v + out_c, which both versions take as one addition.

Nothing here needs a card.
"""
from __future__ import annotations

import numpy as np
import torch

from ldpc_tpu_torch.codes.edge_layout import QCLayout

# (code, Z, hidden_dim, batch, input_injection, share_layers)
EXACT_CASES = (
    ("toy_4x8", 4, 16, 7, False, False),
    ("toy_4x8", 4, 16, 7, True, False),
    ("toy_4x8", 4, 16, 7, True, True),
    ("nr_2_0_4", 4, 64, 5, False, False),
    ("nr_2_0_4", 4, 64, 5, True, False),
    ("nr_2_0_4", 4, 64, 5, True, True),
    ("nr_2_0_32", 32, 64, 3, False, False),
    ("nr_2_0_32", 32, 64, 3, True, False),
    ("nr_2_0_32", 32, 64, 3, True, True),
)
EXACT_SEED = 5

# h = 128, the width B7 and B9 alone are built for (their weights streamed in
# chunks of hidden units): the same values, whose weights' quantum is then
# 1/128; every sum stays within 2**24 of its quanta (checked value by value
# in tests/test_torch_msg_gnn_wide.py).
EXACT_WIDE_CASES = (
    ("toy_4x8", 4, 128, 7, True, False),
    ("nr_2_0_4", 4, 128, 5, True, False),
    ("nr_2_0_4", 4, 128, 5, True, True),
    ("nr_2_0_32", 32, 128, 2, False, False),
)

# (code, Z, hidden_dim, batch, input_injection, share_layers, num_iterations)
EXACT_TE_CASES = (
    ("toy_4x8", 4, 16, 7, True, False, 3),
    ("nr_2_0_4", 4, 64, 5, False, False, 2),
    ("nr_2_0_32", 32, 64, 3, False, False, 3),
)
EXACT_TYPE_EMBEDDINGS = (0.0, 0.25, 0.5)

# (code, Z, hidden_dim, batch, input_injection, share_layers, early_exit)
CORRECTED_EXACT_CASES = (
    ("toy_4x8", 4, 16, 10, False, False, False),
    ("toy_4x8", 4, 16, 10, True, False, True),
    ("toy_4x8", 4, 16, 10, True, True, False),
    ("nr_2_0_4", 4, 64, 10, False, False, True),
    ("nr_2_0_4", 4, 64, 10, True, False, False),
    ("nr_2_0_4", 4, 64, 10, True, True, True),
    ("nr_2_0_32", 32, 64, 5, False, False, False),
    ("nr_2_0_32", 32, 64, 5, True, False, True),
    ("nr_2_0_32", 32, 64, 5, True, True, False),
)
# Share of negative LLRs of frame i: NEGATIVE_SHARES[i % 5].
NEGATIVE_SHARES = (0.0, 0.02, 0.1, 0.3, 0.5)


def _dyadic(rng: np.random.Generator, shape, values, density: float) -> np.ndarray:
    """Entries drawn from ``values`` on a ``density`` share, else 0."""
    vals = rng.choice(np.asarray(values, np.float64), size=shape)
    return np.where(rng.random(shape) < density, vals, 0.0).astype(np.float32)


def _set_parameters(model, rng: np.random.Generator, values: dict) -> None:
    """Every non-empty parameter of ``model`` drawn by ``_dyadic`` from the
    entry of ``values`` (name ending -> (values, share)) its name ends with."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.numel() == 0:
                continue
            key = next((k for k in values if name.endswith(k)), None)
            if key is None:
                raise ValueError(f"no exact value chosen for parameter {name}")
            p.copy_(torch.from_numpy(_dyadic(rng, tuple(p.shape), *values[key])))


def exact_msg_gnn_case(qc: QCLayout, hidden_dim: int, batch: int, input_injection: bool,
                       share_layers: bool, seed: int = EXACT_SEED, num_iterations: int = 2,
                       type_embeddings: tuple = (0.0,)):
    """(model on the CPU, LLRs (batch, n) float32 numpy) of an exact case;
    every type embedding entry drawn from ``type_embeddings``."""
    from ldpc_tpu_torch.models import create_message_gnn_decoder
    from ldpc_tpu_torch.ops import qc_msg

    rng = np.random.default_rng(seed)
    model = create_message_gnn_decoder(
        qc_msg.make_plan(qc, device="cpu"), num_iterations=num_iterations, hidden_dim=hidden_dim,
        input_injection=input_injection, share_layers=share_layers)
    h = hidden_dim
    values = {  # state_dict name ending -> (values, share of nonzero entries)
        "input_embedding.weight": ((0.0, 0.125, 0.25), 1.0),
        "input_embedding.bias": ((0.25, 0.5, 1.0), 1.0),
        "Dense_0.weight": ((1.0 / h, 2.0 / h), 0.25),
        "Dense_1.weight": ((1.0 / h, 2.0 / h), 0.25),
        "Dense_0.bias": ((0.0, 0.25), 1.0),
        "Dense_1.bias": ((0.0, 0.25), 1.0),
        "output_projection.weight": ((-1.0 / 32, 1.0 / 32), 1.0),
        "output_projection.bias": ((-1.0,), 1.0),
        "message_type_embeddings": (tuple(type_embeddings), 1.0),
    }
    _set_parameters(model, rng, values)
    llr = (rng.integers(0, 9, (batch, qc.num_vars)) / 2.0).astype(np.float32)
    return model, llr


def exact_corrected_case(qc: QCLayout, hidden_dim: int, batch: int, input_injection: bool,
                         share_layers: bool, seed: int = EXACT_SEED, num_iterations: int = 2):
    """(corrected model on the CPU, LLRs (batch, n) float32 numpy) of an
    exact case of the corrected min-sum GNN."""
    from ldpc_tpu_torch.models import create_corrected_minsum_gnn_decoder
    from ldpc_tpu_torch.ops import qc_msg

    rng = np.random.default_rng(seed)
    model = create_corrected_minsum_gnn_decoder(
        qc_msg.make_plan(qc, device="cpu"), num_iterations=num_iterations,
        hidden_dim=hidden_dim, input_injection=input_injection, share_layers=share_layers)
    h = hidden_dim
    _set_parameters(model, rng, {
        "w_ch": ((0.5,), 1.0),
        "alpha": ((0.75,), 1.0),
        "input_embedding.weight": ((0.0, 1.0 / 128, 1.0 / 64), 1.0),
        "input_embedding.bias": ((2.0, 3.0), 1.0),
        "message_type_embeddings": ((0.0, 0.5, 1.0), 1.0),
        "Dense_0.weight": ((1.0 / h, 2.0 / h), 0.25),
        "Dense_0.bias": ((1.0, 2.0), 1.0),
        "Dense_1.weight": ((1.0 / h, 2.0 / h), 0.125),
        "Dense_1.bias": ((0.0, 0.25), 1.0),
        "_proj.weight": ((-1.0 / 64, 1.0 / 64), 1.0),
        "_proj.bias": ((0.0,), 1.0),
    })
    mags = rng.integers(1, 9, (batch, qc.num_vars)) / 2.0
    shares = np.asarray([NEGATIVE_SHARES[i % len(NEGATIVE_SHARES)] for i in range(batch)])
    negative = rng.random((batch, qc.num_vars)) < shares[:, None]
    return model, np.where(negative, -mags, mags).astype(np.float32)
