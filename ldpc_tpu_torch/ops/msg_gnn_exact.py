"""Inputs on which a fully-neural message-GNN kernel and its plain version
must agree exactly, whatever order each sums in.

``exact_msg_gnn_case`` builds a ``create_message_gnn_decoder`` model and
LLRs from a numpy seed whose every value is dyadic and, before the output
projection, nonnegative: first- and second-layer weights 1/h or 2/h on a
quarter of the entries and 0 elsewhere, biases 0 or 1/4, embedding weights
0, 1/8 or 1/4 and biases 1/4, 1/2 or 1, no type embeddings, LLRs multiples
of 1/2 in [0, 4]; the projection is +-1/32 with bias -1, so the decisions
take both values.  bf16 x bf16 products are exact in float32, and a sum of
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
to that bar.  Nothing here needs a card.
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


def _dyadic(rng: np.random.Generator, shape, values, density: float) -> np.ndarray:
    """Entries drawn from ``values`` on a ``density`` share, else 0."""
    vals = rng.choice(np.asarray(values, np.float64), size=shape)
    return np.where(rng.random(shape) < density, vals, 0.0).astype(np.float32)


def exact_msg_gnn_case(qc: QCLayout, hidden_dim: int, batch: int, input_injection: bool,
                       share_layers: bool, seed: int = EXACT_SEED, num_iterations: int = 2):
    """(model on the CPU, LLRs (batch, n) float32 numpy) of an exact case."""
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
        "message_type_embeddings": ((0.0,), 1.0),
    }
    with torch.no_grad():
        for name, p in model.named_parameters():
            key = next((k for k in values if name.endswith(k)), None)
            if key is None:
                raise ValueError(f"no exact value chosen for parameter {name}")
            p.copy_(torch.from_numpy(_dyadic(rng, tuple(p.shape), *values[key])))
    llr = (rng.integers(0, 9, (batch, qc.num_vars)) / 2.0).astype(np.float32)
    return model, llr
