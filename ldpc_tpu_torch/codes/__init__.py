"""Code construction: 5G NR base graphs, QC lifting, edge layouts."""

from ldpc_tpu_torch.codes.base_graphs import (  # noqa: F401
    BaseGraph,
    available_base_graphs,
    base_graph_from_H,
    expand_base_matrix,
    get_base_graph,
    load_base_matrix,
)
from ldpc_tpu_torch.codes.encoder import Encoder, encoder_from_H  # noqa: F401
from ldpc_tpu_torch.codes.edge_layout import (  # noqa: F401
    EdgeLayout,
    QCLayout,
    edge_layout_from_H,
    edge_layout_from_H_numpy,
    qc_layout,
)
