"""Command-line tools of the port, each run as ``python -m
ldpc_tpu_torch.tools.<name>``: the GNN kernel bench and the aggregation
probe (counterparts of the JAX package's ``tools/bench_gnn_kernel.py`` and
``tools/probe_agg_mxu.py``)."""
