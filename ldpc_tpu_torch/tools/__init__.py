"""Command-line tools of the port, each run as ``python -m
ldpc_tpu_torch.tools.<name>``: the GNN kernel bench, the aggregation probe,
the min-sum waterfall and its plot (counterparts of the JAX package's
``tools/bench_gnn_kernel.py``, ``tools/probe_agg_mxu.py``,
``tools/high_precision_curve.py`` and ``tools/plot_highprecision.py``), and
the port's own probes."""
