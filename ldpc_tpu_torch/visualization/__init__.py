"""Plotting and reporting (imports matplotlib; nothing else of the port does)."""

from ldpc_tpu_torch.visualization.plots import (  # noqa: F401
    apply_paper_style,
    plot_combined,
    plot_iterations,
    plot_metric,
    plot_parameter_counts,
    plot_snr_performance,
    plot_training_history,
    render_report,
)
