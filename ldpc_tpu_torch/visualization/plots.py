"""Plotting and reporting (counterpart of ``ldpc_tpu.visualization.plots``).

BER, FER, iteration and combined plots with the theoretical uncoded-QPSK
overlay and a paper style, the parameter-count chart, and the trainer's
history and SNR figures.  A pure reporting layer: it reads the results JSON
that :class:`ldpc_tpu_torch.training.ComparativeEvaluator` writes (the JAX
package's schema) and writes the JAX package's file names.

This is the only module of the port that imports matplotlib (with the Agg
backend): importing the package, the CLI or the trainer does not, so they
run where matplotlib is not installed.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def apply_paper_style() -> None:
    """Serif publication style."""
    plt.rcParams.update(
        {
            "font.family": "serif",
            "font.size": 11,
            "axes.grid": True,
            "grid.alpha": 0.4,
            "legend.frameon": False,
            "figure.dpi": 150,
        }
    )


def _theoretical_qpsk(snr_db: np.ndarray) -> np.ndarray:
    """The uncoded-QPSK overlay, 0.5 * exp(-snr_linear)."""
    return 0.5 * np.exp(-(10.0 ** (snr_db / 10.0)))


def plot_metric(results: dict, metric: str, ax=None, theoretical: bool = False):
    """Semilog plot of 'ber' or 'fer' for every decoder in a results dict."""
    if ax is None:
        _, ax = plt.subplots(figsize=(8, 5))
    snr = np.asarray(results["snr_range"], dtype=float)
    markers = "os^vD*P<>"
    for i, (name, entry) in enumerate(results["decoders"].items()):
        vals = np.asarray(entry[metric], dtype=float)
        vals = np.where(vals <= 0, np.nan, vals)  # log scale: hide exact zeros
        ax.semilogy(snr, vals, marker=markers[i % len(markers)], label=name)
    if theoretical and metric == "ber":
        ax.semilogy(snr, _theoretical_qpsk(snr), "k--", label="Uncoded QPSK (theory)")
    ax.set_xlabel("SNR (dB)")
    ax.set_ylabel(metric.upper())
    ax.set_title(f"{metric.upper()} vs SNR")
    ax.legend()
    ax.grid(True, which="both", alpha=0.4)
    return ax


def plot_iterations(results: dict, ax=None):
    """Average-iterations plot for decoders that report them."""
    if ax is None:
        _, ax = plt.subplots(figsize=(8, 5))
    snr = np.asarray(results["snr_range"], dtype=float)
    for name, entry in results["decoders"].items():
        if "avg_iterations" in entry:
            ax.plot(snr, entry["avg_iterations"], marker="o", label=name)
    ax.set_xlabel("SNR (dB)")
    ax.set_ylabel("Average iterations")
    ax.set_title("Decoding iterations vs SNR")
    ax.legend()
    return ax


def plot_parameter_counts(results: dict, ax=None):
    """Bar chart of trainable-parameter counts (decoders with any)."""
    if ax is None:
        _, ax = plt.subplots(figsize=(8, 5))
    named = {n: e.get("param_count", 0) for n, e in results["decoders"].items()}
    named = {n: c for n, c in named.items() if c}
    ax.bar(range(len(named)), list(named.values()))
    ax.set_xticks(range(len(named)))
    ax.set_xticklabels(list(named.keys()), rotation=20, ha="right")
    ax.set_ylabel("Trainable parameters")
    ax.set_title("Model complexity")
    return ax


def plot_combined(results: dict, theoretical: bool = True):
    """2x2 figure: BER, FER, iterations, parameter counts."""
    fig, axes = plt.subplots(2, 2, figsize=(13, 9))
    plot_metric(results, "ber", axes[0, 0], theoretical=theoretical)
    plot_metric(results, "fer", axes[0, 1])
    plot_iterations(results, axes[1, 0])
    plot_parameter_counts(results, axes[1, 1])
    fig.tight_layout()
    return fig


def plot_training_history(history: dict):
    """(loss figure, BER/FER figure or None) of a trainer's history."""
    fig1, ax1 = plt.subplots(figsize=(8, 5))
    ax1.plot(history.get("train_losses", []), label="Training loss")
    vl = history.get("val_losses", [])
    if vl:
        tl = len(history.get("train_losses", []))
        xs = np.linspace(0, max(tl - 1, 1), len(vl))
        ax1.plot(xs, vl, "o-", label="Validation loss")
    ax1.set_xlabel("Epoch")
    ax1.set_ylabel("Loss")
    ax1.legend()
    fig2 = None
    if history.get("ber_history"):
        fig2, ax2 = plt.subplots(figsize=(8, 5))
        ax2.semilogy(history["ber_history"], "o-", label="BER")
        ax2.semilogy(history["fer_history"], "s-", label="FER")
        ax2.set_xlabel("Validation step")
        ax2.set_ylabel("Error rate")
        ax2.legend()
    return fig1, fig2


def plot_snr_performance(snr_range, ber_results, fer_results, comparison_ber=None,
                         comparison_fer=None):
    """(BER figure, FER figure) of a neural decoder over SNR, each with a
    conventional decoder's curve beside it where given."""
    figs = []
    for label, values, other in (("BER", ber_results, comparison_ber),
                                 ("FER", fer_results, comparison_fer)):
        fig, ax = plt.subplots(figsize=(8, 5))
        ax.semilogy(snr_range, values, "o-", label="Neural decoder")
        if other is not None:
            ax.semilogy(snr_range, other, "s-", label="Conventional decoder")
        ax.set_xlabel("SNR (dB)")
        ax.set_ylabel(label)
        ax.legend()
        ax.grid(True)
        figs.append(fig)
    return tuple(figs)


def render_report(results_path: str | Path, out_dir: str | Path, paper_style: bool = False,
                  formats=("png",)) -> list[Path]:
    """Results JSON -> {ber,fer,iterations,combined}_comparison images."""
    if paper_style:
        apply_paper_style()
    results = json.loads(Path(results_path).read_text())
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    jobs = {
        "ber": lambda: plot_metric(results, "ber", theoretical=True).figure,
        "fer": lambda: plot_metric(results, "fer").figure,
        "iterations": lambda: plot_iterations(results).figure,
        "combined": lambda: plot_combined(results),
    }
    for name, make in jobs.items():
        fig = make()
        for fmt in formats:
            p = out_dir / f"{name}_comparison.{fmt}"
            fig.savefig(p, bbox_inches="tight")
            written.append(p)
        plt.close(fig)
    return written
