"""BER/FER figures of high-precision sweep JSONs (counterpart of
``tools/plot_highprecision.py``).

Reads the JSON that the high-precision tools write (the JAX package's
records in ``results/*_highprecision.json`` or the port's
:mod:`ldpc_tpu_torch.tools.high_precision_curve`), adapts it to the
comparison-results schema of :mod:`ldpc_tpu_torch.visualization.plots` and
writes a two-panel BER/FER PNG next to each input.

Run:  python -m ldpc_tpu_torch.tools.plot_highprecision results/*_highprecision.json
          [--paper-style] [--no-theoretical]

Needs matplotlib (imported when the figures are drawn, not by :func:`adapt`).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path


def adapt(raw: dict) -> dict:
    """High-precision sweep JSON -> comparison-results schema."""
    if "decoders" in raw:
        decoders = raw["decoders"]
    else:  # high_precision_curve's single-decoder format
        name = f"Min-Sum ({raw.get('iterations', '?')} iters)"
        decoders = {name: {"ber": raw["ber"], "fer": raw["fer"]}}
    return {"snr_range": raw["snr"], "decoders": decoders}


def main(argv=None) -> list[Path]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("inputs", nargs="+")
    ap.add_argument("--paper-style", action="store_true")
    ap.add_argument("--no-theoretical", action="store_true")
    args = ap.parse_args(argv)

    from ldpc_tpu_torch.visualization.plots import apply_paper_style, plot_metric, plt

    if args.paper_style:
        apply_paper_style()
    written = []
    for path in args.inputs:
        path = Path(path)
        raw = json.loads(path.read_text())
        results = adapt(raw)
        fig, axes = plt.subplots(1, 2, figsize=(13, 5))
        plot_metric(results, "ber", axes[0], theoretical=not args.no_theoretical)
        plot_metric(results, "fer", axes[1])
        bits = raw.get("bits_per_point")
        title = f"{raw.get('code', path.stem)}"
        if bits:
            title += f" — {bits:.2g} bits/point"
        fig.suptitle(title)
        fig.tight_layout()
        out = path.with_suffix(".png")
        fig.savefig(out, dpi=150)
        plt.close(fig)
        print(f"wrote {out}")
        written.append(out)
    return written


if __name__ == "__main__":
    main()
