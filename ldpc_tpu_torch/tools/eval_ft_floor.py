"""Tail BER/FER of the h=128 T=10 message GNNs through the hand-written
B7 kernel at h=128 (the counterpart of ``tools/eval_ft_floor.py``).

Each h=128 sweep checkpoint that exists (``results/gnn_sweep_h128_t10``,
its fine-tune ``_ft`` and wide-window fine-tune ``_ft2``; a missing one is
skipped) is read by the port's flax reader into a ``MessageGNNDecoder``
(T=10, h=128, input injection) and served by
``make_fused_gnn_decoder_v2(hidden_dim=128)`` as the JAX tool serves it:
random GF(2) codewords of
nr_2_0_4 Z=4, QPSK over AWGN, decisions at soft bit 0.5, bit and frame
errors counted over ``--trials`` batches of ``--batch`` frames per SNR.
Every model sees the same codewords and noise: trial t at SNR index i
draws both from one ``torch.Generator`` seeded from (``--seed``, i, t).

Run:  python -m ldpc_tpu_torch.tools.eval_ft_floor [--trials 500] [--batch 1024]
          [--snrs 1,2,3,4,5,6] [--out gnn_h128t10_ft_floor_torch.json] [--device cuda | cpu]

The default device is the card, where each batch is one launch of the
kernel; without a card it raises.  ``--device cpu`` runs the kernel's plain
PyTorch version (for checking, not for tail statistics).  Writes the JAX
tool's schema (``protocol``, ``snr_range``, ``models`` with ``ber`` and
``fer``; here also the error and frame counts) to ``--out``, and
``main(argv)`` returns it.  :func:`error_counts` is its loop for any
builder of ``fused_gnn`` with the same signature.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ldpc_tpu_torch import convert
from ldpc_tpu_torch._device import resolve_device
from ldpc_tpu_torch.codes import encoder_from_H, expand_base_matrix, get_base_graph, qc_layout
from ldpc_tpu_torch.models import create_message_gnn_decoder
from ldpc_tpu_torch.ops import fused_gnn, qc_msg
from ldpc_tpu_torch.utils import qpsk_awgn_llr

RESULTS = Path(__file__).resolve().parents[2] / "results"
CODE, Z, T, HIDDEN = "nr_2_0_4", 4, 10, 128
SEED = 911  # --seed
# (tag as the JAX tool writes it, checkpoint under results/)
MODELS = [("h=128 T=10", "gnn_sweep_h128_t10.msgpack"),
          ("h=128 T=10 ft", "gnn_sweep_h128_t10_ft.msgpack"),
          ("h=128 T=10 ft2 [-3,6]", "gnn_sweep_h128_t10_ft2.msgpack")]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=500)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--snrs", default="1,2,3,4,5,6")
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--out", default="gnn_h128t10_ft_floor_torch.json")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def trial_generator(seed: int, snr_index: int, trial: int, device: torch.device) -> torch.Generator:
    """The generator of one (SNR, trial): codewords and noise, the same for
    every model."""
    state = np.random.SeedSequence([seed, snr_index, trial]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def load_model(path, plan) -> torch.nn.Module:
    """A h=128 T=10 sweep checkpoint in the port's ``MessageGNNDecoder``."""
    model = create_message_gnn_decoder(plan, num_iterations=T, hidden_dim=HIDDEN,
                                       input_injection=True, multiloss=True)
    convert.load_message_gnn(path, model)
    return model.eval()


def error_counts(build, snrs: list[float], trials: int, batch: int, seed: int,
                 device: torch.device) -> dict:
    """Each h=128 T=10 checkpoint that exists, served by ``build`` (a
    ``fused_gnn`` builder): its bit and frame errors per SNR over ``trials``
    batches of ``batch`` frames, by the tag the JAX tool writes."""
    qc = qc_layout(get_base_graph(CODE), Z)
    plan = qc_msg.make_plan(qc, device)
    enc = encoder_from_H(expand_base_matrix(get_base_graph(CODE), Z))
    n = qc.num_vars
    models = {}
    for tag, name in MODELS:
        path = RESULTS / name
        if not path.exists():
            continue
        decode = build(qc, load_model(path, plan), num_iterations=T, hidden_dim=HIDDEN,
                       input_injection=True, device=device)
        t0 = time.time()
        bit_errors, frame_errors = [], []
        for i, snr in enumerate(snrs):
            be = fe = 0
            for t in range(trials):
                gen = trial_generator(seed, i, t, device)
                bits = enc.random_codewords(gen, batch)
                hard = (decode(qpsk_awgn_llr(gen, bits, snr)) > 0.5).to(torch.float32)
                errs = (hard != bits).sum(dim=1)
                be += int(errs.sum())
                fe += int((errs > 0).sum())
            bit_errors.append(be)
            frame_errors.append(fe)
        frames = trials * batch
        models[tag] = {"ber": [b / (frames * n) for b in bit_errors],
                       "fer": [f / frames for f in frame_errors],
                       "bit_errors": bit_errors, "frame_errors": frame_errors,
                       "frames": frames, "seconds": time.time() - t0}
        print(f"{tag}: " + "  ".join(f"{s:+.0f}dB BER {b / (frames * n):.2e}"
                                     for s, b in zip(snrs, bit_errors))
              + f"  ({time.time() - t0:.0f}s)", flush=True)
    return models


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    snrs = [float(s) for s in args.snrs.split(",")]
    n = qc_layout(get_base_graph(CODE), Z).num_vars
    out = {
        "protocol": {
            "code": CODE, "Z": Z, "codewords": "random (GF(2) encoder)",
            "modulation": "qpsk", "trials": args.trials, "batch": args.batch,
            "bits_per_point": args.trials * args.batch * n,
            "identical_noise": "per-(snr, trial) torch.Generator seeds, same for every model",
            "serving": "fused msg_gnn_v2 kernel at h=128 (csrc/fused_msg_gnn_tc.cu)",
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        },
        "snr_range": snrs,
        "models": error_counts(fused_gnn.make_fused_gnn_decoder_v2, snrs, args.trials,
                               args.batch, args.seed, dev),
    }
    Path(args.out).write_text(json.dumps(out, indent=2))
    print(f"wrote {args.out}", flush=True)
    return out


if __name__ == "__main__":
    main()
