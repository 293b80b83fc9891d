"""Command-line interface: train / evaluate / compare / visualize / workflow
(counterpart of ``ldpc_tpu.cli``).

Run:  python -m ldpc_tpu_torch.cli {train,evaluate,compare,visualize,workflow,bench}
          [--config cfg.json] [--<config-field> value ...] [--device cuda | cpu]

The modes and flags are the JAX CLI's: one flag a field of
:class:`ldpc_tpu_torch.config.Config` (``--x/--no-x`` for a bool, so that a
config file's ``true`` can be overridden off), plus ``--device`` (default
the card; without one the commands raise, ``--device cpu`` runs the plain
PyTorch versions).  ``workflow`` chains train -> evaluate -> compare ->
visualize in process, each stage timed.

``compare --mesh-data N`` runs under ``torchrun --nproc-per-node N`` (one
rank a card; ``gloo`` with ``--device cpu``): each rank decodes its rows of
every trial and only rank 0 prints and writes files.  ``bench`` is the
port's benchmark, which is not written yet (ROADMAP §A1).

``visualize`` imports matplotlib; no other mode does.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

from ldpc_tpu_torch.config import Config

MODES = ["train", "evaluate", "compare", "visualize", "workflow", "bench"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ldpc-tpu-torch",
                                description="PyTorch/CUDA 5G LDPC decoding framework")
    p.add_argument("mode", choices=MODES)
    p.add_argument("--config", type=str, default=None, help="JSON config file (flags override)")
    defaults = Config()
    for f in dataclasses.fields(Config):
        flag = "--" + f.name.replace("_", "-")
        if f.type == "bool" or isinstance(getattr(defaults, f.name), bool):
            p.add_argument(flag, action=argparse.BooleanOptionalAction, default=None)
        else:
            p.add_argument(flag, type=type(getattr(defaults, f.name)), default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def config_from_args(args) -> Config:
    cfg = Config.from_file(args.config) if args.config else Config()
    overrides = {
        f.name: getattr(args, f.name)
        for f in dataclasses.fields(Config)
        if getattr(args, f.name, None) is not None
    }
    return cfg.replace(**overrides)


# ---------------------------------------------------------------------------


def _setup(cfg: Config, device: str = "cuda"):
    """(base graph, QC layout, decode plan on ``device``) of the config's code."""
    from ldpc_tpu_torch.codes import get_base_graph, load_base_matrix, qc_layout
    from ldpc_tpu_torch.ops import qc_msg

    if Path(cfg.base_graph).exists():
        bg = load_base_matrix(cfg.base_graph)
    else:
        bg = get_base_graph(cfg.base_graph)
    qc = qc_layout(bg, cfg.lifting_factor)
    return bg, qc, qc_msg.make_plan(qc, device=device)


def _encoder(cfg: Config, bg):
    from ldpc_tpu_torch.codes import encoder_from_H, expand_base_matrix

    return encoder_from_H(expand_base_matrix(bg, cfg.lifting_factor))


def make_model(cfg: Config, plan):
    """The decoder module of ``cfg.model_type`` (every model type of the
    JAX CLI's factory, the node GNN included)."""
    from ldpc_tpu_torch.models import (
        create_corrected_minsum_gnn_decoder,
        create_custom_check_message_gnn_decoder,
        create_custom_minsum_message_gnn_decoder,
        create_custom_variable_message_gnn_decoder,
        create_message_gnn_decoder,
        make_base_graph_gnn_decoder,
        make_gnn_decoder,
        make_standard_decoder,
        make_tied_decoder,
    )

    mt = cfg.model_type
    if mt == "standard":
        return make_standard_decoder(plan, cfg.num_iterations, cfg.depth_L)
    if mt == "tied":
        return make_tied_decoder(plan, cfg.num_iterations, cfg.depth_L)
    if mt == "gnn":
        return make_gnn_decoder(plan, cfg.num_iterations, cfg.depth_L)
    if mt == "base_graph_gnn":
        return make_base_graph_gnn_decoder(plan, cfg.num_iterations, cfg.depth_L)
    gnn_kw = dict(num_iterations=cfg.num_iterations, hidden_dim=cfg.hidden_dim,
                  share_layers=cfg.share_layers)
    if mt == "message_gnn":
        return create_message_gnn_decoder(plan, **gnn_kw)
    if mt == "message_gnn_var_minsum":
        return create_custom_variable_message_gnn_decoder(plan, depth_L=cfg.depth_L, **gnn_kw)
    if mt == "message_gnn_check_minsum":
        return create_custom_check_message_gnn_decoder(plan, **gnn_kw)
    if mt == "message_gnn_minsum":
        return create_custom_minsum_message_gnn_decoder(plan, depth=cfg.depth_L,
                                                        num_iterations=cfg.num_iterations,
                                                        hidden_dim=cfg.hidden_dim)
    if mt == "message_gnn_corrected":
        return create_corrected_minsum_gnn_decoder(plan, input_injection=True, **gnn_kw)
    raise SystemExit(f"unknown --model-type {mt!r}")


def _trainer(cfg: Config, plan, bg=None, device: str = "cuda"):
    import torch

    from ldpc_tpu_torch.training import LDPCDecoderTrainer

    encoder = None
    if bg is not None and (cfg.data_mode == "random_codewords" or cfg.random_codewords):
        encoder = _encoder(cfg, bg)
    # A fresh model's weights are a function of cfg.seed, as the JAX CLI's
    # init key is, so every rank of a mesh builds the same one.
    torch.manual_seed(cfg.seed)
    model = make_model(cfg, plan)
    return LDPCDecoderTrainer(model, plan, seed=cfg.seed, convention=cfg.convention,
                              modulation=cfg.modulation, encoder=encoder, device=device)


def cmd_train(cfg: Config, device: str = "cuda") -> None:
    bg, _, plan = _setup(cfg, device)
    tr = _trainer(cfg, plan, bg, device)
    print(f"training {cfg.model_type} on {cfg.base_graph} Z={cfg.lifting_factor} "
          f"({cfg.num_epochs} epochs, {cfg.data_mode}, {cfg.optimizer})")
    tr.train(
        num_epochs=cfg.num_epochs,
        batch_size=cfg.batch_size,
        learning_rate=cfg.learning_rate,
        snr_range=cfg.train_snr_range(),
        momentum=cfg.momentum,
        weight_decay=cfg.weight_decay,
        validation_interval=cfg.validation_interval,
        data_mode=cfg.data_mode,
        optimizer=cfg.optimizer,
    )
    tr.save_model(cfg.model_path)
    Path(cfg.results_dir).mkdir(parents=True, exist_ok=True)
    tr.save_history_json(Path(cfg.results_dir) / "training_history.json")
    print(f"saved model to {cfg.model_path}")


def cmd_evaluate(cfg: Config, device: str = "cuda") -> None:
    bg, _, plan = _setup(cfg, device)
    tr = _trainer(cfg.replace(data_mode="random_codewords") if cfg.random_codewords else cfg,
                  plan, bg, device)
    if Path(cfg.model_path).exists():
        tr.load_model(cfg.model_path)
        print(f"loaded {cfg.model_path}")
    else:
        print(f"warning: {cfg.model_path} not found — evaluating untrained model")
    snrs = cfg.eval_snr_range()
    bers, fers = tr.evaluate_snr_range(snrs, cfg.batch_size, cfg.num_trials,
                                       use_encoder=cfg.random_codewords)
    n_params = sum(p.numel() for p in tr.model.parameters())
    results = {"snr_range": snrs,
               "decoders": {cfg.model_type: {"ber": bers, "fer": fers,
                                             "param_count": n_params}}}
    out = Path(cfg.results_dir) / "evaluation_results.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=2))
    for s, b, f in zip(snrs, bers, fers):
        print(f"snr {s:5.1f}  BER {b:.3e}  FER {f:.3f}")
    print(f"saved {out}")


def cmd_compare(cfg: Config, device: str = "cuda") -> None:
    """Compare classical and neural decoders: several model types through
    ``--compare-models``, a fresh model where no checkpoint exists, the
    parameter counts in the results.  With ``--mesh-data`` the process
    group comes from the launcher's environment."""
    from ldpc_tpu_torch.training.evaluator import ComparativeEvaluator

    mesh = None
    if cfg.mesh_data:
        import torch.distributed as dist

        from ldpc_tpu_torch.parallel import distributed_init, make_mesh

        distributed_init(backend="nccl" if device == "cuda" else "gloo")
        mesh = make_mesh(data=cfg.mesh_data, model=cfg.mesh_model)
        main_rank = dist.get_rank() == 0
    else:
        main_rank = True
    say = print if main_rank else (lambda *a, **k: None)
    bg, _, plan = _setup(cfg, device)
    encoder = _encoder(cfg, bg) if cfg.random_codewords else None
    ev = ComparativeEvaluator(
        plan,
        snr_range=cfg.eval_snr_range(),
        batch_size=cfg.batch_size,
        num_trials=cfg.num_trials,
        mesh=mesh,
        modulation=cfg.modulation,
        convention=cfg.convention,
        encoder=encoder,
        device=device,
    )
    if cfg.compare_with_traditional:
        ev.add_belief_propagation(cfg.bp_max_iterations)
        ev.add_min_sum(cfg.bp_max_iterations, cfg.ms_scaling_factor)
    model_types = [m for m in cfg.compare_models.split(",") if m] or [cfg.model_type]
    for mt in model_types:
        sub = cfg.replace(model_type=mt)
        tr = _trainer(sub, plan, device=device)
        path = Path(cfg.model_path)
        mt_path = path if len(model_types) == 1 else path.with_name(f"{mt}_{path.name}")
        if mt_path.exists():
            tr.load_model(mt_path)
            say(f"loaded {mt} model from {mt_path}")
        else:
            say(f"no checkpoint at {mt_path} — using fresh {mt} model")
        ev.add_model(f"Neural ({mt})", tr.model)
    if main_rank:
        ev.evaluate_all()
        ev.print_summary()
        out = Path(cfg.results_dir) / "comparison_results.json"
        ev.save_results(out)
        print(f"saved {out}")
    else:
        ev.evaluate_all(log=None)


def cmd_visualize(cfg: Config, device: str = "cuda") -> None:
    from ldpc_tpu_torch.visualization.plots import render_report

    results = Path(cfg.results_dir) / "comparison_results.json"
    if not results.exists():
        results = Path(cfg.results_dir) / "evaluation_results.json"
    if not results.exists():
        raise SystemExit(f"no results found under {cfg.results_dir} — run compare/evaluate first")
    written = render_report(results, cfg.results_dir, paper_style=cfg.paper_style)
    for p in written:
        print(f"wrote {p}")


def cmd_workflow(cfg: Config, device: str = "cuda") -> None:
    """train -> evaluate -> compare -> visualize, each stage timed."""
    for stage in (cmd_train, cmd_evaluate, cmd_compare, cmd_visualize):
        t0 = time.time()
        print(f"=== {stage.__name__[4:]} ===")
        stage(cfg, device)
        print(f"=== {stage.__name__[4:]} done in {time.time() - t0:.1f}s ===")


def cmd_bench(cfg: Config, device: str = "cuda") -> None:
    raise SystemExit("the port's bench is bench_torch.py, which comes with the port's first "
                     "benchmark (ROADMAP §A1); until then chip_smoke.py times every kernel")


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    dispatch = {
        "train": cmd_train,
        "evaluate": cmd_evaluate,
        "compare": cmd_compare,
        "visualize": cmd_visualize,
        "workflow": cmd_workflow,
        "bench": cmd_bench,
    }
    dispatch[args.mode](cfg, args.device)


if __name__ == "__main__":
    main()
