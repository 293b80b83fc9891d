"""The port's Config, CLI, plots and waterfall tool against the JAX package.

* ``Config`` writes the JAX package's JSON, string for string, and each
  package's file loads in the other.
* The parser has the JAX CLI's modes and option strings plus ``--device``,
  and a ``--no-x`` flag overrides a config file's ``true``.
* ``make_model`` builds every model type with the parameter count of the
  JAX CLI's model (its ``init`` evaluated abstractly: no compile).
* ``workflow`` runs end to end on the CPU; ``compare`` takes several model
  types; an unknown model type and ``bench`` exit.
* ``render_report`` writes the JAX package's file names; importing the
  package, the CLI and the trainer does not import matplotlib.
* The waterfall tool keeps the JAX tool's JSON keys and its trials rule, and
  ``plot_highprecision.adapt`` takes the JAX record as the JAX tool does.
"""
import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu import cli as jax_cli
from ldpc_tpu.config import Config as JaxConfig
from ldpc_tpu.visualization.plots import render_report as jax_render_report
from ldpc_tpu_torch import cli
from ldpc_tpu_torch.config import Config
from ldpc_tpu_torch.tools import high_precision_curve, plot_highprecision

REPO = Path(__file__).resolve().parent.parent
RESULTS = REPO / "results"
MODEL_TYPES = ["standard", "tied", "gnn", "base_graph_gnn", "message_gnn",
               "message_gnn_var_minsum", "message_gnn_check_minsum", "message_gnn_minsum",
               "message_gnn_corrected"]
TOY = ["--base-graph", "toy_4x8", "--lifting-factor", "4"]
NON_DEFAULT = dict(model_type="message_gnn_corrected", num_iterations=10, hidden_dim=32,
                   share_layers=True, base_graph="nr_2_0_32", lifting_factor=32,
                   modulation="bpsk", learning_rate=3e-4, snr_min=-4.0, snr_max=-1.0,
                   snr_step=0.5, optimizer="adam", compare_with_traditional=False,
                   compare_models="standard,tied", random_codewords=True, mesh_data=2,
                   model_path="ckpt/x.msgpack", paper_style=True)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load_jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---------------------------------------------------------------------------
# Config and the parser
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fields", [{}, NON_DEFAULT], ids=["default", "non_default"])
def test_config_json_equals_jax(fields, tmp_path):
    ours, theirs = Config(**fields), JaxConfig(**fields)
    assert ours.to_json() == theirs.to_json()
    assert [f.name for f in dataclasses.fields(Config)] == \
        [f.name for f in dataclasses.fields(JaxConfig)]
    assert ours.train_snr_range() == theirs.train_snr_range()
    assert ours.eval_snr_range() == theirs.eval_snr_range()
    (tmp_path / "ours.json").write_text(ours.to_json())
    (tmp_path / "theirs.json").write_text(theirs.to_json())
    assert dataclasses.asdict(JaxConfig.from_file(tmp_path / "ours.json")) == \
        dataclasses.asdict(ours)
    assert Config.from_file(tmp_path / "theirs.json") == ours
    assert ours.replace(seed=7).seed == 7 and ours.seed == theirs.seed


def test_parser_is_jax_plus_device(tmp_path):
    def options(parser):
        return {s for a in parser._actions for s in a.option_strings}

    ours, theirs = cli.build_parser(), jax_cli.build_parser()
    assert options(ours) == options(theirs) | {"--device"}
    mode = [a for a in ours._actions if a.dest == "mode"][0]
    assert mode.choices == [a for a in theirs._actions if a.dest == "mode"][0].choices
    assert ours.parse_args(["compare"]).device == "cuda"
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(Config(compare_with_traditional=True, batch_size=8).to_json())
    args = ours.parse_args(["compare", "--config", str(cfg_file),
                            "--no-compare-with-traditional", "--num-trials", "3"])
    cfg = cli.config_from_args(args)
    assert cfg.compare_with_traditional is False and cfg.batch_size == 8
    assert cfg.num_trials == 3
    jcfg = jax_cli.config_from_args(theirs.parse_args(
        ["compare", "--config", str(cfg_file), "--no-compare-with-traditional",
         "--num-trials", "3"]))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_make_model_parameter_count_equals_jax(model_type, one_thread):
    cfg = Config(model_type=model_type, base_graph="toy_4x8", lifting_factor=4,
                 num_iterations=2, hidden_dim=8)
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    _, _, plan = cli._setup(cfg, "cpu")
    _, _, jplan = jax_cli._setup(jcfg)
    model = cli.make_model(cfg, plan)
    jmodel = jax_cli.make_model(jcfg, jplan)
    n = jplan.C * jplan.Z
    shapes = jax.eval_shape(lambda k: jmodel.init(k, jnp.zeros((2, n)), jplan),
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == want > 0


# ---------------------------------------------------------------------------
# The modes
# ---------------------------------------------------------------------------


def test_workflow_end_to_end_on_cpu(tmp_path, one_thread, capsys):
    model_path = tmp_path / "ckpt" / "model.pt"
    out = tmp_path / "out"
    cli.main(["workflow", "--device", "cpu", *TOY, "--model-type", "tied", "--num-epochs", "2",
              "--batch-size", "16", "--snr-min", "1", "--snr-max", "2", "--snr-step", "1",
              "--num-trials", "2", "--bp-max-iterations", "10", "--validation-interval", "1",
              "--model-path", str(model_path), "--results-dir", str(out)])
    printed = capsys.readouterr().out
    for stage in ("train", "evaluate", "compare", "visualize"):
        assert f"=== {stage} done in" in printed
    assert model_path.exists()
    results = json.loads((out / "comparison_results.json").read_text())
    assert results["snr_range"] == [1.0, 2.0]
    assert list(results["decoders"]) == ["Belief Propagation", "Min-Sum Scaled", "Neural (tied)"]
    assert results["decoders"]["Neural (tied)"]["param_count"] == 21
    evaluation = json.loads((out / "evaluation_results.json").read_text())
    assert evaluation["decoders"]["tied"]["param_count"] == 21
    assert len(evaluation["decoders"]["tied"]["ber"]) == 2
    history = json.loads((out / "training_history.json").read_text())
    assert len(history["train_losses"]) == 2 and len(history["val_losses"]) == 2
    assert (out / "combined_comparison.png").stat().st_size > 0
    assert f"loaded tied model from {model_path}" in printed


def test_compare_several_models_and_exits(tmp_path, one_thread, capsys):
    cli.main(["compare", "--device", "cpu", *TOY, "--compare-models", "standard,tied,message_gnn",
              "--hidden-dim", "8", "--num-iterations", "2", "--snr-min", "2", "--snr-max", "2",
              "--batch-size", "8", "--num-trials", "1", "--bp-max-iterations", "5",
              "--model-path", str(tmp_path / "m.pt"), "--results-dir", str(tmp_path)])
    results = json.loads((tmp_path / "comparison_results.json").read_text())
    assert len(results["decoders"]) == 5
    assert "no checkpoint at " + str(tmp_path / "message_gnn_m.pt") in capsys.readouterr().out
    with pytest.raises(SystemExit, match="unknown --model-type 'nope'"):
        cli.main(["compare", "--device", "cpu", *TOY, "--model-type", "nope"])
    with pytest.raises(SystemExit, match="§A1"):
        cli.main(["bench", "--device", "cpu"])
    if not torch.cuda.is_available():  # the default device is the card: no quiet CPU run
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["train", *TOY, "--model-type", "tied", "--num-epochs", "1",
                      "--results-dir", str(tmp_path / "never")])


def test_evaluate_counts_parameters(tmp_path, one_thread, capsys):
    cli.main(["evaluate", "--device", "cpu", *TOY, "--model-type", "message_gnn",
              "--hidden-dim", "8", "--num-iterations", "2", "--snr-min", "2", "--snr-max", "3",
              "--batch-size", "8", "--num-trials", "1", "--random-codewords",
              "--model-path", str(tmp_path / "none.pt"), "--results-dir", str(tmp_path)])
    entry = json.loads((tmp_path / "evaluation_results.json").read_text())["decoders"]
    _, _, plan = cli._setup(Config(base_graph="toy_4x8", lifting_factor=4), "cpu")
    model = cli.make_model(Config(model_type="message_gnn", hidden_dim=8, num_iterations=2),
                           plan)
    assert entry["message_gnn"]["param_count"] == sum(p.numel() for p in model.parameters())
    assert len(entry["message_gnn"]["ber"]) == 2
    assert "evaluating untrained model" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Plots, and what the package imports without them
# ---------------------------------------------------------------------------


def test_render_report_writes_jax_names(tmp_path):
    from ldpc_tpu_torch.visualization import render_report

    src = RESULTS / "nr_2_0_4_comparison.json"
    ours = render_report(src, tmp_path / "ours", paper_style=True)
    theirs = jax_render_report(src, tmp_path / "theirs")
    assert [p.name for p in ours] == [p.name for p in theirs]
    assert {p.name for p in ours} == {f"{k}_comparison.png"
                                      for k in ("ber", "fer", "iterations", "combined")}
    assert all(p.stat().st_size > 0 for p in ours)


def test_trainer_plots(one_thread):
    from ldpc_tpu_torch.models import make_tied_decoder
    from ldpc_tpu_torch.training import LDPCDecoderTrainer

    _, _, plan = cli._setup(Config(base_graph="toy_4x8", lifting_factor=4), "cpu")
    tr = LDPCDecoderTrainer(make_tied_decoder(plan, 2, 2), plan, device="cpu")
    tr.train_losses, tr.val_losses = [3.0, 2.0, 1.5], [2.5]
    tr.ber_history, tr.fer_history = [0.1], [0.5]
    loss_fig, rate_fig = tr.plot_training_history()
    assert len(loss_fig.axes[0].lines) == 2 and rate_fig is not None
    ber_fig, fer_fig = tr.plot_snr_performance([0.0, 1.0], [0.1, 0.01], [0.5, 0.1],
                                               comparison_ber=[0.2, 0.05])
    assert len(ber_fig.axes[0].lines) == 2 and len(fer_fig.axes[0].lines) == 1
    import matplotlib.pyplot as plt

    for fig in (loss_fig, rate_fig, ber_fig, fer_fig):
        plt.close(fig)


def test_package_cli_and_trainer_import_without_matplotlib():
    code = ("import sys\n"
            "sys.modules['matplotlib'] = None\n"
            "import ldpc_tpu_torch, ldpc_tpu_torch.cli, ldpc_tpu_torch.training\n"
            "import ldpc_tpu_torch.tools.high_precision_curve, ldpc_tpu_torch.run_sharded_sweep\n"
            "import ldpc_tpu_torch.tools.plot_highprecision\n"
            "print('imported')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0 and out.stdout.strip() == "imported", out.stderr


# ---------------------------------------------------------------------------
# The waterfall tool
# ---------------------------------------------------------------------------


def test_waterfall_tool_keys_and_trials_rule(tmp_path, one_thread):
    record = json.loads((RESULTS / "nr_2_0_32_minsum_highprecision.json").read_text())
    out = tmp_path / "curve.json"
    batch, bits, iters = 4, 2e4, 5
    res = high_precision_curve.main(["--device", "cpu", "--batch", str(batch),
                                     "--bits-per-point", str(bits), "--iters", str(iters),
                                     "--out", str(out)])
    assert json.loads(out.read_text()) == res
    assert set(record) <= set(res)
    n = 1664  # nr_2_0_32 at Z=32
    trials = max(1, int(bits / (batch * n)))
    assert res["trials_per_point"] == trials == 3
    assert res["bits_per_point"] == trials * batch * n
    assert res["snr"] == record["snr"] and res["code"] == record["code"]
    assert (res["iterations"], res["batch"], res["device"], res["nvidia_smi"]) == \
        (iters, batch, "cpu", None)
    assert res["ber"][0] > res["ber"][-1] and res["fer"][0] == 1.0
    assert res["ber"] == [be / res["bits_per_point"] for be in res["bit_errors"]]


def test_plot_highprecision_adapts_the_jax_record(tmp_path):
    raw = json.loads((RESULTS / "nr_2_0_32_minsum_highprecision.json").read_text())
    jax_tool = _load_jax_tool("plot_highprecision")
    assert plot_highprecision.adapt(raw) == jax_tool.adapt(raw)
    flagship = json.loads((RESULTS / "nr_2_0_32_corrected10_ft3_highprecision.json").read_text())
    assert plot_highprecision.adapt(flagship) == jax_tool.adapt(flagship)
    copy = tmp_path / "record.json"
    copy.write_text(json.dumps(raw))
    assert plot_highprecision.main([str(copy), "--paper-style"]) == [tmp_path / "record.png"]
    assert (tmp_path / "record.png").stat().st_size > 0
