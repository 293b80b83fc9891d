"""The serving entry point ``python -m ldpc_tpu_torch.serve_trained_decoder``
on the CPU (the kernels' plain versions) for all three model families on the
committed nr_2_0_4 checkpoints, and its refusal to run without a card unless
asked for the CPU."""
from pathlib import Path

import pytest
import torch

from ldpc_tpu_torch import serve_trained_decoder

RESULTS = Path(__file__).resolve().parent.parent / "results"


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions run many small operations; with several test
    workers on one machine, torch's per-operation thread pools fight over
    the cores and a serving case can take a hundred times longer.  One
    thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("model,ckpt,max_ber", [
    ("neural_minsum", "standard_nr_2_0_4", 0.05),
    ("corrected_gnn", "corrected_gnn_nr_2_0_4", 0.05),
    ("message_gnn", "message_gnn_nr_2_0_4", 0.2),
])
def test_serves_on_the_cpu(model, ckpt, max_ber):
    out = serve_trained_decoder.main(["--device", "cpu", "--batch", "8", "--model", model,
                                      "--checkpoint", str(RESULTS / f"{ckpt}.msgpack")])
    assert out["device"] == "cpu" and out["model"] == model and out["batch"] == 8
    assert 0.0 <= out["ber"] <= max_ber and 0.0 <= out["fer"] <= 1.0
    assert out["bits_per_s"] > 0 and out["ms_per_batch"] > 0


def test_raises_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_trained_decoder.main(["--batch", "8", "--checkpoint",
                                    str(RESULTS / "standard_nr_2_0_4.msgpack")])


def test_checkpoint_must_match_the_model():
    with pytest.raises(RuntimeError, match="size mismatch"):
        serve_trained_decoder.main(["--device", "cpu", "--batch", "8", "--checkpoint",
                                    str(RESULTS / "tied_nr_2_0_4.msgpack")])


def test_refuses_a_code_the_fused_kernels_do_not_take():
    """As the JAX example asserts ``fused_kernel_fits``: nr_2_0_32 at Z=384
    is served by fused_zlane only."""
    with pytest.raises(ValueError, match="not served by the fused kernels"):
        serve_trained_decoder.main(["--device", "cpu", "--code", "nr_2_0_32", "--Z", "384",
                                    "--checkpoint", str(RESULTS / "standard_nr_2_0_4.msgpack")])
