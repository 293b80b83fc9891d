"""The port's flax-msgpack reader and parameter conversion against
``flax.serialization`` on committed checkpoints: same keys, arrays identical
(dtype, shape and every value)."""
import struct
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from ldpc_tpu_torch import convert
from ldpc_tpu_torch.models import create_corrected_minsum_gnn_decoder
from ldpc_tpu_torch.ops import qc_msg as tqc
import ldpc_tpu_torch.codes as tcodes

RESULTS = Path(__file__).resolve().parent.parent / "results"
CHECKPOINTS = ["corrected_gnn_nr_2_0_4.msgpack", "corrected10_gnn_nr_2_0_32_ft3.msgpack"]


def _flat(tree):
    return {jax.tree_util.keystr(path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("name", CHECKPOINTS)
def test_reader_matches_flax(name):
    want = _flat(serialization.msgpack_restore((RESULTS / name).read_bytes()))
    got = _flat(convert.read_flax_msgpack(RESULTS / name))
    assert list(got) == list(want)
    assert len(got) == {"corrected_gnn_nr_2_0_4.msgpack": 119}.get(name, 229)
    for key, a in want.items():
        b = got[key]
        assert isinstance(b, np.ndarray) and b.dtype == a.dtype and b.shape == a.shape, key
        np.testing.assert_array_equal(b, a)


def test_reader_scalars_lists_and_errors(tmp_path):
    payload = {"n": 3, "neg": -2, "big": 70000, "f": 1.5, "s": "x" * 40, "none": None,
               "flag": True, "list": [1, "a", 2.0], "arr": np.arange(6, dtype=np.float64).reshape(2, 3)}
    path = tmp_path / "p.msgpack"
    path.write_bytes(serialization.msgpack_serialize(payload))
    got = convert.read_flax_msgpack(path)
    assert got["n"] == 3 and got["neg"] == -2 and got["big"] == 70000 and got["f"] == 1.5
    assert got["s"] == "x" * 40 and got["none"] is None and got["flag"] is True
    assert got["list"] == [1, "a", 2.0]
    np.testing.assert_array_equal(got["arr"], payload["arr"])
    # Type codes the reader does not know raise; it never guesses.
    for bad in (b"\xc1", b"\x81\xa1k\xd4\x05\x00",  # reserved code; ext type 5
                serialization.msgpack_serialize({"c": np.complex64(1 + 2j)})):
        path.write_bytes(bad)
        with pytest.raises(ValueError, match="unknown msgpack"):
            convert.read_flax_msgpack(path)
    path.write_bytes(serialization.msgpack_serialize(payload)[:-5])
    with pytest.raises(ValueError, match="ends inside"):
        convert.read_flax_msgpack(path)
    path.write_bytes(serialization.msgpack_serialize(payload) + struct.pack(">B", 1))
    with pytest.raises(ValueError, match="bytes follow"):
        convert.read_flax_msgpack(path)
    with pytest.raises(FileNotFoundError):
        convert.read_flax_msgpack(tmp_path / "missing.msgpack")


def test_load_message_gnn_fills_every_parameter():
    qc = tcodes.qc_layout(tcodes.get_base_graph("nr_2_0_4"), 4)
    plan = tqc.make_plan(qc, "cpu")
    model = create_corrected_minsum_gnn_decoder(plan, num_iterations=5, hidden_dim=64,
                                                input_injection=True)
    convert.load_message_gnn(RESULTS / "corrected_gnn_nr_2_0_4.msgpack", model)
    tree = serialization.msgpack_restore(
        (RESULTS / "corrected_gnn_nr_2_0_4.msgpack").read_bytes())["params"]["params"]
    sd = model.state_dict()
    assert len(sd) == len(jax.tree_util.tree_leaves(tree))
    k = tree["check_3_gnn"]["var_to_check_update"]["Dense_0"]["kernel"]  # (in, out)
    np.testing.assert_array_equal(sd["check_3_gnn.var_to_check_update.Dense_0.weight"].numpy(),
                                  k.T)
    np.testing.assert_array_equal(sd["var_4_proj.bias"].numpy(), tree["var_4_proj"]["bias"])
    assert float(sd["alpha"]) == float(tree["alpha"]) and sd["w_res"].shape == (0,)
    # a model of another depth does not load quietly
    wrong = create_corrected_minsum_gnn_decoder(plan, num_iterations=4, hidden_dim=64,
                                                input_injection=True)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        convert.load_message_gnn(RESULTS / "corrected_gnn_nr_2_0_4.msgpack", wrong)
    assert all(v.dtype == torch.float32 for v in sd.values())
