"""ldpc_tpu_torch.codes held against ldpc_tpu.codes: base graphs, QC layouts,
dense lifting, flat edge layouts, the GF(2) encoder, the copied assets and
the layout converter."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ldpc_tpu.codes as jcodes
import ldpc_tpu_torch.codes as tcodes
from ldpc_tpu_torch.convert import qc_layout_from_numpy

REPO = Path(__file__).resolve().parents[1]
LAYOUTS = [("toy_4x8", 4), ("nr_2_0_4", 4), ("nr_2_0_32", 32), ("nr_2_0_32", 384)]


def _assert_layouts_equal(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("name,Z", LAYOUTS)
def test_qc_layout_matches_jax(name, Z):
    j = jcodes.qc_layout(jcodes.get_base_graph(name), Z)
    t = tcodes.qc_layout(tcodes.get_base_graph(name), Z)
    _assert_layouts_equal(j, t)
    for prop in ("num_base_edges", "num_edges", "num_checks", "num_vars", "dr_max", "dv_max"):
        assert getattr(j, prop) == getattr(t, prop), prop
    np.testing.assert_array_equal(j.flat_edge_id_var_aligned(), t.flat_edge_id_var_aligned())


@pytest.mark.parametrize("name,Z", LAYOUTS)
def test_expand_base_matrix_matches_jax(name, Z):
    Hj = jcodes.expand_base_matrix(jcodes.get_base_graph(name), Z)
    Ht = tcodes.expand_base_matrix(tcodes.get_base_graph(name), Z)
    assert Hj.dtype == Ht.dtype and Hj.shape == Ht.shape
    step = 1024  # compare in row blocks: the Z=384 matrix is 16128 x 19968
    for r in range(0, Hj.shape[0], step):
        np.testing.assert_array_equal(Hj[r:r + step], Ht[r:r + step])


@pytest.mark.parametrize("name,Z", [("toy_4x8", 4), ("nr_2_0_32", 32)])
def test_convert_qc_layout_round_trips(name, Z):
    j = jcodes.qc_layout(jcodes.get_base_graph(name), Z)
    fields = {k: np.asarray(v) if isinstance(v, np.ndarray) else v
              for k, v in dataclasses.asdict(j).items()}
    converted = qc_layout_from_numpy(fields)
    _assert_layouts_equal(converted, tcodes.qc_layout(tcodes.get_base_graph(name), Z))
    back = qc_layout_from_numpy(dataclasses.asdict(converted))
    _assert_layouts_equal(back, converted)
    del fields["row_edges"]
    with pytest.raises(KeyError, match="row_edges"):
        qc_layout_from_numpy(fields)


@pytest.mark.parametrize("name", ["nr_2_0_32", "nr_2_0_4", "toy_4x8"])
def test_assets_are_byte_identical(name):
    a = (REPO / "ldpc_tpu" / "codes" / "data" / f"{name}.json").read_bytes()
    b = (REPO / "ldpc_tpu_torch" / "codes" / "data" / f"{name}.json").read_bytes()
    assert a == b


def test_registry_and_text_loader(tmp_path):
    assert tcodes.available_base_graphs() == jcodes.available_base_graphs()
    shifts = np.array([[0, -1, 3, 2], [1, 5, -1, 0]])
    path = tmp_path / "bg.txt"
    path.write_text("\n".join(" ".join(str(v) for v in row) for row in shifts) + "\n\n")
    t = tcodes.load_base_matrix(path)
    j = jcodes.load_base_matrix(path)
    assert t.name == j.name == "bg"
    np.testing.assert_array_equal(t.shifts, j.shifts)
    assert t.num_base_edges == j.num_base_edges == 6
    np.testing.assert_array_equal(t.unique_shift_types(4), j.unique_shift_types(4))
    with pytest.raises(KeyError):
        tcodes.get_base_graph("no_such_graph")


def test_base_graph_from_H_and_edge_layout():
    rng = np.random.default_rng(3)
    H = (rng.random((6, 10)) < 0.35).astype(np.int8)
    H[0, :] = 1  # no empty row
    bt, bj = tcodes.base_graph_from_H(H), jcodes.base_graph_from_H(H)
    np.testing.assert_array_equal(bt.shifts, bj.shifts)
    np.testing.assert_array_equal(tcodes.expand_base_matrix(bt, 1), H)
    for Hx in (H, jcodes.expand_base_matrix(jcodes.get_base_graph("toy_4x8"), 4)):
        lt, lj = tcodes.edge_layout_from_H(Hx), jcodes.edge_layout_from_H_numpy(Hx)
        _assert_layouts_equal(lt, lj)
        assert lt.num_edges == lj.num_edges
    with pytest.raises(ValueError, match="binary"):
        tcodes.base_graph_from_H(H * 2)


@pytest.mark.parametrize("name,Z", [("toy_4x8", 4), ("nr_2_0_4", 4)])
def test_encoder_matches_jax(name, Z):
    H = tcodes.expand_base_matrix(tcodes.get_base_graph(name), Z)
    et, ej = tcodes.encoder_from_H(H), jcodes.encoder_from_H(H)
    np.testing.assert_array_equal(et.generator, ej.generator)
    np.testing.assert_array_equal(et.info_cols, ej.info_cols)
    assert not ((et.generator.astype(np.int64) @ H.T.astype(np.int64)) % 2).any()

    info = np.random.default_rng(0).integers(0, 2, (5, et.k)).astype(np.float32)
    cw_t = et.encode(torch.from_numpy(info)).numpy()
    cw_j = np.asarray(ej.encode(info))
    np.testing.assert_array_equal(cw_t, cw_j)

    gen = torch.Generator(device="cpu").manual_seed(0)
    cw = et.random_codewords(gen, 16).numpy().astype(np.int64)
    assert cw.shape == (16, et.n) and cw.any()
    assert not ((cw @ H.T.astype(np.int64)) % 2).any()


def test_import_leaves_jax_out():
    """Every module of the port, found by walking the package, and
    chip_smoke.py import without JAX, flax, msgpack or ldpc_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ldpc_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(ldpc_tpu_torch.__path__, "
        "'ldpc_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'ldpc_tpu_torch.tools.bench_gnn_kernel' in names, names\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'msgpack', 'ldpc_tpu')]\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
