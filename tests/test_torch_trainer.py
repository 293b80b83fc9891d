"""``LDPCDecoderTrainer`` and ``CheckpointManager`` of the port.

Against optax and the JAX trainer, from identical parameters and batches:

* two updates of optax's chain as the JAX trainer builds it
  (``clip_by_global_norm``, ``add_decayed_weights``, then ``sgd`` with
  momentum or ``adam``) against the port's ``make_optimizer`` and
  ``train_step``, on a ``NeuralMinSumDecoder`` whose gradients match
  ``jax.grad`` within 1.1e-6 (``tests/test_torch_train_grad.py``), with the
  clip active: the loss within 1e-6, the clipped gradients within 2e-6
  relative (``clip_grad_norm_`` divides by the norm plus 1e-6, optax by the
  norm) and the parameters within atol 2e-7 + rtol 1e-6 after each update;
* ``warmup_cosine_factor`` times the peak against
  ``optax.warmup_cosine_decay_schedule`` step by step, within float32
  rounding: 2e-6 of the peak rate (optax evaluates in float32, and near the
  cosine's end its 1 + cos(x) cancels), with no warm-up (a first rate of 0)
  and at ``num_steps=1``;
* the history JSON's keys against the JAX trainer's.

On its own: ``train`` lowers the loss (the port of tests/test_gnn.py's
``test_trains``); a ``train_steps`` run saved after k steps and resumed for
k more (through ``save_state`` or a ``CheckpointManager``) is bit-identical
to 2k steps uninterrupted; a first update at rate 0 changes nothing;
``save_model``/``load_model`` round-trip and ``load_model`` reads the
committed flax checkpoints; the manager keeps its last 3 of 5 saves.
All on one torch thread, at toy_4x8 and nr_2_0_4 Z=4.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_gnn_parity import both_plans
from test_torch_neural_min_sum import nms_pair
from test_torch_parity import bpsk_llrs
from test_torch_train_grad import jitted_value_and_grad, truth_bits

from ldpc_tpu.models.gnn import make_gnn_decoder as jax_gnn
from ldpc_tpu.training import LDPCDecoderTrainer as JaxTrainer
from ldpc_tpu_torch import convert
from ldpc_tpu_torch.codes import encoder_from_H, expand_base_matrix, get_base_graph
from ldpc_tpu_torch.models import (create_corrected_minsum_gnn_decoder, make_gnn_decoder,
                                   make_tied_decoder)
from ldpc_tpu_torch.training import CheckpointManager, LDPCDecoderTrainer
from ldpc_tpu_torch.training.trainer import make_optimizer, train_step, warmup_cosine_factor
from ldpc_tpu_torch.utils.metrics import MetricsRegistry

RESULTS = Path(__file__).resolve().parent.parent / "results"


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# Against optax
# ---------------------------------------------------------------------------


def _optax_chain(optimizer: str, lr: float, momentum: float, wd: float, clip: float):
    opt = optax.sgd(lr, momentum=momentum) if optimizer == "sgd" else optax.adam(lr)
    return optax.chain(optax.clip_by_global_norm(clip), optax.add_decayed_weights(wd), opt)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_updates_match_optax(one_thread, optimizer):
    _, pj, qt, pt = both_plans("toy_4x8", 4)
    llr = bpsk_llrs(qt.num_vars, 6, 1.0, seed=8)
    truth = truth_bits(llr.shape, seed=9)
    mj, params, mt = nms_pair(pj, pt, llr, seed=5, num_iterations=3, depth_L=2,
                              weight_sharing="type", learnable_alpha=True,
                              learnable_offset=True, per_iteration=True)
    lr, momentum, wd = 1e-2, 0.9, 1e-2
    _, grads = jitted_value_and_grad(mj, params, jnp.asarray(llr), pj, jnp.asarray(truth))
    clip = 0.5 * float(optax.global_norm(grads))  # the clip acts
    tx = _optax_chain(optimizer, lr, momentum, wd, clip)
    state = tx.init(params)
    opt = make_optimizer(mt.parameters(), optimizer, lr, wd, momentum)
    llr_t, truth_t = torch.from_numpy(llr), torch.from_numpy(truth)
    for _ in range(2):  # the second update reads the momentum / moments
        loss_j, grads = jitted_value_and_grad(mj, params, jnp.asarray(llr), pj,
                                              jnp.asarray(truth))
        clipped, _ = optax.clip_by_global_norm(clip).update(grads, optax.EmptyState())
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        loss_t = train_step(mt, pt, opt, llr_t, truth_t, grad_clip=clip)
        assert abs(float(loss_t) - float(loss_j)) <= 1e-6
        want_g = convert.neural_min_sum_state_dict_from_numpy(clipped)
        want_p = convert.neural_min_sum_state_dict_from_numpy(params)
        for name, p in mt.named_parameters():
            g = want_g[name].numpy()
            err = np.abs(p.grad.numpy() - g).max() / np.abs(g).max()
            assert err <= 2e-6, (name, err)
            np.testing.assert_allclose(p.detach().numpy(), want_p[name].numpy(),
                                       rtol=1e-6, atol=2e-7, err_msg=name)


@pytest.mark.parametrize("lr,warmup,num_steps", [(3e-4, 0, 20), (1e-3, 5, 20), (1e-2, 0, 1),
                                                 (2e-3, 3, 4), (5e-4, 10, 100)])
def test_schedule_matches_optax(lr, warmup, num_steps):
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, max(warmup, 1), max(num_steps, 2))
    steps = range(max(num_steps, 2) + 3)
    got = np.array([lr * warmup_cosine_factor(k, warmup, num_steps) for k in steps])
    want = np.array([float(sched(k)) for k in steps])
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * lr)
    assert got[0] == 0.0  # optax's first update has rate 0, warm-up or not
    with pytest.raises(ValueError):
        warmup_cosine_factor(0, 5, 5)


def test_history_json_has_jax_keys(one_thread, tmp_path):
    plan = both_plans("toy_4x8", 4)[1]
    JaxTrainer(jax_gnn(num_iterations=1, depth_L=0), plan).save_history_json(tmp_path / "j.json")
    trainer = LDPCDecoderTrainer(make_gnn_decoder(both_plans("toy_4x8", 4)[3], 1, 0),
                                 both_plans("toy_4x8", 4)[3], device="cpu")
    trainer.save_history_json(tmp_path / "t.json")
    want = json.loads((tmp_path / "j.json").read_text())
    assert json.loads((tmp_path / "t.json").read_text()) == want
    assert list(want) == ["train_losses", "val_losses", "ber_history", "fer_history"]


# ---------------------------------------------------------------------------
# The trainer's own behaviour
# ---------------------------------------------------------------------------


def test_train_lowers_the_loss(one_thread):
    _, _, _, pt = both_plans("toy_4x8", 4)
    trainer = LDPCDecoderTrainer(make_gnn_decoder(pt, 3, 2), pt, seed=0, device="cpu")
    metrics = MetricsRegistry()
    hist = trainer.train(num_epochs=10, batch_size=16, learning_rate=0.01, snr_range=[2.0, 4.0],
                         validation_interval=5, log=None, metrics=metrics)
    losses = hist["train_losses"]
    assert len(losses) == 10 and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert len(hist["val_losses"]) == len(hist["ber_history"]) == 2
    assert metrics.counters["train_steps"] == 20 and len(metrics.series["val_loss"]) == 2


def _flagship_like(seed: int = 3):
    """A corrected GNN with injection and remat at nr_2_0_4 Z=4, its trainer
    drawing random codewords (the flagship fine-tune's recipe in miniature)."""
    _, _, qt, pt = both_plans("nr_2_0_4", 4)
    model = create_corrected_minsum_gnn_decoder(pt, num_iterations=2, hidden_dim=8,
                                                input_injection=True, remat=True,
                                                generator=torch.Generator().manual_seed(seed))
    enc = encoder_from_H(expand_base_matrix(get_base_graph("nr_2_0_4"), 4))
    return LDPCDecoderTrainer(model, pt, seed=seed, encoder=enc, device="cpu")


FT = dict(batch_size=4, learning_rate=3e-3, snr_range=[-1.0, 2.0], grad_clip=1.0, scan_steps=2,
          weight_decay=1e-4)


@pytest.mark.parametrize("via", ["save_state", "manager"])
def test_resume_is_bit_identical(one_thread, tmp_path, via):
    mgr = CheckpointManager(tmp_path / "ckpts")
    whole = _flagship_like()
    path = tmp_path / "state.pt"

    def save():
        if whole.step == 2:
            whole.save_state(path) if via == "save_state" else whole.save_checkpoint(mgr)

    metrics = MetricsRegistry()
    whole.train_steps(4, checkpoint_fn=save, metrics=metrics, **FT)
    assert metrics.counters["train_steps"] == 4 and len(metrics.series["train_loss"]) == 2
    assert metrics.gauges["train_steps_per_s"] > 0
    resumed = _flagship_like(seed=9)  # other initial weights and data: all restored
    resumed.load_state(path) if via == "save_state" else resumed.load_checkpoint(mgr)
    assert resumed.step == 2 and resumed.train_losses == whole.train_losses[:2]
    resumed.train_steps(4, **FT)
    assert resumed.train_losses == whole.train_losses
    for (name, a), b in zip(whole.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert torch.equal(whole.data_generator.get_state(), resumed.data_generator.get_state())


def test_first_update_at_rate_zero_changes_nothing(one_thread):
    trainer = _flagship_like()
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.train_steps(1, **FT)  # warm-up 0: the schedule starts at 0
    assert all(torch.equal(v, before[k]) for k, v in trainer.model.state_dict().items())
    assert trainer.opt_state and trainer.step == 1
    trainer.train_steps(3, **FT)  # carries on from update 1 at a positive rate
    assert trainer.step == 3 and len(trainer.train_losses) == 3
    assert any(not torch.equal(v, before[k]) for k, v in trainer.model.state_dict().items())


def test_data_modes_and_validation(one_thread):
    trainer = _flagship_like()
    with pytest.raises(ValueError):
        trainer.train_steps(1, data_mode="noise", **FT)
    with pytest.raises(ValueError):
        LDPCDecoderTrainer(make_gnn_decoder(trainer.plan), trainer.plan, device="cpu").train(
            1, 4, 0.01, data_mode="random_codewords")
    first = trainer.validate(4, [0.0, 2.0], "random_codewords")
    assert first == trainer.validate(4, [0.0, 2.0], "random_codewords")  # a fixed set
    assert all(np.isfinite(first)) and 0.0 <= first[1] <= 0.5
    bers, fers = trainer.evaluate_snr_range([1.0, 3.0], 4, 2, use_encoder=True)
    assert (bers, fers) == trainer.evaluate_snr_range([1.0, 3.0], 4, 2, use_encoder=True)
    assert len(bers) == len(fers) == 2 and all(0.0 <= f <= 1.0 for f in fers)


def test_save_and_load_model(one_thread, tmp_path):
    trainer = _flagship_like()
    trainer.train_steps(3, **FT)
    trainer.save_model(tmp_path / "m.pt")
    other = _flagship_like(seed=5)
    other.load_model(tmp_path / "m.pt")
    assert other.train_losses == trainer.train_losses
    for (name, a), b in zip(trainer.model.state_dict().items(), other.model.state_dict().values()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("name,kind", [("corrected_gnn_nr_2_0_4.msgpack", "corrected"),
                                       ("tied_nr_2_0_4.msgpack", "tied")])
def test_load_model_reads_flax_checkpoints(one_thread, name, kind):
    """results/*.msgpack through ``load_model`` equal the strict loaders of
    ``convert``, and the stored history comes along."""
    _, _, _, pt = both_plans("nr_2_0_4", 4)
    if kind == "corrected":
        def build():
            return create_corrected_minsum_gnn_decoder(pt, num_iterations=5, hidden_dim=64,
                                                       input_injection=True)
        load = convert.load_message_gnn
    else:
        def build():
            return make_tied_decoder(pt, num_iterations=5, depth_L=2, learnable_alpha=True)
        load = convert.load_neural_min_sum
    trainer = LDPCDecoderTrainer(build(), pt, device="cpu")
    trainer.load_model(RESULTS / name)
    ref = build()
    load(RESULTS / name, ref)
    for (key, a), b in zip(ref.state_dict().items(), trainer.model.state_dict().values()):
        assert torch.equal(a, b), key
    stored = convert.read_flax_msgpack(RESULTS / name).get("history", {})
    assert trainer.train_losses == [float(x) for x in np.asarray(stored.get("train_losses", []))]


def test_checkpoint_manager_keeps_the_last(tmp_path):
    mgr = CheckpointManager(tmp_path, max_to_keep=3)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    for step in (10, 20, 30, 40, 50):
        mgr.save(step, params={"w": torch.full((2,), float(step))}, opt_state={0: {}},
                 history={"train_losses": [float(step)]})
    assert mgr.all_steps() == [30, 40, 50] and mgr.latest_step() == 50
    for step in (30, 40, 50):
        payload = mgr.restore(step)
        assert torch.equal(payload["params"]["w"], torch.full((2,), float(step)))
        assert payload["history"]["train_losses"] == [float(step)]
    with pytest.raises(FileNotFoundError):
        mgr.restore(20)
    # a write cut short leaves a temporary file that no listing takes
    (tmp_path / "60").mkdir()
    (tmp_path / "60" / "checkpoint.pt.tmp123").write_bytes(b"partial")
    assert mgr.latest_step() == 50 and mgr.restore()["params"]["w"][0] == 50.0
    mgr.close()
