"""``Trainer(steps_per_execution=K)`` of the port against its K = 1 and against the JAX ``Trainer`` (CPU).

On the CPU the chunked path runs its steps eagerly (a CUDA graph needs the card; the card tests in
``tests/test_torch_cuda.py`` hold the graphed step to the eager one there). Held here:

- (i) K = 2 and 3 against K = 1 of the port, bit for bit on one CPU thread: the logged losses, every
  parameter and running statistic, the optimizer's state and the generator's state, over batches with a
  shape change and leftovers, at dropout 0.1 with dither and SpecAugment, and with accumulation, both
  clips, a schedule and the fine-tuning freeze;
- (ii) K = 2 against the JAX ``Trainer(steps_per_execution=2)`` on the same batches from the same weights
  (``test_torch_trainer_features.py``'s harness and tolerances: every parameter and running statistic within
  1e-5, the losses and the validation loss at rtol 1e-5): AdamW (lr 1e-4 and eps 1e-4, the features tests'
  eps, so that an update of a float32-noise gradient stays below lr), and SGD with ``accumulate_grad_batches=2``,
  both clips, ``onecycle`` and ``FinetuneEncoderDecoder``, and SGD with the plateau;
- (iii) a gloo mesh of 2 ranks with K = 2 (``tests/torch_parallel_worker.py``): ``batch_size=3`` over 4
  items (the JAX package's ``tests/test_train_scan.py`` layout: a padded batch and a 1-row leftover, flushed
  on the shape change), over 7 items (a chunk of two padded batches stacked and sharded on axis 1 with
  ``stacked_batch_sharding``, and a leftover), and a 4-row batch then a 3-row one (one chunk of the same shapes
  and other weights: unpadded, then padded to 4), against the meshless port (losses rtol 1e-5, parameters atol
  1e-5: the data group sums in another order) and the JAX mesh run's losses on 2 devices (rtol 1e-5), with
  SGD at lr 1e-4 and momentum 0.9; and the mesh step's host part: the loss share's factor as a float32
  tensor against the host number, bit for bit, and ``GraphedTrainStep.rows_step`` as rank 0 of a larger data
  axis (padding rows of weight 0 and zero length) against ``TrainStep.rows_step`` on a one-rank gloo mesh;
- (iv) a K = 2 run checkpointed after epoch 1 and resumed with K = 1 against the uninterrupted run, bit for bit;
- (v) the grouping (``chunk_batches``) against the JAX ``fit``'s dispatches on a sequence of shapes over two
  epochs: the same batches in the same chunks, in the same order;
- ``ErrorRate.reset`` against the JAX class's.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parallel as P
import thunder_tpu.training.trainer as jax_trainer_module
import torch_parallel_worker as W
from thunder_tpu.audio import FilterbankFeatures as JaxFilterbank
from thunder_tpu.models import Conv1dDecoder as JaxDecoder
from thunder_tpu.models import QuartznetEncoder as JaxQuartznet
from thunder_tpu.ops import calculate_ctc as jax_calculate_ctc
from thunder_tpu.module import CTCModule as JaxModule
from thunder_tpu.parallel import make_mesh as jax_make_mesh
from thunder_tpu.text import BatchTextTransformer as JaxText
from thunder_tpu.training import FinetuneEncoderDecoder as JaxFinetune
from thunder_tpu.training import Trainer as JaxTrainer
from thunder_tpu.training import metrics as jax_metrics
from thunder_tpu.training import optim as jax_optim
from thunder_tpu_torch.audio import FilterbankFeatures
from thunder_tpu_torch.bridge import from_flax_variables
from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
from thunder_tpu_torch.module import CTCModule
from thunder_tpu_torch.text import BatchTextTransformer
from thunder_tpu_torch.training import metrics, optim
from thunder_tpu_torch.training.trainer import (
    FinetuneEncoderDecoder,
    GraphedTrainStep,
    Trainer,
    _host_batch,
    chunk_batches,
)

TOKENS = list("abcdefghijklmnopqrstuvwxyz '")
SMALL = dict(repeat=1, filters=(64,), kernel_sizes=(33,))
WEIGHT_TOL = 1e-5
LOSS_RTOL = 1e-5


@pytest.fixture()
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches(samples, seed=0, rows=2):
    """One batch of ``rows`` rows a length in ``samples``, the last row shorter."""
    rng = np.random.default_rng(seed)
    words = ["hello world", "the cat", "a dog", "sat on the mat", "quick", "brown fox"]
    out = []
    for i, n in enumerate(samples):
        audio = (rng.standard_normal((rows, n)) * 0.2).astype(np.float32)
        lengths = np.full(rows, n, np.int32)
        lengths[-1] = int(rng.integers(n // 2, n))
        out.append((audio, lengths, [words[(i + r) % len(words)] for r in range(rows)]))
    return out


#: a shape change (a flush), chunks of 2 and 3, and leftovers at the change and at the epoch's end
SHAPES = [8000] * 4 + [6000] + [8000] * 3


def _port_module(dropout=0.1):
    return CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(num_time_masks=1, num_freq_masks=1),
                            QuartznetEncoder(**SMALL, dropout=dropout), Conv1dDecoder(len(TOKENS) + 1),
                            BatchTextTransformer(TOKENS), device="cpu")


def _fit(k, module, loader, epochs=2, val=None, **kw):
    trainer = Trainer(max_epochs=epochs, log_every=1, device="cpu", seed=3, steps_per_execution=k, **kw)
    fitted = trainer.fit(module, loader, val_loader=val)
    return trainer, fitted


def _losses(trainer):
    return [e["loss/train_loss"] for e in trainer.logs if "loss/train_loss" in e]


def _assert_same_tree(a, b, path="state"):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for key in a:
            _assert_same_tree(a[key], b[key], f"{path}/{key}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}/{i}")
    else:
        assert a == b, path


FEATURES = dict(accumulate_grad_batches=2, gradient_clip_value=0.05, gradient_clip_norm=1.0,
                lr_scheduler_builder=optim.onecycle, lr_scheduler_kwargs={"max_lr": 1e-3, "total_steps_arg": "total_steps"})


# ---- (i) K against K = 1 of the port, bit for bit


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("settings", ["adamw", "features"])
def test_steps_per_execution_equals_one_step_a_dispatch(one_thread, k, settings):
    kw = dict(FEATURES, callbacks=[FinetuneEncoderDecoder(unfreeze_encoder_at_epoch=1, encoder_initial_lr_div=2.0)]) \
        if settings == "features" else {}
    loader = _batches(SHAPES)
    one, _ = _fit(1, _port_module(), loader, **kw)
    many, _ = _fit(k, _port_module(), loader, **kw)
    assert _losses(many) == _losses(one) and len(_losses(one)) == 2 * len(loader)
    assert [e["lr"] for e in many.logs if "lr" in e] == [e["lr"] for e in one.logs if "lr" in e]
    _assert_same_tree(many.train_state(), one.train_state())
    # on the CPU every step runs eagerly, and is counted so
    assert (many.eager_steps, many.replayed_steps) == (2 * len(loader), 0)


def test_graphed_train_step_runs_eagerly_on_the_cpu(one_thread):
    module = _port_module()
    loader = _batches(SHAPES[:2])
    step, generator, _ = Trainer(device="cpu", steps_per_execution=2).train_step_for(module, loader)
    assert isinstance(step, GraphedTrainStep) and not step._graphable(torch.zeros(1))
    step(*(torch.as_tensor(a) for a in (loader[0][0], loader[0][1])),
         *(torch.as_tensor(a) for a in module.text_transform.encode(loader[0][2], pad_to=32)), generator)
    assert (step.calls, step.steps, step.eager_steps, step.replayed_steps) == (1, 1, 1, 0)


# ---- (ii) K = 2 against the JAX Trainer(steps_per_execution=2)


def _randomized(module, seed=0):
    rng = np.random.default_rng(seed)
    flat = flax.traverse_util.flatten_dict(module.variables)
    for key, v in flat.items():
        if key[-1] == "var":
            flat[key] = jnp.asarray(rng.uniform(0.5, 2.0, v.shape).astype(np.float32))
        elif key[-1] == "mean" or (key[-1] in ("scale", "bias") and "bn" in key):
            flat[key] = jnp.asarray((rng.standard_normal(v.shape) * 0.3).astype(np.float32))
    return module.with_variables(flax.traverse_util.unflatten_dict(flat))


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    tt = JaxText(tokens=TOKENS)
    jax_module = _randomized(JaxModule.create(jax.random.PRNGKey(0), audio_transform=JaxFilterbank(dither=0.0),
                                              encoder=JaxQuartznet(**SMALL), decoder=JaxDecoder(num_classes=tt.num_tokens),
                                              text_transform=tt, sample_len=4000))
    port = CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(dither=0.0), QuartznetEncoder(**SMALL),
                            Conv1dDecoder(len(TOKENS) + 1), BatchTextTransformer(TOKENS), device="cpu")
    return jax_module, port.with_state(from_flax_variables(_numpy(jax_module.variables)))


SGD = dict(optimizer_kwargs={"learning_rate": 0.01, "momentum": 0.9})
JAX_CASES = {
    # lr 1e-4: the ten updates move the weights by about 1e-3, and the packages stay within 6e-7 of each other
    # (at 1e-3 the small model's AdamW training drifts to 7e-4 apart over the ten steps)
    "adamw": (2, dict(optimizer_kwargs={"learning_rate": 1e-4, "eps": 1e-4}), {}),
    "accumulate_clips_onecycle_finetune": (2, dict(SGD, accumulate_grad_batches=2, gradient_clip_value=0.01,
                                                   gradient_clip_norm=0.05),
                                           {"onecycle": {"max_lr": 0.02, "total_steps_arg": "total_steps"},
                                            "finetune": dict(unfreeze_encoder_at_epoch=1, encoder_initial_lr_div=4.0)}),
    "plateau": (3, SGD, {"plateau": {"factor": 0.5, "patience": 1}}),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_steps_per_execution_matches_jax(pair, case):
    epochs, common, extra = JAX_CASES[case]
    common = dict(common)
    jax_kw, port_kw = {}, {}
    if "momentum" in common["optimizer_kwargs"]:
        jax_kw["optimizer_builder"], port_kw["optimizer_builder"] = jax_optim.sgd, optim.sgd
    if "onecycle" in extra:
        jax_kw.update(lr_scheduler_builder=jax_optim.onecycle, lr_scheduler_kwargs=dict(extra["onecycle"]))
        port_kw.update(lr_scheduler_builder=optim.onecycle, lr_scheduler_kwargs=dict(extra["onecycle"]))
    if "plateau" in extra:
        jax_kw.update(lr_scheduler_builder=jax_optim.reduce_on_plateau, lr_scheduler_kwargs=dict(extra["plateau"]))
        port_kw.update(lr_scheduler_builder=optim.reduce_on_plateau, lr_scheduler_kwargs=dict(extra["plateau"]))
    if "finetune" in extra:
        jax_kw["callbacks"] = [JaxFinetune(**extra["finetune"])]
        port_kw["callbacks"] = [FinetuneEncoderDecoder(**extra["finetune"])]
    train = _batches([8000, 8000, 8000, 6000, 8000], seed=1)
    val = _batches([8000], seed=2)
    jax_module, port = pair
    jt = JaxTrainer(max_epochs=epochs, log_every=1, steps_per_execution=2, **common, **jax_kw)
    jm = jt.fit(jax_module, train_loader=train, val_loader=val)
    pt = Trainer(max_epochs=epochs, log_every=1, device="cpu", steps_per_execution=2, **common, **port_kw)
    pm = pt.fit(port, train, val_loader=val)
    want = from_flax_variables(_numpy(jm.variables))
    got = pm.model.state_dict()
    assert set(want) == set(got)
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=WEIGHT_TOL, msg=name)
    np.testing.assert_allclose(_losses(pt), [e["loss/train_loss"] for e in jt.logs if "loss/train_loss" in e],
                               rtol=LOSS_RTOL)
    for key in ("loss/val_loss", "lr_scale/plateau"):
        want_val = [e[key] for e in jt.logs if key in e]
        np.testing.assert_allclose([e[key] for e in pt.logs if key in e], want_val, rtol=LOSS_RTOL)
        assert want_val or key == "lr_scale/plateau"


# ---- (iii) a gloo mesh of 2 ranks with K = 2


#: each layout's batch sizes, over consecutive clips
MESH_LAYOUTS = {"jax_layout_4_items": (3, 1), "a_stacked_chunk_7_items": (3, 3, 1),
                "a_chunk_of_an_unpadded_and_a_padded_batch": (4, 3)}
#: lr 1e-4: the 1-row batches' steps amplify float32 differences; at lr 1e-3 the JAX package's own K = 1 and K = 2
#: runs end 3e-4 of the loss apart, and the port's mesh and meshless runs 1e-4
MESH_SGD = {"learning_rate": 1e-4, "momentum": 0.9}


def _mesh_loader(sizes: tuple):
    """Batches of ``sizes`` rows over consecutive clips of 8,000 samples."""
    items = sum(sizes)
    rng = np.random.default_rng(5)
    audio = (rng.standard_normal((items, 8000)) * 0.3).astype(np.float32)
    texts = ["hello world", "testing speech", "the cat sat", "quick brown fox"] * 2
    starts = np.cumsum((0,) + sizes[:-1])
    return [(audio[i:i + n], np.full(n, 8000, np.int32), texts[i:i + n]) for i, n in zip(starts, sizes)]


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    ref = P._jax_inputs("qn256")
    trainer = dict(max_epochs=2, log_every=1, seed=0, steps_per_execution=2, optimizer_builder=optim.sgd,
                   optimizer_kwargs=MESH_SGD)
    cases = [{"name": name, "kind": "fit", "model": "qn256", "state": ref["state"], "trainer": trainer,
              "loader": _mesh_loader(sizes)} for name, sizes in MESH_LAYOUTS.items()]
    wait = P._spawn(tmp_path_factory.mktemp("train_scan_dp2"), 2, cases)
    jax_losses = {}
    for name, sizes in MESH_LAYOUTS.items():
        jt = JaxTrainer(max_epochs=2, log_every=1, seed=0, steps_per_execution=2, optimizer_builder=jax_optim.sgd,
                        optimizer_kwargs=MESH_SGD,
                        mesh=jax_make_mesh(devices=jax.devices()[:2]))
        jt.fit(ref["module"], train_loader=_mesh_loader(sizes))
        jax_losses[name] = [e["loss/train_loss"] for e in jt.logs if "loss/train_loss" in e]
    return ref, trainer, wait(), jax_losses


@pytest.mark.parametrize("layout", sorted(MESH_LAYOUTS))
def test_steps_per_execution_on_a_gloo_mesh_matches_meshless_and_jax(mesh_runs, layout):
    ref, settings, runs, jax_losses = mesh_runs
    loader = _mesh_loader(MESH_LAYOUTS[layout])
    meshless = Trainer(device="cpu", **settings)
    fitted = meshless.fit(W.build("qn256", ref["state"]), loader)
    want = fitted.model.state_dict()
    for rank in runs[layout]:
        np.testing.assert_allclose(rank["losses"], _losses(meshless), rtol=LOSS_RTOL)
        for name, value in want.items():
            torch.testing.assert_close(rank["state"][name], value, rtol=0, atol=WEIGHT_TOL, msg=name)
        # on the CPU every step runs eagerly
        assert rank["steps"] == (2 * len(loader), 0)
    np.testing.assert_allclose(runs[layout][0]["losses"], jax_losses[layout], rtol=LOSS_RTOL)


def test_a_mesh_chunk_is_stacked_and_sharded_on_its_batch_axis(monkeypatch):
    """The 7-item layout's chunk goes through ``stacked_batch_sharding``: on a one-rank gloo group, the stack of
    its two padded batches, sharded (one rank keeps every row)."""
    import torch.distributed as dist

    from thunder_tpu_torch.parallel import make_mesh
    from thunder_tpu_torch.training import trainer as trainer_module

    seen = []
    real = trainer_module.stacked_batch_sharding

    def spy(mesh):
        shard = real(mesh)
        return lambda x: (seen.append(np.shape(x)), shard(x))[1]

    monkeypatch.setattr(trainer_module, "stacked_batch_sharding", spy)
    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        trainer = Trainer(device="cpu", steps_per_execution=2, mesh=make_mesh(device="cpu"), max_epochs=1,
                          optimizer_builder=optim.sgd, optimizer_kwargs={"learning_rate": 0.01})
        trainer.fit(_port_module(dropout=0.0), _mesh_loader(MESH_LAYOUTS["a_stacked_chunk_7_items"]))
    finally:
        dist.destroy_process_group()
    assert seen == [(2, 3, 8000), (2, 3), (2, 3, 32), (2, 3), (2, 3)]  # audio, lengths, targets, lengths, weights


#: (local weight, total weight) pairs of a rank's rows: padded rows of weight 0, the whole batch, a lone row, no
#: weight at all (the total then counts as 1)
SHARE_WEIGHTS = [(3.0, 7.0), (1.0, 3.0), (2.0, 3.0), (5.0, 5.0), (1.0, 1.0), (0.0, 4.0), (0.0, 0.0), (7.0, 13.0)]


def test_share_factor_on_the_device_is_bit_equal_to_the_host_factor():
    """The loss share's factor as a float32 scalar tensor (what a captured step multiplies by) against the host
    number (what the eager evaluation multiplies by), forward and backward, over seeded losses; a factor of 1 leaves
    the loss as it is."""
    from thunder_tpu_torch.parallel import spmd

    losses = np.random.default_rng(11).uniform(0.1, 400.0, 64).astype(np.float32)
    for local_weight, total_weight in SHARE_WEIGHTS:
        factor = spmd.share_factor(local_weight, total_weight)
        assert factor == local_weight / max(total_weight, 1.0)  # float64 on the host
        on_device = torch.full((), factor, dtype=torch.float32)
        assert on_device.item() == np.float32(factor)  # rounded once
        grads = []
        for f in (factor, on_device):
            x = torch.tensor(losses, requires_grad=True)
            share = x * f
            share.sum().backward()
            grads.append((share.detach(), x.grad))
        assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])
    x = torch.tensor(losses)
    assert spmd.share_factor(5.0, 5.0) == 1.0 and torch.equal(x * torch.ones(()), x)


def test_graphed_rows_step_of_a_larger_data_axis_runs_eagerly_on_the_cpu(one_thread):
    """Rank 0 of a data axis larger than the one-rank gloo mesh: 4 local rows, the last a padding row (weight 0,
    zero audio and target length), of a global batch of 8 rows and more weight than this rank holds, with another
    total weight and other local weights on each call. ``GraphedTrainStep.rows_step`` runs every step eagerly on
    the CPU and equals ``TrainStep.rows_step`` bit for bit: losses, weights, running statistics, optimizer and
    generator state; each loss is the rank's share that the JAX ``calculate_ctc`` gives on the step's logits."""
    import torch.distributed as dist

    from thunder_tpu_torch.parallel import make_mesh
    from thunder_tpu_torch.training.checkpointing import train_state
    from thunder_tpu_torch.training.trainer import TrainStep

    (audio, lengths, texts), = _batches([8000], seed=9, rows=4)
    lengths = lengths.copy()
    lengths[-1] = 0
    calls = [(np.array([1, 1, 1, 0], np.float32), 6.0), (np.array([1, 1, 1, 0], np.float32), 7.0),
             (np.ones(4, np.float32), 8.0), (np.array([1, 1, 1, 0], np.float32), 5.0)]
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh(device="cpu")
        runs = []
        for k in (1, 2):
            module = _port_module()
            targets, target_lengths = module.text_transform.encode(texts, pad_to=32)
            target_lengths = target_lengths.copy()
            target_lengths[-1] = 0
            batch = tuple(torch.as_tensor(a) for a in (audio, lengths, targets, target_lengths))
            step, generator, _ = Trainer(device="cpu", steps_per_execution=k, mesh=mesh).train_step_for(
                module, [None], mesh)
            assert type(step) is (GraphedTrainStep if k == 2 else TrainStep)
            outputs = []
            hook = module.model.register_forward_hook(lambda _m, _args, out: outputs.append(out))
            losses = [step.rows_step(batch, weights, total, 8, generator).item() for weights, total in calls]
            hook.remove()
            runs.append((losses, train_state(step, generator), step.eager_steps, getattr(step, "replayed_steps", 0)))
    finally:
        dist.destroy_process_group()
    (losses1, state1, *_), (losses2, state2, eager, replayed) = runs
    assert losses2 == losses1 and all(np.isfinite(losses1)) and len(set(losses1)) == len(calls)
    _assert_same_tree(state2, state1)
    assert (eager, replayed) == (len(calls), 0)
    # the rank's share from the same logits by the JAX package's calculate_ctc: the local weighted mean times the
    # fraction of the global weight the rank's rows hold
    for (logits, out_lengths), (weights, total), loss in zip(outputs, calls, losses2):
        local = jax_calculate_ctc(jnp.asarray(logits.detach().numpy()), jnp.asarray(batch[2].numpy()),
                                  jnp.asarray(out_lengths.numpy()), jnp.asarray(batch[3].numpy()), module.blank_idx,
                                  sample_weights=jnp.asarray(weights))
        want = float(local) * float(weights.sum()) / total
        np.testing.assert_allclose(loss, want, rtol=LOSS_RTOL)


# ---- (iv) checkpointed with K = 2 after epoch 1, resumed with K = 1


def test_steps_per_execution_checkpoint_resumes_with_one_step_a_dispatch(one_thread, tmp_path):
    # the schedule's length fixed: a one-epoch run would give total_steps_arg half the straight run's
    kw = dict(FEATURES, lr_scheduler_kwargs={"max_lr": 1e-3, "total_steps": 6},
              callbacks=[FinetuneEncoderDecoder(unfreeze_encoder_at_epoch=1, encoder_initial_lr_div=2.0)])
    loader = _batches([8000, 8000, 6000, 8000, 8000], seed=4)  # accumulation 2 across the epoch's end
    straight, straight_module = _fit(2, _port_module(), loader, epochs=2, **kw)
    first, _ = _fit(2, _port_module(), loader, epochs=1, checkpoint_dir=str(tmp_path / "ck"), **kw)
    (folder,) = (tmp_path / "ck").iterdir()
    resumed, resumed_module = _fit(1, _port_module(), loader, epochs=1, resume_from=str(folder), **kw)
    assert _losses(first) + _losses(resumed) == _losses(straight)
    _assert_same_tree(resumed.train_state(), straight.train_state())


# ---- (v) the grouping against the JAX fit's dispatches


def test_chunk_batches_groups_as_the_jax_fit_dispatches(monkeypatch):
    """Shapes 8000 x 3, 6000, 8000 x 5, 6000 x 2 over two epochs at K = 3: the JAX ``fit``'s steps and scans
    (recorded by stand-ins for its compiled steps) are the port's groups, batch for batch."""
    samples = [8000] * 3 + [6000] + [8000] * 5 + [6000] * 2
    loader = _batches(samples, seed=6)
    ids = {float(audio[0, 0]): i for i, (audio, _, _) in enumerate(loader)}
    dispatched = []

    def fake_step(model, blank_idx):
        def step(state, audio, *rest, sample_weights=None):
            dispatched.append([ids[float(np.asarray(audio)[0, 0])]])
            return state, jnp.float32(0.0)
        return step

    def fake_scan(model, blank_idx):
        def scan(state, audio, *rest, sample_weights=None):
            dispatched.append([ids[float(a)] for a in np.asarray(audio)[:, 0, 0]])
            return state, jnp.zeros(audio.shape[0])
        return scan

    monkeypatch.setattr(jax_trainer_module, "make_train_step", fake_step)
    monkeypatch.setattr(jax_trainer_module, "make_train_scan_step", fake_scan)
    tt = JaxText(tokens=TOKENS)
    module = JaxModule.create(jax.random.PRNGKey(0), audio_transform=JaxFilterbank(dither=0.0),
                              encoder=JaxQuartznet(**SMALL), decoder=JaxDecoder(num_classes=tt.num_tokens),
                              text_transform=tt, sample_len=4000)
    JaxTrainer(max_epochs=2, steps_per_execution=3).fit(module, train_loader=loader)
    port_module = _port_module()
    groups = []
    for _ in range(2):
        items = [_host_batch(port_module, *batch) for batch in loader]
        for chunk in chunk_batches(items, 3):
            ids_of = [ids[float(batch[0][0, 0])] for batch, _ in chunk]
            groups.extend([ids_of] if len(chunk) == 3 else [[i] for i in ids_of])
    assert groups == dispatched
    assert [len(g) for g in groups[:6]] == [3, 1, 3, 1, 1, 1]


# ---- ErrorRate.reset


def test_error_rate_reset_matches_jax():
    pairs = [(["the cat sat", "a dog"], ["the cat sat down", "a dog"]), (["hello word"], ["hello world"])]
    for port_cls, jax_cls in ((metrics.WordErrorRate, jax_metrics.WordErrorRate),
                              (metrics.CharErrorRate, jax_metrics.CharErrorRate)):
        port, ref = port_cls(), jax_cls()
        port.update(*pairs[0])
        ref.update(*pairs[0])
        port.reset()
        ref.reset()
        assert (port.errors, port.total) == (ref.errors, ref.total) == (0, 0)
        assert port(*pairs[1]) == ref(*pairs[1]) > 0
