"""The port's ``Trainer`` features against the JAX ``Trainer`` (CPU).

The small QuartzNet of ``test_torch_training.py`` (one block of 64 channels, k 33; random running
statistics) starts from the same weights in both packages (through the bridge), without dither or
dropout, and both trainers ``fit`` it on the same batches (three of 2 rows, then one validation
batch). After the fit every parameter and running statistic is held within 1e-5 of JAX's (SGD with
momentum 0.9 at lr 0.01 where the rule under test is not the optimizer's: an AdamW step moves a weight
whose gradient is float32 noise by a full ``lr`` either way, as ``test_torch_training.py`` notes; AdamW
with eps 1e-4 where the rule is the freeze, whose bias correction after the unfreeze must be optax's,
over two steps), and
the validation metrics equal (the loss at rtol 1e-5):

- ``onecycle`` through ``total_steps_arg``, per step and per epoch;
- ``reduce_on_plateau``: the same ``lr_scale/plateau`` each epoch;
- ``FinetuneEncoderDecoder``: the encoder bit-equal through epoch 0 while the decoder moves, and the
  trained weights after the unfreeze;
- the value clip and the norm clip with ``accumulate_grad_batches`` and a schedule;
- ``EarlyStopping`` (the same epoch stops, the same logs) and ``checkpoint_monitor`` (the same steps
  saved);
- ``eval_beam_width`` with a small LM object (``partial_score``, ``final_score``): CER and WER equal;
- ``fit(datamodule=)`` on WAV files through each package's ``ManifestDatamodule``;
- ``JsonlLogger``: one JSON line per log entry, with its time.

Resume (the port alone): two epochs straight against one epoch, a checkpoint and ``resume_from`` for
one more, at dropout 0.1 with dither, SpecAugment, a shuffled loader, accumulation across the epoch's
end, a schedule, the freeze and a plateau: every parameter, the optimizer state and the generator state
bit-equal, on one CPU thread. A checkpoint with wav2vec2's old separate q/k/v projections resumes through
``migrate_fused_qkv`` into the same state.
"""

import json
import wave

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu.training.checkpointing as jax_checkpointing
from thunder_tpu.audio import FilterbankFeatures as JaxFilterbank
from thunder_tpu.data import ManifestDatamodule as JaxManifestDatamodule
from thunder_tpu.models import Conv1dDecoder as JaxDecoder
from thunder_tpu.models import QuartznetEncoder as JaxQuartznet
from thunder_tpu.module import CTCModule as JaxModule
from thunder_tpu.text import BatchTextTransformer as JaxText
from thunder_tpu.training import EarlyStopping as JaxEarlyStopping
from thunder_tpu.training import FinetuneEncoderDecoder as JaxFinetune
from thunder_tpu.training import Trainer as JaxTrainer
from thunder_tpu.training import optim as jax_optim
from thunder_tpu_torch.audio import FilterbankFeatures
from thunder_tpu_torch.bridge import from_flax_variables
from thunder_tpu_torch.data import DataLoader, ManifestDatamodule, ManifestSpeechDataset
from thunder_tpu_torch.models import Conv1dDecoder, LinearDecoder, QuartznetEncoder
from thunder_tpu_torch.models import wav2vec2 as w2v
from thunder_tpu_torch.module import CTCModule
from thunder_tpu_torch.text import BatchTextTransformer
from thunder_tpu_torch.training import checkpointing, optim
from thunder_tpu_torch.training.loggers import ConsoleLogger, JsonlLogger, MultiLogger
from thunder_tpu_torch.training.trainer import EarlyStopping, FinetuneEncoderDecoder, Trainer

torch.set_num_threads(2)

TOKENS = list("abcdefghijklmnopqrstuvwxyz '")
SMALL = dict(repeat=1, filters=(64,), kernel_sizes=(33,))
WEIGHT_TOL = 1e-5
TEXTS = [["hello world", "the cat"], ["a dog", "sat on the mat"], ["quick", "brown fox"]]


def _randomized(module, seed=0):
    rng = np.random.default_rng(seed)
    flat = flax.traverse_util.flatten_dict(module.variables)
    for k, v in flat.items():
        if k[-1] == "var":
            flat[k] = jnp.asarray(rng.uniform(0.5, 2.0, v.shape).astype(np.float32))
        elif k[-1] == "mean" or (k[-1] in ("scale", "bias") and "bn" in k):
            flat[k] = jnp.asarray((rng.standard_normal(v.shape) * 0.3).astype(np.float32))
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


def _batches(seed=0, texts=TEXTS):
    rng = np.random.default_rng(seed)
    out = []
    for pair_texts in texts:
        audio = (rng.standard_normal((2, 8000)) * 0.2).astype(np.float32)
        lengths = np.array([8000, int(rng.integers(5000, 8000))], np.int32)
        out.append((audio, lengths, list(pair_texts)))
    return out


TRAIN, VAL = _batches(0), _batches(1, [["the quick fox", "a cat"]])


def fit_both(pair, epochs, jax_kw=None, port_kw=None, train=TRAIN, val=VAL, **common):
    jax_module, port = pair
    jax_trainer = JaxTrainer(max_epochs=epochs, log_every=1, **common, **(jax_kw or {}))
    jax_out = jax_trainer.fit(jax_module, train_loader=train, val_loader=val)
    port_trainer = Trainer(max_epochs=epochs, log_every=1, device="cpu", **common, **(port_kw or {}))
    port_out = port_trainer.fit(port, train, val_loader=val)
    return jax_trainer, jax_out, port_trainer, port_out


def assert_weights_close(jax_module, port_module, tol=WEIGHT_TOL):
    want = from_flax_variables(_numpy(jax_module.variables))
    got = port_module.model.state_dict()
    assert set(want) == set(got)
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=tol, msg=name)


def assert_same_val_logs(jax_trainer, port_trainer):
    want = [e for e in jax_trainer.logs if "loss/val_loss" in e or "early_stop" in e]
    got = [e for e in port_trainer.logs if "loss/val_loss" in e or "early_stop" in e]
    assert len(want) == len(got) > 0
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for key in w:
            if key == "loss/val_loss":
                np.testing.assert_allclose(g[key], w[key], rtol=1e-5)
            else:
                assert g[key] == w[key], key


def _moved(before, after, prefix):
    return [k for k, v in before.items() if k.startswith(prefix) and not torch.equal(v, after[k])]


# at lr 0.01 the two packages stay within 1.4e-6 of each other over 12 steps; at 0.05 the small model's
# training is chaotic (1.8e-2 apart after 12 steps, 2.2e-5 after 6)
SGD = dict(optimizer_builder=jax_optim.sgd, optimizer_kwargs={"learning_rate": 0.01, "momentum": 0.9})
PORT_SGD = dict(optimizer_builder=optim.sgd, optimizer_kwargs={"learning_rate": 0.01, "momentum": 0.9})


@pytest.mark.parametrize("interval", ["step", "epoch"])
def test_onecycle_through_total_steps_arg_matches_jax(pair, interval):
    sched = {"max_lr": 0.02, "total_steps_arg": "total_steps", "interval": interval}
    jt, jm, pt, pm = fit_both(pair, 2, {**SGD, "lr_scheduler_builder": jax_optim.onecycle, "lr_scheduler_kwargs": sched},
                              {**PORT_SGD, "lr_scheduler_builder": optim.onecycle, "lr_scheduler_kwargs": dict(sched)})
    assert_weights_close(jm, pm)
    assert_same_val_logs(jt, pt)
    want = jax_optim.onecycle(0.02, 6 if interval == "step" else 2)
    lrs = [e["lr"] for e in pt.logs if "lr" in e]
    steps = range(6) if interval == "step" else [s // 3 for s in range(6)]
    np.testing.assert_allclose(lrs, [float(want(s)) for s in steps], rtol=0, atol=1e-7)


def test_reduce_on_plateau_matches_jax(pair):
    """lr 0 for the first epochs' worth of plateau: patience 0 halves on the first improvement (optax's rule);
    the scale then multiplies SGD's later updates."""
    kw = {"factor": 0.5, "patience": 1}
    jt, jm, pt, pm = fit_both(pair, 4, {**SGD, "lr_scheduler_builder": jax_optim.reduce_on_plateau,
                                        "lr_scheduler_kwargs": kw},
                              {**PORT_SGD, "lr_scheduler_builder": optim.reduce_on_plateau,
                               "lr_scheduler_kwargs": dict(kw)})
    assert_weights_close(jm, pm)
    assert_same_val_logs(jt, pt)
    scales = [e["lr_scale/plateau"] for e in pt.logs if "lr_scale/plateau" in e]
    assert len(scales) == 4


@pytest.mark.parametrize("builder", ["adamw", "sgd"])
def test_finetune_callback_matches_jax(pair, builder):
    jax_kw = {"callbacks": [JaxFinetune(unfreeze_encoder_at_epoch=1, encoder_initial_lr_div=4.0)]}
    port_kw = {"callbacks": [FinetuneEncoderDecoder(unfreeze_encoder_at_epoch=1, encoder_initial_lr_div=4.0)]}
    if builder == "sgd":
        jax_kw, port_kw = {**jax_kw, **SGD}, {**port_kw, **PORT_SGD}
    else:
        # eps 1e-4: an update of a gradient at float32 noise stays far below lr (with 1e-8 it is lr either
        # way); the bias correction, which the freeze's zero gradients must count as optax does, scales all
        jax_kw["optimizer_kwargs"] = {"learning_rate": 1e-3, "eps": 1e-4}
        port_kw["optimizer_kwargs"] = {"learning_rate": 1e-3, "eps": 1e-4}
    train = TRAIN[:1] if builder == "adamw" else TRAIN  # two AdamW steps: one frozen, one at lr / 4
    # epoch 0 alone: the encoder's parameters bit-equal (its running statistics move), the decoder's moved
    _, port = pair
    before = port.model.state_dict()
    jt, jm, pt, pm = fit_both(pair, 1, jax_kw, port_kw, train=train)
    after = pm.model.state_dict()
    params = {n for n, _ in port.model.named_parameters()}
    assert not [k for k in _moved(before, after, "encoder.") if k in params]
    assert _moved(before, after, "decoder.") and _moved(before, after, "encoder.")  # the statistics
    assert_weights_close(jm, pm)
    # after the unfreeze the encoder trains at lr / 4, with optax's bias correction
    jt, jm, pt, pm = fit_both(pair, 2, jax_kw, port_kw, train=train)
    assert [k for k in _moved(before, pm.model.state_dict(), "encoder.") if k in params]
    assert_weights_close(jm, pm)
    assert_same_val_logs(jt, pt)


@pytest.mark.parametrize("clip_value,clip_norm", [(0.01, None), (None, 0.5), (0.01, 0.05)])
def test_clips_with_accumulation_and_schedule_match_jax(pair, clip_value, clip_norm):
    sched = {"max_lr": 0.02, "total_steps_arg": "total_steps"}
    common = dict(gradient_clip_value=clip_value, gradient_clip_norm=clip_norm, accumulate_grad_batches=2)
    jt, jm, pt, pm = fit_both(pair, 2, {**SGD, "lr_scheduler_builder": jax_optim.onecycle, "lr_scheduler_kwargs": sched},
                              {**PORT_SGD, "lr_scheduler_builder": optim.onecycle, "lr_scheduler_kwargs": dict(sched)},
                              **common)
    assert_weights_close(jm, pm)
    assert_same_val_logs(jt, pt)


def test_early_stopping_matches_jax(pair):
    jt, jm, pt, pm = fit_both(pair, 5, {**SGD, "callbacks": [JaxEarlyStopping(patience=1, min_delta=1e9)]},
                              {**PORT_SGD, "callbacks": [EarlyStopping(patience=1, min_delta=1e9)]})
    assert any(e.get("early_stop") for e in pt.logs)
    assert max(e["epoch"] for e in pt.logs if "epoch" in e) == 1
    assert_same_val_logs(jt, pt)
    assert_weights_close(jm, pm)


@pytest.mark.parametrize("lr", [0.0, 0.01])
def test_checkpoint_monitor_saves_the_steps_jax_saves(pair, tmp_path, monkeypatch, lr):
    """Best-only (min) saves: the same steps as JAX's (at lr 0 only the running statistics move the
    validation loss)."""
    jax_saved = []
    monkeypatch.setattr(jax_checkpointing, "save_checkpoint", lambda d, state, step: jax_saved.append(step))
    kw = dict(checkpoint_dir=str(tmp_path / "ck"), checkpoint_monitor="loss/val_loss")
    jt, jm, pt, pm = fit_both(pair, 4, {**SGD, "optimizer_kwargs": {"learning_rate": lr, "momentum": 0.9}},
                              {**PORT_SGD, "optimizer_kwargs": {"learning_rate": lr, "momentum": 0.9}}, **kw)
    saved = sorted(int(p.name.split("_")[1]) for p in (tmp_path / "ck").iterdir())
    assert saved == jax_saved and saved
    assert_same_val_logs(jt, pt)
    payload = checkpointing.restore_checkpoint(str(tmp_path / "ck" / f"step_{saved[-1]}"))
    assert payload["step"] == saved[-1] and payload["calls"] == saved[-1]


def test_early_stop_saves_a_checkpoint_as_jax_does(pair, tmp_path, monkeypatch):
    jax_saved = []
    monkeypatch.setattr(jax_checkpointing, "save_checkpoint", lambda d, state, step: jax_saved.append(step))
    kw = dict(checkpoint_dir=str(tmp_path / "ck"))
    fit_both(pair, 5, {**SGD, "callbacks": [JaxEarlyStopping(patience=0, min_delta=1e9)]},
             {**PORT_SGD, "callbacks": [EarlyStopping(patience=0, min_delta=1e9)]}, **kw)
    saved = sorted(int(p.name.split("_")[1]) for p in (tmp_path / "ck").iterdir())
    assert saved == jax_saved == [3, 6]  # epoch 0's save, then the early stop's at epoch 1


class ToyLM:
    """A shallow-fusion scorer with the word-fusion hooks: a bonus for a space after a word, a penalty
    for repeating the last token; ``final_score`` rewards shorter prefixes, ``partial_score`` is 0."""

    def __call__(self, prefix, token):
        if prefix and prefix[-1] == token:
            return -1.5
        return -0.2 if token == TOKENS.index(" ") + 1 else -0.7

    def final_score(self, prefix):
        return -0.05 * len(prefix)

    def partial_score(self, prefix):
        return 0.0


@pytest.mark.parametrize("lm", [None, ToyLM()], ids=["no_lm", "toy_lm"])
def test_beam_validation_matches_jax(pair, lm):
    jax_module, port = pair
    val = _batches(3, [["hello world", "the cat"], ["a b", "c"]])
    for width in (1, 4):
        want = JaxTrainer(eval_beam_width=width, eval_lm=lm, eval_lm_weight=0.3).validate(jax_module, val)
        got = Trainer(eval_beam_width=width, eval_lm=lm, eval_lm_weight=0.3, device="cpu").validate(port, val)
        assert got["metrics/cer"] == want["metrics/cer"] and got["metrics/wer"] == want["metrics/wer"]
        np.testing.assert_allclose(got["loss/val_loss"], want["loss/val_loss"], rtol=1e-5)


def _wav(path, seed, n):
    rng = np.random.default_rng(seed)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(rng.standard_normal(n) * 0.2, -1, 1) * 32767).astype(np.int16).tobytes())


def _manifest(tmp_path, texts, name, seed=0):
    rows = []
    for i, text in enumerate(texts):
        n = 6000 + 700 * i
        _wav(tmp_path / f"{name}{i}.wav", seed + i, n)
        rows.append({"audio_filepath": str(tmp_path / f"{name}{i}.wav"), "text": text, "duration": n / 16000})
    path = tmp_path / f"{name}.json"
    path.write_text("\n".join(json.dumps(r) for r in rows))
    return str(path)


def test_fit_datamodule_and_jsonl_logger_match_jax(pair, tmp_path):
    jax_module, port = pair
    train = _manifest(tmp_path, ["hello", "the cat", "a dog sat", "fox", "brown"], "t")
    val = _manifest(tmp_path, ["the fox", "a cat"], "v", seed=10)
    jt = JaxTrainer(max_epochs=2, log_every=1, **SGD)
    jm = jt.fit(jax_module, datamodule=JaxManifestDatamodule(train, val, val, batch_size=2, num_workers=2))
    log_path = tmp_path / "logs" / "metrics.jsonl"
    pt = Trainer(max_epochs=2, log_every=1, device="cpu", **PORT_SGD,
                 logger=MultiLogger([JsonlLogger(str(log_path)), ConsoleLogger()]))
    pm = pt.fit(port, datamodule=ManifestDatamodule(train, val, val, batch_size=2, num_workers=2))
    assert_weights_close(jm, pm)
    assert_same_val_logs(jt, pt)
    lines = [json.loads(line) for line in log_path.read_text().splitlines()]
    assert len(lines) == len(pt.logs) == 8 and all("time" in line for line in lines)
    assert [{k: v for k, v in line.items() if k != "time"} for line in lines] == pt.logs


def test_sample_weights_reach_the_loss(pair, monkeypatch):
    """TrainStep hands sample_weights to calculate_ctc: a zero weight leaves its row out of the mean."""
    from thunder_tpu_torch.training import trainer as trainer_module
    from thunder_tpu_torch.training.trainer import TrainStep, _encode_targets

    _, port = pair
    audio, lengths, texts = TRAIN[0]
    targets, target_lengths = _encode_targets(port.text_transform, texts)
    args = [torch.as_tensor(a) for a in (audio, lengths, targets, target_lengths)]
    seen = []
    real = trainer_module.calculate_ctc

    def spy(logits, targets, logit_lengths, target_lengths, blank, sample_weights=None):
        seen.append((real(logits, targets, logit_lengths, target_lengths, blank, sample_weights=sample_weights),
                     real(logits, targets, logit_lengths, target_lengths, blank, sample_weights=None),
                     real(logits[:1], targets[:1], logit_lengths[:1], target_lengths[:1], blank)))
        return seen[-1][0]

    monkeypatch.setattr(trainer_module, "calculate_ctc", spy)
    module = port.to("cpu")
    loss = TrainStep(module.model, optim.sgd(module.model.parameters(), 0.0), module.blank_idx)(
        *args, None, sample_weights=torch.tensor([1.0, 0.0]))
    weighted, unweighted, row0 = seen[0]
    assert torch.equal(loss, weighted.detach()) and not torch.equal(weighted, unweighted)
    torch.testing.assert_close(weighted, row0, rtol=1e-6, atol=0)


# ---- resume: two epochs straight against one epoch and a resume, bit for bit


def _train_module(dropout=0.1):
    tt = BatchTextTransformer(TOKENS)
    return CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(num_time_masks=1, num_freq_masks=1),
                            QuartznetEncoder(**SMALL, dropout=dropout), Conv1dDecoder(len(TOKENS) + 1), tt,
                            device="cpu")


@pytest.fixture()
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _resume_trainer(epochs, **kw):
    settings = dict(max_epochs=epochs, log_every=1, device="cpu", seed=3, accumulate_grad_batches=2,
                    gradient_clip_norm=1.0, lr_scheduler_builder=optim.onecycle,
                    lr_scheduler_kwargs={"max_lr": 1e-3, "total_steps": 4},
                    callbacks=[FinetuneEncoderDecoder(unfreeze_encoder_at_epoch=1, encoder_initial_lr_div=2.0)])
    return Trainer(**{**settings, **kw})


@pytest.mark.parametrize("plateau", [False, True])
def test_resume_replays_the_uninterrupted_run(tmp_path, one_thread, plateau):
    manifest = _manifest(tmp_path, ["hello", "the cat", "a dog sat", "fox", "brown", "mat"], "r")
    extra = {}
    if plateau:  # the plateau replaces the schedule; its state moves once an epoch
        extra = dict(lr_scheduler_builder=optim.reduce_on_plateau, lr_scheduler_kwargs={"factor": 0.5, "patience": 0})
    val = [_batches(5, [["the fox", "a cat"]])[0]]

    def loader():  # three batches an epoch: the optimizer steps once and a half an epoch under accumulation 2
        return DataLoader(ManifestSpeechDataset(manifest), batch_size=2, shuffle=True, num_workers=2, seed=4)

    straight = _resume_trainer(2, **extra).fit(_train_module(), loader(), val_loader=val)

    shared = loader()  # the resumed epoch reads the loader's second epoch, as the straight run does
    first = _resume_trainer(1, checkpoint_dir=str(tmp_path / "ck"), **extra)
    first.fit(_train_module(), shared, val_loader=val)
    (folder,) = (tmp_path / "ck").iterdir()
    payload = checkpointing.restore_checkpoint(str(folder))
    assert folder.name == "step_3" and payload["calls"] == 3 and payload["step"] == 1 and payload["grads"]

    resumed_trainer = _resume_trainer(1, resume_from=str(folder), **extra)
    resumed = resumed_trainer.fit(_train_module(), shared, val_loader=val)
    for (name, a), b in zip(straight.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), name

    # the restored state itself: parameters, optimizer state, step and generator state as saved
    module = _train_module().to("cpu")
    train_step, generator, _ = _resume_trainer(1, **extra).train_step_for(module, [None] * 3)
    checkpointing.load_train_state(payload, train_step, generator)
    again = checkpointing.train_state(train_step, generator)
    _assert_same_tree(again, payload)


def _assert_same_tree(a, b, path="payload"):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}/{i}")
    else:
        assert a == b, path


W2V_SMALL = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2, intermediate_size=256,
                 conv_dim=(32, 32, 32), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2), num_conv_pos_embeddings=16,
                 num_conv_pos_embedding_groups=4)


def _split_qkv(flat):
    """A state tree in the layout before the fused projection: each ``qkv_proj`` leaf cut into three."""
    out = {}
    for name, value in flat.items():
        if ".qkv_proj." in name and value.ndim > 0:
            for part, chunk in zip("qkv", value.chunk(3, dim=-1)):
                out[name.replace("qkv_proj", f"{part}_proj")] = chunk.clone()
        elif ".qkv_proj." in name:
            for part in "qkv":
                out[name.replace("qkv_proj", f"{part}_proj")] = value.clone()
        else:
            out[name] = value
    return out


def test_resume_migrates_separate_qkv_projections(tmp_path, one_thread):
    tt = BatchTextTransformer(TOKENS)
    from thunder_tpu_torch.audio import Wav2Vec2Preprocess

    def module():
        return CTCModule.create(torch.Generator().manual_seed(0), Wav2Vec2Preprocess(),
                                w2v.Wav2Vec2Encoder(w2v.Wav2Vec2Config(**W2V_SMALL)), LinearDecoder(len(TOKENS) + 1, in_features=128),
                                tt, device="cpu")

    batches = _batches(6, [["hello", "the cat"], ["a dog", "fox"]])
    Trainer(max_epochs=1, device="cpu", checkpoint_dir=str(tmp_path / "ck")).fit(module(), batches)
    folder = tmp_path / "ck" / "step_2"
    payload = checkpointing.restore_checkpoint(str(folder))
    old = {**payload, "model": _split_qkv(payload["model"]),
           "optimizer": {"state": {}, "param_groups": payload["optimizer"]["param_groups"]}}
    by_key = {}
    for name, state in payload["optimizer"]["state"].items():
        for key, value in state.items():
            by_key.setdefault(key, {})[name] = value
    for key, values in by_key.items():
        for name, value in _split_qkv(values).items():
            old["optimizer"]["state"].setdefault(name, {})[key] = value
    assert any(".q_proj." in k for k in old["model"]) and not any(".qkv_proj." in k for k in old["model"])
    legacy = tmp_path / "legacy" / "step_2"
    legacy.mkdir(parents=True)
    torch.save(old, legacy / checkpointing.TRAIN_STATE_FILE)
    target = {"model": module().model.state_dict()}
    migrated = checkpointing.restore_checkpoint(str(legacy), target)
    _assert_same_tree(migrated["model"], payload["model"], "model")
    _assert_same_tree(migrated["optimizer"]["state"], payload["optimizer"]["state"], "optimizer")
    resumed = Trainer(max_epochs=1, device="cpu", resume_from=str(legacy)).fit(module(), batches)
    straight = Trainer(max_epochs=1, device="cpu", resume_from=str(folder)).fit(module(), batches)
    for (name, a), b in zip(straight.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    with pytest.raises(ValueError, match="does not fit"):
        checkpointing.restore_checkpoint(str(legacy), {"model": _train_module().model.state_dict()})
