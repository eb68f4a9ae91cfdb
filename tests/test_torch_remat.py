"""Per-block rematerialization (``remat``) in the port (CPU).

flax's ``nn.remat`` changes no loss, gradient or batch statistic
(``tests/test_remat.py``); the port's ``torch.utils.checkpoint`` blocks must
not either, though they recompute with dropout on:

- QuartzNet, Citrinet and wav2vec2 (the tiny wav2vec2 of the other tests:
  hidden 128, 2 heads of 64, 2 layers; bfloat16 runs the training kernels'
  plain versions) in train mode at dropout 0.1, remat on against off from the
  same weights and generator state: the loss, every gradient, the running
  statistics and the generator's state after the step bit-equal. These run
  on one CPU thread: with more, the CPU's bfloat16 products are not
  reproducible from run to run on a loaded machine (measured: two losses 3e-4
  apart over twelve runs of the same step), whatever remat does;
- the recompute runs the training kernels' forwards again (their plain
  versions here), once a layer each, with the same seeds;
- remat on against the JAX package's remat at dropout 0: the loss and every
  gradient within the parity tolerances of ``test_torch_training.py`` (conv
  encoders: rtol 1e-6, 1e-5 of the largest gradient) and
  ``test_torch_wav2vec2_training.py`` (rtol 1e-5, 2e-5);
- ``Trainer.fit`` on a ``ManifestDatamodule`` with remat equals the fit
  without it, bit for bit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.models import QuartznetEncoder as JaxQuartznet
from thunder_tpu.models.citrinet import CitrinetEncoder as JaxCitrinet
from thunder_tpu.models.wav2vec2 import Wav2Vec2Config as JaxW2VConfig
from thunder_tpu.models.wav2vec2 import Wav2Vec2Encoder as JaxW2V
from thunder_tpu_torch.audio import FilterbankFeatures
from thunder_tpu_torch.bridge import from_flax_variables
from thunder_tpu_torch.data import ManifestDatamodule
from thunder_tpu_torch.kernels import add_ln_train, attention_train
from thunder_tpu_torch.models import CitrinetEncoder, Conv1dDecoder, QuartznetEncoder
from thunder_tpu_torch.models.layers import TorchBatchNorm, init_parameters, recomputing
from thunder_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder
from thunder_tpu_torch.module import CTCModule
from thunder_tpu_torch.text import BatchTextTransformer
from thunder_tpu_torch.training.trainer import Trainer

torch.set_num_threads(2)

W2V_SMALL = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2, intermediate_size=256,
                 conv_dim=(32, 32, 32), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2), num_conv_pos_embeddings=16,
                 num_conv_pos_embedding_groups=4)
DROPOUT = 0.1


def _features(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 64, 64)) * 0.3).astype(np.float32), np.array([64, 48], np.int32)


def _waveform(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 4000)) * 0.3).astype(np.float32), np.array([4000, 2900], np.int32)


def make_encoder(family: str, remat: bool, dropout: float = DROPOUT, dtype=torch.float32):
    if family == "quartznet":
        return QuartznetEncoder(repeat=2, filters=(128,), kernel_sizes=(11,), dropout=dropout, dtype=dtype, remat=remat)
    if family == "citrinet":
        return CitrinetEncoder(filters=(128, 128), kernel_sizes=(11, 13), strides=(2, 1), feat_in=64, repeat=2,
                               dropout=dropout, dtype=dtype, remat=remat)
    rates = dict(hidden_dropout=dropout, attention_dropout=dropout, feat_proj_dropout=dropout)
    return Wav2Vec2Encoder(Wav2Vec2Config(**W2V_SMALL, **rates), dtype=dtype, remat=remat)


def _inputs(family):
    return _waveform() if family == "wav2vec2" else _features()


def train_step(encoder, x, lengths, generator):
    """The loss (sum of squares of the output over valid frames) and its backward; returns the loss."""
    out, out_lengths = encoder(torch.as_tensor(x), torch.as_tensor(lengths), train=True, generator=generator)
    valid = torch.arange(out.shape[1])[None, :] < out_lengths[:, None]
    loss = (out.float().square() * valid[:, :, None]).sum()
    loss.backward()
    return loss.detach()


def run(family, remat, dtype=torch.float32, dropout=DROPOUT):
    torch.manual_seed(0)
    encoder = make_encoder(family, remat, dropout, dtype)
    init_parameters(encoder, torch.Generator().manual_seed(1))
    with torch.no_grad():  # running statistics away from identity, so that their update shows
        for m in encoder.modules():
            if isinstance(m, TorchBatchNorm):
                m.mean.normal_(generator=torch.Generator().manual_seed(2))
                m.var.uniform_(0.5, 2.0, generator=torch.Generator().manual_seed(3))
    generator = torch.Generator().manual_seed(7)
    loss = train_step(encoder, *_inputs(family), generator)
    grads = {n: p.grad.clone() for n, p in encoder.named_parameters() if p.grad is not None}
    return loss, grads, {k: v.clone() for k, v in encoder.state_dict().items()}, generator.get_state()


@pytest.fixture()
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CASES = [("quartznet", torch.float32), ("citrinet", torch.float32), ("wav2vec2", torch.float32),
         ("wav2vec2", torch.bfloat16), ("quartznet", torch.bfloat16)]


@pytest.mark.parametrize("family,dtype", CASES, ids=lambda c: str(c).replace("torch.", ""))
def test_remat_is_bit_transparent_at_dropout(family, dtype, one_thread):
    loss0, grads0, state0, gen0 = run(family, False, dtype)
    loss1, grads1, state1, gen1 = run(family, True, dtype)
    assert torch.equal(loss0, loss1)
    assert grads0.keys() == grads1.keys() and len(grads0) == sum(1 for _ in make_encoder(family, False).parameters())
    for name in grads0:
        assert torch.equal(grads0[name], grads1[name]), name
    for name in state0:  # the parameters (untouched) and the running statistics (moved once)
        assert torch.equal(state0[name], state1[name]), name
    assert torch.equal(gen0, gen1)
    assert not recomputing()


def test_running_statistics_move_once_under_remat(one_thread):
    """The recompute leaves the statistics alone: after a remat step they equal one momentum update from the
    start, not two."""
    _, _, start, _ = run("quartznet", False, dropout=0.0)
    _, _, once, _ = run("quartznet", True, dropout=0.0)
    fresh = make_encoder("quartznet", False, 0.0)
    init_parameters(fresh, torch.Generator().manual_seed(1))
    moved = [k for k in start if k.endswith(".mean") and not torch.equal(start[k], fresh.state_dict()[k])]
    assert moved and all(torch.equal(start[k], once[k]) for k in moved)


def test_recompute_runs_the_training_kernels_again(monkeypatch):
    """wav2vec2 in bfloat16: each layer's attention and two add + dropout + LayerNorm forwards run again in the
    recompute (the encoder-level add + LayerNorm is outside the layers), with the seeds of the forward."""
    calls = {"attention": [], "add_ln": []}
    mha_ref, add_ln_ref = attention_train.mha_train_forward_reference, add_ln_train.add_ln_train_forward_reference

    def mha_spy(qkv, lengths, seed, heads, rate=0.0, row_offset=0):
        calls["attention"].append((int(seed), recomputing()))
        return mha_ref(qkv, lengths, seed, heads, rate, row_offset)

    def add_ln_spy(x, y, scale, bias, seed, rate=0.0, eps=1e-5, row_offset=0):
        calls["add_ln"].append((int(seed), recomputing()))
        return add_ln_ref(x, y, scale, bias, seed, rate, eps, row_offset)

    monkeypatch.setattr(attention_train, "mha_train_forward_reference", mha_spy)
    monkeypatch.setattr(add_ln_train, "add_ln_train_forward_reference", add_ln_spy)
    run("wav2vec2", False, torch.bfloat16)
    plain = {k: list(v) for k, v in calls.items()}
    assert [len(plain["attention"]), len(plain["add_ln"])] == [2, 5]
    for v in calls.values():
        v.clear()
    run("wav2vec2", True, torch.bfloat16)
    assert [len(calls["attention"]), len(calls["add_ln"])] == [2 + 2, 5 + 4]
    for kind, n_layers_calls in (("attention", 2), ("add_ln", 4)):
        forward = [c for c in calls[kind] if not c[1]]
        again = [c for c in calls[kind] if c[1]]
        assert forward == plain[kind] and len(again) == n_layers_calls
        assert {s for s, _ in again} <= {s for s, _ in forward}  # the recompute draws the forward's seeds


def _jax_encoder(family):
    if family == "quartznet":
        return JaxQuartznet(repeat=2, filters=(128,), kernel_sizes=(11,), remat=True)
    if family == "citrinet":
        return JaxCitrinet(filters=(128, 128), kernel_sizes=(11, 13), strides=(2, 1), feat_in=64, repeat=2, remat=True)
    return JaxW2V(JaxW2VConfig(**W2V_SMALL, hidden_dropout=0.0, attention_dropout=0.0, feat_proj_dropout=0.0),
                  remat=True)


@pytest.mark.parametrize("family", ["quartznet", "citrinet", "wav2vec2"])
def test_remat_matches_jax_remat(family):
    x, lengths = _inputs(family)
    jax_enc = _jax_encoder(family)
    rngs = {"dropout": jax.random.PRNGKey(7)}
    variables = jax_enc.init({"params": jax.random.PRNGKey(0), **rngs}, jnp.asarray(x), jnp.asarray(lengths), True)
    mutable = ["batch_stats"] if "batch_stats" in variables else []

    def loss_fn(params):
        (out, out_lengths), _ = jax_enc.apply({**variables, "params": params}, jnp.asarray(x), jnp.asarray(lengths),
                                              True, rngs=rngs, mutable=mutable)
        valid = jnp.arange(out.shape[1])[None, :] < out_lengths[:, None]
        return jnp.sum(jnp.where(valid[:, :, None], out.astype(jnp.float32) ** 2, 0.0))

    want_loss, want_grads = jax.value_and_grad(loss_fn)(variables["params"])
    want_grads = from_flax_variables({"params": jax.tree_util.tree_map(np.asarray, want_grads)})

    encoder = make_encoder(family, True, dropout=0.0)
    encoder.load_state_dict(from_flax_variables(jax.tree_util.tree_map(np.asarray, dict(variables))))
    loss = train_step(encoder, x, lengths, torch.Generator().manual_seed(0))
    loss_rtol, grad_tol = (1e-5, 2e-5) if family == "wav2vec2" else (1e-6, 1e-5)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=loss_rtol)
    g_max = max(v.abs().max().item() for v in want_grads.values())
    got = dict(encoder.named_parameters())
    assert set(got) == set(want_grads)
    for name, want in want_grads.items():
        torch.testing.assert_close(got[name].grad, want, rtol=0, atol=grad_tol * g_max, msg=name)


def _wav(path, seed, seconds=0.5):
    import wave

    rng = np.random.default_rng(seed)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((rng.standard_normal(int(16000 * seconds)) * 1500).astype(np.int16).tobytes())


def test_trainer_fit_with_remat_equals_fit_without(tmp_path, one_thread):
    rows = []
    for i, text in enumerate(["ab", "ba", "aab", "b"]):
        _wav(tmp_path / f"c{i}.wav", i, 0.3 + 0.1 * i)
        rows.append({"audio_filepath": str(tmp_path / f"c{i}.wav"), "text": text, "duration": 0.3 + 0.1 * i})
    manifest = tmp_path / "m.json"
    manifest.write_text("\n".join(json.dumps(r) for r in rows))
    tt = BatchTextTransformer(list("ab '"))
    trained = []
    for remat in (False, True):
        module = CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(),
                                  QuartznetEncoder(repeat=1, filters=(64,), kernel_sizes=(11,), dropout=0.1,
                                                   remat=remat),
                                  Conv1dDecoder(tt.num_tokens), tt, device="cpu")
        dm = ManifestDatamodule(str(manifest), str(manifest), str(manifest), batch_size=2, num_workers=2)
        trainer = Trainer(max_epochs=2, device="cpu", log_every=1)
        trained.append((trainer.fit(module, datamodule=dm), trainer.logs))
    (plain, plain_logs), (remat, remat_logs) = trained
    assert remat.model.encoder.remat and not plain.model.encoder.remat
    for (name, a), b in zip(plain.model.state_dict().items(), remat.model.state_dict().values()):
        assert torch.equal(a, b), name
    strip = lambda logs: [{k: v for k, v in e.items() if k != "steps_per_sec"} for e in logs]  # noqa: E731
    assert strip(plain_logs) == strip(remat_logs) and np.isfinite(remat_logs[-1]["loss/val_loss"])
