"""Inference bundles, ``finetune_ctc_module`` and the ``frozen_paths`` rule in the port against the JAX
package (CPU, float32).

- The bundle round trip, for QuartzNet and Citrinet (the repo's ``.nemo``
  fixtures, Citrinet with its ``tokenizer.model``) and wav2vec2 (a tiny HF
  model): the same logits bit for bit, the same transcripts and
  vocabulary; the bundle's ``config.json`` equals the JAX package's for the
  same checkpoint.
- ``finetune_ctc_module`` as ``tests/test_finetune.py`` pins it for the JAX
  package: the original head kept with ``hparams``; with new tokens the
  encoder kept exactly (running statistics included) and a head sized for
  the new vocabulary; the two ValueErrors; ``frozen_paths`` carried over.
- ``frozen_paths`` (C4): two ``Trainer.fit`` steps on a tiny HF wav2vec2
  with its ``frozen_paths``, dropout 0, in both packages: the frozen
  extractor bit-equal to its initial values in both, no ``requires_grad``
  left on it in the port; every other parameter moved, and within 1e-5 of
  JAX's (AdamW at lr 1e-4, so two steps move a weight by up to 2e-4: the
  bound is a tenth of an Adam step's reach, float32 sums in other orders).
  Without ``frozen_paths``, ``freeze_feature_extractor`` keeps today's rule:
  the extractor decays by lr * wd per step.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import thunder_tpu.export as jax_export
import thunder_tpu.registry as jax_registry
from thunder_tpu.finetune import finetune_ctc_module as jax_finetune
from thunder_tpu.models import Conv1dDecoder as JaxConv1dDecoder
from thunder_tpu.training import Trainer as JaxTrainer
from thunder_tpu_torch import export, registry
from thunder_tpu_torch.bridge import from_flax_variables
from thunder_tpu_torch.finetune import finetune_ctc_module
from thunder_tpu_torch.models import Conv1dDecoder, LinearDecoder
from thunder_tpu_torch.training.trainer import Trainer

torch.set_num_threads(2)

FIXTURES = Path(__file__).parent / "fixtures"
QN_FIXTURE, CN_FIXTURE = FIXTURES / "tiny_quartznet.nemo", FIXTURES / "tiny_citrinet.nemo"
HF_VOCAB = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4, "a": 5, "b": 6, "c": 7, "e": 8, "t": 9}


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    from transformers import Wav2Vec2Config, Wav2Vec2CTCTokenizer, Wav2Vec2FeatureExtractor, Wav2Vec2ForCTC

    d = tmp_path_factory.mktemp("hf") / "tiny"
    cfg = Wav2Vec2Config(vocab_size=len(HF_VOCAB), hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
                         intermediate_size=64, conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2),
                         num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, hidden_dropout=0.0,
                         attention_dropout=0.0, feat_proj_dropout=0.0, final_dropout=0.0, layerdrop=0.0,
                         apply_spec_augment=False)
    torch.manual_seed(0)
    Wav2Vec2ForCTC(cfg).eval().save_pretrained(d)
    (d / "vocab.json").write_text(json.dumps(HF_VOCAB))
    Wav2Vec2CTCTokenizer(str(d / "vocab.json"), pad_token="<pad>", unk_token="<unk>",
                         word_delimiter_token="|").save_pretrained(d)
    Wav2Vec2FeatureExtractor(do_normalize=True).save_pretrained(d)
    return str(d)


def _audio(seed=0, samples=16000):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, samples)) * 0.3).astype(np.float32), np.array([samples, samples * 3 // 4], np.int32)


# ---- the inference bundle


@pytest.mark.parametrize("family", ["quartznet", "citrinet", "wav2vec2"])
def test_bundle_round_trip_and_config_match_jax(family, hf_dir, tmp_path):
    name = {"quartznet": str(QN_FIXTURE), "citrinet": str(CN_FIXTURE), "wav2vec2": hf_dir}[family]
    port = registry.load_pretrained(name, device="cpu")
    directory = export.save_inference_bundle(str(tmp_path / "port"), port)
    assert (Path(directory) / "tokenizer.model").exists() == (family == "citrinet")
    restored = export.load_inference_bundle(directory, device="cpu")
    assert restored.device == torch.device("cpu")
    assert set(restored.model.state_dict()) == set(port.model.state_dict())
    for key, value in port.model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[key], value), key
    audio, lengths = _audio(samples=16000 if family != "wav2vec2" else 4000)
    (a, a_len), (b, b_len) = port.forward(audio, lengths), restored.forward(audio, lengths)
    assert torch.equal(a, b) and torch.equal(a_len, b_len)
    assert restored.predict(audio, lengths) == port.predict(audio, lengths)
    assert restored.text_transform.vocab.itos == port.text_transform.vocab.itos
    assert type(restored.text_transform.tokenizer) is type(port.text_transform.tokenizer)

    jax_module = jax_registry.load_pretrained(name)
    jax_dir = jax_export.save_inference_bundle(str(tmp_path / "jax"), jax_module)
    got = json.loads((Path(directory) / "config.json").read_text())
    assert got == json.loads((Path(jax_dir) / "config.json").read_text())
    if family == "citrinet":
        assert (Path(directory) / "tokenizer.model").read_bytes() == (Path(jax_dir) / "tokenizer.model").read_bytes()


def test_bundle_refuses_an_unknown_family(tmp_path):
    port = registry.load_pretrained(str(QN_FIXTURE), device="cpu")
    directory = Path(export.save_inference_bundle(str(tmp_path / "b"), port))
    config = json.loads((directory / "config.json").read_text())
    config["encoder"]["family"] = "conformer"
    (directory / "config.json").write_text(json.dumps(config))
    with pytest.raises(ValueError, match="unknown encoder family"):
        export.load_inference_bundle(str(directory), device="cpu")


# ---- finetune_ctc_module


def test_finetune_keeps_the_original_head(hf_dir):
    module = finetune_ctc_module(hf_dir, checkpoint_kwargs={"device": "cpu"})
    assert module.text_transform is not None and module.hparams["checkpoint_name"] == hf_dir
    assert module.frozen_paths == [("encoder", "feature_extractor")]
    assert module.hparams == jax_finetune(hf_dir).hparams | {"checkpoint_kwargs": {"device": "cpu"}}


@pytest.mark.parametrize("source", ["hf", "nemo"])
def test_finetune_swaps_the_head_and_keeps_the_encoder(source, hf_dir):
    name, builder, jax_builder = ((hf_dir, LinearDecoder, None) if source == "hf"
                                  else (str(QN_FIXTURE), Conv1dDecoder, JaxConv1dDecoder))
    base = registry.load_pretrained(name, device="cpu")
    new = finetune_ctc_module(name, checkpoint_kwargs={"device": "cpu"}, tokens=list("xyz "), decoder_builder=builder)
    for key, value in base.model.state_dict().items():
        if key.startswith("encoder."):
            assert torch.equal(new.model.state_dict()[key], value), key
    assert new.text_transform.num_tokens == len("xyz ") + 1
    assert new.model.decoder.num_classes == new.text_transform.num_tokens
    assert new.frozen_paths == base.frozen_paths
    assert new.hparams["tokens"] == list("xyz ")
    audio, lengths = _audio(samples=4000)
    logits, _ = new.forward(audio, lengths)
    assert logits.shape[-1] == new.text_transform.num_tokens
    if jax_builder is not None:
        jax_new = jax_finetune(name, tokens=list("xyz "), decoder_builder=jax_builder)
        want = from_flax_variables(_numpy_tree(jax_new.variables))
        assert set(want) == set(new.model.state_dict())
        for key, value in want.items():
            if key.startswith("encoder."):
                assert torch.equal(new.model.state_dict()[key], value), key
        assert new.text_transform.vocab.itos == jax_new.text_transform.vocab.itos


def test_finetune_tokens_without_decoder_raises(hf_dir):
    with pytest.raises(ValueError, match="decoder class"):
        finetune_ctc_module(hf_dir, tokens=list("ab"))


def test_finetune_decoder_without_tokens_raises(hf_dir):
    with pytest.raises(ValueError, match="tokens"):
        finetune_ctc_module(hf_dir, decoder_builder=LinearDecoder)


# ---- frozen_paths (C4)

LR, WD = 1e-4, 1e-2
TEXTS = ["abc", "cab"]


def _batches(steps=2):
    audio, lengths = _audio(seed=5, samples=8000)
    return [(audio, lengths, TEXTS)] * steps


def _extractor(state):
    return {k: v for k, v in state.items() if k.startswith("encoder.feature_extractor.")}


def test_frozen_paths_leave_the_extractor_untouched_as_in_jax(hf_dir):
    port = registry.load_pretrained(hf_dir, device="cpu")
    jax_module = jax_registry.load_pretrained(hf_dir)
    assert port.frozen_paths == jax_module.frozen_paths == [("encoder", "feature_extractor")]
    before = {k: v.clone() for k, v in port.model.state_dict().items()}
    kw = dict(max_epochs=1, optimizer_kwargs={"learning_rate": LR, "weight_decay": WD}, log_every=1)
    trained = Trainer(device="cpu", **kw).fit(port, _batches())
    jax_trained = JaxTrainer(**kw).fit(jax_module, train_loader=_batches())
    got, want = trained.model.state_dict(), from_flax_variables(_numpy_tree(jax_trained.variables))
    jax_before = from_flax_variables(_numpy_tree(jax_module.variables))
    frozen = _extractor(before)
    assert frozen
    for key, value in frozen.items():
        assert torch.equal(got[key], value), key
        assert torch.equal(want[key], jax_before[key]), key
    assert not any(p.requires_grad for n, p in trained.model.named_parameters() if n in frozen)
    moved = 0
    for key, value in want.items():
        if key in frozen:
            continue
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), atol=1e-5, rtol=0, err_msg=key)
        moved += not torch.equal(got[key], before[key])
    assert moved == len(want) - len(frozen)


def test_freeze_feature_extractor_alone_keeps_the_decay_rule(hf_dir):
    port = registry.load_pretrained(hf_dir, device="cpu")
    port.frozen_paths = None  # only the encoder's stop-gradient remains
    before = {k: v.clone() for k, v in _extractor(port.model.state_dict()).items()}
    trained = Trainer(device="cpu", max_epochs=1, optimizer_kwargs={"learning_rate": LR, "weight_decay": WD}).fit(
        port, _batches(1))
    for key, value in before.items():
        torch.testing.assert_close(trained.model.state_dict()[key], value * (1 - LR * WD), rtol=0, atol=1e-9)
