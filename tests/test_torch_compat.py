"""Checkpoint loading in the port against the JAX package (CPU, float32).

- ``load_torch_checkpoint``: the same keys and arrays as the JAX reader,
  exactly, on both fixtures' ``model_weights.ckpt`` and on a legacy-format
  file.
- The NeMo config parsers: the same encoder, frontend and text settings as
  the JAX components, on both fixtures, with and without ``augment_params``.
- ``load_pretrained`` on ``tests/fixtures/tiny_{quartznet,citrinet}.nemo``:
  the JAX loader's weights through the bridge exactly; module logits within
  atol 2e-3 / rtol 1e-3 of JAX's over valid frames (the engine-vs-module
  bound of the JAX package's own tests); the engine's greedy transcripts
  equal to JAX's; the golden statistics of the JAX package's fixture tests at
  their own tolerance (2e-4).
- A port module written as a ``.nemo`` archive in NeMo's raw layout (the
  writer and the NeMo config schema of ``chip_smoke.py``, which writes the
  full-width archives on the card) loads back bit for bit, through the port
  and through the JAX loader. A shape mismatch raises ``ValueError``, an unknown leaf
  ``KeyError``, a leaf the archive lacks ``KeyError``.
- HuggingFace: tiny wav2vec2 (both norms) and HuBERT models with random
  weights, saved with ``save_pretrained``, load with logits within 1e-4 of
  the JAX loader's and of HF's own torch model (float32 sums in other
  orders); WavLM and data2vec-audio raise ``NotImplementedError``; the
  module carries ``frozen_paths``.
- The registry: JAX's names; the dispatch rules; ``download_checkpoint``
  returns a file already in the cache folder.
"""

import io
import json
import tarfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

import thunder_tpu.compat.nemo as jax_nemo
import thunder_tpu.registry as jax_registry
from thunder_tpu.compat.torch_reader import load_torch_checkpoint as jax_load_torch_checkpoint
from thunder_tpu.engine import InferenceEngine as JaxEngine
from chip_smoke import nemo_citrinet_config, nemo_quartznet_config, write_nemo
from thunder_tpu_torch import registry
from thunder_tpu_torch import utils
from thunder_tpu_torch.bridge import from_flax_variables
from thunder_tpu_torch.compat import hf as port_hf
from thunder_tpu_torch.compat import nemo
from thunder_tpu_torch.compat.torch_reader import load_torch_checkpoint
from thunder_tpu_torch.engine import InferenceEngine
from thunder_tpu_torch.text.tokenizer import BPETokenizer

torch.set_num_threads(2)

FIXTURES = Path(__file__).parent / "fixtures"
QN_FIXTURE, CN_FIXTURE = FIXTURES / "tiny_quartznet.nemo", FIXTURES / "tiny_citrinet.nemo"
AUGMENT = {"dropout": 0.1, "num_time_masks": 2, "num_freq_masks": 2, "mask_time_width": 30}


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _golden_wav(third_tone: bool) -> np.ndarray:
    t = np.arange(16000) / 16000
    wav = 0.4 * np.sin(2 * np.pi * 220 * t) + 0.3 * np.sin(2 * np.pi * 521 * t)
    if third_tone:
        wav = wav + 0.2 * np.sin(2 * np.pi * 1033 * t)
    return wav.astype(np.float32)


def _audio(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 16000)) * 0.3).astype(np.float32), np.array([16000, 11000], np.int32)


def _fixture_config(fixture: Path) -> dict:
    with tarfile.open(fixture) as tar:
        return yaml.safe_load(tar.extractfile("model_config.yaml"))


def _fixture_member(fixture: Path, name: str, dest: Path) -> Path:
    with tarfile.open(fixture) as tar:
        tar.extract(name, dest, filter="data")
    return dest / name


# ---- the torch checkpoint reader


@pytest.mark.parametrize("fixture", [QN_FIXTURE, CN_FIXTURE], ids=["quartznet", "citrinet"])
def test_torch_reader_matches_jax_on_fixtures(fixture, tmp_path):
    path = str(_fixture_member(fixture, "model_weights.ckpt", tmp_path))
    got, want = load_torch_checkpoint(path), jax_load_torch_checkpoint(path)
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key])


def test_torch_reader_matches_jax_on_legacy_format(tmp_path):
    rng = np.random.default_rng(0)
    state = {
        "a.weight": torch.tensor(rng.standard_normal((3, 4, 5)).astype(np.float32)),
        "a.strided": torch.tensor(rng.standard_normal((6, 4)).astype(np.float32)).t(),
        "b.running_mean": torch.tensor(rng.standard_normal(7).astype(np.float64)),
        "b.num_batches_tracked": torch.tensor(3),
        "c.half": torch.tensor(rng.standard_normal(5).astype(np.float16)),
        "c.bf16": torch.tensor(rng.standard_normal(5).astype(np.float32)).to(torch.bfloat16),
    }
    path = tmp_path / "legacy.ckpt"
    torch.save(state, path, _use_new_zipfile_serialization=False)
    got, want = load_torch_checkpoint(str(path)), jax_load_torch_checkpoint(str(path))
    assert list(got) == list(want) == list(state)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(got["c.bf16"], state["c.bf16"].float().numpy())


# ---- the NeMo config parsers


_ENCODER_FIELDS = ("feat_in", "filters", "kernel_sizes", "strides", "repeat_blocks", "repeat", "dropout")
_FRONTEND_FIELDS = ("sample_rate", "n_window_size", "n_window_stride", "n_fft", "preemph", "nfilt", "dither",
                    "num_cutout_masks", "num_time_masks", "num_freq_masks", "mask_time_width", "mask_freq_width",
                    "div_guard")


@pytest.mark.parametrize("augment", [None, AUGMENT], ids=["plain", "augment"])
@pytest.mark.parametrize("family", ["quartznet", "citrinet"])
def test_config_parsers_match_jax(family, augment, tmp_path):
    fixture = QN_FIXTURE if family == "quartznet" else CN_FIXTURE
    config = _fixture_member(fixture, "model_config.yaml", tmp_path)
    if family == "quartznet":
        got = nemo.load_components_from_quartznet_config(config, augment)
        want = jax_nemo.load_components_from_quartznet_config(config, augment)
    else:
        sp = _fixture_member(fixture, "tokenizer.model", tmp_path)
        got = nemo.load_components_from_citrinet_config(config, sp, augment)
        want = jax_nemo.load_components_from_citrinet_config(config, sp, augment)
    (enc, fe, tt), (jenc, jfe, jtt) = got, want
    assert type(enc).__name__ == type(jenc).__name__
    for name in _ENCODER_FIELDS:
        assert getattr(enc, name, None) == getattr(jenc, name, None), name
    assert enc.dropout == (0.1 if augment else 0.0)
    for name in _FRONTEND_FIELDS:
        assert getattr(fe, name) == getattr(jfe, name), name
    assert tt.vocab.itos == jtt.vocab.itos and tt.vocab.blank_idx == jtt.vocab.blank_idx
    assert isinstance(tt.tokenizer, BPETokenizer) == (family == "citrinet")
    text = "the quick brown fox jumps over the lazy dog"
    np.testing.assert_array_equal(tt.encode([text])[0], jtt.encode([text])[0])


NEMO_YAML = """\
# a NeMo model_config.yaml in its usual spellings
sample_rate: 16000
labels: [' ', a, "b", '##c', 'on', "'"]
preprocessor:
  _target_: nemo.collections.asr.modules.AudioToMelSpectrogramPreprocessor
  window_size: 0.02   # seconds
  window_stride: 1.0e-2
  features: 64
  n_fft: 512
  dither: 1e-05
  pad_to: 16
  frame_splicing: 1
  stft_conv: false
  normalize: per_feature
train_ds:
  manifest_filepath: ???
  batch_size: null
encoder:
  jasper:
  - filters: 256
    kernel: [33]
    stride:
    - 2
    separable: true
    residual: False
"""


def test_nemo_yaml_reads_as_nemo_writes_it(tmp_path):
    path = tmp_path / "model_config.yaml"
    path.write_text(NEMO_YAML)
    conf = nemo._read_config(path)
    assert conf == jax_nemo.yaml.safe_load(NEMO_YAML)
    assert conf["labels"] == [" ", "a", "b", "##c", "on", "'"]
    pre = conf["preprocessor"]
    assert (pre["window_size"], pre["window_stride"], pre["dither"]) == (0.02, 0.01, "1e-05")
    assert (pre["stft_conv"], conf["encoder"]["jasper"][0]["residual"]) == (False, False)
    assert conf["train_ds"] == {"manifest_filepath": "???", "batch_size": None}
    assert conf["encoder"]["jasper"][0]["kernel"] == [33] and conf["encoder"]["jasper"][0]["stride"] == [2]


def test_fix_vocab_matches_jax():
    labels = ["the", "##ing", "", "##", "a"]
    assert nemo.fix_vocab(labels) == jax_nemo.fix_vocab(labels) == ["▁the", "ing", "▁", "", "▁a"]


# ---- load_pretrained on the fixtures


@pytest.fixture(scope="module", params=["quartznet", "citrinet"])
def loaded(request):
    fixture = QN_FIXTURE if request.param == "quartznet" else CN_FIXTURE
    return request.param, registry.load_pretrained(str(fixture), device="cpu"), jax_registry.load_pretrained(str(fixture))


def test_load_pretrained_gives_the_jax_weights_exactly(loaded):
    family, port, jax_module = loaded
    assert type(port.model.encoder).__name__ == type(jax_module.model.encoder).__name__
    assert port.device == torch.device("cpu") and port.frozen_paths is None
    want = from_flax_variables(_numpy_tree(jax_module.variables))
    got = port.model.state_dict()
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert port.text_transform.vocab.itos == jax_module.text_transform.vocab.itos
    assert port.encoder_final_dimension == jax_module.encoder_final_dimension


def test_loaded_logits_and_transcripts_match_jax(loaded):
    _, port, jax_module = loaded
    audio, lengths = _audio()
    want, want_lengths = jax_module.forward(audio, lengths)
    got, got_lengths = port.forward(audio, lengths)
    np.testing.assert_array_equal(got_lengths.numpy(), np.asarray(want_lengths))
    for row, n in enumerate(np.asarray(want_lengths)):
        np.testing.assert_allclose(got[row, :n].numpy(), np.asarray(want)[row, :n], atol=2e-3, rtol=1e-3)
    assert InferenceEngine(port).predict(audio, lengths) == JaxEngine(jax_module).predict(audio, lengths)
    assert port.predict(audio, lengths) == jax_module.predict(audio, lengths)


# the JAX package's golden fixture tests (tests/quartznet/test_golden_fixture_qn.py,
# tests/citrinet/test_golden_fixture_cn.py): shape, mean and std at 2e-4, the argmax path and the transcript
GOLDEN = {
    "quartznet": ((51, 29), -0.0376482, 0.1956763, "t"),
    "citrinet": ((51, 46), 0.0188699, 0.0976740,
                 " world speech world pr world pr world pr world pr world pr world pr world"),
}


def test_loaded_fixtures_reproduce_the_golden_statistics(loaded):
    family, port, _ = loaded
    shape, mean, std, text = GOLDEN[family]
    wav = _golden_wav(third_tone=family == "quartznet")
    logits, lens = port.forward(wav[None], np.array([16000]))
    lg = logits[0, : int(lens[0])].numpy()
    assert lg.shape == shape
    assert float(lg.mean()) == pytest.approx(mean, abs=2e-4)
    assert float(lg.std()) == pytest.approx(std, abs=2e-4)
    if family == "quartznet":
        np.testing.assert_array_equal(lg.argmax(-1), np.full(51, 19))
    assert port.predict(wav[None]) == [text]
    assert InferenceEngine(port).predict(wav[None]) == [text]


def test_citrinet_fixture_tokenizer_round_trip(tmp_path):
    port = registry.load_pretrained(str(CN_FIXTURE), device="cpu")
    config = _fixture_member(CN_FIXTURE, "model_config.yaml", tmp_path)
    sp = _fixture_member(CN_FIXTURE, "tokenizer.model", tmp_path)
    _, _, jax_text = jax_nemo.load_components_from_citrinet_config(config, sp)
    ids, _ = port.text_transform.encode(["the quick brown fox"])
    np.testing.assert_array_equal(ids, jax_text.encode(["the quick brown fox"])[0])
    assert port.text_transform.decode_prediction(ids, remove_repeated=False)[0].strip() == "the quick brown fox"


# ---- archives written from a port module


def _small_quartznet(device="cpu"):
    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
    from thunder_tpu_torch.module import CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer

    labels = list("abcdefghijklmnopqrstuvwxyz '")
    module = CTCModule.create(torch.Generator().manual_seed(3), FilterbankFeatures(),
                              QuartznetEncoder(filters=(64, 96), kernel_sizes=(11, 13), repeat=2),
                              Conv1dDecoder(len(labels) + 1), BatchTextTransformer(labels), device=device)
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for name, t in module.model.state_dict().items():
            if name.endswith(".var"):
                t.copy_(torch.tensor(rng.uniform(0.5, 2.0, t.shape).astype(np.float32)))
            elif name.endswith((".mean", ".bn.bias")):
                t.copy_(torch.tensor((rng.standard_normal(t.shape) * 0.3).astype(np.float32)))
    config = nemo_quartznet_config(module)
    assert config["labels"] == labels
    return module, config


def test_written_quartznet_archive_round_trips(tmp_path):
    module, config = _small_quartznet()
    path = tmp_path / "qn.nemo"
    write_nemo(path, module, config)
    loaded = registry.load_pretrained(str(path), device="cpu")
    for key, value in module.model.state_dict().items():
        assert torch.equal(loaded.model.state_dict()[key], value), key
    jax_module = jax_registry.load_pretrained(str(path))
    want = from_flax_variables(_numpy_tree(jax_module.variables))
    assert set(want) == set(loaded.model.state_dict())
    for key, value in want.items():
        assert torch.equal(loaded.model.state_dict()[key], value), key


def test_written_citrinet_archive_round_trips(tmp_path):
    """The Citrinet fixture's module, written anew with the vocabulary under ``decoder.vocabulary`` only:
    squeeze-excite and strided residual weights included."""
    module = registry.load_pretrained(str(CN_FIXTURE), device="cpu")
    path = tmp_path / "cn.nemo"
    sp = _fixture_member(CN_FIXTURE, "tokenizer.model", tmp_path).read_bytes()
    vocab = module.text_transform.vocab
    config = nemo_citrinet_config(module, [t for t in vocab.itos if t != vocab.blank_token])
    assert "labels" not in config and config["decoder"]["vocabulary"] == _fixture_config(CN_FIXTURE)["labels"]
    write_nemo(path, module, config, tokenizer_model=sp)
    assert any(".fc.0.weight" in k for k in load_torch_checkpoint(str(_fixture_member(path, "model_weights.ckpt",
                                                                                      tmp_path / "x"))))
    loaded = registry.load_pretrained(str(path), device="cpu")
    assert loaded.text_transform.vocab.itos == vocab.itos
    assert set(loaded.model.state_dict()) == set(module.model.state_dict())
    for key, value in module.model.state_dict().items():
        assert torch.equal(loaded.model.state_dict()[key], value), key


def _rewrite_weights(src: Path, dst: Path, edit) -> None:
    with tarfile.open(src) as tar:
        members = {m.name: tar.extractfile(m).read() for m in tar.getmembers()}
    state = torch.load(io.BytesIO(members["model_weights.ckpt"]), weights_only=True)
    edit(state)
    buf = io.BytesIO()
    torch.save(state, buf)
    members["model_weights.ckpt"] = buf.getvalue()
    with tarfile.open(dst, "w") as tar:
        for name, payload in members.items():
            info = tarfile.TarInfo(name)
            info.size = len(payload)
            tar.addfile(info, io.BytesIO(payload))


def test_shape_mismatch_raises(tmp_path):
    # the config says 39 labels while the decoder has 29 outputs: the strict load must fail, as in JAX
    module, config = _small_quartznet()
    config["labels"] = config["labels"] + list("0123456789")
    path = tmp_path / "bad.nemo"
    write_nemo(path, module, config)
    with pytest.raises(ValueError, match="shape"):
        registry.load_pretrained(str(path), device="cpu")
    with pytest.raises(ValueError):
        jax_registry.load_pretrained(str(path))


@pytest.mark.parametrize("edit,match", [
    (lambda s: s.pop("encoder.encoder.0.mconv.0.conv.weight"), "not covered"),
    (lambda s: s.__setitem__("encoder.encoder.1.mconv.99.conv.weight", torch.zeros(1, 1, 1)), "not present"),
], ids=["missing_leaf", "unknown_leaf"])
def test_incomplete_or_foreign_archive_raises(tmp_path, edit, match):
    path = tmp_path / "edited.nemo"
    _rewrite_weights(QN_FIXTURE, path, edit)
    with pytest.raises(KeyError, match=match):
        registry.load_pretrained(str(path), device="cpu")


def test_nemo_key_map_matches_jax():
    layout = {0: True, 1: True, 2: False}
    keys = ["encoder.encoder.1.mconv.5.conv.weight", "encoder.encoder.1.mconv.6.conv.weight",
            "encoder.encoder.1.mconv.7.running_var", "encoder.encoder.1.mconv.13.fc.2.weight",
            "encoder.encoder.1.res.0.0.conv.weight", "encoder.encoder.1.res.0.1.weight",
            "encoder.encoder.2.mconv.4.conv.weight", "encoder.encoder.2.mconv.5.bias",
            "encoder.encoder.2.mconv.5.num_batches_tracked", "decoder.decoder_layers.0.weight",
            "decoder.decoder_layers.0.bias"]
    w = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    for key in keys:
        got, want = nemo.nemo_key_map(key, layout), jax_nemo.nemo_key_map(key, layout)
        assert got[:2] == want[:2], key
        if want[2] is not None:
            arg = w[:, :, 0] if ".fc." in key else w
            np.testing.assert_array_equal(got[2](arg), want[2](arg))
    with pytest.raises(KeyError):
        nemo.nemo_key_map("joint.foo.weight", layout)


# ---- HuggingFace (transformers is imported only by the loader and these tests)

HF_VOCAB = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4, "a": 5, "b": 6, "c": 7, "e": 8, "t": 9}
HF_COMMON = dict(vocab_size=len(HF_VOCAB), hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                 intermediate_size=64, conv_dim=(16, 16, 16), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
                 hidden_dropout=0.0, attention_dropout=0.0, feat_proj_dropout=0.0, final_dropout=0.0,
                 layerdrop=0.0, apply_spec_augment=False, num_conv_pos_embeddings=16,
                 num_conv_pos_embedding_groups=4)


def save_hf(directory: Path, model, return_attention_mask: bool = False, tokenizer: bool = True) -> str:
    from transformers import Wav2Vec2CTCTokenizer, Wav2Vec2FeatureExtractor

    model.save_pretrained(directory)
    if tokenizer:
        (directory / "vocab.json").write_text(json.dumps(HF_VOCAB))
        Wav2Vec2CTCTokenizer(str(directory / "vocab.json"), pad_token="<pad>", unk_token="<unk>",
                             word_delimiter_token="|").save_pretrained(directory)
    Wav2Vec2FeatureExtractor(do_normalize=True, return_attention_mask=return_attention_mask).save_pretrained(directory)
    return str(directory)


def _hf_model(family: str, seed: int = 0):
    from transformers import HubertConfig, HubertForCTC, Wav2Vec2Config, Wav2Vec2ForCTC

    torch.manual_seed(seed)
    if family == "wav2vec2_group":
        return Wav2Vec2ForCTC(Wav2Vec2Config(**HF_COMMON, feat_extract_norm="group", conv_bias=False)).eval(), False
    if family == "wav2vec2_layer":
        cfg = Wav2Vec2Config(**HF_COMMON, feat_extract_norm="layer", do_stable_layer_norm=True, conv_bias=True)
        return Wav2Vec2ForCTC(cfg).eval(), True
    return HubertForCTC(HubertConfig(**HF_COMMON, feat_extract_norm="group", conv_bias=False,
                                     feat_proj_layer_norm=False)).eval(), False


@pytest.mark.parametrize("family", ["wav2vec2_group", "wav2vec2_layer", "hubert"])
def test_hf_checkpoint_matches_jax_and_hf(family, tmp_path):
    from thunder_tpu.compat.hf import load_huggingface_checkpoint as jax_load_hf

    ref, mask_input = _hf_model(family)
    d = save_hf(tmp_path / family, ref, return_attention_mask=mask_input)
    port = registry.load_pretrained(d, device="cpu")
    assert port.frozen_paths == [("encoder", "feature_extractor")]
    assert port.model.encoder.mask_input == mask_input == port.model.audio_transform.mask_input
    jax_module = jax_load_hf(d)
    want_state = from_flax_variables(_numpy_tree(jax_module.variables))
    assert set(port.model.state_dict()) == set(want_state)
    for key, value in want_state.items():
        assert torch.equal(port.model.state_dict()[key], value), key

    rng = np.random.default_rng(0)
    audio = rng.standard_normal((2, 4000)).astype(np.float32)
    lengths = np.array([4000, 4000], np.int32)
    got, got_lengths = port.forward(audio, lengths)
    want, _ = jax_module.forward(audio, lengths)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    normed, _ = port.model.audio_transform(torch.tensor(audio), torch.tensor(lengths))
    with torch.no_grad():
        hf = ref(normed).logits.numpy()
    np.testing.assert_allclose(got.numpy(), hf, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got_lengths.numpy(), ref._get_feat_extract_output_lengths(torch.tensor(lengths)))
    assert port.predict(audio, lengths) == jax_module.predict(audio, lengths)


def test_hf_tokenizer_transform_matches_jax(tmp_path):
    from transformers import AutoTokenizer

    from thunder_tpu.compat.hf import tokenizer_to_transform as jax_tokenizer_to_transform

    d = save_hf(tmp_path / "w", _hf_model("wav2vec2_group")[0])
    tok = AutoTokenizer.from_pretrained(d)
    got, want = port_hf.tokenizer_to_transform(tok), jax_tokenizer_to_transform(tok)
    assert got.vocab.itos == want.vocab.itos
    assert (got.vocab.blank_idx, got.vocab.pad_idx) == (want.vocab.blank_idx, want.vocab.pad_idx)


class _Transformers5Tokenizer:
    """transformers 5's tokenizer as the loader reads it: ``extra_special_tokens`` in place of
    ``additional_special_tokens``."""

    def __init__(self, tokenizer, extras):
        self.tokenizer, self.extra_special_tokens = tokenizer, extras
        self.pad_token, self.unk_token = tokenizer.pad_token, tokenizer.unk_token

    def get_vocab(self):
        return self.tokenizer.get_vocab()


@pytest.mark.parametrize("extras", [[], ["<s>", "</s>"]], ids=["none", "bos_eos"])
def test_hf_tokenizer_transform_reads_transformers_5_extras(tmp_path, extras):
    from transformers import AutoTokenizer

    from thunder_tpu.compat.hf import tokenizer_to_transform as jax_tokenizer_to_transform

    d = save_hf(tmp_path / "w", _hf_model("wav2vec2_group")[0])
    tok = AutoTokenizer.from_pretrained(d)
    tok.add_special_tokens({"additional_special_tokens": extras})  # transformers 4's spelling, for the JAX loader
    got = port_hf.tokenizer_to_transform(_Transformers5Tokenizer(tok, extras))
    want = jax_tokenizer_to_transform(tok)
    assert got.vocab.itos == want.vocab.itos
    assert (got.vocab.blank_token, got.vocab.unknown_token) == (want.vocab.blank_token, want.vocab.unknown_token)
    assert not set(extras) & set(got.vocab.itos)


def test_hf_without_tokenizer_warns_and_leaves_the_head_off(tmp_path):
    d = save_hf(tmp_path / "w", _hf_model("wav2vec2_group")[0], tokenizer=False)
    with pytest.warns(UserWarning, match="missing the tokenizer"):
        module = registry.load_pretrained(d, device="cpu")
    assert module.model.decoder is None and module.text_transform is None
    out, _ = module.forward(np.zeros((1, 4000), np.float32), np.array([4000]))
    assert out.shape[-1] == HF_COMMON["hidden_size"]


def test_hf_fold_weight_norm_matches_jax():
    from thunder_tpu.compat.hf import _fold_weight_norm as jax_fold

    rng = np.random.default_rng(0)
    g, v = rng.standard_normal((1, 1, 7)).astype(np.float32), rng.standard_normal((8, 4, 7)).astype(np.float32)
    np.testing.assert_array_equal(port_hf._fold_weight_norm(g, v), jax_fold(g, v))


@pytest.mark.parametrize("family", ["wavlm", "data2vec-audio"])
def test_hf_families_the_encoder_does_not_run_raise(family, tmp_path):
    from transformers import Data2VecAudioConfig, Data2VecAudioForCTC, WavLMConfig, WavLMForCTC

    torch.manual_seed(0)
    if family == "wavlm":
        ref = WavLMForCTC(WavLMConfig(**HF_COMMON, feat_extract_norm="group", conv_bias=False, num_buckets=32,
                                      max_bucket_distance=64)).eval()
    else:
        ref = Data2VecAudioForCTC(Data2VecAudioConfig(**{**HF_COMMON, "num_conv_pos_embeddings": 3},
                                                      conv_bias=False, conv_pos_kernel_size=7)).eval()
    d = save_hf(tmp_path / family, ref)
    with pytest.raises(NotImplementedError, match="not ported"):
        registry.load_pretrained(d, device="cpu")


def test_wav2vec2_config_from_hf_matches_jax():
    from transformers import HubertConfig, Wav2Vec2Config

    from thunder_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
    from thunder_tpu_torch.models.wav2vec2 import Wav2Vec2Config as PortConfig

    for hf in (Wav2Vec2Config(**HF_COMMON), HubertConfig(**HF_COMMON, feat_proj_layer_norm=False)):
        assert vars(PortConfig.from_hf(hf)) == vars(JaxConfig.from_hf(hf))


# ---- the registry and utils


def test_registry_has_the_jax_names():
    assert sorted(registry.CHECKPOINT_REGISTRY) == sorted(jax_registry.CHECKPOINT_REGISTRY)
    for port_enum, jax_enum in ((nemo.QuartznetCheckpoint, jax_nemo.QuartznetCheckpoint),
                                (nemo.CitrinetCheckpoint, jax_nemo.CitrinetCheckpoint)):
        assert {m.name: m.value for m in port_enum} == {m.name: m.value for m in jax_enum}
    assert nemo.QuartznetCheckpoint.from_string("stt_en_quartznet15x5").value.endswith(".nemo")
    with pytest.raises(ValueError):
        nemo.CitrinetCheckpoint.from_string("nope")
    with pytest.raises(KeyError):
        registry.load_pretrained("definitely_not_registered")
    with pytest.raises(FileNotFoundError):
        registry.load_pretrained(str(FIXTURES / "missing.nemo"))


def test_load_pretrained_dispatch_follows_the_jax_rules(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(registry, "load_quartznet_checkpoint", lambda p, **kw: calls.append(("qn", p, kw)))
    monkeypatch.setattr(registry, "load_citrinet_checkpoint", lambda p, **kw: calls.append(("cn", p, kw)))
    monkeypatch.setattr(port_hf, "load_huggingface_checkpoint", lambda p, **kw: calls.append(("hf", p, kw)))

    def make_nemo(path, names):
        with tarfile.open(path, "w") as tar:
            for name in names:
                info = tarfile.TarInfo(name)
                info.size = 1
                tar.addfile(info, io.BytesIO(b"x"))

    make_nemo(tmp_path / "q.nemo", ["model_config.yaml", "model_weights.ckpt"])
    make_nemo(tmp_path / "c.nemo", ["model_config.yaml", "model_weights.ckpt", "sp/tokenizer.model"])
    registry.load_pretrained(str(tmp_path / "q.nemo"), device="cpu")
    registry.load_pretrained(str(tmp_path / "c.nemo"))
    registry.load_pretrained("facebook/wav2vec2-base-960h", device="cpu")
    assert calls == [("qn", str(tmp_path / "q.nemo"), {"device": "cpu"}), ("cn", str(tmp_path / "c.nemo"), {}),
                     ("hf", "facebook/wav2vec2-base-960h", {"device": "cpu"})]
    # a registry name loads its enum member through the registered partial
    monkeypatch.setitem(registry.CHECKPOINT_REGISTRY, "stt_en_citrinet_256",
                        lambda **kw: calls.append(("registry", kw)))
    registry.load_pretrained(nemo.CitrinetCheckpoint.stt_en_citrinet_256, save_folder="x")
    assert calls[-1] == ("registry", {"save_folder": "x"})


def test_registered_loader_reads_a_cached_checkpoint(tmp_path):
    # the registry's partial for an enum member goes through download_checkpoint, which finds the file cached
    name = nemo.QuartznetCheckpoint.stt_en_quartznet15x5
    cached = tmp_path / name.value.split("/")[-1]
    cached.write_bytes(QN_FIXTURE.read_bytes())
    assert utils.download_checkpoint(name, str(tmp_path)) == cached
    module = registry.load_pretrained("stt_en_quartznet15x5", save_folder=str(tmp_path), device="cpu")
    assert module.predict(_golden_wav(third_tone=True)[None]) == ["t"]


def test_utils_match_jax(tmp_path, monkeypatch):
    from thunder_tpu import utils as jax_utils

    (tmp_path / "a" / "b").mkdir(parents=True)
    for name in ("a/x.wav", "a/b/y.wav", "a/b/z.txt"):
        (tmp_path / name).write_text("")
    assert sorted(utils.get_files(tmp_path, ".wav")) == sorted(jax_utils.get_files(tmp_path, ".wav"))
    assert len(utils.get_files(tmp_path, ".wav")) == 2
    assert utils.chain_calls(lambda x: x + 1, lambda x: x * 3)(2) == 9
    monkeypatch.setenv("HOME", str(tmp_path))
    assert utils.get_default_cache_folder() == tmp_path / ".thunder_tpu_torch"
    assert (tmp_path / ".thunder_tpu_torch").is_dir()
