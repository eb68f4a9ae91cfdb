"""The HuggingFace loader on the wav2vec2 family's variants, in the port against HF and the JAX package (CPU).

Tiny HF models (hidden 32, 4 heads, 2 layers, as ``tests/wav2vec2/test_hf_families.py`` builds them) with
random weights are saved with ``save_pretrained`` and loaded through ``load_huggingface_checkpoint`` and
``registry.load_pretrained``: WavLM (post-LN and stable-LN), data2vec-audio, SEW at (conv_dim[-1],
squeeze_factor) (16, 2) and (32, 4), wav2vec2 with the conv adapter (output_hidden_size 32 and 24) and with
MMS's attention adapters, UniSpeech and UniSpeechSat. For each:

- the encoder's weights equal, bit for bit, the JAX loader's mapping (``thunder_tpu.compat.hf.
  hf_state_to_variables`` under the JAX package's ``Wav2Vec2Config.from_hf``) through the bridge, and the
  config equals the JAX package's;
- the module's logits within 1e-4 of HF's own torch model on the normalized audio (float32 sums in other
  orders), and its lengths HF's ``_get_feat_extract_output_lengths`` (with the adapter's convs);
- both entry points give the same weights, and the module carries ``frozen_paths``.
"""

import json

import numpy as np
import pytest
import torch

from thunder_tpu.compat import hf as jax_hf
from thunder_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from thunder_tpu_torch import registry
from thunder_tpu_torch.bridge import from_flax_variables
from thunder_tpu_torch.compat import hf as port_hf
from thunder_tpu_torch.models.wav2vec2 import Wav2Vec2Config as PortConfig

transformers = pytest.importorskip("transformers")

torch.set_num_threads(2)

VOCAB = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4, "a": 5, "b": 6, "c": 7, "e": 8, "t": 9}
COMMON = dict(vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
              conv_dim=(16, 16, 16), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2), hidden_dropout=0.0,
              attention_dropout=0.0, feat_proj_dropout=0.0, final_dropout=0.0, layerdrop=0.0,
              apply_spec_augment=False, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
STABLE = dict(feat_extract_norm="layer", do_stable_layer_norm=True, conv_bias=True)
FAMILIES = {
    "wavlm": ("WavLM", dict(feat_extract_norm="group", conv_bias=False, num_buckets=32, max_bucket_distance=40)),
    "wavlm_stable": ("WavLM", dict(num_buckets=32, max_bucket_distance=40, **STABLE)),
    "data2vec": ("Data2VecAudio", dict(conv_bias=False, num_conv_pos_embeddings=3, conv_pos_kernel_size=7)),
    "sew_16_2": ("SEW", dict(feat_extract_norm="group", conv_bias=False, squeeze_factor=2)),
    "sew_32_4": ("SEW", dict(feat_extract_norm="group", conv_bias=False, squeeze_factor=4, conv_dim=(16, 16, 32))),
    "adapter_32": ("Wav2Vec2", dict(add_adapter=True, output_hidden_size=32, num_adapter_layers=2, **STABLE)),
    "adapter_24": ("Wav2Vec2", dict(add_adapter=True, output_hidden_size=24, num_adapter_layers=2, **STABLE)),
    "mms": ("Wav2Vec2", dict(adapter_attn_dim=8, **STABLE)),
    "unispeech": ("UniSpeech", dict(feat_extract_norm="group", conv_bias=False)),
    "unispeech_sat": ("UniSpeechSat", dict(feat_extract_norm="group", conv_bias=False)),
}


def _save(directory, model, return_attention_mask: bool) -> str:
    from transformers import Wav2Vec2CTCTokenizer, Wav2Vec2FeatureExtractor

    model.save_pretrained(directory)
    (directory / "vocab.json").write_text(json.dumps(VOCAB))
    Wav2Vec2CTCTokenizer(str(directory / "vocab.json"), pad_token="<pad>", unk_token="<unk>",
                         word_delimiter_token="|").save_pretrained(directory)
    Wav2Vec2FeatureExtractor(do_normalize=True, return_attention_mask=return_attention_mask).save_pretrained(directory)
    return str(directory)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_hf_family_loads_with_hf_logits_and_the_jax_mapping(family, tmp_path):
    prefix, overrides = FAMILIES[family]
    config = getattr(transformers, f"{prefix}Config")(**{**COMMON, **overrides})
    torch.manual_seed(list(FAMILIES).index(family))
    ref = getattr(transformers, f"{prefix}ForCTC")(config).eval()
    mask_input = family in ("data2vec", "adapter_32", "adapter_24", "mms")
    d = _save(tmp_path / family, ref, mask_input)

    port = port_hf.load_huggingface_checkpoint(d, device="cpu")
    assert port.frozen_paths == [("encoder", "feature_extractor")]
    assert port.model.encoder.mask_input == mask_input
    assert vars(port.model.encoder.config) == vars(JaxConfig.from_hf(ref.config))
    state = {k: v.detach().float().numpy() for k, v in ref.base_model.state_dict().items()}
    mapped = jax_hf.hf_state_to_variables(state, JaxConfig.from_hf(ref.config))
    want = from_flax_variables({"params": {"encoder": mapped}})
    got = port.model.state_dict()
    assert {k for k in got if k.startswith("encoder.")} == set(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    via_registry = registry.load_pretrained(d, device="cpu").model.state_dict()
    assert all(torch.equal(via_registry[k], v) for k, v in got.items())

    rng = np.random.default_rng(0)
    audio = rng.standard_normal((2, 4000)).astype(np.float32)
    lengths = np.array([4000, 4000], np.int32)
    logits, out_lengths = port.forward(audio, lengths)
    normed, _ = port.model.audio_transform(torch.tensor(audio), torch.tensor(lengths))
    with torch.no_grad():
        hf = ref(normed).logits.numpy()
    assert logits.shape == hf.shape
    np.testing.assert_allclose(logits.numpy(), hf, atol=1e-4, rtol=0)
    adapter = {"add_adapter": ref.config.add_adapter} if prefix == "Wav2Vec2" else {}  # the adapter's convs too
    hf_lengths = ref._get_feat_extract_output_lengths(torch.tensor(lengths), **adapter)
    np.testing.assert_array_equal(out_lengths.numpy(), hf_lengths.numpy())


def test_every_family_config_matches_jax():
    for prefix, overrides in FAMILIES.values():
        hf = getattr(transformers, f"{prefix}Config")(**{**COMMON, **overrides})
        assert vars(PortConfig.from_hf(hf)) == vars(JaxConfig.from_hf(hf)), prefix
