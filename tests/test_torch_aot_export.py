"""``aot_export`` / ``aot_load`` of the port against the live port module and the JAX package's artifact (CPU).

The counterpart of ``tests/test_export.py``'s AOT tests, at the same tiny configurations (QuartzNet of one
32-channel block of kernel 33 over "abc ", exported at 2 x 8000 samples; wav2vec2 of hidden 32, 4 heads, one
layer, one 16-channel conv, exported at 1 x 4000), the JAX module's weights through the bridge:

- the port's artifact, loaded from its bytes and from a path, serves ``preds`` and lengths equal to the live
  port module's ``infer`` (exactly: the graph runs the same operations);
- on every valid frame where the JAX module's top-2 logit margin exceeds 1e-3, its ``preds`` equal those of
  the JAX package's ``aot_load(...).call`` (the two packages' float32 logits differ by about 1e-5; these
  untrained tiny models' logits are small, so 6 of QuartzNet's 42 valid frames clear the margin);
- the graph calls the port's kernels as the custom ops ``thunder_tpu::*``: one ``fused_log_mel`` for
  QuartzNet; for a bfloat16 wav2vec2 of hidden 128 and 2 heads of 64 (L = 2 layers), exactly L
  ``mha_from_qkv`` and 2L + 1 ``add_layer_norm`` nodes, and its artifact serves the live module's ``preds``;
- ``torch.library.opcheck`` passes for each op on CPU tensors (schema, fake implementation, dispatch).
"""

from collections import Counter

import jax
import numpy as np
import pytest
import torch

from thunder_tpu.audio import FilterbankFeatures as JaxFilterbank
from thunder_tpu.audio import Wav2Vec2Preprocess as JaxPreprocess
from thunder_tpu.export import aot_export as jax_aot_export
from thunder_tpu.export import aot_load as jax_aot_load
from thunder_tpu.models import Conv1dDecoder as JaxConv1dDecoder
from thunder_tpu.models import LinearDecoder as JaxLinearDecoder
from thunder_tpu.models import QuartznetEncoder as JaxQuartznet
from thunder_tpu.models import wav2vec2 as jax_w2v
from thunder_tpu.module import CTCModule as JaxModule
from thunder_tpu.text import BatchTextTransformer as JaxText
from thunder_tpu_torch.audio import FilterbankFeatures, Wav2Vec2Preprocess
from thunder_tpu_torch.bridge import from_flax_variables
from thunder_tpu_torch.export import aot_export, aot_load
from thunder_tpu_torch.models import Conv1dDecoder, LinearDecoder, QuartznetEncoder, Wav2Vec2Config, Wav2Vec2Encoder
from thunder_tpu_torch.module import CTCModule
from thunder_tpu_torch.text import BatchTextTransformer

torch.set_num_threads(2)

QUARTZNET = dict(repeat=1, filters=(32,), kernel_sizes=(33,))
W2V_TINY = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=4, intermediate_size=64, conv_dim=(16,),
                conv_kernel=(10,), conv_stride=(5,))
W2V_BF16 = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2, intermediate_size=256,
                conv_dim=(32, 32, 32), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2), num_conv_pos_embeddings=16,
                num_conv_pos_embedding_groups=4)
MARGIN = 1e-3


def _bridged(jax_module, port: CTCModule) -> CTCModule:
    port.model.load_state_dict(from_flax_variables(jax.tree_util.tree_map(np.asarray, jax_module.variables)))
    return port


@pytest.fixture(scope="module")
def quartznet_pair():
    tt = JaxText(tokens=list("abc "))
    jax_module = JaxModule.create(jax.random.PRNGKey(0), audio_transform=JaxFilterbank(),
                                  encoder=JaxQuartznet(**QUARTZNET), decoder=JaxConv1dDecoder(num_classes=tt.num_tokens),
                                  text_transform=tt, sample_len=4000)
    port = CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(), QuartznetEncoder(**QUARTZNET),
                            Conv1dDecoder(tt.num_tokens), BatchTextTransformer(list("abc ")), device="cpu")
    return jax_module, _bridged(jax_module, port)


@pytest.fixture(scope="module")
def wav2vec2_pair():
    tt = JaxText(tokens=list("ab "))
    jax_module = JaxModule.create(jax.random.PRNGKey(0), audio_transform=JaxPreprocess(mask_input=True),
                                  encoder=jax_w2v.Wav2Vec2Encoder(config=jax_w2v.Wav2Vec2Config(**W2V_TINY)),
                                  decoder=JaxLinearDecoder(num_classes=tt.num_tokens), text_transform=tt,
                                  sample_len=4000)
    port = CTCModule.create(torch.Generator().manual_seed(0), Wav2Vec2Preprocess(mask_input=True),
                            Wav2Vec2Encoder(Wav2Vec2Config(**W2V_TINY)), LinearDecoder(tt.num_tokens),
                            BatchTextTransformer(list("ab ")), device="cpu")
    return jax_module, _bridged(jax_module, port)


def _assert_serves_like(loaded, port: CTCModule, audio, lengths) -> None:
    preds, out_lengths = loaded.call(audio, lengths)
    _, live_preds, live_lengths = port.infer(audio, lengths)
    assert preds.dtype == torch.int32 and out_lengths.dtype == torch.int32
    assert torch.equal(preds, live_preds) and torch.equal(out_lengths, live_lengths)


def _assert_agrees_with_jax(port_preds, jax_module, audio, lengths, batch_size: int, num_samples: int) -> int:
    """Port ``preds`` against the JAX artifact's on the valid frames whose JAX top-2 margin exceeds MARGIN;
    returns how many frames were compared."""
    jax_preds, jax_lengths = jax_aot_load(jax_aot_export(jax_module, batch_size, num_samples)).call(audio, lengths)
    logits, _ = jax_module.forward(audio, lengths)
    top2 = np.sort(np.asarray(logits, np.float32), axis=-1)[..., -2:]
    valid = np.arange(top2.shape[1])[None, :] < np.asarray(jax_lengths)[:, None]
    clear = valid & (top2[..., 1] - top2[..., 0] > MARGIN)
    np.testing.assert_array_equal(port_preds.numpy()[clear], np.asarray(jax_preds)[clear])
    return int(clear.sum())


def test_quartznet_artifact_round_trips_and_serves_the_live_module(quartznet_pair, tmp_path):
    jax_module, port = quartznet_pair
    path = tmp_path / "predict.pt2"
    blob = aot_export(port, batch_size=2, num_samples=8000, path=str(path))
    assert path.exists() and path.read_bytes() == blob and len(blob) > 0
    audio = np.random.default_rng(0).standard_normal((2, 8000)).astype(np.float32)
    lengths = np.array([8000, 5000], dtype=np.int32)
    for loaded in (aot_load(blob), aot_load(str(path)), aot_load(path)):
        _assert_serves_like(loaded, port, audio, lengths)
    preds, _ = aot_load(blob).call(audio, lengths)
    assert _assert_agrees_with_jax(preds, jax_module, audio, lengths, 2, 8000) > 0


def test_wav2vec2_artifact_serves_the_live_module_and_the_jax_predictions(wav2vec2_pair):
    jax_module, port = wav2vec2_pair
    audio = np.random.default_rng(0).standard_normal((1, 4000)).astype(np.float32)
    lengths = np.array([4000], dtype=np.int32)
    loaded = aot_load(aot_export(port, batch_size=1, num_samples=4000))
    _assert_serves_like(loaded, port, audio, lengths)
    preds, _ = loaded.call(audio, lengths)
    assert _assert_agrees_with_jax(preds, jax_module, audio, lengths, 1, 4000) > 0


def _op_nodes(loaded) -> Counter:
    return Counter(str(n.target) for n in loaded.program.graph.nodes
                   if n.op == "call_function" and str(n.target).startswith("thunder_tpu."))


def test_graphs_call_the_kernels_as_custom_ops(quartznet_pair):
    _, port = quartznet_pair
    assert _op_nodes(aot_load(aot_export(port, 2, 8000))) == {"thunder_tpu.fused_log_mel.default": 1}

    layers = W2V_BF16["num_hidden_layers"]
    tt = BatchTextTransformer(list("abc "))
    module = CTCModule.create(torch.Generator().manual_seed(3), Wav2Vec2Preprocess(mask_input=True),
                              Wav2Vec2Encoder(Wav2Vec2Config(**W2V_BF16), dtype=torch.bfloat16),
                              LinearDecoder(tt.num_tokens, dtype=torch.bfloat16), tt, device="cpu")
    loaded = aot_load(aot_export(module, 2, 4000))
    assert _op_nodes(loaded) == {"thunder_tpu.mha_from_qkv.default": layers,
                                 "thunder_tpu.add_layer_norm.default": 2 * layers + 1}
    rng = np.random.default_rng(4)
    _assert_serves_like(loaded, module, (rng.standard_normal((2, 4000)) * 0.3).astype(np.float32),
                        np.array([4000, 2900], np.int32))


def _op_cases():
    rng = np.random.default_rng(5)
    t = lambda a, dtype=torch.float32: torch.as_tensor(np.asarray(a, np.float32)).to(dtype)  # noqa: E731
    audio = t(rng.standard_normal((2, 4000)) * 0.2)
    qkv = t(rng.standard_normal((2, 9, 3 * 128)), torch.bfloat16)
    x, y = (t(rng.standard_normal((2, 5, 64)), torch.bfloat16) for _ in range(2))
    scale, bias = t(rng.uniform(0.5, 1.5, 64)), t(rng.standard_normal(64))
    return {
        "fused_log_mel": (torch.ops.thunder_tpu.fused_log_mel.default, (audio, 16000, 512, 160, 320, 64, 0.97)),
        "mha_from_qkv": (torch.ops.thunder_tpu.mha_from_qkv.default,
                         (qkv, torch.tensor([9, 4], dtype=torch.int32), 2)),
        "add_layer_norm": (torch.ops.thunder_tpu.add_layer_norm.default, (x, y, scale, bias, 1e-5)),
    }


@pytest.mark.parametrize("name", ["fused_log_mel", "mha_from_qkv", "add_layer_norm"])
def test_opcheck_on_the_cpu(name):
    op, args = _op_cases()[name]
    torch.library.opcheck(op, args)
