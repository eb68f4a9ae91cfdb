"""The port's streaming transcription against the JAX package's (CPU, float32).

The JAX package's ``tests/test_streaming.py`` model (QuartzNet with one block of two 64-filter repeats over
"abc ") is built in JAX and its weights go through ``bridge.py`` into the port's module; both packages get the
same numpy-seeded audio and the same pushes. Texts are compared exactly:

- ``StreamingTranscriber`` on the module and on the engine: ``flush()`` and every partial equal to the JAX
  transcriber's on the same pushes, the final text equal to the port's ``predict_long``, and (greedy) every
  partial a prefix of it; greedy, the host beam (the C++ search), the device beam (its plain versions on the
  CPU) and LM fusion (a token n-gram and word fusion, host and device backends);
- the device beam's windows: the stream searches each trimmed window as it is, ``predict_long`` pads it to a
  64-frame bucket; both give the same beams;
- ``StreamingPool`` of batch 1, 3 and 8, greedy and beam, with interleaved ragged pushes and from threads:
  each stream's text equal to a lone stream's and to the JAX pool's; the greedy pool never touches the logits;
- the argument and lifecycle errors of the JAX package, word for word where it has words;
- the engine's ``batch_invariant`` mode (a port option): its float64 statistics and decoder sums within 1e-5 of
  the default float32 ones, its pool streams equal to its lone streams and to the JAX pool's; on a small
  Citrinet (the squeeze-excite gates in float64 too) within 1e-5 of the default engine, a row bit-equal to the
  row alone, and a pool equal to its lone streams; the mode refused for wav2vec2.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.audio import FilterbankFeatures as JaxFilterbank
from thunder_tpu.engine import InferenceEngine as JaxEngine
from thunder_tpu.models import Conv1dDecoder as JaxDecoder
from thunder_tpu.models import QuartznetEncoder as JaxQuartznet
from thunder_tpu.module import CTCModule as JaxModule
from thunder_tpu.streaming import StreamingPool as JaxPool
from thunder_tpu.streaming import StreamingTranscriber as JaxStream
from thunder_tpu.text import BatchTextTransformer as JaxText
from thunder_tpu.text.lm import NGramLM as JaxNGramLM
from thunder_tpu.text.word_fusion import WordFusionLM as JaxWordFusionLM
from thunder_tpu.text.word_fusion import WordNGramLM as JaxWordNGramLM
from thunder_tpu_torch import StreamingPool, StreamingTranscriber
from thunder_tpu_torch.audio import FilterbankFeatures
from thunder_tpu_torch.bridge import from_flax_variables
from thunder_tpu_torch.engine import InferenceEngine
from thunder_tpu_torch.models import CitrinetEncoder, Conv1dDecoder, QuartznetEncoder
from thunder_tpu_torch.module import CTCModule, chunked_transcribe
from thunder_tpu_torch.ops.ctc_beam_device import beam_search_device_stream
from thunder_tpu_torch.ops.masking import lengths_to_mask, masked_mean_std
from thunder_tpu_torch.text import BatchTextTransformer, NGramLM, WordFusionLM, WordNGramLM

torch.set_num_threads(2)

TOKENS = list("abc ")
SR = 16000


@pytest.fixture(scope="module")
def pair():
    """The JAX package's streaming-test module and the port's module with its weights."""
    tt = JaxText(tokens=TOKENS)
    jax_module = JaxModule.create(
        jax.random.PRNGKey(0),
        audio_transform=JaxFilterbank(),
        encoder=JaxQuartznet(filters=(64,), kernel_sizes=(11,), repeat=2, repeat_blocks=1),
        decoder=JaxDecoder(num_classes=tt.num_tokens),
        text_transform=tt,
        sample_len=1600,
    )
    port = CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(),
                            QuartznetEncoder(filters=(64,), kernel_sizes=(11,), repeat=2, repeat_blocks=1),
                            Conv1dDecoder(len(TOKENS) + 1), BatchTextTransformer(TOKENS), device="cpu")
    port.model.load_state_dict(from_flax_variables(jax.tree_util.tree_map(np.asarray, jax_module.variables)))
    return jax_module, port


def _audio(seconds, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(seconds * SR)) * 0.2).astype(np.float32)


def _feed(stream, audio, sizes):
    partials, i, k = [], 0, 0
    while i < len(audio):
        n = sizes[k % len(sizes)]
        partials.append(stream.push(audio[i: i + n]))
        i, k = i + n, k + 1
    return partials, stream.flush()


def _chunked(port, audio, chunk_seconds, overlap_seconds, beam_width=None, **beam_kwargs):
    """``chunked_transcribe`` without the short path (``tests/test_streaming.py::reference``): every clip on the
    chunk grid at ``(1, chunk)``, as the stream decodes it; ``predict_long`` runs a clip of one chunk or less
    through ``predict`` at its own length, whose float32 sums on the CPU may round otherwise."""
    def ids(padded, lengths):
        _, preds, out_lengths = port.infer(padded, lengths)
        return preds, out_lengths

    def logits(padded, lengths):
        out, _, out_lengths = port.infer(padded, lengths)
        return out, out_lengths

    return chunked_transcribe(ids, port.text_transform, audio, chunk_seconds=chunk_seconds,
                              overlap_seconds=overlap_seconds, sample_rate=SR, logits_fn=logits,
                              blank_idx=port.blank_idx, beam_width=beam_width, beam_kwargs=beam_kwargs or None)


def _jax_lms(tt):
    return {"ngram": JaxNGramLM.from_texts(["abc cab", "cab abc", "a b c"], tt, order=3),
            "fusion": JaxWordFusionLM(JaxWordNGramLM(order=2).fit(["cab a", "a cab"]), tt, word_score=-0.2)}


def _port_lms(tt):
    return {"ngram": NGramLM.from_texts(["abc cab", "cab abc", "a b c"], tt, order=3),
            "fusion": WordFusionLM(WordNGramLM(order=2).fit(["cab a", "a cab"]), tt, word_score=-0.2)}


@pytest.mark.parametrize("total_s,sizes", [
    (3.7, [1600, 4000, 16000, 7000]),  # ragged pushes
    (4.0, [16000]),  # the stream ends on the chunk grid
    (1.0, [16000]),  # shorter than one chunk
    (2.0, [100]),  # exactly one chunk, tiny pushes
])
def test_greedy_stream_matches_jax(pair, total_s, sizes):
    jax_module, port = pair
    audio = _audio(total_s, int(total_s * 10))
    kw = dict(chunk_seconds=2.0, overlap_seconds=0.5)
    want_partials, want = _feed(JaxStream(jax_module, **kw), audio, sizes)
    partials, got = _feed(StreamingTranscriber(port, **kw), audio, sizes)
    assert got == want and partials == want_partials
    assert got == _chunked(port, audio, **kw)
    if audio.size > 2 * SR:
        assert got == port.predict_long(audio, **kw)
    assert all(got.startswith(p) for p in partials)


def test_greedy_stream_randomized_grids_match_jax(pair):
    jax_module, port = pair
    rng = np.random.default_rng(123)
    for trial in range(3):
        kw = dict(chunk_seconds=1.25 + 0.25 * int(rng.integers(0, 5)), overlap_seconds=float(rng.uniform(0.2, 0.8)))
        audio = _audio(float(rng.uniform(0.5, 6.0)), 100 + trial)
        sizes = [int(n) for n in rng.integers(50, 20000, 40)]
        want_partials, want = _feed(JaxStream(jax_module, **kw), audio, sizes)
        partials, got = _feed(StreamingTranscriber(port, **kw), audio, sizes)
        assert (got, partials) == (want, want_partials), (trial, kw)
        assert got == _chunked(port, audio, **kw)
        assert all(got.startswith(p) for p in partials)


def test_engine_stream_matches_jax_and_refuses_pushes_after_flush(pair):
    jax_module, port = pair
    audio = _audio(3.2, 5)
    kw = dict(chunk_seconds=2.0, overlap_seconds=0.5)
    want = _feed(JaxStream(JaxEngine(jax_module, compute_dtype=jnp.float32), **kw), audio, [audio.size])
    stream = StreamingTranscriber(InferenceEngine(port), **kw)
    assert _feed(stream, audio, [audio.size]) == want
    with pytest.raises(RuntimeError, match=r"push\(\) after flush\(\)"):
        stream.push(audio[:100])


@pytest.mark.parametrize("backend", ["host", "device"])
def test_beam_stream_matches_jax_and_predict_long(pair, backend):
    jax_module, port = pair
    audio = _audio(4.0, 21 if backend == "host" else 33)
    kw = dict(chunk_seconds=1.5, overlap_seconds=0.5, beam_width=8, beam_backend=backend)
    sizes = [7000, 16000, 1000, 25000, 9000, 100000]
    want_partials, want = _feed(JaxStream(jax_module, **kw), audio, sizes)
    partials, got = _feed(StreamingTranscriber(port, **kw), audio, sizes)
    assert (got, partials) == (want, want_partials)
    assert got == port.predict_long(audio, **kw) == jax_module.predict_long(audio, **kw)
    # one window, shorter than a chunk
    short = audio[:SR]
    got = _feed(StreamingTranscriber(port, **kw), short, [short.size])[1]
    assert got == _chunked(port, short, **kw) == _feed(JaxStream(jax_module, **kw), short, [short.size])[1]


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("lm_name", ["ngram", "fusion"])
def test_lm_stream_matches_jax_and_predict_long(pair, backend, lm_name):
    jax_module, port = pair
    audio = _audio(4.2, 5)
    kw = dict(chunk_seconds=2.0, overlap_seconds=0.5, beam_width=4, beam_backend=backend, lm_weight=0.8)
    jax_lm = _jax_lms(jax_module.text_transform)[lm_name]
    lm = _port_lms(port.text_transform)[lm_name]
    want_partials, want = _feed(JaxStream(jax_module, lm=jax_lm, **kw), audio, [9000])
    partials, got = _feed(StreamingTranscriber(port, lm=lm, **kw), audio, [9000])
    assert (got, partials) == (want, want_partials)
    assert got == port.predict_long(audio, lm=lm, **kw)


def test_device_window_padded_to_a_bucket_gives_the_same_beams():
    # predict_long pads each device window to a 64-frame bucket and passes its length; the stream does not pad
    rng = np.random.default_rng(4)
    kw = dict(blank=4, beam_width=6, max_tokens_per_step=None, device="cpu")
    plain = padded = None
    for frames in (37, 64, 5, 90):
        win = torch.as_tensor(rng.standard_normal((1, frames, 5)).astype(np.float32) * 2)
        plain = beam_search_device_stream(win, state=plain, **kw)
        bucket = max(64, -(-frames // 64) * 64)
        padded = beam_search_device_stream(torch.nn.functional.pad(win, (0, 0, 0, bucket - frames)),
                                           lengths=[frames], state=padded, **kw)
        np.testing.assert_array_equal(padded.total, plain.total)
        for a, b in zip(plain.prefixes[0], padded.prefixes[0]):
            assert (a is None and b is None) or a.tolist() == b.tolist()


def _interleaved(pool, sids, feeds, sizes):
    cursors = [0] * len(feeds)
    while any(c < len(f) for c, f in zip(cursors, feeds)):
        for k, (sid, audio) in enumerate(zip(sids, feeds)):
            if cursors[k] < len(audio):
                step = sizes[(k + cursors[k] // 5000) % len(sizes)]
                pool.push(sid, audio[cursors[k]: cursors[k] + step])
                cursors[k] += step
    return [pool.flush(sid) for sid in sids]


@pytest.mark.parametrize("batch_size", [1, 3, 8])
@pytest.mark.parametrize("beam", [False, True], ids=["greedy", "beam"])
def test_pool_matches_lone_streams_and_jax(pair, batch_size, beam):
    jax_module, port = pair
    kw = dict(chunk_seconds=2.0, overlap_seconds=0.5, **({"beam_width": 4} if beam else {}))
    feeds = [_audio(s, 7 + k) for k, s in enumerate((3.7, 5.2, 2.0))]
    lone = [_feed(StreamingTranscriber(port, **kw), f, [f.size])[1] for f in feeds]
    sizes = [4100, 16000, 7000]
    pool = StreamingPool(port, batch_size=batch_size, **kw)
    got = _interleaved(pool, [pool.open() for _ in feeds], feeds, sizes)
    jax_pool = JaxPool(jax_module, batch_size=batch_size, **kw)
    want = _interleaved(jax_pool, [jax_pool.open() for _ in feeds], feeds, sizes)
    assert got == lone == want


def test_device_beam_pool_matches_lone_streams_and_jax(pair):
    jax_module, port = pair
    kw = dict(chunk_seconds=2.0, overlap_seconds=0.5, beam_width=4, beam_backend="device")
    feeds = [_audio(s, 11 + k) for k, s in enumerate((3.0, 4.5))]
    lone = [_feed(StreamingTranscriber(port, **kw), f, [f.size])[1] for f in feeds]
    pool = StreamingPool(port, batch_size=2, **kw)
    sids = [pool.open() for _ in feeds]
    for sid, f in zip(sids, feeds):
        pool.push(sid, f)
    got = [pool.flush(sid) for sid in sids]
    jax_pool = JaxPool(jax_module, batch_size=2, **kw)
    jax_sids = [jax_pool.open() for _ in feeds]
    for sid, f in zip(jax_sids, feeds):
        jax_pool.push(sid, f)
    assert got == lone == [jax_pool.flush(sid) for sid in jax_sids]


def test_pool_with_word_fusion_matches_lone_stream_and_jax(pair):
    jax_module, port = pair
    kw = dict(chunk_seconds=2.0, overlap_seconds=0.5, beam_width=4, lm_weight=0.8)
    audio = _audio(4.4, 9)
    results = []
    for pool_cls, stream_cls, module, lm in (
            (StreamingPool, StreamingTranscriber, port, _port_lms(port.text_transform)["fusion"]),
            (JaxPool, JaxStream, jax_module, _jax_lms(jax_module.text_transform)["fusion"])):
        lone = _feed(stream_cls(module, lm=lm, **kw), audio, [audio.size])[1]
        pool = pool_cls(module, batch_size=4, lm=lm, **kw)
        a, b = pool.open("a"), pool.open("b")
        for i in range(0, len(audio), 9000):
            pool.push(a, audio[i: i + 9000])
            pool.push(b, audio[i: i + 9000])
        pool.drain()
        results.append((lone, pool.flush(a), pool.flush(b)))
    assert results[0] == results[1] and len(set(results[0])) == 1


def test_pool_threaded_pushes_match_lone_streams(pair):
    _, port = pair
    kw = dict(chunk_seconds=2.0, overlap_seconds=0.5)
    feeds = [_audio(s, 13 + k) for k, s in enumerate((3.3, 4.1, 2.6, 3.8))]
    want = [_feed(StreamingTranscriber(port, **kw), f, [f.size])[1] for f in feeds]
    pool = StreamingPool(InferenceEngine(port), batch_size=3, **kw)
    sids = [pool.open() for _ in feeds]
    errors = []

    def feed(sid, audio):
        try:
            for i in range(0, len(audio), 6000):
                pool.push(sid, audio[i: i + 6000])
        except Exception as err:  # surfaced below: a thread's exception would otherwise be lost
            errors.append(err)

    threads = [threading.Thread(target=feed, args=(sid, audio)) for sid, audio in zip(sids, feeds)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    assert [pool.flush(sid) for sid in sids] == want


def test_greedy_pool_never_touches_the_logits(pair, monkeypatch):
    _, port = pair

    class Untouchable:
        def __getattr__(self, name):
            raise AssertionError(f"the greedy path read the logits ({name})")

        def __getitem__(self, key):
            raise AssertionError("the greedy path read the logits")

    infer = port.infer
    monkeypatch.setattr(port, "infer", lambda audio, lengths: (Untouchable(), *infer(audio, lengths)[1:]))
    audio = _audio(3.0, 2)
    pool = StreamingPool(port, batch_size=2, chunk_seconds=1.0, overlap_seconds=0.25)
    sid = pool.open()
    pool.push(sid, audio)
    lone = StreamingTranscriber(port, chunk_seconds=1.0, overlap_seconds=0.25)
    lone.push(audio)
    assert pool.flush(sid) == lone.flush()


def test_argument_and_lifecycle_errors(pair):
    _, port = pair
    for kwargs in ({"prune_logp": -5.0}, {"lm_weight": 0.3}, {"beam_backend": "device"}):
        with pytest.raises(TypeError, match="without beam_width"):
            StreamingTranscriber(port, **kwargs)
    with pytest.raises(ValueError, match="overlap"):
        StreamingTranscriber(port, chunk_seconds=0.4, overlap_seconds=2.0)
    with pytest.raises(ValueError, match="does not support"):
        StreamingTranscriber(port, beam_width=4, beam_backend="device", nbest=2)
    with pytest.raises(TypeError, match="CTCModule or InferenceEngine"):
        StreamingTranscriber(object())
    # an LM on the device backend is accepted (it ranks the carried beam on the host)
    StreamingTranscriber(port, beam_width=4, beam_backend="device", lm=lambda ids, tok: 0.0)

    pool = StreamingPool(port, batch_size=2, chunk_seconds=2.0, overlap_seconds=0.5)
    sid = pool.open()
    with pytest.raises(ValueError, match="already open"):
        pool.open(sid)
    with pytest.raises(KeyError):
        pool.push("nope", np.zeros(10, np.float32))
    pool.flush(sid)
    with pytest.raises(KeyError):
        pool.push(sid, np.zeros(10, np.float32))  # a flushed stream is removed
    pool.open(1)
    assert pool.open() != 1  # user-chosen and automatic ids never collide
    with pytest.raises(TypeError):
        StreamingPool(port, lm_weight=0.3)
    with pytest.raises(ValueError, match="batch_size"):
        StreamingPool(port, batch_size=0)


def test_batch_invariant_engine_pool_matches_lone_streams_and_jax(pair):
    """The float64 sums change the float32 logits by rounding only (1e-5 absolute against the default engine),
    and a pool on the engine equals its lone streams and the JAX pool."""
    jax_module, port = pair
    engine, default = InferenceEngine(port, batch_invariant=True), InferenceEngine(port)
    audio = np.stack([_audio(2.0, 21 + k) for k in range(3)])
    lengths = np.array([32000, 20000, 7000], np.int32)
    got, want = engine.infer(audio, lengths), default.infer(audio, lengths)
    torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=0)
    assert torch.equal(got[2], want[2])
    kw = dict(chunk_seconds=2.0, overlap_seconds=0.5)
    feeds = [_audio(s, 17 + k) for k, s in enumerate((3.4, 4.9, 2.2))]
    lone = [_feed(StreamingTranscriber(engine, **kw), f, [f.size])[1] for f in feeds]
    pool = StreamingPool(engine, batch_size=3, **kw)
    texts = _interleaved(pool, [pool.open() for _ in feeds], feeds, [4100, 16000, 7000])
    jax_pool = JaxPool(jax_module, batch_size=3, **kw)
    jax_texts = _interleaved(jax_pool, [jax_pool.open() for _ in feeds], feeds, [4100, 16000, 7000])
    assert texts == lone == jax_texts


def test_masked_statistics_in_float64_round_to_the_input_dtype():
    """``masked_mean_std(sum_dtype=float64)``: float32 statistics within 1e-6 of the float32 sums' (relative)."""
    rng = np.random.default_rng(5)
    x = torch.as_tensor((rng.standard_normal((3, 50, 7)) * 4 + 2).astype(np.float32))
    mask = lengths_to_mask(torch.tensor([50, 31, 1]), 50)[:, :, None]
    mean, std = masked_mean_std(x, mask, axis=1, sum_dtype=torch.float64)
    want_mean, want_std = masked_mean_std(x, mask, axis=1)
    assert mean.dtype == std.dtype == torch.float32
    torch.testing.assert_close(mean, want_mean, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(std, want_std, rtol=1e-6, atol=1e-6)


def _citrinet():
    return CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(nfilt=80),
                            CitrinetEncoder(filters=(64, 64), kernel_sizes=(11, 13), strides=(1, 2), repeat=2),
                            Conv1dDecoder(len(TOKENS) + 1), BatchTextTransformer(TOKENS), device="cpu")


class _PassThrough(torch.nn.Module):
    """An encoder the engine has no plan for: it serves it through the module's forward."""

    final_dimension = 64

    def forward(self, x, lengths, train=False, generator=None):
        return x, lengths


def test_batch_invariant_is_a_quartznet_mode():
    # QuartzNet's, Citrinet's and wav2vec2's (a row at a time): any other encoder is refused
    from thunder_tpu_torch.audio import Wav2Vec2Preprocess
    from thunder_tpu_torch.models import LinearDecoder, Wav2Vec2Config, Wav2Vec2Encoder

    assert InferenceEngine(_citrinet(), batch_invariant=True).batch_invariant
    w2v = CTCModule.create(torch.Generator().manual_seed(0), Wav2Vec2Preprocess(),
                           Wav2Vec2Encoder(Wav2Vec2Config(hidden_size=64, num_hidden_layers=1, num_attention_heads=1,
                                                          intermediate_size=64, conv_dim=(32,), conv_kernel=(10,),
                                                          conv_stride=(5,), num_conv_pos_embeddings=16,
                                                          num_conv_pos_embedding_groups=4)),
                           LinearDecoder(len(TOKENS) + 1), BatchTextTransformer(TOKENS), device="cpu")
    assert InferenceEngine(w2v, batch_invariant=True).batch_invariant
    other = CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(nfilt=64), _PassThrough(),
                             Conv1dDecoder(len(TOKENS) + 1), BatchTextTransformer(TOKENS), device="cpu")
    with pytest.raises(ValueError, match="batch_invariant is a QuartzNet, Citrinet and wav2vec2 serving mode"):
        InferenceEngine(other, batch_invariant=True)


def test_batch_invariant_citrinet_pool_matches_lone_streams():
    """Citrinet's float64 squeeze-excite gates change the logits by rounding only (1e-5 against the default
    engine); a row of a batch is bit-equal to the row alone, and a pool equals its lone streams."""
    citrinet = _citrinet()
    engine, default = InferenceEngine(citrinet, batch_invariant=True), InferenceEngine(citrinet)
    audio = np.stack([_audio(2.0, 31 + k) for k in range(3)])
    lengths = np.array([32000, 20000, 7000], np.int32)
    got, want = engine.infer(audio, lengths), default.infer(audio, lengths)
    torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=0)
    assert torch.equal(got[2], want[2])
    for row in range(3):
        alone = engine.infer(audio[row: row + 1], lengths[row: row + 1])[0]
        assert torch.equal(alone[0], got[0][row])
    kw = dict(chunk_seconds=2.0, overlap_seconds=0.5)
    feeds = [_audio(s, 41 + k) for k, s in enumerate((3.4, 4.9, 2.2))]
    lone = [_feed(StreamingTranscriber(engine, **kw), f, [f.size])[1] for f in feeds]
    pool = StreamingPool(engine, batch_size=3, **kw)
    assert _interleaved(pool, [pool.open() for _ in feeds], feeds, [4100, 16000, 7000]) == lone
