"""The traffic generators: the same seed gives the same batches; the shapes are the same for every seed."""

import numpy as np

from asrbench.tests import tiny
from asrbench.traffic import corpus, serve_batch, train


def test_corpus_matches_its_source():
    lengths = corpus.lognormal_lengths(dict(clips=1024, median_s=6.0, sigma=0.65, min_s=1.0, max_s=35.0))
    assert len(lengths) == 1024 and lengths.min() == 16000 and lengths.max() == 35 * 16000
    assert 7.0 < lengths.mean() / 16000 < 7.8  # LibriSpeech test-clean: 7.4 s
    batches = corpus.pack(lengths, 960)
    assert sorted(i for b in batches for i in b) == list(range(1024))
    assert all(len(b) * corpus.bucket(max(lengths[i] for i in b)) <= 960 * 16000 for b in batches)
    assert len(batches) == 10 and len(corpus.pack(lengths, 240)) == 36


def _serve(seed):
    return serve_batch.build_batches(tiny.ctx("quartznet15x5.serve", seed=seed))


def test_serve_batches_repeat_by_seed_and_keep_their_shapes():
    a, b, c = _serve(11), _serve(11), _serve(2**31 + 7)
    assert all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1]) for x, y in zip(a, b))
    assert [x[0].shape for x in a] == [x[0].shape for x in c]
    assert all(np.array_equal(x[1], y[1]) for x, y in zip(a, c))
    assert not np.array_equal(a[0][0], c[0][0])


def test_serve_sample_holds_the_longest_clip():
    host = _serve(3)
    picked = serve_batch.sample(host, 3, 3, 4)
    last = len(host) - 1
    assert last in picked and int(np.argmax(host[last][1])) in picked[last]
    assert picked == serve_batch.sample(host, 3, 3, 4)


def _pool(cell, seed):
    return train.make_pool(tiny.ctx(cell, seed=seed))


def test_train_pool_repeats_by_seed_and_pads_every_text_to_one_bucket():
    for cell in ("wav2vec2-base-960h.finetune", "quartznet15x5.train"):
        a, b, c = _pool(cell, 5), _pool(cell, 5), _pool(cell, 2**31 + 9)
        assert all(np.array_equal(x[0], y[0]) and x[2] == y[2] for x, y in zip(a, b))
        assert [x[0].shape for x in a] == [x[0].shape for x in c]
        assert sorted(np.concatenate([x[1] for x in a])) == sorted(np.concatenate([x[1] for x in c]))
        widths = {-(-max(len(t) for t in x[2]) // 32) for x in a + c}
        assert len(widths) == 1


def test_full_size_train_texts_pad_to_one_bucket():
    """At the cells' sizes (10-15 s clips, 14 characters a second) every batch's longest text pads to 224."""
    for batch in (8, 16):
        lengths = corpus.uniform_lengths(12 * batch, 10.0, 15.0)[::-1]
        longest = lengths[:12]  # one of the pool's longest a batch
        chars = np.round(14.0 * longest / 16000).astype(int)
        assert chars.min() > 192 and np.round(14.0 * lengths / 16000).max() <= 224
