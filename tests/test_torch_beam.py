"""The port's CTC prefix beam search against the JAX package (CPU).

- The plain scan and backtrace (the CPU route of ``kernels/beam.py``)
  against ``beam_scan_pallas``/``beam_backtrace_pallas`` in interpret mode,
  on the same log-probs: pointers, exts and the integer state exactly; the
  float state and ``total`` to 1e-6 (both sides compute the same float32
  operations).
- ``beam_search_device`` and ``beam_search_device_stream`` against the JAX
  package's device search (its XLA scan) and its numpy host search:
  hypotheses exactly, scores to 2e-3 (``tests/test_ctc_beam_device.py:67``:
  the host search sums in float64).
- The port's numpy host search against the JAX package's numpy reference.
- ``CTCModule.predict``/``predict_long`` and ``InferenceEngine.predict``/
  ``predict_long`` with both backends against the JAX package's, on a tiny
  QuartzNet whose weights go through the bridge; the argument errors word
  for word.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.audio import FilterbankFeatures as JaxFilterbank
from thunder_tpu.engine import InferenceEngine as JaxEngine
from thunder_tpu.kernels.beam_pallas import beam_backtrace_pallas, beam_scan_pallas
from thunder_tpu.models import Conv1dDecoder as JaxDecoder
from thunder_tpu.models import QuartznetEncoder as JaxQuartznet
from thunder_tpu.module import CTCModule as JaxModule
from thunder_tpu.ops import ctc_beam as jax_host
from thunder_tpu.ops import ctc_beam_device as jax_device
from thunder_tpu.text import BatchTextTransformer as JaxText
from thunder_tpu_torch.audio import FilterbankFeatures
from thunder_tpu_torch.bridge import from_flax_variables
from thunder_tpu_torch.engine import InferenceEngine
from thunder_tpu_torch.kernels import KERNEL_WRAPPERS
from thunder_tpu_torch.kernels.beam import (
    MAX_BEAM_WIDTH,
    MAX_CANDIDATES,
    MAX_SHARED_BYTES,
    beam_backtrace,
    beam_scan,
    scan_chunks,
    scan_fits,
    scan_plan,
)
from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
from thunder_tpu_torch.module import CTCModule
from thunder_tpu_torch.ops import ctc_beam as host
from thunder_tpu_torch.ops.ctc_beam_device import beam_search_device, beam_search_device_stream
from thunder_tpu_torch.text import BatchTextTransformer

torch.set_num_threads(2)

SCORE_ATOL = 2e-3


def _logits(seed, b, t, v, scale=2.0):
    return np.random.default_rng(seed).normal(0.0, scale, (b, t, v)).astype(np.float32)


def _log_softmax(logits):
    return np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))


def _assert_state_equal(want, got):
    for a, b in zip(want[:2], got[:2]):
        a, b = np.asarray(a), b.numpy()
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        np.testing.assert_allclose(a[np.isfinite(a)], b[np.isfinite(b)], rtol=0, atol=1e-6)
    for a, b in zip(want[2:], got[2:]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# (seed, B, T, V, W, K, prune floor, lengths, carried state)
SCAN_CASES = {
    "fresh_k_eq_v": (0, 3, 29, 9, 8, 9, -12.0, None, False),
    "carried_state": (1, 2, 19, 9, 5, 9, -12.0, None, True),
    "k_lt_v": (2, 3, 23, 9, 6, 4, -10.0, [23, 11, 3], False),
    "zero_length_row": (3, 3, 17, 7, 4, 7, -12.0, [17, 0, 9], False),
    "floor_empties_frames": (4, 2, 12, 8, 6, 8, -2.0, None, False),
    "beam_of_one": (5, 2, 21, 9, 1, 9, -12.0, [21, 8], False),
    # integer-valued logits: equal log-probs and equal candidate totals, ordered by index alone
    "exact_ties": (6, 3, 15, 9, 8, 9, -12.0, [15, 9, 15], False),
    # a high floor leaves fewer finite candidates than W = 40: the dead picks are index 0
    "dead_picks_wide_beam": (7, 2, 10, 9, 40, 9, -1.5, None, False),
    # K < V with W*K = 800 candidates a frame (Citrinet's top-K width)
    "k_lt_v_wide": (8, 2, 4, 300, 16, 50, -12.0, None, False),
}


@pytest.mark.parametrize("name", sorted(SCAN_CASES))
def test_plain_scan_and_backtrace_match_pallas_interpret(name):
    seed, b, t, v, w, k, floor, lengths, carried = SCAN_CASES[name]
    logits = _logits(seed, b, t, v)
    if name == "floor_empties_frames":
        logits[:, [2, 5, 6]] = 0.0  # flat frames: every log-prob is -log(8), under the floor
    if name == "exact_ties":
        logits = np.round(logits)
    logp = _log_softmax(logits)
    lengths = np.full(b, t, np.int32) if lengths is None else np.asarray(lengths, np.int32)
    kw = dict(blank=v - 1, beam_width=w, k_tokens=k)
    init = None
    if carried:  # the state after other frames, as a previous window leaves it
        first = _log_softmax(_logits(seed + 50, b, 7, v))
        _, _, _, state = beam_scan_pallas(jnp.asarray(first), jnp.full((b,), 7, jnp.int32), floor, interpret=True, **kw)
        init = tuple(np.array(a) for a in state)
    jp, je, jt, js = beam_scan_pallas(jnp.asarray(logp), jnp.asarray(lengths), floor, interpret=True,
                                      init_state=None if init is None else tuple(map(jnp.asarray, init)), **kw)
    tp, te, tt, ts = beam_scan(torch.as_tensor(logp), torch.as_tensor(lengths), floor,
                               init_state=None if init is None else tuple(map(torch.as_tensor, init)), **kw)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_array_equal(np.asarray(je), te.numpy())
    _assert_state_equal(js, ts)
    _assert_state_equal((jt,), (tt,))
    if name == "floor_empties_frames":  # some frames were skipped: identity pointers, no emission
        assert bool(((te == -1).all(-1) & (tp == torch.arange(w)).all(-1)).any())
    if name == "dead_picks_wide_beam":  # dead slots remain at the end
        assert bool((ts[2] == -1).any())
    slots0 = np.argsort(-np.asarray(jt), axis=1, kind="stable")[:, : min(3, w)].astype(np.int32)
    jk, jo = beam_backtrace_pallas(jp, je, jnp.asarray(slots0))
    tk, to = beam_backtrace(tp, te, torch.as_tensor(slots0))
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    np.testing.assert_array_equal(np.asarray(jo), to.numpy())


def test_scan_plan_takes_every_width_up_to_2048_and_the_serving_shapes():
    for w in range(1, 2049):
        k = MAX_CANDIDATES // w
        assert scan_plan(w, k)["smem_bytes"] <= MAX_SHARED_BYTES, (w, k)
    # QuartzNet: a thread a candidate; Citrinet's top-K: 26 runs on 16 warps; both in one block
    assert scan_plan(16, 29) == {"threads": 480, "smem_bytes": 5464, "chunk_runs": 0}
    assert scan_plan(16, 50) == {"threads": 512, "smem_bytes": 8616, "chunk_runs": 0}
    assert scan_plan(40, 29)["threads"] == 1024  # above a warp: 1200 candidates, some threads take two
    assert scan_plan(1, 29)["threads"] == 32
    assert scan_plan(3058, 1)["smem_bytes"] > MAX_SHARED_BYTES


def test_wrappers_count_no_launch_on_the_cpu():
    before = [w.launches for w in KERNEL_WRAPPERS]
    beam_search_device(_logits(0, 2, 9, 5), beam_width=4, device="cpu")
    assert [w.launches for w in KERNEL_WRAPPERS] == before


def _same_hyps(want, got):
    assert [h.tolist() for h in want] == [g.tolist() for g in got]


def _same_nbest(want, got):
    assert len(want) == len(got)
    for wrow, grow in zip(want, got):
        assert [ids.tolist() for ids, _ in wrow] == [ids.tolist() for ids, _ in grow]
        for (_, ws), (_, gs) in zip(wrow, grow):
            assert gs == pytest.approx(ws, abs=SCORE_ATOL)


@pytest.mark.parametrize("seed", range(3))
def test_device_search_matches_jax_best_path(seed):
    rng = np.random.default_rng(seed)
    b, t, v = 4, 37, 11
    logits = _logits(seed, b, t, v)
    lengths = rng.integers(1, t + 1, size=b)
    lengths[0] = t
    kw = dict(blank=v - 1, beam_width=8, prune_logp=-12.0, max_tokens_per_step=6)
    got = beam_search_device(logits, lengths=lengths, device="cpu", **kw)
    _same_hyps(jax_device.beam_search_device(logits, lengths=lengths, use_pallas=False, **kw), got)
    _same_hyps(jax_host.beam_search_decode(logits, lengths=lengths, use_native=False, **kw), got)


@pytest.mark.parametrize("seed", [0, 1])
def test_device_search_matches_jax_nbest(seed):
    logits = _logits(100 + seed, 3, 25, 9)
    lengths = np.array([25, 13, 2])
    kw = dict(blank=8, beam_width=8, nbest=4, prune_logp=-12.0, max_tokens_per_step=5)
    got = beam_search_device(torch.as_tensor(logits), lengths=torch.as_tensor(lengths), **kw)  # a CPU tensor
    _same_nbest(jax_device.beam_search_device(logits, lengths=lengths, use_pallas=False, **kw), got)
    _same_nbest(jax_host.beam_search_nbest(logits, lengths=lengths, use_native=False, **kw), got)


def test_device_search_peaked_logits_give_the_collapsed_path():
    v, blank = 6, 5
    path = [1, 1, blank, 2, 2, 3, blank, blank, 3, 4]
    logits = np.full((1, len(path), v), -8.0, np.float32)
    logits[0, np.arange(len(path)), path] = 8.0
    logits += np.random.default_rng(7).normal(0, 0.01, logits.shape).astype(np.float32)
    (got,) = beam_search_device(logits, blank=blank, beam_width=4, device="cpu")
    assert got.tolist() == [1, 2, 3, 3, 4]


def test_device_search_prune_floor_and_zero_length_row():
    logits = _logits(11, 2, 12, 8, scale=0.3)  # flat: log-probs near -2.1, under the floor on some frames
    kw = dict(blank=7, beam_width=6, prune_logp=-2.0, max_tokens_per_step=8)
    got = beam_search_device(logits, device="cpu", **kw)
    _same_hyps(jax_host.beam_search_decode(logits, use_native=False, **kw), got)
    _same_hyps(jax_device.beam_search_device(logits, use_pallas=False, **kw), got)
    logits = _logits(3, 2, 10, 7)
    got = beam_search_device(logits, lengths=[0, 10], blank=6, beam_width=4, device="cpu")
    assert got[0].tolist() == []
    assert got[1].tolist() == jax_host.beam_search_decode(logits, lengths=[0, 10], blank=6, beam_width=4,
                                                          use_native=False)[1].tolist()


def test_device_search_wide_beam_full_vocabulary():
    logits = _logits(21, 2, 20, 10)
    kw = dict(blank=0, beam_width=16, max_tokens_per_step=None)
    got = beam_search_device(logits, device="cpu", **kw)
    _same_hyps(jax_host.beam_search_decode(logits, use_native=False, **kw), got)
    _same_hyps(jax_device.beam_search_device(logits, use_pallas=False, **kw), got)


def test_device_search_no_frames_and_the_candidate_limit():
    empty = np.zeros((2, 0, 7), np.float32)
    assert [h.tolist() for h in beam_search_device(empty, beam_width=4, device="cpu")] == [[], []]
    nb = beam_search_device(empty, beam_width=4, nbest=2, device="cpu")
    assert [[(ids.tolist(), s) for ids, s in row] for row in nb] == [[([], 0.0)], [([], 0.0)]]
    # any K a step (past one block of shared memory the kernel walks a frame in chunks); the limit is the beam's
    big = np.zeros((1, 5, 3000), np.float32)
    assert len(beam_search_device(big, beam_width=16, max_tokens_per_step=None, device="cpu")) == 1
    wide = np.zeros((1, 5, 7), np.float32)
    with pytest.raises(ValueError, match="beam_width"):
        beam_search_device(wide, beam_width=MAX_BEAM_WIDTH + 1, max_tokens_per_step=None, device="cpu")
    with pytest.raises(ValueError, match="beam_width"):
        beam_search_device_stream(wide, beam_width=MAX_BEAM_WIDTH + 1, max_tokens_per_step=None, device="cpu")
    with pytest.raises(ValueError, match="beam_width"):
        beam_scan(torch.zeros((1, 5, 7)), torch.full((1,), 5), -12.0, blank=0, beam_width=MAX_BEAM_WIDTH + 1,
                  k_tokens=7)
    # exactly 8192 candidates a frame is allowed
    assert len(beam_search_device(np.zeros((1, 2, 512), np.float32), beam_width=16, max_tokens_per_step=None,
                                  device="cpu")) == 1


@pytest.mark.parametrize("b,t,v,width,k", [(2, 6, 1025, 16, None), (2, 8, 29, 300, None), (1, 4, 29, 300, 28)])
def test_device_search_past_8192_candidates_matches_the_reference(b, t, v, width, k):
    """Citrinet's V = 1025 at W = 16 with every token a step, and W = 300 on V = 29: more candidates a frame
    than the JAX package's device search takes, within the scan's block; the JAX package's XLA scan's
    hypotheses and scores, and the host search's hypotheses."""
    logits = _logits(24, b, t, v)
    kw = dict(blank=0, beam_width=width, max_tokens_per_step=k)
    for nbest in (None, 3):
        got = beam_search_device(logits, nbest=nbest, device="cpu", **kw)
        want = jax_device.beam_search_device(logits, use_pallas=False, nbest=nbest, **kw)
        (_same_hyps if nbest is None else _same_nbest)(want, got)
    want = jax_host.beam_search_decode(logits, use_native=False, **kw)
    _same_hyps(want, beam_search_device(logits, device="cpu", **kw))


@pytest.mark.parametrize("width", [1, 16, 32, 33, 300, 2048])
@pytest.mark.parametrize("k", [29, 50, 1605, 1606, 3000, 30000])
def test_scan_plan_fits_and_its_chunks_cover_every_run_once(width, k):
    """The mirror of the kernel's plan: every plan fits in shared memory, the one-block plan is taken wherever
    its block fits, and a frame's chunks hold each extend row and each stay row once, in whole runs."""
    plan = scan_plan(width, k)
    assert plan["smem_bytes"] <= MAX_SHARED_BYTES and scan_fits(width)
    one_block = 4 * (18 * width + 64 * -(-(width + width * k) // 32) + 4 * k + 2)
    assert (plan["chunk_runs"] == 0) == (one_block <= MAX_SHARED_BYTES)
    chunks = scan_chunks(width, k)
    if plan["chunk_runs"] == 0:
        assert chunks == [("all", 0, width + width * k)]
        return
    size = 32 * plan["chunk_runs"]
    for rows, n in (("extend", width * k), ("stay", width)):
        spans = [(lo, hi) for r, lo, hi in chunks if r == rows]
        covered = np.zeros(n, np.int64)
        for lo, hi in spans:
            assert lo % 32 == 0 and 0 < hi - lo <= size
            covered[lo:hi] += 1
        assert (covered == 1).all()
    assert [r for r, _, _ in chunks] == sorted((r for r, _, _ in chunks), key=("extend", "stay").index)
    if width > 32:
        assert plan["chunk_runs"] <= 128


def test_device_search_takes_the_scan_up_to_its_block_and_refuses_past_it(monkeypatch):
    """Every K goes to ``beam_scan`` (the kernel on the card): in one block while it fits in shared memory
    (K = 1,605 at W = 16), in chunks past it; a beam_width whose state does not fit beside one chunk
    (``scan_fits``: W above 2,901) raises before any launch."""
    from thunder_tpu_torch.ops import ctc_beam_device

    calls = []
    real = ctc_beam_device.beam_scan

    def spy(*args, **kwargs):
        calls.append(kwargs["beam_width"] * kwargs["k_tokens"])
        return real(*args, **kwargs)

    monkeypatch.setattr(ctc_beam_device, "beam_scan", spy)
    assert scan_plan(16, 1605)["chunk_runs"] == 0 and scan_plan(16, 1606)["chunk_runs"] > 0
    assert MAX_BEAM_WIDTH == 2901 and scan_fits(2901) and not scan_fits(2902)
    for v, width, k in [(512, 16, None), (1605, 16, None), (1606, 16, None), (29, 300, None), (29, 300, 27)]:
        beam_search_device(_logits(25, 1, 3, v), blank=0, beam_width=width, max_tokens_per_step=k, device="cpu")
    assert calls == [MAX_CANDIDATES, 16 * 1605, 16 * 1606, 300 * 29, 300 * 27]
    with pytest.raises(ValueError, match="beam_width"):
        beam_search_device(_logits(25, 1, 3, 5), blank=0, beam_width=MAX_BEAM_WIDTH + 1, device="cpu")
    with pytest.raises(ValueError, match="shared memory"):
        beam_scan(torch.zeros((1, 3, 5)), torch.full((1,), 3), -12.0, blank=0, beam_width=MAX_BEAM_WIDTH + 1,
                  k_tokens=5)
    assert len(calls) == 5


@pytest.mark.parametrize("v", [1606, 3000])
def test_device_search_past_one_block_matches_the_reference(v):
    """Every token a step at W = 16 past the scan's one block (the chunked plan on the card): the JAX package's
    XLA scan's hypotheses and scores."""
    logits = _logits(26, 2, 25, v)
    kw = dict(blank=0, beam_width=16, max_tokens_per_step=None)
    for nbest in (None, 3):
        got = beam_search_device(logits, nbest=nbest, device="cpu", **kw)
        want = jax_device.beam_search_device(logits, use_pallas=False, nbest=nbest, **kw)
        (_same_hyps if nbest is None else _same_nbest)(want, got)


def test_device_search_ranks_with_a_duck_typed_lm():
    class LM:
        def __call__(self, prefix, token):
            return -0.4 * token + (0.3 if prefix and prefix[-1] != token else 0.0)

        def final_score(self, prefix):
            return -0.2 * len(prefix)

    logits = _logits(31, 3, 21, 6)
    kw = dict(blank=5, beam_width=6, lm=LM(), lm_weight=0.7)
    for nbest in (None, 3):
        want = jax_device.beam_search_device(logits, use_pallas=False, nbest=nbest, **kw)
        got = beam_search_device(logits, nbest=nbest, device="cpu", **kw)
        (_same_hyps if nbest is None else _same_nbest)(want, got)


def test_device_stream_matches_full_search_jax_and_host():
    b, t, v, w = 2, 45, 9, 8
    logits = _logits(77, b, t, v)
    kw = dict(blank=v - 1, beam_width=w, prune_logp=-12.0, max_tokens_per_step=None)
    windows = [(0, 17), (17, 30), (30, 45)]
    full = beam_search_device(logits, device="cpu", **kw)
    state = jstate = None
    for lo, hi in windows:
        state = beam_search_device_stream(logits[:, lo:hi], state=state, device="cpu", **kw)
        jstate = jax_device.beam_search_device_stream(logits[:, lo:hi], state=jstate, **kw)
    _same_hyps(full, state.best())
    _same_hyps(jstate.best(), state.best())
    np.testing.assert_allclose(state.total, np.asarray(jstate.total), rtol=0, atol=1e-5)
    for got, want in zip(state.arrays[2:], jstate.arrays[2:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for row in range(b):
        hs = None
        for lo, hi in windows:
            hs = host.beam_search_stream(host.log_softmax(logits[row, lo:hi]), v - 1, beam_width=w, prune_logp=-12.0,
                                         max_tokens_per_step=v, state=hs)
        assert hs.best.tolist() == state.best()[row].tolist()


def test_device_stream_ragged_windows_and_empty_windows():
    b, t, v, w = 3, 40, 7, 6
    logits = _logits(99, b, t, v)
    lengths = np.array([40, 26, 9])
    kw = dict(blank=v - 1, beam_width=w, max_tokens_per_step=None)
    full = beam_search_device(logits, lengths=lengths, device="cpu", **kw)
    state = None
    for lo, hi in [(0, 7), (7, 7), (7, 8), (8, 31), (31, 40), (40, 40)]:
        state = beam_search_device_stream(logits[:, lo:hi], lengths=np.clip(lengths - lo, 0, hi - lo), state=state,
                                          device="cpu", **kw)
    _same_hyps(full, state.best())
    fresh = beam_search_device_stream(logits[:, 0:0], device="cpu", **kw)
    assert [p.tolist() for p in fresh.best()] == [[], [], []]


# ---- the host (numpy) search


class _HostLM:
    def __call__(self, prefix, token):
        return -0.25 * token if token % 2 else 0.1

    def final_score(self, prefix):
        return 0.5 if prefix and prefix[-1] == 1 else -0.5


@pytest.mark.parametrize("lm", [None, _HostLM()], ids=["no_lm", "lm"])
def test_host_prefix_beam_search_matches_jax(lm):
    logp = host.log_softmax(_logits(5, 1, 30, 7)[0])
    np.testing.assert_array_equal(logp, jax_host.log_softmax(_logits(5, 1, 30, 7)[0]))
    for kw in (dict(), dict(prune_logp=-3.0, max_tokens_per_step=3), dict(finalize=True)):
        want = jax_host.prefix_beam_search(logp, 6, beam_width=5, lm=lm, lm_weight=0.6, **kw)
        got = host.prefix_beam_search(logp, 6, beam_width=5, lm=lm, lm_weight=0.6, **kw)
        assert [p for p, _ in got] == [p for p, _ in want]
        np.testing.assert_array_equal([s for _, s in got], [s for _, s in want])


def test_host_stream_nbest_and_decode_match_jax():
    logits = _logits(8, 2, 33, 6)
    logp = host.log_softmax(logits)
    state = jstate = None
    for lo, hi in [(0, 10), (10, 11), (11, 33)]:
        state = host.beam_search_stream(logp[0, lo:hi], 5, beam_width=4, lm=_HostLM(), state=state)
        jstate = jax_host.beam_search_stream(logp[0, lo:hi], 5, beam_width=4, lm=_HostLM(), state=jstate,
                                             use_native=False)
    assert state.beams == jstate.beams
    assert state.best_final(_HostLM(), 0.5).tolist() == jstate.best_final(_HostLM(), 0.5).tolist()
    assert state.best_partial().tolist() == jstate.best_partial().tolist()
    assert state.best_score == jstate.best_score
    kw = dict(lengths=[33, 20], blank=5, beam_width=6, lm=_HostLM())
    _same_hyps(jax_host.beam_search_decode(logits, use_native=False, **kw), host.beam_search_decode(logits, **kw))
    _same_nbest(jax_host.beam_search_nbest(logits, nbest=3, use_native=False, **kw),
                host.beam_search_nbest(logits, nbest=3, **kw))


# ---- CTCModule and InferenceEngine against the JAX package

TOKENS = list("abc ")


@pytest.fixture(scope="module")
def pair():
    """A tiny QuartzNet built in JAX (``tests/test_ctc_beam_device.py``'s fixture) and the port with its weights."""
    tt = JaxText(tokens=TOKENS)
    jax_module = JaxModule.create(
        jax.random.PRNGKey(0),
        audio_transform=JaxFilterbank(),
        encoder=JaxQuartznet(repeat=1, filters=(32,), kernel_sizes=(33,)),
        decoder=JaxDecoder(num_classes=tt.num_tokens),
        text_transform=tt,
        sample_len=4000,
    )
    port = CTCModule.create(torch.Generator().manual_seed(0), FilterbankFeatures(),
                            QuartznetEncoder(repeat=1, filters=(32,), kernel_sizes=(33,)),
                            Conv1dDecoder(len(TOKENS) + 1), BatchTextTransformer(TOKENS), device="cpu")
    port.model.load_state_dict(from_flax_variables(jax.tree_util.tree_map(np.asarray, jax_module.variables)))
    return jax_module, port


class _TokenLM:
    def __call__(self, prefix, token):
        return 0.4 if token == 1 else -0.2

    def final_score(self, prefix):
        return -0.1 * len(prefix)


def _same_texts(want, got, nbest):
    if not nbest:
        assert got == want
        return
    for wrow, grow in zip(want, got):
        assert [text for text, _ in grow] == [text for text, _ in wrow]
        for (_, ws), (_, gs) in zip(wrow, grow):
            assert gs == pytest.approx(ws, abs=SCORE_ATOL)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_predict_with_beam_matches_jax(pair, backend):
    jax_module, port = pair
    audio = np.random.default_rng(0).normal(0, 0.1, (2, 4000)).astype(np.float32)
    jax_engine = JaxEngine(jax_module, compute_dtype=jnp.float32, use_pallas=False)
    engine = InferenceEngine(port)
    for kw in (dict(), dict(nbest=3), dict(lm=_TokenLM(), lm_weight=0.8)):
        kw = dict(beam_width=8, beam_backend=backend, **kw)
        want = jax_module.predict(audio, **kw)
        _same_texts(want, port.predict(audio, **kw), kw.get("nbest"))
        _same_texts(jax_engine.predict(audio, **kw), engine.predict(audio, **kw), kw.get("nbest"))
    assert port.predict(audio, beam_width=8) == port.predict(audio, beam_width=8, beam_backend="device")


@pytest.mark.parametrize("backend", [None, "host", "device"], ids=["greedy", "host", "device"])
def test_predict_long_matches_jax(pair, backend):
    jax_module, port = pair
    rng = np.random.default_rng(4)
    clip = rng.normal(0, 0.1, 41000).astype(np.float32)  # three 1 s chunks with 0.25 s of overlap
    kw = dict(chunk_seconds=1.0, overlap_seconds=0.25)
    if backend is not None:
        kw.update(beam_width=4, beam_backend=backend)
    want = jax_module.predict_long(clip, **kw)
    assert port.predict_long(clip, **kw) == want
    assert InferenceEngine(port).predict_long(clip, **kw) == want
    # one chunk or less takes predict
    assert port.predict_long(clip[:12000], **kw) == jax_module.predict_long(clip[:12000], **kw)


def _raises_like(jax_call, port_call):
    with pytest.raises(Exception) as want:
        jax_call()
    with pytest.raises(Exception) as got:
        port_call()
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", [
    dict(beam_backend="device"),
    dict(nbest=2),
    dict(prune_logp=-5.0, lm_weight=0.2),
    dict(max_tokens_per_step=5),
    dict(beam_width=4, beam_backend="gpu"),
    dict(beam_width=4, beam_backend="device", prune_floor=1),
], ids=["backend_alone", "nbest_alone", "prune_and_weight", "kwarg_alone", "unknown_backend", "stray_device_kwarg"])
def test_beam_argument_errors_match_jax(pair, case):
    jax_module, port = pair
    audio = np.zeros((1, 4000), np.float32)
    _raises_like(lambda: jax_module.predict(audio, **case), lambda: port.predict(audio, **case))
    jax_engine = JaxEngine(jax_module, compute_dtype=jnp.float32, use_pallas=False)
    _raises_like(lambda: jax_engine.predict(audio, **case), lambda: InferenceEngine(port).predict(audio, **case))


@pytest.mark.parametrize("case", [
    dict(nbest=2),
    dict(beam_width=4, nbest=2),
    dict(lm_weight=0.5),
    dict(beam_width=4, beam_backend="device", use_native=True),
    dict(beam_width=4, beam_backend="tpu"),
], ids=["nbest_alone", "nbest", "weight_alone", "stray_device_kwarg", "unknown_backend"])
def test_predict_long_argument_errors_match_jax(pair, case):
    jax_module, port = pair
    clip = np.zeros(41000, np.float32)
    kw = dict(chunk_seconds=1.0, overlap_seconds=0.25, **case)
    _raises_like(lambda: jax_module.predict_long(clip, **kw), lambda: port.predict_long(clip, **kw))
