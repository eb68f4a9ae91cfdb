"""Incremental (streaming) transcription over an audio feed.

Port of ``thunder_tpu/streaming.py``. ``StreamingTranscriber`` wraps the
overlapped-chunk recipe (:func:`thunder_tpu_torch.module.chunked_transcribe`)
in a push API: feed sample buffers of any size as they arrive; each chunk is
decoded as soon as its full window (lookahead overlap included) is there, on
the same fixed chunk grid, so ``flush()`` returns exactly what
``predict_long`` gives for the concatenated audio. Each window is decoded at
the shape ``(1, chunk)``, as ``chunked_transcribe`` decodes it.

With ``beam_width`` the stream runs ONE continuous prefix beam search: each
chunk's trimmed window advances the carried beam state (the host's
:func:`thunder_tpu_torch.ops.ctc_beam.beam_search_stream`, or with
``beam_backend="device"`` :func:`thunder_tpu_torch.ops.ctc_beam_device.beam_search_device_stream`
on the window's logits where they lie), so ``flush()`` equals
``predict_long(beam_width=...)``.

``StreamingPool`` serves many streams: the windows that pushes complete,
across streams, run through the model in groups of exactly ``batch_size``
rows. The predictor is a ``CTCModule`` or an ``InferenceEngine``; both give
``infer(padded, lengths) -> (logits, argmax ids, out_lengths)`` on their
device. A pool's stream equals the same stream served alone only where a
row's forward does not depend on the rows beside it: on the card that is
checked for ``InferenceEngine(module, batch_invariant=True)`` on QuartzNet,
Citrinet and wav2vec2 modules (``chip_smoke.py``'s
``streaming_batch_invariance``, ``citrinet_streaming_batch_invariance``,
``w2v2_batch_invariance`` and pool phases). Elsewhere float32 sums may round
otherwise in a batch and part a stream at a near-tie: on the card every row
of a 64 x 1 s batch parts from the row alone on the default engines and a
``CTCModule`` predictor (``chip_smoke.py``'s ``parting_rows``).
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np

from thunder_tpu_torch.module import _BEAM_UNSET, check_beam_args, check_device_beam_kwargs, trim_chunk_ids

__all__ = ["StreamingTranscriber", "StreamingPool"]


def _make_infer(predictor):
    """``(module, infer)`` from a ``CTCModule`` or ``InferenceEngine``: ``infer(padded (B, chunk), lengths (B,))
    -> (logits, preds, out_lengths)`` on the predictor's device, for any B (1 for a lone stream, the pool's
    batch for concurrent streams)."""
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.module import CTCModule

    if isinstance(predictor, InferenceEngine):
        return predictor.module, predictor.infer
    if isinstance(predictor, CTCModule):
        return predictor, predictor.infer
    raise TypeError("predictor must be a CTCModule or InferenceEngine")


class StreamingTranscriber:
    """Push-based transcription built on a ``CTCModule`` or ``InferenceEngine``.

    Args:
        predictor: a ``CTCModule`` or ``InferenceEngine``.
        chunk_seconds / overlap_seconds / sample_rate: the chunk grid, as in
            ``predict_long``.
        beam_width: decode with carried-state prefix beam search instead of
            the greedy id-stitch; ``prune_logp``/``lm``/``lm_weight`` and
            further beam kwargs match ``predict``'s beam arguments.
        beam_backend: ``"host"`` (default; the C++ search with in-search LM
            fusion) or ``"device"``: the carried beam state stays on the
            device between chunks and each chunk's logits row is searched
            where it lies, never copied to the host. An ``lm`` on the device
            backend ranks the carried beam on the host on every partial and at
            flush (``DeviceBeamState.best_ranked``).
    """

    def __init__(
        self,
        predictor,
        chunk_seconds: float = 20.0,
        overlap_seconds: float = 2.0,
        sample_rate: int = 16000,
        beam_width: Optional[int] = None,
        prune_logp: float = _BEAM_UNSET,
        lm=None,
        lm_weight: float = _BEAM_UNSET,
        beam_backend: Optional[str] = None,
        **beam_kwargs,
    ):
        if beam_backend is not None and not beam_width:
            raise TypeError("beam-search arguments without beam_width: ['beam_backend']")
        check_beam_args(beam_width, beam_kwargs, prune_logp=prune_logp, lm=lm, lm_weight=lm_weight)
        check_device_beam_kwargs(beam_backend, lm, beam_kwargs)
        self.beam_backend = beam_backend
        self._module, self._infer = _make_infer(predictor)
        if self._module.text_transform is None:
            raise ValueError("streaming requires a text_transform")
        self.chunk = int(chunk_seconds * sample_rate)
        self.overlap = int(overlap_seconds * sample_rate)
        if self.overlap >= self.chunk:
            raise ValueError("overlap_seconds must be smaller than chunk_seconds")
        self.step = self.chunk - self.overlap
        self.beam_width = beam_width
        if beam_width:
            self._beam_kwargs = dict(beam_kwargs)
            self._beam_kwargs["prune_logp"] = -12.0 if prune_logp is _BEAM_UNSET else prune_logp
            if beam_backend != "device":
                self._beam_kwargs["lm"] = lm
                self._beam_kwargs["lm_weight"] = 0.5 if lm_weight is _BEAM_UNSET else lm_weight
            else:
                # the LM never enters the device search: it ranks the carried beam on the host
                self._device_lm = lm
                self._device_lm_weight = 0.5 if lm_weight is _BEAM_UNSET else lm_weight
        self._beam_state = None
        self._buffer = np.zeros((0,), np.float32)
        self._buffer_start = 0  # absolute sample index of _buffer[0]
        self._next_start = 0  # next chunk-grid position to decode
        self._pieces: List[np.ndarray] = []
        self._chunks_done = 0
        self._partial_cache = None  # (chunks done, partial text)
        self._closed = False

    # -- internals -----------------------------------------------------

    def _decode_chunk(self, start: int, seg: np.ndarray, last: bool) -> None:
        seg_len = seg.shape[0]
        padded = np.zeros((1, self.chunk), np.float32)
        padded[0, :seg_len] = seg
        logits, preds, out_lengths = self._infer(padded, np.asarray([seg_len], np.int32))
        # greedy reads only the ids; the host beam reads the logits row; the device beam searches it where it lies
        if self.beam_width:
            logits_row = logits[0] if self.beam_backend == "device" else logits[0].float().cpu().numpy()
        else:
            logits_row = None
        self._apply_chunk(start, seg_len, last, logits_row, preds[0].cpu().numpy(), int(out_lengths[0]))

    def _apply_chunk(self, start: int, seg_len: int, last: bool, logits_row, preds_row, n: int) -> None:
        """Advance the decode state with one chunk's model outputs.

        Split from the inference call so that a pool can run chunks of many
        streams in one forward and feed each stream its row."""
        if self.beam_width and self.beam_backend == "device":
            from thunder_tpu_torch.ops.ctc_beam_device import beam_search_device_stream

            win = trim_chunk_ids(logits_row[:n], seg_len, self.overlap, is_first=start == 0, is_last=last)
            self._beam_state = beam_search_device_stream(win[None], blank=self._module.blank_idx,
                                                         beam_width=self.beam_width, state=self._beam_state,
                                                         **self._beam_kwargs)
        elif self.beam_width:
            from thunder_tpu_torch.ops.ctc_beam import beam_search_stream, log_softmax

            win = trim_chunk_ids(np.asarray(logits_row, np.float32)[:n], seg_len, self.overlap, is_first=start == 0,
                                 is_last=last)
            self._beam_state = beam_search_stream(log_softmax(win), self._module.blank_idx, beam_width=self.beam_width,
                                                  state=self._beam_state, **self._beam_kwargs)
        else:
            ids = np.asarray(preds_row)[:n]
            self._pieces.append(trim_chunk_ids(ids, seg_len, self.overlap, is_first=start == 0, is_last=last))
        self._chunks_done += 1

    def _take_ready(self, flush: bool = False):
        """Pop every chunk whose window is complete: ``[(start, seg, last)]``.

        Advances the grid position and trims the buffer; the caller then
        decodes each chunk in order (``_decode_chunk`` inline, or batched
        across streams through ``_apply_chunk``)."""
        total = self._buffer_start + self._buffer.shape[0]
        ready = []
        while True:
            start = self._next_start
            # strict: a stream that ends exactly at start + chunk makes this the final chunk, whose tail must not
            # be trimmed; defer it to flush
            if not flush and start + self.chunk >= total:
                break
            if flush and start >= max(total - self.overlap, 1):
                break
            rel = start - self._buffer_start
            seg = self._buffer[rel: rel + self.chunk]
            if flush and seg.shape[0] == 0:
                break
            last = flush and (start + self.step >= max(total - self.overlap, 1))
            ready.append((start, seg, last))
            self._next_start += self.step
            if flush and last:
                break
        # drop samples no future chunk needs (the segments taken keep referencing the old buffer)
        keep_from = self._next_start - self._buffer_start
        if keep_from > 0:
            self._buffer = self._buffer[keep_from:]
            self._buffer_start += keep_from
        return ready

    def _drain(self, flush: bool = False) -> None:
        for start, seg, last in self._take_ready(flush):
            self._decode_chunk(start, seg, last=last)

    # -- public API ----------------------------------------------------

    def push(self, samples) -> str:
        """Append samples; decode any chunk whose window is complete.

        Returns the stable transcript so far (the trailing token is held
        back: it may still merge with the next chunk's first token, and in
        beam mode the beam may still revise it).
        """
        if self._closed:
            raise RuntimeError("push() after flush()")
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._buffer = np.concatenate([self._buffer, samples])
        self._drain(flush=False)
        return self.partial_text

    def flush(self) -> str:
        """Decode the remaining tail and return the final transcript (equal to
        ``predict_long`` over the concatenated audio, greedy and beam alike)."""
        if not self._closed:
            self._drain(flush=True)
            self._closed = True
        return self.text

    @property
    def partial_text(self) -> str:
        # cached by completed-chunk count: pushes that complete no chunk return without decoding the history again
        key = self._chunks_done
        if self._partial_cache is not None and self._partial_cache[0] == key:
            return self._partial_cache[1]
        ids = self._joined()
        text = "" if ids.shape[0] <= 1 else self._decode(ids[:-1])
        self._partial_cache = (key, text)
        return text

    @property
    def text(self) -> str:
        return self._decode(self._joined())

    def _decode(self, ids: np.ndarray) -> str:
        if self.beam_width:
            # beam prefixes are already collapsed label sequences
            return self._module.text_transform.decode_prediction(ids[None].astype(np.int64), remove_repeated=False)[0]
        return self._module.text_transform.decode_prediction(ids[None])[0]

    def _joined(self) -> np.ndarray:
        if self.beam_width:
            if self._beam_state is None:
                return np.zeros((0,), np.int32)
            if self.beam_backend == "device":
                # LM-aware ranking of the carried device beam: partial_score lookahead while live, final_score at
                # flush (the host stream's finalization)
                bests = self._beam_state.best_ranked(self._device_lm, self._device_lm_weight, final=self._closed)
                return bests[0] if bests else np.zeros((0,), np.int32)
            if self._closed:
                # flush is the finalization point: word fusion's pending-word bonus joins the ranking
                return self._beam_state.best_final(self._beam_kwargs.get("lm"), self._beam_kwargs.get("lm_weight", 0.0))
            # live: word fusion's completion lookahead ranks the in-flight word (display only)
            return self._beam_state.best_partial(self._beam_kwargs.get("lm"), self._beam_kwargs.get("lm_weight", 0.0))
        if not self._pieces:
            return np.zeros((0,), np.int32)
        return np.concatenate(self._pieces).astype(np.int32)


class StreamingPool:
    """Concurrent streaming transcription: many live feeds, batched chunks.

    Each stream keeps its own chunk grid and decode state (an internal
    :class:`StreamingTranscriber`), but whenever pushes complete chunk
    windows, across any streams, the pool runs them through the model as ONE
    padded ``(batch_size, chunk)`` call instead of one call per chunk. Greedy
    pools move only the argmax ids to the host; with the device beam each
    stream searches its row of the logits on the device. For streams equal to
    lone ones on the card, serve a QuartzNet, Citrinet or wav2vec2 engine built
    with ``batch_invariant=True`` (see the module docstring).

    Args:
        predictor: shared ``CTCModule`` or ``InferenceEngine``.
        batch_size: chunks per forward; ready chunks run in groups padded to
            exactly this size, in FIFO order across streams.
        chunk_seconds / overlap_seconds / sample_rate / beam_width /
            beam kwargs: per-stream decode settings, as in
            :class:`StreamingTranscriber`.
    """

    def __init__(
        self,
        predictor,
        batch_size: int = 8,
        chunk_seconds: float = 20.0,
        overlap_seconds: float = 2.0,
        sample_rate: int = 16000,
        beam_width: Optional[int] = None,
        **beam_kwargs,
    ):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        # fail at the faulty call site, not at the first open()
        check_beam_args(beam_width, dict(beam_kwargs))
        self._module, self._infer = _make_infer(predictor)
        self._predictor = predictor
        self._batch = batch_size
        self._beam_width = beam_width
        self._stream_kwargs = dict(chunk_seconds=chunk_seconds, overlap_seconds=overlap_seconds,
                                   sample_rate=sample_rate, beam_width=beam_width, **beam_kwargs)
        self._streams: dict = {}
        self._pending: List[tuple] = []  # (stream, start, seg, last), FIFO
        self._next_id = 0
        # server handlers push from separate threads; the pending queue and every stream's state advance under
        # one lock, and the forwards run on the pushing thread's current CUDA stream
        self._lock = threading.RLock()

    def open(self, stream_id=None):
        """Register a new stream; returns its id (auto-assigned if None)."""
        with self._lock:
            if stream_id is None:
                # skip over any user-chosen ids so that mixing styles never collides
                while self._next_id in self._streams:
                    self._next_id += 1
                stream_id = self._next_id
                self._next_id += 1
            if stream_id in self._streams:
                raise ValueError(f"stream {stream_id!r} already open")
            self._streams[stream_id] = StreamingTranscriber(self._predictor, **self._stream_kwargs)
            return stream_id

    def _stream(self, stream_id) -> StreamingTranscriber:
        st = self._streams.get(stream_id)
        if st is None:
            raise KeyError(f"unknown stream {stream_id!r} (open() it first)")
        return st

    def _process(self, work) -> None:
        """Run ``[(stream, start, seg, last)]`` in forwards of exactly ``batch_size`` rows, in the listed order (a
        stream's beam state is sequential)."""
        for i in range(0, len(work), self._batch):
            group = work[i: i + self._batch]
            chunk = group[0][0].chunk
            padded = np.zeros((self._batch, chunk), np.float32)
            lengths = np.zeros((self._batch,), np.int32)
            for row, (_, _, seg, _) in enumerate(group):
                padded[row, : seg.shape[0]] = seg
                lengths[row] = seg.shape[0]
            logits, preds, out_lengths = self._infer(padded, lengths)
            # greedy pools never read the logits; the host beam reads them; the device beam keeps its rows there
            if not self._beam_width:
                logits = None
            elif self._stream_kwargs.get("beam_backend") != "device":
                logits = logits.float().cpu().numpy()
            preds = preds.cpu().numpy()
            out_lengths = out_lengths.cpu().numpy()
            for row, (st, start, seg, last) in enumerate(group):
                st._apply_chunk(start, seg.shape[0], last, logits[row] if logits is not None else None, preds[row],
                                int(out_lengths[row]))

    def push(self, stream_id, samples) -> str:
        """Append samples to one stream; completed chunk windows join the pool's pending queue, which drains in
        full ``batch_size`` forwards. Returns the stream's stable transcript as of the last drain (call
        :meth:`drain` to force pending chunks through)."""
        with self._lock:
            st = self._stream(stream_id)
            samples = np.asarray(samples, np.float32).reshape(-1)
            st._buffer = np.concatenate([st._buffer, samples])
            self._pending.extend((st, start, seg, last) for start, seg, last in st._take_ready(False))
            while len(self._pending) >= self._batch:
                group = self._pending[: self._batch]
                del self._pending[: self._batch]
                self._process(group)
            return st.partial_text

    def drain(self) -> None:
        """Run every pending chunk now (a final, possibly partial batch)."""
        with self._lock:
            if self._pending:
                pending, self._pending = self._pending, []
                self._process(pending)

    def flush(self, stream_id) -> str:
        """Finalize one stream and return its transcript (the stream closes).

        Drains ALL pending chunks first (FIFO across streams), then decodes
        this stream's tail."""
        with self._lock:
            st = self._stream(stream_id)
            self.drain()
            self._process([(st, start, seg, last) for start, seg, last in st._take_ready(True)])
            st._closed = True
            del self._streams[stream_id]
            return st.text

    def partial_text(self, stream_id) -> str:
        with self._lock:
            return self._stream(stream_id).partial_text
