"""CTCModule: the user-facing model container.

Port of ``CTCModel``, ``CTCModule.create``/``forward``/``predict``/
``predict_long``/``align``/``loss``/``with_variables``, ``pad_to_bucket``, the beam
decoding tail (``check_beam_args``, ``check_device_beam_kwargs``,
``run_beam_decode``) and the long-audio chunking (``trim_chunk_ids``,
``chunked_transcribe``) from ``thunder_tpu/module.py``. The
compute graph is one ``nn.Module`` (``CTCModel`` = audio_transform -> encoder
-> decoder) on an explicit device, the card unless the caller asks for the
CPU; audio is padded to a bucket multiple on the host, and variable lengths
travel as ``(tensor, lengths)`` pairs. The module's weights (parameters and
batch-norm running statistics) are its model's ``state_dict``, the
counterpart of the flax ``variables``.

A ``cuda`` device that is not available raises: nothing here moves work to
the CPU on its own.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from thunder_tpu_torch.data.collate import bucket_length
from thunder_tpu_torch.models.layers import init_parameters
from thunder_tpu_torch.ops.ctc import alignment_segments, calculate_ctc, collapse_ctc, ctc_forced_align, greedy_decode
from thunder_tpu_torch.text.transform import BatchTextTransformer

__all__ = ["CTCModel", "CTCModule", "pad_to_bucket", "require_device", "chunked_transcribe", "run_beam_decode"]

#: sentinel distinguishing "caller passed a value" from the documented default,
#: so beam-only kwargs raise without beam_width instead of silently running greedy
_BEAM_UNSET = object()


def require_device(device) -> torch.device:
    """``torch.device(device)``, raising if it is a CUDA device and no GPU is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is available")
    return device


def pad_to_bucket(n: int, multiple: int = 16000) -> int:
    """Round up to the padding bucket (the data pipeline's ``bucket_length``)."""
    return bucket_length(n, multiple)


def to_device(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a ``dtype`` tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def host_batch(audio, lengths, pad_multiple: int) -> Tuple[np.ndarray, np.ndarray]:
    """Audio (one clip or a batch) -> bucket-padded float32 ``(B, T)`` and int32 lengths."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None, :]
    if lengths is None:
        lengths = np.full((audio.shape[0],), audio.shape[-1], dtype=np.int32)
    lengths = np.asarray(lengths, dtype=np.int32)
    bucket = pad_to_bucket(audio.shape[-1], pad_multiple)
    if bucket != audio.shape[-1]:
        audio = np.pad(audio, ((0, 0), (0, bucket - audio.shape[-1])))
    return audio, lengths


def decode_greedy(text_transform: BatchTextTransformer, preds: torch.Tensor, out_lengths: torch.Tensor) -> List[str]:
    """Device argmax ids -> host CTC collapse -> strings."""
    collapsed = collapse_ctc(preds.cpu().numpy(), out_lengths.cpu().numpy())
    # repeats already collapsed on ids; decode must not re-collapse
    return [text_transform.decode_prediction(c[None], remove_repeated=False)[0] for c in collapsed]


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def check_beam_args(beam_width, beam_kwargs, prune_logp=_BEAM_UNSET, lm=None, lm_weight=_BEAM_UNSET):
    """Raise TypeError when beam-search-only arguments arrive without beam_width.

    Shared by ``CTCModule.predict``/``predict_long`` and the engine's
    equivalents so short and long audio behave identically.
    """
    if beam_width:
        return
    stray = sorted(beam_kwargs or ())
    if prune_logp is not _BEAM_UNSET:
        stray.append("prune_logp")
    if lm is not None:
        stray.append("lm")
    if lm_weight is not _BEAM_UNSET:
        stray.append("lm_weight")
    if stray:
        raise TypeError(f"beam-search arguments without beam_width: {sorted(stray)}")


def check_device_beam_kwargs(backend, lm, beam_kwargs, allowed=("max_tokens_per_step",)):
    """Validate a device-backend beam configuration: the stray-kwarg whitelist
    and the unknown-backend check, shared by ``predict``/``run_beam_decode``
    and ``chunked_transcribe``/``predict_long``.

    ``lm`` with the device backend ranks every surviving beam on the host
    (:func:`thunder_tpu_torch.ops.ctc_beam_device.lm_prefix_score`); unlike
    the host backend's in-search shallow fusion, it does not influence which
    beams survive pruning.
    """
    if backend == "device":
        stray = sorted(set(beam_kwargs or ()) - set(allowed))
        if stray:
            raise ValueError(f"beam_backend='device' does not support: {stray}")
    elif backend not in (None, "host"):
        raise ValueError(f"unknown beam_backend: {backend!r} (use 'host' or 'device')")


def run_beam_decode(logits, out_lengths, *, blank: int, text_transform, beam_width: int, nbest: Optional[int],
                    prune_logp: float, lm, lm_weight: float, backend: Optional[str] = None,
                    beam_kwargs: Optional[dict] = None, mesh=None, data_axis: str = "data"):
    """Shared beam-decode tail for :meth:`CTCModule.predict` and the serving
    engine's ``predict``: logits -> transcriptions (or, with ``nbest``,
    ranked ``(text, log_prob)`` pairs per sample).

    ``backend`` selects where the search runs:

    - ``"host"`` (default): the search of :mod:`thunder_tpu_torch.ops.ctc_beam`
      (the C++ runtime, or numpy with ``use_native=False``), with in-search LM
      shallow fusion;
    - ``"device"``: :func:`thunder_tpu_torch.ops.ctc_beam_device.beam_search_device`
      on the logits where they lie (the beam kernels on the card); with
      ``lm``, the full surviving beam is LM-ranked on the host. With ``mesh``
      each rank searches its rows along ``data_axis`` and gets every row's result.
    """
    kw = dict(beam_kwargs or {})
    check_device_beam_kwargs(backend, lm, kw)
    if backend == "device":
        from thunder_tpu_torch.ops.ctc_beam_device import beam_search_device

        hyps = beam_search_device(logits, out_lengths, blank=blank, beam_width=beam_width, prune_logp=prune_logp,
                                  nbest=nbest, lm=lm, lm_weight=lm_weight, mesh=mesh, data_axis=data_axis, **kw)
    else:
        from thunder_tpu_torch.ops.ctc_beam import beam_search_decode, beam_search_nbest

        host_logits, host_lengths = _numpy(logits).astype(np.float32), _numpy(out_lengths)
        common = dict(blank=blank, beam_width=beam_width, prune_logp=prune_logp, lm=lm, lm_weight=lm_weight, **kw)
        if nbest is not None:
            hyps = beam_search_nbest(host_logits, host_lengths, nbest=nbest, **common)
        else:
            hyps = beam_search_decode(host_logits, host_lengths, **common)
    tt = text_transform
    if nbest is not None:
        return [
            [(tt.decode_prediction(ids[None], remove_repeated=False)[0] if len(ids) else "", score)
             for ids, score in sample]
            for sample in hyps
        ]
    return [tt.decode_prediction(h[None], remove_repeated=False)[0] if len(h) else "" for h in hyps]


def trim_chunk_ids(ids, seg_len: int, overlap: int, is_first: bool, is_last: bool):
    """Drop half the overlap's frames from interior chunk boundaries (ids or a logits window)."""
    fps = ids.shape[0] / max(seg_len, 1)
    trim = int(overlap / 2 * fps)
    lo = 0 if is_first else trim
    hi = ids.shape[0] - trim if (not is_last and trim > 0) else ids.shape[0]
    return ids[lo:hi]


def chunked_transcribe(infer_fn, text_transform, audio, chunk_seconds: float = 20.0, overlap_seconds: float = 2.0,
                       sample_rate: int = 16000, short_path=None, logits_fn=None, blank_idx: Optional[int] = None,
                       beam_width: Optional[int] = None, beam_kwargs: Optional[dict] = None):
    """Overlapped-chunk decoding of long audio.

    ``infer_fn(padded_audio, lengths) -> (pred_ids, out_lengths)``; interior
    chunk boundaries drop half the overlap's frames on each side, the id
    streams are stitched and collapsed once (greedy).

    With ``beam_width`` (requires ``logits_fn(padded, lengths) -> (logits,
    out_lengths)`` and ``blank_idx``), the trimmed frame windows are decoded
    as ONE continuous prefix beam search, each window seeded with the
    previous window's surviving beams (:func:`thunder_tpu_torch.ops.ctc_beam.beam_search_stream`),
    equal to the unchunked decode whenever the windows' log-probs tile the
    full utterance's. ``beam_kwargs["beam_backend"]="device"`` runs the same
    continuous search where the logits lie
    (:func:`thunder_tpu_torch.ops.ctc_beam_device.beam_search_device_stream`):
    each window is sliced, trimmed and padded to a 64-frame bucket on the
    device, the carried state stays there, and an ``lm`` ranks the carried
    beam on the host at the end.
    """
    audio = np.asarray(audio, dtype=np.float32).reshape(-1)
    chunk = int(chunk_seconds * sample_rate)
    overlap = int(overlap_seconds * sample_rate)
    if overlap >= chunk:
        raise ValueError(
            f"overlap_seconds ({overlap_seconds}) must be smaller than "
            f"chunk_seconds ({chunk_seconds}) — the chunk grid would drop audio"
        )
    if audio.shape[0] <= chunk and short_path is not None:
        return short_path(audio)
    step = chunk - overlap
    starts = list(range(0, max(audio.shape[0] - overlap, 1), step))
    use_beam = bool(beam_width)
    if use_beam and (logits_fn is None or blank_idx is None):
        raise ValueError("beam_width requires logits_fn and blank_idx")
    kw = dict(beam_kwargs or {})
    backend = kw.pop("beam_backend", None)
    check_device_beam_kwargs(backend, kw.get("lm"), kw, allowed=("prune_logp", "max_tokens_per_step", "lm", "lm_weight"))
    # device stream: the LM never enters the device search; it ranks the carried beam at the end
    device_lm = kw.pop("lm", None) if backend == "device" else None
    device_lm_weight = kw.pop("lm_weight", 0.5) if backend == "device" else 0.0
    pieces = []
    beam_state = None
    for idx, start in enumerate(starts):
        seg = audio[start: start + chunk]
        seg_len = seg.shape[0]
        padded = np.zeros((1, chunk), dtype=np.float32)
        padded[0, :seg_len] = seg
        first, last = idx == 0, idx == len(starts) - 1
        seg_lengths = np.asarray([seg_len], dtype=np.int32)
        if use_beam and backend == "device":
            from thunder_tpu_torch.ops.ctc_beam_device import beam_search_device_stream

            logits, out_lengths = logits_fn(padded, seg_lengths)
            # slice, trim and pad on the device: the logits never cross to the host
            win = logits[0, : int(out_lengths[0])]
            win = trim_chunk_ids(win, seg_len, overlap, is_first=first, is_last=last)
            n_win = win.shape[0]
            bucket = max(64, -(-n_win // 64) * 64)
            if bucket != n_win:
                win = torch.nn.functional.pad(win, (0, 0, 0, bucket - n_win))
            beam_state = beam_search_device_stream(win[None], lengths=[n_win], blank=blank_idx, beam_width=beam_width,
                                                   state=beam_state, **kw)
        elif use_beam:
            from thunder_tpu_torch.ops.ctc_beam import beam_search_stream, log_softmax

            logits, out_lengths = logits_fn(padded, seg_lengths)
            win = _numpy(logits).astype(np.float32)[0, : int(out_lengths[0])]
            win = trim_chunk_ids(win, seg_len, overlap, is_first=first, is_last=last)
            beam_state = beam_search_stream(log_softmax(win), blank_idx, beam_width=beam_width, state=beam_state, **kw)
        else:
            preds, out_lengths = infer_fn(padded, seg_lengths)
            ids = _numpy(preds)[0, : int(out_lengths[0])]
            pieces.append(trim_chunk_ids(ids, seg_len, overlap, is_first=first, is_last=last))
    if use_beam and backend == "device":
        bests = beam_state.best_ranked(device_lm, device_lm_weight, final=True) if beam_state is not None else []
        best = bests[0] if bests else np.zeros((0,), np.int32)
        return text_transform.decode_prediction(best[None].astype(np.int64), remove_repeated=False)[0]
    if use_beam:
        # the carried search's best prefix is already collapsed; 0.5 is beam_search_stream's
        # lm_weight default, the weight the windows were searched with
        best = beam_state.best_final(kw.get("lm"), kw.get("lm_weight", 0.5))
        return text_transform.decode_prediction(best[None].astype(np.int64), remove_repeated=False)[0]
    joined = np.concatenate(pieces)
    return text_transform.decode_prediction(joined[None])[0]


class CTCModel(nn.Module):
    """audio ``(B, T)`` -> logits ``(B, frames, vocab)``; with ``decoder=None`` (an encoder-only checkpoint)
    the encoder's output ``(B, frames, C)``.

    ``train=True`` runs the frontend's dither and augmentation, batch
    statistics and dropout, drawing every random number from ``generator``.
    """

    def __init__(self, audio_transform: nn.Module, encoder: nn.Module, decoder: Optional[nn.Module]):
        super().__init__()
        self.audio_transform = audio_transform
        self.encoder = encoder
        self.decoder = decoder
        if decoder is not None and decoder.in_features is None:
            decoder.build(encoder.final_dimension)

    def forward(self, audio: torch.Tensor, lengths: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None):
        feats, feat_lengths = self.audio_transform(audio, lengths, train=train, generator=generator)
        encoded, out_lengths = self.encoder(feats, feat_lengths, train=train, generator=generator)
        if self.decoder is None:
            return encoded, out_lengths
        return self.decoder(encoded, train=train, generator=generator), out_lengths


@dataclass
class CTCModule:
    """Model + text transform on one device, with inference conveniences."""

    model: CTCModel
    text_transform: Optional[BatchTextTransformer]
    device: torch.device
    pad_multiple: int = 16000
    #: parameter-name prefixes, as flax path tuples (``("encoder", "feature_extractor")`` for
    #: ``encoder.feature_extractor.*``), that training leaves untouched: the ``Trainer`` keeps them out of the
    #: optimizer and the gradient clip (the HF loader freezes the wav2vec2 conv feature extractor)
    frozen_paths: Optional[List[Tuple[str, ...]]] = None

    @classmethod
    def create(
        cls,
        generator: torch.Generator,
        audio_transform: nn.Module,
        encoder: nn.Module,
        decoder: Optional[nn.Module],
        text_transform: Optional[BatchTextTransformer] = None,
        device="cuda",
    ) -> "CTCModule":
        """Assemble the model, draw its parameters from ``generator`` (a CPU
        generator, so the draw does not depend on the device) and move it to
        ``device``."""
        device = require_device(device)
        model = CTCModel(audio_transform, encoder, decoder)
        init_parameters(model, generator)
        return cls(model=model.eval().to(device), text_transform=text_transform, device=device)

    def to(self, device) -> "CTCModule":
        """A copy of this module on another device."""
        device = require_device(device)
        return replace(self, model=copy.deepcopy(self.model).to(device), device=device)

    def with_state(self, state: Dict[str, torch.Tensor]) -> "CTCModule":
        """A copy of this module whose model holds ``state`` (a ``state_dict``)."""
        model = copy.deepcopy(self.model)
        model.load_state_dict(state)
        return replace(self, model=model)

    @property
    def encoder_final_dimension(self) -> int:
        """Channels out of the encoder (the decoder's input)."""
        return self.model.encoder.final_dimension

    @property
    def blank_idx(self) -> int:
        return self.text_transform.vocab.blank_idx if self.text_transform else 0

    @torch.inference_mode()
    def forward(self, audio, lengths) -> Tuple[torch.Tensor, torch.Tensor]:
        """Padded audio batch -> ``(logits, logit_lengths)`` on the module's device."""
        return self.model(to_device(audio, torch.float32, self.device), to_device(lengths, torch.int32, self.device))

    __call__ = forward

    @torch.inference_mode()
    def infer(self, audio, lengths) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Padded audio batch -> ``(logits, argmax ids, logit_lengths)`` on the module's device."""
        logits, out_lengths = self.forward(audio, lengths)
        return logits, greedy_decode(logits), out_lengths

    def loss(self, audio, audio_lengths, targets, target_lengths, *, train: bool = False,
             generator: Optional[torch.Generator] = None):
        """``calculate_ctc`` of the model's logits: ``(loss, (logits, logit_lengths))``.

        ``train=True`` moves the batch-norm running statistics in place.
        Gradients are recorded as the caller's autograd mode says.
        """
        logits, out_lengths = self.model(
            to_device(audio, torch.float32, self.device), to_device(audio_lengths, torch.int32, self.device),
            train=train, generator=generator,
        )
        loss = calculate_ctc(logits, to_device(targets, torch.int32, self.device), out_lengths,
                             to_device(target_lengths, torch.int32, self.device), self.blank_idx)
        return loss, (logits, out_lengths)

    def predict(self, audio, lengths=None, beam_width: Optional[int] = None, prune_logp: float = _BEAM_UNSET, lm=None,
                lm_weight: float = _BEAM_UNSET, nbest: Optional[int] = None, beam_backend: Optional[str] = None,
                **beam_kwargs) -> List[str]:
        """Audio batch (or one clip) -> transcriptions.

        Greedy CTC decode by default; ``beam_width`` switches to prefix beam
        search over the logits, on ``beam_backend="host"`` (default, the C++
        search of :mod:`thunder_tpu_torch.native` with in-search LM fusion; the
        numpy search with ``use_native=False``) or ``"device"`` (the beam kernels on
        the logits where they lie; an ``lm`` ranks the surviving beam on the
        host). With ``nbest=k``, returns per sample the top-k ``(text,
        log_prob)`` pairs instead of one string.
        """
        return transcribe(self, self.infer, self.pad_multiple, audio, lengths, beam_width, prune_logp, lm, lm_weight,
                          nbest, beam_backend, beam_kwargs)

    def predict_long(self, audio, chunk_seconds: float = 20.0, overlap_seconds: float = 2.0, sample_rate: int = 16000,
                     beam_width: Optional[int] = None, **beam_kwargs) -> str:
        """Transcribe arbitrarily long audio by overlapped chunking (:func:`chunked_transcribe`)."""
        if self.text_transform is None:
            raise ValueError("predict_long requires a text_transform")
        return long_transcribe(self, self.infer, self.predict, audio, chunk_seconds, overlap_seconds, sample_rate,
                               beam_width, beam_kwargs)

    @torch.inference_mode()
    def align(self, audio, texts, lengths=None, sample_rate: int = 16000):
        """Forced alignment: time spans for known transcripts.

        The model's forward on the module's device, ``log_softmax`` in float32
        there, then :func:`~thunder_tpu_torch.ops.ctc.ctc_forced_align` of each
        transcript against its CTC lattice, batched; the spans and the
        frame-to-seconds conversion on the host.

        Args:
            audio: ``(batch, time)`` padded waveforms (or a single 1-D clip).
            texts: the known transcripts, one per sample.
            lengths: valid samples per clip (defaults to full length).
            sample_rate: for the frame -> seconds conversion.

        Returns:
            ``(spans, scores)``: per sample a list of ``(token, start_seconds,
            end_seconds)`` covering its transcript tokens in order, and the
            best-path log-prob per sample as a numpy array (``-inf`` = the
            transcript cannot align, e.g. audio too short).
        """
        if self.text_transform is None:
            raise ValueError("align requires a text_transform (checkpoint had no tokenizer)")
        audio, lengths = host_batch(audio, lengths, self.pad_multiple)
        targets, target_lengths = self.text_transform.encode(list(texts))
        logits, _, out_lengths = self.infer(audio, lengths)
        logp = torch.log_softmax(logits.float(), dim=-1)
        states, _, scores = ctc_forced_align(logp, out_lengths, to_device(targets, torch.int32, self.device),
                                             to_device(target_lengths, torch.int32, self.device), self.blank_idx)
        out_lengths = out_lengths.cpu().numpy()
        segments = alignment_segments(states, out_lengths, target_lengths)
        itos = self.text_transform.vocab.itos
        spans = []
        for b, segs in enumerate(segments):
            sec_per_frame = (lengths[b] / sample_rate) / max(int(out_lengths[b]), 1)
            spans.append([(itos[int(targets[b, i])], start * sec_per_frame, end * sec_per_frame)
                          for i, (start, end) in enumerate(segs)])
        return spans, scores.cpu().numpy()


def transcribe(module: CTCModule, infer, pad_multiple: int, audio, lengths, beam_width, prune_logp, lm, lm_weight,
               nbest, beam_backend, beam_kwargs, mesh=None) -> List[str]:
    """``predict`` of a module or an engine: the audio padded to a multiple of ``pad_multiple`` samples,
    ``infer(padded, lengths) -> (logits, argmax ids, out_lengths)`` on the device, then the greedy decode of
    those ids or :func:`run_beam_decode` of the logits. With ``mesh`` (an engine's device beam on a mesh)
    ``infer`` gives the batch padded to divide the data axis, the search runs sharded over it, and the padding
    rows are dropped from the result."""
    if module.text_transform is None:
        raise ValueError("predict requires a text_transform")
    if nbest is not None and not beam_width:
        raise TypeError("beam-search arguments without beam_width: ['nbest']")
    if beam_backend is not None and not beam_width:
        raise TypeError("beam-search arguments without beam_width: ['beam_backend']")
    check_beam_args(beam_width, beam_kwargs, prune_logp=prune_logp, lm=lm, lm_weight=lm_weight)
    audio, lengths = host_batch(audio, lengths, pad_multiple)
    logits, preds, out_lengths = infer(audio, lengths)
    if beam_width:
        return run_beam_decode(
            logits, out_lengths, blank=module.blank_idx, text_transform=module.text_transform, beam_width=beam_width,
            nbest=nbest, prune_logp=-12.0 if prune_logp is _BEAM_UNSET else prune_logp, lm=lm,
            lm_weight=0.5 if lm_weight is _BEAM_UNSET else lm_weight, backend=beam_backend, beam_kwargs=beam_kwargs,
            mesh=mesh,
        )[: audio.shape[0]]
    return decode_greedy(module.text_transform, preds, out_lengths)


def long_transcribe(module: CTCModule, infer, predict, audio, chunk_seconds, overlap_seconds, sample_rate,
                    beam_width, beam_kwargs) -> str:
    """``predict_long`` of a module or an engine: ``infer(padded, lengths) -> (logits, argmax ids,
    out_lengths)`` on the device, ``predict`` for audio of one chunk or less."""
    check_beam_args(beam_width, beam_kwargs)
    if "nbest" in beam_kwargs:
        raise TypeError(
            "nbest is not supported by predict_long (the chunked beam "
            "yields one continuous search; use predict for n-best)"
        )

    def ids(padded, lengths):
        _, preds, out_lengths = infer(padded, lengths)
        return preds, out_lengths

    def logits(padded, lengths):
        out, _, out_lengths = infer(padded, lengths)
        return out, out_lengths

    return chunked_transcribe(
        ids, module.text_transform, audio, chunk_seconds=chunk_seconds, overlap_seconds=overlap_seconds,
        sample_rate=sample_rate, short_path=lambda a: predict(a, beam_width=beam_width, **beam_kwargs)[0],
        logits_fn=logits, blank_idx=module.blank_idx, beam_width=beam_width, beam_kwargs=beam_kwargs or None,
    )
