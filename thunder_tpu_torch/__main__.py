"""Command-line interface: transcribe / eval / train / export.

Port of ``thunder_tpu/__main__.py``, a thin layer over the Python API that
runs on the card unless ``--device cpu`` asks for the CPU:

    python -m thunder_tpu_torch transcribe clip.wav --checkpoint model.nemo
    python -m thunder_tpu_torch eval --checkpoint model.nemo --manifest test.json
    python -m thunder_tpu_torch train --checkpoint ... --train-manifest ... --val-manifest ...
    python -m thunder_tpu_torch export --checkpoint ... --output bundle/ [--aot]

Without a card, and without ``--device cpu``, every command exits with the
error of :func:`thunder_tpu_torch.module.require_device`. ``export --aot``
also writes ``predict.pt2`` beside the bundle: the predict graph at
``--batch-size`` x ``--seconds`` of 16 kHz audio
(:func:`thunder_tpu_torch.export.aot_export`), which
:func:`thunder_tpu_torch.export.aot_load` serves. On the card, float32
matmuls and cuDNN convolutions run in full float32 (no TF32), as on the CPU.
"""

from __future__ import annotations

import argparse
import json


def _load(args):
    from thunder_tpu_torch.registry import load_pretrained

    return load_pretrained(args.checkpoint, device=args.device)


def _predictor(args, module):
    if args.engine:
        from thunder_tpu_torch.engine import InferenceEngine

        return InferenceEngine(module)
    return module


def _parse_hotwords(specs):
    hotwords = {}
    for spec in specs:
        word, sep, boost = spec.rpartition(":")
        if not sep or not word:
            raise SystemExit(f"--hotword expects WORD:BOOST, got {spec!r}")
        try:
            hotwords[word] = float(boost)
        except ValueError:
            raise SystemExit(f"--hotword boost must be a number, got {spec!r}")
    return hotwords


def _build_lm(args, module):
    """Word-fusion LM from the CLI flags (None when no LM flag given)."""
    hotwords = _parse_hotwords(args.hotword)
    if not (args.arpa or args.lm_transcripts or hotwords or args.word_score):
        return None
    from thunder_tpu_torch.text.word_fusion import WordFusionLM, WordNGramLM

    word_lm = None
    if args.arpa:
        from thunder_tpu_torch.text.lm import ArpaLM

        word_lm = ArpaLM.load(args.arpa)
    elif args.lm_transcripts:
        with open(args.lm_transcripts, encoding="utf-8") as f:
            word_lm = WordNGramLM(order=args.lm_order).fit(line.strip() for line in f)
    return WordFusionLM(word_lm, module.text_transform, word_score=args.word_score, hotwords=hotwords)


def _beam_kwargs(args, module) -> dict:
    """The LM and beam-backend keywords of ``predict``; an LM flag implies the beam decode (width 16)."""
    lm = _build_lm(args, module)
    kwargs = {}
    if lm is not None:
        if not args.beam_width:
            args.beam_width = 16
        kwargs = {"lm": lm, "lm_weight": args.lm_weight}
    if args.beam_backend:
        if not args.beam_width:
            raise SystemExit("--beam-backend requires --beam-width")
        kwargs["beam_backend"] = args.beam_backend
    return kwargs


def cmd_transcribe(args):
    import numpy as np

    from thunder_tpu_torch.data import load_audio, resample

    module = _load(args)
    predictor = _predictor(args, module)
    beam_kwargs = _beam_kwargs(args, module)
    for path in args.audio:
        audio, sr = load_audio(path)
        audio = audio.mean(axis=0) if audio.shape[0] > 1 else audio[0]
        if sr != args.sample_rate:
            audio = resample(audio, sr, args.sample_rate)
        long_clip = audio.shape[-1] > args.sample_rate * args.chunk_seconds
        if long_clip:
            overlap = args.overlap_seconds if args.overlap_seconds is not None else min(2.0, args.chunk_seconds / 4)
            text = predictor.predict_long(audio, chunk_seconds=args.chunk_seconds, overlap_seconds=overlap,
                                          sample_rate=args.sample_rate, beam_width=args.beam_width, **beam_kwargs)
        else:
            text = predictor.predict(np.asarray(audio, dtype=np.float32), beam_width=args.beam_width,
                                     **beam_kwargs)[0]
        record = {"audio": path, "text": text.strip()}
        if args.timestamps and text.strip():
            # alignment runs ONE unchunked forward: only for clips that took the short path (a clip past the chunk
            # length would run the whole waveform at once, which the chunk grid exists to avoid)
            if long_clip:
                import warnings

                warnings.warn(
                    f"--timestamps skipped for {path}: clip exceeds "
                    f"--chunk-seconds ({args.chunk_seconds}); align shorter "
                    "clips or raise --chunk-seconds"
                )
            else:
                spans, _ = module.align(np.asarray(audio, dtype=np.float32), [text], sample_rate=args.sample_rate)
                record["tokens"] = [{"token": tok, "start": round(s, 3), "end": round(e, 3)} for tok, s, e in spans[0]]
        print(json.dumps(record))


def cmd_eval(args):
    import time

    import numpy as np

    from thunder_tpu_torch.data import ManifestDatamodule
    from thunder_tpu_torch.training.metrics import CharErrorRate, WordErrorRate

    module = _load(args)
    predictor = _predictor(args, module)
    beam_kwargs = _beam_kwargs(args, module)
    dm = ManifestDatamodule(args.manifest, args.manifest, args.manifest, batch_size=args.batch_size,
                            num_workers=args.num_workers, sample_rate=args.sample_rate)
    dm.setup("test")
    wer, cer = WordErrorRate(), CharErrorRate()
    utterances, audio_seconds, decode_seconds = 0, 0.0, 0.0
    for audio, lengths, texts in dm.test_dataloader():
        t0 = time.time()
        hyps = predictor.predict(np.asarray(audio), np.asarray(lengths), beam_width=args.beam_width, **beam_kwargs)
        decode_seconds += time.time() - t0
        wer.update(hyps, list(texts))
        cer.update(hyps, list(texts))
        utterances += len(texts)
        audio_seconds += float(np.asarray(lengths).sum()) / args.sample_rate
    print(json.dumps({
        "manifest": args.manifest,
        "utterances": utterances,
        "audio_seconds": round(audio_seconds, 1),
        "wer": round(wer.compute(), 4),
        "cer": round(cer.compute(), 4),
        "rtf": round(audio_seconds / max(decode_seconds, 1e-9), 1),
    }))


def cmd_train(args):
    from thunder_tpu_torch.data import ManifestDatamodule
    from thunder_tpu_torch.finetune import finetune_ctc_module
    from thunder_tpu_torch.models import Conv1dDecoder
    from thunder_tpu_torch.training.loggers import ConsoleLogger
    from thunder_tpu_torch.training.trainer import FinetuneEncoderDecoder, Trainer

    kwargs = {}
    if args.tokens:
        kwargs = dict(tokens=list(args.tokens), decoder_builder=Conv1dDecoder)
    module = finetune_ctc_module(args.checkpoint, checkpoint_kwargs={"device": args.device}, **kwargs)
    dm = ManifestDatamodule(args.train_manifest, args.val_manifest or args.train_manifest,
                            args.test_manifest or args.train_manifest, batch_size=args.batch_size,
                            num_workers=args.num_workers)
    callbacks = []
    if args.unfreeze_encoder_at_epoch is not None:
        callbacks.append(FinetuneEncoderDecoder(unfreeze_encoder_at_epoch=args.unfreeze_encoder_at_epoch))
    trainer = Trainer(max_epochs=args.epochs, optimizer_kwargs={"learning_rate": args.lr}, callbacks=callbacks,
                      checkpoint_dir=args.checkpoint_dir, logger=ConsoleLogger(), log_every=args.log_every,
                      device=args.device)
    trainer.fit(module, datamodule=dm)


def cmd_export(args):
    from thunder_tpu_torch.export import aot_export, save_inference_bundle

    module = _load(args)
    out = save_inference_bundle(args.output, module)
    print(f"bundle: {out}")
    if args.aot:
        path = f"{args.output}/predict.pt2"
        aot_export(module, batch_size=args.batch_size, num_samples=int(args.seconds * 16000), path=path)
        print(f"aot: {path}")


def _add_lm_args(p):
    p.add_argument("--arpa", help="ARPA/.gz word LM for shallow fusion (implies beam)")
    p.add_argument("--lm-transcripts", help="text file to fit a word n-gram LM on")
    p.add_argument("--lm-order", type=int, default=3)
    p.add_argument("--lm-weight", type=float, default=1.0)
    p.add_argument("--hotword", action="append", default=[], metavar="WORD:BOOST",
                   help="bias a word up at decode time (repeatable)")
    p.add_argument("--word-score", type=float, default=0.0,
                   help="flat bonus per decoded word (negative = insertion penalty)")


def _add_device_arg(p):
    p.add_argument("--device", default="cuda", help="torch device to run on (default: cuda; cpu asks for the CPU)")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="thunder_tpu_torch", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("transcribe", help="greedy-CTC transcription of audio files")
    p.add_argument("audio", nargs="+")
    p.add_argument("--checkpoint", required=True, help="registry name, .nemo path, or HF id")
    p.add_argument("--engine", action="store_true", help="use the optimized inference engine")
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--chunk-seconds", type=float, default=20.0)
    p.add_argument("--overlap-seconds", type=float, default=None,
                   help="chunk overlap (default: min(2s, chunk/4))")
    _add_lm_args(p)
    p.add_argument("--timestamps", action="store_true",
                   help="also emit per-token time spans (forced alignment)")
    p.add_argument("--beam-width", type=int, default=None,
                   help="CTC prefix beam search width (default: greedy)")
    p.add_argument("--beam-backend", choices=("host", "device"), default=None,
                   help="where the beam search runs (device = on the card; an LM ranks its beams on the host)")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_transcribe)

    p = sub.add_parser("eval", help="WER/CER of a checkpoint over a NeMo manifest")
    p.add_argument("--manifest", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--engine", action="store_true", help="use the optimized inference engine")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--beam-width", type=int, default=None)
    p.add_argument("--beam-backend", choices=("host", "device"), default=None,
                   help="where the beam search runs (device = on the card; an LM ranks its beams on the host)")
    _add_lm_args(p)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("train", help="finetune a checkpoint on NeMo manifests")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--train-manifest", required=True)
    p.add_argument("--val-manifest")
    p.add_argument("--test-manifest")
    p.add_argument("--tokens", help="new vocabulary characters (swaps the head)")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--unfreeze-encoder-at-epoch", type=int, default=None)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--log-every", type=int, default=50)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("export", help="write an inference bundle (+ optional AOT artifact)")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--aot", action="store_true", help="also write predict.pt2, the exported predict graph")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seconds", type=float, default=15.0)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_export)

    args = parser.parse_args(argv)
    from thunder_tpu_torch.kernels.selftest import exact_float32
    from thunder_tpu_torch.module import require_device

    try:
        require_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"thunder_tpu_torch: {err} (pass --device cpu to run on the CPU)")
    exact_float32()
    args.fn(args)


if __name__ == "__main__":
    main()
