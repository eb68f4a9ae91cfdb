"""What decides ``correct`` for a served model: the plain reference run over the served rows, and the served
tokens judged by it.

For each valid frame the served token's reference logit is compared with the reference's best there; the
compared number is the widest such gap over the sample, in logits. Greedy tokens only: the cells decode
greedily. The served text of each row must also be the CTC collapse of its served tokens (repeats merged,
blanks dropped), so that an answer altered after the argmax shows too.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from asrbench.traffic.corpus import bucket


@contextlib.contextmanager
def float32_exact():
    """TF32 off for the reference's products and convolutions, restored after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def collapse_text(ids: np.ndarray, vocabulary: list) -> str:
    """Greedy CTC: repeats merged, then the blank (the id after the vocabulary) dropped."""
    ids = np.asarray(ids)
    if ids.size:
        ids = ids[np.concatenate([[True], ids[1:] != ids[:-1]])]
    return "".join(vocabulary[i] for i in ids if i < len(vocabulary))


@torch.no_grad()
def reference_logits(model, audio: np.ndarray, lengths: np.ndarray, device, block: int = 16):
    """float32 reference logits ``(B, frames, V)`` on the host of a host batch padded as the engine pads it, and
    the frame lengths; computed ``block`` rows at a time."""
    width = bucket(audio.shape[1])
    padded = np.zeros((audio.shape[0], width), np.float32)
    padded[:, : audio.shape[1]] = audio
    out, frames = [], []
    with float32_exact():
        for lo in range(0, len(padded), block):
            a = torch.as_tensor(padded[lo: lo + block], device=device)
            n = torch.as_tensor(lengths[lo: lo + block].astype(np.int64), device=device)
            logits, out_lengths = model.forward(a, n)
            out.append(logits.float().cpu().numpy())
            frames.append(out_lengths.cpu().numpy())
    return np.concatenate(out), np.concatenate(frames)


def token_gaps(rows) -> dict:
    """``rows``: ``(reference logits (T, V), reference frames, served tokens (T',), served frames, served logits
    (T', V))`` of each judged row. Per valid frame, the reference's best logit less its logit of the served token:
    the widest gap, the mean one, the share of frames whose served token is not the reference's best; the
    root-mean-square gap of the served logits from the reference's over the valid frames, as a share of the
    reference's root-mean-square logit (``logit_rms_error``) and its largest absolute gap; the frames compared, and
    the rows whose frame count differs from the reference's."""
    gaps, rows_off, sq_err, sq_ref, worst = [], 0, 0.0, 0.0, 0.0
    for logits, n, served, served_n, served_logits in rows:
        n = int(n)
        if int(served_n) != n:
            rows_off += 1
            continue
        lg = logits[:n].astype(np.float64)
        gaps.append(lg.max(axis=-1) - np.take_along_axis(lg, served[:n, None].astype(np.int64), axis=-1)[:, 0])
        err = served_logits[:n].astype(np.float64) - lg
        sq_err += float(np.square(err).sum())
        sq_ref += float(np.square(lg).sum())
        worst = max(worst, float(np.abs(err).max()) if err.size else 0.0)
    g = np.concatenate(gaps) if gaps else np.zeros(0)
    return {"widest_gap": float(g.max()) if g.size else float("inf"), "mean_gap": float(g.mean()) if g.size else 0.0,
            "argmax_differs": float((g > 0).mean()) if g.size else 0.0,
            "logit_rms_error": (sq_err / sq_ref) ** 0.5 if sq_ref > 0 else float("inf"), "logit_max_error": worst,
            "frames": int(g.size), "rows_with_other_lengths": rows_off}
