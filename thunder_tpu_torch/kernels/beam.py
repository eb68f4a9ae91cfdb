"""CTC prefix beam search: the frame scan and the pointer-walk backtrace, as CUDA kernels and plain PyTorch.

Port of ``thunder_tpu/kernels/beam_pallas.py`` (``beam_scan_pallas``,
``beam_backtrace_pallas``), with the JAX wrappers' boundary:

- :func:`beam_scan`: ``logp (B, T, V)`` float32, lengths, the prune floor,
  ``blank``, ``beam_width`` (W), ``k_tokens`` and an optional carried
  ``init_state = (pb, pnb, h1, h2, last)``, each ``(B, W)``, go in;
  ``(parents, exts, total, state)`` come out: the per-frame pointers
  ``(B, T, W)`` int32, the final per-beam log-probability ``total (B, W)``
  and the final state. The hashes are uint32 values held in int32 bits, as
  in the TPU kernel.
- :func:`beam_backtrace`: ``(parents, exts, slots0 (B, n_out))`` in,
  ``(toks (B, n_out, T), origin (B, n_out))`` out.

When ``K = min(k_tokens, V) < V``, the candidates are pre-pruned outside the
kernel, as one XLA ``top_k`` does for the TPU kernel: a stable descending
sort (value descending, ties to the lower id, ``lax.top_k``'s order) of which
the first K are kept. When ``K >= V`` the ids are ``0..V-1`` and nothing is
sorted.

Each wrapper launches its kernel (``csrc/beam_search.cu``) for CUDA tensors
and runs its plain version (:func:`beam_scan_reference`,
:func:`beam_backtrace_reference`) only for CPU tensors. The plain scan is
the batched counterpart of the TPU kernel: a loop over frames of ``(B, W)``
and ``(B, W*K)`` tensor ops, with the top-W as a stable sort, and the hashes
in int64 masked to 32 bits (the products are split so that no int64 product
overflows).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from thunder_tpu_torch.kernels import _build

__all__ = [
    "MAX_CANDIDATES",
    "beam_scan",
    "beam_scan_reference",
    "beam_backtrace",
    "beam_backtrace_reference",
    "backtrace_plan",
    "candidates",
    "fresh_state",
    "scan_chunks",
    "scan_plan",
]

#: the largest per-frame candidate block W*K the JAX package's streaming device search allows; the kernel takes
#: any W*K (past one block of shared memory it walks a frame in chunks) and any W (past 2,901 its arrays live in
#: a device-memory workspace)
MAX_CANDIDATES = 8192
#: shared memory a block may use on sm_90 (``csrc/beam_search.cu``: ``MAX_SMEM``)
MAX_SHARED_BYTES = 232448
#: threads a scan block may have (``csrc/beam_search.cu``: ``MAX_THREADS``, ``MAX_TREE_THREADS`` for W <= 32)
MAX_THREADS, MAX_TREE_THREADS = 1024, 512
#: the chunked plan's runs a chunk for W > 32, ranked beside the picks' runs (``MAX_RANK_CHUNK_RUNS``)
MAX_RANK_CHUNK_RUNS = 128

#: the backtrace (``csrc/beam_search.cu``): past ``WALK_MAX_W`` it walks from device memory, ``BACKTRACE_THREADS``
#: paths a block; the serial walk on staged spans takes ``SERIAL_PATHS`` paths a block; the composed walk cuts a
#: span into ``SEGMENTS`` segments and takes W up to ``COMPOSE_MAX_W``
WALK_MAX_W, BACKTRACE_THREADS, SERIAL_PATHS, SEGMENTS, COMPOSE_MAX_W = 6144, 128, 128, 32, 63
BACKTRACE_ROUTES = ("walk", "serial", "composed")  # the C plan's route numbers

M1, M2 = 1000003, 2654435761
H_SEED = 1
DEAD_H1 = 0xFFFFFFFF
_MASK = 0xFFFFFFFF
_NEG = float("-inf")

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _pick_runs(beam_width: int) -> int:
    return 0 if beam_width <= 32 else -(-beam_width // 32)


def scan_plan(beam_width: int, k: int) -> dict:
    """Threads, shared memory, chunk and workspace of one scan block, as ``csrc/beam_search.cu::scan_plan``
    computes them.

    The one-block plan, where it fits in ``MAX_SHARED_BYTES`` (``chunk_runs`` 0): the ``C = W + W*K``
    candidates fall into ``ceil(C / 32)`` runs of 32, one warp's sort each; a thread per candidate, up to 512
    for ``W <= 32`` (whose warps' lists merge in a tree of at most 15 named barriers) and 1024 above. Shared
    memory in 4-byte words: the candidates' 8-byte keys (2 x 32 a run), the picks' keys (2W), the state
    double-buffered (2 x 6 W-vectors), the stay rows' pb, pnb, merged mass and repeated-last value (4W), and
    the frame's K candidates and ids with the blank's log-prob, double-buffered for the prefetch (2 x (2K + 1)).

    Else the chunked plan: the state and picks (18W), for ``W > 32`` the running picks as runs (64 words
    each of ``ceil(W / 32)``), and the keys of a chunk of ``chunk_runs`` runs (64 words a run): as many as
    fit, at most ``MAX_RANK_CHUNK_RUNS`` for ``W > 32``, no more than the extend rows fill. Where a chunk of
    one run does not fit beside the state (``W`` above 2,901), the workspace plan: the same words with
    ``MAX_RANK_CHUNK_RUNS`` runs a chunk (no more than the extend rows fill) in ``workspace_bytes`` of device
    memory a row, and no shared memory. ``workspace_bytes`` is 0 for the other plans.
    """
    runs = -(-(beam_width + beam_width * k) // 32)
    cap = MAX_TREE_THREADS if beam_width <= 32 else MAX_THREADS
    one_block = 4 * (18 * beam_width + 64 * runs + 4 * k + 2)
    if one_block <= MAX_SHARED_BYTES:
        return {"threads": min(cap, 32 * runs), "smem_bytes": one_block, "chunk_runs": 0, "workspace_bytes": 0}
    fixed = 18 * beam_width + 64 * _pick_runs(beam_width)
    in_smem = 4 * (fixed + 64) <= MAX_SHARED_BYTES
    chunk = (MAX_SHARED_BYTES // 4 - fixed) // 64 if in_smem else MAX_RANK_CHUNK_RUNS
    if beam_width > 32:
        chunk = min(chunk, MAX_RANK_CHUNK_RUNS)
    chunk = max(1, min(chunk, -(-(beam_width * k) // 32)))
    size = 4 * (fixed + 64 * chunk)
    return {"threads": min(cap, 32 * (_pick_runs(beam_width) + chunk)), "smem_bytes": size if in_smem else 0,
            "chunk_runs": chunk, "workspace_bytes": 0 if in_smem else size}


def scan_chunks(beam_width: int, k: int) -> list:
    """A frame's chunks in the kernel's order, as ``(rows, lo, hi)``: ``("extend", lo, hi)`` over the extend
    rows ``[0, W*K)``, then ``("stay", lo, hi)`` over the stay rows ``[0, W)``, each ``32 * chunk_runs`` rows
    at most; one ``("all", 0, W + W*K)`` for the one-block plan."""
    chunk = scan_plan(beam_width, k)["chunk_runs"]
    if chunk == 0:
        return [("all", 0, beam_width + beam_width * k)]
    size = 32 * chunk
    return [(rows, lo, min(lo + size, n)) for rows, n in (("extend", beam_width * k), ("stay", beam_width))
            for lo in range(0, n, size)]


def fresh_state(batch: int, beam_width: int, device) -> State:
    """The fresh search: slot 0 holds the empty prefix, the others are dead sentinels."""
    w = torch.arange(beam_width, device=device)
    pb = torch.where(w == 0, 0.0, _NEG).to(torch.float32).expand(batch, -1).contiguous()
    pnb = torch.full((batch, beam_width), _NEG, dtype=torch.float32, device=device)
    h1 = torch.where(w == 0, H_SEED, -1).to(torch.int32).expand(batch, -1).contiguous()  # -1: 0xFFFFFFFF
    h2 = torch.where(w == 0, H_SEED, w).to(torch.int32).expand(batch, -1).contiguous()
    last = torch.full((batch, beam_width), -1, dtype=torch.int32, device=device)
    return pb, pnb, h1, h2, last


def candidates(logp: torch.Tensor, k_tokens: int):
    """``(K, topv, topi)``: the top-K log-probs ``(B, T, K)`` and int32 ids by a stable descending
    sort when ``K < V``, else ``(V, None, None)`` (every token, ids ``0..V-1``)."""
    vocab = logp.shape[-1]
    k = min(int(k_tokens), vocab)
    if k >= vocab:
        return vocab, None, None
    vals, ids = torch.sort(logp, dim=-1, descending=True, stable=True)
    return k, vals[..., :k].contiguous(), ids[..., :k].to(torch.int32).contiguous()


def _check_scan(logp, lengths, blank, beam_width, k_tokens, init_state):
    if logp.ndim != 3 or logp.dtype != torch.float32:
        raise ValueError(f"the beam scan takes float32 logp (B, T, V), got {tuple(logp.shape)} {logp.dtype}")
    batch, _, vocab = logp.shape
    if lengths.shape != (batch,):
        raise ValueError(f"lengths must be ({batch},), got {tuple(lengths.shape)}")
    if not 0 <= blank < vocab:
        raise ValueError(f"blank {blank} outside the vocabulary of {vocab}")
    if beam_width < 1 or k_tokens < 1:
        raise ValueError(f"beam_width and k_tokens must be positive, got {beam_width}, {k_tokens}")
    if init_state is not None and (len(init_state) != 5 or any(a.shape != (batch, beam_width) for a in init_state)):
        raise ValueError(f"init_state must be five ({batch}, {beam_width}) arrays")


def _u32(h: torch.Tensor) -> torch.Tensor:
    return h.long() & _MASK


def _i32(h: torch.Tensor) -> torch.Tensor:
    return torch.where(h >= 2**31, h - 2**32, h).to(torch.int32)


def _mul_mod32(h: torch.Tensor, m: int) -> torch.Tensor:
    """``h * m mod 2**32`` for int64 ``h`` in ``[0, 2**32)``, with no int64 product above 2**48."""
    lo, hi = m & 0xFFFF, m >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _MASK


def beam_scan_reference(logp, lengths, floor, *, blank: int, beam_width: int, k_tokens: int,
                        init_state: Optional[State] = None):
    """Plain version of :func:`beam_scan`: a loop over frames, batched over rows."""
    _check_scan(logp, lengths, blank, beam_width, k_tokens, init_state)
    batch, frames, vocab = logp.shape
    dev, W = logp.device, beam_width
    K, topv, topi = candidates(logp, k_tokens)
    if topv is None:
        topv, topi = logp, torch.arange(vocab, device=dev).expand(batch, frames, vocab)
    floor = float(np.float32(floor))
    state = fresh_state(batch, W, dev) if init_state is None else init_state
    pb, pnb = (a.to(dev, torch.float32) for a in state[:2])
    h1, h2 = (_u32(a.to(dev)) for a in state[2:4])
    last = state[4].to(dev, torch.int64)
    lens = lengths.to(dev, torch.int64)
    arange_w = torch.arange(W, device=dev)[None, :]
    parents = torch.empty((batch, frames, W), dtype=torch.int32, device=dev)
    exts = torch.empty((batch, frames, W), dtype=torch.int32, device=dev)
    for t in range(frames):
        cv, ci = topv[:, t], topi[:, t].long()  # (B, K)
        p_blank = logp[:, t, blank][:, None]
        total = torch.logaddexp(pb, pnb)
        # stay rows: the blank path and the repeated-last path (last among the kept candidates)
        stay_pb = torch.where(p_blank >= floor, total + p_blank, _NEG)
        is_last = last[:, :, None] == ci[:, None, :]  # (B, W, K)
        p_last = torch.where(is_last, cv[:, None, :], _NEG).amax(-1)
        last_in = (is_last & (cv >= floor)[:, None, :]).any(-1) & (last >= 0)
        stay_pnb = torch.where(last_in, pnb + p_last, _NEG)
        # extend rows (B, W*K) in parent*K + slot order
        ok = ((cv >= floor) & (ci != blank))[:, None, :]
        base = torch.where(ci[:, None, :] == last[:, :, None], pb[:, :, None], total[:, :, None])
        ext = torch.where(ok, base + cv[:, None, :], _NEG).reshape(batch, W * K)
        vv = (ci + 2)[:, None, :]
        eh1 = ((_mul_mod32(h1, M1)[:, :, None] + vv) & _MASK).reshape(batch, W * K)
        eh2 = ((_mul_mod32(h2, M2)[:, :, None] + vv) & _MASK).reshape(batch, W * K)
        # merge: the masked max of the extend rows that hold a stay row's prefix is absorbed into it
        match = (eh1[:, :, None] == h1[:, None, :]) & (eh2[:, :, None] == h2[:, None, :])  # (B, W*K, W)
        stay_pnb = torch.logaddexp(stay_pnb, torch.where(match, ext[:, :, None], _NEG).amax(1))
        ext = torch.where(match.any(2), _NEG, ext)
        cand = torch.cat([torch.logaddexp(stay_pb, stay_pnb), ext], 1)
        m_pnb = torch.cat([stay_pnb, ext], 1)
        # top-W, ties to the lower index; once every candidate is -inf the TPU kernel picks index 0
        vals, order = torch.sort(cand, dim=1, descending=True, stable=True)
        live = arange_w < torch.isfinite(cand).sum(1, keepdim=True)
        idx = torch.where(live, order[:, :W], 0)
        best = torch.where(live, vals[:, :W], _NEG)
        stay = idx < W
        e = (idx - W).clamp_min(0)
        par = torch.where(stay, idx, e // K)
        tok = torch.where(stay, -1, ci.gather(1, e % K))
        dead = ~torch.isfinite(best)
        g_h1, g_h2 = h1.gather(1, par), h2.gather(1, par)
        n_pb = torch.where(dead | ~stay, _NEG, stay_pb.gather(1, par))
        n_pnb = torch.where(dead, _NEG, m_pnb.gather(1, idx))
        n_h1 = torch.where(dead, DEAD_H1, torch.where(stay, g_h1, (_mul_mod32(g_h1, M1) + tok + 2) & _MASK))
        n_h2 = torch.where(dead, arange_w, torch.where(stay, g_h2, (_mul_mod32(g_h2, M2) + tok + 2) & _MASK))
        n_last = torch.where(dead, -1, torch.where(stay, last.gather(1, par), tok))
        # commit, a no-op past the row's length or when every candidate is -inf
        valid = ((t < lens) & torch.isfinite(best[:, 0]))[:, None]
        pb, pnb = torch.where(valid, n_pb, pb), torch.where(valid, n_pnb, pnb)
        h1, h2 = torch.where(valid, n_h1, h1), torch.where(valid, n_h2, h2)
        last = torch.where(valid, n_last, last)
        parents[:, t] = torch.where(valid, par, arange_w)
        exts[:, t] = torch.where(valid, tok, -1)
    return parents, exts, torch.logaddexp(pb, pnb), (pb, pnb, _i32(h1), _i32(h2), last.to(torch.int32))


def beam_scan(logp, lengths, floor, *, blank: int, beam_width: int, k_tokens: int,
              init_state: Optional[State] = None):
    """``(parents, exts, total, state)`` of the frame scan: the kernel on the card, the plain version on the CPU."""
    _check_scan(logp, lengths, blank, beam_width, k_tokens, init_state)
    if logp.device.type == "cpu":
        return beam_scan_reference(logp, lengths, floor, blank=blank, beam_width=beam_width, k_tokens=k_tokens,
                                   init_state=init_state)
    if logp.device.type != "cuda":
        raise ValueError(f"the beam scan runs on cuda or cpu tensors, got {logp.device}")
    batch, frames, vocab = logp.shape
    dev, W = logp.device, beam_width
    if batch < 1:
        raise ValueError("the beam scan needs at least one row")
    K, topv, topi = candidates(logp, k_tokens)
    state = fresh_state(batch, W, dev) if init_state is None else init_state
    pb0, pnb0 = (a.to(dev, torch.float32).contiguous() for a in state[:2])
    h10, h20, last0 = (a.to(dev, torch.int32).contiguous() for a in state[2:])
    logp = logp.contiguous()
    lens = lengths.to(dev, torch.int32).contiguous()
    parents = torch.empty((batch, frames, W), dtype=torch.int32, device=dev)
    exts = torch.empty_like(parents)
    total, pb, pnb = (torch.empty((batch, W), dtype=torch.float32, device=dev) for _ in range(3))
    h1, h2, last = (torch.empty((batch, W), dtype=torch.int32, device=dev) for _ in range(3))
    ws_bytes = scan_plan(W, K)["workspace_bytes"]
    workspace = torch.empty(batch * ws_bytes, dtype=torch.uint8, device=dev) if ws_bytes else None
    status = _build.load().thunder_beam_scan(
        logp.data_ptr(), 0 if topv is None else topv.data_ptr(), 0 if topi is None else topi.data_ptr(),
        lens.data_ptr(), float(np.float32(floor)), pb0.data_ptr(), pnb0.data_ptr(), h10.data_ptr(), h20.data_ptr(),
        last0.data_ptr(), parents.data_ptr(), exts.data_ptr(), total.data_ptr(), pb.data_ptr(), pnb.data_ptr(),
        h1.data_ptr(), h2.data_ptr(), last.data_ptr(), batch, frames, vocab, K, W, int(blank),
        0 if workspace is None else workspace.data_ptr(), _build.stream(logp),
    )
    _build.check(status, "thunder_beam_scan")
    beam_scan.launches += 1
    return parents, exts, total, (pb, pnb, h1, h2, last)


def _round4(words: int) -> int:
    return (words + 3) & ~3


def backtrace_plan(beam_width: int, n_out: int, frames: int) -> dict:
    """The backtrace's plan for ``n_out`` paths a row over ``frames`` frames, as ``csrc/beam_search.cu::
    backtrace_plan`` computes it (``thunder_beam_backtrace_plan``).

    Past ``WALK_MAX_W`` the route is ``"walk"``: a thread a path, its loads from device memory, no span. Else the
    row's pointers are staged in spans of ``span`` frames (newest first), as many as fit ``MAX_SHARED_BYTES``
    beside the block's token rows (odd stride ``span | 1``) and, on the composed route, the segments' tables of W +
    1 slots, the entry slots handed down and the slot each path leaves a span with; each field of a span takes its
    words plus the up to 3 of its source's offset in a 16-byte line. The route is ``"composed"`` where W <=
    ``COMPOSE_MAX_W``, the paths are at most two a thread (``n_out <= 2 min(W + 1, 32)``) and the composed chain
    ``2 ceil(span / 32) + 31`` is shorter than the span, with ``32 min(W + 1, 32)`` threads (a segment's threads,
    consecutive); else ``"serial"``, a thread a path, ``SERIAL_PATHS`` paths a block and ``blocks_y`` blocks a row."""
    W = beam_width
    if W > WALK_MAX_W:
        return {"route": "walk", "threads": BACKTRACE_THREADS, "span": 0, "smem_bytes": 0,
                "blocks_y": -(-n_out // BACKTRACE_THREADS)}

    def fit(composed: bool) -> tuple:
        paths = n_out if composed or n_out < SERIAL_PATHS else SERIAL_PATHS
        extra = _round4(SEGMENTS * (W + 1)) + _round4(SEGMENTS * n_out) + _round4(n_out) if composed else 0
        room = MAX_SHARED_BYTES // 4 - 19 - paths - extra
        span = min(room // (2 * W + paths), max(frames, 1))
        words = 2 * _round4(span * W + 3) + _round4(paths * (span | 1)) + extra
        return span, 16 + 4 * words, paths

    per_segment = min(W + 1, 32)
    if W <= COMPOSE_MAX_W and n_out <= 2 * per_segment:
        span, smem, _ = fit(True)
        if 2 * -(-span // SEGMENTS) + SEGMENTS - 1 < span:
            return {"route": "composed", "threads": SEGMENTS * per_segment, "span": span, "smem_bytes": smem,
                    "blocks_y": 1}
    span, smem, paths = fit(False)
    return {"route": "serial", "threads": -(-paths // 32) * 32, "span": span, "smem_bytes": smem,
            "blocks_y": -(-n_out // SERIAL_PATHS)}


def _check_backtrace(parents, exts, slots0):
    if parents.ndim != 3 or exts.shape != parents.shape:
        raise ValueError(f"parents and exts must be one (B, T, W) shape, got {tuple(parents.shape)}, {tuple(exts.shape)}")
    if slots0.ndim != 2 or slots0.shape[0] != parents.shape[0]:
        raise ValueError(f"slots0 must be (B, n_out), got {tuple(slots0.shape)}")


def beam_backtrace_reference(parents, exts, slots0):
    """Plain version of :func:`beam_backtrace`: the sequential walk, newest frame first."""
    _check_backtrace(parents, exts, slots0)
    batch, frames, W = parents.shape
    slot = slots0.long()
    toks = torch.empty((batch, slot.shape[1], frames), dtype=torch.int32, device=parents.device)
    for t in range(frames - 1, -1, -1):
        inside = (slot >= 0) & (slot < W)
        s = slot.clamp(0, W - 1)
        toks[:, :, t] = torch.where(inside, exts[:, t].long().gather(1, s), -1)
        slot = torch.where(inside, parents[:, t].long().gather(1, s), 0)
    return toks, slot.to(torch.int32)


def beam_backtrace(parents, exts, slots0):
    """``(toks (B, n_out, T), origin (B, n_out))``: the kernel on the card, the plain walk on the CPU."""
    _check_backtrace(parents, exts, slots0)
    if parents.device.type == "cpu":
        return beam_backtrace_reference(parents, exts, slots0)
    if parents.device.type != "cuda":
        raise ValueError(f"the beam backtrace runs on cuda or cpu tensors, got {parents.device}")
    batch, frames, W = parents.shape
    n_out = slots0.shape[1]
    if batch < 1 or n_out < 1:
        raise ValueError("the beam backtrace needs at least one row and one output slot")
    dev = parents.device
    parents, exts = parents.to(torch.int32).contiguous(), exts.to(dev, torch.int32).contiguous()
    slots0 = slots0.to(dev, torch.int32).contiguous()
    toks = torch.empty((batch, n_out, frames), dtype=torch.int32, device=dev)
    origin = torch.empty((batch, n_out), dtype=torch.int32, device=dev)
    status = _build.load().thunder_beam_backtrace(
        parents.data_ptr(), exts.data_ptr(), slots0.data_ptr(), toks.data_ptr(), origin.data_ptr(),
        batch, frames, W, n_out, _build.stream(parents),
    )
    _build.check(status, "thunder_beam_backtrace")
    beam_backtrace.launches += 1
    return toks, origin


beam_scan.launches = 0
beam_backtrace.launches = 0
