"""The reference's training steps: the CTC loss, the backward and AdamW, in plain float32 PyTorch.

- :class:`Draws` gives the step's random numbers from a generator on the card seeded as the trainer's, by the
  same calls in the same order as the program's step draws them (``torch.rand`` for a dropout mask,
  ``torch.randn`` for the dither, a 31-bit ``torch.randint`` for each seed a training kernel hashes): the
  masks are worked out again, not taken from the program.
- :func:`ctc_loss`: log-softmax in float32, then ``F.ctc_loss`` with each row's loss over its target length,
  the batch's mean, infinities zeroed.
- :class:`AdamW`: decoupled weight decay, bias-corrected moments, ``eps`` outside the square root.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class Draws:
    """The training step's random numbers, in the program's order."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))

    def rand(self, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator, device=self.device)

    def randn(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator, device=self.device)

    def seed(self) -> torch.Tensor:
        return torch.randint(0, 2**31 - 1, (1,), generator=self.generator, device=self.device, dtype=torch.int32)


def ctc_loss(logits, out_lengths, targets, target_lengths, blank: int) -> torch.Tensor:
    log_probs = torch.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    return F.ctc_loss(log_probs, targets.long(), out_lengths.long(), target_lengths.long(), blank=blank,
                      reduction="mean", zero_infinity=True)


class AdamW:
    """``p <- p (1 - lr wd)``, then the Adam step with bias-corrected moments."""

    def __init__(self, lr: float, weight_decay: float = 1e-2, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.wd, self.b1, self.b2, self.eps = lr, weight_decay, b1, b2, eps
        self.t = 0
        self.m: dict = {}
        self.v: dict = {}

    @torch.no_grad()
    def step(self, params: dict) -> None:
        self.t += 1
        for name, p in params.items():
            g = p.grad
            m = self.m.setdefault(name, torch.zeros_like(p))
            v = self.v.setdefault(name, torch.zeros_like(p))
            p.mul_(1.0 - self.lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (v / (1.0 - self.b2**self.t)).sqrt_().add_(self.eps)
            p.addcdiv_(m, denom, value=-self.lr / (1.0 - self.b1**self.t))
            p.grad = None


def steps(model, trainable: list, batches: list, draws: Draws, blank: int, optimizer: AdamW,
          loss_rows: int | None = None) -> dict:
    """Run ``len(batches)`` training steps of the reference ``model`` (whose ``state`` holds the weights) on
    device batches ``(audio, lengths, targets, target_lengths)``; return each step's loss, the first step's
    gradient of every trainable leaf, and the leaves after the last step. ``loss_rows`` takes the loss over the
    first rows only (a fault planted for the checks' readings)."""
    params = {n: model.state[n].requires_grad_(True) for n in trainable}
    losses, first = [], None
    for audio, lengths, targets, target_lengths in batches:
        logits, out_lengths = model.forward(audio, lengths, train=True, draws=draws)
        k = slice(None, loss_rows)
        loss = ctc_loss(logits[k], out_lengths[k], targets[k], target_lengths[k], blank)
        loss.backward()
        losses.append(float(loss.detach()))
        if first is None:
            first = {n: p.grad.detach().clone() for n, p in params.items()}
        optimizer.step(params)
    return {"losses": losses, "first_grads": first, "params": {n: p.detach() for n, p in params.items()}}
