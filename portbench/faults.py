"""Faults planted under a cell's timed path, for the readings a limit is
set from (``control.py``) and for the tests that see ``correct`` come out
false. Each is a function of a driver after its ``setup`` that breaks
what the window runs."""

from __future__ import annotations

import torch


def state_unchanged(driver):
    """Training: every optimizer step leaves the parameters as they are."""
    driver.trainer.optimizer.adamw.step = lambda *a, **k: None


def half_batch_train(driver):
    """Training: half of each batch left out, the loss's mean taken over
    the rest."""
    step = driver.trainer.train_step

    def half(inputs, targets):
        h = inputs[0].shape[0] // 2
        return step(tuple(x[:h] for x in inputs),
                    {k: v[:h] for k, v in targets.items()})
    driver.trainer.train_step = half


class _HalfModel(torch.nn.Module):
    def __init__(self, model):
        super().__init__()
        self.inner = model

    def forward(self, images, mask):
        h = (images.shape[0] + 1) // 2
        out = self.inner(images[:h], mask[:h])
        n = images.shape[0]

        def widen(x):
            return torch.cat([x, x], 0)[:n]
        return {k: widen(v) for k, v in out.items()
                if isinstance(v, torch.Tensor)}


def half_batch_serve(driver):
    """Serving: the model runs half of each batch; the other half's
    outputs are copies."""
    driver.model = _HalfModel(driver.model)


def altered_answer(driver):
    """Serving: one served box of each batch moved where ``inference``
    produces it."""
    infer = driver.infer

    def altered(out, **kwargs):
        dets = infer(out, **kwargs)
        for d in dets:
            if len(d):
                d.array[0, 0] = (d.array[0, 0] + 0.25) % 1.0
                break
        return dets
    driver.infer = altered


FAULTS = {"state_unchanged": state_unchanged,
          "half_batch_train": half_batch_train,
          "half_batch_serve": half_batch_serve,
          "altered_answer": altered_answer}
