"""Faults planted under the timed path, to show that `correct` comes out
false when the program is broken: a step that returns its state
unchanged, half of the batch left out with the mean taken over the
rest, an answer altered where it is produced.  (On one card there is no
exchange between chips to leave out.)  Each takes the program's object
(the GBDT a training job drives, the Booster a scoring job drives) and
breaks it in place; the tests and `python -m bench_cuda.control --mode
fault:<name>` plant them."""

from __future__ import annotations

import numpy as np
import torch


# -- training (the GBDT) ---------------------------------------------------

def state_unchanged(gbdt):
    """Each step's score update is undone."""
    body = gbdt._step_body

    def step(*a, **kw):
        saved = gbdt.scores.clone()
        out = body(*a, **kw)
        gbdt.scores.copy_(saved)
        return out
    gbdt._step_body = step


def half_batch(gbdt):
    """The gradients of every other row left out and the rest doubled."""
    fn = gbdt.grad_fn

    def grad(score, state):
        g, h = fn(score, state)
        keep = (torch.arange(g.shape[0], device=g.device) % 2 == 0).to(g.dtype)
        return g * keep * 2, h * keep * 2
    gbdt.grad_fn = grad


def answer_altered(gbdt):
    """Every tree's largest leaf value moved by 10 % as the tree is
    unpacked."""
    unpack = gbdt._unpack_tree

    def altered(p):
        t = unpack(p)
        t.leaf_value = np.array(t.leaf_value, dtype=np.float64)
        if len(t.leaf_value):
            t.leaf_value[int(np.argmax(np.abs(t.leaf_value)))] *= 1.1
        return t
    gbdt._unpack_tree = altered


# -- scoring (the Booster) ----------------------------------------------------

def stale_output(booster):
    """A call returns the previous call's answer."""
    predict = booster.predict
    last = []

    def stale(x):
        out = predict(x)
        got = last[0] if last else out
        last[:] = [out]
        return got
    booster.predict = stale


def half_rows(booster):
    """Only the first half of the rows scored, the rest given their
    mean."""
    predict = booster.predict

    def half(x):
        m = len(x) // 2
        out = predict(x[:m])
        return np.concatenate([out, np.full(len(x) - m, out.mean())])
    booster.predict = half


def one_row_altered(booster):
    """One row's probability moved by 1e-6."""
    predict = booster.predict

    def altered(x):
        out = np.array(predict(x), dtype=np.float64)
        out[len(out) // 3] += 1e-6
        return out
    booster.predict = altered


BY_KIND = {"train": (state_unchanged, half_batch, answer_altered),
           "score": (stale_output, half_rows, one_row_altered)}
