"""``correct`` comes out false when the timed path is broken underneath:
each run skips the harness's look for a chip and drives the rest of a
smoke run on the CPU, with one fault planted in the program (a step that
returns its state unchanged, half of the batch left out, an answer
altered where it is produced, in every row or in one row alone), against the limits the chip readings set.
The unbroken run of each cell at the same size comes out correct.  The
control (the reference one precision below, in the program's place) is
held to the same limits: LeNet's on the CPU too, and every cell's on the
card at its own size."""
from unittest import mock

import pytest
import torch

from _cells import smoke_run


def _unchanged_round(entry):
    """Every cloud round leaves the fleet's model as it was."""
    from repro_torch.fl.sim import HFLSimulator
    p = mock.patch.object(HFLSimulator, "_cloud_round",
                          lambda self, *a, **k: None)
    p.start()
    entry._patches.callback(p.stop)


def _half_batch(entry):
    """Local GD on the first half of each UE's samples, the mean taken over
    them."""
    from repro_torch.fl import clients
    gd = clients.gd_local_steps

    def half(*a, **k):
        run = gd(*a, **k)

        def step(params, batches):
            n = next(iter(batches.values())).shape[1] // 2
            return run(params, {key: v[:, :n] for key, v in batches.items()})
        return step
    p = mock.patch.object(clients, "gd_local_steps", half)
    p.start()
    entry._patches.callback(p.stop)


def _altered_cloud_model(entry):
    """The cloud aggregation's result has one element moved by 0.5."""
    from repro_torch.fl import aggregate
    agg = aggregate.flat_cloud_aggregate

    def altered(buf, w, **k):
        out = agg(buf, w, **k).clone()
        out[:, 0] += 0.5
        return out
    p = mock.patch.object(aggregate, "flat_cloud_aggregate", altered)
    p.start()
    entry._patches.callback(p.stop)


def _stale_cache(entry):
    """Every decode step returns the cache it was given."""
    from repro_torch.launch import steps
    make = steps.make_serve_step

    def stale(model):
        step = make(model)

        def serve(params, state, tokens):
            tok, _ = step(params, state, tokens)
            return tok, state
        return serve
    p = mock.patch.object(steps, "make_serve_step", stale)
    p.start()
    entry._spans.callback(p.stop)


def _shifted_tokens(entry):
    """Every served token is the next id after the one the step chose."""
    from repro_torch.launch import steps
    make = steps.make_serve_step

    def shifted(model):
        step = make(model)

        def serve(params, state, tokens):
            tok, st = step(params, state, tokens)
            return (tok + 1) % model.cfg.vocab_size, st
        return serve
    p = mock.patch.object(steps, "make_serve_step", shifted)
    p.start()
    entry._spans.callback(p.stop)


def _shifted_first_token(entry):
    """Every request's last logits (and so its first token) are those of
    the row before it."""
    from repro_torch.models.model import Model
    prefill = Model.prefill

    def altered(self, params, batch):
        logits, state = prefill(self, params, batch)
        return logits.roll(1, 0), state
    p = mock.patch.object(Model, "prefill", altered)
    p.start()
    entry._spans.callback(p.stop)


def _one_row_tokens(entry):
    """One row of every decode step serves the next id after the one the
    step chose; the other rows are served as chosen."""
    from repro_torch.launch import steps
    make = steps.make_serve_step

    def shifted(model):
        step = make(model)

        def serve(params, state, tokens):
            tok, st = step(params, state, tokens)
            tok = tok.clone()
            tok[0] = (tok[0] + 1) % model.cfg.vocab_size
            return tok, st
        return serve
    p = mock.patch.object(steps, "make_serve_step", shifted)
    p.start()
    entry._spans.callback(p.stop)


def _one_row_cache(entry):
    """One row of every request's K/V cache holds each position's keys and
    values at the position after it; the other rows are as built."""
    from repro_torch.models.model import Model
    prefill = Model.prefill

    def altered(self, params, batch):
        logits, state = prefill(self, params, batch)
        S = batch["tokens"].shape[1]
        for n in ("k", "v"):
            kv = state["scanned"][n]
            kv[:, 0, :S] = kv[:, 0, :S].roll(1, 1)
        return logits, state
    p = mock.patch.object(Model, "prefill", altered)
    p.start()
    entry._spans.callback(p.stop)


def _half_batch_prefill(entry):
    """Each request prefills the first half of its rows alone, and serves
    their logits and cache for the other half too."""
    from repro_torch.models.model import Model
    prefill = Model.prefill

    def half(self, params, batch):
        n = batch["tokens"].shape[0] // 2
        logits, state = prefill(self, params, {"tokens":
                                               batch["tokens"][:n]})
        sc = dict(state["scanned"])
        for k in ("k", "v"):
            sc[k] = torch.cat([sc[k], sc[k]], 1)
        return torch.cat([logits, logits]), {**state, "scanned": sc}
    p = mock.patch.object(Model, "prefill", half)
    p.start()
    entry._spans.callback(p.stop)


FAULTS = [("lenet-sync-paper", _unchanged_round),
          ("lenet-sync-paper", _half_batch),
          ("lenet-sync-paper", _altered_cloud_model),
          ("qwen-moe-decode-b32", _stale_cache),
          ("qwen-moe-decode-b32", _shifted_tokens),
          ("qwen-moe-decode-b32", _one_row_tokens),
          ("qwen-moe-prefill-4k", _shifted_first_token),
          ("qwen-moe-prefill-4k", _one_row_cache),
          ("qwen-moe-prefill-4k", _half_batch_prefill)]


@pytest.mark.parametrize("cell", sorted({c for c, _ in FAULTS}))
def test_unbroken_smoke_run_is_correct(capsys, cell):
    assert smoke_run(capsys, cell)["correct"] is True


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f.__name__.strip("_") for _, f in FAULTS])
def test_broken_timed_path_is_not_correct(capsys, cell, fault):
    assert smoke_run(capsys, cell, hook=fault)["correct"] is False


def _control(entry):
    """The entry's check with its control in the program's place."""
    check = entry.check
    kw = next(iter(entry.CONTROLS.values()))
    entry.check = lambda: check(**kw)


def test_tf32_control_is_not_correct(capsys):
    """LeNet's control on the CPU: the reference's convolutions on
    TF32-rounded operands (the dense products take TF32 on a card alone)."""
    assert smoke_run(capsys, "lenet-sync-paper",
                     hook=_control)["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lenet-sync-paper", "qwen-moe-decode-b32",
                                  "qwen-moe-prefill-4k"])
def test_control_is_not_correct_on_the_card(capsys, cell):
    """At the cell's own size on the card: TF32 for LeNet's fp32, float8
    for the bf16 model (a smoke model is too shallow for float8 to show)."""
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's own size on a card")
    import json
    import run
    rc = run.main(["--workload", cell, "--seed", "17", "--seconds", "3",
                   "--trace", "0"], entry_hook=_control)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is False
