"""The port's examples (``examples/torch_*.py``) run on the CPU and print
what the JAX examples print.

Each ``main`` runs in-process with ``--device cpu``.  The reservoir
examples run the same float64 math as the JAX ones, so their lines are held
against the JAX examples' own output, run in the same process: the labels
word for word, the numbers to their printed precision — except the resumed
session of ``serve_sessions``, whose readout is a ridge solve that parts
from JAX's past 1e-7 (ROADMAP C3) along modes the served reservoir grows
(C5), so only its label and a finite value are held.  The LM examples draw
their weights from a torch generator (the JAX ones from a JAX key): their
lines are held to the JAX examples' templates, with the same prompts.
"""
import importlib.util
import json
import pathlib
import re

import numpy as np
import pytest

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
NUM = r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?"


def _main(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _run(capsys, name, *argv):
    _main(name)(*argv)
    return capsys.readouterr().out.splitlines()


def _split(line):
    """(the line with its numbers replaced by '#', the numbers)."""
    return re.sub(NUM, "#", line), [float(v) for v in re.findall(NUM, line)]


def test_quickstart_prints_the_jax_examples_lines(capsys):
    want = _run(capsys, "quickstart")
    got = _run(capsys, "torch_quickstart", ["--device", "cpu"])
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        (gt, gv), (wt, wv) = _split(g), _split(w)
        assert gt == wt
        if "scan max err" in g:       # float64 rounding, ~1e-16 both
            assert gv[0] <= 1e-12 and wv[0] <= 1e-12
        else:                         # RMSEs, printed to 4 digits
            np.testing.assert_allclose(gv, wv, rtol=2e-3)


def test_serve_sessions_prints_the_jax_examples_lines(capsys):
    want = _run(capsys, "serve_sessions")
    got = _run(capsys, "torch_serve_sessions", ["--device", "cpu"])
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        if g.startswith("alice resumed"):
            assert _split(g)[0] == _split(w)[0]
            assert np.isfinite(_split(g)[1]).all()
        else:
            assert g == w


def test_serve_batched_prints_the_jax_examples_lines(capsys):
    got = _run(capsys, "torch_serve_batched", ["--device", "cpu"])
    assert re.fullmatch(
        rf"served 4 requests: prefill \d+ steps in {NUM}s, decoded 32 "
        rf"tokens in {NUM}s \({NUM} tok/s on CPU\)", got[0])
    assert got[1] == "sample continuations:" and len(got) == 6
    rng = np.random.default_rng(0)     # the JAX example's prompts
    prompts = [rng.integers(0, 512, size=rng.integers(8, 24))
               for _ in range(4)]
    assert f"prefill {max(len(p) for p in prompts)} steps" in got[0]
    for i, line in enumerate(got[2:]):
        m = re.fullmatch(rf"  req{i}: \.\.\.(\[.*\]) -> (\[.*\])", line)
        assert m and m.group(1) == str(prompts[i][-5:].tolist())
        cont = json.loads(m.group(2))
        assert len(cont) == 10 and all(0 <= t < 512 for t in cont)


def test_train_reservoir_lm_prints_the_jax_examples_lines(capsys):
    got = _run(capsys, "torch_train_reservoir_lm",
               ["--device", "cpu", "--steps", "20"])
    assert got[0] == "reservoir LM: 0.46M params"
    assert re.fullmatch(rf"step 20 loss {NUM} \({NUM} ms/step\)", got[1])
    m = re.fullmatch(rf"loss ({NUM}) -> ({NUM}) \(unigram ~5\.55, markov "
                     rf"floor ~1\.39\)", got[2])
    assert m and float(m.group(2)) < float(m.group(1)) - 0.5


def test_examples_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("torch_quickstart", "torch_serve_sessions",
                 "torch_serve_batched", "torch_train_reservoir_lm"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _main(name)([])
