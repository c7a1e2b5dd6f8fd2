"""Port parity, `examples_torch/serve_batched.py` against
`examples/serve_batched.py` on the CPU (the JAX example runs as shipped,
its engines recorded; the port's on the same weights, carried through
`checkpoint/convert.py`): greedy tokens per request, the step-clock
counters, the slab's bytes and the printed lines but their seconds. Also
every example's refusal of `--device cuda` without a card."""

import dataclasses
import re

import numpy as np
import pytest

from torch_examples import (NAMES, assert_fields_equal, carried, load,
                            one_torch_thread, record, tokens)  # noqa: F401

import torch

# step-clock fields of an engine's report: equal to JAX's
STEP_FIELDS = ("tokens_generated", "decode_steps", "tokens_per_step",
               "host_syncs_per_token", "mean_occupancy",
               "requests_completed")


def _scrub(line):
    """A printed line without its wall-clock seconds."""
    return re.sub(r" +\d+\.\ds \|", " _s |", line)


def test_serve_batched_matches_jax(capsys):
    jex = load("serve_batched", port=False)
    engines = record(jex, "InferenceEngine")
    jex.main()
    want = capsys.readouterr().out.splitlines()
    ex = load("serve_batched")
    assert (ex.ARCHS, ex.TRACE, ex.N_SLOTS, ex.MAX_LEN, ex.DECODE_CHUNK) \
        == (jex.ARCHS, jex.TRACE, jex.N_SLOTS, jex.MAX_LEN, jex.DECODE_CHUNK)
    assert dataclasses.asdict(ex.SPEC) == dataclasses.asdict(jex.SPEC)
    out = ex.main(["--device", "cpu"],
                  params={a: carried(a, jex.SPEC) for a in ex.ARCHS})
    got = capsys.readouterr().out.splitlines()
    assert len(engines) == len(ex.ARCHS)
    for arch, eng in zip(ex.ARCHS, engines):
        r = out[arch]
        assert r["tokens"] == tokens(eng.submitted), arch
        assert_fields_equal(r["report"], eng.metrics.report(), STEP_FIELDS)
        assert r["pool_bytes"] == eng.pool.bytes(), arch
        np.testing.assert_allclose(r["compression"], eng.model.compression,
                                   rtol=1e-6, err_msg=arch)
    assert [_scrub(s) for s in got] == [_scrub(s) for s in want]


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_example_refuses_cuda_without_a_card(name, monkeypatch):
    ex = load(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex.main(["--device", "cuda"])
