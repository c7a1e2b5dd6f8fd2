"""Shared helpers of the example parity tests (`test_torch_examples_*.py`):
each example loaded by path from `examples/` (the JAX package's) or
`examples_torch/` (the port's), a JAX example's engines and routers
recorded as it runs, and the JAX init weights carried into the port. Not
a test module itself."""

import functools
import importlib.util
import tempfile
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax

from repro import configs as JC
from repro.checkpoint.manager import save_pytree
from repro.models import transformer as JT
from repro_torch.checkpoint.convert import convert

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("quickstart", "sparsity_sweep", "train_resume", "serve_batched",
         "serve_prefix", "serve_speculative", "serve_router", "serve_traced")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-sized CPU ops run far faster on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load(name, port=True):
    """A fresh module of the example `name`: the port's (examples_torch/)
    or, with port=False, the JAX package's (examples/)."""
    folder = "examples_torch" if port else "examples"
    spec = importlib.util.spec_from_file_location(
        f"{folder}_{name}", ROOT / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def record(mod, name):
    """Swap the class `name` the loaded example calls for a subclass that
    keeps every instance made and each one's submitted requests (in
    `.submitted`); returns the list the instances land in."""
    made = []

    class Recorded(getattr(mod, name)):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.submitted = []
            made.append(self)

        def submit(self, *a, **kw):
            r = super().submit(*a, **kw)
            self.submitted.append(r)
            return r

    setattr(mod, name, Recorded)
    return made


@functools.lru_cache(maxsize=None)
def carried(arch, spec=None):
    """The port's dense tree of the smoke `arch` on the weights the JAX
    registry loads under the KratosSpec `spec` (a JAX one; None: the
    config's own), `T.init(PRNGKey(0), cfg)`: a sparse spec's init zeroes
    the pruned blocks, and a quantized pack's scale reads them."""
    cfg = JC.get_smoke(arch) if spec is None else \
        JC.get_smoke(arch, kratos=spec)
    with tempfile.TemporaryDirectory() as d:
        save_pytree(d, JT.init(jax.random.PRNGKey(0), cfg))
        return convert(d, cfg.n_layers)


def tokens(reqs):
    return [[int(t) for t in r.generated] for r in reqs]


def assert_fields_equal(got, want, keys):
    for k in keys:
        assert got[k] == want[k], (k, got[k], want[k])
