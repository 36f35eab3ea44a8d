"""``repro_torch.tolerance.routed_matmuls`` against the JAX package: the hook
on the model layers' MLP products, installed and restored as the
reference's is (an exception included), and a reduced llama3.2-1b run
through ``AbftMatmul`` as ``tests/test_tolerance.py`` composes it: the
reference's planes replayed through ``planes=``, the ledger equal to the
JAX package's ``AbftMatmul(use_pallas=False)`` under its own model, three
products a layer, the routed logits within 1e-5 of the JAX package's, and
top-1 agreement with the clean forward above 0.9. At a rail below the
guard band (the study's 0.700 V at 65 C) the ledgers and logits still
agree: every count is decided by the planes and int32 arithmetic.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import tpu_fleet as JTF
from repro.models import layers as jlayers
from repro.models.model import Model as JModel
from repro.tolerance import AbftMatmul as JAbftMatmul
from repro.tolerance import TimingFaultModel as JTimingFaultModel
from repro.tolerance import routed_matmuls as jrouted
from repro_torch import tolerance as TT
from repro_torch.configs import registry
from repro_torch.models import layers
from repro_torch.models.model import Model
from test_torch_abft import LEDGER, jax_planes

ARCH = "llama3.2-1b"
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_routed_matmuls_installs_and_restores_the_hook():
    calls = []

    def spy(a, b):
        calls.append((tuple(a.shape), tuple(b.shape), a.dtype, b.dtype))
        return a @ b

    assert layers.MATMUL is None
    x = torch.ones((2, 3, 4), dtype=torch.bfloat16)
    w = torch.ones((4, 5), dtype=torch.bfloat16)
    with TT.routed_matmuls(spy) as mm:
        assert mm is spy and layers.MATMUL is spy
        y = layers.matmul(x, w)
    assert layers.MATMUL is None  # restored
    assert calls == [((6, 4), (4, 5), torch.float32, torch.float32)]
    assert y.shape == (2, 3, 5) and y.dtype == torch.bfloat16
    # nested blocks restore the outer hook; an exception restores too
    with TT.routed_matmuls(spy):
        with pytest.raises(RuntimeError, match="inside"):
            with TT.routed_matmuls(lambda a, b: a @ b):
                raise RuntimeError("inside the block")
        assert layers.MATMUL is spy
    assert layers.MATMUL is None and jlayers.MATMUL is None


@pytest.fixture(scope="module")
def models():
    """(JAX model, its params, the port's model, tokens, the two clean
    forwards), float32, the reference's layers unrolled as its study
    runs them."""
    kw = dict(dtype="float32", param_dtype="float32")
    jcfg = jregistry.get(ARCH).reduced().replace(scan_layers=False, **kw)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    model = Model(registry.get(ARCH).reduced().replace(**kw),
                  device="cpu").load_reference(jax.device_get(jp))
    tokens = (np.arange(2 * 12, dtype=np.int32).reshape(2, 12)
              % jcfg.vocab_size)
    jref = np.array(jm.apply(jp, {"tokens": tokens})[0])
    tref = model.apply({"tokens": tokens})[0]
    return jm, jp, model, tokens, jref, tref


def _probs(rail):
    if rail is None:
        return np.zeros(32)
    return np.asarray(JTimingFaultModel().bit_probs(rail, JTF.V_SRAM_NOM,
                                                    65.0))


@pytest.mark.parametrize("rail", [None, 0.700], ids=["clean", "0.700V"])
def test_routed_abft_model_equals_reference(models, rail):
    jm, jp, model, tokens, jref, tref = models
    key = jax.random.PRNGKey(3)
    probs = _probs(rail)
    ref = JAbftMatmul(probs, key, use_pallas=False)
    with jrouted(ref):
        jout = np.array(jm.apply(jp, {"tokens": tokens})[0])
    mm = TT.AbftMatmul(probs, seed=0, planes=jax_planes(key), device="cpu")
    with TT.routed_matmuls(mm):
        out = model.apply({"tokens": tokens})[0]
    assert layers.MATMUL is None
    assert mm._n == ref._n == 3 * model.cfg.num_layers
    assert [getattr(mm.counters, k) for k in LEDGER] == \
        [getattr(ref.counters, k) for k in LEDGER]
    assert mm.counters.checked > 0
    np.testing.assert_allclose(out.numpy(), jout, rtol=TOL, atol=TOL)
    if rail is None:
        assert mm.counters.injected == mm.counters.escaped == 0
        assert TT.topk_agreement(out, tref, k=1) > 0.9
        assert TT.topk_agreement(jout, jref, k=1) > 0.9
    else:
        assert mm.counters.injected > 0
