"""The port's Mamba2 block (``repro_torch.models.ssm``) against the JAX
package's on ``mamba2-780m.reduced()`` (d_model 64, 8 heads of 16, state 16,
chunk 32), the reference's block parameters carried across by
``params.from_reference`` and cast as ``Model`` casts them. The parameters
the reference initialises to ones and zeros (A_log, D, dt_bias, conv_b,
norm) are drawn at random here, so that every head decays at its own rate.

``ssm_apply`` (a 64-token prefill: two chunks, so the carried state runs)
and ``ssm_decode`` agree within 1e-5 in float32, outputs and states; in
bfloat16 (the working type) within 0.06 on outputs (the reference's bound
between its own bf16 tiers, ``tests/test_tolerance.py``) and 2e-2 on the
float32 states. On the CPU the scan runs the kernel's plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import params as jpm
from repro.models import ssm as jssm
from repro.sharding.plan import make_plan
from repro_torch.configs import registry
from repro_torch.kernels import mamba_scan as MS
from repro_torch.models import params as pm
from repro_torch.models import ssm
from repro_torch.models.model import Model, _cast

ARCH = "mamba2-780m"
TOL = {"float32": 1e-5, "bfloat16": 0.06}
STATE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def block(request):
    """(dtype, JAX config, plan, JAX params, port config, port params)."""
    dt = request.param
    jcfg = jregistry.get(ARCH).reduced().replace(dtype=dt)
    plan = make_plan(jcfg, None)
    jp = jax.device_get(jpm.materialize(jssm.ssm_params(jcfg, plan),
                                        jax.random.PRNGKey(1), "float32"))
    rng = np.random.default_rng(1)
    jp = dict(jp)
    for k in ("A_log", "D", "dt_bias", "conv_b", "norm"):
        jp[k] = (0.5 * rng.standard_normal(jp[k].shape)).astype(np.float32)
    jp["norm"] += 1.0
    cfg = registry.get(ARCH).reduced().replace(dtype=dt)
    tp = _cast(pm.from_reference(jp), pm.torch_dtype(dt))
    return dt, jcfg, plan, jp, cfg, tp


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_ssm_apply(block):
    dt, jcfg, plan, jp, cfg, tp = block
    x = np.random.default_rng(2).standard_normal((2, 64, 64)).astype(
        np.float32)
    jo, js = jssm.ssm_apply(jp, jnp.asarray(x).astype(dt), jcfg, plan)
    to, ts = ssm.ssm_apply(tp, torch.from_numpy(x).to(pm.torch_dtype(dt)),
                           cfg)
    assert to.dtype == pm.torch_dtype(dt) and to.shape == jo.shape
    _close(to, jo, TOL[dt])
    _close(ts["ssm"], js["ssm"], STATE_TOL[dt])
    _close(ts["conv"], js["conv"], TOL[dt])
    assert ts["conv"].shape == (2, cfg.d_inner, cfg.ssm_conv - 1)


def test_ssm_decode(block):
    dt, jcfg, plan, jp, cfg, tp = block
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    st = {"ssm": 0.3 * rng.standard_normal((3, 8, 16, 16)).astype(np.float32),
          "conv": rng.standard_normal((3, 128, 3)).astype(np.float32)}
    jst = {"ssm": jnp.asarray(st["ssm"]),
           "conv": jnp.asarray(st["conv"]).astype(dt)}
    jo, jn = jssm.ssm_decode(jp, jnp.asarray(x).astype(dt), jst, jcfg, plan)
    tst = {"ssm": torch.from_numpy(st["ssm"]),
           "conv": torch.from_numpy(st["conv"]).to(pm.torch_dtype(dt))}
    to, tn = ssm.ssm_decode(tp, torch.from_numpy(x).to(pm.torch_dtype(dt)),
                            tst, cfg)
    assert tn is tst  # updated in place
    _close(to, jo, TOL[dt])
    _close(tn["ssm"], jn["ssm"], STATE_TOL[dt])
    _close(tn["conv"], jn["conv"], 0.0)


def test_prefill_then_decode_equals_the_forward():
    """Logits of a 32-token prefill followed by 32 one-token decode steps
    equal the 64-token forward's (two chunks of the scan): the recurrence
    and the chunked scan are one function. The prefill's logits agree
    within 1e-5; the decode steps within 1e-4, since the recurrence sums in
    another order than the scan and drifts by up to 2e-5 over 32 steps
    (still under the reference's 2e-4 between its scan kernel and
    oracle)."""
    jcfg = jregistry.get(ARCH).reduced().replace(dtype="float32")
    from repro.models.model import Model as JModel
    jp = jax.device_get(JModel(jcfg).init(jax.random.PRNGKey(0)))
    model = Model(registry.get(ARCH).reduced().replace(dtype="float32"),
                  device="cpu").load_reference(jp)
    toks = np.random.default_rng(4).integers(0, 256, (2, 64)).astype(np.int32)
    full, _ = model.apply({"tokens": toks})
    before = MS.mamba_scan.launches
    logits, cache = model.prefill({"tokens": toks[:, :32]}, max_len=64)
    assert MS.mamba_scan.launches == before  # plain version on the CPU
    np.testing.assert_allclose(logits.numpy(), full[:, :32].numpy(),
                               rtol=1e-5, atol=1e-5)
    for t in range(32, 64):
        step, cache = model.decode(toks[:, t:t + 1], cache, t)
        np.testing.assert_allclose(step[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_causal_conv_and_segsum_match_the_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    got = ssm._causal_conv(*(torch.from_numpy(a) for a in (x, w, b)), 4)
    want = jssm._causal_conv(*(jnp.asarray(a) for a in (x, w, b)), 4)
    _close(got, want, 1e-6)
    dA = -np.abs(rng.standard_normal((3, 16))).astype(np.float32)
    L = ssm._segsum_exp(torch.from_numpy(dA))
    _close(L, jssm._segsum_exp(jnp.asarray(dA)), 1e-6)
    assert torch.equal(L, torch.tril(L)) and torch.isfinite(L).all()
