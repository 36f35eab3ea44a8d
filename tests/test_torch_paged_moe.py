"""A capacity-bound MoE model in the paged engine with idle slots, the
port's against the reference's, on the CPU (reduced mixtral, float32).

A slot with no request runs its rows through the model with no key to see.
The paged kernel (and its plain version) writes such a row as an exact 0;
the reference's paged step gathers the slot's logical cache and takes a
softmax whose mask value is finite, so the row averages the slot's entries
uniformly. The row itself is discarded, but in an MoE layer its routes
compete for expert capacity with the real tokens of its dispatch group: an
idle slot ahead of a live one (requests that finish early) takes the live
rows' places. ``attention._unseen_rows`` gives such rows the reference's
average in the port's paged path, outside the kernel. With capacity factor
1.0 (routes dropped, asserted) and requests of 3 and 20 new tokens in
turn, every stream equals the reference engine's, with a sliding-window
ring that wraps, one that does not, and no window; with the kernel's
zeros left in place, streams depart (asserted), so the case reaches the
deviation.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models.model import Model as JModel
from repro.serve.engine import Engine as JEngine, Request as JRequest
from repro_torch.configs import registry
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models.model import Model
from repro_torch.serve import Engine, Request

PROMPTS = (5, 20, 9, 30)
KW = dict(batch_slots=4, max_len=64, eos_id=-1, warmup=False,
          prefill_chunk=8, paged=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: with several test processes sharing the cores, torch
    runs these on one thread (no op here is large enough for its result to
    depend on the count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(engine_cls, request_cls, model, *args):
    eng = engine_cls(model, *args, **KW)
    rng = np.random.default_rng(3)
    for rid, n in enumerate(PROMPTS):
        eng.submit(request_cls(rid, rng.integers(0, 256, n).astype(np.int32),
                               max_new=3 if rid % 2 == 0 else 20))
    while eng.step():
        pass
    return {r.rid: tuple(r.out) for r in eng.finished}


@pytest.fixture(scope="module", params=[0, 32, 4096],
                ids=["no_window", "ring32", "ring_unwrapped"])
def runs(request):
    """(the port's model, the reference paged engine's streams)."""
    kw = dict(dtype="float32", param_dtype="float32",
              moe_capacity_factor=1.0, sliding_window=request.param)
    jcfg = jregistry.get("mixtral-8x7b").reduced().replace(**kw)
    cfg = registry.get("mixtral-8x7b").reduced().replace(**kw)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    model = Model(cfg, device="cpu").load_reference(jax.device_get(jp))
    return model, _run(JEngine, JRequest, jm, jp)


def test_idle_slots_take_the_references_rows(runs):
    model, want = runs
    with moe.capture_routes() as routes:
        got = _run(Engine, Request, model)
    assert got == want
    assert sum(int((~r["keep"]).sum()) for r in routes) > 0  # drops


def test_the_kernels_zero_rows_would_move_a_token(runs, monkeypatch):
    model, want = runs
    monkeypatch.setattr(attn, "_unseen_rows", lambda o, *args: o)
    assert _run(Engine, Request, model) != want


def test_only_the_idle_slots_are_repaired(runs, monkeypatch):
    """The engine names the slots with no token in a tick: repairing those
    alone leaves the other slots' rows as repairing every slot leaves them,
    bit for bit, gives the idle slots' rows the same average within 1e-6
    relative (the average's sum rounds by the batch it is taken over: 1
    ulp seen), and a tick with every slot live repairs nothing."""
    model, want = runs
    repair = attn._unseen_rows
    counts = []

    def both(o, *args):
        *rest, slots = args
        got = repair(o.clone(), *args)
        ref = repair(o.clone(), *rest, None)
        live = [b for b in range(o.shape[0]) if b not in slots]
        assert torch.equal(got[live], ref[live])
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=0)
        counts.append(len(slots))
        return got

    monkeypatch.setattr(attn, "_unseen_rows", both)
    assert _run(Engine, Request, model) == want
    assert 0 in counts and max(counts) > 0
