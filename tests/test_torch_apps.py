"""The §III-D demo apps of the port against the JAX package.

The port cannot reproduce ``jax.random``'s streams, so each comparison runs
both packages on the reference's arrays: its images and faces (the port's
``make_digits``/``make_faces``/``_hd_projection`` patched to return them),
its weights (``lenet_params_from_reference``, ``hd_model_from_reference``),
its error-injection planes and HD flips (the ``planes``/``flips`` hooks) and
its batch indices. Tolerances: the float LeNet path within 1e-5 relative
(float32 products summed in another order); the int8 path's logits within
1e-5 with equal argmax (the products are exact, the clip limit is rounded
as the reference's); five training steps within 1e-4 relative; the HD
prototypes and accuracies equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import apps as JA
from repro.kernels import overscale_matmul as jom
from repro_torch.core import apps as TA
from repro_torch.kernels import overscale_matmul as OM

KEY = jax.random.PRNGKey(42)


def _np(x):
    return np.array(x)


def jax_planes(key):
    """The reference's planes of its n-th call (``fold_in(key, n)``)."""
    def planes(n, shape):
        k1, k2 = jax.random.split(jax.random.fold_in(key, n))
        return tuple(torch.from_numpy(
            _np(jax.random.bits(k, shape, jnp.uint32)).view(np.int32))
            for k in (k1, k2))
    return planes


def _ref_params(key=KEY):
    p = JA.lenet_init(key)
    return p, TA.lenet_params_from_reference(
        {"w1": _np(p.w1), "w2": _np(p.w2), "w3": _np(p.w3)}, device="cpu")


def _patch_digits(monkeypatch, key, n):
    x, y = JA.make_digits(key, n)
    monkeypatch.setattr(TA, "make_digits", lambda seed, n_, img=16,
                        device=None: (torch.from_numpy(_np(x)),
                                      torch.from_numpy(_np(y)).long()))
    return x, y


# a heavy Fig-8-like profile: a 12-bit carry tail, ~40 % of outputs flip
PROBS = JA.scale_bit_probs(np.r_[np.zeros(20), np.full(12, 25.0)])


def test_resize_matrix_matches_jax_image_resize():
    x = np.random.default_rng(0).standard_normal((10, 8, 8)).astype(
        np.float32)
    want = _np(jax.image.resize(jnp.asarray(x), (10, 16, 16), "cubic"))
    R = TA.resize_matrix(8, 16)
    got = np.einsum("ij,cjk,lk->cil", R.astype(np.float64), x, R)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # rows sum to one: out-of-range taps are dropped and renormalised
    np.testing.assert_allclose(R.sum(1), 1.0, atol=1e-6)
    for n_in, n_out in [(8, 5), (6, 13)]:
        y = np.random.default_rng(1).standard_normal((n_in,)).astype(
            np.float32)
        np.testing.assert_allclose(
            TA.resize_matrix(n_in, n_out) @ y,
            _np(jax.image.resize(jnp.asarray(y), (n_out,), "cubic")),
            atol=1e-6)


def test_make_digits_is_seeded_and_normalised():
    x1, y1 = TA.make_digits(3, 64, device="cpu")
    x2, y2 = TA.make_digits(3, 64, device="cpu")
    assert x1.shape == (64, 16, 16, 1) and y1.shape == (64,)
    assert torch.equal(x1, x2) and torch.equal(y1, y2)
    assert int(y1.min()) >= 0 and int(y1.max()) <= 9
    base = TA._templates(16)
    assert float(base.mean()) == pytest.approx(0.0, abs=1e-6)
    assert float(base.std(correction=0)) == pytest.approx(1.0, abs=1e-5)
    x3, _ = TA.make_digits(4, 64, device="cpu")
    assert not torch.equal(x1, x3)


def test_lenet_float_path_matches_reference():
    p_j, p_t = _ref_params()
    x, _ = JA.make_digits(jax.random.fold_in(KEY, 999), 16)
    want = _np(JA.lenet_apply(p_j, x))
    got = TA.lenet_apply(p_t, torch.from_numpy(_np(x))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_lenet_int8_error_path_matches_reference():
    p_j, p_t = _ref_params()
    x, _ = JA.make_digits(jax.random.fold_in(KEY, 999), 16)
    k7 = jax.random.fold_in(KEY, 7)
    want = _np(JA.lenet_apply(p_j, x,
                              matmul=jom.make_int8_error_matmul(PROBS, k7)))
    mm = OM.make_int8_error_matmul(PROBS, seed=0, planes=jax_planes(k7),
                                   device="cpu")
    got = TA.lenet_apply(p_t, torch.from_numpy(_np(x)), matmul=mm).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("probs", [None, PROBS])
def test_lenet_accuracy_matches_reference(monkeypatch, probs):
    p_j, p_t = _ref_params()
    n = 64
    _patch_digits(monkeypatch, jax.random.fold_in(KEY, 999), n)
    want = JA.lenet_accuracy(p_j, KEY, n=n, bit_probs=probs)
    got = TA.lenet_accuracy(p_t, 0, n=n, bit_probs=probs,
                            planes=jax_planes(jax.random.fold_in(KEY, 7)),
                            device="cpu")
    assert got == want


def test_lenet_train_replays_reference_steps(monkeypatch):
    steps, batch, n_train = 5, 128, 1024
    kd, kp = jax.random.split(KEY)
    want, info = JA.lenet_train(KEY, steps=steps, batch=batch,
                                n_train=n_train)
    _patch_digits(monkeypatch, kd, n_train)
    _, init = _ref_params(kp)
    idx = lambda i: _np(jax.random.randint(jax.random.fold_in(kd, i),
                                           (batch,), 0, n_train))
    got, tinfo = TA.lenet_train(0, steps=steps, batch=batch,
                                n_train=n_train, device="cpu", init=init,
                                batch_indices=idx)
    for k in ("w1", "w2", "w3"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   _np(getattr(want, k)), rtol=1e-4,
                                   atol=1e-6)
    assert tinfo["final_loss"] == pytest.approx(info["final_loss"], rel=1e-4)
    # the initial parameters were copied, not trained in place
    assert torch.equal(init.w1, torch.from_numpy(_np(JA.lenet_init(kp).w1)))


def test_lenet_train_learns_on_its_own_data():
    p, info = TA.lenet_train(1, steps=60, device="cpu")
    assert info["final_loss"] < 1.0
    assert TA.lenet_accuracy(p, 1, n=256, device="cpu") > 0.6


def _hd_ref(monkeypatch, key=KEY, n=1024, D=256):
    kp, kd = jax.random.split(key)
    want = JA.hd_train(key, n=n, D=D)
    x, y = JA.make_faces(kd, n)
    monkeypatch.setattr(TA, "_hd_projection",
                        lambda seed, dim, D_: torch.from_numpy(_np(want.proj)))
    monkeypatch.setattr(TA, "make_faces", lambda seed, n_, dim=256,
                        device=None: (torch.from_numpy(_np(x)),
                                      torch.from_numpy(_np(y)).long()))
    return want


def test_hd_train_prototypes_equal(monkeypatch):
    want = _hd_ref(monkeypatch)
    got = TA.hd_train(0, n=1024, D=256, device="cpu")
    np.testing.assert_array_equal(got.prototypes.numpy(),
                                  _np(want.prototypes))
    assert got.prototypes.dtype == torch.int8


@pytest.mark.parametrize("flip_prob", [0.0, 0.05, 0.3])
def test_hd_accuracy_with_replayed_flips_equal(monkeypatch, flip_prob):
    model = JA.hd_train(KEY, n=1024, D=256)
    n = 512
    x, y = JA.make_faces(jax.random.fold_in(KEY, 123), n)
    want = JA.hd_accuracy(model, KEY, n=n, flip_prob=flip_prob)
    monkeypatch.setattr(TA, "make_faces", lambda seed, n_, dim=256,
                        device=None: (torch.from_numpy(_np(x)),
                                      torch.from_numpy(_np(y)).long()))
    flips = lambda shape: torch.from_numpy(_np(jax.random.bernoulli(
        jax.random.fold_in(KEY, 5), flip_prob, shape)))
    tm = TA.hd_model_from_reference(
        {"proj": _np(model.proj), "prototypes": _np(model.prototypes)},
        device="cpu")
    assert TA.hd_accuracy(tm, 0, n=n, flip_prob=flip_prob, flips=flips,
                          device="cpu") == want


def test_hd_seeded_path_and_flip_prob():
    model = TA.hd_train(2, n=1024, D=256, device="cpu")
    clean = TA.hd_accuracy(model, 2, n=512, device="cpu")
    assert clean > 0.9
    noisy = TA.hd_accuracy(model, 2, n=512, flip_prob=0.45, device="cpu")
    assert noisy < clean
    for probs in (np.zeros(32), PROBS, np.full(32, 0.5)):
        assert TA.hd_flip_prob(probs) == JA.hd_flip_prob(probs)
        np.testing.assert_array_equal(TA.scale_bit_probs(probs),
                                      JA.scale_bit_probs(probs))


def test_entry_points_need_a_card_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: TA.make_digits(0, 4), lambda: TA.lenet_init(0),
                 lambda: TA.make_faces(0, 4), lambda: TA.hd_train(0, n=8),
                 lambda: OM.make_int8_error_matmul(np.zeros(32), 0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
