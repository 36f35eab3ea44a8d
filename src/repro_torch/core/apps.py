"""Error-tolerant demo applications for voltage over-scaling (paper §III-D).

The port of ``repro.core.apps``:

- a LeNet-style CNN mapped as a systolic-array accelerator (im2col matmuls
  with int8 quantisation and 32-bit accumulators), trained on a
  deterministic synthetic digit set (no external data);
- an HD (hyperdimensional) 2-class classifier (face / non-face analogue)
  with random-projection binary encoding and Hamming associative memory.

Inference consumes the per-bit flip profile from ``core/overscaling`` via
the error-injected int8 matmul (``kernels/overscale_matmul``, the CUDA
kernel on the card): requantisation after each layer clips corrupted
accumulators as the fixed-point hardware would.

Randomness: the reference draws from ``jax.random`` keys, which PyTorch
cannot reproduce. Here every stream is a ``torch.Generator`` seeded from an
integer seed and a fixed stream number (``fold_in``'s counterpart); data
and parameters are drawn on the CPU and moved to the device, the
error-injection planes and the HD flips are drawn on the device. Weights
and data can be carried over from the reference
(``lenet_params_from_reference``, ``hd_model_from_reference``) and the
planes and flips replayed through hooks, so tests run both packages on
identical inputs.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core.netlist import BenchStats
from repro_torch.kernels import overscale_matmul as om

# FPGA-mapped incarnations of the two apps (for the power side of Fig. 8)
LENET_STATS = BenchStats("lenet_systolic", 14200, 32, 72, 120.0, "mixed")
HD_STATS = BenchStats("hd_encoder", 21800, 16, 0, 140.0, "routing")

# error-model sensitization factor: a violating carry path produces a wrong
# capture only under the sensitizing data pattern (long carry propagation)
SENSITIZE = 0.0017

TEMPLATE_SEED = 20190415  # class templates are the TASK
FACE_SEED = 20190416


def scale_bit_probs(bit_probs: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(bit_probs) * SENSITIZE, 0.0, 1.0)


def derive_seed(seed: int, stream: int) -> int:
    """A child seed of ``seed`` for one numbered stream (below 2^63)."""
    s = np.random.SeedSequence([int(seed), int(stream)]).generate_state(
        2, np.uint32)
    return (int(s[0]) << 31) | (int(s[1]) >> 1)


def _cpu_gen(seed: int) -> torch.Generator:
    g = torch.Generator()
    g.manual_seed(int(seed))
    return g


# =============================================================================
# synthetic digits
# =============================================================================

@functools.lru_cache(maxsize=8)
def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 weights of ``jax.image.resize(..., "cubic")``
    along one axis: Keys' cubic with a = -0.5, half-pixel centres, taps
    outside the input dropped and the rest renormalised (not
    ``F.interpolate``'s bicubic, which uses a = -0.75)."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)  # antialias when downsampling
    s = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(s[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    w = np.where(x < 1.0, ((1.5 * x - 2.5) * x) * x + 1.0,
                 ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0)
    w = np.where(x >= 2.0, 0.0, w)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    w = np.where(((s >= -0.5) & (s <= n_in - 0.5))[None, :], w, 0.0)
    return w.T.astype(np.float32)


@functools.lru_cache(maxsize=4)
def _templates(img: int) -> torch.Tensor:
    base = torch.randn((10, 8, 8), generator=_cpu_gen(TEMPLATE_SEED))
    R = torch.from_numpy(resize_matrix(8, img))
    base = torch.einsum("ij,cjk,lk->cil", R, base, R)
    return (base - base.mean()) / (base.std(correction=0) + 1e-6)


def make_digits(seed: int, n: int, img: int = 16, device=None):
    """Deterministic parametric digit-ish dataset: class templates + jitter.
    -> x (n, img, img, 1) float32, labels (n,) int64 on ``device``."""
    dev = resolve_device(device)
    g = _cpu_gen(seed)
    base = _templates(img)
    labels = torch.randint(0, 10, (n,), generator=g)
    shifts = torch.randint(-3, 4, (n, 2), generator=g)
    noise = 0.9 * torch.randn((n, img, img), generator=g)
    # jnp.roll(t, s): out[i] = t[(i - s) mod img], along rows then columns
    ar = torch.arange(img)
    rows = (ar[None, :] - shifts[:, :1]) % img
    cols = (ar[None, :] - shifts[:, 1:]) % img
    t = torch.gather(base[labels], 1, rows[:, :, None].expand(-1, -1, img))
    t = torch.gather(t, 2, cols[:, None, :].expand(-1, img, -1))
    x = t + noise
    return x[..., None].to(dev), labels.to(dev)


# =============================================================================
# LeNet-mini (conv-pool-conv-pool-fc) — float training, int8 inference
# =============================================================================

@dataclass
class LeNetParams:
    w1: torch.Tensor  # (3,3,1,8)
    w2: torch.Tensor  # (3,3,8,16)
    w3: torch.Tensor  # (256,10)


def lenet_init(seed: int, device=None) -> LeNetParams:
    dev = resolve_device(device)
    g = _cpu_gen(seed)
    return LeNetParams(
        w1=(torch.randn((3, 3, 1, 8), generator=g) * 0.3).to(dev),
        w2=(torch.randn((3, 3, 8, 16), generator=g) * 0.1).to(dev),
        w3=(torch.randn((4 * 4 * 16, 10), generator=g) * 0.05).to(dev),
    )


def lenet_params_from_reference(params: Dict[str, np.ndarray],
                                device=None) -> LeNetParams:
    """The reference's LeNet weights (``w1``, ``w2``, ``w3`` as arrays)."""
    dev = resolve_device(device)
    t = lambda k: torch.as_tensor(np.asarray(params[k], np.float32),
                                  device=dev)
    return LeNetParams(t("w1"), t("w2"), t("w3"))


def _im2col(x: torch.Tensor, k: int = 3) -> torch.Tensor:
    """x:(B,H,W,C) -> (B,H,W,k*k*C) with SAME padding."""
    B, H, W, C = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    cols = [xp[:, i:i + H, j:j + W] for i in range(k) for j in range(k)]
    return torch.cat(cols, dim=-1)


def _pool2(x: torch.Tensor) -> torch.Tensor:
    B, H, W, C = x.shape
    return x.reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))


def lenet_apply(p: LeNetParams, x: torch.Tensor, matmul=None) -> torch.Tensor:
    """matmul(a, b) defaults to float; int/error-injected path for inference."""
    mm = matmul or (lambda a, b: a @ b)
    B = x.shape[0]
    c = _im2col(x)  # (B,16,16,9)
    h = mm(c.reshape(-1, c.shape[-1]), p.w1.reshape(-1, 8)).reshape(
        B, 16, 16, 8)
    h = _pool2(torch.relu(h))  # (B,8,8,8)
    c = _im2col(h)
    h = mm(c.reshape(-1, c.shape[-1]), p.w2.reshape(-1, 16)).reshape(
        B, 8, 8, 16)
    h = _pool2(torch.relu(h))  # (B,4,4,16)
    return mm(h.reshape(B, -1), p.w3)


def lenet_train(seed: int, steps: int = 400, batch: int = 128,
                n_train: int = 4096, device=None,
                init: Optional[LeNetParams] = None,
                batch_indices: Optional[Callable[[int], object]] = None
                ) -> Tuple[LeNetParams, Dict]:
    """Momentum SGD (0.9, lr 0.05) on the cross-entropy of the float model.

    ``init`` replaces the seeded initial parameters and ``batch_indices(i)``
    the seeded batch of step i (a test replays the reference's steps)."""
    dev = resolve_device(device)
    x, y = make_digits(derive_seed(seed, 1), n_train, device=dev)
    p = init if init is not None else lenet_init(derive_seed(seed, 2), dev)
    params = [w.detach().to(dev, torch.float32).clone().requires_grad_(True)
              for w in (p.w1, p.w2, p.w3)]
    mom = [torch.zeros_like(w) for w in params]
    g = _cpu_gen(derive_seed(seed, 3))
    loss = torch.zeros(())
    for i in range(steps):
        idx = (batch_indices(i) if batch_indices is not None
               else torch.randint(0, n_train, (batch,), generator=g))
        idx = torch.as_tensor(idx, dtype=torch.long).to(dev)
        logits = lenet_apply(LeNetParams(*params), x[idx])
        loss = -F.log_softmax(logits, -1)[
            torch.arange(idx.numel(), device=dev), y[idx]].mean()
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for w, m, gr in zip(params, mom, grads):
                m.mul_(0.9).add_(gr)
                w.sub_(0.05 * m)
    return (LeNetParams(*(w.detach() for w in params)),
            {"final_loss": float(loss.detach())})


def lenet_logits(p: LeNetParams, seed: int, n: int = 1024,
                 bit_probs: Optional[np.ndarray] = None, *,
                 use_kernel: bool = True, planes: Optional[om.Planes] = None,
                 device=None):
    """The evaluation set's logits and labels: the float model, or the
    int8 error-injected path under ``bit_probs``."""
    dev = resolve_device(device)
    x, y = make_digits(derive_seed(seed, 999), n, device=dev)
    if bit_probs is None:
        return lenet_apply(p, x), y
    mm = om.make_int8_error_matmul(bit_probs, derive_seed(seed, 7),
                                   use_kernel=use_kernel, planes=planes,
                                   device=dev)
    return lenet_apply(p, x, matmul=mm), y


def lenet_accuracy(p: LeNetParams, seed: int, n: int = 1024,
                   bit_probs: Optional[np.ndarray] = None, *,
                   use_kernel: bool = True,
                   planes: Optional[om.Planes] = None, device=None) -> float:
    logits, y = lenet_logits(p, seed, n, bit_probs, use_kernel=use_kernel,
                             planes=planes, device=device)
    return float((logits.argmax(-1) == y).to(torch.float32).mean())


# =============================================================================
# HD classifier
# =============================================================================

def make_faces(seed: int, n: int, dim: int = 256, device=None):
    """2-class gaussian-cluster analogue of the Caltech face/non-face task."""
    dev = resolve_device(device)
    g = _cpu_gen(seed)
    mu = torch.randn((2, dim), generator=_cpu_gen(FACE_SEED)) * 0.34
    y = torch.randint(0, 2, (n,), generator=g)
    x = mu[y] + torch.randn((n, dim), generator=g)
    return x.to(dev), y.to(dev)


@dataclass
class HDModel:
    proj: torch.Tensor  # (dim, D) random +-1
    prototypes: torch.Tensor  # (2, D) binary int8


def hd_model_from_reference(model: Dict[str, np.ndarray],
                            device=None) -> HDModel:
    """The reference's HD model (``proj``, ``prototypes`` as arrays)."""
    dev = resolve_device(device)
    return HDModel(
        torch.as_tensor(np.asarray(model["proj"], np.float32), device=dev),
        torch.as_tensor(np.asarray(model["prototypes"], np.int8),
                        device=dev))


def hd_encode(proj: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (x @ proj > 0).to(torch.int8)  # (n, D) in {0,1}


def _hd_projection(seed: int, dim: int, D: int) -> torch.Tensor:
    return torch.sign(torch.randn((dim, D), generator=_cpu_gen(seed)))


def hd_train(seed: int, n: int = 4096, dim: int = 256, D: int = 1024,
             device=None) -> HDModel:
    dev = resolve_device(device)
    proj = _hd_projection(derive_seed(seed, 1), dim, D).to(dev)
    x, y = make_faces(derive_seed(seed, 2), n, dim, device=dev)
    h = hd_encode(proj, x)
    protos = []
    for c in range(2):
        bundle = torch.where((y == c)[:, None], h, 0).sum(0, dtype=torch.int64)
        cnt = (y == c).sum()
        protos.append((bundle > cnt / 2).to(torch.int8))
    return HDModel(proj, torch.stack(protos))


def hd_accuracy(model: HDModel, seed: int, n: int = 2048,
                flip_prob: float = 0.0, *,
                flips: Optional[Callable[[Tuple[int, ...]], torch.Tensor]]
                = None, device=None) -> float:
    """Hamming-nearest-prototype accuracy with each hypervector bit flipped
    with ``flip_prob`` (a Bernoulli mask from a generator on the device;
    ``flips(shape)`` replaces it)."""
    dev = resolve_device(device)
    x, y = make_faces(derive_seed(seed, 123), n, device=dev)
    h = hd_encode(model.proj, x)
    if flip_prob > 0:
        if flips is None:
            g = torch.Generator(device=dev)
            g.manual_seed(derive_seed(seed, 5))
            mask = torch.rand(h.shape, generator=g, device=dev) < flip_prob
        else:
            mask = flips(tuple(h.shape)).to(dev)
        h = torch.where(mask, 1 - h, h)
    dist = (h[:, None, :] != model.prototypes[None]).sum(-1)
    return float((dist.argmin(-1) == y).to(torch.float32).mean())


def hd_flip_prob(bit_probs: np.ndarray) -> float:
    """Hypervector-bit flip prob: a bit flips when its sign-accumulator's
    high bits are corrupted; the D-wide reduction exposes ~10x more captures
    per output bit than a single MAC."""
    return float(np.clip(10.0 * scale_bit_probs(bit_probs)[-12:].sum(),
                         0.0, 0.5))
