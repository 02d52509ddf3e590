"""Counter-based random streams, bit-exact with the reference's jax.random.

Port of `skirt9_tpu/ops/rng.py`. Every draw is a pure function of
(seed, history index, event counter, purpose tag), folded into threefry-2x32
keys exactly as `jax.random.fold_in` does, and uniforms are built from the
random bits exactly as `jax.random.uniform` builds them (jax 0.9 with
`jax_threefry_partitionable=True`, impl `threefry2x32`, x64 off). So a port
run consumes the same random numbers as the reference, draw for draw.

`gauss` draws `jax.random.normal`'s normals bit for bit: XLA's erf_inv,
log1p and fused multiply-adds replayed in IEEE operations
(`ops/xlamath.py`).

Keys are raw uint32 pairs held in int64 tensors of shape (..., 2), masked to
32 bits after every operation that could carry past them; the same code runs
on the CPU and on CUDA. (Many small elementwise launches per draw on the
GPU: a fused kernel is later work.)
"""

from __future__ import annotations

import math

import torch

from . import xlamath

# purpose tags (identical to the reference)
LAUNCH_WAVELENGTH = 1
LAUNCH_POSITION = 2
LAUNCH_DIRECTION = 3
PATH_TAU = 4
SCATTER_ANGLE = 5
SCATTER_COMPONENT = 6
ROULETTE = 7
LAUNCH_SOURCE = 8
SCATTER_AZIMUTH = 9
LAUNCH_CELL = 10
EMISSION_LAMBDA = 11
LAUNCH_TIME = 12
LAUNCH_FAMILY_CORNER = 13

LAUNCH_EVENT = 1_000_003

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry-2x32 hash (20 rounds) of counters (x1, x2) under key
    (k1, k2); all uint32 values in int64 tensors, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def seed_key(seed: int, device) -> torch.Tensor:
    """The raw key of `jax.random.PRNGKey(seed)`: (2,) int64."""
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK], dtype=torch.int64,
                        device=device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in` over a batch of keys (..., 2); `data` is an int or
    an integer tensor broadcastable against keys[..., 0]."""
    k1, k2 = keys[..., 0], keys[..., 1]
    if isinstance(data, torch.Tensor):
        x2 = data.to(torch.int64) & _MASK
    else:
        x2 = torch.full_like(k1, int(data) & _MASK)
    x1 = torch.zeros_like(x2)
    y1, y2 = threefry2x32(k1, k2, x1, x2)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def history_keys(seed_key: torch.Tensor, history: torch.Tensor) -> torch.Tensor:
    """Per-packet base keys (B, 2) from a run key (2,) and history indices."""
    return fold_in(seed_key.expand(history.shape[0], 2), history)


def event_keys(hkeys: torch.Tensor, event) -> torch.Tensor:
    """Fold the event counter (an int or a per-lane (B,) tensor) into keys."""
    return fold_in(hkeys, event)


def purpose_key(keys: torch.Tensor, tag: int) -> torch.Tensor:
    return fold_in(keys, tag)


def bits_to_unit_exact(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> float32 in [0, 1) as jax.random.uniform builds it."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) \
        - 1.0


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """bits_to_unit_exact with exact zero replaced by the smallest normal
    (the reference's rule for its one-per-key uniforms)."""
    return torch.clamp_min(bits_to_unit_exact(bits), _TINY)


def draw(keys: torch.Tensor, count: int) -> torch.Tensor:
    """32 random bits of element `count` of a 1-D draw under each key."""
    k1, k2 = keys[..., 0], keys[..., 1]
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(k1),
                          torch.full_like(k1, count))
    return y1 ^ y2


def uniform(keys: torch.Tensor, tag: int) -> torch.Tensor:
    """One uniform in (0, 1) per key."""
    return _bits_to_unit(draw(purpose_key(keys, tag), 0))


def uniforms(keys: torch.Tensor, tags) -> torch.Tensor:
    """`uniform(keys, tag)` for several tags at once: (len(tags), B), in one
    pass of hashes instead of one per tag (same bits). tags: ints, or an
    int64 tensor of them on the keys' device, which a caller that draws
    many times builds once so that drawing copies nothing from the host."""
    if not torch.is_tensor(tags):
        tags = torch.tensor(list(tags), dtype=torch.int64, device=keys.device)
    pk = fold_in(keys.unsqueeze(0), tags.unsqueeze(1))
    return _bits_to_unit(draw(pk, 0))


def uniform2(keys: torch.Tensor, tag: int):
    """Two independent uniforms per key (elements 0 and 1 of one draw)."""
    pk = purpose_key(keys, tag)
    return _bits_to_unit(draw(pk, 0)), _bits_to_unit(draw(pk, 1))


def uniform_vec(keys: torch.Tensor, tag: int, n: int) -> torch.Tensor:
    """`jax.random.uniform(k, (n,))` under each purpose key: (B, n) in
    [0, 1), exact zeros kept (no smallest-normal floor)."""
    pk = purpose_key(keys, tag)
    return bits_to_unit_exact(torch.stack([draw(pk, i) for i in range(n)],
                                          dim=-1))


_SQRT2 = xlamath.f32(math.sqrt(2.0))
_NORMAL_LO = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))


def gauss(keys: torch.Tensor, tag: int) -> torch.Tensor:
    """One standard normal per key, as `jax.random.normal(k, ())` draws it
    under the purpose key: a uniform on [nextafter(-1, 0), 1) from the same
    bits (u * (hi - lo) + lo, floored at lo), then sqrt(2) erf_inv(u)."""
    f = bits_to_unit_exact(draw(purpose_key(keys, tag), 0))
    # hi - lo rounds to 2 in f32
    u = torch.clamp_min(f * 2.0 + _NORMAL_LO, _NORMAL_LO)
    return _SQRT2 * xlamath.erf_inv(u)


def expon(keys: torch.Tensor, tag: int) -> torch.Tensor:
    """Exponential with unit scale: tau = -ln(1-u)."""
    return -torch.log1p(-uniform(keys, tag))


def expon_cutoff_from_uniform(u: torch.Tensor, taumax: torch.Tensor):
    """Inverse cdf of e^-t / (1-e^-taumax) on [0, taumax] at uniform u."""
    return -torch.log1p(u * torch.expm1(-taumax))


def expon_cutoff(keys: torch.Tensor, tag: int, taumax: torch.Tensor):
    """Exponential conditioned on tau < taumax."""
    return expon_cutoff_from_uniform(uniform(keys, tag), taumax)


def isotropic_direction(keys: torch.Tensor, tag: int) -> torch.Tensor:
    """Uniform directions on the unit sphere, (B, 3): cos t = 2u - 1, phi =
    2 pi v, formed as the reference's jitted code forms them: 1 - cos^2 t
    one fused multiply-add (rounded apart inside `xlamath.eager()`, the
    reference's op-by-op set-up draws), its correctly rounded square root,
    glibc's cosf and sinf of phi (`xlamath.sincos`) and one product each."""
    u, v = uniform2(keys, tag)
    cost = 2.0 * u - 1.0
    sint = xlamath.sqrt(torch.clamp_min(xlamath.fma(-cost, cost, 1.0), 0.0))
    s, c = xlamath.sincos(xlamath.f32(2.0 * math.pi) * v)
    return torch.stack([sint * c, sint * s, cost], dim=-1)
