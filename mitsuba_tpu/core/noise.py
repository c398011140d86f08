"""Procedural noise (include/mitsuba/render/noise.h — pbrt-derived
Perlin noise and its fBm/turbulence combinators).

Redesign: the reference's 256-entry shuffled permutation table
(noise.cpp NoisePerm) drives lattice hashing; here the lattice hash is
the framework's counter-based hash_u32 (core/rng.py) — the same
avalanche quality with zero table gathers, which is the expensive
operation on this hardware. Gradients are Ken Perlin's improved-noise
12-vector set selected from hash bits. Values are in [-1, 1] and, like
all Perlin noise, zero at lattice points."""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .rng import hash_u32


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _grad(h, x, y, z):
    """Improved-noise gradient: pick one of 12 edge vectors from the
    hash's low 4 bits (Perlin 2002, noise.cpp Grad)."""
    h = h & 15
    u = jnp.where(h < 8, x, y)
    v = jnp.where(h < 4, y, jnp.where((h == 12) | (h == 14), x, z))
    return (jnp.where(h & 1 == 0, u, -u)
            + jnp.where(h & 2 == 0, v, -v))


def _lattice(ix, iy, iz):
    return hash_u32(ix.astype(jnp.uint32), iy.astype(jnp.uint32),
                    iz.astype(jnp.uint32)).astype(jnp.int32)


def perlin_noise(p: jax.Array) -> jax.Array:
    """Perlin gradient noise at points p (..., 3) -> (...) in [-1, 1]
    (Noise::perlinNoise, noise.h:39)."""
    p = jnp.asarray(p, jnp.float32)
    pi = jnp.floor(p)
    pf = p - pi
    ix = pi[..., 0].astype(jnp.int32)
    iy = pi[..., 1].astype(jnp.int32)
    iz = pi[..., 2].astype(jnp.int32)
    x, y, z = pf[..., 0], pf[..., 1], pf[..., 2]
    u, v, w = _fade(x), _fade(y), _fade(z)

    def corner(dx, dy, dz):
        h = _lattice(ix + dx, iy + dy, iz + dz)
        return _grad(h, x - dx, y - dy, z - dz)

    n000 = corner(0, 0, 0)
    n100 = corner(1, 0, 0)
    n010 = corner(0, 1, 0)
    n110 = corner(1, 1, 0)
    n001 = corner(0, 0, 1)
    n101 = corner(1, 0, 1)
    n011 = corner(0, 1, 1)
    n111 = corner(1, 1, 1)
    nx00 = n000 + u * (n100 - n000)
    nx10 = n010 + u * (n110 - n010)
    nx01 = n001 + u * (n101 - n001)
    nx11 = n011 + u * (n111 - n011)
    nxy0 = nx00 + v * (nx10 - nx00)
    nxy1 = nx01 + v * (nx11 - nx01)
    return nxy0 + w * (nxy1 - nxy0)


def perlin_noise_1d(x: jax.Array) -> jax.Array:
    """1D slice perlinNoise(Point(x, 0, 0)) — the irawan.cpp:267 use."""
    x = jnp.asarray(x, jnp.float32)
    return perlin_noise(jnp.stack(
        [x, jnp.zeros_like(x), jnp.zeros_like(x)], -1))


def fbm(p: jax.Array, omega: float = 0.5, octaves: int = 6) -> jax.Array:
    """Fractional Brownian motion: sum of perlin octaves
    (Noise::fbm, noise.h:43)."""
    total = jnp.zeros(p.shape[:-1])
    lam, o = 1.0, 1.0
    for _ in range(octaves):
        total = total + o * perlin_noise(p * lam)
        lam *= 1.99
        o *= omega
    return total


def turbulence(p: jax.Array, omega: float = 0.5,
               octaves: int = 6) -> jax.Array:
    """Sum of |perlin| octaves (Noise::turbulence)."""
    total = jnp.zeros(p.shape[:-1])
    lam, o = 1.0, 1.0
    for _ in range(octaves):
        total = total + o * jnp.abs(perlin_noise(p * lam))
        lam *= 1.99
        o *= omega
    return total
