"""Stateless counter-based RNG for sample streams.

Replacement for the reference's SIMD Mersenne Twister
(include/mitsuba/core/random.h:88) and per-pixel Sampler state
(include/mitsuba/render/sampler.h:66-153): instead of mutable per-core RNG
objects, every sample is a *pure function* of (seed, pixel index, sample
index, dimension). This makes renders deterministic, replayable (the analog
of the reference's ReplayableSampler, bidir/rsampler.h:38), and trivially
shardable — any device can produce any pixel's samples with no state.

Core hash: PCG-style uint32 mixing (pcg3d/pcg4d family) — cheap integer
ops, no threefry tables.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_U32 = jnp.uint32


def _mix32(x: jax.Array) -> jax.Array:
    """splitmix32-style finalizer on uint32."""
    x = x.astype(_U32)
    x = (x ^ (x >> 16)) * _U32(0x7FEB352D)
    x = (x ^ (x >> 15)) * _U32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def hash_u32(*parts) -> jax.Array:
    """Combine integer arrays into one well-mixed uint32 array."""
    acc = _U32(0x9E3779B9)
    for p in parts:
        acc = _mix32(jnp.asarray(p).astype(_U32) + acc * _U32(0x85EBCA6B) + _U32(0xC2B2AE35))
    return acc


def u32_to_uniform(bits: jax.Array) -> jax.Array:
    """uint32 -> float32 in [0, 1)."""
    # Use the top 24 bits so the float is exactly representable.
    return (bits >> 8).astype(jnp.float32) * jnp.float32(1.0 / 16777216.0)


def uniform(seed, pixel, sample, dim) -> jax.Array:
    """One uniform float per element of the broadcasted index arrays."""
    return u32_to_uniform(hash_u32(seed, pixel, sample, dim))


class SampleStream:
    """Functional per-ray sample stream.

    Mirrors Sampler::next1D/next2D (render/sampler.h:105-121) but with a
    dimension counter advanced *statically at trace time* — each call burns
    fixed dims, so the whole render compiles to pure hashing with no state.

    `kind` selects the sampler family (samplers/qmc.py:
    independent/stratified/halton/(0,2)-LD — the plugin set of
    src/samplers/); `spp` is needed by stratified.
    """

    __slots__ = ("seed", "pixel", "sample", "dim", "kind", "spp")

    def __init__(self, seed, pixel, sample, dim: int = 0, kind: int = 0,
                 spp: int = 0):
        self.seed = seed
        self.pixel = pixel
        self.sample = sample
        self.dim = dim
        self.kind = kind
        self.spp = spp

    def at_dim(self, dim):
        """Sample a specific dimension (dim may be traced, e.g. a bounce
        counter; QMC kinds require static dims and fall back to hashing
        for traced ones)."""
        if self.kind == 0 or not isinstance(dim, int):
            return uniform(self.seed, self.pixel, self.sample, dim)
        from ..samplers import qmc

        return qmc.sample_dim(self.kind, self.seed, self.pixel, self.sample,
                              dim, self.spp)

    def next_1d(self):
        u = self.at_dim(self.dim)
        self.dim = self.dim + 1
        return u

    def next_2d(self):
        return jnp.stack([self.next_1d(), self.next_1d()], axis=-1)

    def fork(self, salt: int) -> "SampleStream":
        """Independent stream (e.g. per-bounce NEE) at a salted offset."""
        return SampleStream(
            hash_u32(self.seed, jnp.uint32(0xA511E9B3 + salt)),
            self.pixel,
            self.sample,
            0,
            kind=self.kind,
            spp=self.spp,
        )
