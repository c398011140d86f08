"""Sampler family: independent, stratified, Halton, (0,2) low-discrepancy.

Analog of the reference's sampler plugins
(src/samplers/{independent,stratified,halton,hammersley,ldsampler,sobol}.cpp
and the QMC primitives in include/mitsuba/core/qmc.h:43-119). Every sampler
here is a *pure function* of (seed, pixel, sample-index, dimension) — no
mutable per-pixel state, so any device can evaluate any sample (the
property that makes rendering embarrassingly shardable, and the analog of
the reference registering per-core sampler clones, renderjob.cpp:60-66).

Decorrelation across pixels uses hash-based scrambling:
  * stratified: stratum = sample index, jitter = independent hash.
  * Halton: per-(pixel, dim) Cranley-Patterson rotation of the radical
    inverse — equivalent quality to the reference's per-pixel offsets.
  * LD: the (0,2)-sequence (van der Corput paired with Sobol' dim-2) with
    per-(pixel, dim-pair) Owen-style XOR scrambling — the ldsampler.cpp
    counterpart, excellent for the first bounce dimensions.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.rng import hash_u32, u32_to_uniform

SAMPLER_INDEPENDENT = 0
SAMPLER_STRATIFIED = 1
SAMPLER_HALTON = 2
SAMPLER_LD = 3
SAMPLER_HAMMERSLEY = 4
SAMPLER_SOBOL = 5
SAMPLER_FAURE = 6

_U32 = jnp.uint32

# First 64 primes for Halton dimensions (qmc.h primeBase analog).
_PRIMES = np.array([
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67,
    71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137, 139, 149,
    151, 157, 163, 167, 173, 179, 181, 191, 193, 197, 199, 211, 223, 227,
    229, 233, 239, 241, 251, 257, 263, 269, 271, 277, 281, 283, 293, 307, 311,
], dtype=np.uint32)


def radical_inverse_base2(n: jax.Array) -> jax.Array:
    """Bit-reversed base-2 radical inverse (qmc.h:43 radicalInverse2Single).

    n: uint32 -> float32 in [0,1)."""
    n = n.astype(_U32)
    n = ((n << 16) | (n >> 16)) & _U32(0xFFFFFFFF)
    n = ((n & _U32(0x00FF00FF)) << 8) | ((n & _U32(0xFF00FF00)) >> 8)
    n = ((n & _U32(0x0F0F0F0F)) << 4) | ((n & _U32(0xF0F0F0F0)) >> 4)
    n = ((n & _U32(0x33333333)) << 2) | ((n & _U32(0xCCCCCCCC)) >> 2)
    n = ((n & _U32(0x55555555)) << 1) | ((n & _U32(0xAAAAAAAA)) >> 1)
    return u32_to_uniform(n)


def sobol2(n: jax.Array, scramble: jax.Array) -> jax.Array:
    """Second dimension of the Sobol' (0,2)-sequence with XOR scrambling
    (the ldsampler.cpp sample02 pairing)."""
    n = n.astype(_U32)
    v = jnp.full_like(n, 1 << 31)
    res = scramble.astype(_U32)

    def body(i, carry):
        n_c, v_c, res_c = carry
        res_c = jnp.where((n_c & 1) == 1, res_c ^ v_c, res_c)
        v_c = v_c ^ (v_c >> 1)
        n_c = n_c >> 1
        return n_c, v_c, res_c

    _, _, res = jax.lax.fori_loop(0, 32, body, (n, v, res))
    return u32_to_uniform(res)


def van_der_corput(n: jax.Array, scramble: jax.Array) -> jax.Array:
    """Base-2 VDC with XOR scrambling (first dim of the (0,2) pair)."""
    n = n.astype(_U32)
    n = ((n << 16) | (n >> 16)) & _U32(0xFFFFFFFF)
    n = ((n & _U32(0x00FF00FF)) << 8) | ((n & _U32(0xFF00FF00)) >> 8)
    n = ((n & _U32(0x0F0F0F0F)) << 4) | ((n & _U32(0xF0F0F0F0)) >> 4)
    n = ((n & _U32(0x33333333)) << 2) | ((n & _U32(0xCCCCCCCC)) >> 2)
    n = ((n & _U32(0x55555555)) << 1) | ((n & _U32(0xAAAAAAAA)) >> 1)
    return u32_to_uniform(n ^ scramble.astype(_U32))


def radical_inverse(base: jax.Array, n: jax.Array) -> jax.Array:
    """General radical inverse (qmc.h radicalInverse). base: uint32 scalar or
    array; n: uint32 array. Fixed 20-digit unroll covers n < base^20."""
    base_f = base.astype(jnp.float32)
    inv_base = 1.0 / base_f

    def body(i, carry):
        n_c, inv, value = carry
        digit = (n_c % base).astype(jnp.float32)
        value = value + digit * inv
        return n_c // base, inv * inv_base, value

    n0 = n.astype(_U32)
    _, _, value = jax.lax.fori_loop(
        0, 20, body, (n0, jnp.broadcast_to(inv_base, n0.shape),
                      jnp.zeros(n0.shape, jnp.float32))
    )
    return jnp.minimum(value, 1.0 - 1e-7)


def sample_dim(kind: int, seed, pixel, sample, dim, spp: int = 0) -> jax.Array:
    """One uniform sample for `dim` of the given sampler family.

    kind and dim are static ints when called from integrators (each bounce
    consumes a fixed dimension window); pixel/sample are uint32 arrays.
    """
    if kind == SAMPLER_INDEPENDENT:
        return u32_to_uniform(hash_u32(seed, pixel, sample, dim))

    if kind == SAMPLER_STRATIFIED:
        # 1D strata over spp samples + hashed jitter (stratified.cpp).
        spp = max(spp, 1)
        jitter = u32_to_uniform(hash_u32(seed, pixel, sample, dim))
        return ((sample.astype(jnp.float32) % spp) + jitter) / spp

    if kind == SAMPLER_HALTON:
        # Global Halton index = sample; per-(pixel, dim) CP rotation.
        d = int(dim) % len(_PRIMES)
        base = jnp.uint32(_PRIMES[d])
        v = radical_inverse(base, sample)
        rot = u32_to_uniform(hash_u32(seed, pixel, jnp.uint32(0x9E37), dim))
        return jnp.mod(v + rot, 1.0)

    if kind == SAMPLER_LD:
        # Pair dims: even -> VDC, odd -> Sobol2, shared scramble per pair.
        pair = dim // 2
        scramble = hash_u32(seed, pixel, jnp.uint32(0x51D), pair)
        if dim % 2 == 0:
            return van_der_corput(sample, scramble)
        return sobol2(sample, scramble)

    if kind == SAMPLER_HAMMERSLEY:
        # hammersley.cpp: dim 0 is the equispaced i/N axis, the rest follow
        # the Halton construction (with per-pixel CP rotation).
        spp = max(spp, 1)
        rot = u32_to_uniform(hash_u32(seed, pixel, jnp.uint32(0x9E37), dim))
        if dim == 0:
            v = (sample.astype(jnp.float32) % spp) / spp
        else:
            d = int(dim - 1) % len(_PRIMES)
            v = radical_inverse(jnp.uint32(_PRIMES[d]), sample)
        return jnp.mod(v + rot, 1.0)

    if kind == SAMPLER_SOBOL:
        # High-dimensional Sobol' (sobol.cpp + sobolseq.cpp analog): the
        # direction-number row for this (static) dimension is baked into
        # the program as a constant; per-(pixel, dim) Owen-style XOR
        # scrambling decorrelates pixels.
        from . import sobol as sobollib

        row = jnp.asarray(
            sobollib.direction_numbers()[int(dim) % sobollib.SOBOL_DIMS])
        scramble = hash_u32(seed, pixel, jnp.uint32(0x50B01), dim)
        n0 = sample.astype(_U32)

        def body(i, carry):
            n_c, res_c = carry
            res_c = jnp.where((n_c & _U32(1)) == 1, res_c ^ row[i], res_c)
            return n_c >> 1, res_c

        _, res = jax.lax.fori_loop(0, 32, body,
                                   (n0, scramble.astype(_U32)))
        return u32_to_uniform(res)

    if kind == SAMPLER_FAURE:
        # Generalized Faure: Pascal-matrix digit scrambling in a prime
        # base >= ndims (16 here), + per-(pixel, dim) CP rotation.
        from . import sobol as sobollib

        b, mats = sobollib.faure_tables(16)
        c = jnp.asarray(mats[int(dim) % 16].T, jnp.float32)  # (D, D)
        n0 = sample.astype(jnp.int32)
        ds = []
        for _ in range(16):
            ds.append((n0 % b).astype(jnp.float32))
            n0 = n0 // b
        digits = jnp.stack(ds, -1)                            # (N, D)
        y = jnp.mod(jnp.matmul(digits, c, precision=jax.lax.Precision.HIGHEST),
                    float(b))                     # (N, D)
        w = (1.0 / b) ** jnp.arange(1, 17, dtype=jnp.float32)
        v = jnp.minimum(jnp.matmul(y, w, precision=jax.lax.Precision.HIGHEST),
                        1.0 - 1e-7)
        rot = u32_to_uniform(hash_u32(seed, pixel, jnp.uint32(0xFA4E), dim))
        return jnp.mod(v + rot, 1.0)

    raise ValueError(f"unknown sampler kind {kind}")
