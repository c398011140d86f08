"""The in-repo pytree dataclass (mitsuba_tpu/core/struct.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest

from mitsuba_tpu.core import struct


@struct.dataclass
class _Box:
    lo: jax.Array
    hi: jax.Array = None
    n: int = struct.field(pytree_node=False, default=3)
    tag: tuple = struct.field(pytree_node=False, default=())


def test_flatten_keeps_statics_out_of_the_leaves():
    b = _Box(lo=jnp.zeros(2), hi=jnp.ones(2), n=5, tag=("a",))
    leaves, treedef = jax.tree_util.tree_flatten(b)
    assert len(leaves) == 2
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.n == 5 and back.tag == ("a",)
    # a None child is an empty subtree, not a leaf
    assert len(jax.tree_util.tree_leaves(_Box(lo=jnp.zeros(2)))) == 1


def test_statics_are_part_of_the_jit_cache_key():
    traces = []

    @jax.jit
    def f(b):
        traces.append(b.n)
        return b.lo * b.n

    assert float(f(_Box(lo=jnp.ones(()), n=2))) == 2.0
    assert float(f(_Box(lo=jnp.ones(()) * 3.0, n=2))) == 6.0
    assert float(f(_Box(lo=jnp.ones(()), n=4))) == 4.0
    assert traces == [2, 4]


def test_replace_and_frozen():
    b = _Box(lo=jnp.zeros(2))
    c = b.replace(n=7, hi=jnp.ones(2))
    assert b.n == 3 and b.hi is None
    assert c.n == 7 and c.hi.shape == (2,)
    with pytest.raises(dataclasses.FrozenInstanceError):
        b.n = 1


def test_grad_flows_through_children_only():
    b = _Box(lo=jnp.asarray(2.0), hi=jnp.asarray(3.0), n=4)
    g = jax.grad(lambda b: b.lo * b.hi * b.n)(b)
    assert float(g.lo) == 12.0 and float(g.hi) == 8.0 and g.n == 4
