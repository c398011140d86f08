"""mitsuba_tpu — a differentiable Monte Carlo renderer in JAX.

Built from scratch in JAX/XLA with the capabilities of classic
Mitsuba 0.6 (reference: Potato256/my-mitsuba); see SURVEY.md for the
component map. The compute path is wavefront ray batches of array work;
the scene is a flattened differentiable pytree (scene/ir.py) replacing the
reference's C++ plugin graph.
"""

__version__ = "0.1.0"

from .scene import ir  # noqa: F401
