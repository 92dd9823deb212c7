"""Training loop: gradient-based camera-image optimization.

The reference's entire reason for having a hand-written backward is that
the **camera image is the differentiable input** — its autograd wrapper
returns a gradient only for the camera (reference:
custma/stereo_matching_wrapper.py:33), enabling optimization of the
camera image against a cost-volume objective (exercised with an all-ones
cotangent in examples/verify.py:67-68).  The reference ships no actual
training loop; this module supplies the real thing: optimize camera
frames so the *differentiable* (soft-argmax) disparity matches a target
disparity map — the structured-light inverse-rendering task the op was
built for.

Works single-device and mesh-sharded: the loss is a global mean, so under
``(data, space)`` sharding XLA inserts the final psum; everything else
(including the analytic VJP and the transposed halo exchange) stays
on-shard.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh

from custereomatching_tpu.models.stereo import StereoMatcher


class TrainState(NamedTuple):
    """Optimization state: the camera frames are the parameters."""

    camera: jax.Array          # [B, H, W] — the differentiable input
    opt_state: optax.OptState
    step: jax.Array            # scalar int32


class StepMetrics(NamedTuple):
    loss: jax.Array
    grad_norm: jax.Array


def init_state(camera: jax.Array,
               optimizer: optax.GradientTransformation) -> TrainState:
    """Create a :class:`TrainState` from initial camera frames."""
    return TrainState(camera=camera, opt_state=optimizer.init(camera),
                      step=jnp.zeros((), jnp.int32))


def disparity_loss(model: StereoMatcher, camera: jax.Array,
                   projector: jax.Array, target_disparity: jax.Array,
                   mesh: Optional[Mesh] = None) -> jax.Array:
    """Mean-squared error of the soft disparity against a target map."""
    if mesh is None:
        cv = model.cost_volume(camera, projector)
    else:
        cv = model.sharded_cost_volume(camera, projector, mesh)
    d = model.disparity(cv)
    err = d.soft_disparity - target_disparity
    return jnp.mean(err * err)


def make_train_step(model: StereoMatcher,
                    optimizer: optax.GradientTransformation,
                    mesh: Optional[Mesh] = None):
    """Build a jitted train step ``(state, projector, target) -> (state, metrics)``.

    With ``mesh`` given, the cost volume runs through the shard_map path
    (halo exchange over the ``space`` axis); pass arrays already placed
    with :func:`..parallel.sharded.shard_batch` so jit does not reshard.
    """

    def step(state: TrainState, projector: jax.Array,
             target_disparity: jax.Array) -> Tuple[TrainState, StepMetrics]:
        loss, grads = jax.value_and_grad(disparity_loss, argnums=1)(
            model, state.camera, projector, target_disparity, mesh)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.camera)
        camera = optax.apply_updates(state.camera, updates)
        new_state = TrainState(camera=camera, opt_state=opt_state,
                               step=state.step + 1)
        metrics = StepMetrics(loss=loss,
                              grad_norm=jnp.sqrt(jnp.sum(grads * grads)))
        return new_state, metrics

    return jax.jit(step)


def optimize_camera(model: StereoMatcher, camera0: jax.Array,
                    projector: jax.Array, target_disparity: jax.Array,
                    *, learning_rate: float = 1e-2, num_steps: int = 100,
                    mesh: Optional[Mesh] = None
                    ) -> Tuple[jax.Array, jax.Array]:
    """Convenience loop: run ``num_steps`` of Adam, return (camera, losses)."""
    optimizer = optax.adam(learning_rate)
    state = init_state(camera0, optimizer)
    step_fn = make_train_step(model, optimizer, mesh)
    losses = []
    for _ in range(num_steps):
        state, metrics = step_fn(state, projector, target_disparity)
        losses.append(metrics.loss)
    return state.camera, jnp.stack(losses)
