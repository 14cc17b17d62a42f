"""Inverse rendering: recover scene parameters from a target image.

BASELINE.json config 4: "optimize sphere positions + albedos from target
image via pixel-gradient descent".  The loss is L2 on the LINEAR mean
radiance image (before gamma/quantization — sqrt and u8 cast are not usefully
differentiable), rendered with a fixed seed so the objective is
deterministic.

Gradients flow through the wavefront renderer by plain reverse-mode AD: the
hit-selection argmin and material masks are piecewise-constant (the gradient
follows the selected branch — correct almost everywhere; visibility-boundary
terms are ignored, the standard differentiable-ray-tracing baseline), while
t(center, radius), hit positions, normals and shading are smooth.  Guarded
sqrt/div in intersect.py keep cotangents NaN-free.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import jax
import numpy as np
import jax.numpy as jnp
import optax

from .. import render as render_mod
from ..camera import Camera
from ..scene import Scene
from ..utils import checkpoint as ckpt_mod
from .params import apply_params


def image_loss(rendered_linear, target_linear):
    """Mean squared error over pixels/channels."""
    diff = rendered_linear - target_linear
    return jnp.mean(diff * diff)


def make_loss_fn(scene: Scene, camera: Camera, target_linear, *,
                 width: int, height: int, samples_per_pixel: int, depth: int,
                 seed: int = 0, mesh=None, parity_plane_sign: bool = True,
                 engine: str = "xla", interpret: bool = False) -> Callable:
    """loss(params) -> scalar.  With ``mesh``, rendering (and therefore the
    backward pass, including the automatic gradient psum) is sharded.

    engine "pallas" renders through the fused kernel via its custom VJP
    (ops/diff.render_linear_diff): kernel forward, XLA recompute backward;
    with ``mesh`` the same path runs per device under shard_map
    (render_linear_diff_sharded).  engine "xla" is plain AD through the
    wavefront renderer.

    engine "auto" resolves to plain AD: the kernel has no backward of its
    own, its VJP recomputes the forward on XLA, so a gradient through it
    costs at least what plain AD costs (on the H100 it measured equal or
    slower, and compiled twice as long; PERF.md).
    """
    from ..ops import diff as diff_mod
    if engine == "auto":
        engine = "xla"
    elif engine == "pallas":
        from .. import ops as ops_mod
        ops_mod.resolve_dispatch(scene, parity_plane_sign, engine,
                                 interpret=interpret)
    # static cluster topology for the kernel forward (bounds recomputed
    # traceably from live vertices every call — sound under optimization);
    # only valid with the corrected plane equation
    tri_cull = (diff_mod.build_tri_cull(scene)
                if engine == "pallas" and not parity_plane_sign else None)

    def loss(params):
        s = apply_params(scene, params)
        if mesh is not None and engine == "pallas":
            from ..parallel.sharding import render_linear_diff_sharded
            img = render_linear_diff_sharded(
                s, camera, mesh=mesh, width=width, height=height,
                samples_per_pixel=samples_per_pixel, depth=depth,
                seed=seed, parity_plane_sign=parity_plane_sign,
                interpret=interpret, tri_cull=tri_cull)
        elif mesh is None and engine == "pallas":
            img = diff_mod.render_linear_diff(s, camera, diff_mod.make_statics(
                width=width, height=height,
                samples_per_pixel=samples_per_pixel, depth=depth, seed=seed,
                parity_plane_sign=parity_plane_sign, interpret=interpret,
                tri_cull=tri_cull))
        elif mesh is None:
            img, _ = render_mod.render_linear(
                s, camera, width=width, height=height,
                samples_per_pixel=samples_per_pixel, depth=depth,
                parity_plane_sign=parity_plane_sign, seed=seed)
        else:
            from ..parallel.sharding import render_linear_sharded
            img, _ = render_linear_sharded(
                s, camera, mesh=mesh, width=width, height=height,
                samples_per_pixel=samples_per_pixel, depth=depth,
                parity_plane_sign=parity_plane_sign, seed=seed)
        return image_loss(img, target_linear)

    return loss


def make_train_step(loss_fn: Callable, optimizer: optax.GradientTransformation):
    """One jitted optimizer step: (params, opt_state) -> (params', opt_state',
    loss)."""

    @jax.jit
    def step(params, opt_state):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def make_silhouette_train_step(scene: Scene, camera: Camera, target,
                               optimizer: optax.GradientTransformation, *,
                               width: int, height: int,
                               samples_per_pixel: int, depth: int,
                               parity_plane_sign: bool = True,
                               seed: int = 0, n_edge: int = 512,
                               samples_per_edge: int = 16,
                               max_edges: int | None = None):
    """Train step whose gradients include the visibility-boundary terms
    (grad/silhouette.py) — optimization can move a silhouette across the
    image instead of stalling where interior gradients vanish."""
    from .silhouette import MAX_EDGE_SAMPLES, value_and_grad_with_silhouette
    me = MAX_EDGE_SAMPLES if max_edges is None else max_edges

    def step(params, opt_state):
        loss, grads = value_and_grad_with_silhouette(
            scene, camera, target, params, width=width, height=height,
            samples_per_pixel=samples_per_pixel, depth=depth,
            parity_plane_sign=parity_plane_sign, seed=seed,
            n_edge=n_edge, samples_per_edge=samples_per_edge,
            max_edges=me)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


@dataclasses.dataclass
class FitResult:
    params: Dict[str, jax.Array]
    losses: List[float]
    steps_run: int


def fit(scene: Scene, camera: Camera, target_linear, params_init,
        *, width: int, height: int, samples_per_pixel: int = 4,
        depth: int = 4, steps: int = 200, learning_rate: float = 1e-2,
        seed: int = 0, mesh=None, optimizer=None, silhouette: bool = False,
        checkpoint_path: Optional[str] = None, checkpoint_every: int = 50,
        resume: bool = True, log_every: int = 0) -> FitResult:
    """Adam descent on the pixel loss, with optional npz checkpoint/resume.
    The renderer is ``make_loss_fn``'s ``engine="auto"`` choice.

    ``silhouette=True`` adds the visibility-boundary gradient terms
    (grad/silhouette.py) so geometry can be pulled across its own
    silhouette (single-device only).

    Checkpointing is new-framework scope (the reference renders
    all-or-nothing, SURVEY.md §5 'Checkpoint / resume: None').
    """
    optimizer = optimizer or optax.adam(learning_rate)
    if silhouette:
        assert mesh is None, "silhouette fit is single-device"
        step_fn = make_silhouette_train_step(
            scene, camera, target_linear, optimizer, width=width,
            height=height, samples_per_pixel=samples_per_pixel,
            depth=depth, seed=seed)
    else:
        loss_fn = make_loss_fn(
            scene, camera, target_linear, width=width, height=height,
            samples_per_pixel=samples_per_pixel, depth=depth, seed=seed,
            mesh=mesh, engine="auto")
        step_fn = make_train_step(loss_fn, optimizer)

    params = params_init
    opt_state = optimizer.init(params)
    start_step = 0
    losses: List[float] = []

    if checkpoint_path and resume:
        restored = ckpt_mod.load_latest(checkpoint_path)
        if restored is not None:
            p_u, o_u, start_step, losses = restored
            params = jax.tree.map(jnp.asarray, p_u.rebuild(params))
            opt_state = jax.tree.map(jnp.asarray, o_u.rebuild(opt_state))

    for i in range(start_step, steps):
        params, opt_state, loss = step_fn(params, opt_state)
        losses.append(float(loss))
        if log_every and (i % log_every == 0):
            print(f"[fit] step {i} loss {float(loss):.6e}")
        if checkpoint_path and checkpoint_every and \
                ((i + 1) % checkpoint_every == 0 or i + 1 == steps):
            ckpt_mod.save(checkpoint_path, params, opt_state, i + 1, losses)

    return FitResult(params=params, losses=losses, steps_run=steps - start_step)
