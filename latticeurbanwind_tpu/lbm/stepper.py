"""Step-function dispatch: the jnp tier (XLA) or the fused GPU kernel.

`make_runner` builds the step for the current backend and wraps it in a
jitted multi-step loop.  Both tiers keep one field contract: the step takes
an `LBMState` and returns one whose `rho` and `u` are current.
"""

from __future__ import annotations

import jax

from .reference import make_step as make_reference_step
from .state import Forcing, StepConfig


def kernel_available(config: StepConfig) -> bool:
    """True when the fused kernel can step `config` on this backend."""
    from ..ops.stream_collide import kernel_reject_reason

    return (jax.default_backend() == "gpu"
            and kernel_reject_reason(config) is None)


def select_impl(config: StepConfig, impl: str = "auto") -> str:
    """Resolve `impl` ("auto" | "reference" | "pallas") to the tier stepped.

    "auto" takes the kernel on a GPU for every configuration it supports
    and the jnp tier otherwise (CPU, thermal).  "pallas" refuses to run
    anywhere the kernel cannot, instead of quietly stepping another tier."""
    if impl == "reference":
        return "reference"
    if impl == "pallas":
        from ..ops.stream_collide import kernel_reject_reason

        if jax.default_backend() != "gpu":
            raise ValueError("impl='pallas' needs a GPU backend, found "
                             f"{jax.default_backend()!r}")
        reason = kernel_reject_reason(config)
        if reason is not None:
            raise ValueError(f"impl='pallas': {reason}")
        return "pallas"
    if impl != "auto":
        raise ValueError(f"unknown impl {impl!r}")
    return "pallas" if kernel_available(config) else "reference"


def make_step_fn(config: StepConfig, forcing: Forcing, impl_name: str):
    """The single-step function of the resolved tier."""
    if impl_name == "pallas":
        from ..ops.stream_collide import make_pallas_step

        return make_pallas_step(config, forcing)
    return make_reference_step(config, forcing)


def make_runner(config: StepConfig, forcing: Forcing = Forcing(), *,
                n_inner: int = 1, impl: str = "auto", donate: bool = True,
                pre_step=None):
    """Jitted `run(state, dyn, t0[, n_steps]) -> state` advancing n_steps
    (default n_inner) steps from global step index t0.

    Returns (runner, impl_name).  `pre_step(state, t) -> state` runs before
    each step inside the loop (the VK inlet presets the face velocities the
    step reads).

    The step loop is a `lax.fori_loop` with a TRACED trip count: one
    compilation serves every chunk length the run driver's irregular event
    schedule produces.  The spatial forcing fields are traced arguments, not
    closure constants, so they are not serialized into the program.
    """
    import jax.numpy as jnp

    impl_name = select_impl(config, impl)
    nudge_vertical = forcing.nudge_vertical
    fields = (forcing.nudge_sigma, forcing.nudge_face, forcing.sponge_sigma_z)

    def body(state, dyn, t0, n_steps, fields):
        nsig, nface, spz = fields
        step = make_step_fn(config, Forcing(
            nudge_sigma=nsig, nudge_face=nface, nudge_vertical=nudge_vertical,
            sponge_sigma_z=spz), impl_name)

        def one(i, st):
            if pre_step is not None:
                st = pre_step(st, t0 + i)
            return step(st, dyn)

        return jax.lax.fori_loop(0, n_steps, one, state)

    jitted = jax.jit(body, donate_argnums=(0,) if donate else ())

    def args(state, dyn, t0, n_steps):
        return (state, dyn, jnp.asarray(t0, jnp.int32),
                jnp.asarray(n_inner if n_steps is None else n_steps,
                            jnp.int32), fields)

    def run(state, dyn, t0, n_steps=None):
        return jitted(*args(state, dyn, t0, n_steps))

    def memory_analysis(state, dyn, t0, n_steps=None):
        """XLA memory analysis of the loop executable for these inputs (AOT:
        compiles without executing): `.temp_size_in_bytes` is the program's
        transient peak on top of its (donated) arguments and outputs."""
        return jitted.lower(*args(state, dyn, t0, n_steps)).compile() \
            .memory_analysis()

    run.memory_analysis = memory_analysis
    return run, impl_name

