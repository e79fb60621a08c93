"""Equivariant normalizing flows built on the SAKE model.

Two constructions (reference: ``sake/flows.py``):

- ``AugmentedFlow*`` — RealNVP-style coupling between positions ``x`` and
  augmented velocities ``v``; the conditioner is a SAKE model run with a
  ghost node so per-graph statistics are available, producing a mean-free
  equivariant translation and a tanh-bounded per-graph log-scale. Exact
  log-determinants.
- ``ODEFlow`` — a continuous normalizing flow whose dynamics is
  ``model(t, x).x - x``, with the log-density change estimated by a
  Hutchinson trace via ``jax.vjp`` and integrated by an adaptive
  Dormand-Prince ``odeint`` inside XLA.

Base density: ``CenteredGaussian`` on the translation-quotient subspace
(``(N-1)*D`` degrees of freedom).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from flax import linen as nn
from jax.experimental.ode import odeint

from sake_tpu.models import SAKEModel

# (0, 1) integration span; built lazily so importing this module never
# initializes a device backend.
T_SPAN = (0.0, 1.0)


class CenteredGaussian:
    """Mean-free isotropic Gaussian on the translation-quotient subspace.

    ``log_prob`` uses ``dof = (N-1)*D`` as the normalizing dimension;
    ``sample`` projects out the center of mass
    (reference: ``sake/flows.py:12-27``).
    """

    @staticmethod
    def log_prob(value: jax.Array) -> jax.Array:
        n, d = value.shape[-2], value.shape[-1]
        dof = (n - 1) * d
        r2 = (value**2).reshape(*value.shape[:-2], -1).sum(-1)
        return -0.5 * r2 - 0.5 * dof * math.log(2.0 * math.pi)

    @staticmethod
    def sample(key: jax.Array, shape) -> jax.Array:
        x = jax.random.normal(key=key, shape=shape)
        return x - x.mean(axis=-2, keepdims=True)


class ODEFlow:
    """Continuous normalizing flow driven by an equivariant model.

    Dynamics ``f(x, t) = model(t·1, x).x - x`` (time broadcast as the node
    feature, ``sake/flows.py:32-35``); log-det by a Hutchinson trace
    estimator with a Gaussian probe through ``jax.vjp``
    (``flows.py:57-65``); integrated over t in (0, 1) at rtol=atol=1e-2
    (``flows.py:85-91``). Exact-Jacobian variants provided for testing.
    """

    @staticmethod
    def dynamics(model, params, x, t):
        t = jnp.ones((*x.shape[:-1], 1)) * t
        _, y, _ = model.apply(params, t, x)
        return y - x

    @staticmethod
    def jacobian(fn, x, t):
        """TEST/DIAGNOSTIC helper (reference ``sake/flows.py:38-46``):
        per-sample exact Jacobian of the dynamics, ``x (B, N, D)`` ->
        ``(B, N, D, N, D)``. Not part of the training path — the flow
        uses the Hutchinson ``trace`` estimator."""
        return jax.vmap(lambda xi: jax.jacrev(fn)(xi, t))(x)

    @staticmethod
    def trace(fn, x, t, probe):
        """Hutchinson trace estimate with a Gaussian ``probe`` array (the
        reference drew it from one fixed key, so the probe is constant
        along the trajectory — sampled once in ``call``)."""
        y, vjp_fun = jax.vjp(lambda x_: fn(x_, t), x)
        return (vjp_fun(probe)[0] * probe).sum(axis=(-1, -2))

    @staticmethod
    def exact_logdet(fn, x):
        """TEST/DIAGNOSTIC helper: exact ``slogdet`` of a flow-map
        Jacobian laid out as ``(..., N, D, N, D)`` (the shape
        ``jacobian`` above produces per sample). Cross-checks the
        Hutchinson estimator in tests; O((N*D)^3) — never used in
        training."""
        res = fn(x)
        dof = res.shape[-1] * res.shape[-2]
        res = res.reshape(*res.shape[:-4], dof, dof)
        _, logdet = jnp.linalg.slogdet(res)
        return logdet

    @staticmethod
    def dynamics_and_trace(model):
        """Joint (dx/dt, dlogdet/dt) field in ``odeint``'s ``*args`` form.

        ``params`` and the trace probe are threaded as explicit odeint
        arguments (NOT closed over): ``jax.experimental.ode.odeint``
        differentiates only through its ``*args``, and traced closures
        break its custom VJP — exactly what training (grad w.r.t. params
        under jit) needs. The integer PRNG key cannot be an odeint arg
        (``float0`` cotangent), so the Gaussian probe is pre-sampled.
        """

        def fn(state, t, params, probe):
            x, _ = state
            dyn = partial(ODEFlow.dynamics, model, params)
            return dyn(x, t), ODEFlow.trace(dyn, x, t, probe)

        return fn

    @staticmethod
    def call(model, params, x, key):
        trace0 = jnp.zeros(shape=x.shape[:-2])
        _, subkey = jax.random.split(key)
        probe = jax.random.normal(subkey, x.shape)
        fn = ODEFlow.dynamics_and_trace(model)
        y, logdet = odeint(
            fn, (x, trace0), jnp.array(T_SPAN), params, probe,
            rtol=1e-2, atol=1e-2,
        )
        return y[-1], logdet[-1]

    @staticmethod
    def nll(model, params, x, key):
        """Negative log-likelihood: push x through the flow, score under the
        centered Gaussian, correct by the trace integral
        (the loss of ``scripts/dw4/run.py:36-41``)."""
        z, logdet = ODEFlow.call(model, params, x, key)
        return -(CenteredGaussian.log_prob(z) + logdet).mean()


class AugmentedFlowLayer(nn.Module):
    """One coupling layer: transforms ``v`` conditioned on ``(h, x)``.

    The conditioner ``mp``: append ``|x|^2`` to node features, append a ghost
    node of zeros (so the model's masked-mean sees N+1 nodes and per-graph
    information can route through it), run a SAKE model, strip the ghost,
    return a mean-free translation and a tanh-bounded per-graph scale
    (reference: ``sake/flows.py:97-144``).
    """

    hidden_features: int = 64
    depth: int = 3
    activation: Callable = nn.silu

    def setup(self):
        self.conditioner = SAKEModel(
            hidden_features=self.hidden_features,
            depth=self.depth,
            out_features=1,
            activation=self.activation,
            name="conditioner",
        )
        self.scale_dense_in = nn.Dense(self.hidden_features, name="scale_dense_in")
        self.scale_dense_out = nn.Dense(1, use_bias=False, name="scale_dense_out")

    def mp(self, h, x):
        x0 = x
        h = jnp.concatenate([h, (x**2).sum(-1, keepdims=True)], axis=-1)
        ghost_h = jnp.zeros_like(h[..., :1, :])
        ghost_x = jnp.zeros_like(x[..., :1, :])
        h = jnp.concatenate([h, ghost_h], axis=-2)
        x = jnp.concatenate([x, ghost_x], axis=-2)
        h, x, _ = self.conditioner(h, x)
        h, x = h[..., :-1, :], x[..., :-1, :]
        translation = x - x0
        translation = translation - translation.mean(axis=-2, keepdims=True)
        scale = jnp.tanh(
            self.scale_dense_out(self.activation(self.scale_dense_in(h)))
        ).mean(axis=-2, keepdims=True)
        return scale, translation

    def f_forward(self, h, x, v):
        scale, translation = self.mp(h, x)
        v = jnp.exp(scale) * v + translation
        log_det = scale.sum((-1, -2)) * v.shape[-1] * v.shape[-2]
        return x, v, log_det

    def f_backward(self, h, x, v):
        scale, translation = self.mp(h, x)
        v = jnp.exp(-scale) * (v - translation)
        log_det = scale.sum((-1, -2)) * v.shape[-1] * v.shape[-2]
        return x, v, log_det

    def __call__(self, h, x, v):
        return self.f_forward(h, x, v)


class AugmentedFlowModel(nn.Module):
    """Stack of alternating coupling layers, scanned on-device.

    Capability parity with the reference's ``depth`` pairs of (x->v, v->x)
    couplings (``sake/flows.py:146-188``), restructured for XLA: the
    reference (and our round-1 port) unrolled ``2*depth`` separately traced
    conditioner models per direction — compile time linear in depth. Here
    the ``2*depth`` coupling layers share ONE traced conditioner
    (``nn.scan`` over a parameter stack with a leading coupling axis), and
    every step is the uniform move "transform ``b`` conditioned on ``a``,
    then swap roles" — after an even number of steps the (x, v) roles are
    restored. ``f_backward`` runs the same scan with ``reverse=True``
    (flax slices the stacked parameters in reversed order), making the two
    exact inverses.

    Parameter layout: ``couplings/...`` leaves carry a leading ``2*depth``
    axis in *forward application order* ``[xv_{D-1}, vx_{D-1}, ...,
    xv_0, vx_0]`` (see ``compat.convert_reference_params`` for loading
    reference checkpoints into this layout).
    """

    depth: int = 3
    mp_depth: int = 3
    hidden_features: int = 64
    activation: Callable = nn.silu

    @nn.compact
    def _coupling_step(self, carry, h, inverse):
        """One coupling move on carry ``(a, b, sum_log_det)``: transform
        ``b`` conditioned on ``a`` (forward affine or its inverse, selected
        by the traced ``inverse`` flag — ``mp`` is shared), then swap."""
        a, b, sum_log_det = carry
        layer = AugmentedFlowLayer(
            self.hidden_features, self.mp_depth, self.activation,
            name="couplings",
        )
        scale, translation = layer.mp(h, a)
        b_fwd = jnp.exp(scale) * b + translation
        b_bwd = jnp.exp(-scale) * (b - translation)
        b = jnp.where(inverse, b_bwd, b_fwd)
        log_det = scale.sum((-1, -2)) * b.shape[-1] * b.shape[-2]
        return (b, a, sum_log_det + log_det), None

    def _scan(self, h, a, b, inverse, reverse):
        scan = nn.scan(
            AugmentedFlowModel._coupling_step,
            variable_axes={"params": 0},
            split_rngs={"params": True},
            in_axes=nn.broadcast,
            length=2 * self.depth,
            reverse=reverse,
        )
        ld0 = jnp.zeros(a.shape[:-2], a.dtype)
        (a, b, sum_log_det), _ = scan(self, (a, b, ld0), h, inverse)
        return a, b, sum_log_det

    def f_forward(self, h, x, v):
        return self._scan(h, x, v, jnp.asarray(False), reverse=False)

    def f_backward(self, h, x, v):
        # first move transforms x conditioned on v (the reference's
        # ``vx.f_backward(h, v, x)``), so the carry starts role-swapped;
        # 2*depth swaps restore (x, v) order on exit.
        v, x, sum_log_det = self._scan(h, v, x, jnp.asarray(True), reverse=True)
        return x, v, sum_log_det

    def __call__(self, h, x, v):
        return self.f_forward(h, x, v)

    def nll(self, h, x, key):
        """Augmented NLL: sample centered-Gaussian velocities, invert the
        flow, score both outputs under the base density
        (the loss of ``scripts/dw4_aug/run.py:39-43``)."""
        v = CenteredGaussian.sample(key, x.shape)
        z_x, z_v, log_det = self.f_backward(h, x, v)
        return (
            -CenteredGaussian.log_prob(z_x)
            - CenteredGaussian.log_prob(z_v)
            + log_det
        ).mean()
