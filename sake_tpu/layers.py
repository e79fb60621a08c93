"""SAKE message-passing layers and EGNN baselines.

The dense SAKE layer combines three attention mechanisms over the all-pairs
edge grid — semantic (learned, per-head), euclidean (distance envelope), and
spatial (direction-weighted coefficient mixing) — with an optional learned
velocity/position update, making a depth-``D`` stack a ``D``-step learned
integrator.

Behavioral contract follows the reference ``sake/layers.py``; structure does
not. The same math as a pure function of a parameter pytree is
``sake_tpu.kernels.functional`` (the path the energy/force tasks run);
this module is the linen front end and the bridge to the upstream
library's parameter trees.

Shape conventions: ``h (..., N, F)``, ``x (..., N, 3)``, ``v (..., N, 3)``,
node ``mask (..., N)`` -> edge ``mask (..., N, N)``; axis ``-2`` of edge
tensors (the sender axis ``j``) is normalized/reduced over.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from flax import linen as nn

from sake_tpu import geometry
from sake_tpu.blocks import MLP, ContinuousFilterConv, double_sigmoid


class DenseSAKELayer(nn.Module):
    """Dense (all-pairs) SAKE layer.

    Reference behavior: ``sake/layers.py:42-235``. Config flags:

    - ``update``: apply the velocity/position update (``layers.py:218-232``).
    - ``use_spatial_attention``: if False, spatial-attention outputs are
      zeroed (``layers.py:210-212``).
    - ``use_semantic_attention`` / ``use_euclidean_attention``: in the
      reference these only control whether ``log_gamma`` is a learned
      parameter (``layers.py:97-105``) — the dense forward ignores them.
      Replicated exactly for parity; ``euclidean_attention`` (the
      ``log_gamma``-decay softmax the reference only wired into its sparse
      layer, ``layers.py:310-324``) is provided as a method here.
    - ``cutoff``: optional distance envelope multiplied into the combined
      attention (``layers.py:172-175``).
    """

    out_features: int
    hidden_features: int
    activation: Callable = jax.nn.silu
    n_heads: int = 4
    update: bool = True
    use_semantic_attention: bool = True
    use_euclidean_attention: bool = True
    use_spatial_attention: bool = True
    cutoff: Optional[Callable] = None

    def setup(self):
        h = self.hidden_features
        self.n_coefficients = self.n_heads * h
        self.edge_model = ContinuousFilterConv(h, name="edge_model")
        self.node_mlp = MLP((h, self.out_features), self.activation, name="node_mlp")
        self.post_norm_mlp = MLP((h, h), self.activation, name="post_norm_mlp")
        self.semantic_mlp = nn.Dense(self.n_heads, name="semantic_mlp")
        self.x_mixing_dense = nn.Dense(
            self.n_coefficients, use_bias=False, name="x_mixing"
        )
        if self.update:
            self.velocity_mlp_hidden = nn.Dense(h, name="velocity_mlp_hidden")
            self.velocity_mlp_out = nn.Dense(
                1, use_bias=False, name="velocity_mlp_out"
            )
            self.v_mixing = nn.Dense(1, use_bias=False, name="v_mixing")
        # Per-head distance decay; a learned parameter only when both
        # semantic and euclidean attention are enabled (sake/layers.py:97-105).
        init = -jnp.log(jnp.linspace(1.0, 5.0, self.n_heads))
        if self.use_semantic_attention and self.use_euclidean_attention:
            self.log_gamma = self.param(
                "log_gamma", nn.initializers.constant(init), (self.n_heads,)
            )
        else:
            self.log_gamma = jnp.ones(self.n_heads)

    # --- attention pieces (independently invocable for mask tests) --------

    def semantic_attention(self, h_e_mtx, mask=None):
        """Per-head learned attention over senders: ``softmax_j`` of
        ``celu_{alpha=2}(Dense_H(edge))`` with self/pad pairs additively
        masked at ``-1e5`` (reference: ``sake/layers.py:153-168``)."""
        logits = nn.celu(self.semantic_mlp(h_e_mtx), alpha=2.0)
        logits = geometry.apply_edge_logit_mask(logits, mask)
        return jax.nn.softmax(logits, axis=-2)

    def euclidean_attention(self, x_minus_xt_norm, mask=None):
        """Distance-decay attention ``softmax_j(-r * exp(log_gamma))`` with
        self/pad distances pushed to ``+1e5`` (the mechanism the reference
        implemented only on its sparse layer, ``sake/layers.py:310-324``;
        provided on the dense layer so the reference's mask tests hold)."""
        n = x_minus_xt_norm.shape[-2]
        r = x_minus_xt_norm + geometry.INF * jnp.eye(n)[..., None]
        if mask is not None:
            r = r + geometry.INF * (1.0 - mask[..., None])
        return jax.nn.softmax(-r * jnp.exp(self.log_gamma), axis=-2)

    def combined_attention(self, x_minus_xt_norm, h_e_mtx, mask=None):
        """Product of the cutoff envelope (if any) and semantic attention,
        pad-masked and renormalized over senders
        (reference: ``sake/layers.py:170-182``)."""
        semantic = self.semantic_attention(h_e_mtx, mask=mask)
        euclidean = self.cutoff(x_minus_xt_norm) if self.cutoff is not None else 1.0
        combined = euclidean * semantic
        if mask is not None:
            combined = combined * mask[..., None]
        denom = combined.sum(axis=-2, keepdims=True)
        if mask is not None:
            # Fully-masked (padded) receiver rows sum to 0; the reference
            # divides 0/0 here and the resulting NaN leaks into *real* atoms
            # after >1 layer (its own test_mask.py::test_dense_sake_model
            # fails because of this). Guarding the zero denominator is a
            # bitwise no-op for rows with any real neighbor.
            denom = jnp.where(denom == 0.0, 1.0, denom)
        combined = combined / denom
        return euclidean, semantic, combined

    def spatial_attention(self, h_e_att, x_minus_xt, x_minus_xt_norm, mask=None):
        """Direction-weighted coefficient field and its node-level invariants.

        Mixes the attended edge features into ``C = heads*hidden`` tanh
        coefficients, scales unit displacements by them to get an equivariant
        ``(..., N, N, C, 3)`` field, mean-pools over senders (masked mean with
        a ``+1e-8`` guard), and maps the squared norms through an MLP to node
        scalars (reference: ``sake/layers.py:108-133``). Returns
        ``(h_combinations, combinations)``; the raw field is reused as the
        velocity candidate set."""
        coefficients = jnp.tanh(self.x_mixing_dense(h_e_att))
        unit = x_minus_xt / (x_minus_xt_norm + 1e-5)
        combinations = unit[..., None, :] * coefficients[..., None]
        if mask is not None:
            m = mask[..., None, None]
            combinations = combinations * m
            combinations_sum = combinations.sum(axis=-3) / (m.sum(axis=-3) + 1e-8)
        else:
            combinations_sum = combinations.mean(axis=-3)
        combinations_norm = (combinations_sum**2).sum(-1)
        return self.post_norm_mlp(combinations_norm), combinations

    def aggregate(self, h_e_mtx, mask=None):
        """Masked sum of edge features over senders
        (reference: ``sake/layers.py:135-140``)."""
        if mask is not None:
            h_e_mtx = h_e_mtx * mask[..., None]
        return h_e_mtx.sum(axis=-2)

    def node_model(self, h, h_e, h_combinations):
        """Residual node update from [self, aggregated edges, spatial
        invariants] (reference: ``sake/layers.py:142-151``)."""
        out = jnp.concatenate([h, h_e, h_combinations], axis=-1)
        return h + self.node_mlp(out)

    def velocity_model(self, v, h):
        """Scalar (0,2)-ranged velocity gate from node features
        (reference: ``sake/layers.py:68-76,184-186``)."""
        gate = double_sigmoid(
            self.velocity_mlp_out(self.activation(self.velocity_mlp_hidden(h)))
        )
        return gate * v

    def _delta_v(self, combinations, mask=None):
        """Mix the C velocity candidates into one vector per node: a learned
        weighted sum over coefficients, averaged over senders
        (reference: ``sake/layers.py:218-223``)."""
        mixed = self.v_mixing(combinations.swapaxes(-1, -2)).swapaxes(-1, -2)
        if mask is not None:
            delta_v = mixed.sum(axis=(-2, -3))
            return delta_v / (mask.sum(-1, keepdims=True) + 1e-10)
        return mixed.mean(axis=(-2, -3))

    def _spatial_pooled(self, h_e_att, x_minus_xt, x_minus_xt_norm, mask=None):
        """Spatial attention + velocity mixing WITHOUT materializing the
        ``(..., N, N, C, 3)`` combination field.

        The reference builds that field explicitly (``sake/layers.py:118``)
        and immediately mean-pools it over senders — at batch 256, N=21,
        C=256 that is a ~350 MB device-memory round trip per layer. Both consumers
        are linear in the field, so the pool is a single einsum contraction
        over the sender axis:

        ``pooled[i, c, d] = sum_j coeff[i, j, c] * unit[i, j, d] / count_i``

        and ``delta_v = sum_c w_c * pooled[:, c, :]`` reuses it. Same math
        as the reference (fp32 reassociation only); parity-tested.

        Returns ``(h_combinations, delta_v)``; ``delta_v`` is None when the
        layer has no update head.
        """
        coefficients = jnp.tanh(self.x_mixing_dense(h_e_att))
        unit = x_minus_xt / (x_minus_xt_norm + 1e-5)
        if mask is not None:
            coefficients = coefficients * mask[..., None]
            count = mask.sum(-1)[..., None, None]  # senders per receiver
        else:
            count = x_minus_xt.shape[-2]
        raw = jnp.einsum("...ijc,...ijd->...icd", coefficients, unit)
        pooled = raw / (count + 1e-8) if mask is not None else raw / count
        h_combinations = self.post_norm_mlp((pooled**2).sum(-1))
        delta_v = None
        if self.update:
            # v_mixing is linear, so mixing the pooled sum equals pooling
            # the mixed field; delta_v keeps the reference's own
            # denominator (+1e-10 vs the pool's +1e-8).
            mixed = self.v_mixing(raw.swapaxes(-1, -2))[..., 0]  # (..., N, 3)
            if mask is not None:
                delta_v = mixed / (mask.sum(-1, keepdims=True) + 1e-10)
            else:
                delta_v = mixed / count
        return h_combinations, delta_v

    def __call__(self, h, x, v=None, mask=None, he=None):
        x_minus_xt = geometry.pairwise_displacement(x)
        x_minus_xt_norm = geometry.pairwise_distance(x_minus_xt)
        h_cat_ht = geometry.edge_concat(h)
        if he is not None:
            h_cat_ht = jnp.concatenate([h_cat_ht, he], axis=-1)

        h_e_mtx = self.edge_model(h_cat_ht, x_minus_xt_norm)
        _, _, combined = self.combined_attention(x_minus_xt_norm, h_e_mtx, mask=mask)
        # Attention-weighted edges, flattened (hidden-major, head-minor) to
        # (..., N, N, hidden*heads) — sake/layers.py:206-207.
        h_e_att = h_e_mtx[..., :, None] * combined[..., None, :]
        h_e_att = h_e_att.reshape(*h_e_att.shape[:-2], -1)

        h_combinations, delta_v = self._spatial_pooled(
            h_e_att, x_minus_xt, x_minus_xt_norm, mask=mask
        )
        if not self.use_spatial_attention:
            h_combinations = jnp.zeros_like(h_combinations)
            delta_v = jnp.zeros_like(x) if delta_v is not None else None

        h_e = self.aggregate(h_e_att, mask=mask)
        h = self.node_model(h, h_e, h_combinations)

        if self.update:
            v = self.velocity_model(v, h) if v is not None else jnp.zeros_like(x)
            v = delta_v + v
            x = x + v

        return h, x, v


class EGNNLayer(nn.Module):
    """E(n)-equivariant GNN baseline layer (raw-edge variant).

    Edge features are the raw ``[h_i, h_j, r_ij]`` concat; aggregation uses an
    optional sigmoid edge gate; the coordinate update is
    ``v <- v * scale(h) + sum_j shift(edge)`` (reference:
    ``sake/layers.py:411-496``)."""

    out_features: int
    hidden_features: int
    activation: Callable = jax.nn.silu
    update: bool = False
    sigmoid: bool = False

    def setup(self):
        h = self.hidden_features
        self.node_mlp = MLP((h, self.out_features), self.activation, name="node_mlp")
        self.scaling_mlp = MLP(
            (h, 1), self.activation, act_last=False, use_bias_last=False,
            name="scaling_mlp",
        )
        self.shifting_mlp = MLP(
            (h, 1), self.activation, act_last=False, use_bias_last=False,
            name="shifting_mlp",
        )
        if self.sigmoid:
            self.edge_gate = nn.Dense(1, use_bias=False, name="edge_gate")

    def _edge_features(self, h, x):
        h_cat_ht = geometry.edge_concat(h)
        dist = geometry.pairwise_distance(geometry.pairwise_displacement(x))
        return jnp.concatenate([h_cat_ht, dist], axis=-1)

    def aggregate(self, h_e_mtx, mask=None):
        if mask is not None:
            h_e_mtx = h_e_mtx * mask[..., None]
        if self.sigmoid:
            h_e_mtx = jax.nn.sigmoid(self.edge_gate(h_e_mtx)) * h_e_mtx
        return h_e_mtx.sum(axis=-2)

    def node_model(self, h, h_e):
        return h + self.node_mlp(jnp.concatenate([h, h_e], axis=-1))

    def __call__(self, h, x, v=None, mask=None):
        h_e_mtx = self._edge_features(h, x)
        h_e = self.aggregate(h_e_mtx, mask=mask)
        shift = self.shifting_mlp(h_e_mtx).sum(-2)
        scale = self.scaling_mlp(h)
        if self.update:
            v = v * scale + shift
            x = x + v
        h = self.node_model(h, h_e)
        return h, x, v


class EGNNSmearedLayer(nn.Module):
    """EGNN baseline with the CFConv/RBF edge model
    (reference: ``sake/layers.py:499-588``). Scaling-MLP bias quirk of the
    reference (scale from *pre-update* h) preserved."""

    out_features: int
    hidden_features: int
    activation: Callable = jax.nn.silu
    update: bool = False
    sigmoid: bool = True

    def setup(self):
        h = self.hidden_features
        self.edge_model = ContinuousFilterConv(h, name="edge_model")
        self.node_mlp = MLP((h, self.out_features), self.activation, name="node_mlp")
        self.scaling_mlp = MLP(
            (h, 1), self.activation, act_last=False, use_bias_last=False,
            name="scaling_mlp",
        )
        self.shifting_mlp = MLP(
            (h, 1), self.activation, act_last=False, use_bias_last=False,
            name="shifting_mlp",
        )
        if self.sigmoid:
            self.edge_gate = nn.Dense(1, use_bias=False, name="edge_gate")

    def aggregate(self, h_e_mtx, mask=None):
        if mask is not None:
            h_e_mtx = h_e_mtx * mask[..., None]
        if self.sigmoid:
            h_e_mtx = jax.nn.sigmoid(self.edge_gate(h_e_mtx)) * h_e_mtx
        return h_e_mtx.sum(axis=-2)

    def node_model(self, h, h_e):
        return h + self.node_mlp(jnp.concatenate([h, h_e], axis=-1))

    def __call__(self, h, x, v=None, mask=None):
        dist = geometry.pairwise_distance(geometry.pairwise_displacement(x))
        h_e_mtx = self.edge_model(geometry.edge_concat(h), dist)
        h_e = self.aggregate(h_e_mtx, mask=mask)
        shift = self.shifting_mlp(h_e_mtx).sum(-2)
        scale = self.scaling_mlp(h)
        if self.update:
            v = v * scale + shift
            x = x + v
        h = self.node_model(h, h_e)
        return h, x, v
