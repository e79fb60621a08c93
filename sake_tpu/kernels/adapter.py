"""Adapter: linen parameter trees -> functional ``ModelParams`` pytrees."""

from __future__ import annotations

import jax.numpy as jnp

from sake_tpu.kernels.functional import CFConvParams, LayerParams, ModelParams


def _mlp(tree, i):
    return tree[f"dense_{i}"]["kernel"], tree[f"dense_{i}"].get("bias")


def layer_params_from_linen(lp) -> LayerParams:
    """Convert one ``DenseSAKELayer`` linen param subtree."""
    edge = lp["edge_model"]
    cf = CFConvParams(
        w_in=edge["mlp_in"]["kernel"],
        b_in=edge["mlp_in"]["bias"],
        rbf_means=edge["kernel"]["means"],
        rbf_betas=edge["kernel"]["betas"],
        w_out0=edge["mlp_out"]["dense_0"]["kernel"],
        b_out0=edge["mlp_out"]["dense_0"]["bias"],
        w_out1=edge["mlp_out"]["dense_1"]["kernel"],
        b_out1=edge["mlp_out"]["dense_1"]["bias"],
    )
    has_update = "v_mixing" in lp
    hidden = cf.w_out1.shape[-1]
    n_coeff = lp["x_mixing"]["kernel"].shape[-1]
    f_out = lp["node_mlp"]["dense_1"]["kernel"].shape[-1]
    zeros = jnp.zeros
    return LayerParams(
        edge=cf,
        w_sem=lp["semantic_mlp"]["kernel"],
        b_sem=lp["semantic_mlp"]["bias"],
        w_xmix=lp["x_mixing"]["kernel"],
        w_post0=lp["post_norm_mlp"]["dense_0"]["kernel"],
        b_post0=lp["post_norm_mlp"]["dense_0"]["bias"],
        w_post1=lp["post_norm_mlp"]["dense_1"]["kernel"],
        b_post1=lp["post_norm_mlp"]["dense_1"]["bias"],
        w_node0=lp["node_mlp"]["dense_0"]["kernel"],
        b_node0=lp["node_mlp"]["dense_0"]["bias"],
        w_node1=lp["node_mlp"]["dense_1"]["kernel"],
        b_node1=lp["node_mlp"]["dense_1"]["bias"],
        w_vmix=lp["v_mixing"]["kernel"] if has_update else zeros((n_coeff, 1)),
        w_vel0=(
            lp["velocity_mlp_hidden"]["kernel"]
            if "velocity_mlp_hidden" in lp
            else zeros((f_out, hidden))
        ),
        b_vel0=(
            lp["velocity_mlp_hidden"]["bias"]
            if "velocity_mlp_hidden" in lp
            else zeros((hidden,))
        ),
        w_vel1=(
            lp["velocity_mlp_out"]["kernel"]
            if "velocity_mlp_out" in lp
            else zeros((hidden, 1))
        ),
    )


def model_params_from_linen(params) -> ModelParams:
    """Convert a ``SAKEModel`` linen param tree (``{"params": {...}}`` or
    the inner dict) to the functional pytree."""
    tree = params.get("params", params)
    n_layers = sum(1 for k in tree if k.startswith("layer_"))
    layers = tuple(
        layer_params_from_linen(tree[f"layer_{i}"]) for i in range(n_layers)
    )
    return ModelParams(
        w_embed=tree["embedding_in"]["kernel"],
        b_embed=tree["embedding_in"]["bias"],
        layers=layers,
        w_out0=tree["embedding_out"]["dense_0"]["kernel"],
        b_out0=tree["embedding_out"]["dense_0"]["bias"],
        w_out1=tree["embedding_out"]["dense_1"]["kernel"],
        b_out1=tree["embedding_out"]["dense_1"]["bias"],
    )
