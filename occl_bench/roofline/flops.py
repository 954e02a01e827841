"""Model FLOPs of one step, counted from shapes (no recomputation).

A matrix product of [m, k] by [k, n] counts 2*m*k*n.  A training step
counts three times its forward products (the backward pass takes two per
forward product); norms, softmax and element-wise work are left out.
"""


def vit_layer_forward(tokens: int, d_model: int, d_ff: int) -> int:
    """One encoder layer on one sample: q, k, v and output projections,
    the score and value products over all heads, the two MLP products."""
    T, D, F = tokens, d_model, d_ff
    proj = 2 * T * D * (3 * D) + 2 * T * D * D
    attn = 2 * T * T * D + 2 * T * T * D
    mlp = 2 * T * D * F + 2 * T * F * D
    return proj + attn + mlp


def vit_forward(cfg: dict) -> int:
    """One sample through the patch projection, the layers and the class
    head (over the published classes, not the padded ones)."""
    T, D = cfg["num_patches"], cfg["hidden_size"]
    patch = 2 * T * D * D
    layers = cfg["num_hidden_layers"] * vit_layer_forward(
        T, D, cfg["intermediate_size"])
    head = 2 * D * cfg["num_labels"]
    return patch + layers + head


def vit_train_step(cfg: dict) -> int:
    """Forward and backward over the global batch of a data-parallel step."""
    return 3 * cfg["deployment"]["global_batch"] * vit_forward(cfg)


def moe_forward(cfg: dict) -> int:
    """One MoE layer's forward over every rank's tokens: the router, each
    token's ``num_experts_per_tok`` routed SwiGLU experts and the shared
    experts (three products of ``hidden_size`` by the expert width each)."""
    dep = cfg["deployment"]
    T = dep["ep_ranks"] * dep["tokens_per_rank"]
    D, Fe = cfg["hidden_size"], cfg["moe_intermediate_size"]
    router = 2 * T * D * cfg["n_routed_experts"]
    routed = T * cfg["num_experts_per_tok"] * 3 * 2 * D * Fe
    shared = T * 3 * 2 * D * (cfg["n_shared_experts"] * Fe)
    return router + routed + shared


STEP_FLOPS = {"vit": vit_train_step, "moe": moe_forward}


def step_flops(cfg: dict) -> int:
    return STEP_FLOPS[cfg["family"]](cfg)
