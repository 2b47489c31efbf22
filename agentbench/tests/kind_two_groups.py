"""A kind for the tests: the dense model with its layers drawn as two
groups, layer 0 and then the rest. ``tiny.make_tree`` copies it into the
tree's ``kinds/`` as ``two_groups``."""
from agentbench.kinds.dense import (  # noqa: F401
    REFERENCE, decode_attention_bytes, dims, kv_bytes_per_token,
    layer_leaves, max_context, n_params, port_config, step_flops)


def layer_groups(m):
    leaves = layer_leaves(m)
    return [([0], leaves), (list(range(1, m["L"])), leaves)]
