"""Sharding constraints inside model code (the port of
``repro.distributed.constrain``).

The reference pins an activation's layout with
``jax.lax.with_sharding_constraint`` when a mesh with the named axis is
active and the dim divides it, and is a no-op everywhere else, so model
code can call it unconditionally. The port has one controller holding
whole tensors: a layout is a placement (``distributed.sharding``), never a
property of an activation, so ``maybe_constrain`` returns ``x`` itself
with or without an active mesh (``with mesh:``, ``launch.mesh``). It never
changes a value.
"""


def maybe_constrain(x, spec_dims):
    """spec_dims: tuple of axis-name-or-None per dim of x. Returns ``x``:
    with no active mesh as the reference does, and under one because the
    tensor is whole on its device."""
    return x
