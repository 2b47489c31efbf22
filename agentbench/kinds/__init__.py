"""Kinds of model: what the harness reads of a model's shape.

A configuration file names its kind under ``"kind"`` (``"dense"`` where it
names none), and the harness loads ``kinds/<kind>.py`` by path
(``spec.Cell.kind``). A kind is one module of plain functions and
constants:

  * ``dims(conf)``: the sizes every other function reads;
  * ``port_config(conf)``: the program's ``ModelConfig``;
  * ``layer_groups(m)``: the draw order of the per-layer leaves, as
    ``[(layer indices, {leaf: (one layer's shape, scale)}), ...]``
    (``weights.draw``; the top-level leaves are drawn there);
  * ``n_params(m)``;
  * ``REFERENCE``: the name of a module under ``reference/`` whose
    ``run(conf, raw, tokens, logits_at, kv_sink=None, fp8=False)`` is the
    plain float32 forward, and ``exact_float32()`` turns TF32 off for the
    process (``check.compare``; ``reference/model.py`` is the dense one);
  * ``step_flops(m, rows)``, ``decode_attention_bytes(m, ctxs,
    kv_itemsize, itemsize)``, ``kv_bytes_per_token(m, kv_itemsize)``: the
    benchmark's own work counts (the readers, through ``RunView.kind``);
  * ``max_context(conf, engine_max_len)``: the longest a session may grow;
    the client stops a session there.

Adding a kind is adding files: this module's sibling, its reference, and
readers for any work count it adds.
"""
