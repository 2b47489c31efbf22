"""The port's architecture registry against the reference's, and every
architecture through the port's model API on the CPU:

  * ``ARCH_IDS`` equal, in order; every full and smoke config equal field
    by field;
  * ``input_specs`` gives the reference's shapes and dtypes for every
    (arch x shape) cell of ``iter_cells``, as meta tensors;
  * ``test_smoke_archs.py``'s ``test_forward_shapes_and_finite`` and
    ``test_decode_step`` on the port, for all ten architectures, each from
    its own ``build(cfg).init_params``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref
import repro_torch.configs as port
from repro_torch.models import build

B, S = 2, 16


def test_arch_ids_equal_reference():
    assert port.ARCH_IDS == ref.ARCH_IDS
    assert len(port.ARCH_IDS) == 10
    assert port.__all__ == ref.__all__


@pytest.mark.parametrize("arch", ref.ARCH_IDS)
def test_configs_equal_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        want = getattr(ref, get)(arch)
        got = getattr(port, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), get


def test_unknown_arch_raises_key_error():
    for get in (port.get_config, port.get_smoke_config):
        with pytest.raises(KeyError, match="unknown arch"):
            get("gpt-5")


_DTYPES = {jnp.dtype(jnp.int32): torch.int32,
           jnp.dtype(jnp.float32): torch.float32,
           jnp.dtype(jnp.bfloat16): torch.bfloat16}


@pytest.mark.parametrize("arch", ref.ARCH_IDS)
def test_input_specs_equal_reference(arch):
    cells = [c for c in port.iter_cells() if c[0] == arch]
    assert [(a, s.name, ok, why) for a, s, ok, why in cells] == [
        (a, s.name, ok, why) for a, s, ok, why in ref.iter_cells()
        if a == arch]
    cfg = port.get_config(arch)
    for _, shape, _, _ in cells:
        want = ref.input_specs(ref.get_config(arch), shape)
        got = port.input_specs(cfg, shape)
        assert list(got) == list(want), shape.name
        for name, spec in want.items():
            assert got[name].device.type == "meta"
            assert tuple(got[name].shape) == spec.shape, (shape.name, name)
            assert got[name].dtype == _DTYPES[jnp.dtype(spec.dtype)]


def _inputs(cfg, seed):
    """``test_smoke_archs._batch`` in numpy: text tokens, and the image's
    patch embeddings or the audio's frame embeddings."""
    rng = np.random.default_rng(seed)
    text = S - (cfg.n_image_tokens if cfg.family == "vlm" else 0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, text))
                            .astype(np.int32))
    extra = {}
    if cfg.family == "vlm":
        extra["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32))
    if cfg.is_encoder_decoder:
        extra["frame_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.enc_len, cfg.d_model)).astype(np.float32))
    return toks, extra


@pytest.mark.parametrize("arch", ref.ARCH_IDS)
def test_forward_shapes_and_finite(arch):
    cfg = port.get_smoke_config(arch).replace(remat=False)
    model = build(cfg)
    params = model.init_params(seed=0, device="cpu")
    toks, extra = _inputs(cfg, seed=1)
    logits = model.forward(params, toks, **extra)
    assert logits.shape == (B, toks.shape[1], cfg.vocab_size)
    assert logits.dtype == torch.float32
    assert torch.isfinite(logits).all(), f"{arch}: non-finite logits"


@pytest.mark.parametrize("arch", ref.ARCH_IDS)
def test_decode_step(arch):
    cfg = port.get_smoke_config(arch).replace(remat=False)
    model = build(cfg)
    params = model.init_params(seed=0, device="cpu")
    state = model.init_decode_state(B, 32, device="cpu")
    token = torch.ones((B, 1), dtype=torch.int32)
    logits = model.decode_step(params, state, token, 0)
    assert logits.shape == (B, 1, cfg.vocab_size)
    assert torch.isfinite(logits).all(), f"{arch}: decode non-finite"
    # the next position must work too
    assert torch.isfinite(model.decode_step(params, state, token, 1)).all()
