"""Port parity of the hybrid family (zamba2-2.7b): Mamba2 layers in
groups of ``attn_every``, each group followed by one weight-shared
attention + MLP block with a KV cache of its own.  Held at the smoke
config with ``n_layers=4`` on both sides, so two groups share the block
(``zoo_parity`` says how)."""

import functools

import numpy as np
import pytest
import torch

import zoo_parity as zp
from repro_torch.models import transformer as tfm


@functools.lru_cache(maxsize=None)
def pair():
    return zp.make_pair("zamba2-2.7b", n_layers=4)


def test_configs_match_reference():
    zp.check_configs("zamba2-2.7b")


def test_two_groups_share_one_block():
    ref_cfg, ref_params, cfg, params = pair()
    assert cfg.attn_every == 2 and cfg.n_layers // cfg.attn_every == 2
    assert len(params.layers) == 4 and params.shared is not None
    ref_layers = ref_params["layers"]["mamba"]["in_proj"]
    assert np.shape(ref_layers)[:2] == (2, 2)
    # layer 3 is group 1's second layer there
    np.testing.assert_array_equal(params.layers[3]["in_proj"].numpy(),
                                  np.asarray(ref_layers)[1, 1])
    np.testing.assert_array_equal(params.shared["wq"].numpy(),
                                  np.asarray(ref_params["shared_attn"]["wq"]))


def test_forward_matches_reference():
    assert zp.check_forward(pair(), with_prefix=False) == 0.0


def test_the_shared_block_runs_once_a_group():
    """The shared block, and no other attention block, runs once after
    each group of ``attn_every`` Mamba2 layers."""
    _, _, cfg, params = pair()
    toks = torch.from_numpy(zp.tokens(3, (1, 9), cfg.vocab_size))
    calls = []
    orig = tfm._attn_mlp_block

    def counted(blk, *args):
        calls.append(blk is params.shared)
        return orig(blk, *args)

    tfm._attn_mlp_block = counted
    try:
        tfm.forward(params, cfg, toks)
    finally:
        tfm._attn_mlp_block = orig
    assert calls == [True, True]


@pytest.mark.parametrize("s", zp.PROMPT_LENS)
def test_prefill_and_decode_match_reference(s):
    state = zp.check_prefill_and_decode(pair(), s, with_prefix=False)
    cfg = pair()[2]
    # states one a layer, caches one a group, the batch on axis 1
    assert state["ssm_layers"]["ssm"].shape[:2] == (4, 2)
    assert state["k"].shape[:3] == (2, 2, 32)


def test_engine_serves_the_reference_tokens(monkeypatch):
    zp.check_engine(pair(), monkeypatch)
