"""Port parity of the dense-attention archs beyond Qwen3 (glm4-9b, GQA
rep 2; minitron-4b; gemma3-1b, 5:1 windowed layers, head dim 256 at full
size) and of the vlm and audio archs (internvl2-2b, musicgen-medium),
with and without their frontend prefix, at their smoke configs
(``zoo_parity`` says how they are held).  gemma3's prompts of 13 tokens
pass its smoke window of 8, so its windowed layers mask."""

import functools

import pytest

import zoo_parity as zp

ARCHS = ("glm4-9b", "minitron-4b", "gemma3-1b", "internvl2-2b",
         "musicgen-medium")
FRONTEND_ARCHS = ("internvl2-2b", "musicgen-medium")

pair = functools.lru_cache(maxsize=None)(zp.make_pair)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    zp.check_configs(arch)


def test_gemma3_windows_are_5_to_1():
    from repro.models.transformer import layer_windows as ref_windows
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import layer_windows
    cfg = get_config("gemma3-1b")
    w = layer_windows(cfg)
    assert w.tolist() == ref_windows(cfg).tolist()
    assert (w == 0).sum() == 4 and (w == 1024).sum() == 22
    assert all(w[i] == 0 for i in range(5, 26, 6))
    smoke = zp.smoke_config(cfg)
    assert smoke.sliding_window == 8 < max(zp.PROMPT_LENS)
    assert layer_windows(smoke).tolist() == [8, 0]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    assert zp.check_forward(pair(arch), with_prefix=False) == 0.0


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_forward_with_prefix_matches_reference(arch):
    assert zp.check_forward(pair(arch), with_prefix=True) == 0.0


@pytest.mark.parametrize("s", zp.PROMPT_LENS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, s):
    zp.check_prefill_and_decode(pair(arch), s, with_prefix=False)


@pytest.mark.parametrize("s", zp.PROMPT_LENS)
@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_prefill_with_prefix_matches_reference(arch, s):
    state = zp.check_prefill_and_decode(pair(arch), s, with_prefix=True)
    cfg = pair(arch)[2]
    assert state["index"].tolist() == [cfg.frontend_prefix_len + s + 3] * 2


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_serves_the_reference_tokens(arch, monkeypatch):
    zp.check_engine(pair(arch), monkeypatch)
