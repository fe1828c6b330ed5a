"""The cross-config serving conformance matrix (``tests/test_conformance.py``)
on the port alone, at smoke size, on the CPU (the kernels' plain
versions).

One contract over every config of ``repro_torch.configs``: the engine
serves a config correctly or refuses it loudly, never a third thing.

* The registry is the reference's: ``list_configs()`` names the same
  architectures, and each lands in exactly one serving category.
* Decoder families (dense, MoE, SSM, hybrid, VLM) generate
  deterministically through ``Engine.generate``; a vision model with
  seeded patches.
* The encoder-only family (audio) is refused with a ``ValueError`` naming
  the family.
* Speculation partitions the registry as chunked prefill does:
  chunk-capable configs (dense / MoE with full or sliding-window
  attention, no frontend) run draft-verify rounds with their own
  non-speculative tokens; MLA, SSM, hybrid and VLM configs warn "falls
  back" and then serve exactly as a plain engine.
* Paged speculation composes on the full-attention subset, with the
  invariant checker after every iteration; ``paged=True`` on a frontend
  config raises.

Two card tests (``cuda`` marker) hold the frontend families' kernel runs
to their plain runs on the card: llava-next-34b-smoke's engine and
hubert-xlarge-smoke's forward.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config, list_configs
from repro_torch.models import transformer as T
from repro_torch.serving import speculative as spec_lib
from repro_torch.serving.chaos import check_serving_invariants
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request
from test_torch_threads import share_cpu_threads  # noqa: F401 (autouse: torch threads per worker)

KW = dict(hot_cap=4, max_len=64, device="cpu")
NEW = 8
ALL = list_configs()


def _chunk_capable(cfg):
    # the matrix's own copy of Engine._chunked_capable, kept apart on
    # purpose: if the engine's notion drifts, the config that moved fails
    return (cfg.family in ("dense", "moe") and cfg.attn_type in ("full", "swa")
            and cfg.frontend == "none")


AUDIO = [n for n in ALL if get_smoke_config(n).family == "audio"]
SPEC_OK = [n for n in ALL if _chunk_capable(get_smoke_config(n))]
FALLBACK = [n for n in ALL if n not in AUDIO and not _chunk_capable(get_smoke_config(n))]
PAGED_OK = [n for n in SPEC_OK if get_smoke_config(n).attn_type == "full"]
FRONTEND = [n for n in ALL if get_smoke_config(n).frontend != "none"]

_setup_cache = {}


def _setup(name):
    if name not in _setup_cache:
        cfg = get_smoke_config(name)
        _setup_cache[name] = (cfg, T.init_params(cfg, seed=0, device="cpu"))
    return _setup_cache[name]


def _draft(cfg):
    dcfg = spec_lib.make_draft_config(cfg)
    return dcfg, T.init_params(dcfg, seed=7, device="cpu")


def _inputs(cfg, b=2, n=8):
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, (b, n)).astype(np.int32)
    patches = None
    if cfg.family == "vlm":
        patches = rng.standard_normal((b, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
    return prompts, patches


def test_list_configs_equals_reference():
    pytest.importorskip("jax")
    from repro.configs import list_configs as reference_list

    assert ALL == reference_list()


def test_registry_partition_is_total():
    """Every config lands in exactly one serving category."""
    assert sorted(AUDIO + SPEC_OK + FALLBACK) == sorted(ALL)
    assert AUDIO == ["hubert-xlarge"]
    assert {"mamba2-130m", "zamba2-7b", "deepseek-v3-671b", "llava-next-34b"} <= set(FALLBACK)
    assert "falcon3-draft" in SPEC_OK  # the draft model serves on its own
    assert sorted(FRONTEND) == ["hubert-xlarge", "llava-next-34b"]


@pytest.mark.parametrize("name", [n for n in ALL if n not in AUDIO])
def test_generate_deterministic(name):
    cfg, params = _setup(name)
    prompts, patches = _inputs(cfg)
    eng = Engine(cfg, params, **KW)
    a = eng.generate(prompts, max_new_tokens=NEW, patches=patches)
    b = eng.generate(prompts, max_new_tokens=NEW, patches=patches)
    assert a.tokens.shape == (2, NEW)
    np.testing.assert_array_equal(a.tokens.numpy(), b.tokens.numpy())
    assert ((a.tokens >= 0) & (a.tokens < cfg.vocab_size)).all()


@pytest.mark.parametrize("name", AUDIO)
def test_encoder_only_is_refused(name):
    cfg, params = _setup(name)
    prompts, _ = _inputs(cfg)
    eng = Engine(cfg, params, **KW)
    with pytest.raises(ValueError, match=cfg.family):
        eng.generate(prompts, max_new_tokens=NEW)


@pytest.mark.parametrize("name", SPEC_OK)
def test_speculative_parity(name):
    """Chunk-capable configs: draft-verify greedy tokens equal the
    sequential greedy ones."""
    cfg, params = _setup(name)
    dcfg, dparams = _draft(cfg)
    prompts, _ = _inputs(cfg)
    ref = Engine(cfg, params, prefill_chunk=4, **KW).generate(prompts, max_new_tokens=NEW)
    eng = Engine(cfg, params, prefill_chunk=4, draft_cfg=dcfg, draft_params=dparams,
                 spec_k=4, **KW)
    assert eng.spec
    res = eng.generate(prompts, max_new_tokens=NEW)
    np.testing.assert_array_equal(ref.tokens.numpy(), res.tokens.numpy())
    st = eng.last_stats
    assert 0 < st.drafted_tokens and st.accepted_tokens <= st.drafted_tokens


@pytest.mark.parametrize("name", FALLBACK)
def test_speculative_fallback_warns_then_serves(name):
    """MLA / SSM / hybrid / VLM configs cannot run the chunked verify: the
    engine warns and then serves exactly as a plain engine."""
    cfg, params = _setup(name)
    dcfg, dparams = _draft(cfg)
    prompts, patches = _inputs(cfg)
    ref = Engine(cfg, params, **KW).generate(prompts, max_new_tokens=NEW, patches=patches)
    with pytest.warns(RuntimeWarning, match="falls back"):
        eng = Engine(cfg, params, prefill_chunk=4, draft_cfg=dcfg, draft_params=dparams,
                     spec_k=4, **KW)
    assert not eng.spec
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = eng.generate(prompts, max_new_tokens=NEW, patches=patches)
    np.testing.assert_array_equal(ref.tokens.numpy(), res.tokens.numpy())
    assert eng.last_stats.drafted_tokens == 0


@pytest.mark.parametrize("name", PAGED_OK)
def test_paged_speculative_parity_with_invariants(name):
    """Full-attention configs: speculation over the paged cold tier gives
    the contiguous non-speculative tokens, the invariant checker green
    after every iteration."""
    cfg, params = _setup(name)
    dcfg, dparams = _draft(cfg)
    prompts, _ = _inputs(cfg)
    ref = Engine(cfg, params, prefill_chunk=4, **KW).generate(prompts, max_new_tokens=NEW)
    eng = Engine(cfg, params, prefill_chunk=4, paged=True, page_size=8, draft_cfg=dcfg,
                 draft_params=dparams, spec_k=4, **KW)
    checked = []

    def hook(ctx):
        check_serving_invariants(ctx)
        checked.append(ctx.iteration)

    fins = {f.rid: f for f in eng.serve([Request(i, prompts[i], NEW) for i in range(2)],
                                        slots=2, on_iteration=hook)}
    for i in range(2):
        np.testing.assert_array_equal(ref.tokens.numpy()[i], fins[i].tokens)
    assert len(checked) == eng.last_stats.iterations > 0


@pytest.mark.parametrize("name", FRONTEND)
def test_paged_frontend_config_raises(name):
    cfg, params = _setup(name)
    with pytest.raises(ValueError, match="paged serving needs chunked prefill"):
        Engine(cfg, params, prefill_chunk=4, paged=True, page_size=8, **KW)


def _plain(cfg):
    return dataclasses.replace(cfg, bitnet=dataclasses.replace(cfg.bitnet, impl="plain"))


@pytest.mark.cuda
def test_cuda_vlm_engine_matches_plain_run():
    """llava-next-34b-smoke on the card: kernels 1, 2 and 3 run, and the
    tokens and ledgers equal the plain run's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels import flash_decode, flash_prefill, ternary_matmul

    cfg = get_smoke_config("llava-next-34b")
    params = T.init_params(cfg, seed=0, device="cuda")
    prompts, patches = _inputs(cfg, b=3)
    kernels = (ternary_matmul.KERNEL, flash_decode.KERNEL, flash_prefill.KERNEL)
    before = [k.launches for k in kernels]
    kw = dict(hot_cap=4, max_len=48, slots=3)
    got = Engine(cfg, params, **kw).generate(prompts, max_new_tokens=16, patches=patches)
    assert all(k.launches > n for k, n in zip(kernels, before))
    want = Engine(_plain(cfg), params, **kw).generate(prompts, max_new_tokens=16,
                                                      patches=patches)
    assert torch.equal(got.tokens, want.tokens) and got.traffic == want.traffic


@pytest.mark.cuda
def test_cuda_encoder_forward_matches_plain_run():
    """hubert-xlarge-smoke's forward on the card: one ternary launch per
    projection (4 a layer), logits equal to the plain run's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels import ternary_matmul

    cfg = get_smoke_config("hubert-xlarge")
    params = T.init_params(cfg, seed=0, device="cuda", pack=True)
    frames = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (3, 12, cfg.frontend_dim)).astype(np.float32), device="cuda")
    before = ternary_matmul.KERNEL.launches
    got = T.forward(params, cfg, {"frames": frames})
    assert ternary_matmul.KERNEL.launches - before == 4 * cfg.n_layers
    assert torch.equal(got, T.forward(params, _plain(cfg), {"frames": frames}))
