"""Port parity: every architecture against the JAX package.

The registry holds all ten of the reference's architectures, in its order,
with the same configs and per-arch settings, and all six families. Each
smoke config, with weights converted from the JAX init, must give the
reference's logits (within 1e-4, argmax equal) through prefill and three
decode steps; paligemma with 16 seeded patch embeddings, whisper with 16
seeded frames, danube3 decoding past its 32-token window, and the hybrid,
ssm and audio families also from a 32-position prompt, so the chunked
scans run whole chunks. The serving engine with dbrx-smoke must reproduce
the JAX engine's tokens, memory report and allocation trace; the train
launcher runs every architecture on the CPU and the serve launcher refuses
the families the reference's refuses; and serving paligemma through the
engine fails in both packages in the same way, since neither engine passes
patch embeddings to prefill (ROADMAP queue C)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.pipeline import DataConfig as JDataConfig, SyntheticTokens as JSyntheticTokens
from repro.launch import serve as jserve
from repro.models.api import FAMILIES as jfamilies, family_of as jfamily_of
from repro.serve.engine import EngineConfig as JEngineConfig, ServeEngine as JServeEngine
from repro_torch import configs
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.launch import serve, train
from repro_torch.models import api, moe, transformer as T
from repro_torch.models.api import FAMILIES
from repro_torch.serve.engine import EngineConfig, ServeEngine

#: the reference's architectures whose families wait for later slices
NOT_PORTED = set()
ARCHS = [a for a in jconfigs.ARCHS if a not in NOT_PORTED]
#: the families whose mixers scan in chunks (and whisper's encoder-decoder)
NEW_ARCHS = ["zamba2-1.2b", "rwkv6-7b", "whisper-medium"]
TOL = dict(rtol=1e-4, atol=1e-4)


def converted(arch, seed=0):
    """(JAX config, JAX params, port config, port params) for the smoke
    config, the port's weights converted from the JAX init."""
    jcfg = jconfigs.get_arch(arch).smoke
    cfg = configs.get_arch(arch).smoke
    jparams = jfamily_of(jcfg).init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jparams, cfg, T.params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                                       device="cpu")


def close(port, ref):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32), **TOL)
    np.testing.assert_array_equal(port.argmax(-1).numpy(), np.asarray(ref).argmax(-1))


def test_registry_holds_the_ported_architectures_in_the_reference_order():
    assert list(configs.ARCHS) == ARCHS == list(jconfigs.ARCHS)
    assert len(ARCHS) == 10 and NOT_PORTED == set()
    assert list(FAMILIES) == ["dense", "moe", "hybrid", "ssm", "audio", "vlm"]
    assert list(FAMILIES) == list(jfamilies)
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_arch("no-such-arch")
    with pytest.raises(TypeError, match="unknown model config"):
        api.family_of(object())


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_entries_match_reference(arch):
    jentry, entry = jconfigs.get_arch(arch), configs.get_arch(arch)
    for f in dataclasses.fields(jentry):
        if f.name not in ("full", "smoke"):
            assert getattr(entry, f.name) == getattr(jentry, f.name), f.name
    assert [f.name for f in dataclasses.fields(entry)] == \
        [f.name for f in dataclasses.fields(jentry)]
    for which in ("full", "smoke"):
        jcfg, cfg = getattr(jentry, which), getattr(entry, which)
        assert type(cfg).__name__ == type(jcfg).__name__
        assert [f.name for f in dataclasses.fields(cfg)] == \
            [f.name for f in dataclasses.fields(jcfg)]
        for f in dataclasses.fields(jcfg):
            if f.name != "dtype":
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), (which, f.name)
        assert str(cfg.dtype).split(".")[-1] == jnp.dtype(jcfg.dtype).name
        assert cfg.n_params == jcfg.n_params
        for prop in ("dh", "n_heads", "n_apps", "groups", "mamba"):  # family-specific
            got, want = getattr(cfg, prop, None), getattr(jcfg, prop, None)
            if dataclasses.is_dataclass(want):  # zamba2's mixer config
                assert type(got).__name__ == type(want).__name__, prop
                got, want = dataclasses.asdict(got), dataclasses.asdict(want)
            assert got == want, prop
        assert getattr(cfg, "n_active_params", None) == getattr(jcfg, "n_active_params", None)
        assert api.family_of(cfg).name == jfamily_of(jcfg).name


def prompt_batches(cfg, fam, rng, n_pos):
    """The same seeded prompt for both packages: ``n_pos`` positions of
    tokens, for the vlm family counting its patches, for the audio family
    beside 16 frames."""
    jbatch, batch = {}, {}
    n_text = n_pos
    if fam.name == "vlm":
        patches = rng.standard_normal((2, cfg.n_patches, cfg.d_model)).astype(np.float32)
        jbatch["patch_embeds"], batch["patch_embeds"] = jnp.asarray(patches), \
            torch.from_numpy(patches)
        n_text -= cfg.n_patches
    if fam.name == "audio":
        frames = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
        jbatch["frames"], batch["frames"] = jnp.asarray(frames), torch.from_numpy(frames)
    prompt = rng.integers(0, cfg.vocab, size=(2, n_text)).astype(np.int32)
    jbatch["tokens"], batch["tokens"] = jnp.asarray(prompt), torch.from_numpy(prompt)
    return jbatch, batch


def caches(jcfg, cfg, fam, jfam, max_len=40):
    if fam.name == "audio":
        return jfam.init_cache(jcfg, 2, max_len, 16), fam.init_cache(cfg, 2, max_len, 16, "cpu")
    return jfam.init_cache(jcfg, 2, max_len), fam.init_cache(cfg, 2, max_len, device="cpu")


def check_prefill_and_decode(arch, n_pos):
    """Prefill of ``n_pos`` positions, then 3 decode steps: the logits, the
    lengths and the caches (K/V, or the recurrent states) as the reference's."""
    jcfg, jparams, cfg, params = converted(arch)
    jfam, fam = jfamily_of(jcfg), api.family_of(cfg)
    rng = np.random.default_rng(1)
    jbatch, batch = prompt_batches(cfg, fam, rng, n_pos)
    jcache, cache = caches(jcfg, cfg, fam, jfam)
    jlog, jcache = jfam.prefill(jcfg, jparams, jbatch, jcache)
    log, cache = fam.prefill(cfg, params, batch, cache)
    close(log, jlog)
    for _ in range(3):
        nxt = rng.integers(0, cfg.vocab, size=(2,)).astype(np.int32)
        jlog, jcache = jfam.decode_step(jcfg, jparams, jcache, jnp.asarray(nxt))
        log, cache = fam.decode_step(cfg, params, cache, torch.from_numpy(nxt))
        close(log, jlog)
    n = n_pos + 3
    assert cache["length"].tolist() == [n, n] == np.asarray(jcache["length"]).tolist()
    assert sorted(cache) == sorted(jcache)
    for key in sorted(cache):
        np.testing.assert_allclose(cache[key].float().numpy(),
                                   np.asarray(jcache[key], np.float32), **TOL, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    # 31 prompt positions, then 3 decode steps: danube3 (window 32) decodes
    # past it, and the chunked scans (chunk 8) fall back to chunks of 1
    check_prefill_and_decode(arch, 31)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_of_whole_chunks_and_decode_match_reference(arch):
    # 32 prompt positions: zamba2's and rwkv6's scans run four whole chunks
    check_prefill_and_decode(arch, 32)


@pytest.mark.parametrize("arch", ["paligemma-3b", "dbrx-132b", "h2o-danube-3-4b", *NEW_ARCHS])
def test_loss_matches_reference(arch):
    """The families' training losses: paligemma's prefix-LM loss on the
    text suffix, the MoE loss with its aux term, danube3's windowed one,
    the hybrid's and ssm's scans, whisper's encoder-decoder, on the data
    pipeline's batches (patch or frame embeddings included, bit-identical
    to the reference's)."""
    jcfg, jparams, cfg, params = converted(arch)
    fam = api.family_of(cfg).name
    dims = dict(patch_dim=cfg.d_model if fam == "vlm" else None,
                frame_dim=cfg.d_model if fam == "audio" else None)
    jbatch = JSyntheticTokens(JDataConfig(vocab=cfg.vocab, seq_len=48, global_batch=2,
                                          **dims)).batch_at(0)
    batch = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=48, global_batch=2, **dims),
                            "cpu").batch_at(0)
    assert sorted(batch) == sorted(jbatch)
    for k in batch:
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(jbatch[k]))
    jl = jfamily_of(jcfg).loss_fn(jcfg, jparams, jbatch)
    tl = api.family_of(cfg).loss_fn(cfg, params, batch)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)


def test_engine_with_dbrx_smoke_matches_jax_engine():
    """The MoE family through both engines on the same converted weights:
    tokens, memory report and allocation trace equal. Prompts share one
    length so the JAX engine compiles its prefill once; decode batches carry
    padded slots (token 0), which take expert capacity in both."""
    jcfg, jparams, cfg, params = converted("dbrx-132b")
    engines = (JServeEngine(jcfg, jparams, JEngineConfig(max_batch=3, max_len=64, n_chunks=64)),
               ServeEngine(cfg, params, EngineConfig(max_batch=3, max_len=64, n_chunks=64,
                                                     device="cpu")))
    for eng in engines:
        rng = np.random.default_rng(7)
        for i in range(5):
            eng.submit(rng.integers(0, cfg.vocab, size=12), max_new=2 + i % 3)
        eng.run_to_completion()
    jeng, eng = engines
    assert len(eng.finished) == 5
    assert [(r.req_id, r.generated) for r in eng.finished] == \
        [(r.req_id, r.generated) for r in jeng.finished]
    assert eng.memory_report() == jeng.memory_report()
    assert [(e.op, e.tid, e.size, e.label) for e in eng.recorder.trace.events] == \
        [(e.op, e.tid, e.size, e.label) for e in jeng.recorder.trace.events]


def test_serve_launcher_on_cpu_serves_dbrx_smoke():
    out = serve.main(["--arch", "dbrx-132b", "--smoke", "--device", "cpu", "--requests", "4",
                      "--max-new", "3"])
    assert out["arch"] == "dbrx-smoke" and out["finished"] == 4
    assert out["arena"]["active_bytes"] == 0 and out["init_s"] >= 0


def test_paligemma_serving_fails_in_both_packages():
    """The engines submit text prompts only, so paligemma's prefill finds
    no ``patch_embeds`` at the first admission: the reference's launcher
    accepts the vlm family but cannot serve it, and the port's does the
    same (it adds no patch input the reference lacks)."""
    argv = ["--arch", "paligemma-3b", "--smoke", "--requests", "2", "--max-new", "2"]
    with pytest.raises(KeyError, match="patch_embeds"):
        jserve.main(argv)
    with pytest.raises(KeyError, match="patch_embeds"):
        serve.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_launchers_refuse_the_new_families(arch):
    """The reference's launcher serves decoder-only families and refuses
    the hybrid, ssm and audio ones; the port's refuses them the same way."""
    fam = jfamily_of(jconfigs.get_arch(arch).smoke).name
    with pytest.raises(SystemExit, match=f"decoder-only families, got {fam}"):
        jserve.main(["--arch", arch, "--smoke", "--requests", "1"])
    with pytest.raises(SystemExit, match=f"decoder-only families, got {fam}"):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "1"])


def test_serve_launcher_refuses_families_it_does_not_serve(monkeypatch):
    ssm = api.Family("ssm", *[None] * 7)
    monkeypatch.setattr(serve, "family_of", lambda cfg: ssm)
    with pytest.raises(SystemExit, match="decoder-only families, got ssm"):
        serve.main(["--smoke", "--device", "cpu", "--requests", "1"])


def test_train_launcher_trains_dbrx_smoke(tmp_path):
    """20 supervised steps of the MoE smoke config on the CPU lower the loss."""
    out = train.main(["--arch", "dbrx-132b", "--smoke", "--steps", "20", "--batch", "8",
                      "--seq", "64", "--lr", "3e-3", "--device", "cpu", "--ckpt-dir",
                      str(tmp_path), "--ckpt-every", "10"])
    assert out["steps"] == 20 and out["last_loss"] < out["first_loss"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_runs_every_architecture(arch, tmp_path):
    """Two steps of each smoke config through the launcher (paligemma with
    the pipeline's patch embeddings): finite losses, no restart."""
    out = train.main(["--arch", arch, "--smoke", "--steps", "2", "--batch", "2", "--seq", "32",
                      "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert out["steps"] == 2 and np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])
    assert [e["kind"] for e in out["events"] if e["kind"] != "straggler"] == []


def test_new_entry_points_default_to_cuda():
    """Without a card, the MoE init and the serve launcher's new
    architectures raise on their CUDA default instead of falling back."""
    if torch.cuda.is_available():
        return
    cfg = configs.get_arch("dbrx-132b").smoke
    with pytest.raises(RuntimeError, match="CUDA"):
        moe.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "dbrx-132b", "--smoke", "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2, patch_dim=8))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_family_entry_points_default_to_cuda(arch):
    """Without a card, the new families' init and cache raise on their CUDA
    default, and so does the pipeline with frames."""
    if torch.cuda.is_available():
        return
    cfg = configs.get_arch(arch).smoke
    fam = api.family_of(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        fam.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        fam.init_cache(cfg, 2, 8, 16) if fam.name == "audio" else fam.init_cache(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2, frame_dim=8))
