"""Multi-rank runs of the port for the parallelism tests, on the CPU.

``run_ranks(job, world, tmp_path, *args)`` spawns ``world`` processes
(spawned, never forked), joins them in a ``gloo`` group through a
``file://`` store under ``tmp_path`` (no port, so parallel pytest workers
cannot collide), calls ``job(rank, world, *args)`` in each and returns the
ranks' results in rank order. A collective that waits on a failed rank
times out after two minutes. The jobs below import neither JAX nor the
JAX package, so a rank loads only torch and the port; the tests hold
their results to the reference's, computed in another process.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, world, store, out_dir, job, args):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=120))
        result = job(rank, world, *args)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported by the parent
        result = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_ranks(job, world: int, tmp_path, *args):
    out_dir = tempfile.mkdtemp(prefix=f"ranks_{job.__name__}_", dir=str(tmp_path))
    store = os.path.join(out_dir, "store")
    mp.start_processes(_entry, args=(world, store, out_dir, job, args), nprocs=world,
                       join=True, start_method="spawn")
    results = []
    for rank in range(world):
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    errors = [r["error"] for r in results if isinstance(r, dict) and "error" in r]
    assert not errors, errors[0]
    return results


# ---------------------------------------------------------------------------
# jobs (each rank's side of a test module's scenario)
# ---------------------------------------------------------------------------


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _whole(t):
    """A leaf as a float32 numpy array (a collective for a DTensor)."""
    from repro_torch.parallel.sharding import full

    return full(t).detach().float().numpy()


def moe_config(a2a: bool, gated: bool):
    """The MoE config of the reference's a2a integration test."""
    from repro_torch.models.moe import MoEConfig

    return MoEConfig(name="t", n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=96, vocab=211,
                     n_experts=4, top_k=2, capacity_factor=8.0, dtype=torch.float32,
                     gated=gated, act="silu", remat=False, a2a_dispatch=a2a)


def parallel_job(rank, world, inputs_path):
    """``collectives`` and ``a2a`` in one group."""
    out = collectives(rank, world, inputs_path)
    out.update(a2a(rank, world, inputs_path))
    return out


def collectives(rank, world, inputs_path):
    """compressed_psum (30 error-feedback steps), the ring all-gather, the
    ring matmul and GPipe over every rank."""
    import numpy as np
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.parallel.collectives import (compressed_psum, make_compressed_grad_sync,
                                                  overlapped_all_gather, ring_layer_matmul)
    from repro_torch.parallel.pipeline import pipeline_forward, split_stages

    inp = _load(inputs_path)
    g = torch.from_numpy(inp["g"][rank])
    r = torch.zeros_like(g)
    means, residuals = [], []
    for _ in range(30):
        m, r = compressed_psum(g, r)
        means.append(m.numpy())
        residuals.append(r.numpy())
    sync = make_compressed_grad_sync(init_device_mesh("cpu", (world,), mesh_dim_names=("data",)))
    tree = {"a": g, "b": {"c": g[:7] * 3}}
    synced, res = sync(tree, {"a": torch.zeros_like(g), "b": {"c": torch.zeros(7)}})
    one = compressed_psum(g[:7] * 3, torch.zeros(7))
    tree_sync = bool(torch.equal(synced["a"], torch.from_numpy(means[0]))
                     and torch.equal(synced["b"]["c"], one[0])
                     and torch.equal(res["b"]["c"], one[1]))
    w, x = torch.from_numpy(inp["w"]), torch.from_numpy(inp["x"])
    rows = w.shape[0] // world
    shard = w[rank * rows:(rank + 1) * rows]
    stacked, results = overlapped_all_gather(shard, None, lambda src, part: (src, part.clone()))
    ring = ring_layer_matmul(x, shard)
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("pod",))

    def stage_fn(params, h):
        for wl in params:
            h = torch.tanh(h @ wl)
        return h

    ys = pipeline_forward(stage_fn, split_stages(torch.from_numpy(inp["ws"]), world),
                          torch.from_numpy(inp["xs"]), mesh, "pod")
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    meshes = {m: tuple(make_host_mesh(model=m, device="cpu").shape) for m in (1, 2, 8)}
    try:
        make_production_mesh(device="cpu")
        refused = False
    except ValueError:
        refused = True
    return {"means": np.stack(means), "residuals": np.stack(residuals),
            "stacked": stacked.numpy(), "srcs": [s for s, _ in results],
            "parts": np.stack([p.numpy() for _, p in results]), "ring": ring.numpy(),
            "pipeline": ys.numpy(), "host_meshes": meshes, "production_refused": refused,
            "tree_sync": tree_sync}


def a2a(rank, world, inputs_path):
    """The MoE loss and its router/expert gradients through the a2a
    dispatch on a (data 2, model 2) mesh, gated and ungated, with and
    without ZeRO-3 expert weights; and the global dispatch's loss."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import moe as M
    from repro_torch.parallel import sharding as S
    from repro_torch.tree import leaves, tree_map, unflatten_like

    ref = _load(inputs_path)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    rules = S.make_rules(mesh, kind="train", seq_parallel=True)
    tokens = {"tokens": torch.from_numpy(ref["tokens"])}
    out = {}
    for gated in (True, False):
        cfg = moe_config(True, gated)
        params = M.params_from_jax_numpy(cfg, ref["params"][gated], device="cpu")
        out[("global", gated)] = float(M.loss_fn(moe_config(False, gated), params, tokens))
        for zero in (False, True):
            dp = S.place_tree(params, S.tree_shardings(params, M.param_axes(cfg), rules, mesh,
                                                       zero=zero))
            db = S.place_tree(tokens, S.batch_shardings(tokens, rules, mesh))
            sharder = S.make_sharder(mesh, rules, zero_params=zero)
            with implicit_replication():
                ps = tree_map(lambda p: p.detach().requires_grad_(True), dp)
                loss = M.loss_fn(cfg, ps, db, sharder=sharder)
                grads = torch.autograd.grad(loss, leaves(ps))
            mlp = unflatten_like(ps, list(grads))["layers"]["mlp"]
            out[(gated, zero)] = {"loss": float(S.full(loss)),
                                  "grads": {k: _whole(v) for k, v in mlp.items()}}
    out["sites"] = S.taken_sites()
    return out


def _grads(cfg, params, batch, sharder=None):
    """Every gradient leaf of the family's loss, whole."""
    import contextlib

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.api import family_of
    from repro_torch.tree import leaves, tree_map

    ctx = implicit_replication() if sharder is not None else contextlib.nullcontext()
    with ctx:
        ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
        kw = {} if sharder is None else {"sharder": sharder}
        loss = family_of(cfg).loss_fn(cfg, ps, batch, **kw)
        return [_whole(g) for g in torch.autograd.grad(loss, leaves(ps))]


def train_job(rank, world, inputs_path, archs, ckpt_dir, argv):
    """``train_steps`` and ``launcher`` in one group."""
    return {"steps": train_steps(rank, world, inputs_path, archs),
            "launcher": launcher(rank, world, ckpt_dir, argv)}


def train_steps(rank, world, ref_path, archs):
    """Three sharded train steps on a (data 2, model 2) mesh beside the
    port's unsharded step, from the reference's initial weights; the first
    step's gradients of both; each rank's block shape of every state leaf."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import params_from_jax_numpy
    from repro_torch.parallel import sharding as S
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import TrainState, make_train_step, state_axes
    from repro_torch.tree import leaves

    ref = _load(ref_path)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    rules = S.make_rules(mesh, kind="train", seq_parallel=False)
    out = {}
    for arch in archs:
        entry = get_arch(arch)
        cfg = entry.smoke
        adamw = opt.AdamWConfig(lr=1e-3)

        def fresh():
            p = params_from_jax_numpy(cfg, ref[arch]["params"], device="cpu")
            return TrainState(p, opt.init(adamw, p), torch.zeros((), dtype=torch.int32))

        plain = fresh()
        sh = S.tree_shardings(plain, state_axes(cfg), rules, mesh, zero=entry.zero)
        fallbacks = list(S.tree_shardings.last_fallbacks)
        state = S.place_tree(fresh(), sh)
        sharder = S.make_sharder(mesh, rules, zero_params=entry.zero_params)
        batches = [{"tokens": torch.from_numpy(t)} for t in ref[arch]["batches"]]
        placed = [S.place_tree(b, S.batch_shardings(b, rules, mesh)) for b in batches]
        grads = _grads(cfg, state.params, placed[0], sharder)
        pgrads = _grads(cfg, plain.params, batches[0])
        step = make_train_step(cfg, adamw, sharder, microbatches=entry.microbatches)
        pstep = make_train_step(cfg, adamw, microbatches=entry.microbatches)
        losses, plosses = [], []
        for b, db in zip(batches, placed):
            state, m = step(state, db)
            plain, pm = pstep(plain, b)
            losses.append(float(m["loss"]))
            plosses.append(float(pm["loss"]))
        final = [_whole(x) for x in leaves(state)]
        out[arch] = {
            "losses": losses, "plain_losses": plosses, "grads": grads, "plain_grads": pgrads,
            "final": final, "plain_final": [x.float().numpy() for x in leaves(plain)],
            "local_shapes": [tuple(x.to_local().shape) for x in leaves(state)],
            "placements": [tuple(map(str, x.placements)) for x in leaves(state)],
            "want_placements": [tuple(map(str, s.placements)) for s in leaves(sh)],
            "fallbacks": fallbacks, "sites": S.taken_sites(clear=True),
        }
    return out


def launcher(rank, world, ckpt_dir, argv):
    """The train launcher's ``run`` on every rank with one injected failure,
    then its last checkpoint restored onto a (data 4, model 1) mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    from repro_torch.parallel import sharding as S
    from repro_torch.train.step import state_axes
    from repro_torch.tree import leaves

    fired = []

    def inject(step):
        if step == 12 and not fired:
            fired.append(step)
            raise RuntimeError(f"injected failure at step {step}")

    args = train.parse_args(argv + ["--ckpt-dir", ckpt_dir])
    result, state = train.run(args, fail_injector=inject)
    whole = [S.full(x) for x in leaves(state)]
    mesh41 = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
    rules41 = S.make_rules(mesh41, kind="train")
    entry = get_arch(args.arch)
    sh41 = S.tree_shardings(state, state_axes(entry.smoke), rules41, mesh41, zero=entry.zero)
    ckpt = CheckpointManager(ckpt_dir)
    restored = ckpt.restore(state, step=ckpt.latest_step(), shardings=sh41)
    return {
        "result": {k: v for k, v in result.items() if k != "history"},
        "restored_equal": [bool(torch.equal(S.full(a), b))
                           for a, b in zip(leaves(restored), whole)],
        "restored_placements_ok": all(tuple(a.placements) == s.placements
                                      for a, s in zip(leaves(restored), leaves(sh41))),
        "whole": [b.numpy() if b.dtype != torch.bfloat16 else b.float().numpy()
                  for b in whole] if rank == 0 else None,
        "last_step": ckpt.latest_step(),
    }


def families_job(rank, world, archs):
    """Every architecture's smoke config on a (data 2, model 2) mesh beside
    the port's unsharded step: the first gradient and two steps' losses."""
    import numpy as np
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models.api import family_of
    from repro_torch.parallel import sharding as S
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import init_state, make_train_step, state_axes

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    rules = S.make_rules(mesh, kind="train", seq_parallel=False)
    out = {}
    for arch in archs:
        entry = get_arch(arch)
        cfg = entry.smoke
        fam = family_of(cfg)
        adamw = opt.AdamWConfig(lr=1e-3)

        def fresh():
            return init_state(cfg, adamw, torch.Generator().manual_seed(0), "cpu")

        plain = fresh()
        sh = S.tree_shardings(plain, state_axes(cfg), rules, mesh, zero=entry.zero)
        state = S.place_tree(fresh(), sh)
        sharder = S.make_sharder(mesh, rules, zero_params=entry.zero_params)
        data = SyntheticTokens(DataConfig(
            vocab=cfg.vocab, seq_len=32, global_batch=4, seed=0,
            patch_dim=cfg.d_model if fam.name == "vlm" else None,
            frame_dim=cfg.d_model if fam.name == "audio" else None), "cpu")
        batches = [data.batch_at(i) for i in range(2)]
        placed = [S.place_tree(b, S.batch_shardings(b, rules, mesh)) for b in batches]
        S.taken_sites(clear=True)
        grads = _grads(cfg, state.params, placed[0], sharder)
        pgrads = _grads(cfg, plain.params, batches[0])
        grad_rel = max(float(np.abs(g - p).max() / max(np.abs(p).max(), 1e-30))
                       for g, p in zip(grads, pgrads))
        step = make_train_step(cfg, adamw, sharder)
        pstep = make_train_step(cfg, adamw)
        losses, plosses = [], []
        for b, db in zip(batches, placed):
            state, m = step(state, db)
            plain, pm = pstep(plain, b)
            losses.append(float(m["loss"]))
            plosses.append(float(pm["loss"]))
        out[arch] = {"grad_rel": grad_rel, "losses": losses, "plain_losses": plosses,
                     "sites": S.taken_sites(clear=True)}
    return out


def dryrun_job(rank, world, archs):
    """The dry run's sharded paths that no train test reaches, each beside
    the unsharded step: ``decode`` and ``heads``."""
    return {"decode": decode_steps(archs), "heads": heads_split_gradients()}


def heads_split_gradients():
    """paligemma's smoke config with 2 heads of 32 on a (data 1, model 4)
    mesh, so the attention projections are split inside a head (as the
    full config's 8 heads on a 16-wide model axis): the largest relative
    gap of any gradient leaf to the unsharded one."""
    import dataclasses

    import numpy as np
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models.api import family_of
    from repro_torch.parallel import sharding as S

    cfg = dataclasses.replace(get_arch("paligemma-3b").smoke, n_heads=2)
    fam = family_of(cfg)
    mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    rules = S.make_rules(mesh, kind="train", seq_parallel=True)
    params = fam.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4,
                                       patch_dim=cfg.d_model), "cpu").batch_at(0)
    placed = S.place_tree(params, S.tree_shardings(params, fam.param_axes(cfg), rules, mesh))
    S.taken_sites(clear=True)
    grads = _grads(cfg, placed, S.place_tree(batch, S.batch_shardings(batch, rules, mesh)),
                   S.make_sharder(mesh, rules))
    want = _grads(cfg, params, batch)
    return {"grad_rel": max(float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
                            for g, w in zip(grads, want)),
            "sites": S.taken_sites(clear=True)}


def decode_steps(archs):
    """Each architecture's smoke decode step on a (data 2, model 2) mesh
    under the decode rules (batch over data, the cache's sequence over
    model), from a seeded cache and lengths, beside the unsharded step:
    the logits' and the whole cache's largest differences."""
    import numpy as np
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import ShapeSpec, cache_specs
    from repro_torch.models.api import family_of
    from repro_torch.parallel import sharding as S
    from repro_torch.train.step import make_serve_steps
    from repro_torch.tree import leaves, tree_map

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    rules = S.make_rules(mesh, kind="decode")
    batch, max_len = 4, 16
    out = {}
    for arch in archs:
        cfg = get_arch(arch).smoke
        fam = family_of(cfg)
        params = fam.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        g = torch.Generator().manual_seed(1)

        def seeded(t):
            if t.dtype == torch.int32:  # lengths: each sequence somewhere short of the end
                return torch.randint(0, max_len - 1, t.shape, generator=g, dtype=torch.int32)
            return torch.randn(t.shape, generator=g).to(t.dtype)

        cache = tree_map(seeded, cache_specs(cfg, ShapeSpec("d", max_len, batch, "decode")))
        tokens = torch.randint(0, cfg.vocab, (batch,), generator=g, dtype=torch.int32)
        _, plain = make_serve_steps(cfg)
        want, want_cache = plain(params, tree_map(torch.clone, cache), tokens)
        p_sh = S.tree_shardings(params, fam.param_axes(cfg), rules, mesh)
        c_sh = S.tree_shardings(cache, fam.cache_axes(cfg), rules, mesh)
        t_sh = S.batch_shardings({"t": tokens}, rules, mesh)["t"]
        S.taken_sites(clear=True)
        _, sharded = make_serve_steps(cfg, S.make_sharder(mesh, rules))
        got, got_cache = sharded(S.place_tree(params, p_sh), S.place_tree(cache, c_sh),
                                 S.place(tokens, t_sh))
        out[arch] = {
            "logits": float(np.abs(_whole(got) - want.float().numpy()).max()),
            "logits_max": float(want.abs().max()),
            "cache": max(float(np.abs(_whole(a) - b.float().numpy()).max())
                         for a, b in zip(leaves(got_cache), leaves(want_cache), strict=True)),
            "cache_specs": [sh.spec for sh in leaves(c_sh)],
            "sites": S.taken_sites(clear=True),
        }
    return out
