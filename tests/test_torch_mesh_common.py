"""Multi-process helpers for the port's mesh tests: ``run_world`` spawns a
gloo world on the CPU (one process a rank, topology through the
``ICEK_COORDINATOR`` / ``ICEK_NUM_PROCESSES`` / ``ICEK_PROCESS_ID``
variables), runs one of the workers below on every rank and returns what
each rank returned.  The workers import the port only (never JAX), so a
spawned rank starts in a few seconds; their inputs are numpy trees the
test built in the parent.
"""

import os
import pickle
import time

import numpy as np
import torch
import torch.multiprocessing as mp


def run_world(world: int, worker: str, args: tuple, tmp_path, timeout_s=300):
    """Spawn `world` ranks running ``<this module>.<worker>(rank, *args)``;
    returns the list of their results, rank by rank.  Ranks still running
    after `timeout_s` (a collective that never completes) are killed."""
    from icek_torch.parallel import distributed

    os.makedirs(str(tmp_path), exist_ok=True)
    port = distributed.free_port()
    ctx = mp.spawn(_entry, args=(world, port, worker, args, str(tmp_path)), nprocs=world,
                   join=False)
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"{worker}: a world of {world} ran past {timeout_s} s")
    out = []
    for rank in range(world):
        with open(os.path.join(str(tmp_path), f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _entry(rank, world, port, worker, args, tmp):
    torch.set_num_threads(1)
    os.environ.update(ICEK_COORDINATOR=f"localhost:{port}", ICEK_NUM_PROCESSES=str(world),
                      ICEK_PROCESS_ID=str(rank))
    from icek_torch.parallel import distributed

    info = distributed.maybe_initialize(device="cpu")
    assert (info.index, info.count) == (rank, world)
    try:
        result = globals()[worker](rank, *args)
    finally:
        distributed.shutdown()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [numpy_tree(v) for v in tree]
    return tree.detach().cpu().numpy().copy() if torch.is_tensor(tree) else tree


# --------------------------------------------------------------------------
# workers
# --------------------------------------------------------------------------

def _mesh_step(shape, tc, V, pad, tree, batch, steps, lr, cache=False):
    """`steps` port train steps on `shape`'s mesh; rank 0's view of the
    full params, Adam moments, losses and counts after each step."""
    from icek_torch import bridge
    from icek_torch.parallel import mesh as mesh_lib
    from icek_torch.train import step as tstep

    mesh = mesh_lib.make_mesh(*shape, device="cpu")
    params, specs = mesh_lib.shard_params(bridge.from_jax_params(tree, tc.model, V), mesh)
    params = bridge.trainable(params, "cpu")
    opt = tstep.make_optimizer(lr)
    state = opt.init(params)
    local = mesh_lib.shard_batch(batch, mesh)
    kw = {}
    if cache:
        # the rows' tokens from a cache row-sharded over the data axis
        tokens = local.pop("image_tokens")
        r0, b = mesh_lib.data_rows(mesh, len(batch["lengths"]))
        local["token_rows"] = torch.arange(r0, r0 + b)
        kw = dict(token_cache=mesh_lib.shard_rows(batch["image_tokens"], mesh),
                  token_cache_mesh=mesh)
        assert tokens.shape[0] == b
    train, _ = tstep.make_train_step(tc, V, pad, opt, encode_images=False, device="cpu",
                                     mesh=mesh, param_specs=specs, **kw)
    gen = torch.Generator().manual_seed(0)
    out = []
    for _ in range(steps):
        _, _, loss, count = train(params, state, None, local, gen)
        mu, nu = state.moments(params)
        out.append(dict(
            loss=float(loss), count=int(count),
            params=bridge.to_numpy(mesh_lib.gather_for_host(params, mesh, specs)),
            mu=bridge.to_numpy(mesh_lib.gather_for_host(mu, mesh, specs)),
            nu=bridge.to_numpy(mesh_lib.gather_for_host(nu, mesh, specs))))
    return out


def image_steps(rank, shape, tc, V, pad, tree, enc, batch, steps, lr, enc_lr, mode):
    """`steps` port train steps that run the encoder (`mode` "bn": its
    batch norms in train mode; "finetune": its layers 2-4 trained) on
    `shape`'s mesh; rank 0's losses, params, encoder tree and Adam first
    moments (the encoder's too when fine-tuning), the others' None."""
    from icek_torch import bridge
    from icek_torch.parallel import mesh as mesh_lib
    from icek_torch.train import step as tstep

    mesh = mesh_lib.make_mesh(*shape, device="cpu")
    params, specs = mesh_lib.shard_params(bridge.from_jax_params(tree, tc.model, V), mesh)
    params = bridge.trainable(params, "cpu")
    encoder = bridge.from_jax_resnet(enc)
    opt = tstep.make_optimizer(lr)
    state = opt.init(params)
    kw = dict(encode_images=True, bn_train_mode=mode == "bn", device="cpu", mesh=mesh,
              param_specs=specs)
    if mode == "finetune":
        encoder = bridge.trainable(encoder, "cpu")
        enc_opt = tstep.make_encoder_optimizer(encoder, enc_lr)
        enc_state = enc_opt.init(encoder)
        kw["encoder_optimizer"] = enc_opt
    train, _ = tstep.make_train_step(tc, V, pad, opt, **kw)
    local = mesh_lib.shard_batch(batch, mesh)
    gen = torch.Generator().manual_seed(0)
    losses, mu, enc_mu = [], [], []
    for _ in range(steps):
        if mode == "finetune":
            out = train(params, state, encoder, enc_state, local, gen)
            enc_mu.append(bridge.to_numpy(enc_state.moments(encoder)[0], resnet=True))
        else:
            out = train(params, state, encoder, local, gen)
        losses.append(float(out[-2]))
        mu.append(bridge.to_numpy(state.moments(params)[0]))
    if rank:
        return None
    return dict(losses=losses, params=bridge.to_numpy(params), mu=mu, enc_mu=enc_mu,
                enc=bridge.to_numpy(encoder, resnet=True))


def jobs(rank, todo):
    """Run each (worker name, args) of `todo` in turn on this rank."""
    return [globals()[name](rank, *args) for name, args in todo]


def steps_on_meshes(rank, shapes, tc, V, pad, tree, batch, steps, lr, cache=False):
    """`_mesh_step` on every mesh shape of `shapes`, in one world."""
    return [_mesh_step(s, tc, V, pad, tree, batch, steps, lr, cache) for s in shapes]


def row_gather(rank, shape, n_rows, width, rows_per_rank, seed):
    """The row-sharded cache of `shape`'s data axis: this rank's block from
    ``shard_rows`` and ``sharded_row_gather`` of seeded global row ids."""
    from icek_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh(*shape, device="cpu")
    rng = np.random.default_rng(seed)
    source = rng.standard_normal((n_rows, width)).astype(np.float32)
    S = mesh_lib.axis_size(mesh, mesh_lib.DATA_AXIS)
    ids = rng.integers(0, n_rows, (S * rows_per_rank,))
    block = mesh_lib.shard_rows(source, mesh)
    r0, b = mesh_lib.data_rows(mesh, len(ids))
    got = mesh_lib.sharded_row_gather(block, torch.as_tensor(ids[r0:r0 + b]), mesh)
    bf16 = mesh_lib.shard_rows(source, mesh, torch.bfloat16)
    got16 = mesh_lib.sharded_row_gather(bf16, torch.as_tensor(ids[r0:r0 + b]), mesh)
    return dict(block=block.numpy(), got=got.numpy(), want=source[ids[r0:r0 + b]],
                got16=got16.float().numpy(), data_index=mesh_lib.axis_index(mesh, "data"),
                bf16_dtype=str(bf16.dtype))


def indivisible_microbatch(rank, tc, V, pad, batch, accum):
    """make_train_step's step under a row-sharded cache whose microbatch
    rows do not divide by the data axis: the error text."""
    import dataclasses

    from icek_torch.parallel import mesh as mesh_lib
    from icek_torch.train import step as tstep

    mesh = mesh_lib.make_mesh(2, 1, device="cpu")
    tc = tc.replace(train=dataclasses.replace(tc.train, grad_accum_steps=accum))
    opt = tstep.make_optimizer(1e-3)
    train, _ = tstep.make_train_step(
        tc, V, pad, opt, encode_images=False, device="cpu",
        token_cache=torch.zeros(4, 12, tc.model.emb_dim), token_cache_mesh=mesh)
    local = mesh_lib.shard_batch({k: v for k, v in batch.items() if k != "image_tokens"},
                                 mesh)
    local["token_rows"] = torch.zeros(len(local["lengths"]), dtype=torch.long)
    from icek_torch import bridge
    from icek_torch.models import captioner

    params, _ = mesh_lib.shard_params(captioner.init_captioner_params(
        torch.Generator().manual_seed(0), tc.model, V), mesh)
    params = bridge.trainable(params, "cpu")
    try:
        train(params, opt.init(params), None, local, torch.Generator())
    except ValueError as e:
        return str(e)
    return None


def train_and_eval(rank, tc, data_dir, vocab, pad, ckpt_root, metrics_root, ev_args):
    """A two-process run: ``train.loop.train`` over a (2, 1) mesh, then
    ``Evaluator.run`` over the world."""
    from icek_torch import eval_driver
    from icek_torch.data import codec, dataset as ds
    from icek_torch.parallel import mesh as mesh_lib
    from icek_torch.train import loop

    mesh = mesh_lib.make_mesh(2, 1, device="cpu")
    os.environ["ICEK_METRICS_LOG"] = os.path.join(metrics_root, f"metrics{rank}.jsonl")
    lines = []
    result = loop.train(tc, data_dir, vocab, pad, checkpoint_dir=os.path.join(
        ckpt_root, f"rank{rank}"), max_epochs=1, log=lines.append, mesh=mesh)
    cfg, wm_words, params, enc, out_dir, base, csv_dir = ev_args
    ev = eval_driver.Evaluator(cfg, codec.Wordmap(wm_words), params, enc, batch_size=2,
                               beam_size=3, device="cpu", mesh=mesh)
    data = ds.CaptionDataset(out_dir, base, "TEST", cfg.model.has_facts)
    res = ev.run(data, output_csv=os.path.join(csv_dir, f"rank{rank}.csv"),
                 log=lambda *_: None)
    return dict(best_loss=result.best_loss, lines=lines, eval=res)
