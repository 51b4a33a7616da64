"""The rank-side code of the mesh tests (``tests/test_torch_mesh_*.py``);
pytest does not collect it.

    python tests/torch_mesh_ranks.py CASE DIR

A case named ``ref_*`` runs the JAX reference on forced host devices
(``XLA_FLAGS`` set before JAX starts, as ``tests/test_elastic.py`` does;
``ref_mesh_run`` pickles the reference's mesh decode plans and runs to
``ref_mesh_run.pkl``);
any other spawns ``WORLD[case]`` processes on the CPU that form a ``gloo``
group over a file in ``DIR`` and run ``rank_<case>``.  Inputs and results
cross as ``.npz`` files in ``DIR``: the reference's parameters
(``ref_params.npz``) and each side's results (``<case>_<rank>.npz``).
Everything is SMOKE-sized and every group has at most 4 members.
"""
from __future__ import annotations

import os
import subprocess
import sys
import traceback

import numpy as np

WORLD = {"psum": 4, "dp": 4, "place": 4, "elastic": 4}
FORCED = {"ref_psum": 4, "ref_dp": 4, "ref_elastic": 4, "ref_mesh_run": 4}
ARCH = "qwen1.5-0.5b"
PSUM_SHAPES = ((64,), (7, 33), (3, 5, 9), (1,))
DP_OPT = dict(lr=1e-2, warmup_steps=0, total_steps=10, weight_decay=0.1)
DP_STEPS = 2
B, S = 8, 32


HERE = os.path.dirname(os.path.abspath(__file__))


# ----------------------------------------------------------------- helpers

def run_case(case: str, d: str, timeout: float = 400) -> None:
    """Run ``case`` in a subprocess (this file as a script) with ``DIR`` =
    ``d``; raises with the ranks' tracebacks when it fails."""
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(HERE), "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, os.path.join(HERE, "torch_mesh_ranks.py"), case, d],
                         env=env, capture_output=True, text=True, timeout=timeout)
    errors = "".join(open(os.path.join(d, f)).read() for f in sorted(os.listdir(d))
                     if f.startswith("error_"))
    if out.returncode != 0:
        raise AssertionError(f"{case} failed:\n{out.stderr[-3000:]}\n{errors}")


def flat(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat(v, path + "/"))
        else:
            out[path] = np.asarray(v)
    return out


def nest(flat_tree) -> dict:
    tree: dict = {}
    for path, v in flat_tree.items():
        node = tree
        *dirs, leaf = path.split("/")
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = v
    return tree


def save(d: str, name: str, **arrays) -> None:
    np.savez(os.path.join(d, name + ".npz"), **arrays)


def load(d: str, name: str) -> dict:
    with np.load(os.path.join(d, name + ".npz")) as z:
        return dict(z)


def psum_inputs():
    """Four members' gradients and error buffers per shape, float32."""
    rng = np.random.default_rng(5)
    grads = [rng.normal(size=(4, *s)).astype(np.float32) * 3 for s in PSUM_SHAPES]
    errs = [rng.normal(size=(4, *s)).astype(np.float32) * 0.01 for s in PSUM_SHAPES]
    return grads, errs


def batches():
    rng = np.random.default_rng(11)
    out = []
    for _ in range(DP_STEPS):
        tok = rng.integers(0, 256, size=(B, S + 1)).astype(np.int32)
        out.append({"tokens": tok[:, :-1], "labels": tok[:, 1:]})
    return out


def mesh_columns(P):
    """The reference's mesh decode columns (``tests/test_mesh_decode.py``) and
    their plans in the plan module ``P`` (either package's): a skewed rANS
    grid, RLE, a string dictionary with a bit-packed index, two small rANS
    columns."""
    rng = np.random.default_rng(7)
    cols = {
        "big": np.concatenate([np.zeros(50_000, np.int32),
                               rng.integers(0, 60, 30_000).astype(np.int32)]),
        "rle": np.repeat(rng.integers(0, 50, 400), rng.integers(1, 90, 400)).astype(np.int32),
        "sdbp": np.frombuffer(b"the quick brown fox jumps. " * 1500, dtype=np.uint8).copy(),
        "small0": rng.integers(0, 9, 5_000).astype(np.int32),
        "small1": rng.integers(0, 9, 5_000).astype(np.int32),
    }
    plans = {"big": P.Plan("ans", params={"chunk_size": 512}), "rle": P.make_plan("rle"),
             "sdbp": P.Plan("stringdict", children={"index": P.make_plan("bitpack")}),
             "small0": P.Plan("ans", params={"chunk_size": 512}),
             "small1": P.Plan("ans", params={"chunk_size": 512})}
    return cols, plans


def mesh_blobs():
    """``mesh_columns`` and their blobs, encoded by the reference."""
    from repro.core import plan as RP

    cols, plans = mesh_columns(RP)
    return cols, {n: RP.encode(plans[n], a) for n, a in cols.items()}


# --------------------------------------------------------- reference side

def ref_mesh_run(d: str) -> None:
    """The reference's mesh runs of ``tests/test_mesh_decode.py`` and
    ``tests/test_async_dispatch.py`` on 4 devices: the ``shard_threshold_bytes=0``
    plans at N = 2 and 4 with every shard's schedule, the N = 4 plan run
    sequentially and concurrently, the elastic suffix after the loss of
    device 0, the skewed-link fabric plan, and a serving wave over 2
    devices; plans, schedules and results pickled to ``ref_mesh_run.pkl``."""
    import pickle

    import jax
    from repro.core import planner as RPL
    from repro.core.compiler import ProgramCache
    from repro.core.costmodel import LinkTopology
    from repro.core.executor import StreamingExecutor
    from repro.core.serve_planner import ServePlanner
    from repro.launch.elastic import replan_suffix

    assert jax.device_count() == 4
    _, encs = mesh_blobs()
    ex = StreamingExecutor(chunk_bytes="auto", chunk_decode=True, cache=ProgramCache())
    for n, e in encs.items():
        ex.compile(n, e)
    profiles = {n: ex.column_profile(n) for n in encs}
    out: dict = {"plans": {}, "runs": {}, "schedules": {}}

    def run(label, mp, **kw):
        res = ex.run_sharded(mp, encs, **kw)
        out["plans"][label] = mp
        out["runs"][label] = {
            "arrays": {c: np.asarray(res[c].array) for c in mp.columns()},
            "per_device": dict(res.per_device), "device_launches": dict(res.device_launches),
            "shard_devices": {c: tuple(res[c].shard_devices) for c in mp.shards},
            "d2d": {it: (s, t) for it, (s, t, _) in res.d2d_copies.items()}}
        return res

    for n in (2, 4):
        mp = RPL.plan_mesh_execution(profiles, ex.cost_model, n_devices=n,
                                     shard_threshold_bytes=0)
        out["plans"][f"n{n}"] = mp
        for col, specs in mp.shards.items():
            for s in specs:
                cb = next(p.decisions[s.name] for p in mp.plans
                          if s.name in p.decisions).chunk_bytes
                out["schedules"][(n, s.name)] = (
                    cb, ex.shard_schedule(col, cb, s.g_lo, s.g_hi))
    mp = out["plans"]["n4"]
    res = run("seq", mp, concurrent=False)
    run("conc", mp, concurrent=True)
    done = [it for it in res.per_device[0] if RPL.SHARD_SEP not in it]
    run("suffix", replan_suffix(mp, done, surviving_device_ids=(1, 2, 3),
                                cost_model=ex.cost_model, profiles=profiles,
                                shard_threshold_bytes=0))
    topo = LinkTopology(n_links=4, link_scale=(6.0, 1.0, 1.0, 1.0), d2d_scale=0.05)
    run("fabric", RPL.plan_mesh_execution(profiles, ex.cost_model, n_devices=4,
                                          shard_threshold_bytes=0, topology=topo,
                                          placement="sharded"))
    sp = ServePlanner(StreamingExecutor(chunk_bytes="auto", chunk_decode=True,
                                        cache=ProgramCache()), mesh=2)
    sp.submit("q1", {"big": encs["big"], "small0": encs["small0"]})
    sp.submit("q2", {"rle": encs["rle"], "small1": encs["small1"]})
    served = sp.drain()
    rep = sp.reports[-1]
    out["serve"] = {"chosen": rep.chosen, "devices": tuple(rep.devices),
                    "launch_devices": sorted(rep.device_launches),
                    "arrays": {f"{rid}/{c}": np.asarray(a) for rid, r in served.items()
                               for c, a in r.arrays.items()}}
    with open(os.path.join(d, "ref_mesh_run.pkl"), "wb") as f:
        pickle.dump(out, f)



def _shard_map():
    import jax
    return jax.shard_map, {"check_vma": False}


def _make_mesh(shape, names):
    import jax

    kw = {}
    if hasattr(jax.sharding, "AxisType"):
        kw["axis_types"] = (jax.sharding.AxisType.Auto,) * len(shape)
    return jax.make_mesh(shape, names, **kw)


def ref_psum(d: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.train import grad_compress as RGC

    shard_map, kw = _shard_map()
    mesh = _make_mesh((4,), ("pod",))
    grads, errs = psum_inputs()
    fn = jax.jit(shard_map(
        lambda g, e: tuple(x[None] for x in RGC.compressed_psum(g[0], e[0], "pod")),
        mesh=mesh, in_specs=(P("pod"), P("pod")), out_specs=(P("pod"), P("pod")), **kw))
    out = {}
    for i, (g, e) in enumerate(zip(grads, errs)):
        s, ne = fn(jnp.asarray(g), jnp.asarray(e))
        out[f"sum{i}"], out[f"err{i}"] = np.asarray(s), np.asarray(ne)
    save(d, "ref_psum", **out)


def _ref_f32():
    import dataclasses

    import jax
    import jax.numpy as jnp
    from repro.configs import SMOKES
    from repro.models import get_model

    cfg = dataclasses.replace(SMOKES[ARCH], dtype=jnp.float32)
    params = get_model(cfg).init(jax.random.PRNGKey(3))[0]
    return cfg, params


def ref_dp(d: str) -> None:
    import jax
    import jax.numpy as jnp
    from repro.train import grad_compress as RGC
    from repro.train import optimizer as ROPT
    from repro.train.train_step import make_dp_compressed_step

    cfg, params = _ref_f32()
    save(d, "ref_params", **flat(jax.tree.map(np.asarray, params)))
    mesh = _make_mesh((2, 2), ("pod", "data"))
    opt_cfg = ROPT.AdamWConfig(**DP_OPT)
    step = make_dp_compressed_step(cfg, opt_cfg, mesh)
    opt = ROPT.init(params)
    err = RGC.init_error_feedback(params)
    losses = []
    for b in batches():
        params, opt, err, m = step(params, opt, err, jax.tree.map(jnp.asarray, b))
        losses.append(float(m["loss"]))
    save(d, "ref_dp", losses=np.asarray(losses),
         **{"p/" + k: v for k, v in flat(jax.tree.map(np.asarray, params)).items()})


def ref_elastic(d: str) -> None:
    """The reference's ``test_elastic.py`` scenario on 4 devices: a (2, 2)
    mesh, 2 devices lost, recovery to (1, 2) from a checkpoint."""
    import tempfile

    import jax
    import jax.numpy as jnp
    from repro.configs import SMOKES
    from repro.launch.elastic import (ElasticCoordinator, make_mesh_from_plan, plan_remesh,
                                      reshard)
    from repro.models import get_model
    from repro.train import checkpoint as ckpt

    cfg = SMOKES[ARCH]
    model = get_model(cfg)
    params, specs = model.init(jax.random.PRNGKey(0))
    save(d, "ref_params", **flat(jax.tree.map(np.asarray, params)))
    full = plan_remesh(4, model_size=2)
    placed = reshard(params, specs, make_mesh_from_plan(full))
    zeros = lambda n: {"tokens": jnp.zeros((n, 32), jnp.int32),
                       "labels": jnp.zeros((n, 32), jnp.int32)}
    loss_full = jax.jit(lambda p, b: model.train_loss(p, b))(placed, zeros(4))
    with tempfile.TemporaryDirectory() as c:
        ckpt.save(c, 3, params)
        placed2, mesh2, step = ElasticCoordinator(2, c).recover(params, specs,
                                                                jax.devices()[:2])
        loss_small = jax.jit(lambda p, b: model.train_loss(p, b))(placed2, zeros(2))
    save(d, "ref_elastic", loss_full=np.float32(loss_full),
         loss_small=np.float32(loss_small), step=np.int64(step),
         shape=np.asarray([mesh2.shape["data"], mesh2.shape["model"]]))


# ---------------------------------------------------------------- port side

def _port_model(d: str, f32: bool = True, train: bool = True):
    import dataclasses

    import torch
    from repro_torch.configs import SMOKES
    from repro_torch.models.weights import params_from_reference

    cfg = SMOKES[ARCH]
    if f32:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    return cfg, params_from_reference(nest(load(d, "ref_params")), cfg, "cpu", train=train)


def rank_psum(d: str, rank: int) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.roofline import op_cost
    from repro_torch.train import grad_compress as GC

    grads, errs = psum_inputs()
    g = [torch.from_numpy(x[rank].copy()) for x in grads]
    e = [torch.from_numpy(x[rank].copy()) for x in errs]
    sums, new_errs = GC.compress_tree(g, e, dist.group.WORLD)
    counted = op_cost.analyze(GC.compress_tree, g, e, dist.group.WORLD)
    save(d, f"psum_{rank}", **{f"sum{i}": s.numpy() for i, s in enumerate(sums)},
         **{f"err{i}": x.numpy() for i, x in enumerate(new_errs)},
         allreduce_bytes=np.float64(counted["collectives"].get("all-reduce", 0.0)),
         by_op_bytes=np.float64(sum(v["bytes"] for k, v in counted["by_op"].items()
                                    if "all_reduce" in k)),
         wire_int8=np.int64(GC.wire_bytes(g, compressed=True)),
         wire_f32=np.int64(GC.wire_bytes(g, compressed=False)))


def rank_dp(d: str, rank: int) -> None:
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.models.weights import to_reference
    from repro_torch.train import grad_compress as GC
    from repro_torch.train import make_dp_compressed_step, optimizer
    from repro_torch.train.optimizer import AdamWConfig

    cfg, model = _port_model(d)
    dm = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("pod", "data"))
    step = make_dp_compressed_step(cfg, AdamWConfig(**DP_OPT), dm)
    opt = optimizer.init(model)
    err = GC.init_error_feedback(model)
    losses = []
    for b in batches():
        _, opt, err, m = step(model, opt, err, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    save(d, f"dp_{rank}", losses=np.asarray(losses),
         **{"p/" + k: v for k, v in flat(to_reference(model, model.parameters())).items()})


def rank_place(d: str, rank: int) -> None:
    """qwen SMOKE f32: the placed ``train_loss`` and gradients, and two
    placed AdamW steps, against the unplaced port on a 2 x 2 mesh; every
    parameter's local shape against ``shard_shape``; ``flash_attention``
    with 3 heads on a 2-way TP axis (padded to 4) against the plain one."""
    import dataclasses

    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
    from repro_torch.configs import SHAPES, SMOKES
    from repro_torch.launch import mesh as M
    from repro_torch.models import get_model
    from repro_torch.models import layers as L
    from repro_torch.models.sharding_ctx import mesh_context
    from repro_torch.models.weights import layout, meta_tree
    from repro_torch.train import optimizer
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_step

    full = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
    cfg = dataclasses.replace(SMOKES[ARCH], dtype=torch.float32)
    model = get_model(cfg)
    plain = model.init(torch.Generator().manual_seed(0), device="cpu", train=True)
    placed = model.init(torch.Generator().manual_seed(0), device="cpu", train=True)
    record = M.Mesh("t", ("data", "model"), (2, 2))
    dm = M.device_mesh(record, "cpu")
    specs = M.shard_tree(meta_tree(plain), model.param_specs(), record)
    M.place(placed, model.param_specs(), dm)
    out = {}
    # local shapes: each stacked leaf's spec without its stack dims
    bad = []
    for path, (stack, ps) in layout(placed).items():
        spec = specs
        for k in path.split("/"):
            spec = spec[k]
        want = M.shard_shape(ps[0].shape, spec[len(stack):], record)
        bad += [path for p in ps if tuple(p.to_local().shape) != want]
    out["bad_shapes"] = np.asarray(len(bad))
    out["n_sharded"] = np.asarray(sum(any(not isinstance(x, Replicate) for x in p.placements)
                                      for p in placed.parameters()))
    _, in_logical = model.input_specs(dataclasses.replace(SHAPES["train_4k"],
                                                          global_batch=B, seq_len=S))
    rng = np.random.default_rng(2)
    tok = rng.integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tok[:, :-1].copy()),
             "labels": torch.from_numpy(tok[:, 1:].copy())}
    plist = list(plain.parameters())
    loss = model.train_loss(plain, batch)
    grads = torch.autograd.grad(loss, plist)
    with mesh_context(dm):
        pb = M.place_tree(batch, in_logical, dm)
        loss2 = model.train_loss(placed, pb)
        grads2 = torch.autograd.grad(loss2, list(placed.parameters()))
    out["loss"] = np.float64(loss.item())
    out["loss_placed"] = np.float64(full(loss2).item())
    out["grad_rel"] = np.asarray([float((full(a) - b).abs().max() / b.abs().max().clamp_min(1e-30))
                                  for a, b in zip(grads2, grads)])
    # two AdamW steps, placed and not
    step = make_train_step(cfg, AdamWConfig(**DP_OPT), remat="dots")
    o1, o2 = optimizer.init(plain), optimizer.init(placed)
    before = [p.detach().clone() for p in plain.parameters()]
    losses = []
    for b in batches():
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        m1 = step(plain, o1, tb)[2]
        with mesh_context(dm):
            m2 = step(placed, o2, M.place_tree(tb, in_logical, dm))[2]
        losses.append((m1["loss"].item(), full(m2["loss"]).item()))
    out["step_losses"] = np.asarray(losses)
    with torch.no_grad():
        out["param_diff"] = np.asarray([float((full(a) - b).abs().max())
                                        for a, b in zip(placed.parameters(), plain.parameters())])
        out["param_top"] = np.float64(max(float(b.abs().max()) for b in plain.parameters()))
        out["param_l2"] = np.float64(sum(float(((full(a) - b) ** 2).sum()) for a, b in
                                         zip(placed.parameters(), plain.parameters())) ** 0.5)
        out["change_l2"] = np.float64(sum(float(((b - b0) ** 2).sum()) for b, b0 in
                                          zip(plain.parameters(), before)) ** 0.5)
    # head padding: 3 heads on a 2-way TP axis
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(2, 16, 3, 8, generator=g) for _ in range(3))
    want = L.flash_attention(q, k, v, q_chunk=8, kv_chunk=8)
    pl = (Shard(0), Replicate())
    with mesh_context(dm):
        got = L.flash_attention(*(distribute_tensor(t, dm, pl, src_data_rank=None)
                                  for t in (q, k, v)), q_chunk=8, kv_chunk=8)
    out["pad_err"] = np.float64((full(got) - want).abs().max())
    out["pad_shape"] = np.asarray(full(got).shape)
    out.update(_placed_checkpoint(d, cfg, model, dm, in_logical, step, placed, o2, plain, o1))
    save(d, f"place_{rank}", **out)


def _placed_checkpoint(d, cfg, model, dm, in_logical, step, placed, o2, plain, o1) -> dict:
    """The placed state of ``rank_place``'s two steps through a checkpoint:
    gathered whole by every rank, written by the mesh's first device alone,
    restored into a fresh placed module; then ``loop.run`` resumes it placed
    for a third step, beside the unplaced third step."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    from repro_torch.models.sharding_ctx import mesh_context
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer
    from repro_torch.train.loop import (LoopConfig, load_state, run, save_state, state_like,
                                        state_tree)

    ck = os.path.join(d, "ckpt")
    out = {}
    whole = lambda p, o: flat(dict(zip(("params", "opt"), state_tree(p, o))))
    tree = whole(placed, o2)
    out["ckpt_shapes"] = np.asarray({k: v.shape for k, v in tree.items()}
                                    == {k: v.shape for k, v in whole(plain, o1).items()})
    save_state(ck, 2, placed, o2)
    dist.barrier()
    fresh = M.place(model.init(torch.Generator().manual_seed(1), device="cpu", train=True),
                    model.param_specs(), dm)
    restored, out["ckpt_step"], _ = ckpt.restore(ck, state_like(fresh))
    o3 = load_state(fresh, restored)
    same = lambda a, b: a.placements == b.placements and torch.equal(a.to_local(), b.to_local())
    out["ckpt_params_equal"] = np.asarray(all(same(a, b) for a, b in
                                              zip(fresh.parameters(), placed.parameters())))
    out["ckpt_moments_equal"] = np.asarray(all(same(a, b) for k in ("mu", "nu")
                                               for a, b in zip(o3[k], o2[k])))
    again = whole(fresh, o3)
    out["ckpt_tree_equal"] = np.asarray(all(np.array_equal(again[k], v)
                                            for k, v in tree.items()))
    rng = np.random.default_rng(3)
    tok = rng.integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    third = {"tokens": torch.from_numpy(tok[:, :-1].copy()),
             "labels": torch.from_numpy(tok[:, 1:].copy())}
    out["plain_loss3"] = np.float64(step(plain, o1, third)[2]["loss"].item())
    with mesh_context(dm):
        _, _, hist = run(LoopConfig(total_steps=3, ckpt_dir=ck, ckpt_every=1, log_every=100),
                         lambda p, o, b: step(p, o, M.place_tree(b, in_logical, dm)),
                         fresh, optimizer.init(fresh), lambda i: third, log=lambda _: None)
    out["resumed"] = np.asarray([h["step"] for h in hist])
    out["resumed_loss"] = np.float64(hist[-1]["loss"])
    dist.barrier()
    return out


def rank_elastic(d: str, rank: int) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.configs import SMOKES
    from repro_torch.launch import elastic as E
    from repro_torch.launch import mesh as M
    from repro_torch.models import get_model
    from repro_torch.models.sharding_ctx import mesh_context
    from repro_torch.models.weights import params_to_reference
    from repro_torch.train import checkpoint as ckpt

    cfg, module = _port_model(d, f32=False, train=False)
    model = get_model(cfg)
    specs = model.param_specs()
    zeros = lambda n: {"tokens": torch.zeros((n, 32), dtype=torch.int32),
                       "labels": torch.zeros((n, 32), dtype=torch.int32)}
    ckpt_dir = os.path.join(d, "ckpt")
    if rank == 0:
        ckpt.save(ckpt_dir, 3, params_to_reference(module))
    full = E.plan_remesh(4, model_size=2)
    dm = E.make_mesh_from_plan(full, device_type="cpu")
    placed = E.reshard(module, specs, dm)
    with mesh_context(dm):
        loss_full = model.train_loss(placed, zeros(4)).full_tensor().item()
    dist.barrier()
    fresh = _port_model(d, f32=False, train=False)[1]
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    coord = E.ElasticCoordinator(model_size=2, ckpt_dir=ckpt_dir, device_type="cpu")
    placed2, mesh2, step = coord.recover(fresh, specs, surviving_ranks=[0, 1])
    out = {"loss_full": np.float64(loss_full), "step": np.int64(step),
           "shape": np.asarray([mesh2.size(0), mesh2.size(1)]),
           "member": np.asarray(mesh2.get_coordinate() is not None)}
    if mesh2.get_coordinate() is not None:
        with mesh_context(mesh2):
            out["loss_small"] = np.float64(
                model.train_loss(placed2, zeros(2)).full_tensor().item())
    dist.barrier()
    save(d, f"elastic_{rank}", **out)


# ------------------------------------------------------------------ driver

def _rank(rank: int, case: str, d: str, world: int, store: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    torch.manual_seed(0)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        globals()["rank_" + case](d, rank)
    except BaseException:
        with open(os.path.join(d, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def main(case: str, d: str) -> None:
    if case.startswith("ref_"):
        os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={FORCED[case]}"
        globals()[case](d)
        return
    import tempfile

    import torch.multiprocessing as mp

    # a fresh rendezvous file each launch: a stale one would hang the group
    store = os.path.join(tempfile.mkdtemp(prefix=f"store_{case}_", dir=d), "store")
    mp.start_processes(_rank, args=(case, d, WORLD[case], store), nprocs=WORLD[case],
                       start_method="spawn")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
